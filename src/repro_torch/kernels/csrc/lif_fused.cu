// Fused multi-step LIF dynamics for Hopper (sm_90a).
//
// Replaces repro/kernels/lif_fused.py::lif_fused (the Pallas
// `_lif_kernel`): from zero state, for t = 0 .. T-1 and every neuron
// (b, n) of currents (T, B, N)
//
//   u_pre = beta[n] * u + cur[t, b, n]
//   raw   = u_pre >= thr[n]
//   spk   = raw, gated by the refractory countdown when refractory > 0
//   u     = u_pre * (1 - spk)           (reset "zero")
//         = u_pre - thr[n] * spk        (reset "subtract")
//
// and writes spikes (T, B, N) and the final membrane (B, N).
//
// Design: one thread per neuron (b, n), flat over B * N so that a warp's
// loads and stores are consecutive along n; u and the refractory counter
// stay in registers across the T loop.  The grid masks its own ragged
// edge, so no shape needs padding (the Pallas kernel's +inf-threshold
// padding is a TPU tiling artefact).
//
// Numerics: the multiply and the add of u_pre are rounded separately
// (__fmul_rn, __fadd_rn; the library is built with -fmad=false), and the
// reset is the multiply (or the subtraction), not a select, so inf and
// NaN propagate as in the plain version
// (kernels/lif_fused.py::lif_fused_ref), which the kernel equals value
// for value.
//
// Bounds: each step reads one current and writes one spike per neuron,
// 8 bytes for 5 float operations, so the kernel is bound by bytes: at the
// hardware path's (25, 8, 512) it moves 0.84 MB, 0.25 us at 3.35 TB/s,
// and is launch-bound in practice.  The T loop is sequential by nature;
// the loads of later steps do not depend on earlier ones and are issued
// ahead by the unrolled loop.

#include <cuda_runtime.h>
#include <stdint.h>

#define LIF_THREADS 256

template <bool SUBTRACT, bool REFRACTORY>
__global__ void __launch_bounds__(LIF_THREADS)
    lif_fused_kernel(const float* __restrict__ cur,
                     const float* __restrict__ beta,
                     const float* __restrict__ thr, float* __restrict__ spikes,
                     float* __restrict__ u_fin, int T, int64_t BN, int N,
                     int refractory_steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * LIF_THREADS + threadIdx.x;
  if (i >= BN) return;
  const int n = static_cast<int>(i % N);
  const float b = beta[n];
  const float th = thr[n];
  float u = 0.0f;
  int refrac = 0;
#pragma unroll 5
  for (int t = 0; t < T; ++t) {
    const int64_t at = static_cast<int64_t>(t) * BN + i;
    const float u_pre = __fadd_rn(__fmul_rn(b, u), cur[at]);
    float spk = u_pre >= th ? 1.0f : 0.0f;
    if (REFRACTORY) {
      spk = __fmul_rn(spk, refrac <= 0 ? 1.0f : 0.0f);
      refrac = spk > 0.0f ? refractory_steps : max(refrac - 1, 0);
    }
    u = SUBTRACT ? __fsub_rn(u_pre, __fmul_rn(th, spk))
                 : __fmul_rn(u_pre, __fsub_rn(1.0f, spk));
    spikes[at] = spk;
  }
  u_fin[i] = u;
}

template <bool SUBTRACT>
static void launch(dim3 grid, cudaStream_t s, const float* cur,
                   const float* beta, const float* thr, float* spikes,
                   float* u_fin, int T, int64_t BN, int N, int refractory) {
  if (refractory > 0) {
    lif_fused_kernel<SUBTRACT, true><<<grid, LIF_THREADS, 0, s>>>(
        cur, beta, thr, spikes, u_fin, T, BN, N, refractory);
  } else {
    lif_fused_kernel<SUBTRACT, false><<<grid, LIF_THREADS, 0, s>>>(
        cur, beta, thr, spikes, u_fin, T, BN, N, 0);
  }
}

extern "C" int lif_fused_launch(const void* currents, const void* beta,
                                const void* threshold, void* spikes,
                                void* u_fin, int T, long long B, int N,
                                int refractory_steps, int subtract,
                                void* stream) {
  if (T < 0 || B < 0 || N < 0 || refractory_steps < 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t BN = static_cast<int64_t>(B) * N;
  if (BN == 0) return cudaSuccess;
  const int64_t blocks = (BN + LIF_THREADS - 1) / LIF_THREADS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cur = static_cast<const float*>(currents);
  const float* b = static_cast<const float*>(beta);
  const float* th = static_cast<const float*>(threshold);
  float* spk = static_cast<float*>(spikes);
  float* uf = static_cast<float*>(u_fin);
  if (subtract) {
    launch<true>(grid, s, cur, b, th, spk, uf, T, BN, N, refractory_steps);
  } else {
    launch<false>(grid, s, cur, b, th, spk, uf, T, BN, N, refractory_steps);
  }
  return cudaGetLastError();
}
