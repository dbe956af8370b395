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
// Two input forms, one kernel: float32 currents (lif_fused), or the
// adder tree's int32 sums acc (T, B, N) with the int32 Q1.15 bias codes
// (N,) (lif_fused_from_acc, the hardware path of ops.snn_layer_forward),
// each current then being
//
//   cur = float32(acc + bias) / 2^15
//
// with the int32 add wrapping (done in unsigned arithmetic), the
// conversion to nearest even and the exact power-of-two divide, as the
// plain version's three PyTorch ops compute it; so a layer's forward is
// spike_matmul and one launch of this kernel, with nothing between.
//
// Design: one thread per neuron (b, n), flat over B * N so that a warp's
// loads and spike stores are consecutive along n, in CTAs of one warp, so
// that few neurons still spread over many SMs (the hardware path's 4,096
// neurons: 128 CTAs; CTAs of 64 or 128 timed the same there, of 256
// slower).  A thread issues the loads of LIF_TB = 32 steps
// before it runs their recurrence, and the loads of the next 32 steps
// before the recurrence of these, so the kernel waits on memory once per
// block of 32 steps (once at T = 25); u and the refractory counter stay
// in registers.  The grid masks its own ragged edge, so no shape needs
// padding (the Pallas kernel's +inf-threshold padding is a TPU tiling
// artefact).
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
// hardware path's (25, 8, 512) it moves 0.84 MB, 0.25 us at 3.35 TB/s.
// The T loop is sequential by nature, so in practice the kernel is bound
// by launch and latency: one memory round trip, then 25 dependent steps.
// lif_empty_kernel, an empty kernel launched on the same grid, measures
// that floor on the card (chip_smoke.py phase 8).

#include <cuda_runtime.h>
#include <stdint.h>

#define LIF_TB 32       // steps whose loads are in flight together
#define LIF_THREADS 32  // neurons a CTA

// float32(acc + bias) / 2^15: the multiply by 2^-15 is exact, so it
// equals the divide
__device__ __forceinline__ float from_acc(uint32_t acc, uint32_t bias) {
  return __fmul_rn(__int2float_rn(static_cast<int>(acc + bias)), 0x1p-15f);
}

template <bool FROM_ACC, bool SUBTRACT, bool REFRACTORY>
__global__ void __launch_bounds__(LIF_THREADS)
    lif_fused_kernel(const uint32_t* __restrict__ in,
                     const int* __restrict__ bias,
                     const float* __restrict__ beta,
                     const float* __restrict__ thr, float* __restrict__ spikes,
                     float* __restrict__ u_fin, int T, int64_t BN, int N,
                     int refractory_steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * LIF_THREADS + threadIdx.x;
  if (i >= BN) return;
  const int n = static_cast<int>(i % N);
  const float b = beta[n];
  const float th = thr[n];
  const uint32_t bq = FROM_ACC ? static_cast<uint32_t>(bias[n]) : 0u;
  // raw 32-bit words (float bits or int32 sums) of steps t0 .. t0+LIF_TB-1;
  // addresses advance by a pointer step, not a 64-bit multiply a load
  uint32_t cur[LIF_TB];
  const uint32_t* src = in + i;
#pragma unroll
  for (int j = 0; j < LIF_TB; ++j, src += BN) cur[j] = j < T ? *src : 0u;
  float* dst = spikes + i;
  float u = 0.0f;
  int refrac = 0;
  for (int t0 = 0; t0 < T; t0 += LIF_TB) {
    uint32_t nxt[LIF_TB];
#pragma unroll
    for (int j = 0; j < LIF_TB; ++j, src += BN) {
      nxt[j] = t0 + LIF_TB + j < T ? *src : 0u;
    }
    float c[LIF_TB];  // the currents, off the recurrence's dependent chain
#pragma unroll
    for (int j = 0; j < LIF_TB; ++j) {
      c[j] = FROM_ACC ? from_acc(cur[j], bq) : __uint_as_float(cur[j]);
    }
#pragma unroll
    for (int j = 0; j < LIF_TB; ++j, dst += BN) {
      if (t0 + j >= T) break;
      const float u_pre = __fadd_rn(__fmul_rn(b, u), c[j]);
      float spk = u_pre >= th ? 1.0f : 0.0f;
      if (REFRACTORY) {
        spk = __fmul_rn(spk, refrac <= 0 ? 1.0f : 0.0f);
        refrac = spk > 0.0f ? refractory_steps : max(refrac - 1, 0);
      }
      // 1 - spk is exactly 0 or 1, so the zero reset's factor is a select
      // off the chain; the multiply stays, so inf * 0 is NaN as in the
      // plain version
      u = SUBTRACT ? __fsub_rn(u_pre, __fmul_rn(th, spk))
                   : __fmul_rn(u_pre, spk > 0.0f ? 0.0f : 1.0f);
      *dst = spk;
    }
#pragma unroll
    for (int j = 0; j < LIF_TB; ++j) cur[j] = nxt[j];
  }
  u_fin[i] = u;
}

__global__ void lif_empty_kernel() {}

template <bool FROM_ACC, bool SUBTRACT>
static void launch(dim3 grid, cudaStream_t s, const uint32_t* in,
                   const int* bias, const float* beta, const float* thr,
                   float* spikes, float* u_fin, int T, int64_t BN, int N,
                   int refractory) {
  if (refractory > 0) {
    lif_fused_kernel<FROM_ACC, SUBTRACT, true><<<grid, LIF_THREADS, 0, s>>>(
        in, bias, beta, thr, spikes, u_fin, T, BN, N, refractory);
  } else {
    lif_fused_kernel<FROM_ACC, SUBTRACT, false><<<grid, LIF_THREADS, 0, s>>>(
        in, bias, beta, thr, spikes, u_fin, T, BN, N, 0);
  }
}

static int blocks_of(long long B, int N, dim3* grid) {
  const int64_t BN = static_cast<int64_t>(B) * N;
  const int64_t blocks = (BN + LIF_THREADS - 1) / LIF_THREADS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

// inputs: float32 currents (T, B, N) when bias is null, else int32 sums
// (T, B, N) and int32 bias codes (N,)
extern "C" int lif_fused_launch(const void* inputs, const void* bias,
                                const void* beta, const void* threshold,
                                void* spikes, void* u_fin, int T, long long B,
                                int N, int refractory_steps, int subtract,
                                void* stream) {
  if (T < 0 || B < 0 || N < 0 || refractory_steps < 0) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<int64_t>(B) * N == 0) return cudaSuccess;
  dim3 grid;
  const int err = blocks_of(B, N, &grid);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(inputs);
  const int* bq = static_cast<const int*>(bias);
  const float* b = static_cast<const float*>(beta);
  const float* th = static_cast<const float*>(threshold);
  float* spk = static_cast<float*>(spikes);
  float* uf = static_cast<float*>(u_fin);
  const int64_t BN = static_cast<int64_t>(B) * N;
  if (bq != nullptr) {
    if (subtract) {
      launch<true, true>(grid, s, in, bq, b, th, spk, uf, T, BN, N, refractory_steps);
    } else {
      launch<true, false>(grid, s, in, bq, b, th, spk, uf, T, BN, N, refractory_steps);
    }
  } else if (subtract) {
    launch<false, true>(grid, s, in, bq, b, th, spk, uf, T, BN, N, refractory_steps);
  } else {
    launch<false, false>(grid, s, in, bq, b, th, spk, uf, T, BN, N, refractory_steps);
  }
  return cudaGetLastError();
}

// an empty kernel on the grid lif_fused_launch would take for (B, N):
// the launch-and-schedule floor of the LIF kernel's device time
extern "C" int lif_empty_launch(long long B, int N, void* stream) {
  if (B <= 0 || N <= 0) return cudaErrorInvalidValue;
  dim3 grid;
  const int err = blocks_of(B, N, &grid);
  if (err != cudaSuccess) return err;
  lif_empty_kernel<<<grid, LIF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
