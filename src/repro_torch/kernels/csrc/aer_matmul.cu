// Batched event-driven synaptic integration for Hopper (sm_90a).
//
// Replaces repro/kernels/aer_matmul.py::aer_spike_matmul_batched (the
// Pallas `_aer_batched_kernel`):
//
//   out[b, n] = sum_e values[b, e] * W[addrs[b, e], n]
//
// Two contracts: int16 weights with integer values accumulate in int32
// (two's-complement wrap, bit-exact against the reference's
// aer_spike_matmul_ref per stream); float32 weights with float32 values
// accumulate in float32 (the surrogate-gradient training forward).
//
// Design: grid (B, ceil(N / 128)), one thread per output column.  The
// block walks its stream's event list in E-blocks of 128: each thread
// stages one event's address and value in shared memory, and
// __syncthreads_or skips a block that holds no live event (the Pallas
// kernel's E-block gate).  An event is live when its value is nonzero and
// its address lies in [0, K); other entries are padding or corrupt and
// contribute nothing (no row outside [0, K) is ever read).  Then every
// thread adds value * W[addr, n] for the block's live events in event
// order, with the row loads of AER_UNROLL events issued ahead of the adds.
//
// Numerics: the float sum runs in event order with __fmul_rn/__fadd_rn
// (and the library is built with -fmad=false), so no multiply-add is
// contracted and the result equals the plain PyTorch version
// (kernels/aer_matmul.py::aer_spike_matmul_batched_ref) value for value.
// There are no atomics: runs are deterministic.
//
// Bounds: the work is one W row segment per live event and column block,
// read through the 50 MB L2 that holds the 8 MiB layer-0 slab; at the
// training shape (B = 32, N = 512) the grid is 128 CTAs, about one per
// SM, four warps each.  Each thread keeps a single dependent add chain
// and at most AER_UNROLL loads in flight, so the kernel is bound by L2
// latency, not by bandwidth, far above its bytes bound.  A later design
// splits E across warps of a CTA with a fixed-order reduction in shared
// memory to keep more loads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#define AER_BLOCK 128  // threads per CTA = output columns = events per E-block
#define AER_UNROLL 16  // divides AER_BLOCK: row loads issued before their adds

__device__ __forceinline__ float mac(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

__device__ __forceinline__ int mac(int acc, int v, int16_t w) {
  // wrap as int32 arithmetic does, without signed-overflow UB
  return static_cast<int>(static_cast<unsigned>(acc) +
                          static_cast<unsigned>(v) *
                              static_cast<unsigned>(static_cast<int>(w)));
}

template <typename WT, typename VT>
__global__ void __launch_bounds__(AER_BLOCK)
    aer_matmul_kernel(const int* __restrict__ addrs,
                      const VT* __restrict__ values,
                      const WT* __restrict__ w, VT* __restrict__ out, int E,
                      int K, int N) {
  __shared__ int s_addr[AER_BLOCK];
  __shared__ VT s_val[AER_BLOCK];
  const int b = blockIdx.x;
  const int n = blockIdx.y * AER_BLOCK + threadIdx.x;
  const int* a_row = addrs + static_cast<size_t>(b) * E;
  const VT* v_row = values + static_cast<size_t>(b) * E;
  VT acc = 0;
  for (int e0 = 0; e0 < E; e0 += AER_BLOCK) {
    const int m = min(AER_BLOCK, E - e0);
    const int i = threadIdx.x;
    int a = 0;
    VT v = 0;
    if (i < m) {
      a = a_row[e0 + i];
      v = v_row[e0 + i];
    }
    const bool live = v != 0 && a >= 0 && a < K;
    s_addr[i] = live ? a : 0;
    s_val[i] = live ? v : VT(0);
    if (!__syncthreads_or(live)) continue;  // gated: no live event here
    if (n < N) {
      // AER_UNROLL independent row loads in flight, then the adds in event
      // order.  Slots past m and dead events hold address 0 and value 0:
      // their (row 0) loads are discarded, so they contribute nothing.
      for (int j0 = 0; j0 < m; j0 += AER_UNROLL) {
        WT wv[AER_UNROLL];
#pragma unroll
        for (int u = 0; u < AER_UNROLL; ++u) {
          wv[u] = w[static_cast<size_t>(s_addr[j0 + u]) * N + n];
        }
#pragma unroll
        for (int u = 0; u < AER_UNROLL; ++u) {
          const VT vj = s_val[j0 + u];
          if (vj != 0) acc = mac(acc, vj, wv[u]);
        }
      }
    }
    __syncthreads();  // the next E-block overwrites the staged events
  }
  if (n < N) out[static_cast<size_t>(b) * N + n] = acc;
}

extern "C" int aer_matmul_launch(const void* addrs, const void* values,
                                 const void* w, void* out, int B, int E,
                                 int K, int N, int int16_weights,
                                 void* stream) {
  if (B < 0 || E < 0 || K < 1 || N < 0) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const dim3 grid(B, (N + AER_BLOCK - 1) / AER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int16_weights) {
    aer_matmul_kernel<int16_t, int><<<grid, AER_BLOCK, 0, s>>>(
        static_cast<const int*>(addrs), static_cast<const int*>(values),
        static_cast<const int16_t*>(w), static_cast<int*>(out), E, K, N);
  } else {
    aer_matmul_kernel<float, float><<<grid, AER_BLOCK, 0, s>>>(
        static_cast<const int*>(addrs), static_cast<const float*>(values),
        static_cast<const float*>(w), static_cast<float*>(out), E, K, N);
  }
  return cudaGetLastError();
}
