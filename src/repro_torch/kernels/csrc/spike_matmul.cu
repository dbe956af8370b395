// Spike x weight integration (the paper's cascaded adder) for Hopper
// (sm_90a).
//
// Replaces repro/kernels/spike_matmul.py::spike_matmul (the Pallas
// `_spike_mm_kernel`): int8 spikes (M, K) times int16 Q1.15 codes (K, N)
//
//   out[m, n] = sum_k s[m, k] * w[k, n]     (int32, wrapping)
//
// the integer product the reference's oracle computes (a dot_general), so
// a spike value other than 0 or 1 multiplies; it is not read as 1.
//
// Design: a CTA of 128 threads owns a 16 x 64 output tile; thread
// (ty, tx) = (tid / 64, tid % 64) holds the 8 sums of rows ty*8 .. ty*8+7
// in column tx.  The CTA walks K in slabs of 64: it stages the 16 x 64
// spike tile in shared memory first, and __syncthreads_or skips the slab
// when every spike in it is zero (the Pallas kernel's `n_events > 0`
// gate), before the 64 x 64 weight tile is read, so a silent slab costs
// its spike bytes only.  The tile's edges are masked, so no shape needs
// padding.  A warp shares one ty, so each spike read from shared memory
// is a broadcast, and the weight reads are consecutive along n.
//
// Numerics: integer sums wrap as two's-complement int32 (done in unsigned
// arithmetic), in any order, so the result equals the plain version
// (kernels/spike_matmul.py::spike_matmul_ref) and the reference bit for
// bit.
//
// Bounds: at the hardware path's layer 0, (200, 4096) x (4096, 512), the
// function must move 0.82 + 4.19 + 0.41 MB, 1.6 us at 3.35 TB/s, and is
// bound by bytes.  This design reads each weight tile once per 16-row
// block through L2 and adds with the CUDA cores, so it sits well above
// that bound; a tensor-core (IMMA) design is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define SMM_BM 16
#define SMM_BN 64
#define SMM_BK 64
#define SMM_THREADS 128
#define SMM_ROWS (SMM_BM * SMM_BN / SMM_THREADS)  // sums per thread

__global__ void __launch_bounds__(SMM_THREADS)
    spike_matmul_kernel(const int8_t* __restrict__ s,
                        const int16_t* __restrict__ w, int* __restrict__ out,
                        int M, int K, int N) {
  __shared__ int8_t s_spk[SMM_BM][SMM_BK];
  __shared__ int16_t s_w[SMM_BK][SMM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % SMM_BN;
  const int ty = tid / SMM_BN;
  const int m0 = blockIdx.y * SMM_BM;
  const int n0 = blockIdx.x * SMM_BN;
  unsigned acc[SMM_ROWS];
#pragma unroll
  for (int r = 0; r < SMM_ROWS; ++r) acc[r] = 0u;

  for (int k0 = 0; k0 < K; k0 += SMM_BK) {
    bool any = false;
    for (int i = tid; i < SMM_BM * SMM_BK; i += SMM_THREADS) {
      const int r = i / SMM_BK, c = i % SMM_BK;
      const int m = m0 + r, k = k0 + c;
      const int8_t v = (m < M && k < K) ? s[static_cast<size_t>(m) * K + k] : 0;
      s_spk[r][c] = v;
      any |= v != 0;
    }
    if (!__syncthreads_or(any)) continue;  // gated: a silent slab
    for (int i = tid; i < SMM_BK * SMM_BN; i += SMM_THREADS) {
      const int r = i / SMM_BN, c = i % SMM_BN;
      const int k = k0 + r, n = n0 + c;
      s_w[r][c] = (k < K && n < N) ? w[static_cast<size_t>(k) * N + n] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SMM_BK; ++kk) {
      const int wv = s_w[kk][tx];
#pragma unroll
      for (int r = 0; r < SMM_ROWS; ++r) {
        acc[r] += static_cast<unsigned>(
            static_cast<int>(s_spk[ty * SMM_ROWS + r][kk]) * wv);
      }
    }
    __syncthreads();  // the next slab overwrites both tiles
  }
  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < SMM_ROWS; ++r) {
    const int m = m0 + ty * SMM_ROWS + r;
    if (m < M) out[static_cast<size_t>(m) * N + n] = static_cast<int>(acc[r]);
  }
}

extern "C" int spike_matmul_launch(const void* spikes, const void* weights,
                                   void* out, int M, int K, int N,
                                   void* stream) {
  if (M < 0 || K < 0 || N < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + SMM_BN - 1) / SMM_BN, (M + SMM_BM - 1) / SMM_BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  spike_matmul_kernel<<<grid, SMM_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spikes), static_cast<const int16_t*>(weights),
      static_cast<int*>(out), M, K, N);
  return cudaGetLastError();
}
