// Q1.15 fixed-point matrix product for Hopper (sm_90a).
//
// Replaces repro/kernels/q115_matmul.py::q115_matmul (the Pallas
// `_q115_kernel`): int16 Q1.15 codes x (M, K) times w (K, N) with the
// FPGA's dataflow (paper §4.3): each Q2.30 product is rescaled to Q1.15
// before it is summed,
//
//   acc[m, n] = sum_k (x[m, k] * w[k, n] + 2^14) >> 15   (int32, wrapping)
//
// with an arithmetic shift, so a fan-in-4096 sum fits the paper's 28-bit
// intermediate; the output is acc saturated to int16, or the raw int32
// acc.  Rounding each product is not linear, so no tensor-core product
// computes this.
//
// Design: a CTA of 128 threads owns a 16 x 64 output tile; thread
// (ty, tx) = (tid / 64, tid % 64) holds the 8 sums of rows ty*8 .. ty*8+7
// in column tx.  The CTA walks K in slabs of 64 staged in shared memory
// (x tile 2 KB, w tile 8 KB); a warp shares one ty, so each x read is a
// broadcast and the w reads are consecutive along n.  Edges are masked,
// so no shape needs padding.
//
// Numerics: (-2^15)^2 + 2^14 < 2^31, so no product overflows; the sums
// wrap as two's-complement int32 (done in unsigned arithmetic), in any
// order, so the result equals the plain versions
// (kernels/q115_matmul.py::q115_matmul_ref / q115_matmul_acc_ref) and the
// reference bit for bit.
//
// Bounds: about 3 integer operations a product (multiply-add of the
// rounding constant, shift, add) on the CUDA cores' int32 lanes
// (132 SMs x 64 lanes): 419 M products at (200, 4096) x (4096, 512) are
// about 75 us, far above the bytes (6.2 MB with an int32 output, 1.9 us),
// so the function is bound by operations.

#include <cuda_runtime.h>
#include <stdint.h>

#define Q_BM 16
#define Q_BN 64
#define Q_BK 64
#define Q_THREADS 128
#define Q_ROWS (Q_BM * Q_BN / Q_THREADS)  // sums per thread

template <bool SATURATE>
__global__ void __launch_bounds__(Q_THREADS)
    q115_matmul_kernel(const int16_t* __restrict__ x,
                       const int16_t* __restrict__ w, void* __restrict__ out,
                       int M, int K, int N) {
  __shared__ int16_t s_x[Q_BM][Q_BK];
  __shared__ int16_t s_w[Q_BK][Q_BN];
  const int tid = threadIdx.x;
  const int tx = tid % Q_BN;
  const int ty = tid / Q_BN;
  const int m0 = blockIdx.y * Q_BM;
  const int n0 = blockIdx.x * Q_BN;
  unsigned acc[Q_ROWS];
#pragma unroll
  for (int r = 0; r < Q_ROWS; ++r) acc[r] = 0u;

  for (int k0 = 0; k0 < K; k0 += Q_BK) {
    for (int i = tid; i < Q_BM * Q_BK; i += Q_THREADS) {
      const int r = i / Q_BK, c = i % Q_BK;
      const int m = m0 + r, k = k0 + c;
      s_x[r][c] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0;
    }
    for (int i = tid; i < Q_BK * Q_BN; i += Q_THREADS) {
      const int r = i / Q_BN, c = i % Q_BN;
      const int k = k0 + r, n = n0 + c;
      s_w[r][c] = (k < K && n < N) ? w[static_cast<size_t>(k) * N + n] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < Q_BK; ++kk) {
      const int wv = s_w[kk][tx];
#pragma unroll
      for (int r = 0; r < Q_ROWS; ++r) {
        const int p = static_cast<int>(s_x[ty * Q_ROWS + r][kk]) * wv;
        acc[r] += static_cast<unsigned>((p + (1 << 14)) >> 15);
      }
    }
    __syncthreads();  // the next slab overwrites both tiles
  }
  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < Q_ROWS; ++r) {
    const int m = m0 + ty * Q_ROWS + r;
    if (m >= M) continue;
    const size_t at = static_cast<size_t>(m) * N + n;
    const int a = static_cast<int>(acc[r]);
    if (SATURATE) {
      static_cast<int16_t*>(out)[at] =
          static_cast<int16_t>(min(max(a, -32768), 32767));
    } else {
      static_cast<int*>(out)[at] = a;
    }
  }
}

extern "C" int q115_matmul_launch(const void* x, const void* w, void* out,
                                  int M, int K, int N, int saturate,
                                  void* stream) {
  if (M < 0 || K < 0 || N < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + Q_BN - 1) / Q_BN, (M + Q_BM - 1) / Q_BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int16_t* xp = static_cast<const int16_t*>(x);
  const int16_t* wp = static_cast<const int16_t*>(w);
  if (saturate) {
    q115_matmul_kernel<true><<<grid, Q_THREADS, 0, s>>>(xp, wp, out, M, K, N);
  } else {
    q115_matmul_kernel<false><<<grid, Q_THREADS, 0, s>>>(xp, wp, out, M, K, N);
  }
  return cudaGetLastError();
}
