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
// computes this: every product costs integer instructions on the CUDA
// cores.
//
// Design: a CTA of 8 warps (4 where the grid would be small) owns a
// (8 x warps) x 128 output tile; warp w holds rows 8w .. 8w+7 and lane l
// columns 4l .. 4l+3, 32 sums a thread.  Each k step a thread reads its
// 8 x values (two 16-byte broadcasts) and its 4 w values (one 16-byte
// load) from shared memory and makes 32 products, 8 products a load.  The
// operands sit in shared memory as int32, sign-extended once a slab: K is
// walked in slabs of 32, staged raw (int16) with 16-byte cp.async into a
// ring of three slabs, so two slabs' copies are in flight while one is
// summed; each slab is then widened (x transposed to [k][m]) into one of
// two int32 buffers, one slab ahead of the products, so a slab costs one
// __syncthreads.  A warp whose rows all lie past M skips the products.
//
// Split-K: the planner (kernels/q115_matmul.py::plan) cuts K into
// `k_per_split` pieces (a multiple of 8), grid z, so that both the
// hardware path's shapes fill the card.  The raw int32 output adds its
// partials into a zeroed output by atomicAdd: the sums wrap and commute,
// so any order is bit-exact.  Saturation does not commute with the split,
// so a saturating product takes at most 8 splits, launched as one
// cluster along K: each CTA puts its partial tile in its own shared
// memory, and CTA r of the cluster sums every 8th (C-th) 4-column chunk
// of the C partials through distributed shared memory, then saturates
// that whole sum.  (The raw path runs the same code with clusters of
// one.)  A shape whose rows are not 16-byte aligned (K % 8, N % 8,
// or an unaligned pointer) stages through plain loads; every edge is
// masked and zero-filled, and a zero code adds (0 + 2^14) >> 15 = 0, so
// any M, K, N works.
//
// Numerics: (-2^15)^2 + 2^14 < 2^31, so no product overflows; the sums
// wrap as two's-complement int32 (done in unsigned arithmetic), in any
// order, so the result equals the plain versions
// (kernels/q115_matmul.py::q115_matmul_ref / q115_matmul_acc_ref) and the
// reference bit for bit.
//
// Bounds: a product is one IMAD (x * w + 2^14) and one LEA.HI.SX32
// (acc + (p >> 15)), two instructions where the former bound assumed
// three (multiply-add, shift, add); the SASS of this kernel (PERF.md §6)
// shows this pair in the inner loop.  IMAD issues on the FMA pipe and LEA
// on the integer ALU pipe, each 16 lanes a sub-partition, and a
// sub-partition issues one warp instruction a clock, so the pair is bound
// by issue: 64 products a clock an SM.  At (200, 4096) x (4096, 512) the
// 419 M products take 25.1 us on 132 SMs at 1.98 GHz (the superseded
// three-operation count gave 75.2 us), far above the bytes (6.2 MB with
// an int32 output, 1.9 us), so the function is bound by operations.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define Q_BN 128       // output columns a CTA
#define Q_BK 32        // k a slab
#define Q_KSTEP 8      // a K split is a multiple of this (one 16-byte chunk)
#define Q_TM 8         // rows a warp (a thread)
#define Q_TN 4         // columns a thread
// a CTA has 4 or 8 warps, so Q_TM * warps rows a tile
#define Q_STAGES 3     // raw slabs in the cp.async ring
#define Q_CLUSTER_MAX 8  // K splits reduced in one cluster (portable size)
#define Q_RX_PITCH 40  // int16 a staged x row: 32 + 8 pad (80 bytes)
#define Q_RW_TILE (Q_BK * Q_BN)  // int16, [k][n]
#define Q_CW_TILE (Q_BK * Q_BN)  // int32, [k][n]

static_assert(Q_BN == Q_TN * 32, "a lane holds Q_TN columns");
static_assert(Q_BK == 4 * Q_KSTEP, "a thread stages one x chunk: 4 a row");

// shared memory of a CTA of `warps` warps: the raw ring, then two int32
// slabs (x as [k][m], w as [k][n]), which the cluster reduction reuses
static size_t q_smem(int warps) {
  const size_t bm = Q_TM * warps;
  return Q_STAGES * (bm * Q_RX_PITCH + Q_RW_TILE) * 2 +
         2 * (Q_BK * bm + Q_CW_TILE) * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// raw int16 slab [ks, ks + Q_BK) of x rows m0 .. m0+BM-1 and w columns
// n0 .. n0+Q_BN-1, k past ke zero-filled; 4 * BM threads
template <int BM, bool VEC>
__device__ __forceinline__ void stage(int16_t* rx, int16_t* rw,
                                      const int16_t* x, const int16_t* w,
                                      int M, int K, int N, int m0, int n0,
                                      int ks, int ke) {
  const int tid = threadIdx.x;
  {  // x: one chunk of 8 k a thread, 4 a row
    const int r = tid >> 2, c = tid & 3;
    const int m = m0 + r, k = ks + c * 8;
    int16_t* d = rx + r * Q_RX_PITCH + c * 8;
    if (VEC) {
      const bool ok = m < M && k < ke;
      cp_async16(d, ok ? x + static_cast<size_t>(m) * K + k : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        d[q] = (m < M && k + q < ke) ? x[static_cast<size_t>(m) * K + k + q]
                                     : int16_t(0);
      }
    }
  }
  // w: Q_BK rows x 16 chunks of 8 n
  for (int i = tid; i < Q_BK * (Q_BN / 8); i += 4 * BM) {
    const int r = i >> 4, c = i & 15;
    const int k = ks + r, n = n0 + c * 8;
    int16_t* d = rw + r * Q_BN + c * 8;
    if (VEC) {
      const bool ok = k < ke && n < N;
      cp_async16(d, ok ? w + static_cast<size_t>(k) * N + n : w, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        d[q] = (k < ke && n + q < N) ? w[static_cast<size_t>(k) * N + n + q]
                                     : int16_t(0);
      }
    }
  }
}

__device__ __forceinline__ int lo16(uint32_t v) {
  return static_cast<int>(static_cast<int16_t>(v & 0xFFFFu));
}

__device__ __forceinline__ int hi16(uint32_t v) {
  return static_cast<int>(v) >> 16;
}

// a staged slab, sign-extended to int32: x transposed to [k][m] (lanes
// store consecutive m and read 80-byte-pitched rows, without bank
// conflicts), w in place
template <int BM>
__device__ __forceinline__ void widen(const int16_t* rx, const int16_t* rw,
                                      int* cx, int* cw) {
  const int tid = threadIdx.x;
  {
    const int m = tid % BM, c = tid / BM;
    const uint4 v =
        *reinterpret_cast<const uint4*>(rx + m * Q_RX_PITCH + c * 8);
    const uint32_t word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cx[(c * 8 + 2 * q) * BM + m] = lo16(word[q]);
      cx[(c * 8 + 2 * q + 1) * BM + m] = hi16(word[q]);
    }
  }
  for (int i = tid; i < Q_BK * Q_BN / 4; i += 4 * BM) {
    const uint2 v = *reinterpret_cast<const uint2*>(rw + i * 4);
    *reinterpret_cast<int4*>(cw + i * 4) =
        make_int4(lo16(v.x), hi16(v.x), lo16(v.y), hi16(v.y));
  }
}

template <int WARPS, bool VEC, bool SATURATE>
__global__ void __launch_bounds__(WARPS * 32, 2)
    q115_matmul_kernel(const int16_t* __restrict__ x,
                       const int16_t* __restrict__ w, void* __restrict__ out,
                       int M, int K, int N, int k_per, int split) {
  extern __shared__ __align__(16) char smem[];
  constexpr int BM = Q_TM * WARPS, THREADS = 32 * WARPS;
  constexpr int rx_tile = BM * Q_RX_PITCH, cx_tile = Q_BK * BM;
  int16_t* raw = reinterpret_cast<int16_t*>(smem);
  int* conv = reinterpret_cast<int*>(smem + Q_STAGES * (rx_tile + Q_RW_TILE) * 2);
  auto rx = [&](int s) { return raw + (s % Q_STAGES) * (rx_tile + Q_RW_TILE); };
  auto rw = [&](int s) { return rx(s) + rx_tile; };
  auto cx = [&](int s) { return conv + (s & 1) * (cx_tile + Q_CW_TILE); };
  auto cw = [&](int s) { return cx(s) + cx_tile; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * Q_BN, m0 = blockIdx.y * BM;
  const int kb = static_cast<int>(static_cast<long long>(blockIdx.z) * k_per);
  const int ke = static_cast<int>(min(static_cast<long long>(K),
                                      static_cast<long long>(kb) + k_per));
  const int nslab = ke > kb ? (ke - kb + Q_BK - 1) / Q_BK : 0;
  const bool active = m0 + warp * Q_TM < M;  // warp-uniform

  unsigned acc[Q_TM][Q_TN];
#pragma unroll
  for (int i = 0; i < Q_TM; ++i)
#pragma unroll
    for (int j = 0; j < Q_TN; ++j) acc[i][j] = 0u;

  // prologue: slabs 0 .. Q_STAGES-1 in flight (one group each, empty past
  // nslab), slab 0 widened
#pragma unroll
  for (int s = 0; s < Q_STAGES; ++s) {
    if (s < nslab) {
      stage<BM, VEC>(rx(s), rw(s), x, w, M, K, N, m0, n0, kb + s * Q_BK, ke);
    }
    cp_async_commit();
  }
  cp_async_wait<Q_STAGES - 1>();
  __syncthreads();
  if (nslab > 0) widen<BM>(rx(0), rw(0), cx(0), cw(0));

  for (int j = 0; j < nslab; ++j) {
    // slab j+1 has landed; slab j is widened; every thread is done with
    // raw slab j and with the int32 buffers of slab j-1
    cp_async_wait<Q_STAGES - 2>();
    __syncthreads();
    if (j + Q_STAGES < nslab) {
      stage<BM, VEC>(rx(j + Q_STAGES), rw(j + Q_STAGES), x, w, M, K, N, m0,
                     n0, kb + (j + Q_STAGES) * Q_BK, ke);
    }
    cp_async_commit();
    if (j + 1 < nslab) widen<BM>(rx(j + 1), rw(j + 1), cx(j + 1), cw(j + 1));
    if (!active) continue;
    const int* xs = cx(j) + warp * Q_TM;
    const int* wv = cw(j) + lane * Q_TN;
    // k of this slab in groups of 8; zero-filled k past ke add 0
    const int groups = (min(Q_BK, ke - kb - j * Q_BK) + 7) / 8;
    for (int g = 0; g < groups; ++g) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k = g * 8 + kk;
        const int4 xa = *reinterpret_cast<const int4*>(xs + k * BM);
        const int4 xb = *reinterpret_cast<const int4*>(xs + k * BM + 4);
        const int4 wk = *reinterpret_cast<const int4*>(wv + k * Q_BN);
        const int xr[Q_TM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const int wc[Q_TN] = {wk.x, wk.y, wk.z, wk.w};
#pragma unroll
        for (int i = 0; i < Q_TM; ++i)
#pragma unroll
          for (int c = 0; c < Q_TN; ++c)
            acc[i][c] += static_cast<unsigned>((xr[i] * wc[c] + (1 << 14)) >> 15);
      }
    }
  }

  // the cluster's K splits of this tile reduce through distributed shared
  // memory: each CTA puts its partial tile in its own (now idle) int32
  // buffers, then CTA r of C sums every C-th 4-column chunk over the C
  // partials and writes it: the whole sum (saturated, or raw) when the
  // cluster holds every split, else a raw partial by atomicAdd into the
  // zeroed output
  __syncthreads();
  int* red = conv;  // BM x Q_BN
#pragma unroll
  for (int i = 0; i < Q_TM; ++i) {
    *reinterpret_cast<uint4*>(red + (warp * Q_TM + i) * Q_BN + lane * Q_TN) =
        make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool whole = C == split;
  for (int q = rank + C * tid; q < BM * (Q_BN / 4); q += C * THREADS) {
    uint4 sum = make_uint4(0u, 0u, 0u, 0u);
    for (int p = 0; p < C; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(red, p) + q * 4);
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    const int m = m0 + q / (Q_BN / 4), n = n0 + (q % (Q_BN / 4)) * 4;
    if (m >= M) continue;
    const unsigned part[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (n + c >= N) break;
      const size_t at = static_cast<size_t>(m) * N + n + c;
      const int a = static_cast<int>(part[c]);
      if (SATURATE) {
        static_cast<int16_t*>(out)[at] =
            static_cast<int16_t>(min(max(a, -32768), 32767));
      } else if (whole) {
        static_cast<int*>(out)[at] = a;
      } else {
        atomicAdd(static_cast<int*>(out) + at, a);
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer reads its partial tile
}

template <int WARPS, bool VEC, bool SATURATE>
static cudaError_t launch(dim3 grid, int cluster, const int16_t* x,
                          const int16_t* w, void* out, int M, int K, int N,
                          int k_per, int split, cudaStream_t stream) {
  auto kernel = q115_matmul_kernel<WARPS, VEC, SATURATE>;
  const size_t smem = q_smem(WARPS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, out, M, K, N, k_per, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int WARPS>
static cudaError_t launch_warps(dim3 grid, int cluster, bool vec, bool saturate,
                               const int16_t* x, const int16_t* w, void* out,
                               int M, int K, int N, int k_per, int split,
                               cudaStream_t s) {
  if (vec) {
    return saturate ? launch<WARPS, true, true>(grid, cluster, x, w, out, M, K, N, k_per, split, s)
                    : launch<WARPS, true, false>(grid, cluster, x, w, out, M, K, N, k_per, split, s);
  }
  return saturate ? launch<WARPS, false, true>(grid, cluster, x, w, out, M, K, N, k_per, split, s)
                  : launch<WARPS, false, false>(grid, cluster, x, w, out, M, K, N, k_per, split, s);
}

// Grid (ceil(N / Q_BN), ceil(M / (Q_TM * warps)), split) with warps 4 or
// 8 and split = ceil(K / k_per_split).  out: int16 (saturate: at most
// Q_CLUSTER_MAX splits, reduced in one cluster along K) or int32 (M, N),
// which must be zeroed when K splits (its partials add by atomicAdd).
extern "C" int q115_matmul_launch(const void* x, const void* w, void* out,
                                  int M, int K, int N, int warps,
                                  int k_per_split, int saturate,
                                  void* stream) {
  if (M < 0 || K < 0 || N < 0 || (warps != 4 && warps != 8) ||
      k_per_split < Q_KSTEP || k_per_split % Q_KSTEP != 0) {
    return cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return cudaSuccess;
  const long long split =
      K > 0 ? (static_cast<long long>(K) + k_per_split - 1) / k_per_split : 1;
  const long long m_tiles = (M + Q_TM * warps - 1) / (Q_TM * warps);
  const long long n_tiles = (static_cast<long long>(N) + Q_BN - 1) / Q_BN;
  if (m_tiles > 65535 || split > 65535 || n_tiles > 0x7fffffff ||
      (saturate && split > Q_CLUSTER_MAX)) {
    return cudaErrorInvalidValue;
  }
  const int cluster = saturate ? static_cast<int>(split) : 1;
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(m_tiles),
                  static_cast<unsigned>(split));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int16_t* xp = static_cast<const int16_t*>(x);
  const int16_t* wp = static_cast<const int16_t*>(w);
  const int sp = static_cast<int>(split);
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) % 16) == 0;
  const bool sat = saturate != 0;
  return warps == 4
             ? launch_warps<4>(grid, cluster, vec, sat, xp, wp, out, M, K, N, k_per_split, sp, s)
             : launch_warps<8>(grid, cluster, vec, sat, xp, wp, out, M, K, N, k_per_split, sp, s);
}

// The inner loop's instruction pair alone, on registers: per product one
// mad.lo (IMAD x * w + 2^14) and the shift-add (LEA.HI.SX32), 32
// independent sums a thread, `rounds` times.  The volatile mad keeps the
// compiler from hoisting the products out of the loop.  chip_smoke.py
// phase 8 times it on every SM to measure the products a second the card
// can issue, the ceiling the kernel's bound assumes.
__global__ void __launch_bounds__(256)
    q115_rate_kernel(int* __restrict__ out, int rounds) {
  int xr[Q_TM], wc[Q_TN];
#pragma unroll
  for (int i = 0; i < Q_TM; ++i) xr[i] = static_cast<int>(threadIdx.x) - 3 * i;
#pragma unroll
  for (int c = 0; c < Q_TN; ++c) wc[c] = 1000 * c + static_cast<int>(blockIdx.x);
  unsigned acc[Q_TM][Q_TN];
#pragma unroll
  for (int i = 0; i < Q_TM; ++i)
#pragma unroll
    for (int c = 0; c < Q_TN; ++c) acc[i][c] = 0u;
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int i = 0; i < Q_TM; ++i)
#pragma unroll
      for (int c = 0; c < Q_TN; ++c) {
        int p;
        asm volatile("mad.lo.s32 %0, %1, %2, 16384;\n"
                     : "=r"(p) : "r"(xr[i]), "r"(wc[c]));
        acc[i][c] += static_cast<unsigned>(p >> 15);
      }
  }
  unsigned total = 0u;
#pragma unroll
  for (int i = 0; i < Q_TM; ++i)
#pragma unroll
    for (int c = 0; c < Q_TN; ++c) total += acc[i][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<int>(total);
}

// blocks x threads threads (out holds one int each), each making
// rounds * 32 products
extern "C" int q115_rate_launch(void* out, int blocks, int threads,
                                int rounds, void* stream) {
  if (blocks < 1 || threads < 32 || threads > 256 || rounds < 0) {
    return cudaErrorInvalidValue;
  }
  q115_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), rounds);
  return cudaGetLastError();
}
