// Spike x weight integration (the paper's cascaded adder) for Hopper
// (sm_90a), on the int8 tensor cores.
//
// Replaces repro/kernels/spike_matmul.py::spike_matmul (the Pallas
// `_spike_mm_kernel`): int8 spikes (M, K) times int16 Q1.15 codes (K, N)
//
//   out[m, n] = sum_k s[m, k] * w[k, n]     (int32, wrapping)
//
// the integer product the reference's oracle computes (a dot_general), so
// a spike value other than 0 or 1 multiplies; it is not read as 1.
//
// Weight split: w = 256 * hi + lo with hi = w >> 8 (signed, -128..127) and
// lo = w & 0xFF (unsigned, 0..255).  Two IMMA products run into two int32
// accumulators, s x hi with mma.sync m16n8k32 .s8.s8 and s x lo with the
// mixed .s8.u8 form, and out = (acc_hi << 8) + acc_lo in unsigned 32-bit
// arithmetic.  No .satfinite: both accumulators wrap, so the result equals
// the true sum mod 2^32, which is the plain version's int32 wrap.
//
// Design: a CTA of 8 warps owns a 128 x 64 output tile (warps 4 x 2, each
// 32 x 32) and one contiguous range of K slabs of 64 (split-K: the planner
// in kernels/spike_matmul.py picks the split so about one CTA runs per SM;
// partial tiles combine by int32 atomicAdd into an output the wrapper
// zeroes, which wraps and commutes, so any order is bit-exact).  Copies
// run in a shared-memory ring with 16-byte cp.async: spikes four slabs
// ahead of the MMAs, weights two slabs ahead, so two slabs' copies are in
// flight while a slab's MMAs run.  When slab j+2's spikes have landed,
// __syncthreads_or asks whether any is nonzero (the Pallas gate);
// a silent slab's weights are never copied and its MMAs are skipped.  The
// B operand of an 8-bit MMA must be K-major but w is N-major, so each
// slab's raw (64 k x 64 n) int16 tile is transposed in shared memory into
// K-contiguous hi and lo words (4 k x 4 n a thread, built with
// __byte_perm), in an XOR-swizzled layout that the fragment loads read
// without bank conflicts.  A shape whose rows are not 16-byte aligned
// (K % 16, N % 8, or an unaligned pointer) stages the same tiles through
// plain loads instead of cp.async.  Every edge is masked and zero-filled:
// any M, K, N works.
//
// Bounds: at the hardware path's layer 0, (200, 4096) x (4096, 512), the
// function must move 0.82 + 4.19 + 0.41 MB, 1.6 us at 3.35 TB/s; its
// 1.68 G int8 operations (two halves) take 0.85 us at 1,979 TOP/s.  The
// grid there is 8 N-tiles x 2 M-tiles x 8 K-splits = 128 CTAs, which read
// W from HBM once and from L2 twice (two M tiles); each CTA's 8 slabs pay
// an L2 round trip each, so latency, not the tensor cores, sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

#define SMM_BM 128
#define SMM_BN 64
#define SMM_BK 64  // bytes of spikes = int16 weights along k per slab
#define SMM_THREADS 256
#define SMM_S_AHEAD 4   // spike slabs staged ahead of the MMAs
#define SMM_S_STAGES 5  // SMM_S_AHEAD + the slab in the MMAs
#define SMM_W_STAGES 3  // weights two slabs ahead + the slab being transposed
#define SMM_S_ROW 80    // bytes per spike row: 64 + 16 pad (conflict-free A loads)
#define SMM_W_ROW 144   // bytes per raw weight row: 128 + 16 pad
#define SMM_T_WORDS 16  // 32-bit words per transposed weight row (64 k bytes)
#define SMM_S_TILE (SMM_BM * SMM_S_ROW)
#define SMM_W_TILE (SMM_BK * SMM_W_ROW)
#define SMM_T_TILE (SMM_BN * SMM_T_WORDS * 4)
#define SMM_SMEM \
  (SMM_S_STAGES * SMM_S_TILE + SMM_W_STAGES * SMM_W_TILE + 2 * SMM_T_TILE)

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// word of the transposed tile holding k-word kw of column n: XOR-swizzled
// so that both the fragment loads (8 columns x 4 words) and the transpose
// stores hit distinct banks
__device__ __forceinline__ int t_index(int n, int kw) {
  const int sw = ((((n >> 1) & 3) << 2) ^ (((n >> 3) & 7) << 1));
  return n * SMM_T_WORDS + (kw ^ sw);
}

template <bool VEC>
__device__ __forceinline__ void load_spikes(int8_t* dst, const int8_t* s,
                                            int M, int K, int m0, int k0) {
  // SMM_BM rows x 4 chunks of 16 bytes
  for (int i = threadIdx.x; i < SMM_BM * 4; i += SMM_THREADS) {
    const int r = i >> 2, c = i & 3;
    const int m = m0 + r, k = k0 + c * 16;
    int8_t* d = dst + r * SMM_S_ROW + c * 16;
    if (VEC) {
      const bool ok = m < M && k < K;
      cp_async16(d, ok ? s + static_cast<size_t>(m) * K + k : s, ok ? 16 : 0);
    } else {
      uint32_t word[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int kk = k + q * 4 + b;
          const uint32_t x =
              (m < M && kk < K)
                  ? static_cast<uint8_t>(s[static_cast<size_t>(m) * K + kk])
                  : 0u;
          v |= x << (8 * b);
        }
        word[q] = v;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_weights(char* dst, const int16_t* w,
                                             int K, int N, int k0, int n0) {
  // SMM_BK rows x 8 chunks of 16 bytes (8 int16)
  for (int i = threadIdx.x; i < SMM_BK * 8; i += SMM_THREADS) {
    const int r = i >> 3, c = i & 7;
    const int k = k0 + r, n = n0 + c * 8;
    char* d = dst + r * SMM_W_ROW + c * 16;
    if (VEC) {
      const bool ok = k < K && n < N;
      cp_async16(d, ok ? w + static_cast<size_t>(k) * N + n : w, ok ? 16 : 0);
    } else {
      uint32_t word[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nn = n + q * 2 + h;
          const uint32_t x =
              (k < K && nn < N)
                  ? static_cast<uint16_t>(w[static_cast<size_t>(k) * N + nn])
                  : 0u;
          v |= x << (16 * h);
        }
        word[q] = v;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
}

// raw (k, n) int16 tile -> K-contiguous hi and lo byte words per column
__device__ __forceinline__ void transpose_weights(const char* raw,
                                                  uint32_t* t_hi,
                                                  uint32_t* t_lo) {
  const int nq = threadIdx.x & 15;  // n = 4 nq .. 4 nq + 3
  const int kq = threadIdx.x >> 4;  // k = 4 kq .. 4 kq + 3
  uint2 row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = *reinterpret_cast<const uint2*>(raw + (kq * 4 + i) * SMM_W_ROW +
                                             nq * 8);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // bytes of row i for column 4 nq + j: lo at 2 (j & 1), hi just above
    const unsigned sel = (j & 1) ? 0x7362u : 0x5140u;
    const uint32_t p01 = __byte_perm((j < 2) ? row[0].x : row[0].y,
                                     (j < 2) ? row[1].x : row[1].y, sel);
    const uint32_t p23 = __byte_perm((j < 2) ? row[2].x : row[2].y,
                                     (j < 2) ? row[3].x : row[3].y, sel);
    const int idx = t_index(nq * 4 + j, kq);
    t_lo[idx] = __byte_perm(p01, p23, 0x5410u);
    t_hi[idx] = __byte_perm(p01, p23, 0x7632u);
  }
}

__device__ __forceinline__ void mma_s8s8(int* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8u8(int* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool VEC>
__global__ void __launch_bounds__(SMM_THREADS)
    spike_matmul_kernel(const int8_t* __restrict__ s,
                        const int16_t* __restrict__ w, int* __restrict__ out,
                        int M, int K, int N, int slabs_per_split, int atomic) {
  extern __shared__ __align__(16) char smem[];
  int8_t* s_tiles = reinterpret_cast<int8_t*>(smem);
  char* w_tiles = smem + SMM_S_STAGES * SMM_S_TILE;
  uint32_t* t_hi = reinterpret_cast<uint32_t*>(w_tiles + SMM_W_STAGES * SMM_W_TILE);
  uint32_t* t_lo = t_hi + SMM_BN * SMM_T_WORDS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int n0 = blockIdx.x * SMM_BN;
  const int m0 = blockIdx.y * SMM_BM;
  const int slabs = (K + SMM_BK - 1) / SMM_BK;
  const int j0 = blockIdx.z * slabs_per_split;
  const int nj = max(0, min(slabs, j0 + slabs_per_split) - j0);

  int acc_hi[2][4][4], acc_lo[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_hi[mi][ni][r] = acc_lo[mi][ni][r] = 0;

  // any nonzero spike in the staged tile (rows past M and k past K are 0)
  auto live_tile = [&](const int8_t* tile) {
    bool any = false;
    for (int i = tid; i < SMM_BM * 4; i += SMM_THREADS) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          tile + (i >> 2) * SMM_S_ROW + (i & 3) * 16);
      any |= (v.x | v.y | v.z | v.w) != 0u;
    }
    return __syncthreads_or(any) != 0;
  };

  auto s_tile = [&](int j) { return s_tiles + (j % SMM_S_STAGES) * SMM_S_TILE; };
  auto w_tile = [&](int j) { return w_tiles + (j % SMM_W_STAGES) * SMM_W_TILE; };
  // prologue: slabs 0..3's spikes; then the gate and weights of slabs 0
  // and 1, one cp.async group each
  for (int q = 0; q < SMM_S_AHEAD && q < nj; ++q) {
    load_spikes<VEC>(s_tile(q), s, M, K, m0, (j0 + q) * SMM_BK);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  bool live = nj > 0 && live_tile(s_tile(0));
  if (live) load_weights<VEC>(w_tile(0), w, K, N, j0 * SMM_BK, n0);
  cp_async_commit();
  bool live1 = nj > 1 && live_tile(s_tile(1));
  if (live1) load_weights<VEC>(w_tile(1), w, K, N, (j0 + 1) * SMM_BK, n0);
  cp_async_commit();
  for (int j = 0; j < nj; ++j) {
    // the group of iteration j - 2 has landed: slab j's weights and slab
    // j+2's spikes; iteration j - 1's copies stay in flight
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const bool live2 = j + 2 < nj ? live_tile(s_tile(j + 2)) : false;
    if (live2) {
      load_weights<VEC>(w_tile(j + 2), w, K, N, (j0 + j + 2) * SMM_BK, n0);
    }
    if (j + SMM_S_AHEAD < nj) {
      load_spikes<VEC>(s_tile(j + SMM_S_AHEAD), s, M, K, m0,
                       (j0 + j + SMM_S_AHEAD) * SMM_BK);
    }
    cp_async_commit();
    if (live) {
      transpose_weights(w_tile(j), t_hi, t_lo);
      __syncthreads();
      const uint32_t* a_tile = reinterpret_cast<const uint32_t*>(s_tile(j));
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r0 = (wm * 32 + mi * 16 + g) * (SMM_S_ROW / 4) + ks * 8 + t;
          a[mi][0] = a_tile[r0];
          a[mi][1] = a_tile[r0 + 8 * (SMM_S_ROW / 4)];
          a[mi][2] = a_tile[r0 + 4];
          a[mi][3] = a_tile[r0 + 8 * (SMM_S_ROW / 4) + 4];
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn * 32 + ni * 8 + g;
          const int i0 = t_index(n, ks * 8 + t);
          const int i1 = t_index(n, ks * 8 + 4 + t);
          const uint32_t bh0 = t_hi[i0], bh1 = t_hi[i1];
          const uint32_t bl0 = t_lo[i0], bl1 = t_lo[i1];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_s8s8(acc_hi[mi][ni], a[mi], bh0, bh1);
            mma_s8u8(acc_lo[mi][ni], a[mi], bl0, bl1);
          }
        }
      }
    }
    live = live1;
    live1 = live2;
  }
  cp_async_wait_all();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 32 + mi * 16 + g + (r >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + t * 2 + (r & 1);
        if (m >= M || n >= N) continue;
        const unsigned v = (static_cast<unsigned>(acc_hi[mi][ni][r]) << 8) +
                           static_cast<unsigned>(acc_lo[mi][ni][r]);
        int* o = out + static_cast<size_t>(m) * N + n;
        if (atomic) {
          atomicAdd(o, static_cast<int>(v));
        } else {
          *o = static_cast<int>(v);
        }
      }
}

template <bool VEC>
static cudaError_t launch(dim3 grid, const int8_t* s, const int16_t* w,
                          int* out, int M, int K, int N, int per, int atomic,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spike_matmul_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMM_SMEM);
  if (err != cudaSuccess) return err;
  spike_matmul_kernel<VEC><<<grid, SMM_THREADS, SMM_SMEM, stream>>>(
      s, w, out, M, K, N, per, atomic);
  return cudaGetLastError();
}

// split: CTAs along K, each taking ceil(slabs / split) slabs of SMM_BK.
// With split > 1 the CTAs add into `out`, which the caller zeroes.
extern "C" int spike_matmul_launch(const void* spikes, const void* weights,
                                   void* out, int M, int K, int N, int split,
                                   void* stream) {
  if (M < 0 || K < 0 || N < 0 || split < 1) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const int slabs = (K + SMM_BK - 1) / SMM_BK;
  const int per = slabs > 0 ? (slabs + split - 1) / split : 0;
  const dim3 grid((N + SMM_BN - 1) / SMM_BN, (M + SMM_BM - 1) / SMM_BM, split);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(spikes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(weights) % 16 == 0;
  const int8_t* s = static_cast<const int8_t*>(spikes);
  const int16_t* w = static_cast<const int16_t*>(weights);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int atomic = split > 1;
  return vec ? launch<true>(grid, s, w, o, M, K, N, per, atomic, st)
             : launch<false>(grid, s, w, o, M, K, N, per, atomic, st);
}
