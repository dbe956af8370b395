// Absorbed multi-head latent attention (MLA) for one decode step, against
// the full bfloat16 latent cache, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs the absorbed decode as plain
// jnp (models/attention.py::_mla_attend, absorb branch), and so did the
// port (models/attention.py::_mla_latent), which cast the whole latent
// cache to float32 (c_kv and k_rope, all S rows) every layer of every
// decode step, took the scores by float32 products over all S rows, the
// masked ones too, and read all of c_kv again for the context.  This
// kernel was added for that cache traffic.
//
// For one new token a row b and head h, with the absorbed query
// q_eff (B, 1, H, 512) and q_rope (B, 1, H, 64) against the cache
// c_kv (B, S, 512) and k_rope (B, S, 64), all bfloat16, and the positions
// pos (B,) int64 read on the device (so a CUDA graph replays the launch
// for every step), with n_b = min(pos[b] + 1, S) valid rows:
//
//   s_j = (float32(q_eff . c_kv_j) + float32(q_rope . k_rope_j)) * scale
//   w_j = bf16(expf(s_j - max_j s) / sum_j expf(s_j - max_j s))
//   ctx = bf16(sum_j w_j * c_kv_j)                 accumulated in float32
//
// written as (B, 1, H, 512).  These are the rounding points of the plain
// version: its scores are float32 products of bfloat16 values (each
// product exact in float32), the latent part and the rope part summed
// apart, added, times the scale; a masked row's score is -1e30, whose exp
// is exactly 0 in float32 beside any valid row, so leaving out the rows
// j >= n_b is the same arithmetic; softmax in float32 (expf, division by
// the sum), the weights rounded to bfloat16 once normalised; the context
// a float32 sum of bfloat16 products (exact in float32), rounded once.
// Only the order of the float32 sums differs.  A row with pos[b] < 0 has
// no valid row, and the plain version then weighs all S rows alike
// (every score -1e30): the kernel does the same.  Deterministic: no
// atomics, every sum in a fixed order.
//
// Bound: the bytes of the valid cache rows, each read once: n_b * 1,152
// bytes a row, 189 MB a launch at the DeepSeek serving cell's shape (B
// 128, S 1,536, ~1,280 valid rows), 56 us at 3.35 TB/s.  The products,
// 16 x (576 + 512) x 2 FLOP a cache row and row b, are 5.7 GFLOP, 85 us on
// float32 FFMA, so both go through the tensor cores (mma.sync bf16 with
// float32 sums; the products are exact, so only the order of sums
// differs).
//
// Design: a cluster of MLA_CLUSTER CTAs per (row b, 16 heads); CTA r holds
// rows [r R, (r + 1) R) of the row's cache in shared memory (R = 64, 128
// or 192 rows: S <= 1,536), read once from device memory with 16-byte
// cp.async in groups of 64 rows, rows past n_b zero-filled and whole
// groups past them not read.  The 16 heads are the M = 16 of every
// mma.m16n8k16.  Scores: warp w takes 8 cache rows of each group as one
// n-tile; the query's fragments (36 k-steps) sit in registers, loaded
// with 16-byte loads before the cache rows are asked for (the k order of
// the dot product is permuted to allow that: load_q), so a group's scores
// are taken as soon as its rows land.  The softmax's max and sum are
// reduced in the warp (quad shuffles), over the warps in order, and over
// the cluster's CTAs in rank order: each CTA sends its 16 values into
// every CTA's shared memory (st.async, counted by the receiver's
// mbarrier), and each reads them locally once they are all there.  The
// bf16 weights go to shared memory over the dead k_rope rows; then the
// context: warp w takes 64 of the 512 latent columns over the CTA's rows,
// B from the resident c_kv rows (ldmatrix.trans), so c_kv is read from
// device memory once.  CTA r owns columns [64 r, 64 r + 64) of the
// output: warp r of every other CTA sends its float32 partial of them into
// CTA r the same way, and CTA r sums the 8 partials in rank order and
// rounds once.  Rows sit in shared memory with their 16-byte chunks
// swizzled (at_chunk), so every ldmatrix and 16-byte load is free of bank
// conflicts.  The grid (MLA_CLUSTER, H / 16, B) depends on S only, never
// on pos.
//
// What bounds it (measured on an NVIDIA H100 80GB HBM3 at 700 W, at the
// cell's shape, 0.11-0.12 ms a launch): 15 clusters of 8 fit the card at
// once, so a launch is ~9 waves of 15 rows.  A CTA lives ~11 us: its rows
// land ~4.6 us after it starts, and the rest is latency, during which its
// shared memory, full of rows, admits no next CTA to the SM: the last
// group's scores (0.8 us), the two exchanges (0.5 us each), the weights
// (0.5 us), the context's products and the partials' sends (2.8 us) and
// the final sum (0.5 us).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MLA_THREADS 256    // threads a CTA (kernels/mla_decode.py: THREADS)
#define MLA_WARPS 8        // MLA_THREADS / 32
#define MLA_CLUSTER 8      // CTAs a (row, 16 heads) (mla_decode.py: CLUSTER)
#define MLA_HEADS 16       // heads a CTA, the M of every mma (mla_decode.py: HEADS)
#define MLA_RANK 512       // kv_lora_rank (mla_decode.py: RANK)
#define MLA_ROPE 64        // qk_rope_head_dim (mla_decode.py: ROPE)
#define MLA_GROUP 64       // cache rows a cp.async group, 8 a warp (mla_decode.py: GROUP)
#define MLA_GROUPS_MAX 3   // groups a CTA holds (mla_decode.py: GROUPS_MAX)
#define MLA_SMEM_MAX 232448  // shared memory a CTA may take on an H100, static included

namespace cg = cooperative_groups;

namespace {

constexpr float kMasked = -1e30f;  // the plain version's NEG_INF

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 16-byte copy into shared memory, zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void lds128(uint4& v, uint32_t addr) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
}

// The scores' k order: a dot product may take its terms in any order, so
// lane (g, t) of an mma holds, for k-steps 2 k2 and 2 k2 + 1, the eight
// values 32 k2 + 8 t .. 32 k2 + 8 t + 7 of its query rows and of its cache
// row: one 16-byte load each.  Of each 16-byte vector, words x and y are
// k-step 2 k2's {2t, 2t + 1} and {2t + 8, 2t + 9}, words z and w k-step
// 2 k2 + 1's.  q[k2][0] is row g of a (16, D) row-major tile, q[k2][1]
// row g + 8.
template <int K2, int D>
__device__ __forceinline__ void load_q(uint4 (&q)[K2][2], const __nv_bfloat16* tile,
                                       int g, int t) {
#pragma unroll
  for (int k2 = 0; k2 < K2; ++k2) {
    const __nv_bfloat16* at = tile + g * D + 32 * k2 + 8 * t;
    q[k2][0] = __ldg(reinterpret_cast<const uint4*>(at));
    q[k2][1] = __ldg(reinterpret_cast<const uint4*>(at + 8 * D));
  }
}

// the scores' two mma of k-steps 2 k2, 2 k2 + 1 (module comment above)
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint4 (&q)[2], const uint4& kv) {
  const uint32_t a0[4] = {q[0].x, q[1].x, q[0].y, q[1].y};
  const uint32_t a1[4] = {q[0].z, q[1].z, q[0].w, q[1].w};
  mma(c0, a0, kv.x, kv.y);
  mma(c1, a1, kv.z, kv.w);
}

// the swizzled byte offset of 16-byte chunk `ch` of row `r` (pitch bytes):
// the chunk's low three bits are XORed with a bijection of r % 8 whose
// top bit is r % 2, so 8 consecutive rows at one chunk (ldmatrix) and 2
// rows x 4 aligned chunks (a quarter warp's 16-byte loads) each fall on
// distinct banks
__device__ __forceinline__ uint32_t at_chunk(int r, int ch, int pitch) {
  const int swz = ((r & 1) << 2) | ((r >> 1) & 3);
  return static_cast<uint32_t>(r * pitch + ((ch ^ swz) << 4));
}

// Distributed shared memory with transaction barriers: a CTA's exchange
// buffers each have an mbarrier that expects the bytes its peers send
// with st.async, so a CTA waits for its own data alone, and no cluster
// barrier follows the first.
__device__ __forceinline__ uint32_t peer(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void bar_init(uint32_t bar, int bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar) {  // its first phase
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// 16 bytes into a peer's shared memory, counted by the peer's barrier
__device__ __forceinline__ void send(uint32_t to, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(to),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// a quad's four lanes (one row of an mma tile) reduced; every lane ends
// with the same value
template <bool kMax>
__device__ __forceinline__ float quad_reduce(float x) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : __fadd_rn(x, y);
  }
  return x;
}

// Shared memory of a CTA holding R cache rows (bytes; kernels/mla_decode.py
// ::smem computes the same).  The c_kv rows come first; the k_rope rows
// after them are reused once the scores are taken, and the region past
// them holds what the cluster pushes:
//   [0, W)           the CTAs' sums, [rank][16] float, pushed after the
//                    maxima; then the weights, [16][R] bf16, chunks
//                    swizzled; then this CTA's own partial context of its
//                    64 columns, [16][64] float
//   [STAT, +128)     the row's max and sum, [2][16] float
//   [RECV, +28,672)  the peers' partial contexts of this CTA's 64 columns,
//                    [7 slots][16][64] float, pushed after the sums; its
//                    last 1,024 bytes, past the k_rope rows, hold first the
//                    per-warp maxima and sums, [8][16] float (written while
//                    other warps still read the k_rope rows), and the CTAs'
//                    maxima, [rank][16] float (pushed while this CTA may
//                    still read them)
// and last the three exchanges' mbarriers (maxima, sums, partials).
template <int R>
struct Layout {
  static constexpr int kXch = MLA_CLUSTER * MLA_HEADS * 4;
  static constexpr int kSlot = MLA_HEADS * 64 * 4;
  static constexpr int kCkv = R * MLA_RANK * 2;
  static constexpr int kKr = R * MLA_ROPE * 2;
  static constexpr int kW = R * MLA_HEADS * 2 > kSlot ? R * MLA_HEADS * 2 : kSlot;
  static constexpr int kStat = kW;
  static constexpr int kRecv = kStat + 2 * MLA_HEADS * 4;
  static constexpr int kRecvBytes = (MLA_CLUSTER - 1) * kSlot;
  static constexpr int kWarp = kRecv + kRecvBytes - MLA_WARPS * MLA_HEADS * 4 - kXch;
  static constexpr int kMaxx = kRecv + kRecvBytes - kXch;
  static constexpr int kBars = kCkv + kRecv + kRecvBytes;  // 3 mbarriers
  static constexpr int kBytes = kBars + 3 * 8;
  static_assert(kWarp >= kKr, "the per-warp values must lie past the k_rope rows");
  static_assert(kBytes <= MLA_SMEM_MAX, "a CTA's rows must fit its shared memory");
};

// the float offset of (head h, column c) in a [16][64] partial context:
// its 8-float blocks XORed with a key of h whose low two bits differ
// between h, h + 1, h + 8 and h + 9 (h even), so a quarter warp's 16-byte
// pushes and reads fall on distinct banks
__device__ __forceinline__ int at_part(int h, int c) {
  const int key = (h & 7) ^ ((h >> 3) << 1);
  return h * 64 + (((c >> 3) ^ key) << 3) + (c & 7);
}

// NG groups of MLA_GROUP cache rows a CTA
template <int NG>
__global__ void __cluster_dims__(MLA_CLUSTER, 1, 1) __launch_bounds__(MLA_THREADS, 1)
    mla_decode_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ qr,
                      const __nv_bfloat16* __restrict__ ckv,
                      const __nv_bfloat16* __restrict__ kr,
                      const long long* __restrict__ pos,
                      __nv_bfloat16* __restrict__ out, int S, int H,
                      float scale) {
  constexpr int R = NG * MLA_GROUP;       // cache rows this CTA holds
  constexpr int CKV_PITCH = MLA_RANK * 2;  // bytes a c_kv row
  constexpr int KR_PITCH = MLA_ROPE * 2;   // bytes a k_rope row
  constexpr int W_PITCH = R * 2;           // bytes a head's weights
  using L = Layout<R>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_ckv = smem;
  unsigned char* s_kr = smem + L::kCkv;
  float* s_sumx = reinterpret_cast<float*>(s_kr);
  float* s_own = reinterpret_cast<float*>(s_kr);
  float* s_stat = reinterpret_cast<float*>(s_kr + L::kStat);
  float* s_recv = reinterpret_cast<float*>(s_kr + L::kRecv);
  float* s_warp = reinterpret_cast<float*>(s_kr + L::kWarp);
  float* s_maxx = reinterpret_cast<float*>(s_kr + L::kMaxx);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int hg = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long p = pos[b];
  const bool none = p < 0;
  const int n = none ? S : static_cast<int>(p + 1 < S ? p + 1 : S);
  const int j0 = rank * R;
  const int rows = max(0, min(n - j0, R));  // valid rows of this CTA's part
  const uint32_t ckv_s = smem_addr(s_ckv), kr_s = smem_addr(s_kr);
  const uint32_t bars = smem_addr(smem + L::kBars);  // maxima, sums, partials
  if (tid == 0) {
    bar_init(bars, MLA_CLUSTER * MLA_HEADS * 4);
    bar_init(bars + 8, MLA_CLUSTER * MLA_HEADS * 4);
    bar_init(bars + 16, L::kRecvBytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA's barriers are ready before any peer sends (waited for
  // after the scores, so the loads hide it)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // ---- the 16 heads' query fragments, in registers for every group;
  // asked for before the cache rows, so they do not queue behind them
  const size_t head0 = static_cast<size_t>(b) * H + hg * MLA_HEADS;
  uint4 qa[MLA_RANK / 32][2], qra[MLA_ROPE / 32][2];
  load_q<MLA_RANK / 32, MLA_RANK>(qa, q + head0 * MLA_RANK, g, t);
  load_q<MLA_ROPE / 32, MLA_ROPE>(qra, qr + head0 * MLA_ROPE, g, t);

  // ---- this CTA's valid cache rows into shared memory, a group of 64
  // rows a cp.async group (rows past n_b zero-filled, groups past it not
  // read; every thread commits NG groups)
  {
    const __nv_bfloat16* cb = ckv + static_cast<size_t>(b) * S * MLA_RANK;
    const __nv_bfloat16* kb = kr + static_cast<size_t>(b) * S * MLA_ROPE;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      if (gi * MLA_GROUP < rows) {
        for (int i = tid; i < MLA_GROUP * (CKV_PITCH / 16); i += MLA_THREADS) {
          const int r = gi * MLA_GROUP + i / (CKV_PITCH / 16);
          const int ch = i % (CKV_PITCH / 16);
          const bool ok = r < rows;
          cp16(ckv_s + at_chunk(r, ch, CKV_PITCH),
               cb + static_cast<size_t>(ok ? j0 + r : 0) * MLA_RANK + ch * 8, ok);
        }
        for (int i = tid; i < MLA_GROUP * (KR_PITCH / 16); i += MLA_THREADS) {
          const int r = gi * MLA_GROUP + i / (KR_PITCH / 16);
          const int ch = i % (KR_PITCH / 16);
          const bool ok = r < rows;
          cp16(kr_s + at_chunk(r, ch, KR_PITCH),
               kb + static_cast<size_t>(ok ? j0 + r : 0) * MLA_ROPE + ch * 8, ok);
        }
      }
      cp_commit();
    }
  }

  // ---- scores, a group at a time as its rows land: warp w takes the
  // group's rows 8w .. 8w + 7.  sc[gi][e] is head g + 8 (e >> 1), row
  // gi * 64 + 8w + 2t + (e & 1) of this CTA's part
  float sc[NG][4];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    cp_wait(NG - 1 - gi);
    __syncthreads();
    const int r0 = gi * MLA_GROUP + warp * 8;
    // two sums over the latent k-steps (even, odd) halve the chain of
    // dependent mma; the order is fixed
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
    float r0s[4] = {0.f, 0.f, 0.f, 0.f}, r1s[4] = {0.f, 0.f, 0.f, 0.f};
    if (!none && r0 < rows) {  // uniform over the warp
      // lane (g, t) reads chunk 4 k2 + t of cache row r0 + g
#pragma unroll
      for (int k2 = 0; k2 < MLA_RANK / 32; ++k2) {
        uint4 kv;
        lds128(kv, ckv_s + at_chunk(r0 + g, 4 * k2 + t, CKV_PITCH));
        mma_pair(a0, a1, qa[k2], kv);
      }
#pragma unroll
      for (int k2 = 0; k2 < MLA_ROPE / 32; ++k2) {
        uint4 kv;
        lds128(kv, kr_s + at_chunk(r0 + g, 4 * k2 + t, KR_PITCH));
        mma_pair(r0s, r1s, qra[k2], kv);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = r0 + 2 * t + (e & 1);
      sc[gi][e] = j >= rows ? -INFINITY
                  : none    ? kMasked
                            : __fmul_rn(__fadd_rn(__fadd_rn(a0[e], a1[e]),
                                                  __fadd_rn(r0s[e], r1s[e])),
                                        scale);
    }
  }

  // ---- the row's max: lanes of a quad, warps in order; each CTA pushes
  // its 16 maxima into every CTA of the cluster (thread c * 4 + i four of
  // them into CTA c), which takes them in rank order
  float m0 = -INFINITY, m1 = -INFINITY;  // heads g, g + 8
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    m0 = fmaxf(m0, fmaxf(sc[gi][0], sc[gi][1]));
    m1 = fmaxf(m1, fmaxf(sc[gi][2], sc[gi][3]));
  }
  m0 = quad_reduce<true>(m0);
  m1 = quad_reduce<true>(m1);
  if (t == 0) {
    s_warp[warp * MLA_HEADS + g] = m0;
    s_warp[warp * MLA_HEADS + g + 8] = m1;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int hq = (tid & 3) * 4, to = tid >> 2;  // the pushes' heads and CTA
  if (tid < MLA_CLUSTER * 4) {
    float4 m = *reinterpret_cast<const float4*>(s_warp + hq);
#pragma unroll
    for (int w = 1; w < MLA_WARPS; ++w) {
      const float4 u = *reinterpret_cast<const float4*>(s_warp + w * MLA_HEADS + hq);
      m = make_float4(fmaxf(m.x, u.x), fmaxf(m.y, u.y), fmaxf(m.z, u.z), fmaxf(m.w, u.w));
    }
    send(peer(smem_addr(s_maxx + rank * MLA_HEADS + hq), to), m, peer(bars, to));
  }
  if (tid < MLA_HEADS) {
    bar_wait(bars);
    float m = s_maxx[tid];
#pragma unroll
    for (int c = 1; c < MLA_CLUSTER; ++c) m = fmaxf(m, s_maxx[c * MLA_HEADS + tid]);
    s_stat[tid] = m;
  }
  __syncthreads();
  m0 = s_stat[g];
  m1 = s_stat[g + 8];

  // ---- exps and the row's sum, in the same order (every CTA is past its
  // scores when the sums arrive)
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[gi][e] = expf(__fsub_rn(sc[gi][e], e < 2 ? m0 : m1));
    l0 = __fadd_rn(__fadd_rn(l0, sc[gi][0]), sc[gi][1]);
    l1 = __fadd_rn(__fadd_rn(l1, sc[gi][2]), sc[gi][3]);
  }
  l0 = quad_reduce<false>(l0);
  l1 = quad_reduce<false>(l1);
  if (t == 0) {  // every read of the maxima passed the cluster barrier
    s_warp[warp * MLA_HEADS + g] = l0;
    s_warp[warp * MLA_HEADS + g + 8] = l1;
  }
  __syncthreads();
  if (tid < MLA_CLUSTER * 4) {
    float4 l = *reinterpret_cast<const float4*>(s_warp + hq);
#pragma unroll
    for (int w = 1; w < MLA_WARPS; ++w) {
      const float4 u = *reinterpret_cast<const float4*>(s_warp + w * MLA_HEADS + hq);
      l = make_float4(__fadd_rn(l.x, u.x), __fadd_rn(l.y, u.y), __fadd_rn(l.z, u.z),
                      __fadd_rn(l.w, u.w));
    }
    send(peer(smem_addr(s_sumx + rank * MLA_HEADS + hq), to), l, peer(bars + 8, to));
  }
  if (tid < MLA_HEADS) {
    bar_wait(bars + 8);
    float l = s_sumx[tid];
#pragma unroll
    for (int c = 1; c < MLA_CLUSTER; ++c) l = __fadd_rn(l, s_sumx[c * MLA_HEADS + tid]);
    s_stat[MLA_HEADS + tid] = l;
  }
  __syncthreads();  // also: every read of the sums is done before the weights
  l0 = s_stat[MLA_HEADS + g];
  l1 = s_stat[MLA_HEADS + g + 8];

  // ---- the weights, bf16 once normalised, over the dead k_rope rows:
  // [16 heads][R], 16-byte chunks swizzled
  unsigned char* s_w = s_kr;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    const int ch = gi * 8 + warp;  // the chunk of rows gi * 64 + 8w ..
    *reinterpret_cast<__nv_bfloat162*>(s_w + at_chunk(g, ch, W_PITCH) + 4 * t) =
        __halves2bfloat162(__float2bfloat16_rn(__fdiv_rn(sc[gi][0], l0)),
                           __float2bfloat16_rn(__fdiv_rn(sc[gi][1], l0)));
    *reinterpret_cast<__nv_bfloat162*>(s_w + at_chunk(g + 8, ch, W_PITCH) + 4 * t) =
        __halves2bfloat162(__float2bfloat16_rn(__fdiv_rn(sc[gi][2], l1)),
                           __float2bfloat16_rn(__fdiv_rn(sc[gi][3], l1)));
  }
  __syncthreads();

  // ---- the context: warp w's 64 latent columns over this CTA's rows, 16
  // rows a k-step, k-steps past the valid rows skipped
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  {
    const uint32_t w_s = smem_addr(s_w);
    // ldmatrix lane roles: matrix (lane >> 3), its row (lane & 7)
    const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8, mcol = lane >> 4;
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      if (16 * kk < rows) {  // uniform over the CTA
        uint32_t a[4];
        ldsm4(a, w_s + at_chunk(mrow, 2 * kk + mcol, W_PITCH));
        const int rr = 16 * kk + mrow;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          ldsm4_t(bf, ckv_s + at_chunk(rr, warp * 8 + 2 * np + mcol, CKV_PITCH));
          mma(acc[2 * np], a, bf[0], bf[1]);
          mma(acc[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  // ---- the partial contexts: CTA r owns columns 64 r .. 64 r + 63, which
  // warp r of every CTA holds.  Warp r keeps its partial (over the dead
  // weights), each other warp w sends its partial into CTA w (CTA w has
  // sent its sum, so it reads nothing that lies there any more)
  __syncthreads();  // every warp is done with the weights
  {
    const int slot = (rank < warp ? rank : rank - 1) * (MLA_HEADS * 64);
    const uint32_t to = peer(smem_addr(s_recv + slot), warp);
    const uint32_t to_bar = peer(bars + 16, warp);
    // lanes t and t ^ 1 trade halves, so each sends one 16-byte run: an
    // even t four columns of head g, an odd t four of head g + 8
    const bool odd = t & 1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float sx = odd ? acc[nt][0] : acc[nt][2], sy = odd ? acc[nt][1] : acc[nt][3];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
      const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
      const float4 v = odd ? make_float4(rx, ry, acc[nt][2], acc[nt][3])
                           : make_float4(acc[nt][0], acc[nt][1], rx, ry);
      const int at = at_part(odd ? g + 8 : g, nt * 8 + 2 * (t & 2));
      if (warp == rank) {
        *reinterpret_cast<float4*>(s_own + at) = v;
      } else {
        send(to + at * 4, v, to_bar);
      }
    }
  }

  // ---- every thread of CTA r sums 4 of its 1,024 outputs over the
  // cluster's partials in rank order and rounds them once
  __syncthreads();  // this CTA's own partial
  bar_wait(bars + 16);  // the peers'
  {
    const int h = tid >> 4, col = (tid & 15) * 4;
    const int at = at_part(h, col);
    float4 v = *reinterpret_cast<const float4*>((rank == 0 ? s_own : s_recv) + at);
#pragma unroll
    for (int c = 1; c < MLA_CLUSTER; ++c) {
      const float* from = c == rank ? s_own : s_recv + (c < rank ? c : c - 1) * (MLA_HEADS * 64);
      const float4 u = *reinterpret_cast<const float4*>(from + at);
      v.x = __fadd_rn(v.x, u.x);
      v.y = __fadd_rn(v.y, u.y);
      v.z = __fadd_rn(v.z, u.z);
      v.w = __fadd_rn(v.w, u.w);
    }
    const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
    const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w));
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + (head0 + h) * MLA_RANK + rank * 64 + col) = packed;
  }
}

using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                        const __nv_bfloat16*, const __nv_bfloat16*,
                        const long long*, __nv_bfloat16*, int, int, float);

Kernel pick(int groups) {
  switch (groups) {
    case 1: return mla_decode_kernel<1>;
    case 2: return mla_decode_kernel<2>;
    default: return mla_decode_kernel<3>;
  }
}

// Raise a kernel's dynamic shared-memory limit to all that MLA_SMEM_MAX
// leaves beside its static shared memory, once a device, at the first
// launch that needs more than the default 48 KB, and never on a launch
// that a CUDA graph records: cudaFuncSetAttribute is not a stream
// operation and must not run during a capture.  A capture whose shape
// needs the raise before any eager launch has made it fails here; a
// caller runs the shape once eagerly first (the serving engine does).
cudaError_t allow_smem(int index, Kernel kernel, int smem, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices][MLA_GROUPS_MAX] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  bool& done = raised[dev][index];
  if (done) return cudaSuccess;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  if ((err = cudaStreamIsCapturing(stream, &capture)) != cudaSuccess) return err;
  if (capture != cudaStreamCaptureStatusNone) return cudaErrorStreamCaptureUnsupported;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel))) !=
      cudaSuccess)
    return err;
  const int room = MLA_SMEM_MAX - static_cast<int>(attr.sharedSizeBytes);
  if (smem > room) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, room);
  if (err != cudaSuccess) return err;
  done = true;
  return cudaSuccess;
}

}  // namespace

// q (B, 1, H, rank) and qr (B, 1, H, rope): the absorbed query and its
// rope part; ckv (B, S, rank) and kr (B, S, rope): the cache; out (B, 1,
// H, rank): all bfloat16, contiguous and 16-byte aligned (the wrapper
// checks); pos (B,) int64.  The kernel takes rank 512, rope 64, H a
// multiple of 16 and 1 <= S <= MLA_CLUSTER * MLA_GROUP * MLA_GROUPS_MAX.
// Returns a CUDA error code, 0 on success.
extern "C" int mla_decode_launch(const void* q, const void* qr, const void* ckv,
                                 const void* kr, const void* pos, void* out, int B,
                                 int S, int H, int rank, int rope, float scale,
                                 void* stream) {
  if (rank != MLA_RANK || rope != MLA_ROPE) return cudaErrorInvalidValue;
  if (B < 0 || B > 65535 || H < MLA_HEADS || H % MLA_HEADS != 0 ||
      H / MLA_HEADS > 65535 || S < 1 ||
      S > MLA_CLUSTER * MLA_GROUP * MLA_GROUPS_MAX)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(qr) |
      reinterpret_cast<uintptr_t>(ckv) | reinterpret_cast<uintptr_t>(kr) |
      reinterpret_cast<uintptr_t>(out);
  if (bits % 16 != 0) return cudaErrorMisalignedAddress;
  const int per_cta = (S + MLA_CLUSTER - 1) / MLA_CLUSTER;
  const int groups = (per_cta + MLA_GROUP - 1) / MLA_GROUP;
  const Kernel kernel = pick(groups);
  const int smem = groups == 1   ? Layout<MLA_GROUP>::kBytes
                   : groups == 2 ? Layout<2 * MLA_GROUP>::kBytes
                                 : Layout<3 * MLA_GROUP>::kBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(groups - 1, kernel, smem, s);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(MLA_CLUSTER, H / MLA_HEADS, B), MLA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(qr),
      static_cast<const __nv_bfloat16*>(ckv), static_cast<const __nv_bfloat16*>(kr),
      static_cast<const long long*>(pos), static_cast<__nv_bfloat16*>(out), S, H,
      scale);
  return cudaGetLastError();
}
