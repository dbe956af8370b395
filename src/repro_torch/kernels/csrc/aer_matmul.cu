// Batched event-driven synaptic integration for Hopper (sm_90a).
//
// Replaces repro/kernels/aer_matmul.py::aer_spike_matmul_batched (the
// Pallas `_aer_batched_kernel`) and, with B = 1, aer_spike_matmul (the
// Pallas `_aer_kernel`):
//
//   out[b, n] = sum_e values[b, e] * W[addrs[b, e], n]
//
// Two contracts: int16 weights with integer values accumulate in int32
// (two's-complement wrap, bit-exact against the reference's
// aer_spike_matmul_ref per stream); float32 weights with float32 values
// accumulate in float32 (the surrogate-gradient training forward).  An
// event is live when its value is nonzero and its address lies in [0, K);
// other entries are padding or corrupt and contribute nothing, and no row
// outside [0, K) is ever read.  Any address order, padding anywhere.
//
// Numerics: every float32 sum of one (b, n) runs in one thread, e
// ascending, with __fmul_rn/__fadd_rn (and the library is built with
// -fmad=false), so no multiply-add is contracted and the result equals
// the plain PyTorch version (kernels/aer_matmul.py::
// aer_spike_matmul_batched_ref) value for value.  float32 never splits E
// and uses no atomics: another order would change every training number.
// Runs are deterministic.  int32 sums wrap, so they are associative and
// commutative: int16 weights may split E and meet by atomicAdd.
//
// Two building blocks, and four kernels that kernels/aer_matmul.py::plan
// picks from (each with a name of its own, so a profile tells the layers
// of the trainer apart):
//
//   the ring (aer_ring)  one stream, a slice of `cols` columns, a range of
//       events, walked in E-blocks of one event a thread through two
//       shared-memory rings filled by cp.async: events 2 * AER_LEAD blocks
//       ahead of the adds; once a block's events have landed, each is
//       marked live or dead and a barrier-or asks whether any is live (the
//       Pallas kernel's E-block gate): a silent block copies no row, else
//       its live events' row segments W[a, n0 : n0 + cols] are copied
//       AER_LEAD blocks ahead (16 bytes a copy where the pitch and pointer allow,
//       element by element where not).  Thread c then adds column c over
//       the block's staged rows, event by event.  Run by a whole CTA, or
//       by a group of 128 threads on a named barrier of its own.  It walks
//       only up to the last live event, found first, so it skips the
//       padding that runtime.step_events leaves after the live events.
//   the walk (merged CTA)  the live events of up to 4 streams are scattered
//       into a (streams, K) plane H in shared memory; the CTA then reads W
//       once for all of them, k ascending, in tiles of AER_TILE_ROWS rows
//       (a tile no stream touches is not read), and thread (s, c) adds
//       H[s, k] * W[k, c] for every nonzero H[s, k].  That is stream s's
//       event order exactly when its live events form a prefix of strictly
//       ascending addresses, which is what step_events builds and what the
//       scatter checks.
//
//   aer_merged_kernel  float32, N >= 32: 4 streams x 32 columns a CTA of
//                      4 x 128 threads.  It walks when every stream is an
//                      ascending prefix and at least a quarter of the
//                      (stream, row) pairs are live (the dense early steps;
//                      one warp a stream adds); otherwise each 128 threads
//                      run the ring for their stream (the sparse steps, any
//                      order).
//   aer_rows_kernel    float32 when the plane does not fit: the CTA ring.
//   aer_narrow_kernel  float32, N < 32 (the trainer's layer 1, N = 2): the
//                      CTA ring over all N columns, so all 128 threads copy
//                      each block's 128 rows, where the earlier design had
//                      2 threads walk 16 loads at a time.
//   aer_split_kernel   int16: the CTA ring with E split across grid z;
//                      partials meet by int32 atomicAdd in an output the
//                      wrapper zeroes.  The single stream (B = 1) gets 32
//                      E-chunks x 16 column slices in place of 4 CTAs.
//
// Bounds: the bytes bound counts each touched W row once (0.0028 ms at the
// dense training step), but a per-stream gather reads ~4,000 row segments
// of 2 KB a stream, 262 MB through the 50 MB L2 that holds the 8 MiB
// layer-0 slab, so the ring is bound by the L2 rate there; the walk reads
// W once per 4 streams (64 MB) and is bound by its per-row add chain and
// tile barriers.  The sparse steps are bound by reading the events, all
// of which must be read to find every live one.

#include <cuda_runtime.h>
#include <stdint.h>

#define AER_MAX_THREADS 512
#define AER_LEAD 2  // E-blocks of rows in flight ahead of the adds (rings)
#define AER_SMEM_MAX 231424  // 227 KB less 1 KB for static shared memory
#define AER_TILE_ROWS 256  // W rows a tile of the walk
#define AER_MERGE_MAX 4    // streams a merged CTA
#define AER_GROUP 128      // threads a ring, and a stream of a merged CTA

enum { AER_ROWS = 0, AER_NARROW = 1, AER_SPLIT = 2, AER_MERGED = 3 };

__device__ __forceinline__ float mac(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

__device__ __forceinline__ int mac(int acc, int v, int16_t w) {
  // wrap as int32 arithmetic does, without signed-overflow UB
  return static_cast<int>(static_cast<unsigned>(acc) +
                          static_cast<unsigned>(v) *
                              static_cast<unsigned>(static_cast<int>(w)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// every copy group but the newest AER_LEAD - 1 has landed
__device__ __forceinline__ void cp_async_wait_lead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(AER_LEAD - 1) : "memory");
}

// NaN != 0, so a NaN value is live, as in the plain version
__device__ __forceinline__ bool is_live(int a, float v, int K) {
  return v != 0.f && a >= 0 && a < K;
}

__device__ __forceinline__ bool is_live(int a, int v, int K) {
  return v != 0 && a >= 0 && a < K;
}

// elements between two staged rows: cols rounded up to 16 bytes
__host__ __device__ __forceinline__ int row_pitch(int cols, int wsize) {
  return (cols * wsize + 15) / 16 * 16 / wsize;
}

// the rings of one CTA or group (threads = events a block)
__host__ __device__ __forceinline__ size_t ring_bytes(int threads, int cols,
                                                      int wsize) {
  return static_cast<size_t>(AER_LEAD + 1) * threads *
             row_pitch(cols, wsize) * wsize +
         static_cast<size_t>(2 * AER_LEAD + 1) * threads * 8;
}

// the merged CTA's walk: the (streams, K) plane and two W tiles
__host__ __device__ __forceinline__ size_t walk_bytes(int streams, int K,
                                                      int cols) {
  const size_t kp = (static_cast<size_t>(K) + AER_TILE_ROWS - 1) /
                    AER_TILE_ROWS * AER_TILE_ROWS;
  return streams * kp * 4 + 2ull * AER_TILE_ROWS * row_pitch(cols, 4) * 4;
}

// One stream b, columns [n0, n0 + cols) and events [e_begin, e_end) through
// the events and rows rings, by the whole CTA (GROUP 0) or by one group of
// GROUP threads with a named barrier of its own (`smem` is then the
// group's own part); writes (or, with `atomic`, adds) out[b, n0 : n0 +
// cols].
template <typename WT, typename VT, bool VEC, int GROUP>
__device__ __forceinline__ void aer_ring(
    unsigned char* smem, const int* __restrict__ addrs,
    const VT* __restrict__ values, const WT* __restrict__ w,
    VT* __restrict__ out, int b, int n0, long long e_begin, long long e_end,
    int E, int K, int N, int cols, bool atomic) {
  constexpr int lead = AER_LEAD;
  const int EB = GROUP ? GROUP : blockDim.x;
  const int tid = GROUP ? threadIdx.x % GROUP : threadIdx.x;
  const int bar = GROUP ? 1 + threadIdx.x / GROUP : 0;  // 0 is __syncthreads
  const int pitch = row_pitch(cols, sizeof(WT));
  const int r_slots = lead + 1, e_slots = 2 * lead + 1;
  WT* rows = reinterpret_cast<WT*>(smem);
  int* s_a = reinterpret_cast<int*>(
      smem + static_cast<size_t>(r_slots) * EB * pitch * sizeof(WT));
  VT* s_v = reinterpret_cast<VT*>(s_a + e_slots * EB);
  const int cs = min(cols, N - n0);
  const int nblk =
      e_end > e_begin ? static_cast<int>((e_end - e_begin + EB - 1) / EB) : 0;
  const int* a_row = addrs + static_cast<size_t>(b) * E;
  const VT* v_row = values + static_cast<size_t>(b) * E;

  auto sync = [&] {
    if (GROUP) {
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(GROUP) : "memory");
    } else {
      __syncthreads();
    }
  };
  // one event a thread; past the range, zero (= dead) without a read
  auto issue_events = [&](int blk) {
    if (blk >= nblk) return;
    const int i = (blk % e_slots) * EB + tid;
    const long long e = e_begin + static_cast<long long>(blk) * EB + tid;
    const bool ok = e < e_end;
    cp_async4(s_a + i, ok ? a_row + e : a_row, ok ? 4 : 0);
    cp_async4(s_v + i, ok ? v_row + e : v_row, ok ? 4 : 0);
  };
  // marks the block's events live or dead; true when any is live
  auto gate = [&](int blk) -> bool {
    if (blk >= nblk) return false;  // uniform: no barrier skipped
    const int i = (blk % e_slots) * EB + tid;
    const int a = s_a[i];
    const VT v = s_v[i];
    const bool live = is_live(a, v, K);
    s_a[i] = live ? a : 0;
    s_v[i] = live ? v : VT(0);
    if (GROUP) {  // the group's __syncthreads_or
      int any;
      asm volatile(
          "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n"
          " bar.red.or.pred q, %2, %3, p;\n selp.u32 %0, 1, 0, q;\n}"
          : "=r"(any)
          : "r"(static_cast<int>(live)), "r"(bar), "r"(GROUP)
          : "memory");
      return any != 0;
    }
    return __syncthreads_or(live) != 0;
  };
  // the live events' row segments W[a, n0 : n0 + cs] into the rows ring
  auto issue_rows = [&](int blk) {
    WT* dst = rows + static_cast<size_t>(blk % r_slots) * EB * pitch;
    const int* sa = s_a + (blk % e_slots) * EB;
    const VT* sv = s_v + (blk % e_slots) * EB;
    const WT* src = w + n0;
    if constexpr (VEC) {
      constexpr int PER = 16 / sizeof(WT);
      const int chunks = cs / PER;  // exact: N and n0 are 16-byte aligned
      // thread tid copies chunk c of row i, then steps EB chunks on
      int i = tid / chunks, c = tid - i * chunks;
      const int di = EB / chunks, dc = EB - di * chunks;
      for (; i < EB; i += di) {
        if (sv[i] != VT(0))
          cp_async16(dst + i * pitch + c * PER,
                     src + static_cast<size_t>(sa[i]) * N + c * PER);
        c += dc;
        if (c >= chunks) {
          c -= chunks;
          ++i;
        }
      }
    } else {
      int i = tid / cs, c = tid - i * cs;
      const int di = EB / cs, dc = EB - di * cs;
      for (; i < EB; i += di) {
        if (sv[i] != VT(0)) {
          const WT* s = src + static_cast<size_t>(sa[i]) * N + c;
          if constexpr (sizeof(WT) == 4) {
            cp_async4(dst + i * pitch + c, s, 4);
          } else {
            dst[i * pitch + c] = *s;  // no 2-byte cp.async
          }
        }
        c += dc;
        if (c >= cs) {
          c -= cs;
          ++i;
        }
      }
    }
  };

  // prologue: the events of 2 * lead blocks, then the rows of lead blocks
  for (int p = 0; p < 2 * lead; ++p) issue_events(p);
  cp_async_commit();
  cp_async_wait_all();
  sync();
  unsigned long long live_blocks = 0;  // bit (block & 63): it has a live event
  for (int p = 0; p < lead; ++p) {
    if (gate(p)) {
      live_blocks |= 1ull << (p & 63);
      issue_rows(p);
    }
    cp_async_commit();
  }

  VT acc = 0;
  for (int j = 0; j < nblk; ++j) {
    // landed: block j's rows and block j + lead's events (the group
    // committed lead groups ago); the barrier also frees block j - 1's slots
    cp_async_wait_lead();
    sync();
    const int nb = j + lead;
    if (gate(nb)) {
      live_blocks |= 1ull << (nb & 63);
      issue_rows(nb);
    }
    issue_events(j + 2 * lead);
    cp_async_commit();
    if ((live_blocks >> (j & 63)) & 1ull) {
      if (tid < cs) {
        const WT* r = rows + static_cast<size_t>(j % r_slots) * EB * pitch + tid;
        const VT* sv = s_v + (j % e_slots) * EB;
        // a dead event's row slot holds stale bytes: its sum is computed
        // and dropped by a select, so no branch stalls the unrolled loads
#pragma unroll 8
        for (int i = 0; i < EB; ++i) {
          const VT v = sv[i];
          const VT t = mac(acc, v, r[i * pitch]);
          acc = v != VT(0) ? t : acc;
        }
      }
      live_blocks &= ~(1ull << (j & 63));
    }
  }
  cp_async_wait_all();
  if (tid < cs) {
    VT* o = out + static_cast<size_t>(b) * N + n0 + tid;
    if constexpr (sizeof(WT) == 2) {
      if (atomic) {
        atomicAdd(o, acc);
        return;
      }
    }
    *o = acc;
  }
}

// One past the last live event of stream b in [e_begin, e_end) (e_begin if
// none), found by the whole CTA in one pass of unrolled loads.
template <typename VT>
__device__ __forceinline__ long long live_extent(
    const int* __restrict__ addrs, const VT* __restrict__ values, int b,
    long long e_begin, long long e_end, int E, int K) {
  __shared__ unsigned long long s_ext;
  if (threadIdx.x == 0) s_ext = 0;
  __syncthreads();
  const int* ar = addrs + static_cast<size_t>(b) * E;
  const VT* vr = values + static_cast<size_t>(b) * E;
  long long ext = 0;  // one past a live event, 0 for none
#pragma unroll 8
  for (long long e = e_begin + threadIdx.x; e < e_end; e += blockDim.x)
    if (is_live(__ldg(ar + e), __ldg(vr + e), K)) ext = e + 1;
  for (int d = 16; d > 0; d >>= 1)
    ext = max(ext, __shfl_down_sync(0xffffffffu, ext, d));
  if ((threadIdx.x & 31) == 0 && ext)
    atomicMax(&s_ext, static_cast<unsigned long long>(ext));
  __syncthreads();
  const long long got = static_cast<long long>(s_ext);
  return got ? got : e_begin;
}

// float32, N >= 32, `streams` streams x 32 columns a CTA of AER_GROUP
// threads a stream: the walk when every stream is an ascending prefix and
// the plane is at least a quarter live, else one group ring a stream.
template <bool VEC>
__global__ void __launch_bounds__(AER_MAX_THREADS)
    aer_merged_kernel(const int* __restrict__ addrs,
                      const float* __restrict__ values,
                      const float* __restrict__ w, float* __restrict__ out,
                      int B, int E, int K, int N, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_last[AER_MERGE_MAX];  // past the last live
  __shared__ int s_live[AER_MERGE_MAX];                 // live events
  constexpr int R = AER_TILE_ROWS;
  const int T = blockDim.x, tid = threadIdx.x;
  const int S = T / AER_GROUP;  // the launcher checks T, and cols == 32
  const int sl = tid / cols, c = tid - sl * cols;  // the walk: tid < S * cols
  const int b0 = blockIdx.x * S;
  const int present = min(S, B - b0);
  const int n0 = blockIdx.y * cols, cs = min(cols, N - n0);
  const int nrb = K / R + (K % R != 0), Kp = nrb * R;
  const int pitch = row_pitch(cols, 4);
  float* H = reinterpret_cast<float*>(smem);
  float* tiles = H + static_cast<size_t>(S) * Kp;

  auto issue_tile = [&](int rb) {
    float* dst = tiles + static_cast<size_t>(rb & 1) * R * pitch;
    const int k0 = rb * R, rows = min(R, K - k0);
    const float* src = w + static_cast<size_t>(k0) * N + n0;
    if constexpr (VEC) {
      const int chunks = cs / 4;
      for (int i = tid; i < rows * chunks; i += T) {
        const int r = i / chunks, q = i - r * chunks;
        cp_async16(dst + r * pitch + q * 4,
                   src + static_cast<size_t>(r) * N + q * 4);
      }
    } else {
      for (int i = tid; i < rows * cs; i += T) {
        const int r = i / cs, q = i - r * cs;
        cp_async4(dst + r * pitch + q, src + static_cast<size_t>(r) * N + q,
                  4);
      }
    }
  };
  // true when a stream of the CTA has an event in tile rb's rows
  auto gate = [&](int rb) -> bool {
    if (rb >= nrb) return false;  // uniform: no barrier skipped
    bool any = false;
    for (int i = tid; i < S * R; i += T)
      any |= H[static_cast<size_t>(i / R) * Kp + rb * R + i % R] != 0.f;
    return __syncthreads_or(any) != 0;
  };

  for (int i = tid; i < S * Kp; i += T) H[i] = 0.f;
  if (tid < AER_MERGE_MAX) s_last[tid] = 0, s_live[tid] = 0;
  __syncthreads();
  // scatter, four events a thread and stream, checking the order: event
  // e + 1 may be live only if e is live with a smaller address
  bool bad = false;
  const bool evec = E % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(addrs) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 16 == 0;
  const int nq = E / 4 + (E % 4 != 0);
  long long last[AER_MERGE_MAX] = {};
  int live_n[AER_MERGE_MAX] = {};
  for (int q = tid; q < nq; q += T) {
#pragma unroll
    for (int j = 0; j < AER_MERGE_MAX; ++j) {
      if (j < present) {
        const long long e0 = 4ll * q;
        const size_t o = static_cast<size_t>(b0 + j) * E + e0;
        int a[5];
        float v[5];
        if (evec) {
          const int4 a4 = *reinterpret_cast<const int4*>(addrs + o);
          const float4 v4 = *reinterpret_cast<const float4*>(values + o);
          a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
          v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in = e0 + u < E;
            a[u] = in ? addrs[o + u] : 0;
            v[u] = in ? values[o + u] : 0.f;
          }
        }
        const bool in = e0 + 4 < E;
        a[4] = in ? addrs[o + 4] : 0;
        v[4] = in ? values[o + 4] : 0.f;
        bool live[5];
#pragma unroll
        for (int u = 0; u < 5; ++u) live[u] = is_live(a[u], v[u], K);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          bad |= live[u + 1] && !(live[u] && a[u] < a[u + 1]);
          if (live[u]) {
            H[static_cast<size_t>(j) * Kp + a[u]] = v[u];
            last[j] = e0 + u + 1;
            ++live_n[j];
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < AER_MERGE_MAX; ++j) {
    long long l = last[j];
    int n = live_n[j];
    for (int d = 16; d > 0; d >>= 1) {
      l = max(l, __shfl_down_sync(0xffffffffu, l, d));
      n += __shfl_down_sync(0xffffffffu, n, d);
    }
    if ((tid & 31) == 0 && n) {
      atomicMax(&s_last[j], static_cast<unsigned long long>(l));
      atomicAdd(&s_live[j], n);
    }
  }
  bad = __syncthreads_or(bad) != 0;
  long long live_total = 0;
  for (int j = 0; j < present; ++j) live_total += s_live[j];

  if (bad || 4 * live_total < static_cast<long long>(present) * K) {
    // sparse or out of order: one ring a group, each to its last live event
    __syncthreads();  // the rings reuse the plane's bytes
    const int g = tid / AER_GROUP;
    if (g < present) {
      unsigned char* part =
          smem + static_cast<size_t>(g) * ring_bytes(AER_GROUP, cols, 4);
      aer_ring<float, float, VEC, AER_GROUP>(
          part, addrs, values, w, out, b0 + g, n0, 0,
          static_cast<long long>(s_last[g]), E, K, N, cols, false);
    }
    return;
  }

  // the walk: tile rb + 1 flies while tile rb is added
  unsigned long long live_tiles = 0;  // bit (tile & 63)
  if (gate(0)) {
    live_tiles = 1;
    issue_tile(0);
  }
  cp_async_commit();
  float acc = 0.f;
  const float* h = H + static_cast<size_t>(min(sl, S - 1)) * Kp;
  for (int rb = 0; rb < nrb; ++rb) {
    cp_async_wait_all();  // tile rb; the barrier frees tile rb - 1's slot
    __syncthreads();
    if (gate(rb + 1)) {
      live_tiles |= 1ull << ((rb + 1) & 63);
      issue_tile(rb + 1);
    }
    cp_async_commit();
    if ((live_tiles >> (rb & 63)) & 1ull) {
      if (sl < S && c < cs) {
        const float* t = tiles + static_cast<size_t>(rb & 1) * R * pitch + c;
        const float* hr = h + rb * R;
#pragma unroll 8
        for (int r = 0; r < R; ++r) {
          const float x = hr[r];  // one address a warp: a broadcast
          const float p = __fmul_rn(x, t[r * pitch]);
          // acc += p where x != 0 (NaN included), as one predicated add
          asm("{\n .reg .pred q;\n setp.neu.f32 q, %1, 0f00000000;\n"
              " @q add.rn.f32 %0, %0, %2;\n}"
              : "+f"(acc)
              : "f"(x), "f"(p));
        }
      }
      live_tiles &= ~(1ull << (rb & 63));
    }
  }
  cp_async_wait_all();
  if (sl < present && c < cs)
    out[static_cast<size_t>(b0 + sl) * N + n0 + c] = acc;
}

// The CTA ring over one stream and column slice (grid x, y) and one
// E-chunk (grid z), up to the chunk's last live event.
template <bool VEC, typename WT, typename VT>
__device__ __forceinline__ void ring_cta(const int* addrs, const VT* values,
                                         const WT* w, VT* out, int E, int K,
                                         int N, int cols, int e_chunk,
                                         bool atomic) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long e0 = static_cast<long long>(blockIdx.z) * e_chunk;
  const long long e1 = min(static_cast<long long>(E), e0 + e_chunk);
  const long long ext = live_extent(addrs, values, blockIdx.x, e0, e1, E, K);
  aer_ring<WT, VT, VEC, 0>(smem, addrs, values, w, out, blockIdx.x,
                               blockIdx.y * cols, e0, ext, E, K, N, cols,
                               atomic);
}

template <bool VEC>
__global__ void __launch_bounds__(AER_MAX_THREADS)
    aer_rows_kernel(const int* __restrict__ addrs,
                    const float* __restrict__ values,
                    const float* __restrict__ w, float* __restrict__ out,
                    int E, int K, int N, int cols) {
  ring_cta<VEC>(addrs, values, w, out, E, K, N, cols, E, false);
}

template <bool VEC>
__global__ void __launch_bounds__(AER_MAX_THREADS)
    aer_narrow_kernel(const int* __restrict__ addrs,
                      const float* __restrict__ values,
                      const float* __restrict__ w, float* __restrict__ out,
                      int E, int K, int N, int cols) {
  ring_cta<VEC>(addrs, values, w, out, E, K, N, cols, E, false);
}

template <bool VEC>
__global__ void __launch_bounds__(AER_MAX_THREADS)
    aer_split_kernel(const int* __restrict__ addrs,
                     const int* __restrict__ values,
                     const int16_t* __restrict__ w, int* __restrict__ out,
                     int E, int K, int N, int cols, int e_chunk,
                     bool atomic) {
  ring_cta<VEC>(addrs, values, w, out, E, K, N, cols, e_chunk, atomic);
}

// Raise the dynamic shared-memory limit of every kernel instantiation to
// AER_SMEM_MAX once a device, at the first launch that needs more than the
// default 48 KB, and never on a launch that a CUDA graph records:
// cudaFuncSetAttribute is not a stream operation and must not run during a
// capture.  A capture whose shape needs the raise before any eager launch
// has made it fails here; a caller runs the shape once eagerly first.
static cudaError_t allow_smem(int smem, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (raised[dev]) return cudaSuccess;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  if ((err = cudaStreamIsCapturing(stream, &capture)) != cudaSuccess)
    return err;
  if (capture != cudaStreamCaptureStatusNone)
    return cudaErrorStreamCaptureUnsupported;
  const void* kernels[] = {
      reinterpret_cast<const void*>(&aer_rows_kernel<true>),
      reinterpret_cast<const void*>(&aer_rows_kernel<false>),
      reinterpret_cast<const void*>(&aer_narrow_kernel<true>),
      reinterpret_cast<const void*>(&aer_narrow_kernel<false>),
      reinterpret_cast<const void*>(&aer_split_kernel<true>),
      reinterpret_cast<const void*>(&aer_split_kernel<false>),
      reinterpret_cast<const void*>(&aer_merged_kernel<true>),
      reinterpret_cast<const void*>(&aer_merged_kernel<false>),
  };
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               AER_SMEM_MAX);
    if (err != cudaSuccess) return err;
  }
  raised[dev] = true;
  return cudaSuccess;
}

// The geometry comes from kernels/aer_matmul.py::plan; this only checks
// that it covers the shape and fits the kernel it names.
extern "C" int aer_matmul_launch(const void* addrs, const void* values,
                                 const void* w, void* out, int B, int E,
                                 int K, int N, int int16_weights, int variant,
                                 int cols, int threads, int streams,
                                 int e_chunk, int slices, int splits, int smem,
                                 void* stream) {
  if (B < 0 || E < 0 || K < 1 || N < 0) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const int wsize = int16_weights ? 2 : 4;
  bool ok = (variant == AER_SPLIT) == (int16_weights != 0) &&
            streams >= 1 && threads == AER_GROUP * streams && cols >= 1 &&
            cols <= 32 && slices >= 1 && slices <= 65535 &&
            static_cast<long long>(slices) * cols >= N &&
            static_cast<long long>(slices - 1) * cols < N && splits >= 1 &&
            splits <= 65535 && smem >= 0 && smem <= AER_SMEM_MAX &&
            (variant == AER_SPLIT || splits == 1);
  switch (variant) {
    case AER_ROWS:
    case AER_NARROW:
    case AER_SPLIT:
      ok = ok && streams == 1 && e_chunk >= 0 && e_chunk % threads == 0 &&
           static_cast<long long>(splits) * e_chunk >= E &&
           static_cast<size_t>(smem) >= ring_bytes(threads, cols, wsize);
      break;
    case AER_MERGED:
      ok = ok && streams <= AER_MERGE_MAX && cols == 32 &&
           static_cast<size_t>(smem) >= walk_bytes(streams, K, cols) &&
           static_cast<size_t>(smem) >= streams * ring_bytes(AER_GROUP, cols, 4);
      break;
    default:
      ok = false;
  }
  if (!ok) return cudaErrorInvalidValue;
  const bool vec = (cols * wsize) % 16 == 0 && (N * wsize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(B / streams + (B % streams != 0), slices, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(addrs);
  cudaError_t err = allow_smem(smem, s);
  if (err != cudaSuccess) return err;
  if (variant == AER_SPLIT) {
    auto k = vec ? &aer_split_kernel<true> : &aer_split_kernel<false>;
    k<<<grid, threads, smem, s>>>(a, static_cast<const int*>(values),
                                  static_cast<const int16_t*>(w),
                                  static_cast<int*>(out), E, K, N, cols,
                                  e_chunk, splits > 1);
    return cudaGetLastError();
  }
  const float* v = static_cast<const float*>(values);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (variant == AER_MERGED) {
    auto k = vec ? &aer_merged_kernel<true> : &aer_merged_kernel<false>;
    k<<<grid, threads, smem, s>>>(a, v, wf, o, B, E, K, N, cols);
  } else {
    auto k = variant == AER_NARROW
                 ? (vec ? &aer_narrow_kernel<true> : &aer_narrow_kernel<false>)
                 : (vec ? &aer_rows_kernel<true> : &aer_rows_kernel<false>);
    k<<<grid, threads, smem, s>>>(a, v, wf, o, E, K, N, cols);
  }
  return cudaGetLastError();
}
