// Fused event-driven SNN chunk for Hopper (sm_90a), one thread-block
// cluster per slot.
//
// Replaces repro/kernels/snn_chunk.py::snn_chunk (the Pallas
// `_chunk_kernel`): one launch advances an L-layer LIF/Lapicque network
// Tc steps for B slots.  Layer 0 is the gated sum of value * W0[addr] over
// each step's valid-first event list; hidden layers are h @ W_i + b_i over
// the previous layer's spike plane, skipped where the plane is silent;
// refractory countdown; zero or subtract reset.  Frozen slots (active == 0)
// copy their incoming state through, with zero spikes and events.
//
// Design: slot b runs on a cluster of SNN_CLUSTER CTAs (cudaLaunchKernelEx
// with a cluster dimension).  CTA rank r owns columns
// [r * cpc_i, (r + 1) * cpc_i) of every layer i
// (cpc_i = ceil(N_i / SNN_CLUSTER)) and keeps their membrane and refractory state
// in shared memory for the whole chunk.  The chunk runs in blocks of TB
// steps, because a layer's input current for step t does not depend on
// step t - 1; only the membrane update does.  In a block:
//   * layer 0: the steps' events are staged in shared memory in E-blocks
//     of SNN_EB as {row offset a * N0, value} (a skipped entry has offset
//     -1), and one thread carries one (step, column) current chain over
//     them in staging order.  Its W0 loads run two batches of SNN_UNROLL
//     events ahead of the ordered adds, so up to 64 loads a thread are in
//     flight.  The chain lives in shared memory between E-blocks, so a CTA
//     may hold more chains than threads;
//   * one thread per column then runs the LIF update over the block's
//     steps in order and writes the block's spike plane and per-step spike
//     counts into its own shared memory;
//   * each hidden layer starts with one cluster barrier, gathers the whole
//     previous plane and the ranks' counts over distributed shared memory
//     (rank order), then runs its (step, neuron) chains, one warp each:
//     the lanes load the W rows of nonzero inputs ahead, and the warp adds
//     them k ascending in ballot order; then its LIF update as above.
// Planes and counts are double-buffered by block parity, so one cluster
// barrier per hidden layer per block is enough: a rank overwrites a parity
// only after a barrier that every reader of the previous use has passed.
//
// Numerics: every sum runs in the plain version's order (events in
// staging order from 0 for layer 0, then + bias; k ascending over nonzero
// h for hidden layers) with __fmul_rn/__fadd_rn, so no multiply-add is
// contracted and the result equals kernels/snn_chunk.py::snn_chunk_ref
// value for value.  Spike counts are integers (shared atomics, summed over
// ranks); there are no float atomics, so runs are deterministic.
//
// Bounds: the work is the W0 rows gathered per event, N0 floats each.  The
// HBM bound counts each distinct row once (about 2.6 us at the collision
// serving chunk), but every step re-reads its rows through the 50 MB L2
// that holds the 8 MiB slab: 8 slots x 5 steps x ~1,300 events x 2 KB is
// about 0.1 GB, 15-20 us at L2 rates.  The cluster spreads that gather
// over B x SNN_CLUSTER SMs instead of B, and the step block gives each CTA
// TB x cpc_0 independent chains to keep loads in flight.  On the card
// (PERF.md) the serving chunk reads about 25 GB/s per SM whether 16 or 32
// loads a thread run ahead, so what seems to bound it is the misses an
// SM keeps in flight, on 64 SMs.  A (non-portable) cluster of 16 uses 128
// SMs but was within 4 % of 8 at the serving chunk and 18 % slower at the
// trainer's evaluate chunk, so the cluster is 8, the portable maximum.
//
// Per-layer weight pointers, widths and shared-memory offsets travel in
// the kernel's parameter block (SNN_MAX_LAYERS entries, about 3.3 KB), so
// L is a run-time value up to 128, as in the reference.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SNN_MAX_LAYERS 128
#define SNN_CLUSTER 8  // CTAs per slot; kernels/snn_chunk.py: CLUSTER
#define SNN_EB 512     // events staged per step and E-block
#define SNN_UNROLL 32  // row loads issued before their adds
#define SNN_STAGE 8    // staged events a thread loads at once
#define SNN_MAX_THREADS 512
#define SNN_HQ 16      // hidden-layer inputs a lane loads ahead, per 32

// a chain loads whole batches of SNN_UNROLL staged events, up to the
// E-block's length rounded up; past SNN_EB it would read the next step's
static_assert(SNN_EB % SNN_UNROLL == 0, "SNN_UNROLL must divide SNN_EB");

struct ChunkParams {
  const float* w[SNN_MAX_LAYERS];   // layer i weights, (width[i], width[i+1]) row-major
  int width[SNN_MAX_LAYERS + 1];    // width[0] = K0, width[i+1] = N_i
  int offset[SNN_MAX_LAYERS];       // offset of layer i in the flat per-slot state
  int own_off[SNN_MAX_LAYERS];      // offset of layer i's columns in a CTA's state
  int plane_off[SNN_MAX_LAYERS];    // offset of layer i's plane in a parity buffer
  const float* bias;                // (total,) all layers concatenated
  const float* beta;                // (total,) effective (post-sigmoid)
  const float* thr;                 // (total,)
  const float* u0;                  // (B, total) incoming membranes
  const int* r0;                    // (B, total) incoming refractory counters
  const void* addrs;                // layer-0 event addresses, int16 or int32
  const void* values;               // layer-0 event values, int8 or float
  const int* counts;                // valid events per (slot, step)
  const int* active;                // (B,) nonzero = active
  long long ev_slot_stride;         // elements between slots in addrs/values
  long long ev_step_stride;         // elements between steps in addrs/values
  long long cnt_slot_stride;
  long long cnt_step_stride;
  float* mem;                       // (Tc, B, N_L) last-layer membrane trace
  float* spk;                       // (Tc, B, N_L) last-layer spikes
  float* events;                    // (Tc, L, B) input events per layer
  float* u_fin;                     // (B, total)
  int* r_fin;                       // (B, total)
  int num_layers;
  int batch;
  int steps;
  int capacity;
  int total;
  int refractory;
  int reset_subtract;
  int lapicque;
  float gain;
  int step_block;   // TB
  int own_total;    // sum of cpc_i
  int plane_total;  // floats of one parity's planes (layers 0 .. L-2)
  int cpc_max;
  int kh_max;       // widest hidden-layer input (0 when L == 1)
};

__device__ __forceinline__ int cols_per_cta(const ChunkParams& p, int i) {
  return (p.width[i + 1] + SNN_CLUSTER - 1) / SNN_CLUSTER;
}

// One membrane update of neuron j (flat index); returns the spike.
__device__ __forceinline__ bool neuron_update(const ChunkParams& p, int j,
                                              float cur, float& u, int& r) {
  const float thr = p.thr[j];
  const float u_pre = p.lapicque
                          ? __fadd_rn(u, __fmul_rn(p.gain, cur))
                          : __fadd_rn(__fmul_rn(p.beta[j], u), cur);
  bool spike = u_pre >= thr;
  if (p.refractory > 0) {
    spike = spike && (r <= 0);
    r = spike ? p.refractory : max(r - 1, 0);
  }
  u = spike ? (p.reset_subtract ? __fsub_rn(u_pre, thr) : 0.0f) : u_pre;
  return spike;
}

// W0[a, n] for SNN_UNROLL staged events {a * N0 (-1: skipped), value}; a
// skipped entry reads row 0
__device__ __forceinline__ void load_rows(float* wv, const int2* ev,
                                          const float* col) {
#pragma unroll
  for (int u = 0; u < SNN_UNROLL; ++u) wv[u] = __ldg(col + max(ev[u].x, 0));
}

// the ordered adds of SNN_UNROLL staged events
__device__ __forceinline__ float add_rows(float acc, const float* wv,
                                          const int2* ev) {
#pragma unroll
  for (int u = 0; u < SNN_UNROLL; ++u) {
    const int2 x = ev[u];
    if (x.x >= 0) acc = __fadd_rn(acc, __fmul_rn(__int_as_float(x.y), wv[u]));
  }
  return acc;
}

template <typename AddrT, typename ValT>
__global__ void __launch_bounds__(SNN_MAX_THREADS)
    snn_chunk_kernel(const __grid_constant__ ChunkParams p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int TB = p.step_block;
  const int L = p.num_layers;
  int2* s_ev = reinterpret_cast<int2*>(smem);  // staged {a * N0, value}
  float* u_s = reinterpret_cast<float*>(s_ev + TB * SNN_EB);
  int* r_s = reinterpret_cast<int*>(u_s + p.own_total);
  float* cur = reinterpret_cast<float*>(r_s + p.own_total);
  float* planes = cur + TB * p.cpc_max;
  int* cnt = reinterpret_cast<int*>(planes + 2 * p.plane_total);
  float* g_plane = reinterpret_cast<float*>(cnt + 2 * (L - 1) * TB);
  int* prev_cnt = reinterpret_cast<int*>(g_plane + TB * p.kh_max);
  int* n_ev = prev_cnt + TB;

  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / SNN_CLUSTER;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int B = p.batch;
  const int NL = p.width[L];
  const float* u0 = p.u0 + (size_t)b * p.total;
  const int* r0 = p.r0 + (size_t)b * p.total;
  float* u_fin = p.u_fin + (size_t)b * p.total;
  int* r_fin = p.r_fin + (size_t)b * p.total;

  if (p.active[b] == 0) {
    // frozen slot (every rank of the cluster takes this branch): state
    // held, membrane trace pinned, no spikes or events
    for (int i = 0; i < L; ++i) {
      const int cpc = cols_per_cta(p, i);
      const int n0 = rank * cpc;
      const int own = max(0, min(cpc, p.width[i + 1] - n0));
      for (int c = tid; c < own; c += nt) {
        const int j = p.offset[i] + n0 + c;
        u_fin[j] = u0[j];
        r_fin[j] = r0[j];
        if (i == L - 1) {
          for (int t = 0; t < p.steps; ++t) {
            const size_t o = ((size_t)t * B + b) * NL + n0 + c;
            p.mem[o] = u0[j];
            p.spk[o] = 0.0f;
          }
        }
      }
    }
    if (rank == 0) {
      for (int j = tid; j < p.steps * L; j += nt) {
        const int t = j / L, i = j % L;
        p.events[((size_t)t * L + i) * B + b] = 0.0f;
      }
    }
    return;
  }

  for (int i = 0; i < L; ++i) {
    const int cpc = cols_per_cta(p, i);
    const int n0 = rank * cpc;
    const int own = max(0, min(cpc, p.width[i + 1] - n0));
    for (int c = tid; c < own; c += nt) {
      u_s[p.own_off[i] + c] = u0[p.offset[i] + n0 + c];
      r_s[p.own_off[i] + c] = r0[p.offset[i] + n0 + c];
    }
  }

  const AddrT* addrs = static_cast<const AddrT*>(p.addrs);
  const ValT* values = static_cast<const ValT*>(p.values);
  const int K0 = p.width[0];
  const int N0 = p.width[1];
  const float* W0 = p.w[0];
  const int cpc0 = cols_per_cta(p, 0);

  for (int t0 = 0, blk = 0; t0 < p.steps; t0 += TB, ++blk) {
    const int nb = min(TB, p.steps - t0);
    const int par = blk & 1;
    float* plane_par = planes + par * p.plane_total;
    int* cnt_par = cnt + par * (L - 1) * TB;

    // ---- layer 0: (step, column) chains over the staged events, in order
    for (int s = tid; s < nb; s += nt) {
      const int c = p.counts[b * p.cnt_slot_stride + (t0 + s) * p.cnt_step_stride];
      n_ev[s] = min(max(c, 0), p.capacity);
    }
    for (int j = tid; j < (L - 1) * TB; j += nt) cnt_par[j] = 0;
    for (int j = tid; j < nb * cpc0; j += nt) cur[j] = 0.0f;
    __syncthreads();
    int max_ev = 0;
    for (int s = 0; s < nb; ++s) max_ev = max(max_ev, n_ev[s]);
    for (int e0 = 0; e0 < max_ev; e0 += SNN_EB) {
      const int ne = min(SNN_EB, max_ev - e0);
      const int neu = (ne + SNN_UNROLL - 1) / SNN_UNROLL * SNN_UNROLL;
      // SNN_STAGE entries a thread: their loads are issued together
      for (int j0 = tid; j0 < nb * neu; j0 += nt * SNN_STAGE) {
        int a[SNN_STAGE];
        float v[SNN_STAGE];
#pragma unroll
        for (int q = 0; q < SNN_STAGE; ++q) {
          const int j = j0 + q * nt;
          a[q] = -1;
          v[q] = 0.0f;
          if (j < nb * neu && e0 + j % neu < n_ev[j / neu]) {
            const long long o = b * p.ev_slot_stride +
                                (t0 + j / neu) * p.ev_step_stride + e0 + j % neu;
            a[q] = static_cast<int>(addrs[o]);
            v[q] = static_cast<float>(values[o]);
          }
        }
#pragma unroll
        for (int q = 0; q < SNN_STAGE; ++q) {
          const int j = j0 + q * nt;
          if (j >= nb * neu) break;
          const bool ok = a[q] >= 0 && a[q] < K0;  // a corrupt entry is skipped
          s_ev[(j / neu) * SNN_EB + j % neu] =
              make_int2(ok ? a[q] * N0 : -1, __float_as_int(ok ? v[q] : 0.0f));
        }
      }
      __syncthreads();
      for (int j = tid; j < nb * cpc0; j += nt) {
        const int s = j / cpc0, c = j % cpc0;
        const int n = rank * cpc0 + c;
        if (n >= N0) continue;
        const int2* ev = s_ev + s * SNN_EB;
        const float* col = W0 + n;
        float acc = cur[j];
        // two batches of row loads in flight: batch e + U loads while
        // batch e adds, so each add waits on a load issued a batch earlier
        float wa[SNN_UNROLL], wb[SNN_UNROLL];
        load_rows(wa, ev, col);
        for (int e = 0; e < neu; e += 2 * SNN_UNROLL) {
          const bool more = e + SNN_UNROLL < neu;
          if (more) load_rows(wb, ev + e + SNN_UNROLL, col);
          acc = add_rows(acc, wa, ev + e);
          if (e + 2 * SNN_UNROLL < neu) load_rows(wa, ev + e + 2 * SNN_UNROLL, col);
          if (more) acc = add_rows(acc, wb, ev + e + SNN_UNROLL);
        }
        cur[j] = acc;
      }
      __syncthreads();  // the next E-block overwrites the staged events
    }
    if (rank == 0 && tid == 0) {
      for (int s = 0; s < nb; ++s) {
        p.events[((size_t)(t0 + s) * L) * B + b] = static_cast<float>(n_ev[s]);
      }
    }

    // ---- every layer: bias, LIF over the block's steps in order; hidden
    // layers first gather the previous plane and run their chains
    for (int i = 0; i < L; ++i) {
      const int N = p.width[i + 1];
      const int cpc = cols_per_cta(p, i);
      const int n0 = rank * cpc;
      const int own = max(0, min(cpc, N - n0));
      if (i > 0) {
        const int Kp = p.width[i];
        const int cpcp = cols_per_cta(p, i - 1);
        cluster.sync();  // layer i-1's planes and counts are final
        for (int j = tid; j < nb * Kp; j += nt) {
          const int s = j / Kp, k = j % Kp;
          const float* remote = cluster.map_shared_rank(
              plane_par + p.plane_off[i - 1], k / cpcp);
          g_plane[j] = remote[s * cpcp + k % cpcp];
        }
        for (int s = tid; s < nb; s += nt) {
          int total = 0;
          for (int q = 0; q < SNN_CLUSTER; ++q) {
            total += cluster.map_shared_rank(cnt_par + (i - 1) * TB, q)[s];
          }
          prev_cnt[s] = total;
        }
        __syncthreads();
        // one warp per (step, neuron) chain: lanes load the W rows of
        // SNN_HQ x 32 inputs at once, then the warp adds the nonzero ones
        // k ascending (ballot order), every lane carrying the same sum
        const float* W = p.w[i];
        const int lane = tid & 31;
        for (int j = tid >> 5; j < nb * cpc; j += nt >> 5) {
          const int s = j / cpc, c = j % cpc;
          if (c >= own) continue;
          float acc = 0.0f;
          if (prev_cnt[s] > 0) {
            const float* h = g_plane + s * Kp;
            const float* col = W + n0 + c;
            for (int k0 = 0; k0 < Kp; k0 += 32 * SNN_HQ) {
              float hv[SNN_HQ], wv[SNN_HQ];
#pragma unroll
              for (int q = 0; q < SNN_HQ; ++q) {
                const int k = k0 + q * 32 + lane;
                hv[q] = k < Kp ? h[k] : 0.0f;
                wv[q] = hv[q] != 0.0f ? __ldg(col + (size_t)k * N) : 0.0f;
              }
#pragma unroll
              for (int q = 0; q < SNN_HQ; ++q) {
                unsigned live = __ballot_sync(0xffffffffu, hv[q] != 0.0f);
                while (live) {
                  const int src = __ffs(live) - 1;
                  live &= live - 1;
                  acc = __fadd_rn(acc, __fmul_rn(__shfl_sync(0xffffffffu, hv[q], src),
                                                 __shfl_sync(0xffffffffu, wv[q], src)));
                }
              }
            }
          }
          if (lane == 0) cur[j] = acc;
        }
        __syncthreads();
        if (rank == 0 && tid == 0) {
          for (int s = 0; s < nb; ++s) {
            p.events[((size_t)(t0 + s) * L + i) * B + b] =
                static_cast<float>(prev_cnt[s]);
          }
        }
      }
      float* plane = plane_par + p.plane_off[i];
      for (int c = tid; c < own; c += nt) {
        const int j = p.offset[i] + n0 + c;
        const float bias = p.bias[j];
        float u = u_s[p.own_off[i] + c];
        int r = r_s[p.own_off[i] + c];
        for (int s = 0; s < nb; ++s) {
          const bool spike =
              neuron_update(p, j, __fadd_rn(cur[s * cpc + c], bias), u, r);
          if (i < L - 1) {
            plane[s * cpc + c] = spike ? 1.0f : 0.0f;
            if (spike) atomicAdd(&cnt_par[i * TB + s], 1);
          } else {
            const size_t o = ((size_t)(t0 + s) * B + b) * NL + n0 + c;
            p.mem[o] = u;
            p.spk[o] = spike ? 1.0f : 0.0f;
          }
        }
        u_s[p.own_off[i] + c] = u;
        r_s[p.own_off[i] + c] = r;
      }
      __syncthreads();  // cur is rewritten by the next layer or block
    }
  }

  for (int i = 0; i < L; ++i) {
    const int cpc = cols_per_cta(p, i);
    const int n0 = rank * cpc;
    const int own = max(0, min(cpc, p.width[i + 1] - n0));
    for (int c = tid; c < own; c += nt) {
      u_fin[p.offset[i] + n0 + c] = u_s[p.own_off[i] + c];
      r_fin[p.offset[i] + n0 + c] = r_s[p.own_off[i] + c];
    }
  }
  if (L > 1) cluster.sync();  // no CTA leaves while a peer reads its planes
}

// Shared-memory bytes of one CTA; kernels/snn_chunk.py::plan mirrors it.
static long long smem_bytes(const ChunkParams& p) {
  const long long TB = p.step_block, L = p.num_layers;
  return 4LL * (2LL * p.own_total + TB * p.cpc_max + 2LL * p.plane_total +
                2LL * (L - 1) * TB + TB * p.kh_max + 2LL * TB +
                2LL * TB * SNN_EB);
}

template <typename AddrT, typename ValT>
static cudaError_t launch(const ChunkParams& p, int threads, int smem,
                          cudaStream_t stream) {
  auto kernel = snn_chunk_kernel<AddrT, ValT>;
  // Raise the kernel's dynamic shared-memory limit at the first launch on a
  // device that needs more, not before every launch: a launch recorded into
  // a CUDA graph then makes no call but the launch itself (the serving
  // engine runs each shape once eagerly on each device before it captures
  // it).  The limit is a property of the device's context, so it is kept a
  // device (a sharded engine launches on each of its shards' cards).
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.batch * SNN_CLUSTER);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SNN_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int snn_chunk_launch(
    const long long* weight_ptrs,  // host array, num_layers device pointers
    const int* widths,             // host array, num_layers + 1 widths
    int num_layers, const void* bias, const void* beta, const void* thr,
    const void* u0, const void* r0, const void* addrs, int addr_bytes,
    const void* values, int value_bytes, const void* counts,
    const void* active, long long ev_slot_stride, long long ev_step_stride,
    long long cnt_slot_stride, long long cnt_step_stride, int batch,
    int steps, int capacity, int refractory, int reset_subtract,
    int lapicque, float gain, void* mem, void* spk, void* events,
    void* u_fin, void* r_fin, int step_block, int threads, int smem,
    void* stream) {
  if (num_layers < 1 || num_layers > SNN_MAX_LAYERS || step_block < 1 ||
      threads < 32 || threads > SNN_MAX_THREADS || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  ChunkParams p = {};
  int total = 0, own_total = 0, plane_total = 0, cpc_max = 0, kh_max = 0;
  p.step_block = step_block;
  p.width[0] = widths[0];
  for (int i = 0; i < num_layers; ++i) {
    p.w[i] = reinterpret_cast<const float*>(weight_ptrs[i]);
    p.width[i + 1] = widths[i + 1];
    const int cpc = (widths[i + 1] + SNN_CLUSTER - 1) / SNN_CLUSTER;
    p.offset[i] = total;
    p.own_off[i] = own_total;
    p.plane_off[i] = plane_total;
    total += widths[i + 1];
    own_total += cpc;
    if (i < num_layers - 1) plane_total += step_block * cpc;
    if (i > 0 && widths[i] > kh_max) kh_max = widths[i];
    cpc_max = cpc > cpc_max ? cpc : cpc_max;
  }
  p.bias = static_cast<const float*>(bias);
  p.beta = static_cast<const float*>(beta);
  p.thr = static_cast<const float*>(thr);
  p.u0 = static_cast<const float*>(u0);
  p.r0 = static_cast<const int*>(r0);
  p.addrs = addrs;
  p.values = values;
  p.counts = static_cast<const int*>(counts);
  p.active = static_cast<const int*>(active);
  p.ev_slot_stride = ev_slot_stride;
  p.ev_step_stride = ev_step_stride;
  p.cnt_slot_stride = cnt_slot_stride;
  p.cnt_step_stride = cnt_step_stride;
  p.mem = static_cast<float*>(mem);
  p.spk = static_cast<float*>(spk);
  p.events = static_cast<float*>(events);
  p.u_fin = static_cast<float*>(u_fin);
  p.r_fin = static_cast<int*>(r_fin);
  p.num_layers = num_layers;
  p.batch = batch;
  p.steps = steps;
  p.capacity = capacity;
  p.total = total;
  p.refractory = refractory;
  p.reset_subtract = reset_subtract;
  p.lapicque = lapicque;
  p.gain = gain;
  p.own_total = own_total;
  p.plane_total = plane_total;
  p.cpc_max = cpc_max;
  p.kh_max = kh_max;
  if (smem_bytes(p) != smem) return cudaErrorInvalidValue;  // plan disagrees
  if (batch == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (addr_bytes == 2 && value_bytes == 1) {
    return launch<int16_t, int8_t>(p, threads, smem, s);
  }
  if (addr_bytes == 2 && value_bytes == 4) {
    return launch<int16_t, float>(p, threads, smem, s);
  }
  if (addr_bytes == 4 && value_bytes == 1) {
    return launch<int32_t, int8_t>(p, threads, smem, s);
  }
  if (addr_bytes == 4 && value_bytes == 4) {
    return launch<int32_t, float>(p, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}
