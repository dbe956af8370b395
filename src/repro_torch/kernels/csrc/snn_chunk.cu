// Fused event-driven SNN chunk for Hopper (sm_90a).
//
// Replaces repro/kernels/snn_chunk.py::snn_chunk (the Pallas
// `_chunk_kernel`): one launch advances an L-layer LIF/Lapicque network
// Tc steps for B slots.  Layer 0 is the gated sum of value * W0[addr] over
// each step's valid-first event list; hidden layers are h @ W_i + b_i over
// the previous layer's spike plane, skipped where the plane is silent;
// refractory countdown; zero or subtract reset.  Frozen slots (active == 0)
// copy their incoming state through, with zero spikes and events.
//
// Design: one CTA per slot; threads stride over each layer's neurons.
// Every layer's membrane and refractory state, and the spike planes, stay
// in shared memory for all Tc steps, so device memory sees one read of the
// incoming state and one write of the outgoing state.  Event addresses
// (int16 or int32) and values (int8 or float) are read as staged, with no
// widening copy.  Each thread masks its own edge: there is no lane padding.
//
// Numerics: every sum runs in a fixed order (events in staging order for
// layer 0, k ascending for hidden layers) with __fmul_rn/__fadd_rn, so no
// multiply-add is contracted and the result equals the plain PyTorch
// version (kernels/snn_chunk.py::snn_chunk_ref) value for value.  Spike
// counts use shared integer atomics; there are no float atomics, so runs
// are deterministic.
//
// Bounds: the work is the W0 rows gathered per event (N0 floats each), read
// through the 50 MB L2 that holds the 8 MiB collision slab, plus the
// tables, states and outputs.  A launch has only B CTAs, so at 8 slots it
// occupies 8 of the 132 SMs and each slot's gather runs at one SM's L2
// bandwidth.  A later design splits each slot's neurons across the CTAs of
// a thread-block cluster that shares the hidden spike plane through
// distributed shared memory.
//
// Per-layer weight pointers and widths travel in the kernel's parameter
// block (SNN_MAX_LAYERS entries, about 2 KB), so L is a run-time value up
// to 128, as in the reference, and no table is uploaded per launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define SNN_MAX_LAYERS 128

struct ChunkParams {
  const float* w[SNN_MAX_LAYERS];   // layer i weights, (width[i], width[i+1]) row-major
  int width[SNN_MAX_LAYERS + 1];    // width[0] = K0, width[i+1] = N_i
  int offset[SNN_MAX_LAYERS];       // offset of layer i in the flat per-slot state
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
  int max_width;
  int refractory;
  int reset_subtract;
  int lapicque;
  float gain;
};

// One membrane update of neuron j (flat index); returns the spike.
__device__ __forceinline__ float neuron_update(const ChunkParams& p, int j,
                                               float cur, float* u_s,
                                               int* r_s) {
  const float u = u_s[j];
  const float thr = p.thr[j];
  const float u_pre = p.lapicque
                          ? __fadd_rn(u, __fmul_rn(p.gain, cur))
                          : __fadd_rn(__fmul_rn(p.beta[j], u), cur);
  bool spike = u_pre >= thr;
  if (p.refractory > 0) {
    const int r = r_s[j];
    spike = spike && (r <= 0);
    r_s[j] = spike ? p.refractory : max(r - 1, 0);
  }
  u_s[j] = spike ? (p.reset_subtract ? __fsub_rn(u_pre, thr) : 0.0f) : u_pre;
  return spike ? 1.0f : 0.0f;
}

template <typename AddrT, typename ValT>
__global__ void snn_chunk_kernel(const __grid_constant__ ChunkParams p) {
  extern __shared__ float smem[];
  __shared__ int spike_count[SNN_MAX_LAYERS];
  float* u_s = smem;
  int* r_s = reinterpret_cast<int*>(u_s + p.total);
  float* plane_a = reinterpret_cast<float*>(r_s + p.total);
  float* plane_b = plane_a + p.max_width;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int L = p.num_layers;
  const int B = p.batch;
  const int NL = p.width[L];
  const int offL = p.offset[L - 1];
  const float* u0 = p.u0 + (size_t)b * p.total;
  const int* r0 = p.r0 + (size_t)b * p.total;
  float* u_fin = p.u_fin + (size_t)b * p.total;
  int* r_fin = p.r_fin + (size_t)b * p.total;

  if (p.active[b] == 0) {
    // frozen slot: state held, membrane trace pinned, no spikes or events
    for (int j = tid; j < p.total; j += nt) {
      u_fin[j] = u0[j];
      r_fin[j] = r0[j];
    }
    for (int j = tid; j < p.steps * NL; j += nt) {
      const int t = j / NL, n = j % NL;
      const size_t o = ((size_t)t * B + b) * NL + n;
      p.mem[o] = u0[offL + n];
      p.spk[o] = 0.0f;
    }
    for (int j = tid; j < p.steps * L; j += nt) {
      const int t = j / L, i = j % L;
      p.events[((size_t)t * L + i) * B + b] = 0.0f;
    }
    return;
  }

  for (int j = tid; j < p.total; j += nt) {
    u_s[j] = u0[j];
    r_s[j] = r0[j];
  }

  const AddrT* addrs = static_cast<const AddrT*>(p.addrs);
  const ValT* values = static_cast<const ValT*>(p.values);
  for (int t = 0; t < p.steps; ++t) {
    for (int i = tid; i < L; i += nt) spike_count[i] = 0;
    __syncthreads();

    // ---- layer 0: value * W0[addr] over the step's valid events, in order
    int n0 = p.counts[b * p.cnt_slot_stride + t * p.cnt_step_stride];
    n0 = min(max(n0, 0), p.capacity);
    const long long ev = b * p.ev_slot_stride + t * p.ev_step_stride;
    const AddrT* a = addrs + ev;
    const ValT* v = values + ev;
    float* out = plane_a;
    float* in = plane_b;
    {
      const int K = p.width[0];
      const int N = p.width[1];
      const float* W = p.w[0];
      int mine = 0;
      for (int n = tid; n < N; n += nt) {
        float acc = 0.0f;
#pragma unroll 8
        for (int e = 0; e < n0; ++e) {
          const int addr = static_cast<int>(a[e]);
          if (addr < 0 || addr >= K) continue;  // corrupt entry: skipped
          acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(v[e]),
                                         W[(size_t)addr * N + n]));
        }
        const float s = neuron_update(p, n, __fadd_rn(acc, p.bias[n]), u_s,
                                      r_s);
        out[n] = s;
        mine += s != 0.0f;
        if (L == 1) {
          const size_t o = ((size_t)t * B + b) * NL + n;
          p.mem[o] = u_s[n];
          p.spk[o] = s;
        }
      }
      if (mine) atomicAdd(&spike_count[0], mine);
      if (tid == 0) p.events[((size_t)t * L) * B + b] = static_cast<float>(n0);
    }
    __syncthreads();

    // ---- hidden layers: h @ W_i + b_i over the resident spike plane
    for (int i = 1; i < L; ++i) {
      float* tmp = in;
      in = out;
      out = tmp;
      const int K = p.width[i];
      const int N = p.width[i + 1];
      const int off = p.offset[i];
      const float* W = p.w[i];
      const int prev = spike_count[i - 1];
      int mine = 0;
      for (int n = tid; n < N; n += nt) {
        float acc = 0.0f;
        if (prev > 0) {
          for (int k = 0; k < K; ++k) {
            const float h = in[k];
            if (h != 0.0f) {
              acc = __fadd_rn(acc, __fmul_rn(h, W[(size_t)k * N + n]));
            }
          }
        }
        const float s = neuron_update(p, off + n,
                                      __fadd_rn(acc, p.bias[off + n]), u_s,
                                      r_s);
        out[n] = s;
        mine += s != 0.0f;
        if (i == L - 1) {
          const size_t o = ((size_t)t * B + b) * NL + n;
          p.mem[o] = u_s[off + n];
          p.spk[o] = s;
        }
      }
      if (mine) atomicAdd(&spike_count[i], mine);
      if (tid == 0) {
        p.events[((size_t)t * L + i) * B + b] = static_cast<float>(prev);
      }
      __syncthreads();
    }
  }

  for (int j = tid; j < p.total; j += nt) {
    u_fin[j] = u_s[j];
    r_fin[j] = r_s[j];
  }
}

template <typename AddrT, typename ValT>
static cudaError_t launch(const ChunkParams& p, int threads, int smem,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        snn_chunk_kernel<AddrT, ValT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  snn_chunk_kernel<AddrT, ValT><<<p.batch, threads, smem, stream>>>(p);
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
    void* u_fin, void* r_fin, int threads, int smem, void* stream) {
  if (num_layers < 1 || num_layers > SNN_MAX_LAYERS) {
    return cudaErrorInvalidValue;
  }
  ChunkParams p = {};
  int total = 0, max_width = 0;
  p.width[0] = widths[0];
  for (int i = 0; i < num_layers; ++i) {
    p.w[i] = reinterpret_cast<const float*>(weight_ptrs[i]);
    p.width[i + 1] = widths[i + 1];
    p.offset[i] = total;
    total += widths[i + 1];
    max_width = widths[i + 1] > max_width ? widths[i + 1] : max_width;
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
  p.max_width = max_width;
  p.refractory = refractory;
  p.reset_subtract = reset_subtract;
  p.lapicque = lapicque;
  p.gain = gain;
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
