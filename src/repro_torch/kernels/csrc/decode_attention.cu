// Decode attention against a full bfloat16 KV cache, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs this step as plain jnp
// (models/attention.py::attend_full), and so did the port, which made a
// float32 copy of the whole cache, a permuted copy of that for the scores
// and a permuted copy of V for the weighted sum, every layer of every
// decode step, and read the rows past each sequence's position that the
// mask then threw away.  This kernel was added for that cache traffic.
//
// For one new token a row b, kv head h and query group g of
// q (B, 1, Kv, G, D), against k, v (B, S, Kv, D), all bfloat16, and the
// positions pos (B,) int64 read on the device (so a CUDA graph replays
// the launch for every step), with n_b = min(pos[b] + 1, S) valid rows:
//
//   s_j = float32(q . k_j) * scale                 j < n_b
//   w_j = bf16(expf(s_j - max_j s) / sum_j expf(s_j - max_j s))
//   o   = bf16(sum_j w_j * v_j)                    accumulated in float32
//
// written as (B, 1, Kv, G, D).  These are the rounding points of
// attend_full: its scores are float32 dot products of bfloat16 values
// (each product exact in float32), times the scale; a masked row's score
// is -1e30, whose exp is exactly 0 in float32 beside any valid row, so
// skipping the rows j >= n_b is the same arithmetic; softmax in float32
// (expf, not __expf; division by the sum), the weights rounded to
// bfloat16 once normalised; the weighted sum of bfloat16 products (exact
// in float32) added in float32 and rounded once.  Only the order of the
// float32 sums differs from the plain version's library products.  A row
// with pos[b] < 0 has no valid row, and attend_full then weighs all S
// rows alike (every score -1e30): the kernel does the same.  The library
// is built with -fmad=false; every product here is exact, so a fused
// multiply-add would round the same.  Deterministic: no atomics, every
// sum in a fixed order that depends on n_b alone.
//
// Bound: the bytes of the valid K and V rows, each read once: 2 * n_b *
// D * 2 bytes a (b, h), 302 MB a launch at the LM serving cell's shape
// (B 32, S 1,280, Kv 32, G 1, D 64, ~1,152 valid rows), 90 us at 3.35
// TB/s; q, pos and the output are under 0.1 % of it.
//
// Design: one CTA of DA_THREADS threads per (b, h): 1,024 CTAs at the
// cell's shape, all resident at once (a CTA takes ~6 KB of shared memory
// and few registers).  The CTA reads its K rows once with 16-byte loads,
// a row spread over TPR lanes (8 at D = 64 and so 4 rows a warp; 16 at D
// = 96 or 128, where lanes past D / 8 read nothing), DA_UNROLL rows a
// thread issued before any is used; the G query rows sit in registers and
// share each K load.  The G * n_b scores stay in shared memory (G * S
// floats, 5 KB at S = 1,280), so the max and the sum are taken over
// shared memory, then one pass over V reads each valid row once, adds
// w_j v_j into per-lane float32 partials, and the partials meet by a
// butterfly within the warp and in warp order across the CTA.  The grid
// depends on S only, never on pos.  D and G are run-time arguments: four
// instantiations (8 or 16 lanes a row; one query group, or registers for
// up to DA_MAX_G of them) keep the build short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DA_THREADS 128     // threads a CTA (kernels/decode_attention.py: THREADS)
#define DA_WARPS 4         // DA_THREADS / 32
#define DA_UNROLL 4        // K or V rows a thread loads before it uses them
#define DA_MAX_G 8         // query rows a kv head (decode_attention.py: MAX_GROUPS)
#define DA_SCORES_MAX 32768  // G * S scores a CTA keeps (decode_attention.py: SCORES_MAX)
#define DA_SMEM_MAX 232448   // shared memory a CTA may take on an H100, static included

namespace {

constexpr float kMasked = -1e30f;  // attend_full's NEG_INF

// Lanes a cache row spreads over: one 16-byte chunk (8 values) a lane,
// 8 lanes for D <= 64, 16 for D <= 128 (lanes past D / 8 read nothing).
template <int TPR>
struct Geo {
  static constexpr int kRpw = 32 / TPR;          // rows a warp a load
  static constexpr int kRps = kRpw * DA_WARPS;   // rows a CTA a load
};

// eight bfloat16 values to float32, exactly: element 2i is the low half
// of word i
__device__ __forceinline__ void unpack(const uint4 r, float (&f)[8]) {
  f[0] = __uint_as_float(r.x << 16);
  f[1] = __uint_as_float(r.x & 0xffff0000u);
  f[2] = __uint_as_float(r.y << 16);
  f[3] = __uint_as_float(r.y & 0xffff0000u);
  f[4] = __uint_as_float(r.z << 16);
  f[5] = __uint_as_float(r.z & 0xffff0000u);
  f[6] = __uint_as_float(r.w << 16);
  f[7] = __uint_as_float(r.w & 0xffff0000u);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the G values of every thread reduced over the CTA, in a fixed order:
// a butterfly within each warp (every lane ends with the same value), then
// the warps in order.  `part` holds DA_WARPS * G floats.
// the GM values of every thread reduced over the CTA, in a fixed order:
// a butterfly within each warp (every lane ends with the same value), then
// the warps in order.  `part` holds DA_WARPS * GM floats.
template <int GM, bool kMax>
__device__ __forceinline__ void block_reduce(float (&x)[GM], float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], off);
      x[g] = kMax ? fmaxf(x[g], y) : __fadd_rn(x[g], y);
    }
  }
  __syncthreads();  // `part` may still be read from the last reduction
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) part[warp * GM + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float t = part[g];
#pragma unroll
    for (int w = 1; w < DA_WARPS; ++w)
      t = kMax ? fmaxf(t, part[w * GM + g]) : __fadd_rn(t, part[w * GM + g]);
    x[g] = t;
  }
}

// TPR lanes a row; GM the most query groups a kv head (G <= GM at run
// time: one instantiation holds G = 1, the other every G up to DA_MAX_G)
template <int TPR, int GM>
__global__ void __launch_bounds__(DA_THREADS)
    decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const long long* __restrict__ pos,
                            __nv_bfloat16* __restrict__ out, int S, int Kv,
                            int G, int D, float scale) {
  using Gm = Geo<TPR>;
  extern __shared__ float smem[];
  float* w = smem;                 // [G][S]: scores, then weights
  float* red = smem + G * S;       // [DA_WARPS][G][D]: V partials
  __shared__ float part[DA_WARPS * GM];
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % TPR;        // the 16-byte chunk this lane reads
  const int sub = lane / TPR;      // its row within the warp's rows
  const bool on = c < D / 8;
  const long long p = pos[b];
  const bool none = p < 0;
  const int n = none ? S : static_cast<int>(p + 1 < S ? p + 1 : S);
  const size_t stride = static_cast<size_t>(Kv) * D;  // between cache rows
  const size_t base = (static_cast<size_t>(b) * S * Kv + h) * D + c * 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // ---- scores: s_j = (q . k_j) * scale, the G query rows on each load
  if (none) {
    for (int j = threadIdx.x; j < S; j += DA_THREADS) {
      for (int g = 0; g < G; ++g) w[g * S + j] = kMasked;
    }
  } else {
    float qf[GM][8];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const size_t at = ((static_cast<size_t>(b) * Kv + h) * G + g) * D + c * 8;
      unpack(on && g < G ? __ldg(reinterpret_cast<const uint4*>(q + at)) : zero,
             qf[g]);
    }
    // the trip count is the warp's, so every lane reaches the shuffles
    for (int j0 = warp * Gm::kRpw; j0 < n; j0 += Gm::kRps * DA_UNROLL) {
      uint4 kr[DA_UNROLL];
#pragma unroll
      for (int u = 0; u < DA_UNROLL; ++u) {
        const int j = j0 + sub + u * Gm::kRps;
        kr[u] = on && j < n
                    ? __ldg(reinterpret_cast<const uint4*>(k + base + j * stride))
                    : zero;
      }
#pragma unroll
      for (int u = 0; u < DA_UNROLL; ++u) {
        const int j = j0 + sub + u * Gm::kRps;
        float kf[8];
        unpack(kr[u], kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {  // uniform over the CTA
            float s = __fmul_rn(qf[g][0], kf[0]);
#pragma unroll
            for (int e = 1; e < 8; ++e) s = __fadd_rn(s, __fmul_rn(qf[g][e], kf[e]));
#pragma unroll
            for (int off = TPR / 2; off > 0; off >>= 1)
              s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
            if (c == 0 && j < n) w[g * S + j] = __fmul_rn(s, scale);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- softmax over the n scores of each query row, in float32
  float m[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kMasked;
    if (g < G)
      for (int j = threadIdx.x; j < n; j += DA_THREADS) m[g] = fmaxf(m[g], w[g * S + j]);
  }
  block_reduce<GM, true>(m, part);
  float l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    l[g] = 0.f;
    if (g < G)
      for (int j = threadIdx.x; j < n; j += DA_THREADS) {
        const float e = expf(__fsub_rn(w[g * S + j], m[g]));
        w[g * S + j] = e;
        l[g] = __fadd_rn(l[g], e);
      }
  }
  block_reduce<GM, false>(l, part);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G)
      for (int j = threadIdx.x; j < n; j += DA_THREADS)
        w[g * S + j] = bf16_round(__fdiv_rn(w[g * S + j], l[g]));
  }
  __syncthreads();

  // ---- o = sum_j w_j v_j: per-lane float32 partials over the V rows
  float acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  for (int j0 = warp * Gm::kRpw; j0 < n; j0 += Gm::kRps * DA_UNROLL) {
    uint4 vr[DA_UNROLL];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int j = j0 + sub + u * Gm::kRps;
      vr[u] = on && j < n
                  ? __ldg(reinterpret_cast<const uint4*>(v + base + j * stride))
                  : zero;
    }
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int j = j0 + sub + u * Gm::kRps;
      if (j < n) {
        float vf[8];
        unpack(vr[u], vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float wj = w[g * S + j];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[g][e] = __fadd_rn(acc[g][e], __fmul_rn(wj, vf[e]));
          }
        }
      }
    }
  }
  // the warp's rows meet by a butterfly over the lanes of one chunk
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1)
        acc[g][e] = __fadd_rn(acc[g][e], __shfl_xor_sync(0xffffffffu, acc[g][e], off));
    }
  }
  if (sub == 0 && on) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[(warp * G + g) * D + c * 8 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  // then the warps, in order, and one rounding to bfloat16
  __nv_bfloat16* o = out + (static_cast<size_t>(b) * Kv + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += DA_THREADS) {
    float t = red[i];
#pragma unroll
    for (int wp = 1; wp < DA_WARPS; ++wp) t = __fadd_rn(t, red[wp * G * D + i]);
    o[i] = __float2bfloat16_rn(t);
  }
}

using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                        const __nv_bfloat16*, const long long*,
                        __nv_bfloat16*, int, int, int, int, float);

// the instantiation for (D, G) and its index (for the shared-memory raise)
Kernel pick(int D, int G, int* index) {
  const bool narrow = D <= 64, single = G == 1;
  *index = (narrow ? 0 : 2) + (single ? 0 : 1);
  if (narrow)
    return single ? decode_attention_kernel<8, 1> : decode_attention_kernel<8, DA_MAX_G>;
  return single ? decode_attention_kernel<16, 1> : decode_attention_kernel<16, DA_MAX_G>;
}

// Raise a kernel's dynamic shared-memory limit to all that DA_SMEM_MAX
// leaves beside its static shared memory, once a device, at the first
// launch that needs more than the default 48 KB, and never on a launch
// that a CUDA graph records: cudaFuncSetAttribute is not a stream
// operation and must not run during a capture.  A capture whose shape
// needs the raise before any eager launch has made it fails here; a caller
// runs the shape once eagerly first (the serving engine does).
cudaError_t allow_smem(int index, Kernel kernel, int smem,
                       cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices][4] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  bool& done = raised[dev][index];
  if (done) return cudaSuccess;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  if ((err = cudaStreamIsCapturing(stream, &capture)) != cudaSuccess) return err;
  if (capture != cudaStreamCaptureStatusNone)
    return cudaErrorStreamCaptureUnsupported;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel))) !=
      cudaSuccess)
    return err;
  const int room = DA_SMEM_MAX - static_cast<int>(attr.sharedSizeBytes);
  if (smem > room) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, room);
  if (err != cudaSuccess) return err;
  done = true;
  return cudaSuccess;
}

// Dynamic shared memory of a CTA: the G * S scores, then the warps' V
// partials (kernels/decode_attention.py::plan computes the same).
int smem_bytes(int S, int G, int D) {
  return static_cast<int>((static_cast<long long>(G) * S +
                           static_cast<long long>(DA_WARPS) * G * D) *
                          sizeof(float));
}

}  // namespace

// q (B, 1, Kv, G, D), k and v (B, S, Kv, D), out (B, 1, Kv, G, D): all
// bfloat16, contiguous and 16-byte aligned (the wrapper checks); pos (B,)
// int64.  Returns a CUDA error code, 0 on success.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int B, int S, int Kv, int G,
                                       int D, float scale, void* stream) {
  if (B < 0 || S < 1 || Kv < 1 || G < 1 || G > DA_MAX_G ||
      static_cast<long long>(G) * S > DA_SCORES_MAX || B > 65535)
    return cudaErrorInvalidValue;
  if (D != 64 && D != 96 && D != 128) return cudaErrorInvalidValue;
  int index = 0;
  const Kernel kernel = pick(D, G, &index);
  if (B == 0) return cudaSuccess;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (bits % 16 != 0) return cudaErrorMisalignedAddress;
  const int smem = smem_bytes(S, G, D);
  if (smem > DA_SMEM_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(index, kernel, smem, s);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Kv, B), DA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const long long*>(pos),
      static_cast<__nv_bfloat16*>(out), S, Kv, G, D, scale);
  return cudaGetLastError();
}
