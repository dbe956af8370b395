// Phase markers: empty kernels whose names say where a phase of the
// device's work begins and ends.
//
// The LM serving engine's prefill and decode step, the static training
// step's update, and inside them a DeepSeek-style expert layer (`moe`) and
// a latent-attention core (`mla`) run inside CUDA graphs, whose kernels
// share names with the rest of the work; a marker launched on the phase's
// stream at each end is recorded into the graph, so every replay shows the phase in the
// profiler's trace as the interval from its begin marker's start to its
// end marker's end.  The names are C names (no mangling), each
// `phase_marker_<phase>`; the launcher's `phase` is the index in
// PHASE_MARKERS, the order of kernels/markers.py's PHASES.  A marker reads
// and writes nothing: one thread of one CTA, about 2 us of device time.

#include <cuda_runtime.h>

#define PHASE_MARKER(phase) \
  extern "C" __global__ void phase_marker_##phase() {}

PHASE_MARKER(prefill_begin)
PHASE_MARKER(prefill_end)
PHASE_MARKER(decode_begin)
PHASE_MARKER(decode_end)
PHASE_MARKER(update_begin)
PHASE_MARKER(update_end)
PHASE_MARKER(moe_begin)
PHASE_MARKER(moe_end)
PHASE_MARKER(mla_begin)
PHASE_MARKER(mla_end)

static void (*const PHASE_MARKERS[])() = {
    phase_marker_prefill_begin, phase_marker_prefill_end,
    phase_marker_decode_begin,  phase_marker_decode_end,
    phase_marker_update_begin,  phase_marker_update_end,
    phase_marker_moe_begin,     phase_marker_moe_end,
    phase_marker_mla_begin,     phase_marker_mla_end,
};

extern "C" int phase_marker_launch(int phase, void* stream) {
  const int n = static_cast<int>(sizeof(PHASE_MARKERS) / sizeof(PHASE_MARKERS[0]));
  if (phase < 0 || phase >= n) return cudaErrorInvalidValue;
  return cudaLaunchKernel(reinterpret_cast<const void*>(PHASE_MARKERS[phase]),
                          dim3(1), dim3(1), nullptr, 0,
                          static_cast<cudaStream_t>(stream));
}
