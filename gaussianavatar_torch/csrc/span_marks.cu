// The span markers: one empty kernel at each end of each of the program's
// spans (gaussianavatar_torch/utils/spans.py), with a plain C interface
// (loaded through ctypes).
//
// `span("train::decode", device)` launches ga_span__train_decode__b on the
// current stream where the span opens and ga_span__train_decode__e where it
// closes ("::" written "_"). A CUDA graph captures the launches, so every
// replay runs them again, and the profiler's device trace records them by
// name on the device's own clock: the device work of one span instance lies
// between the start of its begin marker and the end of its end marker.
// These symbol names are what a trace reader matches; no marker's name may
// contain the name of another kernel of the program (blend_fwd_kernel,
// blend_bwd_kernel), which readers match as substrings.
//
// GA_SPANS lists every span, one X(...) per line; the order is the index
// ga_span_mark takes (utils/spans.py reads it through ga_span_name).

#include <cuda_runtime.h>

#define GA_SPANS(X)            \
  X(train_step)                \
  X(train_decode)              \
  X(train_decode_bwd)          \
  X(train_loss)                \
  X(train_aiap)                \
  X(train_lpips)               \
  X(train_backward)            \
  X(train_all_reduce)          \
  X(train_optimizer)           \
  X(train_feeds)               \
  X(train_replay)              \
  X(render_call)               \
  X(render_decode)             \
  X(render_pose_gaussians)     \
  X(render_attributes)         \
  X(render_projection)         \
  X(render_binning)            \
  X(render_blend)              \
  X(render_untile)             \
  X(render_blend_bwd)          \
  X(render_scatter_bwd)

#define GA_MARKERS(n)                                  \
  extern "C" __global__ void ga_span__##n##__b() {}    \
  extern "C" __global__ void ga_span__##n##__e() {}
GA_SPANS(GA_MARKERS)

namespace {

typedef void (*Marker)();

struct Span {
  const char* name;
  Marker begin;
  Marker end;
};

#define GA_ENTRY(n) {#n, ga_span__##n##__b, ga_span__##n##__e},
const Span kSpans[] = {GA_SPANS(GA_ENTRY)};
const int kCount = static_cast<int>(sizeof(kSpans) / sizeof(kSpans[0]));

}  // namespace

extern "C" int ga_span_count() { return kCount; }

// The i-th span's name as in the marker symbols (train_decode), or null.
extern "C" const char* ga_span_name(int i) {
  return i >= 0 && i < kCount ? kSpans[i].name : nullptr;
}

// Launches span i's begin marker (end 0) or end marker (end 1) on `stream`,
// one thread, no shared memory. Returns the launch's CUDA error (0 =
// launched).
extern "C" int ga_span_mark(int i, int end, void* stream) {
  if (i < 0 || i >= kCount) return static_cast<int>(cudaErrorInvalidValue);
  const Marker k = end ? kSpans[i].end : kSpans[i].begin;
  void* no_args[1] = {nullptr};
  const cudaError_t rc = cudaLaunchKernel(reinterpret_cast<const void*>(k), dim3(1), dim3(1),
                                          no_args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}
