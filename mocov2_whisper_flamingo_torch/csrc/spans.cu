// Span markers for Hopper (sm_90a): one empty one-thread kernel for each edge of each span
// that `utils/profiling.py::span` marks on the card.
//
// Ports no Pallas kernel and computes nothing. The train step runs as one replayed CUDA
// graph (training/programs.py), and a profiler ties every kernel of a replay to a single
// `cudaGraphLaunch`: the host ranges that ran while the graph was captured are not
// replayed. A marker launched on the current stream during the capture becomes a node of
// the graph, in stream order between the work before it and the work after it, so every
// replay leaves `span_open_<span>` and `span_close_<span>` on the device trace, on the
// same clock as every other kernel. `extern "C"` keeps the names unmangled: the trace
// prints them as written here. No name matches a kernel group of the benchmark's trace
// reader, so the markers count as "other" there.
//
// Cost: two launches a span of one thread that reads and writes nothing, each about 0.9 us of
// device time inside a replayed graph on an H100 (14 a train step: 0.012 ms of ~135). Nothing
// here synchronises, reads the card back or allocates.

#include <cuda_runtime.h>

#include <cstring>

// The spans that have markers, in the order the train step opens them.
#define SPAN_MARKERS(X) \
  X(train_step)         \
  X(frozen_audio)       \
  X(frozen_video)       \
  X(trainable_forward)  \
  X(losses)             \
  X(backward)           \
  X(optimizer)

#define DEFINE_MARKERS(name)                            \
  extern "C" __global__ void span_open_##name(void) {}  \
  extern "C" __global__ void span_close_##name(void) {}
SPAN_MARKERS(DEFINE_MARKERS)
#undef DEFINE_MARKERS

namespace {

struct Marker {
  const char* name;
  void (*open)(void);
  void (*close)(void);
};

#define MARKER_ENTRY(name) {#name, span_open_##name, span_close_##name},
const Marker kMarkers[] = {SPAN_MARKERS(MARKER_ENTRY)};
#undef MARKER_ENTRY

}  // namespace

// Launch the open (close == 0) or close marker of span `name` on `stream`. Returns the
// launch's CUDA error, 0 when it was queued, or -1 for a span without markers.
extern "C" int span_mark(const char* name, int close, void* stream) {
  for (const Marker& m : kMarkers) {
    if (std::strcmp(m.name, name) == 0) {
      const void* kernel = reinterpret_cast<const void*>(close ? m.close : m.open);
      void* no_args[1] = {nullptr};
      cudaLaunchKernel(kernel, dim3(1), dim3(1), no_args, 0, static_cast<cudaStream_t>(stream));
      return static_cast<int>(cudaGetLastError());
    }
  }
  return -1;
}
