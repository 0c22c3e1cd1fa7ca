// Stage marks: one empty kernel a stage of the chained step, and the node
// count of a graph under capture.
//
// Replaces no TPU kernel. The chained batch (models/simulator.py:ChainedBatch)
// replays a step of ~5,500 nodes from a CUDA graph, and a host range
// (record_function, NVTX) around a stage runs once, at capture, and never at
// replay. A mark launched into the graph where a stage starts is a device
// event named after the stage, mcray_mark_<stage>, on the replayed timeline:
// a trace splits there by stage (utils/profiling.py:mark, STAGES, in this
// order). One thread, no memory traffic: a mark costs its launch, ~1-2 us of
// device time.
//
// mcray_capture_nodes counts the nodes of the graph being captured on a
// stream: the step graph's size, read once at the end of its capture.

#include <cuda_runtime.h>

extern "C" __global__ void mcray_mark_draws() {}
extern "C" __global__ void mcray_mark_prepass() {}
extern "C" __global__ void mcray_mark_closest_hit() {}
extern "C" __global__ void mcray_mark_bounce_physics() {}
extern "C" __global__ void mcray_mark_march() {}
extern "C" __global__ void mcray_mark_image() {}

// Launch the mark of stage `stage` (an index into utils/profiling.py:STAGES).
extern "C" int mcray_mark(int stage, cudaStream_t stream) {
  switch (stage) {
    case 0: mcray_mark_draws<<<1, 1, 0, stream>>>(); break;
    case 1: mcray_mark_prepass<<<1, 1, 0, stream>>>(); break;
    case 2: mcray_mark_closest_hit<<<1, 1, 0, stream>>>(); break;
    case 3: mcray_mark_bounce_physics<<<1, 1, 0, stream>>>(); break;
    case 4: mcray_mark_march<<<1, 1, 0, stream>>>(); break;
    case 5: mcray_mark_image<<<1, 1, 0, stream>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Nodes of the graph that `stream` is capturing into, or -1 where it captures
// none (a query: the capture goes on unchanged).
extern "C" long long mcray_capture_nodes(cudaStream_t stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  size_t n = 0;
  if (cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive || cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return -1;
  }
  return (long long)n;
}
