// A CUDA graph conditional (IF) node opened in the graph that a stream is
// capturing: the counterpart, inside a captured frame body, of the
// ``jax.lax.cond`` that the JAX package compiles into its scan body
// (gradslam_tpu/slam/icpslam.py:1085, :1183, :1365). It replaces no TPU
// kernel: XLA decides a ``lax.cond`` on the device, and so does this node.
//
// gradslam_if_begin, called while ``capture`` captures:
//   1. makes a conditional handle in the capturing graph;
//   2. captures a one-thread kernel that sets the handle from ``*pred``
//      (a bool on the device), so every replay decides from the value the
//      graph computed before it;
//   3. adds an IF node after the capture's current dependencies and makes
//      it the capture's only dependency, so later work waits for it;
//   4. starts capturing ``body`` (another stream) into the node's body
//      graph.
// gradslam_if_end ends the body's capture. What ``body`` launches in
// between runs on a replay only where the predicate was true. The node has
// no else branch: the caller fills what it writes with the values that pass
// through before the node.
//
// Bound: one byte read and one handle write a node; the node's cost is the
// launch of its set kernel and the body's scheduling, a few microseconds.
// Needs CUDA 12.4 or later (conditional nodes, capture into a given graph).

#include <cuda_runtime.h>

namespace {

__global__ void set_if_handle(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int gradslam_if_begin(void* capture, const void* pred, void* body) {
  cudaStream_t s = static_cast<cudaStream_t>(capture);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, nullptr, &n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if_handle<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the set kernel is now the capture's dependency
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, nullptr, &n);
#else
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeGlobal));
}

extern "C" int gradslam_if_end(void* body) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}

extern "C" const char* gradslam_cuda_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
