// The device-side masked while loop: a CUDA graph conditional node of type
// WHILE, the counterpart of the `lax.while_loop` that loik_tpu compiles into
// every jitted solve (loik_tpu/solver/solve.py::_solve_loop).
//
// This is launch plumbing, not a port of a TPU kernel: the only kernel here
// reads one flag and sets the node's condition.  `utils/graphs.py` drives it
// while torch captures a CUDA graph on the PARENT stream:
//
//   loik_while_begin(parent, body, flag)  a kernel on the parent stream sets
//       the condition from `flag` (cond(carry) before the loop, so a loop of
//       zero trips runs no body), a WHILE node is added after it, the parent's
//       later work is made to depend on the node, and the BODY stream starts
//       capturing into the node's body graph;
//   ... the body's operators on the body stream ...
//   loik_while_end(body, handle, flag, trips)  a last kernel in the body
//       sets the condition from `flag` (cond(new carry)) and adds one to the
//       body-execution counter `trips`, and the body's capture ends.
//
// At replay the node runs its body graph again and again while the condition
// is nonzero, with no host round trip.  Needs CUDA 12.4 (WHILE nodes and
// cudaStreamBeginCaptureToGraph); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "the device-side while loop needs CUDA 12.4 or later (conditional WHILE nodes)"
#endif

// CUDA 13 gave the capture-dependency calls their edge-data arguments.
#if CUDART_VERSION >= 13000
#define LOIK_CAPTURE_INFO(s, status, graph, deps, n) \
  cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr, n)
#define LOIK_ADD_NODE(node, graph, deps, n, params) \
  cudaGraphAddNode(node, graph, deps, nullptr, n, params)
#define LOIK_SET_DEPS(s, deps, n) \
  cudaStreamUpdateCaptureDependencies(s, deps, nullptr, n, cudaStreamSetCaptureDependencies)
#else
#define LOIK_CAPTURE_INFO(s, status, graph, deps, n) \
  cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n)
#define LOIK_ADD_NODE(node, graph, deps, n, params) \
  cudaGraphAddNode(node, graph, deps, n, params)
#define LOIK_SET_DEPS(s, deps, n) \
  cudaStreamUpdateCaptureDependencies(s, deps, n, cudaStreamSetCaptureDependencies)
#endif

// One thread: the loop continues while *flag (a bool tensor) is true; at the
// end of a body, one more body execution goes into *trips (an int64 tensor
// that graphs of several host threads may share; null before the node).
__global__ void loik_set_condition(cudaGraphConditionalHandle handle, const bool* flag,
                                   unsigned long long* trips) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
  if (trips) atomicAdd(trips, 1ull);
}

#define LOIK_TRY(call)                  \
  do {                                  \
    cudaError_t e_ = (call);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

extern "C" {

// Load the condition kernel now, outside any capture (lazy module loading
// inside a capture is what this avoids).
int loik_while_prepare(void) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, loik_set_condition);
}

// See the top of the file.  `mode` is the body capture's cudaStreamCaptureMode.
int loik_while_begin(void* parent_stream, void* body_stream, const void* flag,
                     int mode, unsigned long long* handle_out) {
  cudaStream_t parent = (cudaStream_t)parent_stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  LOIK_TRY(LOIK_CAPTURE_INFO(parent, &status, &graph, &deps, &n_deps));
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  LOIK_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  loik_set_condition<<<1, 1, 0, parent>>>(handle, (const bool*)flag, nullptr);
  LOIK_TRY(cudaGetLastError());
  LOIK_TRY(LOIK_CAPTURE_INFO(parent, &status, &graph, &deps, &n_deps));

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  LOIK_TRY(LOIK_ADD_NODE(&node, graph, deps, n_deps, &params));
  cudaGraph_t body = params.conditional.phGraph_out[0];
  LOIK_TRY(LOIK_SET_DEPS(parent, &node, 1));
  LOIK_TRY(cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body, nullptr,
                                         nullptr, 0, (cudaStreamCaptureMode)mode));
  *handle_out = handle;
  return cudaSuccess;
}

// Nodes of the graph being captured on `stream` (its top level).
int loik_capture_nodes(void* stream, unsigned long long* n_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0, n = 0;
  LOIK_TRY(LOIK_CAPTURE_INFO((cudaStream_t)stream, &status, &graph, &deps, &n_deps));
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  LOIK_TRY(cudaGraphGetNodes(graph, nullptr, &n));
  *n_out = n;
  return cudaSuccess;
}

// See the top of the file; `nodes_out` gets the body graph's nodes.
int loik_while_end(void* body_stream, unsigned long long handle, const void* flag,
                   void* trips, unsigned long long* nodes_out) {
  cudaStream_t body = (cudaStream_t)body_stream;
  loik_set_condition<<<1, 1, 0, body>>>((cudaGraphConditionalHandle)handle,
                                        (const bool*)flag, (unsigned long long*)trips);
  cudaError_t launched = cudaGetLastError();
  cudaError_t counted =
      launched == cudaSuccess ? (cudaError_t)loik_capture_nodes(body, nodes_out) : launched;
  cudaGraph_t graph;
  cudaError_t ended = cudaStreamEndCapture(body, &graph);
  return counted != cudaSuccess ? counted : ended;
}

// End a body capture that failed; returns the capture's error, if any.
int loik_while_abort(void* body_stream) {
  cudaGraph_t graph;
  cudaError_t e = cudaStreamEndCapture((cudaStream_t)body_stream, &graph);
  (void)cudaGetLastError();
  return e;
}

}  // extern "C"
