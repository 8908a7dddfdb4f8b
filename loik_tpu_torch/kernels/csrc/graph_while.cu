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
//
// `loik_graph_nodes` lists a captured graph's nodes (types, dependencies,
// kernel names) for `utils.graphs.node_kinds`, by which a profiler trace of a
// replay is split into the solver's phases; `loik_capture_graph` finds a WHILE
// node's body graph for it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cxxabi.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>

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
#define LOIK_NODE_DEPS(node, deps, n) cudaGraphNodeGetDependencies(node, deps, nullptr, n)
#else
#define LOIK_CAPTURE_INFO(s, status, graph, deps, n) \
  cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n)
#define LOIK_ADD_NODE(node, graph, deps, n, params) \
  cudaGraphAddNode(node, graph, deps, n, params)
#define LOIK_SET_DEPS(s, deps, n) \
  cudaStreamUpdateCaptureDependencies(s, deps, n, cudaStreamSetCaptureDependencies)
#define LOIK_NODE_DEPS(node, deps, n) cudaGraphNodeGetDependencies(node, deps, n)
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

// The graph being captured on `stream` (a WHILE node's body graph, read before
// its capture ends: it lives on in the node).
int loik_capture_graph(void* stream, void** graph_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  LOIK_TRY(LOIK_CAPTURE_INFO((cudaStream_t)stream, &status, &graph, &deps, &n_deps));
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  *graph_out = graph;
  return cudaSuccess;
}

}  // extern "C"

// A CUDA driver API entry point (the runtime has no call that names a kernel node's
// function), or null.
static void* loik_driver(const char* symbol) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(symbol, &fn, 12030, cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint(symbol, &fn, cudaEnableDefault, &found);
#endif
  if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
    (void)cudaGetLastError();
    return nullptr;
  }
  return fn;
}

typedef CUresult (*loik_kernel_params_t)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
typedef CUresult (*loik_func_name_t)(const char**, CUfunction);
typedef CUresult (*loik_kernel_name_t)(const char**, CUkernel);

// The mangled name of a kernel node's function, or null.
static const char* loik_kernel_name(cudaGraphNode_t node) {
  static loik_kernel_params_t params_of =
      (loik_kernel_params_t)loik_driver("cuGraphKernelNodeGetParams");
  static loik_func_name_t func_name = (loik_func_name_t)loik_driver("cuFuncGetName");
  static loik_kernel_name_t kernel_name = (loik_kernel_name_t)loik_driver("cuKernelGetName");
  CUDA_KERNEL_NODE_PARAMS p;
  std::memset(&p, 0, sizeof(p));
  if (!params_of || params_of((CUgraphNode)node, &p) != CUDA_SUCCESS) return nullptr;
  const char* name = nullptr;
  if (p.func && func_name && func_name(&name, p.func) == CUDA_SUCCESS) return name;
  if (p.kern && kernel_name && kernel_name(&name, p.kern) == CUDA_SUCCESS) return name;
  return nullptr;
}

typedef CUresult (*loik_node_type_t)(CUgraphNode, CUgraphNodeType*);

// A node's type: the runtime's answer, else the CUDA driver API's (CUDA 12.8's runtime
// fails with cudaErrorUnknown on a WHILE node added by loik_while_begin).
static cudaError_t loik_node_type(cudaGraphNode_t node, cudaGraphNodeType* type) {
  cudaError_t e = cudaGraphNodeGetType(node, type);
  if (e == cudaSuccess) return e;
  (void)cudaGetLastError();
  static loik_node_type_t type_of = (loik_node_type_t)loik_driver("cuGraphNodeGetType");
  CUgraphNodeType t;
  if (!type_of || type_of((CUgraphNode)node, &t) != CUDA_SUCCESS) return e;
  *type = (cudaGraphNodeType)t;
  return cudaSuccess;
}

static size_t loik_put(char* out, size_t cap, size_t used, const char* s) {
  size_t n = std::strlen(s);
  if (used + n <= cap) std::memcpy(out + used, s, n);
  return used + n;
}

extern "C" {

// The nodes of `graph` in cudaGraphGetNodes' order: each one's
// cudaGraphNodeType in `types`, in `chained` whether it depends on exactly the
// node before it (none for the first: the graph is then one chain, in the
// order the capture recorded it), and one line of `names` per node: for a
// kernel node the name of its function as a profiler trace shows it, demangled
// (mangled where it does not demangle, "?" where the CUDA driver API gives
// none); empty for any other node.
// A node whose type or dependencies cannot be read gets -1 there, and its
// line "!<the call>:<its error>"; the listing goes on.  `*n_out` and
// `*used_out` get the nodes and the bytes of the lines; when more than
// `n_max` nodes or `cap` bytes were needed nothing is complete and the call
// returns cudaErrorInvalidValue: call again with that room.
int loik_graph_nodes(void* graph, size_t n_max, int* types, int* chained, char* names,
                     size_t cap, size_t* n_out, size_t* used_out) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t n = 0;
  LOIK_TRY(cudaGraphGetNodes(g, nullptr, &n));
  *n_out = n;
  cudaGraphNode_t* nodes = (cudaGraphNode_t*)std::malloc((n ? n : 1) * sizeof(cudaGraphNode_t));
  if (!nodes) return cudaErrorMemoryAllocation;
  cudaError_t e = cudaGraphGetNodes(g, nodes, &n);
  size_t used = 0;
  char note[64];
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    cudaError_t e_type = loik_node_type(nodes[i], &type);
    size_t n_deps = 0;
    cudaGraphNode_t dep = nullptr;
    cudaError_t e_deps = LOIK_NODE_DEPS(nodes[i], nullptr, &n_deps);
    if (e_deps == cudaSuccess && n_deps == 1) e_deps = LOIK_NODE_DEPS(nodes[i], &dep, &n_deps);
    if (i < n_max) {
      types[i] = e_type == cudaSuccess ? (int)type : -1;
      chained[i] = e_deps != cudaSuccess ? -1
                   : i == 0              ? n_deps == 0
                                         : (n_deps == 1 && dep == nodes[i - 1]);
    }
    if (e_type != cudaSuccess || e_deps != cudaSuccess) {
      (void)cudaGetLastError();
      std::snprintf(note, sizeof(note), "!%s:%d", e_type != cudaSuccess ? "type" : "deps",
                    (int)(e_type != cudaSuccess ? e_type : e_deps));
      used = loik_put(names, cap, used, note);
    } else if (type == cudaGraphNodeTypeKernel) {
      const char* name = loik_kernel_name(nodes[i]);
      if (!name) {
        used = loik_put(names, cap, used, "?");
      } else {
        int status = 0;
        char* plain = abi::__cxa_demangle(name, nullptr, nullptr, &status);
        used = loik_put(names, cap, used, status == 0 && plain ? plain : name);
        std::free(plain);
      }
    }
    used = loik_put(names, cap, used, "\n");
  }
  std::free(nodes);
  *used_out = used;
  if (e != cudaSuccess) return e;
  return n > n_max || used > cap ? cudaErrorInvalidValue : cudaSuccess;
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
