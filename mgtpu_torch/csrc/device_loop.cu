// The device-side while loop of the recorded Krylov and refinement loops
// (cycle/capture.py `loop`).
//
// mgtpu runs each of these loops as one `lax.while_loop`: the device tests
// the condition and runs the next iteration, and the host waits until it
// stops.  The port records the loop's start (`init`) and one iteration
// (`body`, its new state written back into the loop's buffers) as two
// torch CUDA graphs, and this file makes them one executable graph with a
// conditional WHILE node (CUDA 12.3 or later):
//
//   init graph -> set_cond(h, go_init) -> WHILE(h) { body graph ->
//                                                    set_cond(h, go_body) }
//
// Both torch graphs go in as child-graph nodes; `go_init` and `go_body`
// are the 0-dim bool tensors the two graphs write (the loop's condition
// after the start and after each iteration).  A launch of the result runs
// the whole loop with no host step, where the chunked form of the same
// loop needs a host read of the flag, a copy of the state and a graph
// launch every few iterations.
//
// set_cond replaces no TPU kernel: it is the one step of `lax.while_loop`
// that a CUDA graph cannot express with torch's operations, the write of
// the condition into the graph's conditional handle.  One thread reads one
// byte; what bounds it is its launch, one a loop iteration.
//
// Under torch.profiler's CUDA tracing (CUPTI), launches of such a graph
// faulted with an illegal address in 5 of 13 traced benchmark runs on an
// H100 (CUDA 12.8), never untraced; the cause was not found.  The caller
// (capture.py) launches it only while torch.profiler is off.  Each graph
// is instantiated once: instantiating one again while its executable
// lived (and the profiler traced) returned cudaErrorNotSupported there.
#include <cuda_runtime.h>

#include <vector>

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

__global__ void set_cond(cudaGraphConditionalHandle handle, const bool* go) {
  cudaGraphSetConditional(handle, *go ? 1u : 0u);
}

namespace {

// a set_cond kernel node in `graph` after `dep`
cudaError_t add_set_cond(cudaGraphNode_t* node, cudaGraph_t graph,
                         cudaGraphNode_t dep, cudaGraphConditionalHandle h,
                         const bool* go) {
  void* args[2] = {&h, &go};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_cond);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, &dep, 1, &p);
}

// the WHILE node on `h` after `dep`; its body graph (owned by the node)
cudaError_t add_while(cudaGraphNode_t* node, cudaGraph_t graph,
                      cudaGraphNode_t dep, cudaGraphConditionalHandle h,
                      cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, graph, &dep, nullptr, 1, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, graph, &dep, 1, &p);
#endif
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

// the steps of a build, reported where one fails
enum Stage {
  kHandle = 1, kInit, kCond0, kWhile, kStep, kCond1, kInstantiate
};

cudaError_t assemble(cudaGraph_t g, cudaGraph_t init, cudaGraph_t step,
                     const bool* go_init, const bool* go_body, int* stage) {
  cudaGraphConditionalHandle h;
  cudaGraphNode_t n_init, n_cond0, n_while, n_step, n_cond1;
  cudaGraph_t body = nullptr;
  *stage = kHandle;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (e != cudaSuccess) return e;
  *stage = kInit;
  e = cudaGraphAddChildGraphNode(&n_init, g, nullptr, 0, init);
  if (e != cudaSuccess) return e;
  *stage = kCond0;
  e = add_set_cond(&n_cond0, g, n_init, h, go_init);
  if (e != cudaSuccess) return e;
  *stage = kWhile;
  e = add_while(&n_while, g, n_cond0, h, &body);
  if (e != cudaSuccess) return e;
  *stage = kStep;
  e = cudaGraphAddChildGraphNode(&n_step, body, nullptr, 0, step);
  if (e != cudaSuccess) return e;
  *stage = kCond1;
  return add_set_cond(&n_cond1, body, n_step, h, go_body);
}

bool in_host_memory(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();                 // an unregistered host pointer
    return true;
  }
  return a.type != cudaMemoryTypeDevice && a.type != cudaMemoryTypeManaged;
}

cudaError_t census(cudaGraph_t g, int* counts, int n) {
  size_t count = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &count);
  if (e != cudaSuccess || count == 0) return e;
  std::vector<cudaGraphNode_t> nodes(count);
  e = cudaGraphGetNodes(g, nodes.data(), &count);
  for (size_t i = 0; e == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    if (static_cast<int>(t) < n - 1) ++counts[t];
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = census(child, counts, n);
    } else if (t == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      e = cudaGraphMemcpyNodeGetParams(nodes[i], &p);
      if (e == cudaSuccess &&
          (in_host_memory(p.srcPtr.ptr) || in_host_memory(p.dstPtr.ptr)))
        ++counts[n - 1];
    }
  }
  return e;
}

}  // namespace

// counts[t] (t < n - 1): the graph's nodes of cudaGraphNodeType t, those of
// its child graphs included; counts[n - 1]: its memcpy nodes with an
// operand outside device memory.  A conditional node's body takes kernel,
// empty, child-graph, memset and device-memory memcpy nodes alone.
extern "C" int mgt_graph_census(void* graph, int* counts, int n) {
  if (!graph || !counts || n < 2) return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) counts[i] = 0;
  return census(static_cast<cudaGraph_t>(graph), counts, n);
}

// Builds and instantiates the loop from the raw graphs of two recordings
// (torch's `CUDAGraph(keep_graph=True).raw_cuda_graph()`, which the child
// nodes copy) and the two condition tensors' device addresses.  On success
// *exec and *graph hold the executable and its graph (mgt_loop_free); on a
// failure *stage says which step failed (Stage).
extern "C" int mgt_loop_build(void* init, void* step, const void* go_init,
                              const void* go_body, void** exec, void** graph,
                              int* stage) {
  if (!init || !step || !go_init || !go_body || !exec || !graph || !stage)
    return cudaErrorInvalidValue;
  cudaGraph_t g;
  *stage = 0;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return e;
  e = assemble(g, static_cast<cudaGraph_t>(init),
               static_cast<cudaGraph_t>(step),
               static_cast<const bool*>(go_init),
               static_cast<const bool*>(go_body), stage);
  cudaGraphExec_t x = nullptr;
  if (e == cudaSuccess) {
    *stage = kInstantiate;
    e = cudaGraphInstantiate(&x, g, 0);
  }
  if (e != cudaSuccess) {
    cudaGraphDestroy(g);
    return e;
  }
  *exec = x;
  *graph = g;
  return cudaSuccess;
}

// Runs the whole loop on `stream`.
extern "C" int mgt_loop_launch(void* exec, void* stream) {
  if (!exec) return cudaErrorInvalidValue;
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

extern "C" int mgt_loop_free(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = f;
  }
  return e;
}
