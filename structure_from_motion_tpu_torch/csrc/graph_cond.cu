// Conditional nodes of a CUDA graph capture: a bucket switch decided on the
// device (IF) and a convergence loop stopped on the device (WHILE).
//
// No Pallas kernel stands behind this file: the JAX package picks its
// buckets with lax.switch and runs its LM and PCG loops as lax.while_loops
// inside one compiled program, whose predicates the device evaluates. Here,
// inside the capture of a steady frame (utils/control.graphed), each
// conditional node is added to the graph being captured and its body is
// captured from a second stream (cudaStreamBeginCaptureToGraph):
//
// * a branch of a switch (utils/control.switch) goes into the body of an
//   IF node; a one-thread kernel captured just before the node sets its
//   condition from a device bool (sfm_capture_if, sfm_end_capture);
// * a loop of k-step chunks (utils/control.masked_loop) becomes ONE WHILE
//   node whose body is one chunk, ending in a one-thread kernel that sets
//   the node's condition to "a problem is still active and fewer than n
//   steps ran" (sfm_begin_while, sfm_end_while). The body runs again while
//   the condition holds.
//
// The host makes no read in either: the frame's one host read is its
// grouped metric fetch.
//
// What bounds it: nothing of bytes or operations. A condition kernel reads
// a bool (and an int64) and writes the node's condition; a loop iteration
// costs the device's launch of its body's kernels, as a replay of a chunk's
// graph from the host would, without the host's read between chunks.
//
// A node goes into whatever graph the stream captures into: the frame's, or
// the body of an enclosing node, so a loop inside a bucket's branch is a
// WHILE node inside that branch's IF node, and IF nodes nest. An IF handle's
// default is 0 and its kernel sets it; a WHILE handle's default is 1,
// assigned at every launch of the graph: the first chunk always runs, as it
// does eagerly. A handle is made in the graph that holds its node.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void if_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void while_condition(cudaGraphConditionalHandle handle, const bool* active,
                                const long long* step, long long n) {
  cudaGraphSetConditional(handle, (*active && *step < n) ? 1u : 0u);
}

// Nodes of `graph` (a conditional node's body is counted when its capture
// ends), added to `*total`.
cudaError_t count_nodes(cudaGraph_t graph, long long* total) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err == cudaSuccess) *total += static_cast<long long>(n);
  return err;
}

bool on_device(const void* ptr) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, ptr) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return a.type == cudaMemoryTypeDevice;
}

}  // namespace

// The nodes of `graph`, added to `*total`.
extern "C" int sfm_graph_nodes(void* graph, long long* total) {
  return count_nodes(static_cast<cudaGraph_t>(graph), total);
}

// The nodes of `graph` by type, added to `counts[type]` (cudaGraphNodeType,
// below 16); `counts[14]`: copies that touch memory off the device (which a
// conditional body may not hold), `counts[15]`: nodes whose type could not
// be read.
extern "C" int sfm_graph_node_types(void* graph_, long long* counts) {
  cudaGraph_t graph = static_cast<cudaGraph_t>(graph_);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(node, &type) != cudaSuccess || static_cast<int>(type) >= 14) {
      cudaGetLastError();
      counts[15] += 1;
      continue;
    }
    counts[static_cast<int>(type)] += 1;
    if (type == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      if (cudaGraphMemcpyNodeGetParams(node, &p) == cudaSuccess &&
          !(on_device(p.srcPtr.ptr) && on_device(p.dstPtr.ptr))) {
        counts[14] += 1;
      }
      cudaGetLastError();
    }
  }
  return cudaSuccess;
}

// Adds to the graph `stream` is capturing into an IF node on the device bool
// `pred` (read when the graph runs, by a kernel captured just before the
// node), and starts capturing `body_stream` into the node's body: what is
// launched on `body_stream` until sfm_end_capture runs only where `pred` is
// true. The capture of `stream` goes on after the node. Returns a
// cudaError_t.
extern "C" int sfm_capture_if(void* stream_, void* body_stream_, const void* pred) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  if_condition<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream_),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

// Ends the capture sfm_capture_if began on `body_stream`; `*body` receives
// the body's graph (owned by its node).
extern "C" int sfm_end_capture(void* body_stream_, void** body) {
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream_),
                              reinterpret_cast<cudaGraph_t*>(body));
}

// A new non-blocking stream (a branch's capture stream; never destroyed).
extern "C" int sfm_stream_create(void** out) {
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(out), cudaStreamNonBlocking);
}

// Adds to the graph `stream` is capturing into a WHILE node and starts
// capturing `body_stream` into its body: what is launched on `body_stream`
// until sfm_end_while runs once an iteration. `*handle` receives the node's
// condition handle (default 1: the body runs at least once). Returns a
// cudaError_t.
extern "C" int sfm_begin_while(void* stream_, void* body_stream_,
                               unsigned long long* handle_out) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 1, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *handle_out = static_cast<unsigned long long>(handle);
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream_),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

// Ends the body sfm_begin_while began on `body_stream`: a one-thread kernel
// sets the WHILE node's condition to `*active && *step < n`, then the
// capture ends; `*body` receives the body's graph (owned by its node).
extern "C" int sfm_end_while(void* body_stream_, unsigned long long handle, const void* active,
                             const void* step, long long n, void** body) {
  cudaStream_t body_stream = static_cast<cudaStream_t>(body_stream_);
  while_condition<<<1, 1, 0, body_stream>>>(static_cast<cudaGraphConditionalHandle>(handle),
                                            static_cast<const bool*>(active),
                                            static_cast<const long long*>(step), n);
  cudaError_t launch = cudaGetLastError();
  cudaError_t err = cudaStreamEndCapture(body_stream, reinterpret_cast<cudaGraph_t*>(body));
  return launch != cudaSuccess ? launch : err;
}
