// The step graph's kernel nodes by IPM phase, host code only (the CUDA
// runtime's graph API). The step is captured with a timing event recorded
// at each phase boundary; the event-record nodes delimit the phases.

#include <cuda_runtime.h>

#include <unordered_map>
#include <vector>

namespace {

bool is_event_in(cudaGraphNode_t node, void* const* events, int n, int* which) {
  cudaGraphNodeType type;
  if (cudaGraphNodeGetType(node, &type) != cudaSuccess || type != cudaGraphNodeTypeEventRecord)
    return false;
  cudaEvent_t ev;
  if (cudaGraphEventRecordNodeGetEvent(node, &ev) != cudaSuccess) return false;
  for (int k = 0; k < n; ++k)
    if (events[k] == static_cast<void*>(ev)) {
      *which = k;
      return true;
    }
  return false;
}

}  // namespace

extern "C" {

// graph: a cudaGraph_t; events: the n cudaEvent_t of the phase marks, in
// the order recorded. out[0] gets the kernel nodes that no mark precedes,
// out[k + 1] those after mark k and before the next. A node's phase is the
// latest mark among its ancestors (the nodes are taken in dependency
// order), so a graph captured on one stream counts as its stream ran.
int clrs_graph_phase_nodes(void* graph, void* const* events, int n, long long* out) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  for (int k = 0; k <= n; ++k) out[k] = 0;
  size_t nn = 0, ne = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &nn);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> nodes(nn);
  if (nn && (e = cudaGraphGetNodes(g, nodes.data(), &nn)) != cudaSuccess) return e;
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &ne);
#else
  e = cudaGraphGetEdges(g, nullptr, nullptr, &ne);
#endif
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> from(ne), to(ne);
  if (ne) {
#if CUDART_VERSION >= 13000
    e = cudaGraphGetEdges(g, from.data(), to.data(), nullptr, &ne);
#else
    e = cudaGraphGetEdges(g, from.data(), to.data(), &ne);
#endif
    if (e != cudaSuccess) return e;
  }
  std::unordered_map<cudaGraphNode_t, size_t> index;
  index.reserve(nn);
  for (size_t i = 0; i < nn; ++i) index[nodes[i]] = i;
  std::vector<std::vector<size_t>> succ(nn);
  std::vector<size_t> indeg(nn, 0);
  for (size_t i = 0; i < ne; ++i) {
    const size_t a = index.at(from[i]), b = index.at(to[i]);
    succ[a].push_back(b);
    ++indeg[b];
  }
  std::vector<int> phase(nn, 0);
  std::vector<size_t> ready;
  for (size_t i = 0; i < nn; ++i)
    if (!indeg[i]) ready.push_back(i);
  // Kahn's order; ready is a stack, which keeps a chain's order
  while (!ready.empty()) {
    const size_t i = ready.back();
    ready.pop_back();
    cudaGraphNodeType type;
    if ((e = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess) return e;
    int k = 0;
    if (is_event_in(nodes[i], events, n, &k)) {
      if (k + 1 > phase[i]) phase[i] = k + 1;
    } else if (type == cudaGraphNodeTypeKernel) {
      ++out[phase[i]];
    }
    for (const size_t j : succ[i]) {
      if (phase[i] > phase[j]) phase[j] = phase[i];
      if (!--indeg[j]) ready.push_back(j);
    }
  }
  return cudaSuccess;
}

}  // extern "C"
