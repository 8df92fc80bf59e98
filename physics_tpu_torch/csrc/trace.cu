// Stage markers of the step (physics_tpu_torch/tracing.py). Not a TPU
// kernel: the JAX package has none. While tracing is on, each boundary of
// the step launches stage_mark<ID> (ID: the stage's index in
// tracing.STAGES), one thread that does nothing, on the caller's stream.
// Launched while a CUDA graph is captured it becomes a node of the graph,
// so a device trace of a replay, where no Python runs, puts each device
// operation after a marker to that marker's stage. Its cost is the launch
// latency of an empty kernel, once a boundary. tr_graph_nodes counts the
// nodes of a captured graph, for the tests that hold a graph captured with
// tracing off to the nodes of the step alone.

#include <cuda_runtime.h>

namespace {

template <int ID>
__global__ void stage_mark() {}

}  // namespace

// stage_mark<id> on `stream`; cudaErrorInvalidValue for an id outside
// tracing.STAGES.
extern "C" int tr_stage_mark(int id, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
    case 0: stage_mark<0><<<1, 1, 0, s>>>(); break;
    case 1: stage_mark<1><<<1, 1, 0, s>>>(); break;
    case 2: stage_mark<2><<<1, 1, 0, s>>>(); break;
    case 3: stage_mark<3><<<1, 1, 0, s>>>(); break;
    case 4: stage_mark<4><<<1, 1, 0, s>>>(); break;
    case 5: stage_mark<5><<<1, 1, 0, s>>>(); break;
    case 6: stage_mark<6><<<1, 1, 0, s>>>(); break;
    case 7: stage_mark<7><<<1, 1, 0, s>>>(); break;
    case 8: stage_mark<8><<<1, 1, 0, s>>>(); break;
    case 9: stage_mark<9><<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The number of nodes of the graph `graph` (a cudaGraph_t, such as
// torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()) into *count.
extern "C" int tr_graph_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *count = (unsigned long long)n;
  return (int)err;
}
