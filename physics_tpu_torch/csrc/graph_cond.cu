// A two-way branch decided on the device inside one CUDA graph: what the
// JAX package's lax.cond gives its rollout (physics_tpu/solver/contacts.py
// :1117-1157, the hull table path's motion guard), for engine.DeviceStepper.
// Not a TPU kernel: the glue that composes three graphs PyTorch captured
// (torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()) into one:
//
//   the predicate's graph (it writes an int32 flag)
//     → set_conditions: one thread reads the flag and sets two conditional
//       handles, flag ≠ 0 and flag = 0
//     → an if-node on the first, whose body is the true side's graph
//     → an if-node on the second, whose body is the false side's graph
//
// Each graph enters as a child graph node (a copy). A conditional node's
// body may hold kernel (cooperative ones too, without MPS), memcpy,
// memset, child graph and conditional nodes: what a captured step holds.
// Replaying the instantiated graph (gc_launch) runs the predicate and
// exactly one side, with no read back to the host. Needs CUDA 12.4 or
// later (conditional nodes; if-nodes without an else body).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditions(cudaGraphConditionalHandle on_true, cudaGraphConditionalHandle on_false,
                               const int* flag) {
  const unsigned int v = *flag != 0 ? 1u : 0u;
  cudaGraphSetConditional(on_true, v);
  cudaGraphSetConditional(on_false, 1u - v);
}

// an if-node on `handle` after `dep`, whose body runs `child`
cudaError_t add_if(cudaGraph_t g, cudaGraphNode_t dep, cudaGraphConditionalHandle handle, cudaGraph_t child,
                   cudaGraphNode_t* node) {
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  cudaError_t err = cudaGraphAddNode(node, g, &dep, 1, &cp);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t inner;
  return cudaGraphAddChildGraphNode(&inner, cp.conditional.phGraph_out[0], nullptr, 0, child);
}

}  // namespace

// The composed graph and its instance: pred_graph writes *flag (int32 on
// the device), then true_graph runs if it is not 0, else false_graph.
// out[0] the instance (cudaGraphExec_t), out[1] the graph (cudaGraph_t).
extern "C" int gc_compose(void* pred_graph, const int* flag, void* true_graph, void* false_graph, void** out) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaGraphCreate(&g, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t n_pred, n_set, n_true, n_false;
  cudaGraphConditionalHandle h_true, h_false;
  err = cudaGraphAddChildGraphNode(&n_pred, g, nullptr, 0, (cudaGraph_t)pred_graph);
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&h_true, g, 0, 0);
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&h_false, g, 0, 0);
  if (err == cudaSuccess) {
    void* args[] = {&h_true, &h_false, &flag};
    cudaKernelNodeParams kp = {};
    kp.func = (void*)set_conditions;
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&n_set, g, &n_pred, 1, &kp);
  }
  if (err == cudaSuccess) err = add_if(g, n_set, h_true, (cudaGraph_t)true_graph, &n_true);
  if (err == cudaSuccess) err = add_if(g, n_true, h_false, (cudaGraph_t)false_graph, &n_false);
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(g);
    return (int)err;
  }
  out[0] = (void*)exec;
  out[1] = (void*)g;
  return 0;
}

extern "C" int gc_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int gc_destroy(void* exec, void* graph) {
  cudaError_t err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
  return (int)(err != cudaSuccess ? err : e2);
}
