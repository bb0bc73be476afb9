// K2: a registry row's step applied n times to a carry, for Hopper (sm_90a);
// this file is its loop form, op_chain_timed.cu its timed form.
//
// Replaces the Pallas kernel repro/kernels/opchain.py::op_chain
// (_opchain_kernel): OpSpec.step applied n times in a lax.fori_loop to a
// carry tile, the operand tiles loaded once.
//
// Design: one element per thread, 128-thread blocks (the reference's (8, 128)
// tile is 8 blocks, its (16, 128) tile of a 16-bit type 16). The step is a
// template parameter, one struct a registry row (op_chain_steps.cuh). The
// operands are loaded once into registers. The two forms are two sources,
// each its own library, so that their nvcc runs in parallel (the timed
// form's 58 x 3 straight-line and loop instances made one source the
// build's longest).
//
// The loop form is a real loop over n (`#pragma unroll 1`), as the
// fori_loop is. Its body is kUnroll steps in a straight line, then a
// remainder loop runs n % kUnroll single steps:
//   kUnroll = 1  : the fori_loop's counterpart; every step pays the loop's
//                  counter add, compare and branch;
//   kUnroll = 32 : what the table2 plan's O3 rows of popc, clz, the uint32
//                  divides and mul64hi time; the loop's cost is spread over
//                  32 steps.
// Each step depends on the previous carry. The compiler may merge steps
// that simplify together (not, bfi, mul24; see op_chain_timed.cu); the
// table2 rows that run here do not.
//
// Bound on this card: the chain's latency, n x (step + loop share) per
// element; the bytes (carry, operands, out) and the operation count are far
// below what the card moves or computes in that time.
#include "op_chain_steps.cuh"

namespace {

using namespace k2;

template <class Step, int kUnroll>
__global__ void op_chain_kernel(const typename Step::T* __restrict__ x,
                                const typename Step::T* __restrict__ a,
                                const typename Step::T* __restrict__ b,
                                typename Step::T* __restrict__ out,
                                long long numel, int n) {
  using T = typename Step::T;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= numel) return;
  T c = x[i];
  const T av = Step::kOperands > 0 ? a[i] : c;
  const T bv = Step::kOperands > 1 ? b[i] : c;
  int k = 0;
#pragma unroll 1
  for (; k + kUnroll <= n; k += kUnroll) {
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) c = Step::apply(c, av, bv);
  }
#pragma unroll 1
  for (; k < n; ++k) c = Step::apply(c, av, bv);
  out[i] = c;
}

template <class Step>
int launch(int unroll, const void* x, const void* a, const void* b, void* out,
           long long numel, int n, cudaStream_t stream) {
  using T = typename Step::T;
  const auto* xt = static_cast<const T*>(x);
  const auto* at = static_cast<const T*>(a);
  const auto* bt = static_cast<const T*>(b);
  auto* ot = static_cast<T*>(out);
  const unsigned blocks = blocks_for(numel);
  switch (unroll) {
    case 1: op_chain_kernel<Step, 1><<<blocks, kThreads, 0, stream>>>(xt, at, bt, ot, numel, n); break;
    case 32: op_chain_kernel<Step, 32><<<blocks, kThreads, 0, stream>>>(xt, at, bt, ot, numel, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// unroll: the steps in the loop's body, 1 or 32
// (repro_torch.kernels.opchain.UNROLLS). step: the index of the step's name
// in repro_torch.kernels.opchain.STEPS. A step reads a only if it has an
// operand and b only if it has two.
extern "C" int op_chain_launch(int step, int unroll, const void* x, const void* a,
                               const void* b, void* out, long long numel,
                               int n, cudaStream_t stream) {
  switch (step) {
#define K2_CASE(S) case k##S: return launch<S>(unroll, x, a, b, out, numel, n, stream);
    K2_STEPS(K2_CASE)
#undef K2_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
