// K2: a registry row's step applied n times to a carry, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/opchain.py::op_chain
// (_opchain_kernel): OpSpec.step applied n times in a lax.fori_loop to a
// carry tile, the operand tiles loaded once.
//
// Design: one element per thread; the step is a template parameter (a struct
// with the carry type, the operand count and apply()), so a later row is one
// more struct and one more case in op_chain_launch. The operands are loaded
// once into registers, and the chain is a real loop over n (`#pragma unroll
// 1`), as the fori_loop is. The loop's body is kUnroll steps in a straight
// line, then a remainder loop runs n % kUnroll single steps:
//   kUnroll = 1  : the fori_loop's counterpart; every step pays the loop's
//                  counter add, compare and branch, and a two-length slope
//                  keeps that in the per-step figure;
//   kUnroll = 32 : what the O3 rows of popc and clz time (a chain of
//                  straight-line steps, as every other O3 row and the JAX
//                  package's own O3 rows are); the loop's cost is spread
//                  over 32 steps, and for n a multiple of 32 no remainder
//                  step runs.
// Each step depends on the previous carry through a data-dependent
// instruction (popc, clz, a divide, a multiply, an add), so ptxas cannot
// fold the loop and no `asm volatile` is needed.
//   popc            : __popc(x) ^ a   (uint32; POPC + LOP3)
//   clz             : __clz(x) + a    (uint32; FLO + IADD3)
//   div.u.regular   : x / 8 + a       (uint32; the constant divisor lets
//                                      ptxas shift instead of divide)
//   div.u.irregular : x / 6 + a       (uint32; a constant, not a power of
//                                      2: a high multiply by a magic number)
//   div.u.runtime   : x / a + b       (uint32; the divisor a runtime
//                                      operand: the divide sequence, whose
//                                      reciprocal of a does not depend on x)
//   rem.u           : x % a + b       (uint32; likewise)
//   mul64hi         : (uint32)((uint64)x * a >> 32) | 1
//                                     (the high word of the widening
//                                      multiply; the | 1 keeps the chain
//                                      off the fixed point 0)
//   add             : (x + a) ^ b     (int32, computed unsigned so overflow
//                                      wraps as in the plain version; the
//                                      in-kernel baseline that nets the
//                                      rows' guard op)
//
// Bound on this card: the chain's latency, n x (step + loop share) per element; the
// bytes (carry, operands, out: 4 B each per element) and the operation count
// are far below what the card moves or computes in that time.
#include <cstdint>

#include "common.cuh"

namespace {

struct Popc {
  using T = uint32_t;
  static constexpr int kOperands = 1;
  __device__ __forceinline__ static T apply(T x, T a, T) { return __popc(x) ^ a; }
};

struct Clz {
  using T = uint32_t;
  static constexpr int kOperands = 1;
  __device__ __forceinline__ static T apply(T x, T a, T) {
    return static_cast<T>(__clz(static_cast<int>(x))) + a;
  }
};

struct DivU8 {
  using T = uint32_t;
  static constexpr int kOperands = 1;
  __device__ __forceinline__ static T apply(T x, T a, T) { return x / 8u + a; }
};

struct DivU6 {
  using T = uint32_t;
  static constexpr int kOperands = 1;
  __device__ __forceinline__ static T apply(T x, T a, T) { return x / 6u + a; }
};

struct DivURuntime {
  using T = uint32_t;
  static constexpr int kOperands = 2;
  __device__ __forceinline__ static T apply(T x, T a, T b) { return x / a + b; }
};

struct RemU {
  using T = uint32_t;
  static constexpr int kOperands = 2;
  __device__ __forceinline__ static T apply(T x, T a, T b) { return x % a + b; }
};

struct Mul64Hi {
  using T = uint32_t;
  static constexpr int kOperands = 1;
  __device__ __forceinline__ static T apply(T x, T a, T) {
    return static_cast<T>((static_cast<uint64_t>(x) * a) >> 32) | 1u;
  }
};

struct AddXor {
  using T = int32_t;
  static constexpr int kOperands = 2;
  __device__ __forceinline__ static T apply(T x, T a, T b) {
    return static_cast<T>((static_cast<uint32_t>(x) + static_cast<uint32_t>(a)) ^
                          static_cast<uint32_t>(b));
  }
};

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
  const T av = a[i];
  const T bv = Step::kOperands > 1 ? b[i] : T(0);
  int k = 0;
#pragma unroll 1
  for (; k + kUnroll <= n; k += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c = Step::apply(c, av, bv);
  }
#pragma unroll 1
  for (; k < n; ++k) c = Step::apply(c, av, bv);
  out[i] = c;
}

template <class Step>
int launch(int unroll, const void* x, const void* a, const void* b, void* out,
           long long numel, int n, cudaStream_t stream) {
  using T = typename Step::T;
  constexpr int kThreads = 128;
  const unsigned blocks = static_cast<unsigned>((numel + kThreads - 1) / kThreads);
  const auto* xt = static_cast<const T*>(x);
  const auto* at = static_cast<const T*>(a);
  const auto* bt = static_cast<const T*>(b);
  auto* ot = static_cast<T*>(out);
  switch (unroll) {
    case 1: op_chain_kernel<Step, 1><<<blocks, kThreads, 0, stream>>>(xt, at, bt, ot, numel, n); break;
    case 32: op_chain_kernel<Step, 32><<<blocks, kThreads, 0, stream>>>(xt, at, bt, ot, numel, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Step ids: the index of the step's name in repro_torch.kernels.opchain.STEPS.
enum StepId : int {
  kAdd = 0, kPopc = 1, kClz = 2, kDivU8 = 3, kDivU6 = 4, kDivURuntime = 5, kRemU = 6,
  kMul64Hi = 7
};

}  // namespace

// unroll: the steps in the loop's body, 1 or 32 (repro_torch.kernels.opchain.UNROLLS).
extern "C" int op_chain_launch(int step, int unroll, const void* x, const void* a,
                               const void* b, void* out, long long numel,
                               int n, cudaStream_t stream) {
  switch (step) {
    case kAdd: return launch<AddXor>(unroll, x, a, b, out, numel, n, stream);
    case kPopc: return launch<Popc>(unroll, x, a, b, out, numel, n, stream);
    case kClz: return launch<Clz>(unroll, x, a, b, out, numel, n, stream);
    case kDivU8: return launch<DivU8>(unroll, x, a, b, out, numel, n, stream);
    case kDivU6: return launch<DivU6>(unroll, x, a, b, out, numel, n, stream);
    case kDivURuntime: return launch<DivURuntime>(unroll, x, a, b, out, numel, n, stream);
    case kRemU: return launch<RemU>(unroll, x, a, b, out, numel, n, stream);
    case kMul64Hi: return launch<Mul64Hi>(unroll, x, a, b, out, numel, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
