// K1: the in-kernel dependent ALU chain, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/alu_chain.py::alu_chain
// (_chain_kernel): an n-step dependent chain of one op over an [R, C] f32
// tile, x <- op(x, a), the result stored once.
//
// Design: one element per thread, the op a template parameter, n a runtime
// argument. Each step reads the previous step's result, so the chain is
// serial in every thread and its length shows in the kernel's time; the
// final value is stored, so nothing is dead. The steps are floating point
// and nvcc does not reassociate them, so no two steps fold into one.
//   fma   : fmaf(x, a, a) -> one FFMA per step (one rounding). The plain
//           version, like the JAX kernel on the CPU, computes x*a + a with
//           two roundings; with the tile values the probe uses (a = 0.5) the
//           product is exact and the two agree bit for bit, and elsewhere
//           they differ by at most an ulp a step (tolerance rtol 1e-5).
//   add   : x + a          (FADD)
//   mul   : x * a          (FMUL)
//   rsqrt : rsqrtf(x) + a  (MUFU.RSQ, within 2 ulp of the exact value)
//   exp   : expf(-x) + a   (accurate expf: range reduction + MUFU.EX2)
// `#pragma unroll 8` leaves one loop branch every 8 steps; the two-length
// slope the probe takes cancels everything that does not grow with n.
//
// Bound on this card: a dependent chain is bounded by the op's latency,
// n x latency per element, not by bytes (3 x 4 B per element) or by the
// card's FP32 rate; one tile of 8 x 128 fills 8 blocks of 128 threads.
#include <cstdint>

#include "common.cuh"

namespace {

enum Op : int { kFma = 0, kAdd = 1, kMul = 2, kRsqrt = 3, kExp = 4 };

template <int OP>
__device__ __forceinline__ float step(float x, float a) {
  if (OP == kFma) return fmaf(x, a, a);
  if (OP == kAdd) return x + a;
  if (OP == kMul) return x * a;
  if (OP == kRsqrt) return rsqrtf(x) + a;
  return expf(-x) + a;
}

template <int OP>
__global__ void alu_chain_kernel(const float* __restrict__ x,
                                 const float* __restrict__ a,
                                 float* __restrict__ out, long long numel,
                                 int n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= numel) return;
  float v = x[i];
  const float av = a[i];
#pragma unroll 8
  for (int k = 0; k < n; ++k) v = step<OP>(v, av);
  out[i] = v;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int alu_chain_launch(const float* x, const float* a, float* out,
                                long long numel, int n, int op,
                                cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((numel + kThreads - 1) / kThreads);
  switch (op) {
    case kFma: alu_chain_kernel<kFma><<<blocks, kThreads, 0, stream>>>(x, a, out, numel, n); break;
    case kAdd: alu_chain_kernel<kAdd><<<blocks, kThreads, 0, stream>>>(x, a, out, numel, n); break;
    case kMul: alu_chain_kernel<kMul><<<blocks, kThreads, 0, stream>>>(x, a, out, numel, n); break;
    case kRsqrt: alu_chain_kernel<kRsqrt><<<blocks, kThreads, 0, stream>>>(x, a, out, numel, n); break;
    case kExp: alu_chain_kernel<kExp><<<blocks, kThreads, 0, stream>>>(x, a, out, numel, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
