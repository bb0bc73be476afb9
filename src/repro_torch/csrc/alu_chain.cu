// K1: the in-kernel dependent ALU chain, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/alu_chain.py::alu_chain
// (_chain_kernel): an n-step dependent chain of one op over an [R, C] f32
// tile, x <- op(x, a), the result stored once.
//
// Design: one element per thread, the op a template parameter. Each step
// reads the previous step's result, so the chain is serial in every thread
// and its length shows in the kernel's time; the final value is stored, so
// nothing is dead. The steps are floating point and nvcc does not
// reassociate them, so no two steps fold into one.
//   fma   : fmaf(x, a, a) -> one FFMA per step (one rounding). The plain
//           version, like the JAX kernel on the CPU, computes x*a + a with
//           two roundings; with the tile values the probe uses (a = 0.5) the
//           product is exact and the two agree bit for bit, and elsewhere
//           they differ by at most an ulp a step (tolerance rtol 1e-5).
//   add   : x + a          (FADD)
//   mul   : x * a          (FMUL)
//   rsqrt : rsqrtf(x) + a  (MUFU.RSQ, within 2 ulp of the exact value)
//   exp   : expf(-x) + a   (accurate expf: range reduction + MUFU.EX2)
// At the lengths the probe takes its slope at (8 and 64, KernelProbe's
// default) the chain is straight-line: an instance per length, with no
// loop, so the slope holds the op's latency and nothing else. Any other n
// runs a loop unrolled 8 times, whose compare and branch add to every 8
// steps.
//
// Bound on this card: a dependent chain is bounded by the op's latency,
// n x latency per element, not by bytes (3 x 4 B per element) or by the
// card's FP32 rate; one tile of 8 x 128 fills 8 blocks of 128 threads.
//
// Given a `cycles` array, the kernel runs its timed form, the paper's clock
// sandwich: each thread reads %clock64 once its x and a have landed, runs
// the chain, and reads %clock64 again once the chain's result exists, then
// stores the result and the difference in SM cycles. Each read is
// predicated on a test of the values it must follow (the loads, then the
// chain's result); the test is true for every value but one NaN payload
// (0x7fc00001), for which an unpredicated read stands in. In the SASS,
// ptxas turns the pair into two CS2R reads and a select, placed right after
// the ISETP of the test; a warp executes in order and the ISETP waits for
// its operand, so neither read runs before the value exists (chip_smoke.py
// checks that the reads bracket the 64 FFMAs of the fma chain at n 64, with
// no branch between them). Timed and untimed forms share the chain.
//
// sm_clock_launch samples the SM clock: %clock64 and %globaltimer (ns) at
// both ends of a spin of spin_ns on one thread.
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

// %clock64, read once `bits` has been produced (see the file's note).
__device__ __forceinline__ long long clock_after(unsigned bits) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %1, 0x7fc00001;\n\t"
      "mov.u64 %0, %%clock64;\n\t"
      "@p mov.u64 %0, %%clock64;\n\t}"
      : "=&l"(t) : "r"(bits) : "memory");
  return t;
}

// N > 0: exactly N steps, straight-line (the caller passes n == N);
// N == 0: n steps in a loop.
template <int OP, int N>
__device__ __forceinline__ float chain(float v, float av, int n) {
  if constexpr (N > 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) v = step<OP>(v, av);
  } else {
#pragma unroll 8
    for (int k = 0; k < n; ++k) v = step<OP>(v, av);
  }
  return v;
}

template <int OP, int N, bool TIMED>
__global__ void alu_chain_kernel(const float* __restrict__ x,
                                 const float* __restrict__ a,
                                 float* __restrict__ out,
                                 long long* __restrict__ cycles,
                                 long long numel, int n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= numel) return;
  float v = x[i];
  const float av = a[i];
  long long t0 = 0;
  if constexpr (TIMED) t0 = clock_after(__float_as_uint(v) ^ __float_as_uint(av));
  v = chain<OP, N>(v, av, n);
  if constexpr (TIMED) cycles[i] = clock_after(__float_as_uint(v)) - t0;
  out[i] = v;
}

__global__ void sm_clock_kernel(long long* out, long long spin_ns) {
  long long g0, g1, c0, c1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0) :: "memory");
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0) :: "memory");
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1) :: "memory");
  } while (g1 - g0 < spin_ns);
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1) :: "memory");
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1) :: "memory");
  out[0] = c1 - c0;
  out[1] = g1 - g0;
}

constexpr int kThreads = 128;

template <int OP, int N>
void launch_len(const float* x, const float* a, float* out, long long* cycles,
                long long numel, int n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((numel + kThreads - 1) / kThreads);
  if (cycles)
    alu_chain_kernel<OP, N, true><<<blocks, kThreads, 0, stream>>>(x, a, out, cycles, numel, n);
  else
    alu_chain_kernel<OP, N, false><<<blocks, kThreads, 0, stream>>>(x, a, out, cycles, numel, n);
}

template <int OP>
void launch_op(const float* x, const float* a, float* out, long long* cycles,
               long long numel, int n, cudaStream_t stream) {
  if (n == 8) launch_len<OP, 8>(x, a, out, cycles, numel, n, stream);
  else if (n == 64) launch_len<OP, 64>(x, a, out, cycles, numel, n, stream);
  else launch_len<OP, 0>(x, a, out, cycles, numel, n, stream);
}

}  // namespace

// out <- op applied n times to x with operand a; with a non-null `cycles`,
// the timed form, and cycles[i] gets the SM cycles of element i's chain.
extern "C" int alu_chain_launch(const float* x, const float* a, float* out,
                                long long* cycles, long long numel, int n, int op,
                                cudaStream_t stream) {
  switch (op) {
    case kFma: launch_op<kFma>(x, a, out, cycles, numel, n, stream); break;
    case kAdd: launch_op<kAdd>(x, a, out, cycles, numel, n, stream); break;
    case kMul: launch_op<kMul>(x, a, out, cycles, numel, n, stream); break;
    case kRsqrt: launch_op<kRsqrt>(x, a, out, cycles, numel, n, stream); break;
    case kExp: launch_op<kExp>(x, a, out, cycles, numel, n, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0] = SM cycles and out[1] = globaltimer ns over one spin of spin_ns,
// on one thread.
extern "C" int sm_clock_launch(long long* out, long long spin_ns,
                               cudaStream_t stream) {
  sm_clock_kernel<<<1, 1, 0, stream>>>(out, spin_ns);
  return static_cast<int>(cudaGetLastError());
}
