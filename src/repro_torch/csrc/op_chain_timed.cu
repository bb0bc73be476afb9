// K2's timed form, for Hopper (sm_90a): the paper's clock sandwich around a
// registry row's chain (op_chain.cu has the loop form and the design).
//
// On K1's pattern (alu_chain.cu): each thread reads %clock64 once its carry
// and operands have landed, runs the chain, reads %clock64 again once the
// chain's result exists, and stores the result and the difference in SM
// cycles. Each read is predicated on a test of the values it must follow
// (a compare of their bits with a value that never occurs: a float32 NaN
// payload, or a 16-bit pattern for the 16-bit rows, whose zero-extended bits
// could never equal the 32-bit one and would make the test constant), so
// neither runs before they exist. At n 8 and 64 (the in-kernel plan's
// lengths) the chain is straight-line, an instance per length, so a
// two-length slope holds the steps and no loop cost; any other n runs a
// loop of single steps.
//
// Between two steps the carry passes through an empty asm, which emits
// nothing: nvcc must take each step as written and cannot merge steps
// where two steps simplify, as LLVM does in the table2 plan's O3 chains
// (not: ~(~x + a) + a == x; mul24's masks drop out and x*A*A... becomes a
// power by squaring). The asm does not reach ptxas, which still folds bfi,
// idempotent in its own right ((x & M) | c twice is (x & M) | c):
// chip_smoke.py shows its SASS.
//
// Bound on this card: the chain's latency, n x step per element; the bytes
// (carry, operands, out, 8 B of cycles per element) and the operation
// count are far below what the card moves or computes in that time.
#include "op_chain_steps.cuh"

namespace {

using namespace k2;

// The bits a clock read waits for: 32 of a 32-bit value, 16 of a 16-bit one.
__device__ __forceinline__ uint32_t bits(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t bits(int32_t v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned short bits(__half v) { return __half_as_ushort(v); }
__device__ __forceinline__ unsigned short bits(bf16 v) { return __bfloat16_as_ushort(v); }

// The carry through an empty asm: no instruction, but nvcc no longer knows
// the value, so no step is merged with the next; given t, the carry also
// seems to depend on t (the first clock read).
__device__ __forceinline__ void opaque(uint32_t& v, long long t = 0) {
  asm volatile("" : "+r"(v) : "l"(t));
}
__device__ __forceinline__ void opaque(int32_t& v, long long t = 0) {
  asm volatile("" : "+r"(v) : "l"(t));
}
__device__ __forceinline__ void opaque(float& v, long long t = 0) {
  asm volatile("" : "+f"(v) : "l"(t));
}
__device__ __forceinline__ void opaque(__half& v, long long t = 0) {
  unsigned short s = __half_as_ushort(v);
  asm volatile("" : "+h"(s) : "l"(t));
  v = __ushort_as_half(s);
}
__device__ __forceinline__ void opaque(bf16& v, long long t = 0) {
  unsigned short s = __bfloat16_as_ushort(v);
  asm volatile("" : "+h"(s) : "l"(t));
  v = __ushort_as_bfloat16(s);
}

// %clock64, read once `b` has been produced: the read is predicated on a
// test of b, true for every value but one, for which an unpredicated read
// stands in (alu_chain.cu's clock_after).
__device__ __forceinline__ long long clock_after(uint32_t b) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %1, 0x7fc00001;\n\t"
      "mov.u64 %0, %%clock64;\n\t"
      "@p mov.u64 %0, %%clock64;\n\t}"
      : "=&l"(t) : "r"(b) : "memory");
  return t;
}
__device__ __forceinline__ long long clock_after(unsigned short b) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b16 p, %1, 0x7e01;\n\t"
      "mov.u64 %0, %%clock64;\n\t"
      "@p mov.u64 %0, %%clock64;\n\t}"
      : "=&l"(t) : "h"(b) : "memory");
  return t;
}

// N > 0: exactly N steps, straight-line (the caller passes n == N);
// N == 0: n steps in a loop.
template <class Step, int N>
__global__ void op_chain_timed_kernel(const typename Step::T* __restrict__ x,
                                      const typename Step::T* __restrict__ a,
                                      const typename Step::T* __restrict__ b,
                                      typename Step::T* __restrict__ out,
                                      long long* __restrict__ cycles,
                                      long long numel, int n) {
  using T = typename Step::T;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= numel) return;
  T c = x[i];
  const T av = Step::kOperands > 0 ? a[i] : c;
  const T bv = Step::kOperands > 1 ? b[i] : c;
  auto landed = bits(c);
  if (Step::kOperands > 0) landed ^= bits(av);
  if (Step::kOperands > 1) landed ^= bits(bv);
  const long long t0 = clock_after(landed);
  opaque(c, t0);
  if constexpr (N > 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      c = Step::apply(c, av, bv);
      opaque(c);
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      c = Step::apply(c, av, bv);
      opaque(c);
    }
  }
  cycles[i] = clock_after(bits(c)) - t0;
  out[i] = c;
}

template <class Step>
int launch_timed(const void* x, const void* a, const void* b, void* out,
                 long long* cycles, long long numel, int n, cudaStream_t stream) {
  using T = typename Step::T;
  const auto* xt = static_cast<const T*>(x);
  const auto* at = static_cast<const T*>(a);
  const auto* bt = static_cast<const T*>(b);
  auto* ot = static_cast<T*>(out);
  const unsigned blocks = blocks_for(numel);
  if (n == 8)
    op_chain_timed_kernel<Step, 8><<<blocks, kThreads, 0, stream>>>(xt, at, bt, ot, cycles, numel, n);
  else if (n == 64)
    op_chain_timed_kernel<Step, 64><<<blocks, kThreads, 0, stream>>>(xt, at, bt, ot, cycles, numel, n);
  else
    op_chain_timed_kernel<Step, 0><<<blocks, kThreads, 0, stream>>>(xt, at, bt, ot, cycles, numel, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out as op_chain_launch gives it, and cycles[i] the SM cycles between
// element i's two clock reads. step: as op_chain_launch's.
extern "C" int op_chain_timed_launch(int step, const void* x, const void* a,
                                     const void* b, void* out, long long* cycles,
                                     long long numel, int n, cudaStream_t stream) {
  switch (step) {
#define K2_CASE(S) case k##S: return launch_timed<S>(x, a, b, out, cycles, numel, n, stream);
    K2_STEPS(K2_CASE)
#undef K2_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
