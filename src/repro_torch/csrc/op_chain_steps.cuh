// K2's steps, shared by its two forms (op_chain.cu, the loop form, and
// op_chain_timed.cu, the timed form): one struct a registry row, with the
// carry type T, the operand count and apply(x, a, b), named after its row
// (add.float32 -> AddFloat32). There is a step for each of the 58 rows that
// can run inside a kernel (repro_torch.inkernel.supported_specs()), and for
// mul64hi, a table2 row.
//
// What a step computes is what the registry row's step computes
// (repro/core/chains.py), in the row's dtype:
//   int32 rows wrap on overflow: they compute in uint32 and cast back;
//     div.s.* and rem.s truncate (C's / and %, as lax.div and lax.rem);
//     shl, shr and bfe shift by PTX shl.b32 / shr.s32, which clamp a shift
//     amount of 32 or more (as unsigned) to 32, as lax's shifts do;
//     abs and sad take |x - a| of the wrapped difference (abs(INT_MIN) ==
//     INT_MIN, as jnp.abs).
//   uint32 rows: popc, clz, the divides by 8, 6 and a runtime divisor,
//     rem.u, and mul64hi's high word of the 64-bit product (| 1).
//   float32 rows round every op as IEEE does (nvcc's default -prec-div and
//     -prec-sqrt), as eager jnp does op by op: div.* and rcp are true
//     divides (x / 3 too, which XLA's compiled chain takes as
//     fma(x, 1/3, a)), sqrt a true square root. fma.float32 is fmaf, one
//     FFMA, one rounding as in XLA's compiled chain (eager x*a + b rounds
//     twice; the product x * 0.5 of the row's inputs is exact, so all
//     agree). min and max carry a NaN through, as jnp.minimum and
//     jnp.maximum (and torch.minimum) do: PTX min.NaN.f32 / max.NaN.f32
//     (fminf / fmaxf would return the other operand), and order -0 below +0.
//   bfloat16 and float16 rows run their dtype's own instructions (HADD2,
//     HMUL2, HMNMX2 ... .BF16_V2 for bfloat16), each op rounded, as eager
//     and jax.jit round every op; fma is __hmul_rn then __hadd_rn, two
//     roundings like eager x*a + b (plain __hmul/__hadd would be contracted
//     into one HFMA2; XLA's compiled float16 chain rounds once); min and
//     max are __hmin_nan / __hmax_nan, which carry a NaN through as the
//     float32 rows' do.
//   special math: the accurate CUDA functions (1.0f / x, sqrtf, rsqrtf,
//     sinf, cosf, log2f, exp2f, tanhf, copysignf), never the __sinf-style
//     intrinsics: what jnp.sin and the rest compute, to an ulp or two.
#pragma once
#include <cstdint>

#include <cuda_fp16.h>

#include "common.cuh"

namespace k2 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ int32_t wrap(uint32_t v) { return static_cast<int32_t>(v); }
__device__ __forceinline__ uint32_t u(int32_t v) { return static_cast<uint32_t>(v); }

// PTX shifts: a shift amount of 32 or more (as unsigned) gives 0 for shl and
// the sign for shr.s32, as lax.shift_left / shift_right_arithmetic do.
__device__ __forceinline__ int32_t shl(int32_t x, int32_t s) {
  int32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}
__device__ __forceinline__ int32_t shr(int32_t x, int32_t s) {
  int32_t r;
  asm("shr.s32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}
// min and max that return NaN if either operand is NaN (PTX .NaN)
__device__ __forceinline__ float min_nan(float x, float a) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(a));
  return r;
}
__device__ __forceinline__ float max_nan(float x, float a) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(a));
  return r;
}
// |d| of the wrapped difference d, as jnp.abs of an int32 (INT_MIN stays)
__device__ __forceinline__ uint32_t abs_wrapped(uint32_t d) {
  return static_cast<int32_t>(d) < 0 ? 0u - d : d;
}

#define STEP(Name, Type, Operands, ...)                                        \
  struct Name {                                                                \
    using T = Type;                                                            \
    static constexpr int kOperands = Operands;                                 \
    __device__ __forceinline__ static T apply(T x, T a, T b) { __VA_ARGS__; } \
  };

// int_arith, int32 (guarded as the registry's rows are)
STEP(Add, int32_t, 2, return wrap((u(x) + u(a)) ^ u(b)))
STEP(Sub, int32_t, 2, return wrap((u(x) - u(a)) ^ u(b)))
STEP(Mul, int32_t, 2, return wrap((u(x) * u(a)) ^ u(b)))
STEP(Mad, int32_t, 2, return wrap((u(x) * u(a) + u(b)) ^ u(a)))
STEP(Min, int32_t, 2, return wrap(u(min(x, a)) + u(b)))
STEP(Max, int32_t, 2, return wrap(u(max(x, a)) - u(b)))
STEP(Abs, int32_t, 1, return wrap(abs_wrapped(u(x) - u(a))))
STEP(DivSRegular, int32_t, 1, return wrap(u(x / 4) + u(a)))
STEP(DivSIrregular, int32_t, 1, return wrap(u(x / 5) + u(a)))
STEP(DivSRuntime, int32_t, 2, return wrap(u(x / a) + u(b)))
STEP(RemS, int32_t, 2, return wrap(u(x % a) + u(b)))
// int_arith, uint32: the divisor a compile-time constant (8: a shift; 6: a
// high multiply by a magic number) or a runtime operand (the divide
// sequence, whose reciprocal of a does not depend on x)
STEP(DivURegular, uint32_t, 1, return x / 8u + a)
STEP(DivUIrregular, uint32_t, 1, return x / 6u + a)
STEP(DivURuntime, uint32_t, 2, return x / a + b)
STEP(RemU, uint32_t, 2, return x % a + b)
// logic_shift, int32
STEP(And, int32_t, 2, return wrap(u(x & a) + u(b)))
STEP(Or, int32_t, 2, return wrap(u(x | a) + u(b)))
STEP(Xor, int32_t, 2, return wrap(u(x ^ a) + u(b)))
STEP(Not, int32_t, 1, return wrap(~u(x) + u(a)))
STEP(Cnot, int32_t, 1, return wrap(static_cast<uint32_t>(x == 0) + u(a)))
STEP(Shl, int32_t, 2, return shl(x, a) | b)
STEP(Shr, int32_t, 1, return shr(x, a) | a)
// fp32
STEP(AddFloat32, float, 1, return x + a)
STEP(SubFloat32, float, 1, return x - a)
STEP(MulFloat32, float, 1, return x * a)
STEP(FmaFloat32, float, 2, return fmaf(x, a, b))
STEP(MinFloat32, float, 2, return min_nan(x, a) + b)
STEP(MaxFloat32, float, 2, return max_nan(x, a) - b)
STEP(DivRegularFloat32, float, 1, return x / 4.0f + a)
STEP(DivIrregularFloat32, float, 1, return x / 3.0f + a)
STEP(DivRuntimeFloat32, float, 2, return x / a + b)
// fp16: bfloat16, then float16
STEP(AddBfloat16, bf16, 1, return __hadd(x, a))
STEP(SubBfloat16, bf16, 1, return __hsub(x, a))
STEP(MulBfloat16, bf16, 1, return __hmul(x, a))
STEP(FmaBfloat16, bf16, 2, return __hadd_rn(__hmul_rn(x, a), b))
STEP(MinBfloat16, bf16, 2, return __hadd(__hmin_nan(x, a), b))
STEP(MaxBfloat16, bf16, 2, return __hsub(__hmax_nan(x, a), b))
STEP(AddFloat16, __half, 1, return __hadd(x, a))
STEP(SubFloat16, __half, 1, return __hsub(x, a))
STEP(MulFloat16, __half, 1, return __hmul(x, a))
STEP(FmaFloat16, __half, 2, return __hadd_rn(__hmul_rn(x, a), b))
STEP(MinFloat16, __half, 2, return __hadd(__hmin_nan(x, a), b))
STEP(MaxFloat16, __half, 2, return __hsub(__hmax_nan(x, a), b))
// multi_precision: the high word of the widening multiply (the | 1 keeps
// the chain off the fixed point 0); its row needs a 64-bit product, so it
// is a table2 row only
STEP(Mul64hi, uint32_t, 1, return static_cast<uint32_t>((static_cast<uint64_t>(x) * a) >> 32) | 1u)
// special_math, float32
STEP(Rcp, float, 1, return 1.0f / x + a)
STEP(Sqrt, float, 1, return sqrtf(x) + a)
STEP(Rsqrt, float, 1, return rsqrtf(x) + a)
STEP(Sin, float, 1, return sinf(x) + a)
STEP(Cos, float, 0, return cosf(x))
STEP(Lg2, float, 1, return log2f(x + a))
STEP(Ex2, float, 1, return exp2f(x) - a)
STEP(Tanh, float, 1, return tanhf(x) + a)
STEP(Copysign, float, 2, return copysignf(x, a) + b)
// int_intrinsic
STEP(Sad, int32_t, 2, return wrap(abs_wrapped(u(x) - u(a)) + u(b)))
STEP(Popc, uint32_t, 1, return static_cast<uint32_t>(__popc(x)) ^ a)
STEP(Clz, uint32_t, 1, return static_cast<uint32_t>(__clz(static_cast<int>(x))) + a)
STEP(Bfe, int32_t, 2, return wrap(u(shr(x, a) & 0xFFFF) + u(b)))
STEP(Bfi, int32_t, 2, return (x & ~0xFF) | (a & 0xFF) | b)
STEP(Mul24, int32_t, 1, return wrap((u(x & 0xFFFFFF) * u(a & 0xFFFFFF)) & 0x7FFFFFFFu))
#undef STEP

// Every step, in the order of repro_torch.kernels.opchain.STEPS: the index
// is the step id the launch functions take. The first eight are the steps
// of the table2 plan's kernel rows (and add, the in-kernel baseline).
#define K2_STEPS(X)                                                                   \
  X(Add) X(Popc) X(Clz) X(DivURegular) X(DivUIrregular) X(DivURuntime) X(RemU)        \
  X(Mul64hi) X(Sub) X(Mul) X(Mad) X(Min) X(Max) X(Abs) X(DivSRegular)                 \
  X(DivSIrregular) X(DivSRuntime) X(RemS) X(And) X(Or) X(Xor) X(Not) X(Cnot) X(Shl)   \
  X(Shr) X(AddFloat32) X(SubFloat32) X(MulFloat32) X(FmaFloat32) X(MinFloat32)        \
  X(MaxFloat32) X(DivRegularFloat32) X(DivIrregularFloat32) X(DivRuntimeFloat32)      \
  X(AddBfloat16) X(SubBfloat16) X(MulBfloat16) X(FmaBfloat16) X(MinBfloat16)          \
  X(MaxBfloat16) X(AddFloat16) X(SubFloat16) X(MulFloat16) X(FmaFloat16)              \
  X(MinFloat16) X(MaxFloat16) X(Rcp) X(Sqrt) X(Rsqrt) X(Sin) X(Cos) X(Lg2) X(Ex2)     \
  X(Tanh) X(Copysign) X(Sad) X(Bfe) X(Bfi) X(Mul24)

#define K2_ID(S) k##S,
enum StepId : int { K2_STEPS(K2_ID) kSteps };
#undef K2_ID

constexpr int kThreads = 128;

inline unsigned blocks_for(long long numel) {
  return static_cast<unsigned>((numel + kThreads - 1) / kThreads);
}

}  // namespace k2
