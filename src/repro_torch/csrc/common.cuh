// Shared by every kernel library of repro_torch. Each .cu file builds into a
// shared library of its own with a plain C interface, loaded with ctypes
// (repro_torch/kernels/_build.py). A launch function returns
// cudaGetLastError() right after the launch, so a launch the driver refused
// (too many threads, too much shared memory) reaches the Python wrapper as a
// non-zero code instead of vanishing.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace repro {

// The wrappers' dtype codes (repro_torch/kernels/common.py DTYPE_CODES).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (MUFU.EX2, relative error about 2^-22; exact 0 for
// x <= -126, so a masked logit's weight is exactly 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sum / max over aligned groups of W lanes (W a power of two <= 32). Every
// lane of the warp must take part: the shuffles name the full mask.
template <int W = 32>
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int W = 32>
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Loads widen to float32, stores round to nearest even (as torch's .to()).
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// E consecutive elements widened to float32. When E elements are 16 bytes
// (4 float32, 8 bfloat16) it is one 128-bit access, and p must be 16-byte
// aligned; 2 float32 are one 64-bit access (p 8-byte aligned); any other E
// is E scalar accesses.
template <int E>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[E]) {
  if constexpr (E == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = p[e];
  }
}

template <int E>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[E]) {
  if constexpr (E == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __bfloat162float(p[e]);
  }
}

template <int E>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[E]) {
  if constexpr (E == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = v[e];
  }
}

template <int E>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[E]) {
  if constexpr (E == 8) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

// cp.async of 16 bytes from device to shared memory (both 16-byte aligned),
// bypassing L1; with src_bytes 0 it reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
// The same for 4 bytes (any 4-byte aligned address), through L1.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace repro
