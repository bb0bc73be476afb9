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

}  // namespace repro
