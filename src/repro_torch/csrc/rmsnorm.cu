// K4: RMSNorm over the last dimension, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): out = x * rsqrt(mean(x^2) + eps) * w, computed in
// float32 and cast to the dtype of x (w multiplies in float32 before the
// cast, as the TPU kernel and ref_rmsnorm do; models/common.py's RMSNorm
// casts first, see ROADMAP R4).
//
// Bound on this card: bytes. Each element is read, squared and summed,
// then read again, scaled and written: a few operations per 2 or 4 bytes,
// far below the ~20 float32 operations per byte at which the card's
// arithmetic would be the limit.
//
// Design: one thread block per row (the TPU kernel's 256-row blocks were
// sized for VMEM; here a row is the unit of parallel work, and a model's
// row count fills the 132 SMs). Each thread sums the squares of a strided
// slice of the row in float32, the warps reduce with shuffles and then
// across warps through shared memory; the second pass re-reads the row
// (from L1/L2: a 4096-wide bf16 row is 8 KB) and writes the output. Any D.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  __shared__ float partial[kMaxThreads / 32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* orow = out + static_cast<long long>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = repro::load_f32(xr + i);
    ss = fmaf(v, v, ss);
  }
  ss = repro::warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < static_cast<int>(blockDim.x / 32) ? partial[lane] : 0.f;
    ss = repro::warp_sum(ss);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float rms = rsqrtf(partial[0] / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    repro::store_f32(orow + i, repro::load_f32(xr + i) * rms * repro::load_f32(w + i));
  }
}

}  // namespace

// x, out: [rows, d] contiguous; w: [d]; all of one dtype (repro::kFloat32 or
// repro::kBFloat16). rows >= 1, d >= 1.
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* w, void* out,
                              long long rows, int d, float eps,
                              cudaStream_t stream) {
  int threads = ((d + 31) / 32) * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const dim3 grid(static_cast<unsigned>(rows));
  if (dtype == repro::kFloat32) {
    rmsnorm_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, eps);
  } else if (dtype == repro::kBFloat16) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
