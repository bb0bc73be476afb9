// K4: RMSNorm over the last dimension, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): out = x * rsqrt(mean(x^2) + eps) * w, computed in
// float32 and cast to the dtype of x (w multiplies in float32 before the
// cast, as the TPU kernel and ref_rmsnorm do; models/common.py's RMSNorm
// casts first, see ROADMAP R4).
//
// Bound on this card: bytes. Each element is read once, squared and summed,
// scaled and written: a few operations per 2 or 4 bytes, far below the ~20
// float32 operations per byte at which the card's arithmetic would be the
// limit.
//
// Design: x is read from device memory once and the output written once,
// both as 16-byte accesses (E = 8 bfloat16 or 4 float32 a lane). A row
// group, a warp (narrow rows, 4 rows to a block) or the whole block (wide
// rows, one row to a block), loads its row into registers, NV accesses a
// thread, together with the same columns of w; sums the squares in float32
// (shuffles, then across warps through shared memory); and scales the
// registers it holds. The wrapper picks the instance (rmsnorm_plan): when
// D is not a multiple of E or a base is not 16-byte aligned, the same
// kernel runs with E = 1 (scalar accesses, the row still in registers);
// a row longer than NV accesses of the largest block (max_threads) keeps
// its first part in registers and reads the rest again in the second pass.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpRowsPerBlock = 4;  // rows a block of the warp-per-row form

// Threads a block may have: 128 in the warp-per-row form; in the block
// form as many as hold 8192 elements in registers (x and w take 2 NV E
// registers a thread), at most 1024.
template <int E, int NV, bool kWarpPerRow>
constexpr int max_threads() {
  return kWarpPerRow ? 32 * kWarpRowsPerBlock
                     : (8192 / (NV * E) < 1024 ? 8192 / (NV * E) : 1024);
}

template <typename T, int E, int NV, bool kWarpPerRow>
__global__ void __launch_bounds__(max_threads<E, NV, kWarpPerRow>())
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               long long rows, int d, float eps) {
  const int nthr = kWarpPerRow ? 32 : static_cast<int>(blockDim.x);
  const int t = kWarpPerRow ? threadIdx.x % 32 : threadIdx.x;
  const long long row = kWarpPerRow
      ? static_cast<long long>(blockIdx.x) * kWarpRowsPerBlock + threadIdx.x / 32
      : static_cast<long long>(blockIdx.x);
  if (kWarpPerRow && row >= rows) return;  // a whole warp leaves together
  const int nvec = d / E;  // E divides d (the wrapper's choice)
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float xv[NV][E], wv[NV][E];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * nthr;
    if (i < nvec) {
      repro::load_vec<E>(xr + i * E, xv[j]);
      repro::load_vec<E>(w + i * E, wv[j]);
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(xv[j][e], xv[j][e], ss);
    }
  }
  for (int i = t + NV * nthr; i < nvec; i += nthr) {  // past the registers
    float tv[E];
    repro::load_vec<E>(xr + i * E, tv);
#pragma unroll
    for (int e = 0; e < E; ++e) ss = fmaf(tv[e], tv[e], ss);
  }
  ss = repro::warp_sum(ss);
  if (!kWarpPerRow) {
    __shared__ float partial[32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    ss = lane < static_cast<int>(blockDim.x / 32) ? partial[lane] : 0.f;
    ss = repro::warp_sum(ss);
  }
  const float rms = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * nthr;
    if (i < nvec) {
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = xv[j][e] * rms * wv[j][e];
      repro::store_vec<E>(orow + i * E, o);
    }
  }
  for (int i = t + NV * nthr; i < nvec; i += nthr) {
    float tv[E], tw[E], o[E];
    repro::load_vec<E>(xr + i * E, tv);
    repro::load_vec<E>(w + i * E, tw);
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = tv[e] * rms * tw[e];
    repro::store_vec<E>(orow + i * E, o);
  }
}

template <typename T, int E, bool kWarpPerRow>
int launch_nv(const T* x, const T* w, T* out, long long rows, int d, float eps, int nv,
              int threads, cudaStream_t stream) {
  const long long blocks = kWarpPerRow ? (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock
                                       : rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
#define REPRO_RMSNORM_NV(NV)                                                       \
  case NV:                                                                         \
    if (threads > max_threads<E, NV, kWarpPerRow>())                               \
      return static_cast<int>(cudaErrorInvalidValue);                              \
    rmsnorm_kernel<T, E, NV, kWarpPerRow><<<grid, threads, 0, stream>>>(x, w, out, \
                                                                       rows, d, eps); \
    break;
  switch (nv) {
    REPRO_RMSNORM_NV(1)
    REPRO_RMSNORM_NV(2)
    REPRO_RMSNORM_NV(4)
    REPRO_RMSNORM_NV(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_RMSNORM_NV
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_form(const void* x, const void* w, void* out, long long rows, int d, float eps,
                int nv, int threads, int warp_per_row, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (d % E) return static_cast<int>(cudaErrorInvalidValue);
  if (warp_per_row) {
    if (threads != 32 * kWarpRowsPerBlock) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nv<T, E, true>(xt, wt, ot, rows, d, eps, nv, threads, stream);
  }
  if (threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_nv<T, E, false>(xt, wt, ot, rows, d, eps, nv, threads, stream);
}

}  // namespace

// x, out: [rows, d] contiguous; w: [d]; all of one dtype (repro::kFloat32 or
// repro::kBFloat16). rows >= 1, d >= 1. vec: elements a thread reads at a
// time, 16 bytes' worth (8 bfloat16, 4 float32; d a multiple of it and
// every base 16-byte aligned) or 1; nv in {1, 2, 4, 8}: accesses a thread
// holds in registers; warp_per_row: a warp per row and 128 threads a block,
// else a block of `threads` (a multiple of 32, at most max_threads) per row.
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* w, void* out,
                              long long rows, int d, float eps, int vec, int nv,
                              int threads, int warp_per_row, cudaStream_t stream) {
  if (dtype == repro::kFloat32) {
    if (vec == 4)
      return launch_form<float, 4>(x, w, out, rows, d, eps, nv, threads, warp_per_row, stream);
    if (vec == 1)
      return launch_form<float, 1>(x, w, out, rows, d, eps, nv, threads, warp_per_row, stream);
  } else if (dtype == repro::kBFloat16) {
    if (vec == 8)
      return launch_form<__nv_bfloat16, 8>(x, w, out, rows, d, eps, nv, threads,
                                          warp_per_row, stream);
    if (vec == 1)
      return launch_form<__nv_bfloat16, 1>(x, w, out, rows, d, eps, nv, threads,
                                          warp_per_row, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
