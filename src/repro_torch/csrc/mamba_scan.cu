// K7: the selective scan of Mamba (S6), for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/mamba_scan.py::mamba_scan
// (_scan_kernel): for each batch row and channel, over the time steps t,
//   dt = softplus(dt[t]);  h = exp(dt * A) * h + (dt * x[t]) * B[t];
//   y[t] = h . C[t]
// with the [N] state in float32, starting from 0. x, dt: [Bz,S,Dm]; A:
// [Dm,N]; B, C: [Bz,S,N]; y: [Bz,S,Dm], float32. softplus takes
// jax.nn.softplus's stable form, log1p(exp(-|x|)) + max(x, 0). The y + x * D
// step runs in the wrapper, after the kernel, as the TPU kernel's caller
// does; like the TPU kernel this returns y only, not the final state.
//
// Bound on this card: at a model's widths, bytes (x, dt and y stream once:
// 12 bytes per (t, channel) against ~7 N + 6 float32 operations), but the
// recurrence is serial in t, so a channel's steps form a dependent chain
// and the kernel's time is S steps of latency unless enough channels run
// side by side to hide it.
//
// Design: one thread per (channel, batch row), its N state values and its
// row of A in registers (N a template parameter). B[t] and C[t] are shared
// by every channel of a batch row, so the block stages them through shared
// memory one chunk of time steps at a time; x[t], dt[t] and y[t] are read
// and written coalesced across the block's 64 consecutive channels. The
// chunk only sets the staging: results do not depend on it.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;

template <int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ C, float* __restrict__ y, int s,
                  int dm, int chunk) {
  extern __shared__ float staged[];  // B then C: [chunk][N] each
  float* bs = staged;
  float* cs = staged + chunk * N;
  const int ch = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y;
  const bool live = ch < dm;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[static_cast<long long>(ch) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const long long row0 = static_cast<long long>(b) * s;  // first (b, t) row
  const float* Bb = B + row0 * N;
  const float* Cb = C + row0 * N;

  for (int t0 = 0; t0 < s; t0 += chunk) {
    const int tn = min(chunk, s - t0);
    __syncthreads();  // the previous chunk's B and C are consumed
    for (int i = threadIdx.x; i < tn * N; i += kThreads) {
      bs[i] = Bb[static_cast<long long>(t0) * N + i];
      cs[i] = Cb[static_cast<long long>(t0) * N + i];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int t = 0; t < tn; ++t) {
      const long long idx = (row0 + t0 + t) * dm + ch;
      const float raw = dt[idx];
      const float d = log1pf(expf(-fabsf(raw))) + fmaxf(raw, 0.f);
      const float dx = d * x[idx];
      float yt = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(d * a[n]) * h[n] + dx * bs[t * N + n];
        yt = fmaf(h[n], cs[t * N + n], yt);
      }
      y[idx] = yt;
    }
  }
}

}  // namespace

// x, dt, y: [bz, s, dm]; A: [dm, n]; B, C: [bz, s, n]; all float32 and
// contiguous; n in {4, 8, 16}; 2 * chunk * n * 4 bytes of shared memory
// (at most 48 KB, checked by the wrapper).
extern "C" int mamba_scan_launch(const float* x, const float* dt, const float* A,
                                 const float* B, const float* C, float* y,
                                 int bz, int s, int dm, int n, int chunk,
                                 cudaStream_t stream) {
  const dim3 grid((dm + kThreads - 1) / kThreads, bz);
  const size_t smem = 2 * static_cast<size_t>(chunk) * n * sizeof(float);
  switch (n) {
    case 4:
      mamba_scan_kernel<4><<<grid, kThreads, smem, stream>>>(x, dt, A, B, C, y, s, dm, chunk);
      break;
    case 8:
      mamba_scan_kernel<8><<<grid, kThreads, smem, stream>>>(x, dt, A, B, C, y, s, dm, chunk);
      break;
    case 16:
      mamba_scan_kernel<16><<<grid, kThreads, smem, stream>>>(x, dt, A, B, C, y, s, dm, chunk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
