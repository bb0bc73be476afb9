// K7: the selective scan of Mamba (S6), for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/mamba_scan.py::mamba_scan
// (_scan_kernel): for each batch row and channel, over the time steps t,
//   dt = softplus(dt[t]);  h = exp(dt * A) * h + (dt * x[t]) * B[t];
//   y[t] = h . C[t] + x[t] * D
// with the [N] state in float32, starting from 0. x, dt: [Bz,S,Dm]; A:
// [Dm,N]; B, C: [Bz,S,N]; D: [Dm]; y: [Bz,S,Dm], float32. softplus takes
// jax.nn.softplus's stable form, log1p(exp(-|x|)) + max(x, 0). The TPU
// kernel's caller adds x * D after it; here the store does it, one fmaf.
// On request the kernel also stores the final state h [Bz,Dm,N], which the
// TPU kernel does not return (ref_selective_scan's h_final).
//
// Bound on this card: at a model's widths the bytes (x, dt and y stream
// once: 12 bytes a (t, channel)), 0.060 ms at Jamba (Dm 8192, N 16,
// S 2048). This kernel takes its exponentials, one a (t, channel, state),
// on the SFU (MUFU.EX2, 16 a clock an SM): 0.064 ms there alone, not a
// floor, since an ex2 can also run as a polynomial on the FMA pipes, which
// the other float32 operations (0.030 ms) leave half idle. The recurrence is
// serial in t, but its dependent chain is one FMA a step (exp(dt * A) does
// not depend on h), so a time-parallel (chunked) scan is not needed at
// these widths: Dm 8192 channels of 4 lanes fill every SM.
//
// Design: a block owns kChannels channels of one batch row; a channel's N
// states are spread over kLanes lanes (4 for N 16, 2 for N 8 and 4), each
// lane keeping its kPer states and its row of A, pre-scaled by log2 e, in
// registers, so each exp is one FMUL and one ex2.approx. The block stages
// tiles of kSteps time steps, x and dt ([kSteps, kChannels], rows of 256
// bytes) and B and C ([kSteps, N]), by cp.async, 16 bytes a copy when
// every row is a multiple of 16 bytes and every base is aligned, else 4,
// into a ring that keeps kAhead tiles in flight beyond the one being
// scanned, so no step waits on device memory. After the one barrier a
// tile, each warp works on its own 8 (or 16) channels alone: it computes
// softplus(dt) and dt * x once per (t, channel) into shared memory, then
// scans kGroup steps at a time, every shared-memory read of a group before
// its arithmetic; a step's y is a shuffle sum over the channel's lanes,
// and its first lane adds x * D (one fmaf) and stores y straight to device
// memory, the warp's channels whole 32-byte sectors a step. The tail of the
// sequence is masked: the kernel stages its own kSteps, whatever chunk the
// caller names, so results do not depend on the chunk.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSteps = 32;     // time steps a staged tile
constexpr int kChannels = 64;  // channels a block
constexpr int kAhead = 2;      // tiles in flight beyond the one being scanned
constexpr int kGroup = 16;     // steps whose reads are issued together
constexpr int kStages = kAhead + 1;
using repro::fast_exp2;
using repro::kLog2e;

template <int N>
struct Layout {
  static constexpr int kPer = N >= 8 ? 4 : 2;  // states a lane
  static constexpr int kLanes = N / kPer;      // lanes a channel
  static constexpr int kThreads = kChannels * kLanes;
  static constexpr int kWarpChannels = 32 / kLanes;  // channels a warp
  // rows of x and dt: kChannels floats, padded so that a warp's reads of
  // kWarpChannels columns over consecutive rows hit distinct banks
  static constexpr int kRow = kChannels + kWarpChannels;
  static constexpr int kXT = kSteps * kRow;
  // a stage: x, dt [kSteps][kRow], then B, C [kSteps][N]
  static constexpr int kStage = 2 * kXT + 2 * kSteps * N;
  // the ring, then (softplus(dt), softplus(dt) * x) pairs [kSteps][kRow][2]
  static constexpr int kBytes = (kStages * kStage + 2 * kXT) * 4;
};

__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// jax.nn.softplus's stable form, max(x, 0) + log1p(e) with e = exp(-|x|)
// in (0, 1], on the SFU: e by ex2, log1p(e) as lg2(1 + e) ln 2, or, where
// 1 + e would drop most of e's bits (e < 2^-6), by its series e (1 - e/2 +
// e^2/3), whose first omitted term is below 2^-20 of it. Within about 2^-16
// of the value (the rounding of 1 + e, and lg2.approx's absolute error of
// about 2^-22), against the float32 limit of 2^-13, at a fraction of the
// cost of the accurate expf and log1pf.
__device__ __forceinline__ float softplus(float x) {
  constexpr float kLn2 = 0.6931471805599453f;
  const float e = fast_exp2(-fabsf(x) * kLog2e);
  const float l = e < 0x1p-6f ? e * fmaf(e, fmaf(e, 1.f / 3.f, -0.5f), 1.f)
                              : fast_log2(1.f + e) * kLn2;
  return fmaxf(x, 0.f) + l;
}

// Steps t..t + G - 1 of a staged tile for one lane's kPer states: every
// shared-memory read of the G steps first, then the recurrence (its only
// dependent chain is h's FMA; the exps depend on dt alone), then the G
// sums over the channel's lanes, then the channel's first lane stores y,
// with x * D folded in, straight to device memory: a warp's 8 (or 16)
// channels fill whole 32-byte sectors a step. (A store to shared memory
// there would keep the compiler from starting the next steps' reads.)
template <int N, int G>
__device__ __forceinline__ void scan_steps(int t, int c, int lane_in,
                                           const float (&a)[Layout<N>::kPer],
                                           float (&h)[Layout<N>::kPer], float dcoef,
                                           const float* xs, const float* dus, const float* bs,
                                           const float* cs, float* yt, int dm, bool store) {
  using L = Layout<N>;
  constexpr int kPer = L::kPer;
  float du[G][2], bv[G][kPer], cv[G][kPer], yv[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    repro::load_vec<2>(dus + 2 * ((t + g) * L::kRow + c), du[g]);
    repro::load_vec<kPer>(bs + (t + g) * N + lane_in * kPer, bv[g]);
    repro::load_vec<kPer>(cs + (t + g) * N + lane_in * kPer, cv[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      h[j] = fmaf(fast_exp2(du[g][0] * a[j]), h[j], du[g][1] * bv[g][j]);
      acc = fmaf(h[j], cv[g][j], acc);
    }
    yv[g] = acc;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) yv[g] = repro::warp_sum<L::kLanes>(yv[g]);
  if (store) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      yt[static_cast<long long>(t + g) * dm] = fmaf(xs[(t + g) * L::kRow + c], dcoef, yv[g]);
  }
}

// One grid row per batch row, kChannels channels a block; kVec: 16-byte
// copies (Dm a multiple of 4, x, dt, B and C 16-byte aligned), else 4-byte
// ones. hf is null unless the final state is asked for.
template <int N, bool kVec>
__global__ void __launch_bounds__(Layout<N>::kThreads)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ C, const float* __restrict__ D,
                  float* __restrict__ y, float* __restrict__ hf, int s, int dm) {
  using L = Layout<N>;
  constexpr int kPer = L::kPer, kLanes = L::kLanes, kThreads = L::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* dus = smem + kStages * L::kStage;  // (softplus(dt), softplus(dt) * x) pairs

  const int tid = threadIdx.x, c = tid / kLanes, lane_in = tid % kLanes;
  const int ch0 = blockIdx.x * kChannels, ch = ch0 + c, b = blockIdx.y;
  const bool live = ch < dm;
  float a[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a[j] = live ? A[static_cast<long long>(ch) * N + lane_in * kPer + j] * kLog2e : 0.f;
    h[j] = 0.f;
  }
  const float dcoef = live ? D[ch] : 0.f;
  const bool store = live && lane_in == 0;  // the lane that stores the channel's y
  const long long row0 = static_cast<long long>(b) * s;  // the (b, 0) row
  const int n_tiles = (s + kSteps - 1) / kSteps;

  // tile i's x, dt, B and C into stage i % kStages; steps >= s land as 0.
  // A thread copies the same column piece q of rows r, r + kRowsAPass, ...
  // of x and dt in every tile, so its addresses are set up once.
  constexpr int kWidth = kVec ? 4 : 1;                 // floats a copy
  constexpr int kPieces = kChannels / kWidth;          // copies a row
  constexpr int kRowsAPass = kThreads / kPieces;
  const int q = tid % kPieces, r = tid / kPieces;
  const bool q_in = ch0 + kWidth * q < dm;  // Dm % 4 == 0 for kVec: all in or all out
  const long long src0 = (row0 + r) * dm + ch0 + kWidth * q;
  auto copy = [&](float* dst, const float* src, bool in) {
    if constexpr (kVec) repro::cp_async16(dst, src, in ? 16 : 0);
    else repro::cp_async4(dst, src, in ? 4 : 0);
  };
  auto load = [&](int i) {
    float* st = smem + (i % kStages) * L::kStage;
    const int t0 = i * kSteps;
#pragma unroll
    for (int k = 0; k < kSteps / kRowsAPass; ++k) {
      const int t = r + k * kRowsAPass;
      const bool in = q_in && t0 + t < s;
      const long long src = in ? src0 + static_cast<long long>(t0 + k * kRowsAPass) * dm : 0;
      copy(st + t * L::kRow + kWidth * q, x + src, in);
      copy(st + L::kXT + t * L::kRow + kWidth * q, dt + src, in);
    }
    constexpr int kBC = N / kWidth;  // copies a row of B or C
    for (int e = tid; e < 2 * kSteps * kBC; e += kThreads) {
      const int t = (e / kBC) % kSteps, qq = e % kBC;
      const bool in = t0 + t < s, is_c = e >= kSteps * kBC;
      const long long src = in ? (row0 + t0 + t) * N + kWidth * qq : 0;
      copy(st + 2 * L::kXT + (is_c ? kSteps * N : 0) + t * N + kWidth * qq, (is_c ? C : B) + src,
           in);
    }
  };

  for (int i = 0; i < kAhead; ++i) {
    if (i < n_tiles) load(i);
    repro::cp_async_commit();
  }
  // After the one barrier a tile, each warp works on its own channels
  // alone (softplus and dt * x, the scan, the store of y), so one warp's
  // exps overlap another's softplus or stores.
  const int lane = tid % 32, wc0 = tid / 32 * L::kWarpChannels;  // the warp's first channel
  for (int i = 0; i < n_tiles; ++i) {
    repro::cp_async_wait<kAhead - 1>();  // tile i has landed (this thread's copies)
    __syncthreads();                     // everyone's; and every warp is done with tile i - 1
    if (i + kAhead < n_tiles) load(i + kAhead);  // into the stage tile i - 1 used
    repro::cp_async_commit();
    float* xs = smem + (i % kStages) * L::kStage;
    const float* dts = xs + L::kXT;
    const float* bs = xs + 2 * L::kXT;
    const float* cs = bs + kSteps * N;
    const int t0 = i * kSteps, tn = min(kSteps, s - t0);  // the same for every thread
    // softplus(dt) and dt * x once per (t, channel) of the warp's columns:
    // every read first, so that no store waits between them
    constexpr int kK = kSteps * L::kWarpChannels / 32;
    int at[kK];
    float dtv[kK], xv[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int e = lane + 32 * k;
      at[k] = e / L::kWarpChannels * L::kRow + wc0 + e % L::kWarpChannels;
      dtv[k] = dts[at[k]];
      xv[k] = xs[at[k]];
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float d = softplus(dtv[k]);
      *reinterpret_cast<float2*>(dus + 2 * at[k]) = make_float2(d, d * xv[k]);
    }
    __syncwarp();

    float* yt = y + (row0 + t0) * dm + ch;  // this channel's y at step t0
    if (tn == kSteps) {  // a whole tile: straight-line code, kGroup steps at a time
#pragma unroll
      for (int g0 = 0; g0 < kSteps; g0 += kGroup)
        scan_steps<N, kGroup>(g0, c, lane_in, a, h, dcoef, xs, dus, bs, cs, yt, dm, store);
    } else {  // the tail of the sequence
      int step = 0;
      for (; step + kGroup <= tn; step += kGroup)
        scan_steps<N, kGroup>(step, c, lane_in, a, h, dcoef, xs, dus, bs, cs, yt, dm, store);
      for (; step < tn; ++step)
        scan_steps<N, 1>(step, c, lane_in, a, h, dcoef, xs, dus, bs, cs, yt, dm, store);
    }
  }

  if (hf != nullptr && live) {
    float* dst = hf + (static_cast<long long>(b) * dm + ch) * N + lane_in * kPer;
    if constexpr (kVec) {
      repro::store_vec<kPer>(dst, h);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) dst[j] = h[j];
    }
  }
}

template <int N, bool kVec>
int launch(const float* x, const float* dt, const float* A, const float* B, const float* C,
           const float* D, float* y, float* hf, int bz, int s, int dm, cudaStream_t stream) {
  using L = Layout<N>;
  const cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<N, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dm + kChannels - 1) / kChannels, bz);
  mamba_scan_kernel<N, kVec><<<grid, L::kThreads, L::kBytes, stream>>>(x, dt, A, B, C, D, y,
                                                                      hf, s, dm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dt, y: [bz, s, dm]; A: [dm, n]; B, C: [bz, s, n]; D: [dm]; hf: [bz,
// dm, n] or null; all float32 and contiguous; n in {4, 8, 16}; vec != 0
// only when dm % 4 == 0 and every base is 16-byte aligned (the wrapper
// checks).
extern "C" int mamba_scan_launch(const float* x, const float* dt, const float* A,
                                 const float* B, const float* C, const float* D, float* y,
                                 float* hf, int bz, int s, int dm, int n, int vec,
                                 cudaStream_t stream) {
#define REPRO_SCAN_CASE(NN)                                                            \
  case NN:                                                                             \
    return vec ? launch<NN, true>(x, dt, A, B, C, D, y, hf, bz, s, dm, stream)         \
               : launch<NN, false>(x, dt, A, B, C, D, y, hf, bz, s, dm, stream);
  switch (n) {
    REPRO_SCAN_CASE(4)
    REPRO_SCAN_CASE(8)
    REPRO_SCAN_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SCAN_CASE
}
