// K6: one-token (decode) GQA attention against a KV cache, for Hopper
// (sm_90a), split over the sequence (split-KV).
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py::flash_decode
// (_decode_kernel): q [B,H,D], k and v [B,S,KH,D], kv_len [B] int32. The g
// = H / KH query heads of one KV head attend together to the keys below
// kv_len[b] with an online softmax (float32 m, l and accumulator, finite
// NEG_INF, output acc / max(l, 1e-30) cast to the inputs' dtype). Keys at
// or past kv_len weigh exactly 0 and are never loaded, so kv_len = 0 gives
// zeros, as the TPU kernel does (ref_decode_attention gives NaN there).
//
// Bound on this card: bytes. Each key and value is read once for the g
// query heads: 4 g D operations per 4 D bytes (bf16), far below the card's
// ~295 operations per byte, so float32 FMAs on the CUDA cores suffice.
//
// Design, two passes on one stream, no atomics (two calls give the same
// bits):
// 1. decode_split_kernel, grid (KV head, batch, split). A split is a fixed
//    run of keys_per_split keys (the wrapper's KEYS_PER_SPLIT); a block
//    whose split starts at or past kv_len[b] exits at once, so the long
//    rows of a ragged batch spread over many SMs. The block streams its
//    keys in tiles of kTileKeys through a kStages-deep cp.async ring in
//    shared memory (16-byte copies, neighbouring threads on neighbouring
//    addresses, the next tiles in flight while one is computed). A group of
//    D / E lanes (E elements, 16 bytes, a lane) owns one key row at a time:
//    each lane keeps its E columns of the g query rows in registers (scaled
//    by log2(e) / sqrt(D)), reads its 16 bytes of K once for all g heads,
//    and the group sums the g partial dots with shuffles. Each group walks
//    its own kKeysPerStep keys of every tile with a running m, l and its E
//    columns of the g accumulators in registers (rescaled only when the
//    running max moves); at the end the block's groups are merged by
//    log-sum-exp in a fixed order. With one split the block writes the
//    output; otherwise it writes its partial (m, l, acc) in float32 to
//    workspace the wrapper allocates.
// 2. decode_combine_kernel, grid (KV head, batch, query head): the live
//    splits of a row merged by log-sum-exp, their loads spread over the
//    block and the sums taken in a fixed order. A row with kv_len = 0 has
//    none and gives 0.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxGroup = 8;      // query heads per KV head
constexpr int kKeysPerStep = 4;   // keys a lane group takes from each tile
constexpr int kStages = 3;        // cp.async ring depth, in tiles
constexpr float kNegInf = -1e30f;
// Keys per split must be a multiple of every instance's tile, so that no
// tile straddles two splits (checked by Layout).
constexpr int kSplitMultiple = 64;

// 2^x by the SFU: exact 0 for the finite NEG_INF offsets of masked and
// empty running maxima.
using repro::fast_exp2;

template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a lane
  static constexpr int kLanes = D / kVec;                         // lanes a key row
  // at least 8 groups, and at least one full warp (the shuffles name all 32)
  static constexpr int kGroups = kLanes >= 4 ? 8 : 32 / kLanes;
  static constexpr int kThreads = kGroups * kLanes;
  static constexpr int kTileKeys = kGroups * kKeysPerStep;
  static constexpr int kRingBytes = kStages * 2 * kTileKeys * D * static_cast<int>(sizeof(T));
  static constexpr int kMergeBytes = kGroups * kMaxGroup * (D + 2) * 4;
  static constexpr int kSmemBytes = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static_assert(kLanes >= 1 && kLanes <= 32 && D % kVec == 0, "head dim");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kSplitMultiple % kTileKeys == 0, "a tile within one split");
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(Layout<T, D>::kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int s, int kh, int g,
                    int keys_per_split, float scale_log2) {
  using Lay = Layout<T, D>;
  constexpr int E = Lay::kVec, L = Lay::kLanes, NG = Lay::kGroups;
  constexpr int NT = Lay::kThreads, BK = Lay::kTileKeys;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kStages][K, V][BK][D]

  const int tid = threadIdx.x, grp = tid / L, lane = tid % L;
  const int khi = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int len = min(max(kv_len[b], 0), s);
  const int k_begin = split * keys_per_split;
  if (nsplit > 1 && k_begin >= len) return;  // no key here; the combine skips it
  const int k_end = min(k_begin + keys_per_split, len);
  const long long kv_stride = static_cast<long long>(kh) * D;  // between keys
  const T* kb = k + static_cast<long long>(b) * s * kv_stride + static_cast<long long>(khi) * D;
  const T* vb = v + static_cast<long long>(b) * s * kv_stride + static_cast<long long>(khi) * D;
  const long long head0 = static_cast<long long>(b) * kh * g + static_cast<long long>(khi) * g;

  // cp.async of tile t into ring stage st: each thread copies kKeysPerStep
  // 16-byte chunks of K and as many of V, neighbouring threads on
  // neighbouring chunks; rows past k_end are zero-filled without a read.
  auto load_tile = [&](int t, int st) {
    T* ks = ring + st * 2 * BK * D;
    T* vs = ks + BK * D;
    const int t0 = k_begin + t * BK;
#pragma unroll
    for (int r = 0; r < kKeysPerStep; ++r) {
      const int c = tid + NT * r, row = c / L, col = (c % L) * E;
      const int key = t0 + row;
      const bool in = key < k_end;
      const long long off = static_cast<long long>(in ? key : 0) * kv_stride + col;
      repro::cp_async16(ks + row * D + col, kb + off, in ? 16 : 0);
      repro::cp_async16(vs + row * D + col, vb + off, in ? 16 : 0);
    }
  };

  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    repro::cp_async_commit();
  }

  float qr[G][E];  // this lane's E columns of the g query rows, pre-scaled
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h < g) {
      repro::load_vec<E>(q + (head0 + h) * D + lane * E, qr[h]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[h][e] *= scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[h][e] = 0.f;
    }
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed for all; stage (t - 1) % kStages is free
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    repro::cp_async_commit();

    const T* ks = ring + (t % kStages) * 2 * BK * D;
    const T* vs = ks + BK * D;
    const int row0 = grp * kKeysPerStep;
    float sc[kKeysPerStep][G];
#pragma unroll
    for (int i = 0; i < kKeysPerStep; ++i) {
      float kf[E];
      repro::load_vec<E>(ks + (row0 + i) * D + lane * E, kf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[h][e], kf[e], dot);
        sc[i][h] = dot;
      }
    }
#pragma unroll
    for (int i = 0; i < kKeysPerStep; ++i)
#pragma unroll
      for (int h = 0; h < G; ++h) sc[i][h] = repro::warp_sum<L>(sc[i][h]);

    const int key0 = k_begin + t * BK + row0;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mt = kNegInf;
#pragma unroll
      for (int i = 0; i < kKeysPerStep; ++i)
        if (key0 + i < k_end) mt = fmaxf(mt, sc[i][h]);
      if (mt > m[h]) {  // a new running max: rescale (else the factor is exactly 1)
        const float alpha = fast_exp2(m[h] - mt);
        m[h] = mt;
        l[h] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
      }
      float ls = 0.f;
#pragma unroll
      for (int i = 0; i < kKeysPerStep; ++i) {
        const float p = key0 + i < k_end ? fast_exp2(sc[i][h] - m[h]) : 0.f;
        sc[i][h] = p;
        ls += p;
      }
      l[h] += ls;
    }
#pragma unroll
    for (int i = 0; i < kKeysPerStep; ++i) {
      float vf[E];
      repro::load_vec<E>(vs + (row0 + i) * D + lane * E, vf);
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(sc[i][h], vf[e], acc[h][e]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // every read of the ring is done: reuse it for the merge

  // merge the groups: [NG][G][D] accumulators, then [NG][G] m and l
  float* mg_acc = reinterpret_cast<float*>(smem);
  float* mg_m = mg_acc + NG * G * D;
  float* mg_l = mg_m + NG * G;
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < E; ++e) mg_acc[(grp * G + h) * D + lane * E + e] = acc[h][e];
    if (lane == 0) {
      mg_m[grp * G + h] = m[h];
      mg_l[grp * G + h] = l[h];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += NT) {
    const int h = i / D, d = i % D;
    float mx = kNegInf;
    for (int j = 0; j < NG; ++j) mx = fmaxf(mx, mg_m[j * G + h]);
    float lsum = 0.f, o = 0.f;
    for (int j = 0; j < NG; ++j) {
      const float w = exp2f(mg_m[j * G + h] - mx);  // 0 for a group that saw no key
      lsum = fmaf(w, mg_l[j * G + h], lsum);
      o = fmaf(w, mg_acc[(j * G + h) * D + d], o);
    }
    if (nsplit == 1) {
      repro::store_f32(out + (head0 + h) * D + d, o / fmaxf(lsum, 1e-30f));
    } else {
      const long long slot = (static_cast<long long>(b * kh + khi) * nsplit + split) * g + h;
      part_acc[slot * D + d] = o;
      if (d == 0) {
        part_ml[slot * 2] = mx;
        part_ml[slot * 2 + 1] = lsum;
      }
    }
  }
}

// Threads a combine block deals each output column's splits over.
constexpr int kCombineParts = 4;

// The max (or sum) of v over the block, the same in every thread: shuffles
// within each warp, then the warps' values in warp order (a fixed order, so
// two calls give the same bits). red holds one value a warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? repro::warp_max(v) : repro::warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
    v = kMax ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();  // red is free again
  return v;
}

// Grid (KV head, batch, query head), D * kCombineParts threads. The row's
// live splits are independent loads, spread over the block so that few
// L2 round trips are in series: the largest m and the sum of l under it
// by block reductions, then each output column's sum over the splits
// dealt over kCombineParts threads and added in part order.
template <typename T>
__global__ void __launch_bounds__(128 * kCombineParts)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      const int* __restrict__ kv_len, T* __restrict__ out, int s, int kh,
                      int g, int d, int nsplit, int keys_per_split) {
  __shared__ float red[32];
  __shared__ float partial[kCombineParts][128];
  const int khi = blockIdx.x, b = blockIdx.y, h = blockIdx.z, tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = min(max(kv_len[b], 0), s);
  const int live = (len + keys_per_split - 1) / keys_per_split;
  const long long slot0 = static_cast<long long>(b * kh + khi) * nsplit * g + h;
  const float* ml = part_ml + slot0 * 2;         // split j: m at ml[j * 2 g], l after it
  const float* acc = part_acc + slot0 * d;       // split j at acc[j * g d]
  const long long ml_step = 2LL * g, acc_step = static_cast<long long>(g) * d;

  float mx = kNegInf;
  for (int j = tid; j < live; j += nt) mx = fmaxf(mx, ml[j * ml_step]);
  mx = block_reduce<true>(mx, red);
  float lsum = 0.f;
  for (int j = tid; j < live; j += nt) lsum += exp2f(ml[j * ml_step] - mx) * ml[j * ml_step + 1];
  lsum = block_reduce<false>(lsum, red);

  const int col = tid % d, part = tid / d;
  float o = 0.f;
#pragma unroll 16
  for (int j = part; j < live; j += kCombineParts)
    o = fmaf(exp2f(ml[j * ml_step] - mx), acc[j * acc_step + col], o);
  partial[part][col] = o;
  __syncthreads();
  if (part == 0) {
    for (int p = 1; p < kCombineParts; ++p) o += partial[p][col];
    const long long head = static_cast<long long>(b) * kh * g + static_cast<long long>(khi) * g + h;
    repro::store_f32(out + head * d + col, o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch_split(const T* q, const T* k, const T* v, const int* kv_len, T* o,
                 float* part_acc, float* part_ml, int b, int s, int kh, int g,
                 int keys_per_split, int nsplit, float scale_log2, cudaStream_t stream) {
  using Lay = Layout<T, D>;
  auto kernel = decode_split_kernel<T, D, G>;
  if (Lay::kSmemBytes > 48 * 1024) {  // above 48 KB only when asked for, once
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmemBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  kernel<<<dim3(kh, b, nsplit), Lay::kThreads, Lay::kSmemBytes, stream>>>(
      q, k, v, kv_len, o, part_acc, part_ml, s, kh, g, keys_per_split, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_group(const T* q, const T* k, const T* v, const int* kv_len, T* o,
                 float* part_acc, float* part_ml, int b, int s, int kh, int g,
                 int keys_per_split, int nsplit, float scale_log2, cudaStream_t stream) {
  // the smallest instance whose G covers g (G: 1, 2, 4, 8)
  if (g <= 1)
    return launch_split<T, D, 1>(q, k, v, kv_len, o, part_acc, part_ml, b, s, kh, g,
                                 keys_per_split, nsplit, scale_log2, stream);
  if (g <= 2)
    return launch_split<T, D, 2>(q, k, v, kv_len, o, part_acc, part_ml, b, s, kh, g,
                                 keys_per_split, nsplit, scale_log2, stream);
  if (g <= 4)
    return launch_split<T, D, 4>(q, k, v, kv_len, o, part_acc, part_ml, b, s, kh, g,
                                 keys_per_split, nsplit, scale_log2, stream);
  return launch_split<T, D, 8>(q, k, v, kv_len, o, part_acc, part_ml, b, s, kh, g,
                               keys_per_split, nsplit, scale_log2, stream);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const int* kv_len,
                 void* o, float* part_acc, float* part_ml, int b, int s, int kh, int g,
                 int d, int keys_per_split, float scale_log2, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  const int nsplit = s > keys_per_split ? (s + keys_per_split - 1) / keys_per_split : 1;
  if (nsplit > 65535 || (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (d) {
    case 16: err = launch_group<T, 16>(qt, kt, vt, kv_len, ot, part_acc, part_ml, b, s, kh, g,
                                       keys_per_split, nsplit, scale_log2, stream); break;
    case 32: err = launch_group<T, 32>(qt, kt, vt, kv_len, ot, part_acc, part_ml, b, s, kh, g,
                                       keys_per_split, nsplit, scale_log2, stream); break;
    case 64: err = launch_group<T, 64>(qt, kt, vt, kv_len, ot, part_acc, part_ml, b, s, kh, g,
                                       keys_per_split, nsplit, scale_log2, stream); break;
    case 128: err = launch_group<T, 128>(qt, kt, vt, kv_len, ot, part_acc, part_ml, b, s, kh,
                                         g, keys_per_split, nsplit, scale_log2, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err || nsplit == 1) return err;
  decode_combine_kernel<T><<<dim3(kh, b, g), d * kCombineParts, 0, stream>>>(
      part_acc, part_ml, kv_len, ot, s, kh, g, d, nsplit, keys_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [b, kh * g, d]; k, v: [b, s, kh, d]; kv_len: [b] int32; contiguous,
// 16-byte aligned, q/k/v/o of one dtype (repro::kFloat32 or
// repro::kBFloat16); d in {16, 32, 64, 128}; 1 <= g <= 8; keys_per_split a
// positive multiple of 64. With nsplit = ceil(s / keys_per_split) > 1,
// part_acc is float32 [b, kh, nsplit, g, d] and part_ml float32 [b, kh,
// nsplit, g, 2] (workspace: written by the first pass, read by the second);
// with one split both may be null.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, const int* kv_len, void* o,
                                   void* part_acc, void* part_ml, int b, int s, int kh,
                                   int g, int d, int keys_per_split, float scale,
                                   cudaStream_t stream) {
  if (g < 1 || g > kMaxGroup || keys_per_split < kSplitMultiple ||
      keys_per_split % kSplitMultiple)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == repro::kFloat32)
    return launch_typed<float>(q, k, v, kv_len, o, pa, pm, b, s, kh, g, d, keys_per_split,
                               scale_log2, stream);
  if (dtype == repro::kBFloat16)
    return launch_typed<__nv_bfloat16>(q, k, v, kv_len, o, pa, pm, b, s, kh, g, d,
                                       keys_per_split, scale_log2, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
