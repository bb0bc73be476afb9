// K6: one-token (decode) GQA attention against a KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py::flash_decode
// (_decode_kernel): q [B,H,D], k and v [B,S,KH,D], kv_len [B] int32. The g
// = H / KH query heads of one KV head attend together to the keys below
// kv_len[b], with the online softmax of K5 (float32 m, l and accumulator,
// finite NEG_INF, output acc / max(l, 1e-30) cast to the inputs' dtype).
// KV tiles at or past kv_len are never loaded, so kv_len = 0 gives zeros,
// as the TPU kernel does (ref_decode_attention gives NaN there).
//
// Bound on this card: bytes. Each key and value is read once for g query
// heads: 4 g D operations per 4 D bytes (bf16), far below the card's
// ~295 operations per byte.
//
// Design: one block of 128 threads per (KV head, batch), walking the KV
// tiles of 32 keys below kv_len[b]; the tiles are staged in float32 shared
// memory (rows padded to D + 1 against bank conflicts). Sixteen lanes own
// one query head: each computes 2 of the tile's 32 logits, the sixteen
// reduce max and sum with shuffles, and each accumulates D/16 output
// columns in float32 registers. g is a runtime bound up to 8 (the block's
// 8 query slots; slots past g idle in the arithmetic but help load). This
// first version keeps one block per KV head, so a batch of 8 with 8 KV
// heads fills only 64 of the 132 SMs and each block streams its cache
// alone: the split over the sequence (split-KV, partial results combined
// by their log-sum-exp) that fills the card is a later PR.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;                          // query heads per KV head
constexpr int kLanesPerRow = kThreads / kMaxGroup;    // 16
constexpr int kBlockK = 32;                           // keys per KV tile
constexpr int kKeysPerLane = kBlockK / kLanesPerRow;  // 2
constexpr float kNegInf = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, int s, int kh, int g, float scale) {
  constexpr int kPad = D + 1;
  constexpr int kCols = D / kLanesPerRow;  // output columns per thread
  __shared__ float qs[kMaxGroup][kPad];
  __shared__ float ks[kBlockK][kPad];
  __shared__ float vs[kBlockK][kPad];
  __shared__ float ps[kMaxGroup][kBlockK + 1];

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow, lane = tid % kLanesPerRow;
  const int khi = blockIdx.x, b = blockIdx.y;
  const long long kv_stride = static_cast<long long>(kh) * D;  // between keys
  const T* qb = q + (static_cast<long long>(b) * kh * g + static_cast<long long>(khi) * g) * D;
  const T* kb = k + static_cast<long long>(b) * s * kv_stride + static_cast<long long>(khi) * D;
  const T* vb = v + static_cast<long long>(b) * s * kv_stride + static_cast<long long>(khi) * D;
  T* ob = o + (static_cast<long long>(b) * kh * g + static_cast<long long>(khi) * g) * D;

  for (int i = tid; i < kMaxGroup * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[r][d] = r < g ? repro::load_f32(qb + r * D + d) * scale : 0.f;
  }
  const int len = min(max(kv_len[b], 0), s);

  float m = kNegInf, l = 0.f, acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int c = i / D, d = i % D, t = k0 + c;
      const bool in = t < len;
      ks[c][d] = in ? repro::load_f32(kb + t * kv_stride + d) : 0.f;
      vs[c][d] = in ? repro::load_f32(vb + t * kv_stride + d) : 0.f;
    }
    __syncthreads();

    float sc[kKeysPerLane];
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) sc[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row][d];
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j)
        sc[j] = fmaf(qv, ks[lane + kLanesPerRow * j][d], sc[j]);
    }
    bool valid[kKeysPerLane];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      valid[j] = k0 + lane + kLanesPerRow * j < len;
      if (valid[j]) mt = fmaxf(mt, sc[j]);
    }
    mt = repro::warp_max<kLanesPerRow>(mt);
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      const float p = valid[j] ? expf(sc[j] - m_new) : 0.f;
      ps[row][lane + kLanesPerRow * j] = p;
      ls += p;
    }
    ls = repro::warp_sum<kLanesPerRow>(ls);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();  // the row's sixteen lanes (half a warp) wrote ps[row]
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float p = ps[row][c];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = fmaf(p, vs[c][lane + kLanesPerRow * j], acc[j]);
    }
  }

  if (row < g) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      repro::store_f32(ob + row * D + lane + kLanesPerRow * j, acc[j] * inv);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const int* kv_len,
                 void* o, int b, int s, int kh, int g, int d, float scale,
                 cudaStream_t stream) {
  const dim3 grid(kh, b);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
#define REPRO_DECODE_CASE(DIM)                                             \
  case DIM:                                                                \
    flash_decode_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(            \
        qt, kt, vt, kv_len, ot, s, kh, g, scale);                          \
    break;
  switch (d) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [b, kh * g, d]; k, v: [b, s, kh, d]; kv_len: [b] int32; contiguous,
// q/k/v/o of one dtype (repro::kFloat32 or repro::kBFloat16); d in
// {16, 32, 64, 128}; 1 <= g <= 8.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, const int* kv_len, void* o,
                                   int b, int s, int kh, int g, int d,
                                   float scale, cudaStream_t stream) {
  if (g < 1 || g > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return launch_typed<float>(q, k, v, kv_len, o, b, s, kh, g, d, scale, stream);
  if (dtype == repro::kBFloat16)
    return launch_typed<__nv_bfloat16>(q, k, v, kv_len, o, b, s, kh, g, d, scale,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
