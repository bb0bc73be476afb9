// K5: blockwise (flash) GQA attention with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): q [B,Sq,H,D], k and v [B,Sk,KH,D] with
// H % KH == 0; the query head h reads KV head h / (H / KH). Logits are
// (q * scale) . k in float32; with `causal` a query at row i sees the keys
// at or before i + (Sk - Sq). The running max m, sum l and accumulator are
// float32, masked logits take the finite NEG_INF, and the output is
// acc / max(l, 1e-30) cast to the inputs' dtype. A query row that sees no
// key (causal, Sq > Sk) is 0 here: masked keys weigh exactly 0, so acc and
// l stay 0. (The TPU kernel gives such a row a value that depends on its
// block sizes, and ref_attention gives NaN; see ROADMAP Queue 3.)
//
// Bound on this card: at a model's widths, operations (4 D per visible
// query-key pair against ~4 D bytes per key read); this first version runs
// them as float32 FMAs from shared memory, not on the tensor cores, so it
// is bound by shared-memory loads (about one per FMA) and sits far from
// the card's bf16 peak. The tensor-core (mma/wgmma) version is a later PR.
//
// Design: one block of 128 threads per (query tile of 16 rows, head,
// batch). The q tile is staged once, scaled, in float32 shared memory;
// the loop walks the KV tiles of 32 keys, staging k and v (float32, rows
// padded to D + 1 so that the lanes of a warp hit distinct banks). Eight
// lanes own a query row: each computes 4 of the row's 32 logits, the eight
// reduce the max and the sum with shuffles, and each then accumulates D/8
// output columns of p . v in float32 registers. With `causal`, KV tiles
// wholly above the tile's last row are never loaded. The kernel reads the
// [B,S,H,D] layout through its own strides: nothing is transposed.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 16;         // query rows per block
constexpr int kBlockK = 32;         // keys per KV tile
constexpr int kLanesPerRow = kThreads / kBlockQ;      // 8
constexpr int kKeysPerLane = kBlockK / kLanesPerRow;  // 4
constexpr float kNegInf = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int sk, int h, int kh, float scale, int causal) {
  constexpr int kPad = D + 1;
  constexpr int kCols = D / kLanesPerRow;  // output columns per thread
  __shared__ float qs[kBlockQ][kPad];
  __shared__ float ks[kBlockK][kPad];
  __shared__ float vs[kBlockK][kPad];
  __shared__ float ps[kBlockQ][kBlockK + 1];

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow, lane = tid % kLanesPerRow;
  const int q0 = blockIdx.x * kBlockQ, hi = blockIdx.y, b = blockIdx.z;
  const int khi = hi / (h / kh);
  const long long q_stride = static_cast<long long>(h) * D;   // between rows
  const long long kv_stride = static_cast<long long>(kh) * D;
  const T* qb = q + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(hi) * D;
  const T* kb = k + static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(khi) * D;
  const T* vb = v + static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(khi) * D;
  T* ob = o + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(hi) * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    qs[r][d] = s < sq ? repro::load_f32(qb + s * q_stride + d) * scale : 0.f;
  }
  const int offset = sk - sq;          // query row i sits at key position i + offset
  const int qpos = q0 + row + offset;
  int kend = sk;                       // keys at or past kend are masked for every row
  if (causal) kend = min(sk, max(q0 + kBlockQ + offset, 0));

  float m = kNegInf, l = 0.f, acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int c = i / D, d = i % D, s = k0 + c;
      const bool in = s < sk;
      ks[c][d] = in ? repro::load_f32(kb + s * kv_stride + d) : 0.f;
      vs[c][d] = in ? repro::load_f32(vb + s * kv_stride + d) : 0.f;
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
      const int kp = k0 + lane + kLanesPerRow * j;
      valid[j] = kp < sk && (!causal || qpos >= kp);
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
    __syncwarp();  // the row's eight lanes (one warp) wrote ps[row]
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

  const int s = q0 + row;
  if (s < sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      repro::store_f32(ob + s * q_stride + lane + kLanesPerRow * j, acc[j] * inv);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, int b,
                 int sq, int sk, int h, int kh, int d, float scale, int causal,
                 cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
#define REPRO_FLASH_CASE(DIM)                                              \
  case DIM:                                                                \
    flash_attention_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(         \
        qt, kt, vt, ot, sq, sk, h, kh, scale, causal);                     \
    break;
  switch (d) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [b, sq, h, d]; k, v: [b, sk, kh, d]; contiguous, one dtype
// (repro::kFloat32 or repro::kBFloat16); d in {16, 32, 64, 128}; h % kh == 0.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int sk, int h, int kh, int d, float scale,
                                      int causal, cudaStream_t stream) {
  if (dtype == repro::kFloat32)
    return launch_typed<float>(q, k, v, o, b, sq, sk, h, kh, d, scale, causal, stream);
  if (dtype == repro::kBFloat16)
    return launch_typed<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kh, d, scale,
                                       causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
