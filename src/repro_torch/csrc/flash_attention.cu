// K5: blockwise (flash) GQA attention with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): q [B,Sq,H,D], k and v [B,Sk,KH,D] with
// H % KH == 0; the query head h reads KV head h / (H / KH). Logits are
// (q * scale) . k in float32; with `causal` a query at row i sees the keys
// at or before i + (Sk - Sq). The running max m, sum l and accumulator are
// float32, masked keys weigh exactly 0, and the output is
// acc / max(l, 1e-30) cast to the inputs' dtype. A query row that sees no
// key (causal, Sq > Sk) is 0 here: masked keys weigh exactly 0, so acc and
// l stay 0. (The TPU kernel gives such a row a value that depends on its
// block sizes, and ref_attention gives NaN; see ROADMAP Queue 3.)
//
// Bound on this card: at a model's widths, operations (4 D per visible
// query-key pair against ~4 D bytes per key read): bf16 on the tensor cores
// at 989 TFLOP/s; float32 the least of float32 FMAs (67 TFLOP/s), three
// TF32 products (3 x 4 D a pair at 495 TFLOP/s) and three bf16 products (at
// 989 TFLOP/s: two bf16 terms an operand keep about 2^-16 of each product,
// inside the float32 limit), about 0.104 ms at Jamba's causal q [1, 2048,
// 32, 128], kv [1, 2048, 8, 128], against 0.21 ms in 3xTF32, this kernel's
// form, and 0.51 ms in FMAs. The design follows the dtype, and nothing else:
//
// bfloat16 -> flash_attention_wgmma_kernel, on the tensor cores. A block
// owns 128 query rows of one head: two consumer warpgroups of 64 rows
// each, and one producer warp. The producer's lane 0 copies the Q tile once
// and each 64-key tile of K and V into a ring of kStages stages with TMA
// (cp.async.bulk.tensor; the tensor maps are made on the host through
// cudaGetDriverEntryPoint, so nothing links against libcuda), straight
// into wgmma's swizzled shared-memory layout. Each stage has a `full`
// mbarrier (the copies' bytes) and an `empty` one (one arrival per
// consumer warp), so the two warpgroups run on their own while the next
// tiles load. S = Q . K^T is wgmma m64n64k16 with both operands in shared
// memory and float32 accumulators; the online softmax runs on those
// registers in float32 (base 2, the scale folded with log2 e into the
// exponent's FMA); P becomes the A operand of O += P . V (wgmma m64nDk16, P
// from registers, V read from shared memory transposed, O in float32
// registers) as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so
// P . V carries about 16 bits of p. One rounding of p alone reads about the
// bf16 limit at Jamba widths (PERF.md gives both forms' errors and times).
// With `causal`, KV tiles
// wholly above a block's last row are never loaded, a warpgroup skips the
// tiles above its own rows, the mask is computed only on tiles that cross
// the diagonal or Sk, and the heaviest query tiles launch first. Rows past
// Sq or Sk load as zeros (TMA's out-of-bounds fill); keys >= Sk are masked
// and rows >= Sq are never stored. Masked keys weigh exactly 0: their
// logits are set to -inf, so p = 2^(-inf - m) = 0, while the running max m
// starts at the finite NEG_INF and stays finite. (With the finite NEG_INF
// for the masked logits instead, a row whose keys are all masked so far
// would have m = -1e30 and 2^(s - m) = 1 for each masked key.)
//
// float32 -> flash_attention_tf32_kernel, 3xTF32 on the tensor cores
// (mma.sync m16n8k8). One TF32 product (2^-11) would fail the float32 limit
// of 2^-13, so each operand x is split as hi = tf32(x), lo = tf32(x - hi),
// both rounded to nearest, ties away (cvt.rna's rounding, in integer ops:
// mma reads only a register's top 19 bits, so raw bits would truncate),
// and each product is taken as lo.hi + hi.lo + hi.hi into float32
// accumulators, for S = (q scale) . K^T and for O += P . V alike. A block
// of 8 warps serves up to 128 query rows of the g query heads that share
// one KV head (a warp: 16 rows of one head), so each K and V tile it loads
// serves all of them: 32-key tiles of K and V arrive by 16-byte cp.async
// in a 2-stage ring, in float32, rows padded to D + 4 floats (every
// fragment read hits 32 distinct banks). Each warp splits its scaled q
// once into shared memory (hi and lo: split Q in registers would take 128
// of them at D 128, and the O accumulator 64 more); K and V are split as
// their fragments are read. The softmax runs on S's accumulator fragments
// in float32 (base 2, MUFU.EX2). P enters P . V without a shuffle: the
// accumulator holds keys 2 t and 2 t + 1 of each 8 where the A fragment
// wants columns t and t + 4, so the kernel lets column t stand for key 2 t
// and column t + 4 for key 2 t + 1, and reads V's rows in that order (the
// sum over keys does not care). Masked logits take the finite NEG_INF and
// p is forced to exactly 0 by predicate (so hi = lo = 0); a row that sees
// no key has l = 0 and is stored as 0. With `causal`, KV tiles wholly above
// a block's last row are never loaded, a warp skips the tiles above its own
// rows, the mask is computed only on tiles that cross the diagonal or Sk,
// and the heaviest blocks launch first. What holds it above its bound:
// every warp reads its split q and whole K and V tiles as fragments from
// shared memory and splits K and V itself, mma.sync does not reach
// wgmma's TF32 rate, and TF32 runs at half bf16's (PERF.md, section 6).
// wgmma would read both products' operands straight from shared memory,
// but in TF32 only K-major, and V is stored [key, D]: it needs V transposed
// per tile. In bf16, wgmma also takes V as it is stored.
//
// Both read the [B,S,H,D] layout through their own strides: nothing is
// transposed.
#include <cuda.h>  // CUtensorMap; the driver function comes through the runtime

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the finite mask value and the running max's start
using repro::fast_exp2;
using repro::kLog2e;

// ------------------------------------------------- float32, 3xTF32 mma.sync
namespace tf {

constexpr int kWarps = 8;              // warps a block, 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;              // query rows of a warp: mma's M
constexpr int kBlockN = 32;            // keys a KV tile
constexpr int kStages = 2;             // KV tiles in the cp.async ring

// Shared memory of a block, in floats: the split Q of each warp (hi, then
// lo: [kWarps][kRows][kPad] each), then kStages K tiles and kStages V tiles
// ([kBlockN][kPad] each). Rows are padded to D + 4 floats, so the lanes of a
// fragment read (row g, column t, or row 2t, column g) hit 32 distinct
// banks, and stay 16-byte aligned for cp.async.
template <int D>
struct Smem {
  static constexpr int kPad = D + 4;
  static constexpr int kQ = kWarps * kRows * kPad;
  static constexpr int kTile = kBlockN * kPad;
  static constexpr int kK = 2 * kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBytes = (kV + kStages * kTile) * 4;
};

// x = hi + lo in two TF32 terms, each rounded to nearest with ties away
// from zero, cvt.rna.tf32.f32's rounding for finite x, in integer ops on
// the bit pattern (cvt.rna adds an inf/NaN check and a select to each):
// adding half of TF32's ulp to the magnitude and clearing the 13 low bits
// rounds; hi is cleared, since x - hi must be exact in float32; lo is only
// added to, since mma reads the top 19 bits of a register and never the
// rest. Raw float32 bits would be truncated instead of rounded.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}
// d (16x8, float32) += a (16x8, TF32, row) . b (8x8, TF32, col). Fragments,
// with g = lane / 4 and t = lane % 4: a = {(g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)}; b = {(t, g), (t + 4, g)}; d = {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)} as (row, column).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a . b in 3xTF32: lo.hi + hi.lo + hi.hi (lo.lo, about 2^-22 of the
// product, is left out).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// One block per (run of kWarps work items, KV head, batch); an item is 16
// query rows of one of the g query heads that read this KV head (item i:
// row tile i / g, head i % g), so every K and V tile a block loads serves
// up to kWarps x 16 query rows. Heavy blocks (late rows under `causal`)
// launch first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int sq,
                            int sk, int h, int kh, float scale, int causal) {
  using L = Smem<D>;
  constexpr int kPad = L::kPad;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int khi = blockIdx.y, b = blockIdx.z, grp = h / kh;
  const int n_items = (sq + kRows - 1) / kRows * grp;
  const int first = (gridDim.x - 1 - blockIdx.x) * kWarps;  // this block's first item
  const int item = first + warp;
  const bool live = item < n_items;
  const int p0 = (live ? item / grp : 0) * kRows;            // this warp's first row
  const int hi = khi * grp + (live ? item % grp : 0);
  const int offset = sk - sq;  // query row i sits at key position i + offset
  const int last_p0 = (min(first + kWarps, n_items) - 1) / grp * kRows;
  const int kend = causal ? min(sk, max(last_p0 + kRows + offset, 0)) : sk;
  const int w_kend = causal ? min(sk, max(p0 + kRows + offset, 0)) : sk;
  const int n_tiles = (kend + kBlockN - 1) / kBlockN;

  const long long q_stride = static_cast<long long>(h) * D;   // between rows
  const long long kv_stride = static_cast<long long>(kh) * D;
  const float* qb = q + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(hi) * D;
  const float* kb = k + static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(khi) * D;
  const float* vb = v + static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(khi) * D;
  float* ob = o + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(hi) * D;
  float* qh = smem + warp * kRows * kPad;
  float* ql = qh + L::kQ;

  // K and V rows k0.. of tile t into stage t % kStages, 16 bytes a copy;
  // keys >= sk read nothing and land as zeros.
  auto load_tile = [&](int t) {
    float* ks = smem + L::kK + (t % kStages) * L::kTile;
    float* vs = smem + L::kV + (t % kStages) * L::kTile;
    constexpr int kChunks = D / 4;  // 16-byte copies a row
    for (int i = tid; i < 2 * kBlockN * kChunks; i += kThreads) {
      const int r = (i / kChunks) % kBlockN, c = i % kChunks, key = t * kBlockN + r;
      const long long src = static_cast<long long>(min(key, sk - 1)) * kv_stride + 4 * c;
      const bool is_v = i >= kBlockN * kChunks;
      repro::cp_async16((is_v ? vs : ks) + r * kPad + 4 * c, (is_v ? vb : kb) + src,
                        key < sk ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(0);
  repro::cp_async_commit();

  // this warp's rows of q, scaled, split in two TF32 terms once
  for (int i = lane; i < kRows * D; i += 32) {
    const int r = i / D, d = i % D, s = p0 + r;
    uint32_t xh, xl;
    split(live && s < sq ? qb[s * q_stride + d] * scale : 0.f, xh, xl);
    qh[r * kPad + d] = __uint_as_float(xh);
    ql[r * kPad + d] = __uint_as_float(xl);
  }

  const int row0 = p0 + g, row1 = row0 + 8;  // this thread's two rows
  float o_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o_acc[n][c] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // tile t has landed (this thread's copies)
    __syncthreads();            // everyone's copies, and the split q
    const int k0 = t * kBlockN;
    if (live && k0 < w_kend) {  // some key of the tile is visible to this warp
      const float* ks = smem + L::kK + (t % kStages) * L::kTile;
      const float* vs = smem + L::kV + (t % kStages) * L::kTile;
      // S = (q scale) . K^T: s[j] is the 16 x 8 block of keys k0 + 8j..
      float s[kBlockN / 8][4];
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int a0 = g * kPad + 8 * kk + t4, a1 = a0 + 8 * kPad;
        const uint32_t ah[4] = {__float_as_uint(qh[a0]), __float_as_uint(qh[a1]),
                                __float_as_uint(qh[a0 + 4]), __float_as_uint(qh[a1 + 4])};
        const uint32_t al[4] = {__float_as_uint(ql[a0]), __float_as_uint(ql[a1]),
                                __float_as_uint(ql[a0 + 4]), __float_as_uint(ql[a1 + 4])};
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          const float* kp = ks + (8 * j + g) * kPad + 8 * kk + t4;
          mma3(s[j], ah, al, kp[0], kp[4]);
        }
      }
      // s[j][c]: row (c < 2 ? row0 : row1), key k0 + 8j + 2 t4 + (c & 1).
      // Masked keys take the finite kNegInf and weigh exactly 0 by
      // predicate; only a tile that crosses the diagonal or Sk is masked.
      uint32_t visible = 0xffffu;  // bit 4j + c
      if (k0 + kBlockN > sk || (causal && k0 + kBlockN - 1 > p0 + offset)) {
        visible = 0;
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = k0 + 8 * j + 2 * t4 + (c & 1), row = c < 2 ? row0 : row1;
            if (key < sk && (!causal || key <= row + offset)) visible |= 1u << (4 * j + c);
          }
      }
      float mt0 = kNegInf, mt1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!(visible >> (4 * j + c) & 1u)) s[j][c] = kNegInf;
          if (c < 2) mt0 = fmaxf(mt0, s[j][c]);
          else mt1 = fmaxf(mt1, s[j][c]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the row's four lanes
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
      }
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      const float alpha0 = fast_exp2((m0 - mn0) * kLog2e);
      const float alpha1 = fast_exp2((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = (visible >> (4 * j + c) & 1u)
                              ? fast_exp2((s[j][c] - (c < 2 ? mn0 : mn1)) * kLog2e)
                              : 0.f;
          s[j][c] = p;
          if (c < 2) ls0 += p;
          else ls1 += p;
        }
      l0 = l0 * alpha0 + ls0;  // this lane's part of the row sums
      l1 = l1 * alpha1 + ls1;
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {  // a max moved
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o_acc[n][0] *= alpha0;
          o_acc[n][1] *= alpha0;
          o_acc[n][2] *= alpha1;
          o_acc[n][3] *= alpha1;
        }
      }
      // O += P . V over the tile's keys, 8 at a time. The A fragment wants
      // columns t4 and t4 + 4 of each row, but s[j] holds keys 2 t4 and
      // 2 t4 + 1: so column t4 stands for key 8j + 2 t4 and column t4 + 4
      // for key 8j + 2 t4 + 1, and V's rows are read in the same order
      // (B's rows t4, t4 + 4 -> keys 2 t4, 2 t4 + 1). The sum over keys is
      // the same, and P needs no shuffle.
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        const float* vp = vs + (8 * j + 2 * t4) * kPad + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) mma3(o_acc[n], ph, pl, vp[8 * n], vp[kPad + 8 * n]);
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

  if (!live) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t4;
    if (row0 < sq)
      *reinterpret_cast<float2*>(ob + row0 * q_stride + col) =
          make_float2(o_acc[n][0] * inv0, o_acc[n][1] * inv0);
    if (row1 < sq)
      *reinterpret_cast<float2*>(ob + row1 * q_stride + col) =
          make_float2(o_acc[n][2] * inv1, o_acc[n][3] * inv1);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int b, int sq, int sk,
           int h, int kh, float scale, int causal, cudaStream_t stream) {
  using L = Smem<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = (sq + kRows - 1) / kRows * (h / kh);
  const dim3 grid((items + kWarps - 1) / kWarps, kh, b);
  flash_attention_tf32_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      q, k, v, o, sq, sk, h, kh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf

int launch_tf32(const void* q, const void* k, const void* v, void* o, int b, int sq,
                int sk, int h, int kh, int d, float scale, int causal, cudaStream_t stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(o);
  switch (d) {
    case 16: return tf::launch<16>(qt, kt, vt, ot, b, sq, sk, h, kh, scale, causal, stream);
    case 32: return tf::launch<32>(qt, kt, vt, ot, b, sq, sk, h, kh, scale, causal, stream);
    case 64: return tf::launch<64>(qt, kt, vt, ot, b, sq, sk, h, kh, scale, causal, stream);
    case 128: return tf::launch<128>(qt, kt, vt, ot, b, sq, sk, h, kh, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------- bfloat16, wgmma
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = 2;                    // warpgroups of 64 query rows
constexpr int kBlockM = 64 * kConsumers;         // query rows per block
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kBlockN = 64;                      // keys per KV tile
constexpr int kStages = 2;                       // KV tiles in the ring
constexpr int kPTerms = 2;                       // bf16 terms of p in P . V
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also sets the bytes the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}
// One TMA copy of a box of a 4-d tensor into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product's start and its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor: the start address, the leading- and
// stride-dimension byte offsets (between core matrices along K, and along
// M or N), each in units of 16 bytes, and the swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (layout << 62);
}

// Two neighbouring p values (x at the lower address) as two bf16 pairs:
// their rounding, and the rounding of what it leaves out.
__device__ __forceinline__ void round_p(float x, float y, uint32_t (&terms)[kPTerms]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);  // .x, the low half, = x
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  terms[0] = *reinterpret_cast<const uint32_t*>(&h);
  terms[1] = *reinterpret_cast<const uint32_t*>(&l);
}

// d[0:32] (+)= A[64x16] . B[16x64], A and B in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:N/2] += A[64x16] . B[16xN], A in registers, B in shared memory,
// MN-major (V read transposed), for N = 16, 32, 64, 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory of a block (1024-aligned): the Q tile and kStages K and V
// tiles, then the barriers. A tile of R rows is D / A slabs of R rows by
// S = min(128, 2 D) bytes (slab c holds columns A c..A c + A - 1, A = S / 2),
// swizzled in S-byte rows: wgmma's swizzled layout, which TMA writes with
// the same swizzle, one box of A columns by R rows per slab.
template <int D>
struct Smem {
  static constexpr int kS = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kA = kS / 2;
  static constexpr uint64_t kLayout = kS == 128 ? 1 : (kS == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kS == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (kS == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // full[kStages], empty[kStages], q
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;  // + alignment
};

// One block per (head, batch, query tile of kBlockM rows), heavy tiles
// (late rows under `causal`) first: kConsumers warpgroups of 64 rows each,
// and one producer warp whose lane 0 starts the TMA copies of Q once and of
// each K and V tile into the ring as the consumers free its stages.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                             int sq, int sk, int h, int kh, float scale_log2, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV, bars = base + L::kBars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t q_bar = bars + 16 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hi = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;
  const int khi = hi / (h / kh);
  const int offset = sk - sq;  // query row i sits at key position i + offset
  const int kend = causal ? min(sk, max(q0 + kBlockM + offset, 0)) : sk;
  const int n_tiles = (kend + kBlockN - 1) / kBlockN;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);                     // the producer's expect_tx
      mbar_init(empty(st), 4 * kConsumers);       // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int c = 0; c < D / L::kA; ++c)
        tma_load_4d(q_s + c * kBlockM * L::kS, &q_map, L::kA * c, q0, hi, b, q_bar);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty(st), (t / kStages - 1) & 1);
        mbar_expect_tx(full(st), 2 * L::kTileBytes);
        for (int c = 0; c < D / L::kA; ++c) {
          tma_load_4d(k_s + st * L::kTileBytes + c * kBlockN * L::kS, &k_map, L::kA * c,
                      t * kBlockN, khi, b, full(st));
          tma_load_4d(v_s + st * L::kTileBytes + c * kBlockN * L::kS, &v_map, L::kA * c,
                      t * kBlockN, khi, b, full(st));
        }
      }
    }
    return;
  }

  const int wgi = tid / 128, wwarp = warp % 4;
  const long long q_stride = static_cast<long long>(h) * D;
  bf16* ob = o + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(hi) * D;
  const int w_q0 = q0 + 64 * wgi;  // this warpgroup's first row
  const int w_kend = causal ? min(sk, max(w_q0 + 64 + offset, 0)) : sk;
  const int row0 = w_q0 + 16 * wwarp + lane / 4, row1 = row0 + 8;  // this thread's rows

  // K-major operands (Q, K): atoms of A columns by 8 rows of S bytes, the
  // 8-row groups 8 S apart (SBO); a k-step of 16 columns moves 32 bytes
  // inside an atom row, and the next atom of columns starts a slab on.
  auto k_major = [&](uint32_t tile, int rows, int kk) {
    constexpr int kSteps = L::kA / 16;  // k-steps per atom
    return make_desc(tile + (kk / kSteps) * rows * L::kS + (kk % kSteps) * 32, 16, 8 * L::kS,
                     L::kLayout);
  };
  float s_acc[32], o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  if (n_tiles > 0) mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    // Wait for the tile even when skipping it: an arrival on `empty` before
    // this use's copy has landed could count toward the stage's previous use.
    mbar_wait(full(st), (t / kStages) & 1);
    const int k0 = t * kBlockN;
    if (k0 < w_kend) {  // some key of the tile is visible to this warpgroup
      // V (B transposed, MN-major): atoms of A columns of D (N), a slab
      // apart (LBO); 8 keys (K) 8 S bytes apart (SBO)
      const uint64_t dv = make_desc(v_s + st * L::kTileBytes, kBlockN * L::kS, 8 * L::kS,
                                    L::kLayout);
      reg_fence(s_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s_acc, k_major(q_s + 64 * wgi * L::kS, kBlockM, kk),
                     k_major(k_s + st * L::kTileBytes, kBlockN, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s_acc);

      // s_acc[4j + 2i + c]: row (i ? row1 : row0), key k0 + 8j + 2(lane % 4) + c.
      // Only a tile that crosses the diagonal or Sk is masked.
      if (k0 + kBlockN > sk || (causal && k0 + kBlockN - 1 > w_q0 + offset)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + c;
            if (key >= sk || (causal && key > row0 + offset)) s_acc[4 * j + c] = -INFINITY;
            if (key >= sk || (causal && key > row1 + offset)) s_acc[4 * j + 2 + c] = -INFINITY;
          }
      }
      float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mt0 = fmaxf(mt0, fmaxf(s_acc[4 * j], s_acc[4 * j + 1]));
        mt1 = fmaxf(mt1, fmaxf(s_acc[4 * j + 2], s_acc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the row's four lanes
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
      }
      // the running max in base-2 units of the scaled logits (scale > 0)
      const float mn0 = fmaxf(m0, mt0 * scale_log2), mn1 = fmaxf(m1, mt1 * scale_log2);
      const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p0 = fast_exp2(fmaf(s_acc[4 * j + c], scale_log2, -mn0));
          const float p1 = fast_exp2(fmaf(s_acc[4 * j + 2 + c], scale_log2, -mn1));
          s_acc[4 * j + c] = p0;
          s_acc[4 * j + 2 + c] = p1;
          ls0 += p0;
          ls1 += p1;
        }
      l0 = l0 * a0 + ls0;  // this lane's part of the row sums
      l1 = l1 * a1 + ls1;
      if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {  // a max moved in this warp
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o_acc[4 * j] *= a0;
          o_acc[4 * j + 1] *= a0;
          o_acc[4 * j + 2] *= a1;
          o_acc[4 * j + 3] *= a1;
        }
      }
      // P as wgmma's A fragments: keys 16kk..16kk+15 are the accumulator's
      // n8 blocks 2kk, 2kk+1, so s_acc's layout is already A's.
      uint32_t pa[4][4][kPTerms];  // [k-step][A register][term]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          round_p(s_acc[8 * kk + 2 * r], s_acc[8 * kk + 2 * r + 1], pa[kk][r]);
      reg_fence(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys of V: two core matrices on
        const uint64_t dvk = dv + kk * (2 * 8 * L::kS >> 4);
#pragma unroll
        for (int term = 0; term < kPTerms; ++term) {
          const uint32_t a[4] = {pa[kk][0][term], pa[kk][1][term], pa[kk][2][term],
                                 pa[kk][3][term]};
          wgmma_rs(o_acc, a, dvk);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_stride + 8 * j + col) =
          __floats2bfloat162_rn(o_acc[4 * j] * inv0, o_acc[4 * j + 1] * inv0);
    if (row1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * q_stride + 8 * j + col) =
          __floats2bfloat162_rn(o_acc[4 * j + 2] * inv1, o_acc[4 * j + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                              cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a [batch, rows, heads, D] bf16 tensor read as boxes of
// `box_cols` columns by `box_rows` rows of one head; rows past the end read
// as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads, int d,
              int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(heads) * d * 2,
                                 static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * heads * d * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int b, int sq, int sk, int h,
           int kh, float scale, int causal, cudaStream_t stream) {
  if (sk == 0)  // no key at all: every row is 0 (and a tensor map needs rows)
    return static_cast<int>(cudaMemsetAsync(
        o, 0, static_cast<size_t>(b) * sq * h * D * sizeof(bf16), stream));
  CUtensorMap q_map, k_map, v_map;
  using L = Smem<D>;
  if (!make_map(&q_map, q, b, sq, h, D, L::kA, kBlockM, L::kSwizzle) ||
      !make_map(&k_map, k, b, sk, kh, D, L::kA, kBlockN, L::kSwizzle) ||
      !make_map(&v_map, v, b, sk, kh, D, L::kA, kBlockN, L::kSwizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b, (sq + kBlockM - 1) / kBlockM);
  flash_attention_wgmma_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      q_map, k_map, v_map, o, sq, sk, h, kh, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b, int sq,
                 int sk, int h, int kh, int d, float scale, int causal,
                 cudaStream_t stream) {
  using wg::bf16;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(o);
  switch (d) {
    case 16: return wg::launch<16>(qt, kt, vt, ot, b, sq, sk, h, kh, scale, causal, stream);
    case 32: return wg::launch<32>(qt, kt, vt, ot, b, sq, sk, h, kh, scale, causal, stream);
    case 64: return wg::launch<64>(qt, kt, vt, ot, b, sq, sk, h, kh, scale, causal, stream);
    case 128: return wg::launch<128>(qt, kt, vt, ot, b, sq, sk, h, kh, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: [b, sq, h, d]; k, v: [b, sk, kh, d]; contiguous, one dtype:
// repro::kBFloat16 runs the wgmma kernel, repro::kFloat32 the 3xTF32
// mma.sync kernel; bases 16-byte aligned (TMA and cp.async need it); d in
// {16, 32, 64, 128}; h % kh == 0.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int sk, int h, int kh, int d, float scale,
                                      int causal, cudaStream_t stream) {
  if (dtype == repro::kFloat32)
    return launch_tf32(q, k, v, o, b, sq, sk, h, kh, d, scale, causal, stream);
  if (dtype == repro::kBFloat16)
    return launch_wgmma(q, k, v, o, b, sq, sk, h, kh, d, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
