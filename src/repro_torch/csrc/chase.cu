// K3: the dependent pointer chase, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/chase.py::chase (_chase, through
// _chase_kernel_vmem and _chase_kernel_any): p = ring[p] for `steps` steps
// over an int32 single-cycle ring, returning the last index.
//
// Design: one thread chases. Each load's address is the value the previous
// load returned, so the loads cannot overlap and the chase's time is steps x
// the latency of the level the ring sits in. The TPU kernel's two
// residencies have two counterparts here, picked by the wrapper from the
// ring's footprint (kernels/chase.py select_memory_space):
//   smem   (the VMEM path): a block of kCopyThreads copies the ring into
//          dynamic shared memory with 16-byte loads, waits at a barrier, and
//          thread 0 chases with ld.shared. A block may opt into 227 KB
//          (232448 bytes) of dynamic shared memory on sm_90, the most a
//          ring on this path may take.
//   global (the ANY path): one thread chases with ld.global.ca through
//          inline PTX (asm volatile, so ptxas neither changes the cache
//          operator nor moves the load to the read-only path). The kernel
//          asks for the largest L1 (shared-memory carveout 0: 256 KB of L1
//          on an H100 SM), so the level a load hits depends on where the
//          ring sits and on what the launch walked before it.
// The indices stay slot indices on both paths, so both return the same p. A
// step is the load and one address instruction (LEA for ld.shared, IMAD.WIDE
// for ld.global; chip_smoke.py reads it from the SASS).
//
// Before its timed loads a launch may walk `warm` untimed steps: a ring that
// fits L1 is walked once around (warm = its live slots) so that the timed
// loads hit L1 (membench.level_rule). p is written to `out`; passing the
// start's own buffer as `out` carries the start from one launch to the next,
// which rings above L1 use: one thread reads start[0] first and writes out[0]
// last, so the two may alias.
//
// The timed form (`cycles` non-null) is K1's and K2's clock sandwich: %clock64
// is read once the start index, the copy (smem path) and the warm steps have
// landed, and again once the last timed load has returned; each read is
// predicated on a test of the index it must follow, true for every index a
// ring can hold (alu_chain.cu's clock_after), so neither read moves. At 64 and
// 192 timed steps (the in-kernel plan's lengths) the chase is straight-line,
// an instance per length, so a two-length slope holds the loads and their
// address arithmetic and no loop; any other count runs a loop of single
// steps.
//
// The ring must hold indices into itself (a permutation of its live slots,
// as repro_torch.core.membench.build_ring makes it); the kernel does not
// check them, because a check in the chase would add to every load it times.
//
// Bound on this card: latency, steps x one dependent load; the bytes it
// needs (one word per step) would take nanoseconds at the card's bandwidth.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCopyThreads = 256;
constexpr long long kSmemBudget = 232448;  // 227 KB: sm_90's opt-in maximum

__device__ __forceinline__ int load_global(const int* ring, int p) {
  int v;
  asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(v) : "l"(ring + p));
  return v;
}

__device__ __forceinline__ int load_shared(unsigned base, int p) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];"
               : "=r"(v) : "r"(base + (static_cast<unsigned>(p) << 2)));
  return v;
}

// %clock64, read once `p` has been produced: the read is predicated on a
// test of p, true for every value but one no ring index takes, for which an
// unpredicated read stands in.
__device__ __forceinline__ long long clock_after(int p) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %1, 0x7fc00001;\n\t"
      "mov.u64 %0, %%clock64;\n\t"
      "@q mov.u64 %0, %%clock64;\n\t}"
      : "=&l"(t) : "r"(p) : "memory");
  return t;
}

template <bool SMEM>
struct Ring {
  const int* global;
  unsigned shared;
  __device__ __forceinline__ int step(int p) const {
    if constexpr (SMEM) return load_shared(shared, p);
    else return load_global(global, p);
  }
};

// N > 0: exactly N steps, straight-line (the caller passes steps == N);
// N == 0: `steps` steps, a loop of single steps when timed.
template <bool SMEM, bool TIMED, int N>
__global__ void chase_kernel(const int* __restrict__ ring, long long n, const int* start,
                             int* out, long long* __restrict__ cycles, long long warm,
                             long long steps, int vec) {
  extern __shared__ int4 smem[];
  Ring<SMEM> r{ring, 0};
  int p = 0;
  if constexpr (SMEM) {
    if (threadIdx.x == 0) p = start[0];
    int* s = reinterpret_cast<int*>(smem);
    const long long n4 = vec ? n / 4 : 0;
    const int4* src = reinterpret_cast<const int4*>(ring);
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) smem[i] = src[i];
    for (long long i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) s[i] = ring[i];
    __syncthreads();
    if (threadIdx.x != 0) return;
    r.shared = static_cast<unsigned>(__cvta_generic_to_shared(s));
  } else {
    p = start[0];
  }
#pragma unroll 1
  for (long long k = 0; k < warm; ++k) p = r.step(p);
  long long t0 = 0;
  if constexpr (TIMED) t0 = clock_after(p);
  if constexpr (N > 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) p = r.step(p);
  } else if constexpr (TIMED) {
#pragma unroll 1
    for (long long k = 0; k < steps; ++k) p = r.step(p);
  } else {
    for (long long k = 0; k < steps; ++k) p = r.step(p);
  }
  if constexpr (TIMED) cycles[0] = clock_after(p) - t0;
  out[0] = p;
}

template <bool SMEM, bool TIMED, int N>
int launch(const int* ring, long long n, const int* start, int* out, long long* cycles,
           long long warm, long long steps, cudaStream_t stream) {
  auto kernel = chase_kernel<SMEM, TIMED, N>;
  if constexpr (SMEM) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBudget));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const size_t bytes = static_cast<size_t>((n * 4 + 15) / 16 * 16);
    const int vec = reinterpret_cast<uintptr_t>(ring) % 16 == 0;
    kernel<<<1, kCopyThreads, bytes, stream>>>(ring, n, start, out, cycles, warm, steps, vec);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxL1);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<1, 1, 0, stream>>>(ring, n, start, out, cycles, warm, steps, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool SMEM, bool TIMED>
int launch_len(const int* ring, long long n, const int* start, int* out, long long* cycles,
               long long warm, long long steps, cudaStream_t stream) {
  if constexpr (TIMED) {
    if (steps == 64)
      return launch<SMEM, true, 64>(ring, n, start, out, cycles, warm, steps, stream);
    if (steps == 192)
      return launch<SMEM, true, 192>(ring, n, start, out, cycles, warm, steps, stream);
  }
  return launch<SMEM, TIMED, 0>(ring, n, start, out, cycles, warm, steps, stream);
}

}  // namespace

// out[0] <- p after `warm` + `steps` loads from start[0] over the n-slot
// ring; `smem` picks the path (the ring's bytes must fit kSmemBudget there);
// with a non-null `cycles`, the timed form, and cycles[0] gets the SM cycles
// of the `steps` timed loads. `out` may be `start` (the start carried).
extern "C" int chase_launch(const int* ring, long long n, const int* start, int* out,
                            long long* cycles, long long warm, long long steps, int smem,
                            cudaStream_t stream) {
  if (n <= 0 || warm < 0 || steps < 0 || (smem && n * 4 > kSmemBudget))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem) {
    return cycles ? launch_len<true, true>(ring, n, start, out, cycles, warm, steps, stream)
                  : launch_len<true, false>(ring, n, start, out, cycles, warm, steps, stream);
  }
  return cycles ? launch_len<false, true>(ring, n, start, out, cycles, warm, steps, stream)
                : launch_len<false, false>(ring, n, start, out, cycles, warm, steps, stream);
}
