// K3: the dependent pointer chase, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/chase.py::chase (_chase, through
// _chase_kernel_vmem and _chase_kernel_any): p = ring[p] for `steps` steps
// over an int32 single-cycle ring, returning the last index.
//
// Design: one thread. Each load's address is the value the previous load
// returned, so the loads cannot overlap and the kernel's time is steps x the
// latency of the level the ring sits in. Every rung issues the same
// instruction, ld.global.ca.s32 through inline PTX (asm volatile, so ptxas
// neither changes the cache operator nor moves the load through the
// read-only path), so what changes from rung to rung is only where the ring
// sits: small rings are hit in L1 or L2, a 2 MiB ring in L2. The TPU
// kernel's VMEM-resident path has no counterpart yet (a shared-memory path
// for rings that fit a block's shared memory is left to a later slice).
//
// The ring must hold indices into itself (a permutation of its live slots,
// as repro_torch.core.membench.build_ring makes it); the kernel does not
// check them, because a check in the loop would add to every load it times.
//
// Bound on this card: latency, steps x one dependent load; the bytes it
// needs (one word per step) would take nanoseconds at the card's bandwidth.
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ int load_global(const int* addr) {
  int v;
  asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(v) : "l"(addr));
  return v;
}

__global__ void chase_kernel(const int* ring, const int* start, int* out,
                             long long steps) {
  int p = start[0];
  for (long long k = 0; k < steps; ++k) p = load_global(ring + p);
  out[0] = p;
}

}  // namespace

extern "C" int chase_launch(const int* ring, const int* start, int* out,
                            long long steps, cudaStream_t stream) {
  chase_kernel<<<1, 1, 0, stream>>>(ring, start, out, steps);
  return static_cast<int>(cudaGetLastError());
}
