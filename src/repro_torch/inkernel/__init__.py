"""``repro_torch.inkernel`` — the paper's in-pipeline probes, inside kernels.

The dispatch-level path (``repro_torch.core.measure``) times a chain from
outside its kernels. The paper instead samples ``%clock`` around a
dependent chain inside the pipeline; the card can do that, as the TPU of
the JAX package could not. All of ``repro.inkernel``:

* :func:`supported` / :func:`supported_specs` — the 58 registry rows that
  run inside a kernel (the JAX package's rule: 64-bit rows stay on the
  dispatch path); :func:`default_tile`, :func:`tiles` and
  :func:`build_chain` — a row's chain in one K2 launch;
* :func:`measure_inkernel_full` / :func:`prepare_inkernel` /
  :func:`run_prepared_inkernel` — per-step latency from the slope between
  two chain lengths (``inkernel.<row>`` rows), on the card from K2's clock
  sandwich in SM cycles;
* :func:`build_fused` — each fused kernel's unit workload at ``n`` units
  (the JAX package's arguments, bit for bit), and :func:`fused_kwargs`,
  the keywords it passes the kernel's wrapper;
* :func:`measure_fused_full` / :func:`prepare_fused` /
  :func:`run_prepared_fused` — per-unit latency from the slope between two
  workload sizes (``inkernel.fused.<name>`` rows);
* :func:`unit_bytes` — the bytes a unit adds, carried in the row's notes;
* :func:`measure_chase_full` / :func:`prepare_chase` /
  :func:`run_prepared_chase` — per-load latency of the pointer chase inside
  K3 from the slope between :data:`CHASE_LENS` (``inkernel.mem.<bytes>``
  rows), on the card from K3's clock sandwich in SM cycles, from shared
  memory or global memory (``PreparedKernel.memory_space``).

The scheduled front doors are :class:`repro_torch.api.KernelChainProbe`
(plan name ``inkernel``), :class:`repro_torch.api.FusedKernelProbe` (plan
name ``fused``) and :class:`repro_torch.api.MemoryChaseProbe` (plan name
``memory-inkernel``).
"""
from repro_torch.inkernel.factory import (build_chain, default_tile, supported,
                                          supported_specs, tile_layout, tiles)
from repro_torch.inkernel.fused import (FUSED_KERNELS, FUSED_LENS, build_fused,
                                        fused_kwargs)
from repro_torch.inkernel.measure import (CHASE_LENS, INKERNEL_LENS, PreparedKernel,
                                          measure_chase_full, measure_fused_full,
                                          measure_inkernel_full, prepare_chase,
                                          prepare_fused, prepare_inkernel,
                                          run_prepared_chase, run_prepared_fused,
                                          run_prepared_inkernel, unit_bytes)

__all__ = [
    "CHASE_LENS", "FUSED_KERNELS", "FUSED_LENS", "INKERNEL_LENS", "PreparedKernel",
    "build_chain", "build_fused", "default_tile", "fused_kwargs", "measure_chase_full",
    "measure_fused_full", "measure_inkernel_full", "prepare_chase", "prepare_fused",
    "prepare_inkernel", "run_prepared_chase", "run_prepared_fused",
    "run_prepared_inkernel", "supported", "supported_specs", "tile_layout", "tiles",
    "unit_bytes",
]
