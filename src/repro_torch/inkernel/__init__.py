"""``repro_torch.inkernel`` — the fused production kernels as probe rows.

The fused half of ``repro.inkernel``:

* :func:`build_fused` — each fused kernel's unit workload at ``n`` units
  (the JAX package's arguments, bit for bit), and :func:`fused_kwargs`,
  the keywords it passes the kernel's wrapper;
* :func:`measure_fused_full` / :func:`prepare_fused` /
  :func:`run_prepared_fused` — per-unit latency from the slope between two
  workload sizes (``inkernel.fused.<name>`` rows);
* :func:`unit_bytes` — the bytes a unit adds, carried in the row's notes.

The scheduled front door is :class:`repro_torch.api.FusedKernelProbe`
(plan name ``fused``). The chain and chase halves of ``repro.inkernel``
are not ported yet.
"""
from repro_torch.inkernel.fused import (FUSED_KERNELS, FUSED_LENS, build_fused,
                                        fused_kwargs)
from repro_torch.inkernel.measure import (PreparedKernel, measure_fused_full,
                                          prepare_fused, run_prepared_fused,
                                          unit_bytes)

__all__ = [
    "FUSED_KERNELS", "FUSED_LENS", "PreparedKernel", "build_fused",
    "fused_kwargs", "measure_fused_full", "prepare_fused", "run_prepared_fused", "unit_bytes",
]
