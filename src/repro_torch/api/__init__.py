"""``repro_torch.api`` — the single entry point for characterization.

* :class:`Probe` — one measurement with a stable cache identity.
* :class:`Plan` — a declarative, deduplicated cross-product of probes.
* :class:`Session` — owns the device, the Timer, the environment
  fingerprint and the LatencyDB-backed cache; runs plans incrementally.
* :class:`ResultSet` — per-probe outcomes plus report helpers.

CLI: ``python -m repro_torch characterize --plan
quick|table2|memory|inkernel|memory-inkernel|fused|serving|slo --db PATH
[--table] [--device cuda|cpu]`` and ``python -m repro_torch serve-slo --db
PATH [--rates R1,R2] [--trace PATH] [--device cuda|cpu]``.
"""
from repro_torch.api.plan import (PLAN_NAMES, PORTED_PLANS, QUICK_OPS, SERVING_CELLS,
                                  SLO_RATES, Plan, named_plan)
from repro_torch.api.probes import (ClockOverheadProbe, FusedKernelProbe,
                                    InstructionProbe, KernelChainProbe, KernelProbe,
                                    MemoryChaseProbe, MemoryProbe, Probe, ProbeContext,
                                    ServingCostProbe, SloProbe, serving_tiny_config)
from repro_torch.api.session import ProbeResult, ResultSet, Session

__all__ = [
    "PLAN_NAMES", "PORTED_PLANS", "QUICK_OPS", "SERVING_CELLS", "SLO_RATES", "Plan",
    "named_plan",
    "ClockOverheadProbe", "FusedKernelProbe", "InstructionProbe", "KernelChainProbe",
    "KernelProbe", "MemoryChaseProbe", "MemoryProbe",
    "Probe", "ProbeContext", "ProbeResult", "ResultSet", "ServingCostProbe", "Session",
    "SloProbe",
    "serving_tiny_config",
]
