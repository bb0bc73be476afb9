"""Declarative measurement plans: cross-products of probes, with dedupe.

A :class:`Plan` is an ordered, duplicate-free tuple of probes; builders make
the paper's sweeps, ``+`` composes plans and ``filter`` trims them. The
algebra and the ``quick``, ``table2``, ``memory``, ``inkernel``,
``memory-inkernel``, ``fused``, ``serving`` and ``slo`` plans are those of
``repro.api.plan``, so both packages give the same ordered logical keys;
``Plan.clock_overhead`` defaults to the three levels, O0, O1 and O3, as
there. The other named plans of the JAX package are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

from repro_torch import inkernel
from repro_torch.api.probes import (ClockOverheadProbe, FusedKernelProbe,
                                    InstructionProbe, KernelChainProbe, KernelProbe,
                                    MemoryChaseProbe, MemoryProbe, Probe,
                                    ServingCostProbe, SloProbe)
from repro_torch.core import chains
from repro_torch.core.chains import OpSpec
from repro_torch.core.optlevels import OPT_LEVELS

# The CLI/CI keep-set: one representative per interesting latency class,
# including the divisor-taxonomy splits the paper highlights.
QUICK_OPS = ("add", "mul", "mad", "div.s.regular", "div.s.irregular",
             "div.s.runtime", "fma.float32", "div.runtime.float32", "sqrt",
             "rsqrt", "sin", "ex2", "popc", "clz", "add.bfloat16")

# The JAX package's plan names; only PORTED_PLANS run here.
PLAN_NAMES = ("quick", "table2", "memory", "inkernel", "memory-inkernel",
              "fused", "serving", "collectives", "serving-sharded", "slo",
              "full")
PORTED_PLANS = ("quick", "table2", "memory", "inkernel", "memory-inkernel", "fused",
                "serving", "slo")

# Representative (batch, prompt_len) serving cells: a single-sequence short
# prompt and a batched longer one, as in the JAX package.
SERVING_CELLS = ((1, 16), (2, 64))

# The SLO plan's arrival rates, as in the JAX package: below, around and
# above the tiny engine's saturation point, so that the throughput-vs-latency
# curve has a flat region and a queueing knee.
SLO_RATES = (20.0, 50.0, 100.0)

# The JAX package's in-kernel chase ladder (``Plan.memory_inkernel``): its
# 16 MiB VMEM budget >> 8, >> 6, >> 4, >> 2, x1, x2, x4, written out so that
# both plans stay equal. On the card K3's own budget
# (``kernels.chase.SMEM_BUDGET_BYTES``, 227 KB) picks the path: the 64 KiB
# rung runs from shared memory, the other six from global memory.
MEMORY_INKERNEL_LADDER = (64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20, 32 << 20,
                          64 << 20)


@dataclasses.dataclass(frozen=True)
class Plan:
    probes: tuple[Probe, ...] = ()
    name: str = "plan"

    # ------------------------------------------------------------- algebra
    def __add__(self, other: "Plan") -> "Plan":
        return Plan(_dedupe(self.probes + other.probes),
                    name=_compose_name(self.name, other.name))

    def __len__(self) -> int:
        return len(self.probes)

    def __iter__(self) -> Iterator[Probe]:
        return iter(self.probes)

    def dedupe(self) -> "Plan":
        return dataclasses.replace(self, probes=_dedupe(self.probes))

    def filter(self, ops: Iterable[str] | None = None,
               opt_levels: Iterable[str] | None = None,
               categories: Iterable[str] | None = None) -> "Plan":
        """Keep only probes matching every given axis (None = keep all); the
        op axis matches any of a probe's :meth:`Probe.match_names`."""
        ops = set(ops) if ops is not None else None
        opt_levels = set(opt_levels) if opt_levels is not None else None
        categories = set(categories) if categories is not None else None
        kept = tuple(
            p for p in self.probes
            if (ops is None or not ops.isdisjoint(p.match_names()))
            and (opt_levels is None or p.opt_level in opt_levels)
            and (categories is None or p.category in categories))
        return dataclasses.replace(self, probes=kept)

    # ------------------------------------------------------------ builders
    @staticmethod
    def instructions(registry: Sequence[OpSpec] | None = None,
                     opt_levels: Sequence[str] = ("O0", "O3"),
                     ops: Iterable[str] | None = None,
                     dtypes: Iterable[str] | None = None,
                     categories: Iterable[str] | None = None) -> "Plan":
        """Registry x opt-level cross-product (paper Table II)."""
        registry = list(registry if registry is not None
                        else chains.default_registry())
        if ops is not None:
            keep = set(ops)
            registry = [o for o in registry if o.name in keep]
        if dtypes is not None:
            keep = set(dtypes)
            registry = [o for o in registry if o.dtype in keep]
        if categories is not None:
            keep = set(categories)
            registry = [o for o in registry if o.category in keep]
        probes = tuple(InstructionProbe(spec, lv)
                       for spec in registry for lv in opt_levels)
        return Plan(_dedupe(probes), name="instructions")

    @staticmethod
    def clock_overhead(opt_levels: Sequence[str] = OPT_LEVELS) -> "Plan":
        return Plan(tuple(ClockOverheadProbe(lv) for lv in opt_levels),
                    name="clock_overhead")

    @staticmethod
    def memory(working_sets: Sequence[int] | None = None,
               steps: tuple[int, int] = (2048, 6144)) -> "Plan":
        """Pointer-chase ladder over working-set sizes (paper Fig. 6)."""
        if working_sets is None:
            working_sets = [1 << k for k in range(12, 26)]  # 4 KiB .. 32 MiB
        return Plan(tuple(MemoryProbe(ws, steps=steps) for ws in working_sets),
                    name="memory")

    @staticmethod
    def kernels(kernel_ops: Sequence[str] = ("fma",),
                lens: tuple[int, int] = (8, 64)) -> "Plan":
        return Plan(tuple(KernelProbe(op, lens=lens) for op in kernel_ops),
                    name="kernels")

    @staticmethod
    def memory_inkernel(working_sets: Sequence[int] | None = None,
                        lens: tuple[int, int] | None = None,
                        host_pair: bool = True,
                        host_steps: tuple[int, int] = (2048, 6144)) -> "Plan":
        """The in-kernel chase ladder (paper Table IV from shared memory, Fig. 6
        from global memory), paired by default with the host-level chase at
        the same sizes, so that one run fills both sides of the host vs
        in-kernel table (:data:`MEMORY_INKERNEL_LADDER` by default)."""
        if working_sets is None:
            working_sets = MEMORY_INKERNEL_LADDER
        probes: list[Probe] = [MemoryChaseProbe(ws, lens=lens) for ws in working_sets]
        if host_pair:
            probes += [MemoryProbe(ws, steps=host_steps) for ws in working_sets]
        return Plan(_dedupe(tuple(probes)), name="memory-inkernel")

    @staticmethod
    def fused(names: Sequence[str] | None = None,
              lens: tuple[int, int] | None = None) -> "Plan":
        """One :class:`FusedKernelProbe` per fused kernel (flash_attention /
        flash_decode / mamba_scan / rmsnorm): the ``inkernel.fused.<name>``
        rows."""
        names = tuple(names if names is not None else inkernel.FUSED_KERNELS)
        return Plan(tuple(FusedKernelProbe(n, lens=lens) for n in names),
                    name="fused")

    @staticmethod
    def serving(cells: Sequence[tuple[int, int]] = SERVING_CELLS,
                phases: Sequence[str] = ("prefill", "decode"),
                cfg=None, rt=None, with_deps: bool = True) -> "Plan":
        """One :class:`ServingCostProbe` per ``(batch, prompt_len)`` cell and
        phase, preceded by default by the rows the estimator prices against:
        the ``QUICK_OPS`` at O3 and the chase rungs of 8 KiB, 128 KiB and 2
        MiB at the memory plan's default steps (a step-suffixed rung is
        another experiment, which the estimator's ladder does not read).
        Plan order is execution order, so the cells are priced from measured
        rows."""
        probes: list[Probe] = []
        if with_deps:
            probes += list(Plan.instructions(ops=QUICK_OPS, opt_levels=("O3",)))
            probes += list(Plan.memory((1 << 13, 1 << 17, 1 << 21)))
        probes += [ServingCostProbe(phase, b, p, cfg=cfg, rt=rt)
                   for b, p in cells for phase in phases]
        return Plan(_dedupe(tuple(probes)), name="serving")

    @staticmethod
    def slo(rates: Sequence[float] = SLO_RATES, n_requests: int = 12,
            n_slots: int = 4, seed: int = 0, cfg=None, rt=None,
            with_deps: bool = True) -> "Plan":
        """Serving-SLO sweep: one :class:`SloProbe` per arrival rate —
        predicted-vs-measured TTFT/TPOT percentiles over the same seeded
        trace — preceded by default by the estimator's pricing inputs,
        exactly like :meth:`serving`: plan order is execution order, so each
        SLO point's simulator is measurement-backed."""
        probes: list[Probe] = []
        if with_deps:
            probes += list(Plan.instructions(ops=QUICK_OPS, opt_levels=("O3",)))
            probes += list(Plan.memory((1 << 13, 1 << 17, 1 << 21)))
        probes += [SloProbe(r, n_requests=n_requests, n_slots=n_slots, seed=seed,
                            cfg=cfg, rt=rt) for r in rates]
        return Plan(_dedupe(tuple(probes)), name="slo")

    @staticmethod
    def inkernel(registry: Sequence[OpSpec] | None = None,
                 ops: Iterable[str] | None = None,
                 categories: Iterable[str] | None = None,
                 lens: tuple[int, int] | None = None,
                 dispatch_pair: bool = True) -> "Plan":
        """An in-kernel chain per eligible registry row (the paper's
        in-pipeline method), paired by default with the same row's
        dispatch-level O3 probe, so that one run fills both sides of the
        dispatch-vs-in-kernel table."""
        specs = inkernel.supported_specs(registry, ops=ops, categories=categories)
        probes: list[Probe] = [KernelChainProbe(s, lens=lens) for s in specs]
        if dispatch_pair:
            probes += [InstructionProbe(s, "O3") for s in specs]
        return Plan(_dedupe(tuple(probes)), name="inkernel")


def _compose_name(a: str, b: str, max_parts: int = 3) -> str:
    """Name for ``a + b``: deduped '+'-join, capped (``a+b+c+2more``)."""
    parts: list[str] = []
    overflow = 0
    for part in (*a.split("+"), *b.split("+")):
        if part.endswith("more") and part[:-4].isdigit():
            overflow += int(part[:-4])
        elif part and part not in parts:
            parts.append(part)
    if len(parts) > max_parts:
        overflow += len(parts) - max_parts
        parts = parts[:max_parts]
    if overflow:
        parts.append(f"{overflow}more")
    return "+".join(parts) or "plan"


def _dedupe(probes: Sequence[Probe]) -> tuple[Probe, ...]:
    seen: set[tuple] = set()
    out: list[Probe] = []
    for p in probes:
        k = p.logical_key()
        if k in seen:
            continue
        seen.add(k)
        out.append(p)
    return tuple(out)


def named_plan(name: str) -> Plan:
    """The CLI's plan registry (:data:`PORTED_PLANS` run; the JAX package's
    other names raise)."""
    if name == "quick":
        plan = (Plan.clock_overhead(("O0", "O3"))
                + Plan.instructions(ops=QUICK_OPS, opt_levels=("O0", "O3"))
                + Plan.memory((1 << 13, 1 << 17, 1 << 21), steps=(512, 1536))
                + Plan.kernels(("fma",)))
    elif name == "table2":
        plan = (Plan.clock_overhead(("O0", "O3"))
                + Plan.instructions(opt_levels=("O0", "O3")))
    elif name == "memory":
        plan = Plan.memory()
    elif name == "inkernel":
        plan = Plan.inkernel()
    elif name == "memory-inkernel":
        plan = Plan.memory_inkernel()
    elif name == "fused":
        plan = Plan.fused()
    elif name == "serving":
        plan = Plan.serving()
    elif name == "slo":
        plan = Plan.slo()
    elif name in PLAN_NAMES:
        raise ValueError(f"plan {name!r} is not ported yet; ported plans: "
                         f"{PORTED_PLANS} (see ROADMAP.md)")
    else:
        raise ValueError(f"unknown plan {name!r}; choose from {PORTED_PLANS}")
    return dataclasses.replace(plan, name=name)
