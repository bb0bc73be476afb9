"""Probe types: the unit of work a :class:`repro_torch.api.Session` schedules.

A probe is one measurement with a stable identity, the
``(device_kind, backend, jax_version, opt_level, op, dtype)`` tuple of a
:class:`LatencyRecord` key: a probe whose key is already in the DB is a
cache hit and is not run again (unless forced). Row names and logical keys
are those of ``repro.api.probes``, so a plan yields the same keys in both
packages.

* :class:`InstructionProbe` — one :class:`OpSpec` at one opt level via the
  dependent-chain slope (paper Table II).
* :class:`MemoryProbe` — the pointer chase at one working-set size (Fig. 6).
* :class:`ClockOverheadProbe` — the cost of the timed region itself (Fig. 5).
* :class:`KernelProbe` — the in-kernel dependent ALU chain (the paper's
  timed PTX block), through the ``alu_chain`` kernel.
* :class:`KernelChainProbe` — one registry :class:`OpSpec` as an in-kernel
  chain through the ``op_chain`` kernel (``inkernel.<row>``; plan name
  ``inkernel``).
* :class:`FusedKernelProbe` — one fused kernel (rmsnorm, flash_attention,
  flash_decode, mamba_scan) as a two-size workload slope.
* :class:`MemoryChaseProbe` — the pointer chase inside K3 at one
  working-set size (``inkernel.mem.<bytes>``; plan name
  ``memory-inkernel``): from shared memory up to the block's budget, from
  global memory above (paper Table IV / Fig. 6).
* :class:`ServingCostProbe` — one serving cell, the Engine's prefill or
  decode step priced from the DB's rows and timed (``serving.<phase>.<cell>``;
  plan name ``serving``).
* :class:`SloProbe` — one serving-SLO point: a seeded arrival trace through
  the DB-priced simulator and the engine's slot pool (``slo.r<rate>``; plan
  name ``slo``).
"""
from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Any, Callable, Mapping

import torch

from repro_torch import inkernel
from repro_torch.core import measure, membench
from repro_torch.core.chains import KERNEL_CHAIN_UNROLL, OpSpec, spec_by_name
from repro_torch.core.latency_db import LatencyDB, LatencyRecord
from repro_torch.core.optlevels import compile_at_level, o1_option_string
from repro_torch.core.timing import Measurement, Timer, sandwich_slope
from repro_torch.kernels.alu_chain import alu_chain, alu_chain_timed
from repro_torch.kernels.opchain import STEP_SASS
from repro_torch.utils import timestamp


@dataclasses.dataclass(frozen=True)
class ProbeContext:
    """Session-owned machinery handed to every probe run."""

    timer: Timer
    env: Mapping[str, str]              # device_kind / backend / jax_version
    clock_hz: float                     # what ``cycles`` count: the SM clock on
                                        # the card, the host pseudo-clock on the CPU
    baseline_ns: Callable[[str], float]  # per-level 1-cycle-class baseline
    kernel_baseline_ns: Callable[[], float]  # the same, inside op_chain
    device: torch.device
    adaptive: bool = False               # adaptive fidelity on: effective rep
                                         # counts ride in record notes
    db: LatencyDB | None = None          # the session's DB (what a serving
                                         # cell is priced against)
    compile_cache: Any = None            # CompileCache: the O3 chains'
                                         # compiles and their device code


class Probe:
    """One schedulable measurement. Subclasses set identity + implement run.

    Attributes
    ----------
    op: table row name (e.g. ``"fma.float32"``, ``"mem.chase.ws8192"``).
    opt_level: compilation level the probe measures under.
    dtype: dtype axis of the record key.
    category: table grouping.

    A probe implements :meth:`run`, or the split the session uses:
    :meth:`prepare` does everything compile-bound, :meth:`run_prepared` the
    timing, and :meth:`warm_tasks` names compiles a worker process can do
    ahead of both. The defaults route a probe that only implements
    :meth:`run` through the split.
    """

    op: str = ""
    opt_level: str = "O3"
    dtype: str = "float32"
    category: str = "uncategorized"

    def logical_key(self) -> tuple[str, str, str]:
        """Environment-independent identity, used for plan dedupe."""
        return (self.op, self.opt_level, self.dtype)

    def match_names(self) -> frozenset[str]:
        """Every name an op filter may address this probe by."""
        return frozenset((self.op,))

    def key(self, env: Mapping[str, str]) -> tuple:
        """Full cache key; identical layout to ``LatencyRecord.key()``."""
        return (env["device_kind"], env["backend"], env["jax_version"],
                self.opt_level, self.op, self.dtype)

    def run(self, ctx: ProbeContext) -> LatencyRecord:
        raise NotImplementedError

    def prepare(self, ctx: ProbeContext) -> Any:
        """Compile-bound half; None makes :meth:`run_prepared` call
        :meth:`run`."""
        return None

    def run_prepared(self, ctx: ProbeContext, prepared: Any) -> LatencyRecord:
        """Device-bound half: time what ``prepare`` built."""
        return self.run(ctx)

    def warm_tasks(self, device: torch.device) -> list[tuple[Callable, tuple]]:
        """``(function, args)`` pairs a worker process may run to fill the
        compile caches before :meth:`prepare` runs on ``device``; picklable."""
        return []

    # ------------------------------------------------------------------ util
    def _record(self, ctx: ProbeContext, m: Measurement, *, guard: int = 0,
                notes: str = "", baseline: float | None = None,
                clock: str | None = None) -> LatencyRecord:
        """Build the result record from a Measurement, netting out guards.

        ``baseline`` overrides the session's dispatch-level add baseline for
        probes whose guard ops run under another methodology (in-kernel).
        The notes end with the clock that timed the row (``clock``, by
        default the timer's); a slope taken at the widened retry's lengths
        says so (``retry_lens=n1-n2``). ``cycles`` counts at the session's
        ``clock_hz``; on the card that is the SM clock, and the notes name
        it (``cycles_at=sm_clock64@<MHz>``).
        """
        extra = []
        if ctx.adaptive:
            extra.append(f"reps_eff={m.n}")
        if m.retry_lens is not None:
            extra.append(f"retry_lens={m.retry_lens[0]}-{m.retry_lens[1]}")
        ns = max(m.median_ns, 0.0)
        base = (baseline if baseline is not None else ctx.baseline_ns(self.opt_level)) \
            if guard else 0.0
        net = ns - guard * base
        if net < 0.0:  # flag the clamp below: a wrong guard count or baseline
            extra.append("clamped=1")
        if ctx.device.type == "cuda":
            extra.append(f"cycles_at=sm_clock64@{ctx.clock_hz / 1e6:.0f}")
        extra.append(f"clock={clock or ctx.timer.clock}")
        return LatencyRecord(
            op=self.op, category=self.category, dtype=self.dtype,
            opt_level=self.opt_level, latency_ns=ns, mad_ns=m.mad_ns,
            cycles=ns * ctx.clock_hz / 1e9, guard=guard,
            net_latency_ns=max(net, 0.0), n_samples=m.n,
            measured_at=timestamp(), notes=" ".join([notes, *extra]).strip(),
            **ctx.env)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.op}@{self.opt_level})"


class InstructionProbe(Probe):
    """One registry OpSpec at one opt level (paper Table II row x column)."""

    def __init__(self, spec: OpSpec, opt_level: str = "O3"):
        self.spec = spec
        self.op = spec.name
        self.opt_level = opt_level
        self.dtype = spec.dtype
        self.category = spec.category

    def prepare(self, ctx: ProbeContext):
        return measure.prepare_op(self.spec, self.opt_level, ctx.device,
                                  cache=ctx.compile_cache, env=ctx.env)

    def warm_tasks(self, device: torch.device) -> list[tuple[Callable, tuple]]:
        if self.opt_level != "O3" or self.spec.kernel is not None:
            return []
        return [(measure.warm_chain, (self.spec.name, self.opt_level, n, str(device)))
                for n in reversed(measure._CHAIN_LENS[self.opt_level])]  # longest first

    def run_prepared(self, ctx: ProbeContext, prepared) -> LatencyRecord:
        m = measure.run_prepared_op(prepared, ctx.timer)
        on_card = ctx.device.type == "cuda"
        o1 = f"o1={o1_option_string()}" if self.opt_level == "O1" else ""
        # on the card an O1 chain replays its graph's kernels from one CUDA
        # graph (measure.GraphedChain); O0 and O3 launch on the stream
        graph = self.opt_level == "O1" and on_card
        if self.spec.kernel is None:
            opts = (measure.inductor_options(self.spec, ctx.device)
                    if self.opt_level == "O3" else None)
            step = measure.HALF_O3_STEP_SASS.get(self.spec.name) if opts and on_card else None
            notes = " ".join(filter(None, (
                self.spec.notes,
                opts and "inductor=" + ",".join(f"{k}:{v}" for k, v in sorted(opts.items())),
                step and f"step_sass={step}", graph and "launch=cuda_graph", o1)))
            return self._record(ctx, m, guard=self.spec.guard, notes=notes)
        # the guard runs inside the same launch: net it with the in-kernel
        # baseline, never with an eager dispatch
        launch = ("per-step" + (",cuda_graph" if graph else "")
                  if self.opt_level in ("O0", "O1") else
                  f"per-chain unroll={KERNEL_CHAIN_UNROLL}")
        step = STEP_SASS.get(self.spec.kernel) if on_card else None
        notes = " ".join(filter(None, (
            self.spec.notes, f"kernel=op_chain.{self.spec.kernel}",
            f"launch={launch}", "guard_base=op_chain.add", step and f"step_sass={step}", o1)))
        return self._record(ctx, m, guard=self.spec.guard, notes=notes,
                            baseline=ctx.kernel_baseline_ns() if self.spec.guard else None)


class ClockOverheadProbe(Probe):
    """Cost of the timed region itself at one opt level (paper Fig. 5)."""

    category = "overhead"

    def __init__(self, opt_level: str = "O3"):
        self.op = "clock_overhead"
        self.opt_level = opt_level

    def prepare(self, ctx: ProbeContext):
        x = torch.ones((), dtype=torch.float32, device=ctx.device)
        fn = compile_at_level(lambda v: v, self.opt_level, name="clock_overhead_null")
        measure._first_call(fn, x)
        return (fn, x)

    def run_prepared(self, ctx: ProbeContext, prepared) -> LatencyRecord:
        fn, x = prepared
        m = ctx.timer.time_callable(fn, x, reps=measure._REPS[self.opt_level])
        o1 = f" o1={o1_option_string()}" if self.opt_level == "O1" else ""
        return self._record(ctx, m, notes="null timed region (Fig. 5 analog)" + o1)


class MemoryProbe(Probe):
    """Dependent pointer chase at one working-set size (paper Fig. 6 point),
    one launch of K3's global path per timed chase, under
    ``membench.level_rule`` (the notes say how: ``warm=<steps>`` walked
    untimed in each launch, ``carry=1`` for a start carried from launch to
    launch after an untimed lap).

    Non-default chase parameters are part of the op name (and therefore the
    cache key): a short-chase point never satisfies a lookup for the
    standard sweep.
    """

    category = "memory"
    dtype = "int32"
    DEFAULT_STEPS = (2048, 6144)
    DEFAULT_LINE_BYTES = 64

    def __init__(self, working_set_bytes: int,
                 line_bytes: int = DEFAULT_LINE_BYTES,
                 steps: tuple[int, int] = DEFAULT_STEPS):
        self.working_set_bytes = int(working_set_bytes)
        self.line_bytes = line_bytes
        self.steps = tuple(steps)
        self.base_op = f"mem.chase.ws{self.working_set_bytes}"
        self.op = self.base_op
        if self.steps != self.DEFAULT_STEPS:
            self.op += f".s{self.steps[0]}-{self.steps[1]}"
        if self.line_bytes != self.DEFAULT_LINE_BYTES:
            self.op += f".line{self.line_bytes}"

    def match_names(self) -> frozenset[str]:
        # "mem" is the whole-family base row: ``--ops mem`` keeps every rung
        return frozenset((self.op, self.base_op, "mem"))

    def prepare(self, ctx: ProbeContext):
        return membench.prepare_chase(self.working_set_bytes,
                                      line_bytes=self.line_bytes,
                                      steps=self.steps, device=ctx.device)

    def run_prepared(self, ctx: ProbeContext, prepared) -> LatencyRecord:
        pt = membench.run_prepared_chase(prepared, ctx.timer)
        m = Measurement(median_ns=pt.latency_ns, mad_ns=0.0,
                        min_ns=pt.latency_ns, n=ctx.timer.reps)
        return self._record(
            ctx, m, notes=f"cold_ns={pt.cold_latency_ns:.3f} "
                          f"stride={pt.stride_bytes} warm={prepared.warm} "
                          f"carry={int(prepared.carry)}")


class KernelProbe(Probe):
    """In-kernel dependent ALU chain, slope-timed.

    The paper's timed PTX block. On the card the clock is the paper's own
    sandwich: each thread of the tile reads the SM's ``%clock64`` around
    its chain (``alu_chain_timed``); a launch counts the median of the
    tile's cycles, a length the minimum over the reps, and the slope in
    cycles (:func:`~repro_torch.core.timing.sandwich_slope`) becomes ns at
    the session's SM clock (``ProbeContext.clock_hz``), which the row's
    notes name (``clock=sm_clock64@<MHz>``). On the CPU the whole ``alu_chain`` call is
    the timed region on the host clock and the two-length slope cancels its
    overhead.
    """

    category = "kernel"
    DEFAULT_LENS = (8, 64)
    DEFAULT_SHAPE = (8, 128)

    def __init__(self, kernel_op: str = "fma",
                 lens: tuple[int, int] = DEFAULT_LENS,
                 shape: tuple[int, int] = DEFAULT_SHAPE, reps: int = 5):
        self.kernel_op = kernel_op
        self.lens = tuple(lens)
        self.shape = tuple(shape)
        self.reps = reps
        # non-default chain lengths / tile are a different experiment: part
        # of the cache identity, like MemoryProbe.steps
        self.base_op = f"kernel.alu_chain.{kernel_op}"
        self.op = self.base_op
        if self.lens != self.DEFAULT_LENS:
            self.op += f".l{self.lens[0]}-{self.lens[1]}"
        if self.shape != self.DEFAULT_SHAPE:
            self.op += f".t{self.shape[0]}x{self.shape[1]}"

    def match_names(self) -> frozenset[str]:
        return frozenset((self.op, self.base_op, self.kernel_op))

    def prepare(self, ctx: ProbeContext):
        x = torch.full(self.shape, 1.0, dtype=torch.float32, device=ctx.device)
        a = torch.full(self.shape, 0.5, dtype=torch.float32, device=ctx.device)

        chain = alu_chain_timed if ctx.device.type == "cuda" else alu_chain

        def fn_by_len(n: int):
            return lambda x, a: chain(x, a, n=n, op=self.kernel_op)

        for n in self.lens:  # the first launch builds and loads the kernel
            measure._first_call(fn_by_len(n), x, a)
        return (fn_by_len, x, a)

    def run_prepared(self, ctx: ProbeContext, prepared) -> LatencyRecord:
        fn_by_len, x, a = prepared
        if ctx.device.type == "cpu":
            m = ctx.timer.slope(fn_by_len, *self.lens, x, a, reps=self.reps)
            return self._record(
                ctx, m, notes=f"plain alu_chain tile={self.shape} lens={self.lens}")
        m = sandwich_slope(lambda n: lambda: fn_by_len(n)(x, a)[1], *self.lens,
                           clock_hz=ctx.clock_hz, reps=self.reps,
                           warmup=max(ctx.timer.warmup, 1))
        return self._record(
            ctx, m, notes=f"cuda alu_chain tile={self.shape} lens={self.lens}",
            clock=f"sm_clock64@{ctx.clock_hz / 1e6:.0f}")


class KernelChainProbe(Probe):
    """One registry :class:`OpSpec` as an in-kernel chain (the paper's
    in-pipeline measurement, ``repro_torch.inkernel``), through K2.

    Shares the record schema and category with the row's dispatch-level
    :class:`InstructionProbe`, under the op name ``inkernel.<name>``: both
    rows live in one LatencyDB, which ``LatencyDB.compare_markdown`` pairs
    up. ``opt_level`` is ``"O3"``: the kernel is always compiled, there is
    no eager analog. Non-default chain lengths or tiles are another
    experiment and part of the op name (``.l<n1>-<n2>``, ``.t<R>x<C>``),
    as in the JAX package; ``lens=None`` means ``inkernel.INKERNEL_LENS``.

    On the card the chain is timed by K2's clock sandwich (each thread
    reads ``%clock64`` around its chain; the slope in SM cycles, converted
    at the session's SM clock); on the CPU the plain chain on the host
    clock. Guard netting stays in-method: the ``guard x add`` subtraction
    uses an *in-kernel* add baseline, the ``add`` row's chain measured the
    same way at the same lengths (once per timer and lengths), never the
    dispatch-level baseline nor ``Session.kernel_baseline_ns`` (the table2
    rows' events-timed one at (64, 512)).
    """

    # per-(timer, lens) in-kernel add baseline; weak keys, so that a
    # session's timer does not outlive it
    _baselines: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def __init__(self, spec: OpSpec, lens: tuple[int, int] | None = None,
                 shape: tuple[int, int] | None = None, reps: int = 5):
        if not inkernel.supported(spec):
            raise ValueError(f"spec {spec.name!r} cannot lower in-kernel")
        self.spec = spec
        self.lens = tuple(lens) if lens is not None else tuple(inkernel.INKERNEL_LENS)
        self.shape = tuple(shape) if shape is not None else None
        self.reps = reps
        self.opt_level = "O3"
        self.dtype = spec.dtype
        self.category = spec.category
        self.base_op = f"inkernel.{spec.name}"
        self.op = self.base_op
        if self.lens != tuple(inkernel.INKERNEL_LENS):
            self.op += f".l{self.lens[0]}-{self.lens[1]}"
        if self.shape is not None:
            self.op += f".t{self.shape[0]}x{self.shape[1]}"

    def match_names(self) -> frozenset[str]:
        # the full name, the unsuffixed in-kernel name, and the dispatch
        # row's name (``--ops add`` keeps ``inkernel.add``)
        return frozenset((self.op, self.base_op, self.spec.name))

    def _measure(self, ctx: ProbeContext, prepared) -> Measurement:
        # on the card the session's SM clock converts the sandwich's cycles
        return inkernel.run_prepared_inkernel(prepared, ctx.timer, clock_hz=ctx.clock_hz)

    def _inkernel_baseline_ns(self, ctx: ProbeContext) -> float:
        """The in-kernel 1-cycle-class baseline: the ``add`` row's (add ^ xor)
        chain in-kernel at the same lengths, / (1 + its guard)."""
        per_timer = KernelChainProbe._baselines.setdefault(ctx.timer, {})
        if self.lens not in per_timer:
            base = spec_by_name("add")
            prepared = inkernel.prepare_inkernel(base, lens=self.lens, device=ctx.device,
                                                 reps=self.reps)
            m = self._measure(ctx, prepared)
            per_timer[self.lens] = max(m.median_ns, 0.0) / (1 + base.guard)
        return per_timer[self.lens]

    def prepare(self, ctx: ProbeContext):
        return inkernel.prepare_inkernel(self.spec, lens=self.lens, shape=self.shape,
                                         device=ctx.device, reps=self.reps)

    def run_prepared(self, ctx: ProbeContext, prepared) -> LatencyRecord:
        m = self._measure(ctx, prepared)
        baseline = self._inkernel_baseline_ns(ctx) if self.spec.guard else None
        tile = self.shape or inkernel.default_tile(self.spec.dtype)
        layout = f"lens={self.lens[0]}-{self.lens[1]} tile={tile[0]}x{tile[1]}"
        if ctx.device.type == "cpu":
            return self._record(ctx, m, guard=self.spec.guard, baseline=baseline,
                                notes=f"plain op_chain {layout}")
        step = STEP_SASS.get(self.spec.name)
        notes = " ".join(filter(None, (
            f"cuda op_chain clock64 sandwich {layout} {inkernel.tile_layout(tile)}",
            self.spec.guard and "guard_base=inkernel.add", step and f"step_sass={step}")))
        return self._record(ctx, m, guard=self.spec.guard, baseline=baseline, notes=notes,
                            clock=f"sm_clock64@{ctx.clock_hz / 1e6:.0f}")


class FusedKernelProbe(Probe):
    """One fused kernel as a two-size workload slope (``inkernel.fused.<name>``
    rows; plan name ``fused``).

    The same netting algebra as :class:`KernelProbe`, with the chain length
    replaced by a workload-unit count (KV blocks for the attention kernels,
    sequence chunks for the SSM scan, row blocks for rmsnorm): two sizes
    share the launch path and tile shapes, so the slope is the per-unit
    kernel cost. The bytes a unit adds (``unit_bytes=``) ride in the notes.
    """

    category = "kernel"

    def __init__(self, name: str, lens: tuple[int, int] | None = None,
                 reps: int = 5):
        if name not in inkernel.FUSED_KERNELS:
            raise ValueError(f"unknown fused kernel {name!r}; known: "
                             f"{', '.join(inkernel.FUSED_KERNELS)}")
        self.name = name
        self.lens = tuple(lens) if lens is not None else tuple(inkernel.FUSED_LENS)
        self.reps = reps
        self.base_op = f"inkernel.fused.{name}"
        self.op = self.base_op
        if self.lens != tuple(inkernel.FUSED_LENS):
            self.op += f".l{self.lens[0]}-{self.lens[1]}"

    def match_names(self) -> frozenset[str]:
        return frozenset((self.op, self.base_op, self.name))

    def prepare(self, ctx: ProbeContext):
        return inkernel.prepare_fused(self.name, lens=self.lens, device=ctx.device,
                                      reps=self.reps)

    def run_prepared(self, ctx: ProbeContext, prepared) -> LatencyRecord:
        m = inkernel.run_prepared_fused(prepared, ctx.timer)
        route = "cuda" if ctx.device.type == "cuda" else "plain"
        return self._record(
            ctx, m, notes=f"{route} fused kernel lens={self.lens[0]}-{self.lens[1]} "
                          f"unit_bytes={inkernel.unit_bytes(self.name)}")


class MemoryChaseProbe(Probe):
    """The pointer chase inside K3 at one working-set size: the memory rows of
    the in-pipeline method (paper Table IV / Fig. 6), ``inkernel.mem.<bytes>``.

    Timed like :class:`KernelChainProbe`: on the card by K3's clock sandwich
    (the slope between :data:`inkernel.CHASE_LENS` in SM cycles, converted
    at the session's SM clock), on the CPU the plain chase on the host
    clock. The path is picked by the ring's footprint: shared memory up to
    ``kernels.chase.SMEM_BUDGET_BYTES`` (the VMEM path's counterpart),
    global memory above (the ANY path's); the notes carry it
    (``space=smem|global``), the working set, the line and
    ``membench.level_rule``'s ``warm=`` and ``carry=``
    (:func:`membench.chasepoint_from_record` reads them back).

    Op name ``inkernel.mem.<bytes>``, ``opt_level`` ``"O3"``, as in the JAX
    package; non-default lengths, line padding or a *forced* path are
    another experiment and suffix it (``.l<a>-<b>``, ``.line<n>``,
    ``.smem`` / ``.global``).
    """

    category = "memory"
    dtype = "int32"
    DEFAULT_LINE_BYTES = 64

    def __init__(self, working_set_bytes: int, line_bytes: int = DEFAULT_LINE_BYTES,
                 lens: tuple[int, int] | None = None, memory_space: str | None = None,
                 reps: int = 5):
        self.working_set_bytes = int(working_set_bytes)
        self.line_bytes = line_bytes
        self.lens = tuple(lens) if lens is not None else tuple(inkernel.CHASE_LENS)
        self.memory_space = memory_space  # None: by footprint
        self.reps = reps
        self.opt_level = "O3"
        self.base_op = f"inkernel.mem.{self.working_set_bytes}"
        self.host_op = f"mem.chase.ws{self.working_set_bytes}"
        self.op = self.base_op
        if self.lens != tuple(inkernel.CHASE_LENS):
            self.op += f".l{self.lens[0]}-{self.lens[1]}"
        if self.line_bytes != self.DEFAULT_LINE_BYTES:
            self.op += f".line{self.line_bytes}"
        if memory_space is not None:
            self.op += f".{memory_space}"

    def match_names(self) -> frozenset[str]:
        # the full name, the unsuffixed in-kernel row, the host twin
        # (``--ops mem.chase.ws8192`` keeps both sides of the pairing) and
        # the whole family ``mem``
        return frozenset((self.op, self.base_op, self.host_op, "mem"))

    def prepare(self, ctx: ProbeContext):
        return inkernel.prepare_chase(self.working_set_bytes, line_bytes=self.line_bytes,
                                      lens=self.lens, memory_space=self.memory_space,
                                      reps=self.reps, device=ctx.device)

    def run_prepared(self, ctx: ProbeContext, prepared) -> LatencyRecord:
        m, space = inkernel.run_prepared_chase(prepared, ctx.timer, clock_hz=ctx.clock_hz)
        notes = (f"chase ws={self.working_set_bytes} line={self.line_bytes} space={space} "
                 f"lens={self.lens[0]}-{self.lens[1]} warm={prepared.warm} "
                 f"carry={int(prepared.carry)}")
        if ctx.device.type == "cpu":
            return self._record(ctx, m, notes=f"plain {notes}")
        return self._record(ctx, m, notes=f"cuda {notes}",
                            clock=f"sm_clock64@{ctx.clock_hz / 1e6:.0f}")


def serving_tiny_config():
    """The model the serving cells characterize by default (the JAX
    package's): small enough for a CPU test, two layers deep."""
    from repro_torch.models.config import ModelConfig, Runtime

    cfg = ModelConfig(name="serving-tiny", family="dense", n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      vocab_size=128, param_dtype="float32",
                      compute_dtype="float32")
    rt = Runtime(remat=False, xent_chunk=16, moe_groups=1)
    return cfg, rt


# the models the serving probes built (weights from seed 0), by (config,
# device), held only while a prepared cell uses one: the cells of one run
# share one build
_SERVED_MODELS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _served_model(cfg, device: torch.device):
    from repro_torch.models import transformer

    key = (cfg, str(device))
    model = _SERVED_MODELS.get(key)
    if model is None:
        model = transformer.init_lm(cfg, seed=0, device=device)
        _SERVED_MODELS[key] = model
    return model


class ServingCostProbe(Probe):
    """Price and measure one serving cell: the Engine's prefill or decode
    step at ``(batch, prompt_len)``, where the measured rows of the DB meet
    the model side, the paper's stated purpose.

    ``prepare`` builds the model from seed 0 on the session's device (the
    cells of one run share one build), takes the step from
    :meth:`Engine.lower_prefill` / :meth:`Engine.lower_decode` and records
    what it issues, once and untimed (:func:`hlo_analysis.record_ops`).
    ``run_prepared`` merges the DB from its path, prices the record with the
    :class:`~repro_torch.core.perfmodel.RecordLatencyEstimator` against the
    rows of the session's environment only, then times the same eager step
    with the session's timer. The record's ``latency_ns`` is the
    **measured** time; the prediction and its digest ride in the notes
    (``servingpoint_from_record`` reads them back), with ``exec=eager``: the
    JAX package times a compiled executable, the port the eager step it
    priced. On the card the events are recorded around the step on an idle
    stream (``Timer.time_callable(lead=False)``, notes ``lead=none``): the
    step's time as served, its host gaps included. The last record and report stay on the probe
    (``last_record``, ``last_report``).

    Op names ``serving.prefill.b<B>p<L>`` / ``serving.decode.b<B>p<L>``,
    ``opt_level`` ``"O3"``; a non-default cache size suffixes ``.c<len>``
    and a non-default model ``.<cfg.name>``, as in the JAX package.
    """

    category = "serving"

    def __init__(self, phase: str, batch: int, prompt_len: int,
                 cfg=None, rt=None, max_len: int | None = None, reps: int = 5):
        if phase not in ("prefill", "decode"):
            raise ValueError(f"phase must be prefill|decode, got {phase!r}")
        default_cfg, default_rt = serving_tiny_config()
        self.phase = phase
        self.batch = int(batch)
        self.prompt_len = int(prompt_len)
        self.cfg = cfg if cfg is not None else default_cfg
        self.rt = rt if rt is not None else default_rt
        self.max_len = max_len
        self.reps = reps
        self.opt_level = "O3"
        self.dtype = self.cfg.compute_dtype
        self.base_op = f"serving.{phase}.b{self.batch}p{self.prompt_len}"
        self.op = self.base_op
        if max_len is not None:
            self.op += f".c{int(max_len)}"
        if self.cfg.name != default_cfg.name:
            self.op += f".{self.cfg.name}"
        self.last_record = None
        self.last_report = None

    def match_names(self) -> frozenset[str]:
        # the full cell name, the phase family (``--ops serving.decode``)
        # and the whole family ``serving``
        return frozenset((self.op, self.base_op, f"serving.{self.phase}", "serving"))

    def prepare(self, ctx: ProbeContext):
        from repro_torch.core import hlo_analysis
        from repro_torch.serving.engine import Engine

        eng = Engine(_served_model(self.cfg, ctx.device), self.rt)
        if self.phase == "prefill":
            step, args = eng.lower_prefill(self.batch, self.prompt_len)
            cache_len = 0                     # prefill builds, never reads, a cache
        else:
            cache_len = self.max_len if self.max_len is not None else eng.max_len
            step, args = eng.lower_decode(self.batch, self.prompt_len, cache_len)
        self.last_record = hlo_analysis.record_ops(step, *args)
        return (step, args, self.last_record, cache_len)

    def run_prepared(self, ctx: ProbeContext, prepared) -> LatencyRecord:
        from repro_torch.core.perfmodel import RecordLatencyEstimator

        step, args, record, cache_len = prepared
        if ctx.db is not None and ctx.db.path and os.path.exists(ctx.db.path):
            # rows another run flushed to the DB's path since it was loaded
            ctx.db.merge(LatencyDB(ctx.db.path))
        est = RecordLatencyEstimator(ctx.db if ctx.db is not None else LatencyDB(),
                                     opt_level=self.opt_level, filters=dict(ctx.env))
        report = self.last_report = est.estimate(record)
        # a served step launches more kernels than the card's queue holds
        # behind a lead, and its decode copies from host memory: timed on an
        # idle stream, as served (``lead=none``)
        m = ctx.timer.time_callable(step, *args, reps=self.reps, lead=False)
        notes = (f"phase={self.phase} batch={self.batch} "
                 f"prompt={self.prompt_len} cache={cache_len} "
                 f"model={self.cfg.name} "
                 f"predicted_ns={report.total_ns:.3f} "
                 f"compute_ns={report.compute_ns:.3f} "
                 f"memory_ns={report.memory_ns:.3f} "
                 f"coverage={report.coverage:.4f} "
                 f"bound={report.bound} exec=eager"
                 + (" lead=none" if ctx.device.type == "cuda" else ""))
        return self._record(ctx, m, notes=notes)


class SloProbe(Probe):
    """One serving-SLO point: a seeded arrival trace at one rate, replayed
    through *both* sides of ``repro_torch.traffic`` — the LatencyDB-priced
    simulator (predicted) and the engine's continuous-batching slot pool
    (measured) — and aggregated into exact-rank TTFT/TPOT/e2e percentiles.

    The record's ``latency_ns`` is the **measured p50 TTFT** (the headline
    SLO number); every other percentile, both predicted and measured, plus
    goodput and the estimator's coverage, ride in the notes and are parsed
    back by :func:`~repro_torch.core.perfmodel.slopoint_from_record`. The
    measured side is the eager engine's host wall clock to device
    completion, which the notes say (``exec=eager clock=wall``). Like
    :class:`ServingCostProbe` this is a consumer probe: it prices against
    ``ctx.db``, so schedule it *after* the instruction/memory rows
    (``Plan.slo`` does).

    ``prepare`` only builds the model from seed 0 on the session's device
    (``_served_model``), which the session holds until its run ends, so the
    points of one run share one build (the JAX package builds it in each
    point); ``run`` does the rest, pricing included, as it consumes rows
    sibling probes may still be flushing.

    Op name ``slo.r<rate>``; a non-default trace shape (request count, slot
    count, seed, arrival process), cache size or model is a different
    experiment and suffixes the cache identity, as in the JAX package.
    """

    category = "slo"
    DEFAULT_N = 12
    DEFAULT_SLOTS = 4

    def __init__(self, rate_rps: float, n_requests: int = DEFAULT_N,
                 n_slots: int = DEFAULT_SLOTS, seed: int = 0,
                 cfg=None, rt=None, max_len: int | None = None,
                 process: str = "poisson", burstiness_cv: float = 1.0,
                 prompt_len: tuple[int, int] = (4, 8),
                 max_new: tuple[int, int] = (4, 8)):
        default_cfg, default_rt = serving_tiny_config()
        self.rate_rps = float(rate_rps)
        self.n_requests = int(n_requests)
        self.n_slots = int(n_slots)
        self.seed = int(seed)
        self.cfg = cfg if cfg is not None else default_cfg
        self.rt = rt if rt is not None else default_rt
        self.max_len = max_len
        self.process = process
        self.burstiness_cv = float(burstiness_cv)
        self.prompt_len = tuple(prompt_len)
        self.max_new = tuple(max_new)
        self.opt_level = "O3"
        self.dtype = self.cfg.compute_dtype
        self.base_op = f"slo.r{self.rate_rps:g}"
        self.op = self.base_op
        if (self.n_requests, self.n_slots) != (self.DEFAULT_N, self.DEFAULT_SLOTS):
            self.op += f".n{self.n_requests}s{self.n_slots}"
        if self.seed != 0:
            self.op += f".seed{self.seed}"
        if self.process != "poisson":
            self.op += f".{self.process}{self.burstiness_cv:g}"
        if max_len is not None:
            self.op += f".c{int(max_len)}"
        if self.cfg.name != default_cfg.name:
            self.op += f".{self.cfg.name}"
        self.last_result = None

    def match_names(self) -> frozenset[str]:
        # the full point name, the rate family and the whole family ``slo``
        return frozenset((self.op, self.base_op, "slo"))

    def trace_config(self):
        """The (deterministic) trace recipe this point replays."""
        from repro_torch.traffic.traces import TraceConfig

        return TraceConfig(n_requests=self.n_requests, rate_rps=self.rate_rps,
                           seed=self.seed, process=self.process,
                           burstiness_cv=self.burstiness_cv,
                           prompt_len=self.prompt_len, max_new=self.max_new,
                           vocab_size=self.cfg.vocab_size)

    def prepare(self, ctx: ProbeContext):
        return _served_model(self.cfg, ctx.device)

    def run(self, ctx: ProbeContext) -> LatencyRecord:
        from repro_torch.serving.engine import Engine
        from repro_torch.traffic.simulate import run_slo_point
        from repro_torch.traffic.traces import generate_trace

        eng = Engine(_served_model(self.cfg, ctx.device), self.rt)
        trace = generate_trace(self.trace_config())
        db = ctx.db if ctx.db is not None else LatencyDB()
        if db.path and os.path.exists(db.path):
            # rows another run flushed to the DB's path since it was loaded
            db.merge(LatencyDB(db.path))
        pred, meas, coverage = run_slo_point(
            eng, db, trace, n_slots=self.n_slots, max_len=self.max_len,
            opt_level=self.opt_level, filters=dict(ctx.env))
        self.last_result = (pred, meas, coverage)
        m = Measurement(median_ns=meas.ttft_ns[50.0], mad_ns=0.0,
                        min_ns=meas.ttft_ns[50.0], n=self.n_requests)
        notes = (f"rate={self.rate_rps:g} n={self.n_requests} "
                 f"slots={self.n_slots} seed={self.seed} "
                 f"model={self.cfg.name} "
                 f"pred_ttft_p50_ns={pred.ttft_ns[50.0]:.1f} "
                 f"pred_ttft_p99_ns={pred.ttft_ns[99.0]:.1f} "
                 f"pred_tpot_p50_ns={pred.tpot_ns[50.0]:.1f} "
                 f"pred_tpot_p99_ns={pred.tpot_ns[99.0]:.1f} "
                 f"pred_e2e_p50_ns={pred.e2e_ns[50.0]:.1f} "
                 f"pred_goodput_tok_s={pred.goodput_tok_s:.3f} "
                 f"meas_ttft_p50_ns={meas.ttft_ns[50.0]:.1f} "
                 f"meas_ttft_p99_ns={meas.ttft_ns[99.0]:.1f} "
                 f"meas_tpot_p50_ns={meas.tpot_ns[50.0]:.1f} "
                 f"meas_tpot_p99_ns={meas.tpot_ns[99.0]:.1f} "
                 f"meas_e2e_p50_ns={meas.e2e_ns[50.0]:.1f} "
                 f"meas_goodput_tok_s={meas.goodput_tok_s:.3f} "
                 f"coverage={coverage:.4f} exec=eager")
        return self._record(ctx, m, notes=notes, clock="wall")
