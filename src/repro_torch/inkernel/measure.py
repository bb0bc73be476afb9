"""Slope extraction for the in-kernel chains, the in-kernel pointer chase
and the fused kernels (``repro/inkernel/measure.py``).

Two kernels that differ only in chain length (or workload size) share the
launch path and the tile, so ``(T(n2) - T(n1)) / (n2 - n1)`` is the cost of
a step (or a unit). The fused kernels and, on the CPU, the chains are timed
around the whole call with :meth:`Timer.slope`. On the card a chain is
timed the paper's way, inside the kernel: K2's timed form reads the SM's
``%clock64`` around each thread's chain, and
:func:`~repro_torch.core.timing.sandwich_slope` takes the slope in SM
cycles, converted to ns at the SM clock; neither the host clock nor bare
events resolve 56 steps of a 2 ns op. The in-kernel chase is timed the same
way, through K3's timed form, at :data:`CHASE_LENS`, under
``core.membench.level_rule``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.chains import OpSpec
from repro_torch.core.measure import retry_lens_for
from repro_torch.core.membench import build_ring, lap_steps, level_rule
from repro_torch.core.timing import Measurement, Timer, sandwich_slope, sm_clock_hz
from repro_torch.inkernel.factory import build_chain, tiles
from repro_torch.inkernel.fused import FUSED_LENS, build_fused
from repro_torch.kernels.chase import chase, chase_timed, resolve_memory_space
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.opchain import op_chain_timed
from repro_torch.utils import block

# The in-kernel chains' two lengths, as in the JAX package: 8 and 64 steps
# put 56 steps of the op between them, and K2's timed form is straight-line
# at both (TIMED_LENS).
INKERNEL_LENS = (8, 64)

# The in-kernel chase's two step counts, as in the JAX package: 128 dependent
# loads between them, and K3's timed form is straight-line at both.
CHASE_LENS = (64, 192)


@dataclasses.dataclass
class PreparedKernel:
    """Built two-length kernel callables plus their slope parameters: the
    build half of an in-kernel chain or fused probe, consumed by
    :func:`run_prepared_inkernel` / :func:`run_prepared_fused`.

    A chain's callables take ``args`` (the carry and operand tiles); on the
    card (``sandwich``) each returns its threads' SM cycles. A fused
    kernel's callables close over their own workload (the two sizes have
    different input shapes), so ``args`` is empty and ``Timer.slope``
    times zero-argument thunks."""

    lens: tuple[int, int]
    reps: int | None
    args: tuple = ()
    retry_lens: tuple[int, int] | None = None
    sandwich: bool = False
    memory_space: str = ""          # chase only: the path K3 runs
    warm: int = 0                   # chase only: level_rule's
    carry: bool = False
    lap: Callable[[], object] | None = None  # chase only: the untimed lap of a carried ring
    _fns: dict[int, Callable] = dataclasses.field(default_factory=dict)
    _build: Callable[[int], Callable] | None = None

    def fn_by_len(self, n: int) -> Callable:
        """Memoized callable; the widened retry size builds lazily."""
        if n not in self._fns:
            self._fns[n] = self._build(n)
        return self._fns[n]


def prepare_fused(name: str, lens: tuple[int, int] | None = None,
                  device: str | torch.device | None = None,
                  reps: int | None = None) -> PreparedKernel:
    """Build a fused kernel's workload at both sizes on ``device`` (default
    ``cuda:0``) and run each once, which builds and loads the kernel; no
    timing."""
    device = resolve_device(device)
    lens = tuple(lens or FUSED_LENS)

    def build(n: int) -> Callable:
        fn, args = build_fused(name, n, device)
        block(fn(*args))
        return functools.partial(fn, *args)

    prepared = PreparedKernel(lens=lens, reps=reps, _build=build)
    prepared.fn_by_len(lens[0])
    prepared.fn_by_len(lens[1])
    return prepared


def run_prepared_fused(prepared: PreparedKernel,
                       timer: Timer | None = None) -> Measurement:
    """Time a prepared fused kernel: per-workload-unit latency slope (a
    non-positive slope is retried once at a widened spread, then raises
    ``NoisySlopeError``)."""
    timer = timer or Timer()
    return timer.slope(prepared.fn_by_len, *prepared.lens, reps=prepared.reps)


def measure_fused_full(name: str, lens: tuple[int, int] | None = None,
                       timer: Timer | None = None,
                       reps: int | None = None) -> Measurement:
    """Per-unit latency of one fused kernel (KV block / chunk / row block) on
    the timer's device. Serial form of
    ``run_prepared_fused(prepare_fused(...))``."""
    timer = timer or Timer()
    return run_prepared_fused(
        prepare_fused(name, lens, device=timer.device, reps=reps), timer)


@functools.cache
def unit_bytes(name: str) -> int:
    """Bytes that the kernel's inputs and output grow by per workload unit,
    each tensor counted once (the rule of ``repro.audit.dataflow``'s
    signature). Computed from the CPU workload at the two sizes."""
    n1, n2 = FUSED_LENS
    total = []
    for n in (n1, n2):
        fn, args = build_fused(name, n, "cpu")
        total.append(sum(t.nbytes for t in (*args, fn(*args))))
    return (total[1] - total[0]) // (n2 - n1)


def prepare_chase(working_set_bytes: int, line_bytes: int = 64,
                  lens: tuple[int, int] = CHASE_LENS,
                  memory_space: str | None = None, reps: int | None = None,
                  device: str | torch.device | None = None) -> PreparedKernel:
    """Build the ring on ``device`` (default ``cuda:0``) and run the chase at
    both lengths once, which builds and loads K3; no timing. The path is
    ``memory_space``, or the ring's footprint's when None. On the card the
    callables are K3's timed form and return its cycles; on the CPU the
    plain chase. Both follow ``core.membench.level_rule``: a ring that fits
    L1 walks a lap untimed in each launch, a larger one carries its start
    (the callables chase from, and write back to, ``args[1]``) after an
    untimed lap (``PreparedKernel.lap``) just before timing.

    On the CPU the host clock times the whole call, where K3's timed form
    reads its first clock after the warm lap. So the plain chase walks the
    warm lap here, once, and the callables chase on from where it ended
    (``args[1]``): the same ``p`` at the end, and only the timed steps in
    the timed region. With the lap inside, the 128 steps between the two
    lengths were 11 % of a 64 KiB ring's call (1088 against 1216 loads),
    less than the host's slow stretches, and the slope came out
    non-positive in about one run in eight under a loaded host."""
    device = resolve_device(device)
    ring, start = build_ring(working_set_bytes, line_bytes, device=device)
    space = resolve_memory_space(ring, memory_space)
    warm, carry = level_rule(ring.numel() * 4, line_bytes)
    sandwich = device.type == "cuda"
    if not sandwich and warm:
        start = chase(ring, start, steps=warm, memory_space=space)
    timed_warm = warm if sandwich else 0

    def build(n: int) -> Callable:
        kw = dict(steps=n, warm=timed_warm, memory_space=space)
        if sandwich:
            fn = lambda r, s: chase_timed(r, s, **kw, out=s if carry else None)[1]  # noqa: E731
        else:
            fn = lambda r, s: chase(r, s, **kw, out=s if carry else None)  # noqa: E731
        block(fn(ring, start))
        return fn

    lap = lap_steps(ring.numel() * 4, line_bytes)
    prepared = PreparedKernel(
        lens=tuple(lens), reps=reps, args=(ring, start), sandwich=sandwich,
        memory_space=space, warm=warm, carry=carry, _build=build,
        lap=(lambda: block(chase(ring, start, steps=lap, memory_space=space, out=start)))
        if carry else None)
    prepared.fn_by_len(prepared.lens[0])
    prepared.fn_by_len(prepared.lens[1])
    return prepared


def run_prepared_chase(prepared: PreparedKernel, timer: Timer | None = None,
                       clock_hz: float | None = None) -> tuple[Measurement, str]:
    """Time a prepared chase: ``(measurement, memory_space)``. A carried
    ring's untimed lap runs first. On the card the slope of K3's clock
    sandwich, converted at ``clock_hz`` (default: :func:`sm_clock_hz`,
    sampled now), a non-positive slope raising ``NoisySlopeError``; on the
    CPU :meth:`Timer.slope` around the plain chase, the lengths' samples
    interleaved."""
    timer = timer or Timer()
    if prepared.lap is not None:
        with timer.device_ctx():
            prepared.lap()
    if prepared.sandwich:
        hz = clock_hz or sm_clock_hz(timer.device)
        m = sandwich_slope(
            lambda n: functools.partial(prepared.fn_by_len(n), *prepared.args),
            *prepared.lens, clock_hz=hz, reps=prepared.reps or 5,
            warmup=max(timer.warmup, 1))
    else:
        # the two lengths' samples alternate, so that a slow stretch of the
        # host slows both
        m = timer.slope(prepared.fn_by_len, *prepared.lens, *prepared.args,
                        reps=prepared.reps, interleave=True)
    return m, prepared.memory_space


def measure_chase_full(working_set_bytes: int, line_bytes: int = 64,
                       lens: tuple[int, int] = CHASE_LENS, timer: Timer | None = None,
                       memory_space: str | None = None, reps: int | None = None,
                       clock_hz: float | None = None) -> tuple[Measurement, str]:
    """Per-load in-kernel chase latency at one working-set size on the
    timer's device, and the path K3 ran (``"smem"`` or ``"global"``): the
    serial form of ``run_prepared_chase(prepare_chase(...))``."""
    timer = timer or Timer()
    return run_prepared_chase(
        prepare_chase(working_set_bytes, line_bytes, lens, memory_space=memory_space,
                      reps=reps, device=timer.device), timer, clock_hz=clock_hz)


def prepare_inkernel(spec: OpSpec, lens: tuple[int, int] = INKERNEL_LENS,
                     shape: tuple[int, int] | None = None,
                     device: str | torch.device | None = None,
                     reps: int | None = None) -> PreparedKernel:
    """Build ``spec``'s chain tiles on ``device`` (default ``cuda:0``) and
    run the chain at both lengths once, which builds and loads K2; no
    timing. On the card the callables are K2's timed form and return each
    thread's cycles; on the CPU they are the plain chain."""
    device = resolve_device(device)
    n1, n2 = lens
    if spec.max_chain is not None:
        n1, n2 = min(n1, max(spec.max_chain // 3, 1)), min(n2, spec.max_chain)
    carry, operands = tiles(spec, shape, device)
    sandwich = device.type == "cuda"

    def build(n: int) -> Callable:
        if sandwich:
            fn = lambda *args: op_chain_timed(*args, step=spec.name, n=n)[1]  # noqa: E731
        else:
            fn = build_chain(spec, n)
        block(fn(carry, *operands))
        return fn

    prepared = PreparedKernel(lens=(n1, n2), reps=reps, args=(carry, *operands),
                              retry_lens=retry_lens_for(spec, n1, n2), sandwich=sandwich,
                              _build=build)
    prepared.fn_by_len(n1)
    prepared.fn_by_len(n2)
    return prepared


def run_prepared_inkernel(prepared: PreparedKernel, timer: Timer | None = None,
                          clock_hz: float | None = None) -> Measurement:
    """Time a prepared chain: per-step latency from the two lengths. On the
    card the slope of the SM clock sandwich, converted at ``clock_hz``
    (default: :func:`sm_clock_hz`, sampled now); a non-positive slope raises
    ``NoisySlopeError`` (a chain that holds its steps resolves on the SM
    clock, so no widened retry). On the CPU :meth:`Timer.slope` around the
    plain chain, with its widened retry."""
    timer = timer or Timer()
    if prepared.sandwich:
        hz = clock_hz or sm_clock_hz(timer.device)
        return sandwich_slope(
            lambda n: functools.partial(prepared.fn_by_len(n), *prepared.args),
            *prepared.lens, clock_hz=hz, reps=prepared.reps or 5,
            warmup=max(timer.warmup, 1))
    return timer.slope(prepared.fn_by_len, *prepared.lens, *prepared.args,
                       reps=prepared.reps, retry_lens=prepared.retry_lens)


def measure_inkernel_full(spec: OpSpec, lens: tuple[int, int] = INKERNEL_LENS,
                          shape: tuple[int, int] | None = None,
                          timer: Timer | None = None,
                          reps: int | None = None,
                          clock_hz: float | None = None) -> Measurement:
    """Per-step in-kernel latency of ``spec`` on the timer's device, with
    dispersion: the serial form of
    ``run_prepared_inkernel(prepare_inkernel(...))``."""
    timer = timer or Timer()
    return run_prepared_inkernel(
        prepare_inkernel(spec, lens, shape, device=timer.device, reps=reps), timer,
        clock_hz=clock_hz)
