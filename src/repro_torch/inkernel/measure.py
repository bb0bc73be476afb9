"""Slope extraction for the fused kernels (the fused half of
``repro/inkernel/measure.py``).

Two workload sizes share the launch path and the kernel's tile shapes, so
``(T(n2) - T(n1)) / (n2 - n1)`` is the per-unit kernel cost. Reuses
:meth:`Timer.slope` unchanged, so these rows and the chain rows come from
one algebra.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.timing import Measurement, Timer
from repro_torch.inkernel.fused import FUSED_LENS, build_fused
from repro_torch.kernels.common import resolve_device
from repro_torch.utils import block


@dataclasses.dataclass
class PreparedKernel:
    """Built two-size kernel callables plus their slope parameters: the
    build half of a fused probe, consumed by :func:`run_prepared_fused`.
    Each callable closes over its own workload (the two sizes have
    different input shapes), so ``Timer.slope`` times zero-argument
    thunks."""

    lens: tuple[int, int]
    reps: int | None
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
