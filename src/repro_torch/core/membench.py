"""Memory-hierarchy probe (paper Section V-B3, Fig. 6): the pointer chase.

A permutation ring ``p`` is walked as ``i = p[i]``; each load's address
depends on the previous load's value, so nothing can overlap or elide the
loads, and latency per load as a function of working-set size exposes each
level of the hierarchy as a capacity cliff. ``build_ring`` makes the same
line-padded ring as the JAX package from the same seed (numpy's
``RandomState``), so both packages chase identical inputs.

The JAX package chases with an XLA ``fori_loop``, one compiled program for
all steps. PyTorch has no eager counterpart (a Python loop of ``ring[p]``
costs one launch per step), so here every chase is one launch of the
``chase`` kernel (``kernels/chase.py``), timed at two step counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.timing import Timer
from repro_torch.kernels.chase import chase
from repro_torch.kernels.common import resolve_device
from repro_torch.utils import block


@dataclasses.dataclass(frozen=True)
class MemPoint:
    working_set_bytes: int
    latency_ns: float       # steady-state per-load latency (hit in whichever level fits)
    cold_latency_ns: float  # first-touch latency (the paper's 'global memory' number)
    stride_bytes: int


def _ring_permutation(n: int, seed: int = 0) -> np.ndarray:
    """Random single-cycle permutation (threading any random visiting order
    into a pointer table yields one n-cycle)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n).astype(np.int32)
    ring = np.empty(n, dtype=np.int32)
    ring[idx[:-1]] = idx[1:]
    ring[idx[-1]] = idx[0]
    return ring


def build_ring(working_set_bytes: int, line_bytes: int = 64, seed: int = 0,
               device: str | torch.device | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Line-padded chase ring covering ``working_set_bytes`` on ``device``
    (default ``cuda:0``, see ``resolve_device``): ``(ring [N] int32,
    start [1] int32)``.

    One live slot per cache line (so each step lands on a distinct line);
    slot values are absolute indices into the padded array.
    """
    device = resolve_device(device)
    n = max(working_set_bytes // line_bytes, 8)
    pad = line_bytes // 4
    ring_np = _ring_permutation(n, seed) * pad
    full = np.zeros(n * pad, dtype=np.int32)
    full[np.arange(n) * pad] = ring_np
    return (torch.from_numpy(full).to(device),
            torch.zeros(1, dtype=torch.int32, device=device))


def chase_fn(steps: int):
    """Dependent pointer chase of ``steps`` loads, one kernel launch."""
    return lambda ring, start: chase(ring, start, steps=steps)


def _cold_latency_ns(fn, ring: torch.Tensor, start: torch.Tensor, steps: int,
                     timer: Timer) -> float:
    """First-touch per-load latency of ``fn(ring, start)``.

    The launch path is warmed first with a call of the same shape on a zeroed
    ring (which chases slot 0 forever and touches one line), so the timed
    pass is the first execution that walks ``ring``'s memory, never the
    kernels' build or load.
    """
    block(fn(torch.zeros_like(ring), start))
    return timer.time_once(fn, ring, start) / steps


@dataclasses.dataclass
class PreparedChase:
    """The ring and both chase lengths, built off the timing thread by
    :func:`prepare_chase` and timed by :func:`run_prepared_chase`."""

    working_set_bytes: int
    line_bytes: int
    steps: tuple[int, int]
    ring: torch.Tensor
    start: torch.Tensor
    f1: object
    f2: object


def prepare_chase(working_set_bytes: int, line_bytes: int = 64,
                  steps: tuple[int, int] = (2048, 6144),
                  device: str | torch.device | None = None) -> PreparedChase:
    """Build the ring on ``device`` (default ``cuda:0``) and the two chase
    callables; no timing."""
    ring, start = build_ring(working_set_bytes, line_bytes, device=device)
    n1, n2 = steps
    return PreparedChase(working_set_bytes=working_set_bytes,
                         line_bytes=line_bytes, steps=(n1, n2), ring=ring,
                         start=start, f1=chase_fn(n1), f2=chase_fn(n2))


def run_prepared_chase(prepared: PreparedChase, timer: Timer) -> MemPoint:
    """Time a :class:`PreparedChase`: the device-serial half of the split."""
    ring, start = prepared.ring, prepared.start
    n1, n2 = prepared.steps
    cold_ns = _cold_latency_ns(prepared.f2, ring, start, n2, timer)
    m1 = timer.time_callable(prepared.f1, ring, start)
    m2 = timer.time_callable(prepared.f2, ring, start)
    per_load = max((m2.median_ns - m1.median_ns) / (n2 - n1), 0.0)
    return MemPoint(working_set_bytes=prepared.working_set_bytes,
                    latency_ns=per_load, cold_latency_ns=cold_ns,
                    stride_bytes=prepared.line_bytes)
