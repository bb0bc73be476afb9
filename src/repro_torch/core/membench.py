"""Memory-hierarchy probe (paper Section V-B3, Fig. 6): the pointer chase.

A permutation ring ``p`` is walked as ``i = p[i]``; each load's address
depends on the previous load's value, so nothing can overlap or elide the
loads, and latency per load as a function of working-set size exposes each
level of the hierarchy as a capacity cliff. ``build_ring`` makes the same
line-padded ring as the JAX package from the same seed (numpy's
``RandomState``), so both packages chase identical inputs.

The JAX package chases with an XLA ``fori_loop``, one compiled program for
all steps. PyTorch has no eager counterpart (a Python loop of ``ring[p]``
costs one launch per step), so here every chase is one launch of K3's
global path (``kernels/chase.py``), timed at two step counts. The loads a
rung times hit the level its size names (:func:`level_rule`): a ring that
fits the SM's L1 is walked once around inside each launch before its timed
steps; a larger one is walked once around by an untimed launch, and each
timed launch then starts where the last one stopped.

The in-kernel rows of the same rings (``repro_torch.api.MemoryChaseProbe``)
run through ``repro_torch.inkernel``; :func:`chasepoint_from_record` reads
them back.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.timing import Timer
from repro_torch.kernels.chase import chase
from repro_torch.kernels.common import resolve_device
from repro_torch.utils import block, logger, parse_kv_notes

# The L1 of an H100 SM: 256 KB shared with shared memory; K3's global path
# asks for carveout 0, all of it L1. A ring fits L1 when it is smaller (a
# ring as large as the L1 would need every line of a set-associative cache).
L1_BYTES = 256 * 1024


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


def chase_fn(steps: int, warm: int = 0, carry: bool = False):
    """Dependent pointer chase of ``warm + steps`` loads, one launch of K3's
    global path (the JAX package's chase reads device memory, never a
    scratchpad); with ``carry`` the launch leaves its last index in
    ``start`` for the next."""
    return lambda ring, start: chase(ring, start, steps=steps, warm=warm,
                                     memory_space="global", out=start if carry else None)


def lap_steps(ring_bytes: int, line_bytes: int = 64) -> int:
    """The steps of one lap of a :func:`build_ring` ring of ``ring_bytes``:
    its live slots, one a ``line_bytes`` line."""
    return max(ring_bytes // line_bytes, 1)


def level_rule(ring_bytes: int, line_bytes: int = 64) -> tuple[int, bool]:
    """``(warm, carry)``: how a chase of a ring of ``ring_bytes`` (one live
    slot a ``line_bytes`` line, as :func:`build_ring` pads it) makes its
    timed loads hit the level its size names.

    Below :data:`L1_BYTES` the ring fits the SM's L1: each launch first walks
    a whole lap (its live slots) untimed, and the timed loads follow it
    there: ``(lap, False)``. A larger ring is walked once around by an
    untimed launch before the first timed one, and carries its start from
    launch to launch: ``(0, True)``. Each timed load then reaches a line
    last touched a lap ago, in L2 when the ring fits it and evicted from it
    when it does not; L1 does not outlive a launch.
    """
    if ring_bytes < L1_BYTES:
        return lap_steps(ring_bytes, line_bytes), False
    return 0, True


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
    :func:`prepare_chase` and timed by :func:`run_prepared_chase`. ``pos``
    is the start the timed launches chase from (carried when ``carry``);
    ``warm`` and ``carry`` are :func:`level_rule`'s."""

    working_set_bytes: int
    line_bytes: int
    steps: tuple[int, int]
    ring: torch.Tensor
    start: torch.Tensor
    f1: object
    f2: object
    pos: torch.Tensor
    warm: int
    carry: bool


def prepare_chase(working_set_bytes: int, line_bytes: int = 64,
                  steps: tuple[int, int] = (2048, 6144),
                  device: str | torch.device | None = None) -> PreparedChase:
    """Build the ring on ``device`` (default ``cuda:0``) and the two chase
    callables under :func:`level_rule`; no timing."""
    ring, start = build_ring(working_set_bytes, line_bytes, device=device)
    warm, carry = level_rule(ring.numel() * 4, line_bytes)
    n1, n2 = steps
    return PreparedChase(working_set_bytes=working_set_bytes,
                         line_bytes=line_bytes, steps=(n1, n2), ring=ring,
                         start=start, f1=chase_fn(n1, warm, carry),
                         f2=chase_fn(n2, warm, carry), pos=start.clone(), warm=warm,
                         carry=carry)


def run_prepared_chase(prepared: PreparedChase, timer: Timer) -> MemPoint:
    """Time a :class:`PreparedChase`: the device-serial half of the split.

    The first-touch figure comes first, from the ring's start; then, for a
    carried ring, one untimed lap; then both lengths, whose difference over
    ``n2 - n1`` is the per-load latency (a warm lap inside each launch
    cancels in it)."""
    ring, start, pos = prepared.ring, prepared.start, prepared.pos
    n1, n2 = prepared.steps
    cold_ns = _cold_latency_ns(chase_fn(n2), ring, start, n2, timer)
    if prepared.carry:
        with timer.device_ctx():
            block(chase_fn(lap_steps(ring.numel() * 4, prepared.line_bytes),
                           carry=True)(ring, pos))
    m1 = timer.time_callable(prepared.f1, ring, pos)
    m2 = timer.time_callable(prepared.f2, ring, pos)
    per_load = max((m2.median_ns - m1.median_ns) / (n2 - n1), 0.0)
    return MemPoint(working_set_bytes=prepared.working_set_bytes,
                    latency_ns=per_load, cold_latency_ns=cold_ns,
                    stride_bytes=prepared.line_bytes)


def mempoint_from_record(rec) -> MemPoint:
    """Rebuild a MemPoint from its LatencyDB record (see api.MemoryProbe):
    the working set from the op name (``mem.chase.ws<N>``), the cold and
    stride figures from the notes."""
    fields = parse_kv_notes(rec.notes)
    return MemPoint(working_set_bytes=int(rec.op.rsplit("ws", 1)[1].split(".")[0]),
                    latency_ns=rec.latency_ns,
                    cold_latency_ns=float(fields.get("cold_ns", 0.0)),
                    stride_bytes=int(fields.get("stride", 64)))


@dataclasses.dataclass(frozen=True)
class ChasePoint:
    """One in-kernel memory row (see api.MemoryChaseProbe): per-load latency
    plus the working-set metadata persisted in the record's notes field."""

    working_set_bytes: int
    latency_ns: float
    memory_space: str   # the path the kernel ran: "smem" | "global"
    line_bytes: int


# the JAX package's residencies, read as the port's counterparts, so that one
# DB can hold both packages' rows
_SPACES = {"vmem": "smem", "any": "global", "smem": "smem", "global": "global"}


def chasepoint_from_record(rec) -> ChasePoint:
    """Rebuild a ChasePoint from an ``inkernel.mem.<bytes>`` LatencyDB record:
    the working set, path and line size from the notes' ``key=value`` pairs
    (the JAX package's ``space=vmem|any`` read as ``smem|global``)."""
    fields = parse_kv_notes(rec.notes)
    return ChasePoint(
        working_set_bytes=int(fields["ws"]),
        latency_ns=rec.latency_ns,
        memory_space=_SPACES[fields.get("space", "vmem")],
        line_bytes=int(fields.get("line", 64)))


def sweep(working_sets: Sequence[int] | None = None, timer: Timer | None = None,
          device: str | torch.device | None = None) -> list[MemPoint]:
    """Deprecated shim (Fig. 6 analog): latency vs working-set size on
    ``device`` (default ``cuda:0``).

    Use ``Session(...).run(Plan.memory(...))`` instead: the same probe with
    caching and resumability.
    """
    warnings.warn(
        "membench.sweep is deprecated; use "
        "repro_torch.api.Session.run(Plan.memory(...))",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import Plan, Session

    device = timer.device if timer is not None and device is None else resolve_device(device)
    session = Session(device=device, timer=timer or Timer(warmup=2, reps=15, device=device))
    result = session.run(Plan.memory(working_sets), force=True)
    pts = [mempoint_from_record(r.record) for r in result.results
           if r.record is not None]
    for pt in pts:
        logger.info("chase ws=%-10d hit=%6.2fns cold=%6.2fns",
                    pt.working_set_bytes, pt.latency_ns, pt.cold_latency_ns)
    return pts


def detect_levels(points: Sequence[MemPoint], jump: float = 1.6) -> list[dict]:
    """Identify capacity cliffs: consecutive latency jumps >= ``jump``x."""
    levels, cur = [], []
    for prev, nxt in zip(points, points[1:]):
        cur.append(prev)
        if prev.latency_ns > 0 and nxt.latency_ns / max(prev.latency_ns, 1e-9) >= jump:
            levels.append(cur)
            cur = []
    cur.append(points[-1])
    levels.append(cur)
    out = []
    for i, grp in enumerate(levels):
        out.append({
            "level": i,
            "capacity_bytes_lower_bound": grp[-1].working_set_bytes,
            "hit_latency_ns": float(np.median([p.latency_ns for p in grp])),
        })
    return out


def bandwidth_probe(size_bytes: int = 1 << 26, timer: Timer | None = None,
                    device: str | torch.device | None = None) -> float:
    """Streaming bandwidth in GB/s (paper Table I 'memory bandwidth' analog):
    one elementwise pass, ``1 + 2 v`` over ``size_bytes`` of float32 on
    ``device`` (default the timer's, else ``cuda:0``), its read and write
    bytes over its time."""
    timer = timer or Timer(warmup=2, reps=10, device=device)
    device = timer.device if device is None else resolve_device(device)
    x = torch.arange(size_bytes // 4, dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    m = timer.time_callable(lambda v: torch.add(one, v, alpha=2.0), x)
    return (2 * x.nbytes) / max(m.median_ns, 1.0)  # read + write, bytes/ns == GB/s
