"""Continuous-batching scheduler: admission queue + slot recycling (the port
of ``repro/traffic/scheduler.py``: the same policy, step for step).

One scheduler drives both sides of the predicted-vs-measured SLO loop. The
batching policy lives here — FIFO admission into a fixed slot pool, one
lockstep decode step per iteration, a slot freed the *moment* its row
finishes (eos or budget) and re-admitted to the next waiting request — while
the *cost* of each prefill/decode step comes from an executor:

* :class:`EngineExecutor` — the measured side: a real
  :class:`repro_torch.serving.engine.SlotPool` (per-slot positions over one
  persistent batched cache), every admit/step wall-clocked to device
  completion (``utils.block``: ``torch.cuda.synchronize`` on the card).
* ``traffic.simulate.SimulatedExecutor`` — the predicted side: the same
  protocol, costs priced from the LatencyDB via ``RecordLatencyEstimator``,
  no step run.

Time is a **virtual clock over real service times**: the clock starts at 0,
advances by each executor-reported cost, and jumps forward to the next
arrival when the pool drains — so a trace replays deterministically (no
sleeping, no load generator) while the measured run still prices every step
on the actual engine. TTFT is first-token-completion minus arrival, which
includes queueing delay: that is the number production SLOs bound.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Protocol, Sequence

import numpy as np

from repro_torch.traffic.traces import Request
from repro_torch.utils import block, logger


class Executor(Protocol):
    """Cost-bearing backend the scheduler drives (measured or simulated)."""

    n_slots: int

    def admit(self, slot: int, req: Request) -> tuple[int, float]:
        """Prefill ``req`` into ``slot``; returns (first token, cost ns)."""
        ...

    def step(self) -> tuple[np.ndarray, float]:
        """One lockstep decode step; returns ([n_slots] tokens, cost ns)."""
        ...

    def evict(self, slot: int) -> None:
        ...


@dataclasses.dataclass
class RequestResult:
    """Per-request timeline collected by one scheduler run (all ns, on the
    run's virtual clock; ``arrival_ns`` comes from the trace)."""

    request: Request
    slot: int = -1
    admitted_ns: float = 0.0          # prefill start (admission out of queue)
    first_token_ns: float = 0.0       # prefill complete = first token emitted
    finish_ns: float = 0.0
    tokens: list[int] = dataclasses.field(default_factory=list)
    token_times_ns: list[float] = dataclasses.field(default_factory=list)
    finish_reason: str = ""           # "eos" | "max_new"

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class ScheduleResult:
    """Outcome of one trace run: per-request timelines + run totals."""

    requests: list[RequestResult]
    n_slots: int
    makespan_ns: float                # virtual-clock time of the last event
    decode_steps: int
    admissions: int

    def by_uid(self) -> dict[int, RequestResult]:
        return {r.request.uid: r for r in self.requests}


class ContinuousBatchingScheduler:
    """FIFO admission over a fixed slot pool with immediate slot recycling.

    Policy, in priority order at every iteration:

    1. **Admit**: while a slot is free and the head-of-queue request has
       arrived (``arrival_ns <= clock``), admit it (one batch-1 prefill,
       clock advances by its cost). A request whose first token is already
       terminal (eos, or ``max_new == 1``) finishes and frees the slot
       within the same admission burst.
    2. **Decode**: if any slot is active, run one lockstep step (clock
       advances by its cost); every active slot emits one token, finished
       rows are evicted immediately — the freed slot is admission-eligible
       on the very next iteration, before the rest of the batch drains.
    3. **Idle**: nothing active and nothing arrived — jump the clock to the
       next arrival.
    """

    def __init__(self, executor: Executor, *, eos_id: int | None = None):
        self.executor = executor
        self.eos_id = eos_id

    def run(self, trace: Sequence[Request]) -> ScheduleResult:
        ex = self.executor
        pending = deque(sorted(trace, key=lambda r: (r.arrival_ns, r.uid)))
        free = list(range(ex.n_slots))
        active: dict[int, RequestResult] = {}           # slot -> in-flight
        done: list[RequestResult] = []
        clock = 0.0
        decode_steps = admissions = 0

        def finish(slot: int, rr: RequestResult, reason: str) -> None:
            rr.finish_ns = clock
            rr.finish_reason = reason
            ex.evict(slot)
            del active[slot]
            free.append(slot)
            free.sort()                                 # deterministic reuse
            done.append(rr)

        while pending or active:
            # -------------------------------------------------- 1. admit
            admitted_any = False
            while pending and free and pending[0].arrival_ns <= clock:
                req = pending.popleft()
                slot = free.pop(0)
                rr = RequestResult(request=req, slot=slot, admitted_ns=clock)
                tok, cost = ex.admit(slot, req)
                clock += cost
                rr.first_token_ns = clock
                rr.tokens.append(tok)
                rr.token_times_ns.append(clock)
                active[slot] = rr
                admissions += 1
                admitted_any = True
                if self.eos_id is not None and tok == self.eos_id:
                    finish(slot, rr, "eos")
                elif req.max_new <= 1:
                    finish(slot, rr, "max_new")
            if admitted_any:
                continue        # new arrivals may have become eligible
            # -------------------------------------------------- 2. decode
            if active:
                toks, cost = ex.step()
                clock += cost
                decode_steps += 1
                for slot in sorted(active):
                    rr = active[slot]
                    tok = int(toks[slot])
                    rr.tokens.append(tok)
                    rr.token_times_ns.append(clock)
                    if self.eos_id is not None and tok == self.eos_id:
                        finish(slot, rr, "eos")
                    elif rr.n_tokens >= rr.request.max_new:
                        finish(slot, rr, "max_new")
                continue
            # -------------------------------------------------- 3. idle
            clock = max(clock, pending[0].arrival_ns)

        done.sort(key=lambda r: r.request.uid)
        return ScheduleResult(requests=done, n_slots=ex.n_slots,
                              makespan_ns=clock, decode_steps=decode_steps,
                              admissions=admissions)


# ------------------------------------------------------------ measured side
class EngineExecutor:
    """The measured executor: a real
    :class:`~repro_torch.serving.engine.SlotPool`, every admit/step
    wall-clocked on the host to device completion.

    Costs are per-call wall times of the eager engine, including whatever a
    cold engine pays once (on the card the kernels' libraries load at their
    first launch, and the allocator grows its pools) — pass ``warm_lens`` to
    run the prefill/decode shapes up front so that this never lands inside a
    request's TTFT.
    """

    def __init__(self, engine, n_slots: int, *, max_len: int | None = None,
                 temperature: float = 0.0, seed: int = 0,
                 warm_lens: Sequence[int] = ()):
        self.pool = engine.slots(n_slots, max_len=max_len) \
            if max_len is not None else engine.slots(n_slots)
        self.pool.temperature = temperature
        self.pool.seed = seed
        self.n_slots = n_slots
        if warm_lens:
            self.warm(warm_lens)

    def warm(self, prompt_lens: Sequence[int]) -> None:
        """Run prefill/admit at each prompt length + the decode step once, so
        measured costs are steady-state service times, not first-call cost."""
        pool = self.pool
        for plen in sorted(set(int(p) for p in prompt_lens)):
            pool.admit(0, [1] * plen, uid=-1, max_new=1)
            pool.evict(0)
        pool.admit(0, [1], uid=-1, max_new=1)
        pool.step()
        pool.evict(0)
        logger.info("engine executor warm: %d prefill shapes + decode step",
                    len(set(prompt_lens)))

    def admit(self, slot: int, req: Request) -> tuple[int, float]:
        t0 = time.perf_counter_ns()
        tok = self.pool.admit(slot, list(req.prompt), uid=req.uid,
                              max_new=req.max_new)
        block(self.pool.cache)
        return tok, float(time.perf_counter_ns() - t0)

    def step(self) -> tuple[np.ndarray, float]:
        t0 = time.perf_counter_ns()
        toks = self.pool.step()
        block(self.pool.cache)
        return toks, float(time.perf_counter_ns() - t0)

    def evict(self, slot: int) -> None:
        self.pool.evict(slot)
