"""Discrete-event serving simulator priced from the measured LatencyDB (the
port of ``repro/traffic/simulate.py``).

The predicted half of an SLO point: run the *same*
:class:`~repro_torch.traffic.scheduler.ContinuousBatchingScheduler` over
the *same* trace, but with every prefill/decode cost supplied by
:class:`~repro_torch.core.perfmodel.RecordLatencyEstimator` pricing the
engine's steps against the session DB. Because scheduler policy and costs
are both deterministic, the simulated timeline is a pure function of
``(trace, DB)``: the throughput-vs-latency curve the measured tables
*predict*, to be held against the curve the engine actually produces.

The estimator prices an **op record, not HLO**, as the port's performance
model does everywhere (``core.hlo_analysis``): each step is run once,
eagerly and untimed, under the recorder (:func:`hlo_analysis.record_ops`),
which keeps every dispatched op, the matmul FLOPs, the kernel sites and the
bytes; the JAX package compiles each step and prices the optimized HLO
text. So the port prices what its eager engine runs (every op reads its
inputs and writes its output), and recording a step runs it once on the
engine's device, kernels included.

Fidelity notes:

* The decode step is priced **once**: the pool's step has the fixed shape
  ``(n_slots, max_len)``, so its cost does not depend on occupancy —
  exactly like the real pool, whose free slots keep computing waste rows.
* Prefill is priced per distinct prompt length (each length is its own
  record).
* The simulator does not model eos (it cannot know what the model will
  sample); each request runs its full ``max_new`` budget. Compare against a
  measured run with ``eos_id=None`` for like-for-like schedules, or accept
  the divergence as part of the model error when eos is live.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.traffic.scheduler import ContinuousBatchingScheduler, ScheduleResult
from repro_torch.traffic.traces import Request
from repro_torch.utils import logger


class PredictedCostModel:
    """Price the slot pool's prefill/decode steps from a LatencyDB.

    Records the engine's steps (:meth:`Engine.lower_prefill` at batch 1 and
    each prompt length, :meth:`Engine.lower_decode` at the pool's
    ``(n_slots, max_len)``) and prices each record with the estimator —
    environment-filtered, like ``ServingCostProbe``, so rows measured on
    another device never price this timeline. ``coverage`` of the
    least-covered priced step is exposed so callers can tell a
    measurement-backed prediction from a ``default_ns``-backed one.
    """

    def __init__(self, engine, db, n_slots: int, *, max_len: int | None = None,
                 opt_level: str = "O3", filters: dict[str, str] | None = None):
        from repro_torch.core.perfmodel import RecordLatencyEstimator

        self.engine = engine
        self.n_slots = int(n_slots)
        self.max_len = int(max_len) if max_len is not None else engine.max_len
        self.est = RecordLatencyEstimator(db, opt_level=opt_level, filters=filters)
        self.min_coverage = 1.0
        # priced once a shape, on the instance: a cache on the class (the
        # JAX package's ``functools.lru_cache``) would keep every cost model,
        # and with it its engine's model, alive for the process
        self._prefill: dict[int, float] = {}
        self._decode: float | None = None

    def _price(self, step, args) -> float:
        from repro_torch.core.hlo_analysis import record_ops

        report = self.est.estimate(record_ops(step, *args))
        self.min_coverage = min(self.min_coverage, report.coverage)
        return report.total_ns

    def prefill_ns(self, prompt_len: int) -> float:
        if prompt_len not in self._prefill:
            ns = self._prefill[prompt_len] = self._price(*self.engine.lower_prefill(1, prompt_len))
            logger.debug("priced prefill plen=%d: %.0fns", prompt_len, ns)
        return self._prefill[prompt_len]

    def decode_ns(self) -> float:
        if self._decode is None:
            self._decode = self._price(*self.engine.lower_decode(self.n_slots, 1, self.max_len))
            logger.debug("priced decode step b=%d cache=%d: %.0fns",
                         self.n_slots, self.max_len, self._decode)
        return self._decode


class SimulatedExecutor:
    """Executor protocol over a :class:`PredictedCostModel` — no step run.

    Emits placeholder tokens (the simulator cannot know what the model would
    sample), so it must be scheduled with ``eos_id=None``: every request
    consumes exactly its ``max_new`` budget.
    """

    def __init__(self, costs: PredictedCostModel):
        self.costs = costs
        self.n_slots = costs.n_slots
        self._zeros = np.zeros((self.n_slots,), np.int32)

    def admit(self, slot: int, req: Request) -> tuple[int, float]:
        return 0, self.costs.prefill_ns(req.prompt_len)

    def step(self) -> tuple[np.ndarray, float]:
        return self._zeros, self.costs.decode_ns()

    def evict(self, slot: int) -> None:
        pass


def simulate(trace: Sequence[Request], costs: PredictedCostModel) -> ScheduleResult:
    """Predicted timeline of ``trace`` under the DB-priced cost model."""
    sched = ContinuousBatchingScheduler(SimulatedExecutor(costs), eos_id=None)
    return sched.run(trace)


def run_slo_point(engine, db, trace: Sequence[Request], *, n_slots: int = 4,
                  max_len: int | None = None, opt_level: str = "O3",
                  filters: dict[str, str] | None = None, measure: bool = True):
    """One predicted-vs-measured SLO point: the same trace through the
    DB-priced simulator and (optionally) the real engine's slot pool.

    Both sides run ``eos_id=None`` so every request consumes exactly its
    ``max_new`` budget — the schedules differ only through step *costs*,
    which is the quantity under test. Returns
    ``(predicted SloSummary, measured SloSummary | None, min coverage)``.
    """
    from repro_torch.traffic.metrics import summarize
    from repro_torch.traffic.scheduler import EngineExecutor

    costs = PredictedCostModel(engine, db, n_slots, max_len=max_len,
                               opt_level=opt_level, filters=filters)
    pred = summarize(simulate(trace, costs))
    meas = None
    if measure:
        ex = EngineExecutor(engine, n_slots, max_len=max_len,
                            warm_lens=sorted({r.prompt_len for r in trace}))
        meas = summarize(ContinuousBatchingScheduler(ex, eos_id=None).run(trace))
    return pred, meas, costs.min_coverage
