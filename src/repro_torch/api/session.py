"""The session: single front door for all characterization runs.

A :class:`Session` owns the pieces every sweep needs once — the device, the
:class:`Timer`, the environment fingerprint, the calibrated clock, the
guard baselines and a :class:`LatencyDB`-backed result cache — and runs
:class:`Plan`\\ s incrementally, as ``repro.api.session`` does:

* probes whose key is already in the DB are skipped (``force=True``
  re-measures);
* after every measured or failed probe the new rows are appended to the
  DB's journal, so an interrupted sweep resumes where it stopped, and the
  run's final ``save`` compacts the journal into one atomic write;
* a probe that raises is recorded as a structured :class:`ProbeFailure`
  (superseded when a later run of it succeeds); ``KeyboardInterrupt`` is
  not swallowed.

Compiles are taken off the timing path before it starts: on the card the
``torch.compile`` chains of the pending probes are compiled in worker
processes (:func:`compile_workers_for`), which fill Inductor's on-disk
cache, so the in-process compile of each chain in ``prepare`` is a cache
load.
Processes, not threads: Inductor's code generation is Python and holds the
interpreter lock. For the same reason the JAX package's compile-ahead
thread (prepare probe N+1 while probe N times) is not ported: a Dynamo
trace on a second thread stalls the eager dispatch the O0 rows time, so
here each probe is prepared and then timed, in turn. The persistent compile
cache of the JAX package is not ported yet.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import os
import time

import torch

from repro_torch.api.plan import Plan
from repro_torch.api.probes import Probe, ProbeContext
from repro_torch.core import chains, measure
from repro_torch.core.latency_db import (LatencyDB, LatencyRecord, ProbeFailure,
                                         current_environment)
from repro_torch.core.timing import AdaptiveFidelity, Timer
from repro_torch.kernels.common import resolve_device
from repro_torch.utils import logger, timestamp


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """Outcome of one scheduled probe."""

    probe: Probe
    status: str                        # "measured" | "cached" | "failed"
    record: LatencyRecord | None = None
    failure: ProbeFailure | None = None


@dataclasses.dataclass
class ResultSet:
    """Per-probe outcomes of one ``Session.run``, in plan order."""

    results: list[ProbeResult]
    db: LatencyDB
    # wall-clock attribution for this run: {"warm", "compile", "time",
    # "flush"} in ns
    stage_ns: dict = dataclasses.field(default_factory=dict)

    @property
    def measured(self) -> list[ProbeResult]:
        return [r for r in self.results if r.status == "measured"]

    @property
    def cached(self) -> list[ProbeResult]:
        return [r for r in self.results if r.status == "cached"]

    @property
    def failed(self) -> list[ProbeResult]:
        return [r for r in self.results if r.status == "failed"]

    def records(self) -> list[LatencyRecord]:
        return [r.record for r in self.results if r.record is not None]

    def summary(self) -> str:
        return (f"{len(self.measured)} measured, {len(self.cached)} cached, "
                f"{len(self.failed)} failed ({len(self.results)} probes)")

    def table_markdown(self, opt_levels: tuple[str, ...] = ("O3", "O0")) -> str:
        return self.db.table_markdown(opt_levels=opt_levels)

    def __len__(self) -> int:
        return len(self.results)


def compile_workers_for(device: torch.device, n_tasks: int) -> int:
    """Worker processes for ``n_tasks`` warm tasks on ``device``: on CUDA one
    per core but the one the session runs on, and no more than there are
    tasks; on the CPU none (the chains compile in the session's process, and
    no worker imports torch anew beside it)."""
    if device.type != "cuda":
        return 0
    return min(max((os.cpu_count() or 1) - 1, 1), n_tasks)


class Session:
    """Cache-aware scheduler over a LatencyDB (see module docstring).

    Parameters
    ----------
    db: a :class:`LatencyDB`, a path to one (loaded if present, created on
        first flush), or None for an in-memory DB.
    device: where every probe runs: ``"cuda[:N]"`` (the default is
        ``cuda:0``) or ``"cpu"``. Raises when CUDA is asked for and absent.
    timer: shared :class:`Timer`; defaults to the standard calibration on
        ``device``. A given timer must time the same device.
    force: re-measure cache hits by default (per-run ``force`` overrides).
    adaptive: True for default :class:`AdaptiveFidelity`, an instance for
        custom thresholds, or None/False to keep fixed rep counts.
    """

    def __init__(self, db: LatencyDB | str | None = None,
                 device: str | torch.device | None = None,
                 timer: Timer | None = None, force: bool = False,
                 adaptive: AdaptiveFidelity | bool | None = None):
        self.device = resolve_device(device)
        self.db = db if isinstance(db, LatencyDB) else LatencyDB(path=db)
        self.timer = timer or Timer(device=self.device)
        if self.timer.device != self.device:
            raise ValueError(f"timer times {self.timer.device}, session runs on "
                             f"{self.device}; give the session a timer of its device")
        if adaptive is True:
            adaptive = AdaptiveFidelity()
        elif adaptive is False:
            adaptive = None
        self.adaptive = adaptive
        if adaptive is not None:
            self.timer.adaptive = adaptive
        self.force = force
        self.env = current_environment(self.device)
        self._baseline: dict[tuple, float] = {}

    # ------------------------------------------------------------- baseline
    def baseline_ns(self, opt_level: str, use_db: bool = True) -> float:
        """Per-level 1-cycle-class baseline used to net out guard ops.

        The ``add`` row is an (add ^ xor) pair in the same latency class, so
        baseline = measured_pair / (1 + guard). Taken from the DB when the
        pair is cached there (and ``use_db``), measured otherwise; forced
        runs pass ``use_db=False`` so a stale row never mixes in.
        """
        cache_key = ("dispatch", opt_level, use_db)
        if cache_key not in self._baseline:
            base = chains.spec_by_name("add")
            rec = self.db.get((self.env["device_kind"], self.env["backend"],
                               self.env["jax_version"], opt_level,
                               base.name, base.dtype)) if use_db else None
            ns = (rec.latency_ns if rec is not None
                  else measure.measure_op(base, opt_level, self.timer))
            self._baseline[cache_key] = ns / (1 + base.guard)
        return self._baseline[cache_key]

    def kernel_baseline_ns(self) -> float:
        """The same baseline inside the ``op_chain`` kernel: the ``add``
        row's step run through op_chain at O3, / (1 + guard). It nets the
        guard op of ``op_chain`` rows at both levels, since their guard runs
        inside the kernel either way. Measured once per session."""
        if ("kernel",) not in self._baseline:
            base = chains.kernel_baseline_spec()
            ns = measure.measure_op(base, "O3", self.timer)
            self._baseline[("kernel",)] = ns / (1 + base.guard)
        return self._baseline[("kernel",)]

    def _context(self, force: bool = False) -> ProbeContext:
        return ProbeContext(timer=self.timer, env=self.env,
                            clock_hz=self.timer.calibrate_clock_hz(),
                            baseline_ns=lambda lv: self.baseline_ns(
                                lv, use_db=not force),
                            kernel_baseline_ns=self.kernel_baseline_ns,
                            device=self.device,
                            adaptive=self.adaptive is not None)

    # ------------------------------------------------------------ execution
    def run(self, plan: Plan, force: bool | None = None) -> ResultSet:
        """Execute a plan incrementally; returns per-probe outcomes.

        Probes are prepared and timed one at a time. The rows of
        every measured or failed probe are journal-appended to the DB path
        at once, so interrupting a sweep loses at most the probe in flight;
        a completed run compacts the journal into the main DB file.
        """
        force = self.force if force is None else force
        plan = plan.dedupe()
        ctx = self._context(force=force)
        probes = list(plan)
        results: dict[int, ProbeResult] = {}
        pending: list[tuple[int, Probe]] = []
        for i, probe in enumerate(probes):
            key = probe.key(self.env)
            if not force and key in self.db:
                results[i] = ProbeResult(probe, "cached", record=self.db.get(key))
                logger.debug("cached   %-28s", probe.op + "@" + probe.opt_level)
            else:
                pending.append((i, probe))
        stage_ns = {"warm": 0, "compile": 0, "time": 0, "flush": 0}
        if pending:
            t0 = time.perf_counter_ns()
            self._warm_compiles([p for _, p in pending], ctx)
            stage_ns["warm"] += time.perf_counter_ns() - t0
            for i, probe in pending:
                self._run_probe(i, probe, ctx, results, stage_ns)
        if self.db.path:
            t0 = time.perf_counter_ns()
            self.db.save()  # compact the journal into one atomic write
            stage_ns["flush"] += time.perf_counter_ns() - t0
        return ResultSet(results=[results[i] for i in range(len(probes))],
                         db=self.db, stage_ns=stage_ns)

    def _warm_compiles(self, probes: list[Probe], ctx: ProbeContext) -> None:
        """Run the probes' warm tasks in spawned worker processes
        (:func:`compile_workers_for`) and wait for all of them. A task that fails only costs its
        cache entry: prepare compiles (or fails and records) the same chain
        in this process afterwards."""
        tasks = [t for p in probes for t in p.warm_tasks(ctx)]
        workers = compile_workers_for(self.device, len(tasks))
        if workers < 1:
            return
        t0 = time.perf_counter()
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = {pool.submit(fn, *args): args for fn, args in tasks}
            for fut in concurrent.futures.as_completed(futures):
                try:
                    logger.debug("warmed %s in %.1f s", futures[fut], fut.result())
                except Exception as e:  # noqa: BLE001 - advisory stage, see docstring
                    logger.warning("compile-ahead of %s failed in a worker: %s: %s",
                                   futures[fut], type(e).__name__, e)
        logger.info("compile-ahead: %d chains in %d worker processes in %.1f s",
                    len(tasks), workers, time.perf_counter() - t0)

    def _run_probe(self, i, probe, ctx, results, stage_ns) -> None:
        """Prepare and time one probe; record the outcome and flush it."""
        t0 = time.perf_counter_ns()
        prepared, exc = None, None
        try:
            prepared = probe.prepare(ctx)
        except Exception as e:  # noqa: BLE001 - structured failure below
            exc = e
        stage_ns["compile"] += time.perf_counter_ns() - t0
        if exc is None:
            t0 = time.perf_counter_ns()
            try:
                rec = probe.run_prepared(ctx, prepared)
            except Exception as e:  # noqa: BLE001 - recorded as failure
                exc = e
            else:
                self.db.add(rec)
                results[i] = ProbeResult(probe, "measured", record=rec)
                logger.info("measured %-28s %8.1fns (±%.1f)",
                            f"{probe.op}@{probe.opt_level}", rec.latency_ns,
                            rec.mad_ns)
            stage_ns["time"] += time.perf_counter_ns() - t0
        if exc is not None:
            failure = ProbeFailure(
                op=probe.op, dtype=probe.dtype, opt_level=probe.opt_level,
                error_type=type(exc).__name__, message=str(exc),
                failed_at=timestamp(), **self.env)
            self.db.add_failure(failure)
            results[i] = ProbeResult(probe, "failed", failure=failure)
            logger.warning("probe %s@%s failed: %s: %s", probe.op,
                           probe.opt_level, type(exc).__name__, exc)
        t0 = time.perf_counter_ns()
        if self.db.path:
            self.db.flush()  # per-probe durability: journal-append new rows
        stage_ns["flush"] += time.perf_counter_ns() - t0
