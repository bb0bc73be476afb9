"""The session: single front door for all characterization runs.

A :class:`Session` owns the pieces every sweep needs once — the device, the
:class:`Timer`, the environment fingerprint, the clock that ``cycles``
count (the SM clock on the card), the guard baselines and a
:class:`LatencyDB`-backed result cache — and runs
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
processes (:class:`CompilePool`, :func:`compile_workers_for`), longest
chain first, which fill Inductor's on-disk cache, and each probe is
prepared here as soon as its chains have landed (the in-process compile of
a chain is then a cache load); only then are the probes timed, in plan
order. A caller that runs several plans can open one pool for all of them
and submit every chain at once (``chip_smoke.py`` does, before it builds
the kernels); each session then waits only for its own chains.
Processes, not threads: Inductor's code generation is Python and holds the
interpreter lock. For the same reason the JAX package's compile-ahead
thread (prepare probe N+1 while probe N times) is not ported: a Dynamo
trace on a second thread stalls the eager dispatch the O0 rows time. The
persistent compile cache of the JAX package is not ported yet.

With ``audit=True`` each probe's compiled code is judged as soon as it is
prepared (``repro_torch.audit``) and the verdict rides in the record's
notes (``audit=...``); a probe that then fails carries it in its failure's
message. On the card the chains' PTX and SASS come back from the compile
workers that built them (``audit.artifacts.warm_and_read``, the pool's
runner), each with its chain's name; nothing is compiled again for the
audit, and a chain whose worker failed is ``unaudited:artifact-missing``.
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
from repro_torch.audit import artifacts
from repro_torch.core import chains, measure
from repro_torch.core.latency_db import (LatencyDB, LatencyRecord, ProbeFailure,
                                         current_environment)
from repro_torch.core.timing import AdaptiveFidelity, Timer, sm_clock_hz
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


def warm_tasks(probes, device: torch.device) -> list[tuple]:
    """The probes' warm tasks (:meth:`Probe.warm_tasks`), the longest chain
    first (a 512-op chain compiles several times longer than a 64-op one,
    so the pool's last task is a short one)."""
    tasks = [t for p in probes for t in p.warm_tasks(device)]
    return sorted(tasks, key=lambda t: -t[1][2])  # stable: plan order within a length


class CompilePool:
    """Worker processes that run warm tasks (``(function, args)`` pairs),
    spawned, not forked. A task submitted again shares the first
    submission's future, so it runs once. While a pool is open as a
    context manager it is :attr:`current`, and every :class:`Session` of
    this process warms its chains in it instead of starting its own.
    ``runner``, if given, runs each task as ``runner(function, *args)`` (a
    caller that also reads what the task compiled). ``local`` holds tasks
    that this process runs, one at a time, while a session waits on the
    workers (the O1 chains, which compile in the process that runs them);
    ``local_s`` sums their seconds."""

    current: "CompilePool | None" = None

    def __init__(self, workers: int, runner=None):
        self.workers = workers
        self.runner = runner
        self._executor = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
        self.futures: dict[tuple, concurrent.futures.Future] = {}
        self.local: list[tuple] = []
        self.local_s = 0.0
        self.started_at = time.time()

    def submit(self, tasks: list[tuple]) -> list[concurrent.futures.Future]:
        out = []
        for fn, args in tasks:
            key = (fn.__module__, fn.__qualname__, *args)
            if key not in self.futures:
                self.futures[key] = (self._executor.submit(fn, *args) if self.runner is None
                                     else self._executor.submit(self.runner, fn, *args))
            out.append(self.futures[key])
        return out

    def run_local(self) -> None:
        """Run the first task of :attr:`local` in this process. One that
        fails only logs: the probe's prepare compiles its chain again."""
        fn, args = self.local.pop(0)
        t0 = time.perf_counter()
        try:
            fn(*args)
        except Exception as e:  # noqa: BLE001 - advisory, as above
            logger.warning("local task %s%s failed: %s: %s", fn.__name__, args,
                           type(e).__name__, e)
        self.local_s += time.perf_counter() - t0

    def __enter__(self) -> "CompilePool":
        CompilePool.current = self
        return self

    def __exit__(self, *exc) -> None:
        CompilePool.current = None
        self.close()

    def close(self) -> None:
        """Stop the workers (a task not started yet is dropped)."""
        self._executor.shutdown(cancel_futures=True)


def compile_workers_for(device: torch.device, n_tasks: int) -> int:
    """Worker processes for ``n_tasks`` warm tasks on ``device``: on CUDA one
    per CPU the process may use (its affinity mask: ``os.cpu_count()``
    counts the machine's), and no more than there are tasks (the session's
    own process mostly waits for them: it only loads each chain they
    compiled); on the CPU none (the chains
    compile in the session's process, and no worker imports torch anew
    beside it)."""
    if device.type != "cuda":
        return 0
    return min(len(os.sched_getaffinity(0)), n_tasks)


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
    audit: statically verify each probe's compiled code as it is prepared
        (``repro_torch.audit``: chain count, guard accounting, dependent
        path) and attach the verdict to the record's notes (``audit=ok`` /
        ``audit=transformed:<cause>`` / ...). Off by default; a failed
        verdict only flags the record — ``python -m repro_torch audit
        --strict`` turns flags into a failing exit.
    """

    def __init__(self, db: LatencyDB | str | None = None,
                 device: str | torch.device | None = None,
                 timer: Timer | None = None, force: bool = False,
                 adaptive: AdaptiveFidelity | bool | None = None, audit: bool = False):
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
        self.audit = audit
        self.env = current_environment(self.device)
        self._baseline: dict[tuple, float] = {}
        self._clock_hz: float | None = None

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

    def clock_hz(self) -> float:
        """The clock a record's ``cycles`` count: on the card the SM clock
        (``sm_clock_hz``: %clock64 against the card's ns timer), sampled once
        a session, so that ``cycles`` are the unit of the paper's Table II;
        on the CPU the JAX package's host pseudo-clock
        (``Timer.calibrate_clock_hz``)."""
        if self._clock_hz is None:
            self._clock_hz = (sm_clock_hz(self.device) if self.device.type == "cuda"
                              else self.timer.calibrate_clock_hz())
        return self._clock_hz

    def _context(self, force: bool = False) -> ProbeContext:
        return ProbeContext(timer=self.timer, env=self.env,
                            clock_hz=self.clock_hz(),
                            baseline_ns=lambda lv: self.baseline_ns(
                                lv, use_db=not force),
                            kernel_baseline_ns=self.kernel_baseline_ns,
                            device=self.device,
                            adaptive=self.adaptive is not None, db=self.db)

    # ------------------------------------------------------------ execution
    def run(self, plan: Plan, force: bool | None = None) -> ResultSet:
        """Execute a plan incrementally; returns per-probe outcomes.

        Every pending probe is prepared first (:meth:`_prepare_all`: its
        O3 chains warmed in compile workers, then loaded here as soon as
        they land), then each is timed in plan order. The rows of every
        measured or failed probe are journal-appended to the DB path at
        once, so interrupting a sweep loses at most the probe in flight; a
        completed run compacts the journal into the main DB file.
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
            prepared = self._prepare_all(pending, ctx, stage_ns)
            for i, probe in pending:
                self._run_probe(i, probe, ctx, prepared[i], results, stage_ns)
        if self.db.path:
            t0 = time.perf_counter_ns()
            self.db.save()  # compact the journal into one atomic write
            stage_ns["flush"] += time.perf_counter_ns() - t0
        return ResultSet(results=[results[i] for i in range(len(probes))],
                         db=self.db, stage_ns=stage_ns)

    def _prepare_all(self, pending: list[tuple[int, Probe]], ctx: ProbeContext,
                     stage_ns: dict) -> dict[int, tuple]:
        """``{i: (prepared, exception)}`` for every pending probe.

        The probes' warm tasks run in the open :class:`CompilePool`, or in
        :func:`compile_workers_for` processes started for this run and shut
        down before any timing. While they compile, this process prepares
        each probe whose tasks have all landed (its chains then load from
        Inductor's cache), and the probes without tasks first. A task that
        fails only costs its cache entry: prepare compiles (or fails and
        records) the same chain in this process.
        """
        t0 = time.perf_counter()
        stage0 = dict(stage_ns)
        tasks = warm_tasks([p for _, p in pending], self.device)
        workers = (0 if not tasks or CompilePool.current is not None
                   else compile_workers_for(self.device, len(tasks)))
        own = (CompilePool(workers, runner=artifacts.warm_and_read if self.audit else None)
               if workers else None)
        pool = CompilePool.current or own
        local0 = pool.local_s if pool is not None else 0.0
        waiting: dict[int, list] = {}
        if pool is not None and tasks:
            pool.submit(tasks)  # in this order; a probe's own submit below finds them
            waiting = {i: list(zip(ts, pool.submit(ts))) for i, p in pending
                       if (ts := p.warm_tasks(self.device))}
        by_index, prepared = dict(pending), {}
        try:
            for i, probe in pending:
                if i not in waiting:
                    prepared[i] = self._prepare(probe, ctx, stage_ns)
            while waiting:
                landed = [i for i, fs in waiting.items() if all(f.done() for _, f in fs)]
                if not landed:
                    t1 = time.perf_counter_ns()
                    if pool.local:  # this process's own tasks while the workers compile
                        pool.run_local()
                    else:
                        concurrent.futures.wait([f for fs in waiting.values() for _, f in fs],
                                                return_when=concurrent.futures.FIRST_COMPLETED)
                    stage_ns["warm"] += time.perf_counter_ns() - t1
                    continue
                for i in landed:
                    for _, fut in waiting.pop(i):
                        self._log_warm(by_index[i], fut)
                    prepared[i] = self._prepare(by_index[i], ctx, stage_ns)
        finally:
            if own is not None:
                own.close()
        if tasks and pool is not None:
            local_s = pool.local_s - local0
            logger.info("compile-ahead: %d chains in %d worker processes; all probes "
                        "prepared in %.1f s: this process %.1f s preparing probes (their "
                        "chains loaded from the cache), %.1f s on its own tasks, %.1f s "
                        "waiting", len(tasks), pool.workers, time.perf_counter() - t0,
                        (stage_ns["compile"] - stage0["compile"]) / 1e9, local_s,
                        (stage_ns["warm"] - stage0["warm"]) / 1e9 - local_s)
        return prepared

    @staticmethod
    def _log_warm(probe: Probe, fut: concurrent.futures.Future) -> None:
        """Log a landed warm task; file the device code it read (the pool's
        runner was ``artifacts.warm_and_read``) under the chain's name it
        gives."""
        try:
            result = fut.result()
            logger.debug("warmed %s@%s in %.1f s: %s", probe.op, probe.opt_level,
                         result["s"], result["phases"])
        except Exception as e:  # noqa: BLE001 - advisory stage, see _prepare_all
            logger.warning("compile-ahead of %s@%s failed in a worker: %s: %s",
                           probe.op, probe.opt_level, type(e).__name__, e)
            return
        if "ptx" in result:
            artifacts.remember(result["chain"], result)

    def _prepare(self, probe: Probe, ctx: ProbeContext, stage_ns: dict) -> tuple:
        """(what ``probe.prepare`` built, None, its verdict), or (None, the
        exception, its verdict); the verdict is None without ``audit``."""
        t0 = time.perf_counter_ns()
        try:
            return probe.prepare(ctx), None, self._audit_for(probe)
        except Exception as e:  # noqa: BLE001 - recorded as a failure when timed
            return None, e, self._audit_for(probe)
        finally:
            stage_ns["compile"] += time.perf_counter_ns() - t0

    def _audit_for(self, probe: Probe):
        """Static integrity verdict for one probe's compiled code, right
        after ``prepare`` (its chains are loaded, their device code filed).
        Any auditor error degrades to no verdict — auditing must never turn
        a measurable probe into a failure."""
        if not self.audit:
            return None
        try:
            from repro_torch.audit import audit_target

            return audit_target(probe.op, probe.opt_level, env=self.env)
        except Exception as e:  # noqa: BLE001 - advisory only
            logger.warning("audit of %s@%s errored: %s: %s", probe.op, probe.opt_level,
                           type(e).__name__, e)
            return None

    def _run_probe(self, i, probe, ctx, prepared, results, stage_ns) -> None:
        """Time one prepared probe (``prepared`` is ``(what prepare built,
        its exception, its verdict)``); record the outcome, with the verdict,
        and flush it."""
        prepared, exc, verdict = prepared
        if exc is None:
            t0 = time.perf_counter_ns()
            try:
                rec = probe.run_prepared(ctx, prepared)
            except Exception as e:  # noqa: BLE001 - recorded as failure
                exc = e
            else:
                if verdict is not None:
                    from repro_torch.audit import annotation
                    kv = {k: v for k, v in annotation(verdict).items() if v is not None}
                    rec = dataclasses.replace(rec, notes=" ".join(
                        [rec.notes, *(f"{k}={v}" for k, v in kv.items())]).strip())
                self.db.add(rec)
                results[i] = ProbeResult(probe, "measured", record=rec)
                logger.info("measured %-28s %8.1fns (±%.1f)",
                            f"{probe.op}@{probe.opt_level}", rec.latency_ns,
                            rec.mad_ns)
            stage_ns["time"] += time.perf_counter_ns() - t0
        if exc is not None:
            message = str(exc) + (f" [{verdict.note()}]" if verdict is not None else "")
            failure = ProbeFailure(
                op=probe.op, dtype=probe.dtype, opt_level=probe.opt_level,
                error_type=type(exc).__name__, message=message,
                failed_at=timestamp(), **self.env)
            self.db.add_failure(failure)
            results[i] = ProbeResult(probe, "failed", failure=failure)
            logger.warning("probe %s@%s failed: %s: %s", probe.op,
                           probe.opt_level, type(exc).__name__, exc)
        t0 = time.perf_counter_ns()
        if self.db.path:
            self.db.flush()  # per-probe durability: journal-append new rows
        stage_ns["flush"] += time.perf_counter_ns() - t0
