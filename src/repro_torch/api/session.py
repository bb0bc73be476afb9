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

Compiles are taken off the timing path. On the card the ``torch.compile``
chains of the pending probes are compiled in worker processes
(:class:`CompilePool`, :func:`compile_workers_for`), submitted so that the
probes' chains land one probe after another in plan order
(:func:`warm_tasks`); they fill Inductor's on-disk cache, and this process
prepares each probe once its chains have landed (the in-process compile of
a chain is then a cache load). Processes, not threads: Inductor's code
generation is Python and holds the interpreter lock, and a Dynamo trace on
a second thread would stall the eager dispatch the O0 rows time. A caller
that runs several plans can open one pool for all of them and submit every
chain at once (``chip_smoke.py`` does, before it builds the kernels); each
session then waits only for its own chains. Two modes, as in the JAX
package (``Session.run(pipeline=)``, the CLI's ``--serial``):

* **pipelined** (the default on the CPU, and ``pipeline=True``): each probe
  is timed in plan order as soon as it and every probe before it are
  prepared, while the workers compile the chains of the probes after it.
  All timing stays in this process and strictly serial on the device; a
  probe's in-process prepare (a cache load) runs between timings, never
  beside one, and so do this process's own tasks (``CompilePool.local``)
  while it waits. A probe's timing thus shares the host with the compile
  workers, but not the card.
* **serial** (the default on the card, and ``pipeline=False``): no timing
  overlaps the compiles of the run's chains: every chain lands and every
  probe is prepared first, then the probes are timed in plan order. On the
  card this stays the default until rows timed beside the compile workers
  are shown to agree with rows timed after them: ``tools/wait_study.py``
  found one of table2's rows 30.8 % off there (PERF.md section 2).

Given the same timings, both give the same statuses, records and failures
(``tests/test_torch_pipeline.py``); on the card the timings themselves may
differ, by the study above.
With a :class:`~repro_torch.core.compile_cache.CompileCache`
(``compile_cache=``, ``--compile-cache DIR``) Inductor's caches live under
its directory, for this process and every compile worker, and each O3
chain's device code is kept beside them; a warm run compiles nothing
(``ResultSet.summary``: ``compile cache: N hits, 0 compiled``) and starts
no worker for a chain whose entry is present.

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
from repro_torch.core.compile_cache import CacheStats, CompileCache, use_dirs
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
    # CompileCache hit/compile counters for THIS run (a delta, not the
    # cache's lifetime totals); None when no cache was configured
    cache_stats: CacheStats | None = None

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
        s = (f"{len(self.measured)} measured, {len(self.cached)} cached, "
             f"{len(self.failed)} failed ({len(self.results)} probes)")
        if self.cache_stats is not None:
            st = self.cache_stats
            s += f", compile cache: {st.hits} hits, {st.misses} compiled"
        return s

    def table_markdown(self, opt_levels: tuple[str, ...] = ("O3", "O0")) -> str:
        return self.db.table_markdown(opt_levels=opt_levels)

    def __len__(self) -> int:
        return len(self.results)


def warm_tasks(probes, device: torch.device, workers: int = 8) -> list[tuple]:
    """The probes' warm tasks (:meth:`Probe.warm_tasks`), each once, in the
    order that lands the probes one after another in plan order without
    lengthening the pool. A probe's longest chain goes in plan order; its
    shorter ones follow ``2 * workers`` probes later, about when the long
    one ends (a 512-op chain compiles ≈ 9x longer than a 64-op one); the
    tasks of the last ``3 * workers`` probes go last, longest first, so that
    the pool's last tasks are short ones and its workers finish together
    (replayed over the compile seconds of an H100 host's 130 chains, this
    packs the pool within 1 % of longest-first order)."""
    seen, per_probe = set(), []
    for p in probes:
        mine = [t for t in sorted(p.warm_tasks(device), key=lambda t: -t[1][2])
                if (t[0], t[1]) not in seen]
        seen.update((t[0], t[1]) for t in mine)
        if mine:
            per_probe.append(mine)
    lag = 2 * workers
    cut = max(len(per_probe) - 3 * workers, 0)
    head, tail = per_probe[:cut], per_probe[cut:]
    out = []
    for k, mine in enumerate(head):
        out.append(mine[0])
        if k >= lag:
            out += head[k - lag][1:]
    rest = [t for mine in head[max(len(head) - lag, 0):] for t in mine[1:]]
    rest += [t for mine in tail for t in mine]
    return out + sorted(rest, key=lambda t: -t[1][2])  # stable: plan order within a length


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
    ``local_s`` sums their seconds. ``cache`` (a :class:`CompileCache`)
    puts every worker's Inductor and Triton caches under its directory and
    has their chain compiles go through it (``measure.warm_chain``). The
    workers run at a lower priority than this process (:data:`WORKER_NICE`):
    the whole host is theirs while it waits, and it is not descheduled for
    one of their slices while it times a probe between two landings."""

    current: "CompilePool | None" = None

    def __init__(self, workers: int, runner=None, cache: CompileCache | None = None):
        self.workers = workers
        self.runner = runner
        self.cache = cache
        self._executor = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker, initargs=(cache.environ() if cache else None,))
        self.futures: dict[tuple, concurrent.futures.Future] = {}
        self.local: list[tuple] = []
        self.local_s = 0.0
        self.started_at = time.time()

    def submit(self, tasks: list[tuple]) -> list[concurrent.futures.Future]:
        out = []
        for fn, args in tasks:
            key = (fn.__module__, fn.__qualname__, *args)
            if key not in self.futures:
                self.futures[key] = self._executor.submit(_run_task, self.runner, fn, *args)
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
        logger.debug("local task %s%s took %.2f s", fn.__name__, args[:1],
                     time.perf_counter() - t0)

    def __enter__(self) -> "CompilePool":
        CompilePool.current = self
        return self

    def __exit__(self, *exc) -> None:
        CompilePool.current = None
        self.close()

    def close(self) -> None:
        """Stop the workers (a task not started yet is dropped)."""
        self._executor.shutdown(cancel_futures=True)


# how much less of the CPU a compile worker asks for than the session's
# process (os.nice): the session times probes and prepares them while the
# workers compile, and a probe's enqueue must not wait for a worker's slice
WORKER_NICE = 10


def _init_worker(environ: dict | None) -> None:
    """A compile worker's start: a compile cache's directories."""
    if environ is not None:
        use_dirs(environ)


_niced = False


def _run_task(runner, fn, *args):
    """Run one warm task in a compile worker (through ``runner`` if given),
    from its first task on at a lower priority than the session's process
    (:data:`WORKER_NICE`): the workers start up (the imports) at full
    priority beside the build, and compile below the session."""
    global _niced
    if not _niced:
        os.nice(WORKER_NICE)
        _niced = True
    return fn(*args) if runner is None else runner(fn, *args)


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
    compile_cache: a :class:`CompileCache`, a directory path for one, or
        None (Inductor's default directory, no entries). Given, this
        process's Inductor and Triton caches move under it at once.
    pipeline: True times each probe as soon as it and the probes before it
        are prepared, while the compile workers build the rest; False
        prepares every probe before timing any; None (the default) is True
        on the CPU and False on the card (see the module docstring).
    """

    def __init__(self, db: LatencyDB | str | None = None,
                 device: str | torch.device | None = None,
                 timer: Timer | None = None, force: bool = False,
                 adaptive: AdaptiveFidelity | bool | None = None, audit: bool = False,
                 compile_cache: CompileCache | str | None = None,
                 pipeline: bool | None = None):
        self.device = resolve_device(device)
        if isinstance(compile_cache, str):
            compile_cache = CompileCache(compile_cache)
        self.compile_cache = compile_cache
        if compile_cache is not None:
            compile_cache.use()
        self.pipeline = self.device.type != "cuda" if pipeline is None else pipeline
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
                  else max(measure.run_prepared_op(measure.prepare_op(
                      base, opt_level, self.device, cache=self.compile_cache, env=self.env,
                      count=False),
                      self.timer).median_ns, 0.0))
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
                            adaptive=self.adaptive is not None, db=self.db,
                            compile_cache=self.compile_cache)

    # ------------------------------------------------------------ execution
    def run(self, plan: Plan, force: bool | None = None,
            pipeline: bool | None = None) -> ResultSet:
        """Execute a plan incrementally; returns per-probe outcomes.

        The pending probes' O3 chains are warmed in compile workers and
        each probe is prepared here once they have landed; pipelined, each
        is timed in plan order as soon as it and the probes before it are
        prepared; serial (``pipeline=False``), once every probe is. The
        rows of every measured or failed probe are journal-appended to the
        DB path at once, so interrupting a sweep loses at most the probe in
        flight; a completed run compacts the journal into the main DB file.
        """
        force = self.force if force is None else force
        pipeline = self.pipeline if pipeline is None else pipeline
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
        stats0 = (dataclasses.replace(self.compile_cache.stats)
                  if self.compile_cache is not None else None)
        if pending:
            self._run_pending(pending, ctx, results, stage_ns, pipeline)
        if self.db.path:
            t0 = time.perf_counter_ns()
            self.db.save()  # compact the journal into one atomic write
            stage_ns["flush"] += time.perf_counter_ns() - t0
        cache_stats = None
        if stats0 is not None:
            now = self.compile_cache.stats
            cache_stats = CacheStats(**{f.name: getattr(now, f.name) - getattr(stats0, f.name)
                                        for f in dataclasses.fields(CacheStats)})
        return ResultSet(results=[results[i] for i in range(len(probes))],
                         db=self.db, stage_ns=stage_ns, cache_stats=cache_stats)

    def _tasks_of(self, probe: Probe) -> list[tuple]:
        """``probe``'s warm tasks, but those whose chain a compile cache
        already holds (its entry present: this process loads it at once)."""
        tasks = probe.warm_tasks(self.device)
        if self.compile_cache is None:
            return tasks
        return [(fn, args) for fn, args in tasks if fn is not measure.warm_chain
                or not os.path.exists(self.compile_cache.entry_path(measure.chain_cache_key(
                    chains.spec_by_name(args[0]), args[2], args[1], self.env)))]

    def _run_pending(self, pending: list[tuple[int, Probe]], ctx: ProbeContext,
                     results: dict, stage_ns: dict, pipeline: bool) -> None:
        """Prepare and time every pending probe.

        The probes' warm tasks run in the open :class:`CompilePool`, or in
        :func:`compile_workers_for` processes started for this run (shut
        down once every chain has landed when serial, at the run's end when
        pipelined). This process prepares each probe whose tasks have all
        landed (its chains then run from the modules the workers compiled,
        ``measure.load_chain``) and, pipelined, times it as soon as every
        probe before it is timed; while it waits it prepares the later
        probes that have landed, then runs the pool's local tasks. Serial,
        it prepares every probe first. A task that fails only costs its
        compile: prepare compiles (or fails and records) the same chain in
        this process.
        """
        t0 = time.perf_counter()
        stage0 = dict(stage_ns)
        own_tasks = {i: ts for i, p in pending if (ts := self._tasks_of(p))}
        n_tasks = sum(len(ts) for ts in own_tasks.values())
        workers = (0 if not n_tasks or CompilePool.current is not None
                   else compile_workers_for(self.device, n_tasks))
        own = (CompilePool(workers, runner=artifacts.warm_and_read if self.audit else None,
                           cache=self.compile_cache)
               if workers else None)
        pool = CompilePool.current or own
        if (own is None and pool is not None and n_tasks and pool.cache is not None
                and self.compile_cache is not None
                and pool.cache.root != self.compile_cache.root):
            raise ValueError("the open compile pool serves another compile cache than "
                             "this session's; open it with the session's cache")
        local0 = pool.local_s if pool is not None else 0.0
        waiting: dict[int, list] = {}
        if pool is not None and n_tasks:
            by_probe = dict(pending)
            pool.submit(warm_tasks([by_probe[i] for i in own_tasks], self.device,
                                   pool.workers))  # this order; the lookups below find them
            waiting = {i: list(zip(ts, pool.submit(ts))) for i, ts in own_tasks.items()}
        by_index, prepared = dict(pending), {}

        def land(i: int) -> None:
            for _, fut in waiting.pop(i, ()):
                self._log_warm(by_index[i], fut, self.compile_cache)
            prepared[i] = self._prepare(by_index[i], ctx, stage_ns)

        def landed(i: int) -> bool:
            return all(f.done() for _, f in waiting.get(i, ()))

        def wait_once(i: int | None) -> None:
            """Prepare a later probe that has landed, else run one local
            task, else wait for the next task to land."""
            ahead = next((j for j in waiting if j != i and landed(j)), None)
            if ahead is not None:
                land(ahead)
                return
            t1 = time.perf_counter_ns()
            if pool.local:  # this process's own tasks while the workers compile
                pool.run_local()
            else:
                concurrent.futures.wait([f for fs in waiting.values() for _, f in fs],
                                        return_when=concurrent.futures.FIRST_COMPLETED)
            stage_ns["warm"] += time.perf_counter_ns() - t1

        try:
            if not pipeline:
                for i, _ in pending:
                    if i not in waiting:
                        land(i)
                while waiting:
                    ready = [i for i in waiting if landed(i)]
                    if ready:
                        land(ready[0])
                    else:
                        wait_once(None)
                if own is not None:  # no worker beside the timing below
                    own.close()
            for i, probe in pending:
                while i not in prepared:
                    if landed(i):
                        land(i)
                    else:
                        wait_once(i)
                # what a probe prepared lives to the run's end, as in a serial
                # run: later probes may share it (a served model, by weak key)
                self._run_probe(i, probe, ctx, prepared[i], results, stage_ns)
        finally:
            if own is not None:
                own.close()
        if n_tasks and pool is not None:
            local_s = pool.local_s - local0
            logger.info("compile-ahead (%s): %d chains in %d worker processes; the run took "
                        "%.1f s: this process %.1f s preparing probes (their chains loaded "
                        "from the workers' modules), %.1f s timing, %.1f s on its own "
                        "tasks, %.1f s waiting", "pipelined" if pipeline else "serial", n_tasks,
                        pool.workers, time.perf_counter() - t0,
                        (stage_ns["compile"] - stage0["compile"]) / 1e9,
                        (stage_ns["time"] - stage0["time"]) / 1e9, local_s,
                        (stage_ns["warm"] - stage0["warm"]) / 1e9 - local_s)

    @staticmethod
    def _log_warm(probe: Probe, fut: concurrent.futures.Future,
                  cache: CompileCache | None = None) -> None:
        """Log a landed warm task; file the device code it read (the pool's
        runner was ``artifacts.warm_and_read``, or the task went through a
        compile cache) under the chain's name it gives, and count its cache
        lookup in ``cache``, the session's."""
        try:
            result = fut.result()
            logger.debug("warmed %s@%s in %.1f s: %s", probe.op, probe.opt_level,
                         result["s"], result["phases"])
        except Exception as e:  # noqa: BLE001 - advisory stage, see _prepare_all
            logger.warning("compile-ahead of %s@%s failed in a worker: %s: %s",
                           probe.op, probe.opt_level, type(e).__name__, e)
            return
        if "ptx" in result or "module" in result:
            artifacts.remember(result["chain"], result)
        if "cache_hit" in result and cache is not None:
            cache.note(tuple(result["cache_key"]), result["cache_hit"])

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
            logger.debug("prepared %s@%s in %.2f s", probe.op, probe.opt_level,
                         (time.perf_counter_ns() - t0) / 1e9)

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
            logger.debug("timed %s@%s in %.2f s", probe.op, probe.opt_level,
                         (time.perf_counter_ns() - t0) / 1e9)
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
