"""The session's compile-ahead pipeline against the JAX package's.

The invariant is the JAX package's (``tests/test_pipeline.py``): pipelining
changes when compiles happen, never what is measured. On a scripted plan
with a prepare error and a run error, pipelined and serial runs give the
same statuses, records and failures, field for field, in both packages.
Timing runs only in the session's process and thread; the compile workers
are processes. The pool's tasks are ordered so that probes land one after
another in plan order (``session.warm_tasks``), and the CLI takes
``--serial`` and ``--resume`` as the JAX package's does.
"""
import os
import threading
import time

import pytest

from repro.api import Plan as JaxPlan
from repro.api import Probe as JaxProbe
from repro.api import Session as JaxSession
from repro.core.timing import Measurement as JaxMeasurement
from repro.core.timing import Timer as JaxTimer
from repro_torch.api import Plan, Probe, Session, cli
from repro_torch.api import session as session_mod
from repro_torch.api.session import warm_tasks
from repro_torch.core.timing import Measurement, Timer

FIELDS = ("op", "latency_ns", "mad_ns", "net_latency_ns", "cycles", "n_samples", "guard")


def _split_probe(base, measurement):
    """A scripted probe over ``base`` (either package's Probe): a fixed
    measurement, optional prepare and run errors, and a log of where each
    half ran (pid, thread)."""

    class SplitProbe(base):
        category = "test"

        def __init__(self, op, value, prepare_error=None, run_error=None, log=None,
                     tasks=()):
            self.op, self.opt_level, self.dtype = op, "O3", "float32"
            self.value = value
            self.prepare_error, self.run_error = prepare_error, run_error
            self.log = log if log is not None else []
            self.tasks = list(tasks)

        def warm_tasks(self, device):
            return self.tasks

        def prepare(self, ctx):
            self.log.append(("prepare", self.op, os.getpid(), threading.current_thread().name))
            if self.prepare_error is not None:
                raise self.prepare_error
            return ("prepared", self.op)

        def run_prepared(self, ctx, prepared):
            self.log.append(("run", self.op, os.getpid(), threading.current_thread().name,
                             time.time()))
            if self.run_error is not None:
                raise self.run_error
            return self._record(ctx, measurement(self.value, self.value / 8, self.value, 5))

        def run(self, ctx):
            return self.run_prepared(ctx, None)

    return SplitProbe


TorchSplit = _split_probe(Probe, Measurement)
JaxSplit = _split_probe(JaxProbe, JaxMeasurement)


def _scripted(cls):
    return (cls("alpha", 12.0), cls("bad-prep", 1.0, prepare_error=ValueError("no lowering")),
            cls("beta", 34.5), cls("bad-run", 1.0, run_error=RuntimeError("timed out")),
            cls("gamma", 56.25))


def _torch_session():
    # a fixed clock: the cycles field must not depend on calibration noise
    return Session(device="cpu", timer=Timer(warmup=0, reps=2, clock_hz=1e9, device="cpu"))


def _fields(result):
    out = []
    for r in result.results:
        if r.record is not None:
            out.append((r.status, tuple(getattr(r.record, f) for f in FIELDS)))
        else:
            out.append((r.status, r.failure.op, r.failure.error_type, r.failure.message))
    return out


def test_pipelined_records_identical_to_serial_and_to_the_jax_package():
    serial = _torch_session().run(Plan(_scripted(TorchSplit)), pipeline=False)
    piped = _torch_session().run(Plan(_scripted(TorchSplit)), pipeline=True)
    assert [r.status for r in piped.results] == \
        ["measured", "failed", "measured", "failed", "measured"]
    assert _fields(serial) == _fields(piped)
    # the JAX package's session on the same script gives the same outcomes
    jax_timer = JaxTimer(warmup=0, reps=2, clock_hz=1e9)
    jax_serial = JaxSession(timer=jax_timer).run(JaxPlan(_scripted(JaxSplit)), pipeline=False)
    jax_piped = JaxSession(timer=JaxTimer(warmup=0, reps=2, clock_hz=1e9)).run(
        JaxPlan(_scripted(JaxSplit)), pipeline=True)
    assert _fields(jax_serial) == _fields(jax_piped)
    assert [s for s, *_ in _fields(piped)] == [s for s, *_ in _fields(jax_piped)]
    for mine, theirs in zip(_fields(piped), _fields(jax_piped)):
        if mine[0] == "measured":
            assert mine[1][FIELDS.index("latency_ns")] == theirs[1][FIELDS.index("latency_ns")]
        else:
            assert mine[1:] == theirs[1:]


def test_serial_prepares_everything_before_timing_and_pipelined_interleaves():
    for pipeline, want in ((False, ["prepare"] * 3 + ["run"] * 3),
                           (True, ["prepare", "run"] * 3)):
        log = []
        plan = Plan(tuple(TorchSplit(f"p{i}", 10.0 * (i + 1), log=log) for i in range(3)))
        _torch_session().run(plan, pipeline=pipeline)
        assert [e[0] for e in log] == want
        assert {(e[2], e[3]) for e in log} == {(os.getpid(), threading.current_thread().name)}


def _sleep_task(name, opt_level, n, device):
    """A warm task for the pool: n hundredths of a second of work."""
    time.sleep(n / 100)
    return {"chain": f"{name}_{n}", "s": n / 100, "phases": {}, "out": 0.0}


def test_pipelined_times_a_probe_while_the_workers_compile_the_rest(monkeypatch):
    """With a real worker process: the first probe is timed before the last
    probe's task has landed, and every timing happens in this process."""
    monkeypatch.setattr(session_mod, "compile_workers_for", lambda device, n_tasks: 1)
    log = []
    plan = Plan(tuple(TorchSplit(f"p{i}", 1.0, log=log,
                                 tasks=[(_sleep_task, (f"p{i}", "O3", 150, "cpu"))])
                      for i in range(3)))
    result = _torch_session().run(plan)
    assert [r.status for r in result.results] == ["measured"] * 3
    runs = [e for e in log if e[0] == "run"]
    assert {(e[2], e[3]) for e in runs} == {(os.getpid(), threading.current_thread().name)}
    # the tasks run one after another in the one worker, 1.5 s each: the
    # first probe was timed at least a task's length before the last one
    assert runs[-1][4] - runs[0][4] > 2.0
    assert result.stage_ns["warm"] > 0


class _Task:
    def __init__(self, name, n):
        self.name, self.n = name, n

    def warm_tasks(self, device):
        return [(_sleep_task, (self.name, "O3", m, str(device))) for m in self.n]


def test_warm_tasks_land_the_probes_in_plan_order_and_end_short():
    probes = [_Task(f"r{i}", (512, 64)) for i in range(30)]
    probes.append(_Task("r3", (512, 64)))  # a probe again: its tasks go once
    tasks = warm_tasks(probes, "cpu", workers=2)
    assert len(tasks) == 60 and len({t[1] for t in tasks}) == 60
    longs = [t[1][0] for t in tasks if t[1][2] == 512]
    # every long chain in plan order (the last 3 * workers probes' longest
    # first among the tail, which is plan order at one length)
    assert longs == [f"r{i}" for i in range(30)]
    # a probe's short chain follows 2 * workers probes after its long one
    pos = {(t[1][0], t[1][2]): k for k, t in enumerate(tasks)}
    for i in range(20):
        assert pos[(f"r{i}", 64)] == pos[(f"r{i + 4}", 512)] + 1
    # the pool's last tasks are short ones
    assert all(t[1][2] == 64 for t in tasks[-10:])


def test_warm_tasks_keep_the_pool_as_short_as_longest_first():
    """A FIFO pool of 8 workers over the new order ends no later than 3 %
    after one over longest-first order (the 0.135 s a worker-second that
    PERF.md allows is 8 % over the ideal 0.125), on chains of 9 and 1 time
    units (a 512-op chain against a 64-op one) and a few slow rows."""
    import heapq

    dur = {f"r{i}": 9.0 + (10.0 if i % 13 == 5 else 0.0) for i in range(65)}
    probes = [_Task(name, (512, 64)) for name in dur]

    def span(tasks):
        free = [0.0] * 8
        for _, (name, _, n, _) in tasks:
            heapq.heappush(free, heapq.heappop(free) + (dur[name] if n == 512 else 1.0))
        return max(free)

    lpt = sorted(warm_tasks(probes, "cpu", workers=0),
                 key=lambda t: -(dur[t[1][0]] if t[1][2] == 512 else 1.0))
    assert span(warm_tasks(probes, "cpu", workers=8)) <= 1.03 * span(lpt)


def test_cli_takes_serial_resume_and_compile_cache(tmp_path, capsys):
    db = str(tmp_path / "db.json")
    assert cli.main(["characterize", "--plan", "quick", "--db", db, "--device", "cpu",
                     "--force", "--resume"]) == 2
    assert "--force and --resume are mutually exclusive" in capsys.readouterr().err
    parser = cli.build_parser()
    args = parser.parse_args(["characterize", "--plan", "quick", "--db", db, "--serial",
                              "--resume", "--compile-cache", str(tmp_path / "cc")])
    assert args.serial and args.resume and args.compile_cache == str(tmp_path / "cc")
    rc = cli.main(["characterize", "--plan", "quick", "--db", db, "--device", "cpu",
                   "--ops", "clock_overhead", "--opt-levels", "O0", "--serial", "--resume",
                   "--compile-cache", str(tmp_path / "cc"), "--reps", "2", "--warmup", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "1 measured, 0 cached, 0 failed (1 probes), compile cache: 0 hits, 0 compiled" in out
    audit = cli.build_parser().parse_args(["audit", "--db", db, "--compile-cache", "d",
                                           "--lint", "--dataflow"])
    assert audit.compile_cache == "d" and audit.dataflow


@pytest.mark.parametrize("flag", ["--serial", "--resume", "--compile-cache"])
def test_cli_help_names_the_flags(flag, capsys):
    with pytest.raises(SystemExit):
        cli.main(["characterize", "--help"])
    out = capsys.readouterr().out
    assert flag in out and "not ported" not in out
