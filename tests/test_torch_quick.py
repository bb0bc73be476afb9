"""The whole slice on the CPU: ``python -m repro_torch characterize --plan
quick --device cpu`` against the JAX package's quick plan; the device policy;
and the port's import boundary.

The run is cut to size for the CPU: chain lengths (4, 8) at O3 and (2, 4) at
O0 instead of (64, 512) and (2, 10), 3 reps, no compile workers. The host
clock cannot resolve a few-op slope on a shared CPU, so a probe may end as a
``NoisySlopeError`` failure; the test holds the control flow, which does not
depend on that: every row of the plan ends as a record or a persisted
failure, records are cache hits on the next run, failures are re-run.
"""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.api.plan import named_plan as jax_named_plan
from repro_torch.api import QUICK_OPS, Plan, Probe, Session, cli
from repro_torch.core import measure
from repro_torch.core.latency_db import LatencyDB
from repro_torch.core.timing import Measurement, Timer
from repro_torch.kernels.common import resolve_device

ROOT = Path(__file__).resolve().parents[1]


def test_quick_plan_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(measure, "_CHAIN_LENS", {"O0": (2, 4), "O3": (4, 8)})
    db_path = tmp_path / "quick.json"
    args = ["characterize", "--plan", "quick", "--db", str(db_path), "--device", "cpu",
            "--reps", "3", "--warmup", "1", "--table"]
    rc = cli.main(args)
    out = capsys.readouterr().out
    db = LatencyDB(str(db_path))
    rows = {(r.op, r.opt_level) for r in db.records()}
    failed = {(f.op, f.opt_level) for f in db.failures()}
    assert rows | failed == {(p.op, p.opt_level) for p in jax_named_plan("quick")}
    assert not rows & failed
    # only an O3 chain of a few ops can drown in host noise here
    assert all(f.error_type == "NoisySlopeError" and f.opt_level == "O3"
               for f in db.failures())
    assert {("clock_overhead", "O0"), ("clock_overhead", "O3"),
            ("kernel.alu_chain.fma", "O3"), ("popc", "O3"), ("clz", "O3")} <= rows
    assert {(op, "O0") for op in QUICK_OPS} <= rows
    assert sum(op.startswith("mem.chase.ws") for op, _ in rows) == 3
    assert rc == (1 if failed else 0)
    assert f"{len(rows)} measured, 0 cached, {len(failed)} failed (36 probes)" in out
    assert "| category | op | dtype | Optimized | Non-Optimized |" in out
    for r in db.records():
        assert r.backend == "cpu" and r.device_kind == "cpu"
        assert r.jax_version.startswith("torch-") and r.jax_version.endswith("+cpu")
        assert "clock=host" in r.notes
    kernel_rows = [r for r in db.records() if r.op in ("popc", "clz")]
    assert all("kernel=op_chain." in r.notes for r in kernel_rows)

    # resume: every record is a cache hit; only the failed rows run again
    rc = cli.main(args)
    out = capsys.readouterr().out
    m = re.search(r"(\d+) measured, (\d+) cached, (\d+) failed \(36 probes\)", out)
    assert m and int(m[2]) == len(rows)
    assert int(m[1]) + int(m[3]) == len(failed)
    if not failed:
        assert "all probes were cache hits" in out


class _Boom(Probe):
    category = "test"

    def __init__(self, op, error=None):
        self.op, self.opt_level, self.dtype, self.error = op, "O3", "float32", error

    def run(self, ctx):
        if self.error is not None:
            raise self.error
        return self._record(ctx, Measurement(10.0, 1.0, 9.0, 3))


def test_failures_persist_and_are_superseded(tmp_path):
    path = str(tmp_path / "db.json")
    session = lambda: Session(db=path, device="cpu",  # noqa: E731
                              timer=Timer(warmup=0, reps=2, device="cpu"))
    result = session().run(Plan((_Boom("ok"), _Boom("boom", ValueError("bad operand")))))
    assert [r.status for r in result.results] == ["measured", "failed"]
    reloaded = LatencyDB(path)
    (failure,) = reloaded.failures()
    assert (failure.op, failure.error_type, failure.message) == ("boom", "ValueError", "bad operand")
    assert json.loads(Path(path).read_text())["failures"][0]["op"] == "boom"
    fixed = session().run(Plan((_Boom("ok"), _Boom("boom"))))
    assert [r.status for r in fixed.results] == ["cached", "measured"]
    assert LatencyDB(path).failures() == []


def test_interrupt_keeps_finished_probes(tmp_path):
    path = str(tmp_path / "db.json")
    timer = Timer(warmup=0, reps=2, device="cpu")
    with pytest.raises(KeyboardInterrupt):
        Session(db=path, device="cpu", timer=timer).run(
            Plan((_Boom("a"), _Boom("b", KeyboardInterrupt()), _Boom("c"))))
    result = Session(db=path, device="cpu", timer=timer).run(
        Plan((_Boom("a"), _Boom("b"), _Boom("c"))))
    assert [r.status for r in result.results] == ["cached", "measured", "measured"]


# ------------------------------------------------------------ device policy
def test_no_card_means_an_error_not_the_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the CLI runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    db = tmp_path / "db.json"
    assert cli.main(["characterize", "--plan", "quick", "--db", str(db)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not db.exists()
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "characterize",
                           "--plan", "quick", "--db", str(db)],
                          capture_output=True, text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert not db.exists()


def test_unported_plan_is_an_error(tmp_path, capsys):
    rc = cli.main(["characterize", "--plan", "collectives", "--device", "cpu",
                   "--db", str(tmp_path / "db.json")])
    assert rc == 2 and "not ported yet" in capsys.readouterr().err


# --------------------------------------------------------- import boundary
def _port_sources():
    yield from sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"


@pytest.mark.parametrize("path", list(_port_sources()), ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_corrupt_db_needs_recover(tmp_path, capsys):
    db = tmp_path / "db.json"
    args = ["characterize", "--plan", "quick", "--db", str(db), "--device", "cpu",
            "--ops", "clock_overhead", "--opt-levels", "O0", "--reps", "2",
            "--warmup", "0"]
    assert cli.main(args) == 0
    db.write_text(db.read_text()[:-20])  # a save cut short after the last record
    assert cli.main(args) == 2
    assert "--recover" in capsys.readouterr().err
    assert cli.main(args + ["--recover"]) == 0
    assert "0 measured, 1 cached" in capsys.readouterr().out


def test_adaptive_session_records_effective_reps(tmp_path):
    session = Session(device="cpu", timer=Timer(warmup=0, reps=8, device="cpu"),
                      adaptive=True)
    rec = session.run(Plan((_Boom("a"),))).measured[0].record
    assert "reps_eff=3" in rec.notes and "clock=host" in rec.notes
