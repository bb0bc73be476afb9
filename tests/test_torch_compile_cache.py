"""The port's compile cache against the JAX package's contract.

``repro_torch.core.compile_cache`` keeps the JAX package's names and
behaviour (``tests/test_pipeline.py`` and ``tests/test_api.py``'s cases):
a round trip with its counters, eviction and corrupt entries, per-run
deltas in ``ResultSet.summary``, and a sweep resumed after an interrupt
with a warm cache that compiles nothing. An entry here is not an
executable: Inductor keeps the O3 chain in its own caches under the
cache's directory, and the entry keeps what the audit reads of it, so a hit
is the entry read back *and* an Inductor cache hit by Inductor's counters.

The chains are real Inductor chains on the CPU, cut to lengths (4, 8) as
``test_torch_quick.py`` cuts them; their timing is scripted (a fixed
measurement), since what is under test is when chains compile, not the
host clock. One module-wide cache directory is filled once (a cold
Inductor compile on the CPU takes tens of seconds).
"""
import json
import os
import sys

import pytest

from repro.core.compile_cache import fidelity_key as jax_fidelity_key
from repro_torch.api import Plan, Probe, Session
from repro_torch.audit import artifacts
from repro_torch.core import measure
from repro_torch.core.compile_cache import CacheStats, CompileCache, fidelity_key
from repro_torch.core.latency_db import current_environment
from repro_torch.core.timing import Measurement, Timer

ROW = "add"


def _timer():
    return Timer(warmup=0, reps=2, clock_hz=1e9, device="cpu")


@pytest.fixture
def short_chains(monkeypatch):
    """O3 chains of 4 and 8 ops, timed by a fixed measurement (no retry)."""
    monkeypatch.setattr(measure, "_CHAIN_LENS", {**measure._CHAIN_LENS, "O3": (4, 8)})
    monkeypatch.setattr(measure, "run_prepared_op",
                        lambda prepared, timer: Measurement(5.0, 0.5, 4.5, 3))


@pytest.fixture(scope="module")
def warm_root(tmp_path_factory):
    """A compile cache directory that a first sweep filled with ``add``'s
    two O3 chains (the fill is asserted in the round-trip test)."""
    saved = {k: os.environ.get(k) for k in CompileCache("/tmp").environ()}
    root = str(tmp_path_factory.mktemp("cc") / "cache")
    mp = pytest.MonkeyPatch()
    mp.setattr(measure, "_CHAIN_LENS", {**measure._CHAIN_LENS, "O3": (4, 8)})
    mp.setattr(measure, "run_prepared_op", lambda prepared, timer: Measurement(5.0, 0.5, 4.5, 3))
    session = Session(device="cpu", timer=_timer(), compile_cache=root)
    first = session.run(Plan.instructions(ops=(ROW,), opt_levels=("O3",)))
    mp.undo()
    yield root, first
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_fidelity_key_layout_is_the_jax_packages():
    env = current_environment("cpu")
    key = fidelity_key(env, "add", "O3", "int32", "chain512")
    assert key == ("cpu", "cpu", env["jax_version"], "add", "O3", "int32", "chain512")
    assert key == jax_fidelity_key(env, "add", "O3", "int32", "chain512")
    assert env["jax_version"].startswith("torch-")  # the torch build where jax's stands


def test_round_trip_and_counters(warm_root, short_chains):
    root, first = warm_root
    # the first sweep compiled both chains and stored their entries
    assert first.cache_stats == CacheStats(hits=0, misses=2, stores=2, evictions=0, errors=0)
    assert "compile cache: 0 hits, 2 compiled" in first.summary()
    cache = CompileCache(root)
    assert len(cache) == 2
    env = current_environment("cpu")
    key = measure.chain_cache_key(measure.chains.spec_by_name(ROW), 8, "O3", env)
    entry = cache.load(key)
    # no device code on the CPU; the compiled module, the chain's result
    assert {k: entry[k] for k in ("ptx", "carry", "sass", "cubins")} == \
        {"ptx": [], "carry": {}, "sass": {}, "cubins": 0}
    assert os.path.exists(os.path.join(cache.root, "inductor", entry["module"]["path"]))
    assert measure.compiled_module(entry["module"]) is not None
    # Inductor's and Triton's caches live under the cache's root
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == os.path.join(cache.root, "inductor")
    assert os.path.isdir(os.path.join(cache.root, "inductor", "fxgraph"))
    # a second lookup: the entry reads back and the chain runs from its
    # module, nothing traced or compiled
    r = Session(device="cpu", timer=_timer(), compile_cache=cache).run(
        Plan.instructions(ops=(ROW,), opt_levels=("O3",)), force=True)
    assert r.cache_stats == CacheStats(hits=2)
    assert r.summary().endswith("compile cache: 2 hits, 0 compiled")


def test_cache_stats_are_per_run_deltas(warm_root, short_chains, tmp_path):
    root, _ = warm_root
    session = Session(db=str(tmp_path / "db.json"), device="cpu", timer=_timer(),
                      compile_cache=root)
    plan = Plan.instructions(ops=(ROW,), opt_levels=("O0", "O3"))
    r1 = session.run(plan)
    r2 = session.run(plan, force=True)
    for r in (r1, r2):  # O0 compiles nothing; each run counts its own two hits
        assert (r.cache_stats.hits, r.cache_stats.misses) == (2, 0)
    assert session.compile_cache.stats.hits == 4
    r3 = session.run(plan)  # every probe a DB hit: nothing prepared
    assert r3.cache_stats == CacheStats()
    assert "2 cached" in r3.summary() and "compile cache: 0 hits, 0 compiled" in r3.summary()


class _Boom(Probe):
    """A probe that interrupts the sweep when it is timed."""

    category = "test"

    def __init__(self, interrupt: bool):
        self.op, self.opt_level, self.dtype = "boom", "O3", "float32"
        self.interrupt = interrupt

    def run(self, ctx):
        if self.interrupt:
            raise KeyboardInterrupt
        return self._record(ctx, Measurement(1.0, 0.1, 0.9, 3))


def test_resume_after_interrupt_with_warm_compile_cache(warm_root, short_chains, tmp_path):
    """An interrupted sweep re-run with the same cache: the probe done before
    the interrupt is a DB hit from the journal, the rest measure, and their
    chains load from the cache: 0 compiled."""
    root, _ = warm_root
    db = tmp_path / "db.json"
    done = Plan.instructions(ops=(ROW,), opt_levels=("O0",))
    rest = Plan.instructions(ops=(ROW,), opt_levels=("O3",))
    with pytest.raises(KeyboardInterrupt):
        Session(db=str(db), device="cpu", timer=_timer(), compile_cache=root).run(
            done + Plan((_Boom(True),)) + rest, pipeline=False)
    assert os.path.exists(str(db) + ".journal")  # the O0 row is durable, uncompacted
    r = Session(db=str(db), device="cpu", timer=_timer(), compile_cache=root).run(
        done + Plan((_Boom(False),)) + rest)
    assert [x.status for x in r.results] == ["cached", "measured", "measured"]
    assert (r.cache_stats.hits, r.cache_stats.misses) == (2, 0)
    assert "0 compiled" in r.summary()
    assert not os.path.exists(str(db) + ".journal")  # compacted on save


def test_eviction_and_corrupt_entries(tmp_path):
    cache = CompileCache(str(tmp_path / "cc"), max_entries=1)
    cache.store(("k", "0"), {"ptx": ["a"]})
    os.utime(cache.entry_path(("k", "0")), (1, 1))  # the older one
    cache.store(("k", "1"), {"ptx": ["b"]})
    assert len(cache) == 1 and cache.stats.evictions == 1
    assert cache.load(("k", "0")) is None and cache.load(("k", "1")) == {"ptx": ["b"]}
    assert os.path.isdir(cache.root)  # eviction takes entry files only
    # a torn or foreign entry is a miss and one error, never a crash
    with open(cache.entry_path(("k", "torn")), "w") as f:
        f.write("{not json")
    assert cache.load(("k", "torn")) is None and cache.stats.errors == 1
    other = cache.entry_path(("k", "other"))
    os.replace(cache.entry_path(("k", "1")), other)  # an entry under a key not its own
    assert cache.load(("k", "other")) is None and cache.stats.errors == 2
    # what the lookup compiles after a bad entry is a miss, stored anew
    built, extra, hit = cache.load_or_compile(("k", "torn"), lambda: 7, extra=lambda b: {"b": b})
    assert (built, extra, hit) == (7, {"b": 7}, False) and cache.stats.misses == 1
    assert cache.load(("k", "torn")) == {"b": 7}


def test_a_worker_noted_lookup_is_counted_once(tmp_path):
    """A compile worker counts its chain (``note``); the session's own load
    of that chain right after counts nothing more."""
    cache = CompileCache(str(tmp_path / "cc"))
    cache.store(("k",), {"ptx": []})
    cache.note(("k",), hit=False)
    built, extra, hit = cache.load_or_compile(("k",), lambda: "loaded")
    assert built == "loaded" and extra == {"ptx": []}
    assert (cache.stats.hits, cache.stats.misses, cache.stats.stores) == (0, 1, 1)
    cache.load_or_compile(("k",), lambda: "again")  # not noted now: this one counts
    assert cache.stats.misses == 2


def test_the_audit_reads_device_code_from_an_entry(tmp_path):
    env = {"device_kind": "card", "backend": "cuda", "jax_version": "torch-x"}
    spec = measure.chains.spec_by_name("add")
    cache = CompileCache(str(tmp_path / "cc"))
    code = {"ptx": ["// ptx"], "carry": {"k": "k_param_0"}, "sass": {"IADD3": 9}, "cubins": 1}
    cache.store(measure.chain_cache_key(spec, 64, "O3", env), code)
    name = measure.chain_name("add", 64)
    assert artifacts.chain_artifacts(name) is None
    assert artifacts.chain_artifacts(name, cache, measure.chain_cache_key(
        spec, 64, "O3", env)) == code
    assert artifacts.chain_artifacts(name, cache, measure.chain_cache_key(
        spec, 512, "O3", env)) is None


def test_a_warm_process_compiles_nothing(warm_root, tmp_path):
    """``characterize --compile-cache`` in a fresh process on the warm
    cache: every chain a hit, run from the module its entry names, with no
    Inductor lowering and nothing asked of Inductor's caches."""
    import subprocess
    from pathlib import Path

    root, _ = warm_root
    src = Path(__file__).resolve().parents[1] / "src"
    script = (
        "import sys\n"
        "from repro_torch.core import measure\n"
        "from repro_torch.core.timing import Measurement\n"
        "from repro_torch.api import cli\n"
        "measure._CHAIN_LENS['O3'] = (4, 8)\n"
        "measure.run_prepared_op = lambda prepared, timer: Measurement(5.0, 0.5, 4.5, 3)\n"
        "sys.exit(cli.main(sys.argv[1:]))\n")
    proc = subprocess.run(
        [sys.executable, "-c", script, "characterize", "--plan", "quick", "--device", "cpu",
         "--ops", ROW, "--opt-levels", "O3", "--db", str(tmp_path / "db.json"),
         "--compile-cache", root, "--reps", "2", "--warmup", "0"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(src)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "compile cache: 2 hits, 0 compiled" in proc.stdout
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("compile cache /"))
    assert "lowering 0.000 s" in line
    counts = json.loads(line.split("inductor ", 1)[1].split("; lowering")[0])
    # the chains ran from their compiled modules: Inductor was not asked
    assert not any(v for k, v in counts.items() if k.endswith("_miss"))
    assert not counts.get("inductor.fxgraph_cache_hit")


WORKERS_SCRIPT = """
import sys

from repro_torch.api import Plan, Session, session as session_mod
from repro_torch.core import measure
from repro_torch.core.timing import Measurement, Timer

if __name__ == "__main__":
    measure._CHAIN_LENS["O3"] = (4, 8)
    measure.run_prepared_op = lambda prepared, timer: Measurement(5.0, 0.5, 4.5, 3)
    # the session warms in workers only on the card; take two here as well
    session_mod.compile_workers_for = lambda device, n_tasks: 2
    plan = Plan.instructions(ops=("add",), opt_levels=("O3",))
    for force in (False, True):
        r = Session(device="cpu", timer=Timer(warmup=0, reps=2, clock_hz=1e9, device="cpu"),
                    compile_cache=sys.argv[1]).run(plan, force=force)
        print("run", r.cache_stats.hits, r.cache_stats.misses, r.cache_stats.stores,
              int(r.stage_ns["warm"] > 0))
"""


def test_compile_workers_fill_the_cache_and_a_warm_run_starts_none(warm_root, tmp_path):
    """The compile workers of a cached session compile through the cache and
    store each chain's entry; the session counts their lookups (two chains
    compiled: no entry was there) and loads the chains without counting them
    again. The next run finds every entry, starts no worker and loads both
    chains: 2 hits. (Inductor's own cache is the warm one, copied, so the
    workers' compiles are loads.)"""
    import shutil
    import subprocess
    from pathlib import Path

    shutil.copytree(os.path.join(warm_root[0], "inductor"), tmp_path / "cc" / "inductor")
    script = tmp_path / "main_script.py"
    script.write_text(WORKERS_SCRIPT)
    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "cc")],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(src)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    runs = [ln.split()[1:] for ln in proc.stdout.splitlines() if ln.startswith("run ")]
    # hits, misses, stores in this process, waited on workers
    assert runs == [["0", "2", "0", "1"], ["2", "0", "0", "0"]], proc.stdout
    assert len(CompileCache(str(tmp_path / "cc"))) == 2  # the workers stored them


def test_a_module_that_disagrees_with_its_entry_is_compiled_instead(warm_root, short_chains,
                                                                    tmp_path):
    """An entry whose module gives another result than the one it keeps is
    stale: the chain compiles (Inductor's cache still serves it), the entry
    is written anew, and the next run loads the module again."""
    import shutil

    root = tmp_path / "cc"
    shutil.copytree(warm_root[0], root)
    cache = CompileCache(str(root))
    env = current_environment("cpu")
    key = measure.chain_cache_key(measure.chains.spec_by_name(ROW), 8, "O3", env)
    cache.store(key, {**cache.load(key), "out": 12345})
    plan = Plan.instructions(ops=(ROW,), opt_levels=("O3",))
    r = Session(device="cpu", timer=_timer(), compile_cache=str(root)).run(plan)
    assert (r.cache_stats.hits, r.cache_stats.misses) == (1, 1)
    assert cache.load(key)["out"] != 12345
    r = Session(device="cpu", timer=_timer(), compile_cache=str(root)).run(plan, force=True)
    assert (r.cache_stats.hits, r.cache_stats.misses) == (2, 0)
