"""The session's compile workers fill the cache the session then reads.

The session runs each chain from the module its worker compiled
(``measure.load_chain``); a ``torch.compile`` of the same chain in the
session must still be a hit of the cache the workers filled.

A chain compiled in a worker process must hash like the same chain compiled
in the session, or the worker's compile is wasted and the session compiles
again (on the card that cost tens of seconds per 512-op chain). The key used
to depend on which loaded module pickle found ``torch.contiguous_format``
through: a main script that imports torch (as ``chip_smoke.py`` does) made
the worker's keys differ from the session's.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core.optlevels import stable_cache_keys

ROOT = Path(__file__).resolve().parents[1]


def test_memory_format_pickles_by_name():
    stable_cache_keys()
    for fmt in (torch.contiguous_format, torch.channels_last, torch.preserve_format):
        blob = pickle.dumps(fmt)
        assert b"__main__" not in blob and b"pydoc" in blob
        assert pickle.loads(blob) is fmt


SCRIPT = """
import sys
import torch  # a main script that imports torch, as chip_smoke.py does

from torch._dynamo.utils import counters

from repro_torch.api import Plan, Session, session as session_mod
from repro_torch.core import measure
from repro_torch.core.timing import Measurement, Timer

if __name__ == "__main__":
    measure._CHAIN_LENS["O3"] = (3, 7)
    # a fixed measurement: a noisy host slope would compile a widened chain
    measure.run_prepared_op = lambda prepared, timer: Measurement(5.0, 0.5, 4.5, 3)
    # the session warms in workers only on the card; take two here as well
    session_mod.compile_workers_for = lambda device, n_tasks: 2
    session = Session(device="cpu", timer=Timer(warmup=0, reps=3, device="cpu"))
    # add is guarded: its record takes the guard baseline, whose chains are
    # add's own, served by the workers' compiles as well; mul's record finds
    # that baseline in the DB
    result = session.run(Plan.instructions(ops=("add", "mul"), opt_levels=("O3",)))
    assert result.stage_ns["warm"] > 0 and not result.failed, result.summary()
    # the session ran every chain from the modules the workers compiled
    print("session", counters["inductor"]["fxgraph_cache_miss"],
          counters["inductor"]["fxgraph_cache_hit"])
    # and torch.compile here finds the workers' compiles in Inductor's cache,
    # at both lengths
    spec = measure.chains.spec_by_name("mul")
    for n in (3, 7):
        fn = measure.compile_chain(spec, n, "O3", "cpu")
        fn(spec.carry("cpu"), *spec.operand_tensors("cpu"))
    print("after", counters["inductor"]["fxgraph_cache_miss"])
    print("hits", counters["inductor"]["fxgraph_cache_hit"])
"""


def test_worker_compiles_are_cache_hits_in_the_session(tmp_path):
    script = tmp_path / "main_script.py"
    script.write_text(SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "TORCHINDUCTOR_CACHE_DIR": str(tmp_path / "inductor")}  # a fresh cache
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    # every chain was served by the workers' compiles: the session compiled
    # none, and a compile of mul's chain at either length here is a hit
    misses, session_hits = proc.stdout.split("session")[-1].split()[:2]
    assert (misses, session_hits) == ("0", "0"), proc.stdout
    assert int(proc.stdout.split("after")[-1].split()[0]) == 0, proc.stdout
    hits = int(proc.stdout.split("hits")[-1])
    assert hits >= 2, proc.stdout
