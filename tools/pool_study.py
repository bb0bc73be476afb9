#!/usr/bin/env python3
"""How much the session's own compiles slow the compile workers, on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/pool_study.py [--rounds=1] [--out=PATH]

``chip_smoke.py`` compiles and captures the O1 chains of the 15 quick rows
in its own process (``CompilePool.local``) while the compile workers build
the O3 chains of quick and table2, one worker a core. This study runs the
quick plan's 26 O3 warm tasks in a fresh pool, with empty Inductor and
Triton caches, once with those O1 chains compiled and captured in this
process meanwhile (``on``) and once without (``off``), in the order off,
on, on, off each round, each run a process of its own with cache
directories of its own. For each run it prints the pool's wall seconds
(from the submit until every task is done), the sum of its tasks' seconds
(chain-seconds) and the local tasks run and their seconds, then each
mode's medians; a JSON file (``--out``, by default
``build/pool_study.json``) keeps every run.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MODES = ("off", "on", "on", "off")


def one_run(mode: str) -> dict:
    """The quick plan's O3 warm tasks in a fresh pool, with the O1 chains of
    the quick rows as this process's local tasks while it waits (``on``)
    or none (``off``)."""
    import torch

    from repro_torch.api.plan import QUICK_OPS, named_plan
    from repro_torch.api.session import CompilePool, compile_workers_for, warm_tasks
    from repro_torch.core import measure

    dev = torch.device("cuda:0")
    tasks = warm_tasks(named_plan("quick"), dev)
    with CompilePool(compile_workers_for(dev, len(tasks))) as pool:
        t0 = time.perf_counter()
        futures = pool.submit(tasks)
        if mode == "on":
            pool.local += [(measure.prepare_o1_chain, (name, n, str(dev)))
                           for name in QUICK_OPS for n in reversed(measure._CHAIN_LENS["O1"])]
        ran = 0
        while not all(f.done() for f in futures):
            if pool.local:
                pool.run_local()
                ran += 1
            else:
                concurrent.futures.wait(futures)
        wall = time.perf_counter() - t0
        return {"mode": mode, "workers": pool.workers, "tasks": len(tasks), "wall_s": wall,
                "chain_s": sum(f.result()["s"] for f in futures), "local_tasks": ran,
                "local_s": pool.local_s}


def main() -> int:
    args = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--") and "=" in a)
    if "run" in args:  # a child: one run, its result as the last line
        print(json.dumps(one_run(args["run"])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("pool_study: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    out = Path(args.get("out", ROOT / "build" / "pool_study.json"))
    (ROOT / "build").mkdir(exist_ok=True)
    _build.build()  # K2, which popc's and clz's O1 chains launch, built before any run
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}, "
          f"{os.cpu_count()} cores", flush=True)
    runs = []
    for _ in range(int(args.get("rounds", "1"))):
        for mode in MODES:
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as cache:
                env = {**os.environ, "TORCHINDUCTOR_CACHE_DIR": f"{cache}/inductor",
                       "TRITON_CACHE_DIR": f"{cache}/triton"}
                proc = subprocess.run([sys.executable, __file__, f"--run={mode}"], env=env,
                                      capture_output=True, text=True, check=True)
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(run)
            print(f"pool {mode}: wall {run['wall_s']:.2f} s, {run['tasks']} tasks on "
                  f"{run['workers']} workers {run['chain_s']:.2f} chain-s, local "
                  f"{run['local_tasks']} tasks {run['local_s']:.2f} s", flush=True)
    for mode in ("off", "on"):
        mine = [r for r in runs if r["mode"] == mode]
        print(f"pool {mode} median: wall {statistics.median(r['wall_s'] for r in mine):.2f} s, "
              f"chain-s {statistics.median(r['chain_s'] for r in mine):.2f}")
    out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
