#!/usr/bin/env python3
"""Does timing a row in the compile pool's wait change it?

``chip_smoke.py`` times table2's rows as their chains land, while the
compile workers build the rest on every core, and times the memory plans in
the pool's wait too. This study times the same rows beside the workers and
again once the pool has finished, on one host, and holds each row against
its twin. Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/wait_study.py [--out chiprun_out/wait_study.json]

1. It opens the pool ``chip_smoke.py`` opens (quick's and table2's O3
   chains, in ``session.warm_tasks``' order, one worker per CPU, a compile
   cache under ``build/``) and, while the workers compile, runs the memory
   and memory-inkernel plans, then quick and table2 (pipelined: each probe
   timed as soon as its chains have landed) into DB A.
2. Once the pool has finished it runs table2 (``force``: every chain a load
   from the compile cache) and the two memory plans again, into DB B.
3. Each row of A against its twin in B: within the larger of 5 % and 3 x
   the twin's MAD, and off by more than 20 %. The bound (PERF.md section 2,
   written before the first run): at least 95 % of the rows within, none
   off by more than 20 %, for table2's 146 rows and for the memory plans'
   22. A row that failed in either run (a folded O3 chain) is left out and
   named.

It prints a line per row outside the bound, the counts, the pool's span
and worker-seconds, and the card's name and power limit, and writes every
row to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WITHIN_REL, MAD_K, OFF_REL, SHARE = 0.05, 3.0, 0.20, 0.95


def compare(plan, db_a, db_b, env) -> dict:
    """Each probe of ``plan`` in A against its twin in B."""
    rows, left_out = [], []
    for probe in plan:
        a, b = db_a.get(probe.key(env)), db_b.get(probe.key(env))
        if a is None or b is None:
            left_out.append(f"{probe.op}@{probe.opt_level}")
            continue
        diff = a.latency_ns - b.latency_ns
        tol = max(WITHIN_REL * abs(b.latency_ns), MAD_K * b.mad_ns)
        rel = abs(diff) / abs(b.latency_ns) if b.latency_ns else (0.0 if not diff else 1e9)
        rows.append({"row": f"{probe.op}@{probe.opt_level}", "wait_ns": a.latency_ns,
                     "after_ns": b.latency_ns, "after_mad_ns": b.mad_ns, "rel": rel,
                     "within": abs(diff) <= tol, "off20": rel > OFF_REL})
    within = sum(r["within"] for r in rows)
    off = [r["row"] for r in rows if r["off20"]]
    return {"rows": rows, "left_out": left_out, "within": within, "compared": len(rows),
            "off20": off, "met": bool(rows) and within >= SHARE * len(rows) and not off}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wait_study: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.api.plan import named_plan
    from repro_torch.api.session import CompilePool, Session, compile_workers_for, warm_tasks
    from repro_torch.audit import artifacts
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.latency_db import LatencyDB, current_environment
    from repro_torch.core.timing import Timer
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "wait_study.json"))
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    env = current_environment(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    quick, table2 = named_plan("quick"), named_plan("table2")
    memory = (named_plan("memory") + named_plan("memory-inkernel")).dedupe()
    probes = list(quick) + list(table2)
    workers = compile_workers_for(dev, len(warm_tasks(probes, dev)))
    tasks = warm_tasks(probes, dev, workers)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cache = CompileCache(str(Path(tmp) / "compile_cache"))
        cache.use()
        db_a, db_b = str(Path(tmp) / "wait.json"), str(Path(tmp) / "after.json")

        def session(db):  # pipelined: timed as the chains land (the card's default is serial)
            return Session(db=db, device=dev, timer=Timer(device=dev), compile_cache=cache,
                           pipeline=True)

        with CompilePool(workers, runner=artifacts.warm_and_read, cache=cache) as pool:
            pool.submit(tasks)
            _build.build()
            t0 = time.perf_counter()
            session(db_a).run(memory)
            session(db_a).run(quick)
            session(db_a).run(table2)
            print(f"wait: memory, quick and table2 took {time.perf_counter() - t0:.1f} s "
                  "beside the workers")
        done = [f.result() for f in pool.futures.values() if f.exception() is None]
        span = max(r["done_at"] for r in done) - pool.started_at
        busy = sum(r["done_at"] - r["started_at"] for r in done)
        t0 = time.perf_counter()
        session(db_b).run(table2, force=True)
        session(db_b).run(memory, force=True)
        print(f"after: table2 and memory took {time.perf_counter() - t0:.1f} s after the pool")
        a, b = LatencyDB(db_a), LatencyDB(db_b)
        result = {"card": card, "workers": workers, "pool_span_s": span,
                  "worker_seconds": busy, "table2": compare(table2, a, b, env),
                  "memory": compare(memory, a, b, env)}
    for group in ("table2", "memory"):
        r = result[group]
        for row in r["rows"]:
            if not row["within"] or row["off20"]:
                print(f"{group}: {row['row']}: wait {row['wait_ns']:.3f} ns, after "
                      f"{row['after_ns']:.3f} ns (MAD {row['after_mad_ns']:.3f}), "
                      f"{100 * row['rel']:.1f} % off")
        print(f"{group}: {r['within']} of {r['compared']} rows within max(5 %, 3 x MAD); "
              f"{len(r['off20'])} off by more than 20 % {r['off20']}; left out (failed in a "
              f"run) {r['left_out']}; bound met: {r['met']}")
    print(f"pool: {workers} workers, span {span:.1f} s, {busy:.1f} worker-seconds; {card}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if result["table2"]["met"] and result["memory"]["met"] else 1


if __name__ == "__main__":
    sys.exit(main())
