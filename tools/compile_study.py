#!/usr/bin/env python3
"""Where the O3 chains' compile time goes on a CUDA card's host.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/compile_study.py [--parts=cpus,alone,crowd,crowd1t] [--out=PATH]

``chip_smoke.py`` compiles the 130 O3 chains of quick and table2 in one
pool of compile workers while its own process compiles and captures the
O1 chains of the quick rows (``CompilePool.local``). This study asks why
one of those compiles takes many times as long there as the same
Inductor lowering takes alone:

* ``cpus``: the CPUs the process may use: ``os.cpu_count()``,
  ``len(os.sched_getaffinity(0))``, the cgroup's ``cpu.max`` and
  ``cpu.stat``, the load average, torch's intra-op threads
  (read-only reads under ``/proc`` and ``/sys/fs/cgroup``);
* ``alone``: ``add.float32``, ``mad.cc`` and ``fma.float16`` at n 512, one
  after another in a pool of one worker, each timed by phase with the
  worker's CPU seconds beside its wall seconds; then the same three again
  under cProfile (Inductor's and AOTAutograd's caches off, so they compile
  anew), the functions that took the most time listed;
* ``crowd``: the same three and five more n-512 chains in a pool of
  ``compile_workers_for`` workers while this process compiles and captures
  the O1 chains of the 15 quick rows, as ``chip_smoke.py`` runs them;
* ``crowd1t``: ``crowd`` with one intra-op thread in every process
  (``torch.set_num_threads(1)``);
* ``usable``: ``crowd1t`` on as many workers as the affinity mask holds
  CPUs, less one for this process.

Each run is a process of its own with empty Inductor and Triton caches. A
worker's CPU seconds far below its wall seconds mean it waited for a CPU.
Everything it prints goes to standard output; a JSON file (``--out``, by
default ``build/compile_study.json``) keeps every run.
"""
from __future__ import annotations

import concurrent.futures
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

THREE = ("add.float32", "mad.cc", "fma.float16")
MORE = ("mul.float32", "xor", "sub.float16", "fma.bfloat16", "and")
N = 512


def _read(path: str) -> str | None:
    try:
        return Path(path).read_text().strip()
    except OSError:
        return None


def cpus() -> dict:
    import torch

    model = [l.split(":", 1)[1].strip() for l in (_read("/proc/cpuinfo") or "").splitlines()
             if l.startswith("model name")]
    return {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "cgroup_cpu_max": _read("/sys/fs/cgroup/cpu.max"),
            "cgroup_v1_quota": _read("/sys/fs/cgroup/cpu/cpu.cfs_quota_us"),
            "cgroup_v1_period": _read("/sys/fs/cgroup/cpu/cpu.cfs_period_us"),
            "cgroup_cpu_stat": _read("/sys/fs/cgroup/cpu.stat"),
            "loadavg": _read("/proc/loadavg"), "cpu_models": sorted(set(model)),
            "cpuinfo_processors": len(model), "torch_threads": torch.get_num_threads(),
            "torch_interop_threads": torch.get_num_interop_threads()}


def profiled(fn, *args, profile: bool = False, threads: int = 0) -> dict:
    """Run one warm task in a worker: its result, with the worker's CPU
    seconds and, with ``profile``, the 30 functions of most own time and
    most cumulative time."""
    import torch

    if threads:
        torch.set_num_threads(threads)
    if profile:
        torch._inductor.config.fx_graph_cache = False
        torch._functorch.config.enable_autograd_cache = False
    c0, t0 = time.process_time(), time.perf_counter()
    prof = cProfile.Profile() if profile else None
    if prof:
        prof.enable()
    result = fn(*args)
    if prof:
        prof.disable()
    result.update(cpu_s=time.process_time() - c0, wall_s=time.perf_counter() - t0,
                  pid=os.getpid(), threads=torch.get_num_threads())
    if prof:
        for key in ("tottime", "cumulative"):
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(key).print_stats(30)
            result[f"top_{key}"] = out.getvalue()
    return result


def one_run(kind: str) -> dict:
    import torch

    from repro_torch.api.plan import QUICK_OPS
    from repro_torch.api.session import CompilePool, compile_workers_for
    from repro_torch.core import measure

    dev = torch.device("cuda:0")
    threads = 1 if kind in ("crowd1t", "usable") else 0
    if threads:
        torch.set_num_threads(threads)
    rows = THREE if kind == "alone" else THREE + MORE
    tasks = [(measure.warm_chain, (name, "O3", N, str(dev))) for name in rows]
    workers = (1 if kind == "alone" else
               max(len(os.sched_getaffinity(0)) - 1, 1) if kind == "usable" else
               compile_workers_for(dev, 130))
    out = {"kind": kind, "workers": workers, "threads": threads, "chains": {}}
    with CompilePool(workers) as pool:
        t0 = time.perf_counter()
        futures = {name: pool._executor.submit(profiled, fn, *args, threads=threads)
                   for name, (fn, args) in zip(rows, tasks)}
        if kind != "alone":
            pool.local += [(measure.prepare_o1_chain, (name, n, str(dev)))
                           for name in QUICK_OPS for n in reversed(measure._CHAIN_LENS["O1"])]
        while not all(f.done() for f in futures.values()):
            if pool.local:
                pool.run_local()
            else:
                concurrent.futures.wait(futures.values())
        out["wall_s"] = time.perf_counter() - t0
        out["local_s"] = pool.local_s
        out["chains"] = {name: f.result() for name, f in futures.items()}
        if kind == "alone":
            prof = {name: pool._executor.submit(profiled, fn, *args, profile=True)
                    for name, (fn, args) in zip(rows, tasks)}
            out["profiled"] = {name: f.result() for name, f in prof.items()}
    return out


def show(run: dict) -> None:
    print(f"{run['kind']}: {run['workers']} worker(s), intra-op threads "
          f"{run['threads'] or 'default'}: wall {run['wall_s']:.2f} s, O1 local "
          f"{run['local_s']:.2f} s", flush=True)
    for name, r in run["chains"].items():
        ph = r["phases"]
        print(f"  {name}@O3 n {N}: {r['s']:.2f} s, worker CPU {r['cpu_s']:.2f} s "
              f"({r['cpu_s'] / r['wall_s']:.2f} of its wall), lower "
              f"{ph.get('GraphLowering.run', 0.0):.2f}, sched "
              f"{ph.get('Scheduler.__init__', 0.0):.2f}, codegen "
              f"{ph.get('Scheduler.codegen', 0.0):.2f}, torch threads {r['threads']}",
              flush=True)
    for name, r in run.get("profiled", {}).items():
        print(f"  profiled {name}@O3 n {N}: {r['s']:.2f} s under cProfile (lower "
              f"{r['phases'].get('GraphLowering.run', 0.0):.2f})")
        print("\n".join(r["top_tottime"].splitlines()[:45]))


def main() -> int:
    args = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--") and "=" in a)
    if "run" in args:  # a child: one run, its result as the last line
        print(json.dumps(one_run(args["run"])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compile_study: no CUDA device", file=sys.stderr)
        return 1
    parts = args.get("parts", "cpus,alone,crowd,crowd1t,usable").split(",")
    out = Path(args.get("out", ROOT / "build" / "compile_study.json"))
    (ROOT / "build").mkdir(exist_ok=True)
    from repro_torch.kernels import _build
    _build.build()  # K2, which popc's and clz's O1 chains launch
    study = {"torch": torch.__version__, "card": torch.cuda.get_device_name(0), "runs": []}
    if "cpus" in parts:
        study["cpus"] = cpus()
        print(f"cpus: {json.dumps(study['cpus'])}", flush=True)
    for kind in [p for p in parts if p != "cpus"]:
        stat0 = _read("/sys/fs/cgroup/cpu.stat")
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as cache:
            env = {**os.environ, "TORCHINDUCTOR_CACHE_DIR": f"{cache}/inductor",
                   "TRITON_CACHE_DIR": f"{cache}/triton"}
            proc = subprocess.run([sys.executable, __file__, f"--run={kind}"], env=env,
                                  capture_output=True, text=True)
        if proc.returncode:
            print(f"{kind}: exited {proc.returncode}\n{proc.stderr[-4000:]}", flush=True)
            continue
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["cgroup_cpu_stat"] = [stat0, _read("/sys/fs/cgroup/cpu.stat")]
        study["runs"].append(run)
        show(run)
        print(f"  cgroup cpu.stat before/after: {run['cgroup_cpu_stat']}", flush=True)
    out.write_text(json.dumps(study, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
