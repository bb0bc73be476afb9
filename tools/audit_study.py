#!/usr/bin/env python3
"""What the compiled chains hold on a CUDA card: the PTX and SASS the audit reads.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/audit_study.py [--lens=4,8] [--ops=add,sin,...] [--out=PATH]

It compiles the O3 chain of every registry row that Inductor compiles, at
two short lengths (default 4 and 8), in one pool of compile workers, and
keeps for each chain its Triton kernels' source, PTX and ``cuobjdump
-sass`` text, and the wrapper Inductor generated; it builds the CUDA
kernels and keeps ``cuobjdump -ptx`` and ``-sass`` of K1-K3's libraries.
Everything goes into one JSON file (``--out``, by default
``build/audit_study.json``); a line per chain is printed: its PTX opcodes
a step (the longer length's less the shorter's, over the steps between).
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.audit import artifacts  # noqa: E402


def dump_chain(name: str, n: int, device: str) -> dict:
    """Compile row ``name``'s O3 chain at length ``n`` in this process and
    return the text of everything it loaded."""
    from repro_torch.core import measure

    before = {id(m) for m in artifacts.loaded_inductor_modules()}
    result = measure.warm_chain(name, "O3", n, device)
    mods = [m for m in artifacts.loaded_inductor_modules() if id(m) not in before]
    sources = []
    for m in mods:
        path = getattr(m, "__file__", None)
        if path and Path(path).exists():
            sources.append(Path(path).read_text())
    cubins = artifacts.triton_cubins(mods)
    ptx = [p.read_text() for c in cubins for p in sorted(c.parent.glob("*.ptx"))]
    sass = {}
    for c in cubins:
        sass.update(artifacts.sass_functions(c))
    return {**result, "sources": sources, "ptx": ptx, "sass": sass,
            "layout": [sorted(p.name for p in c.parent.iterdir()) for c in cubins]}


def ptx_opcodes(text: str) -> Counter:
    out = Counter()
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith(("//", ".", "{", "}", "$")) or ln.endswith(":"):
            continue
        ln = re.sub(r"^@!?%\w+\s+", "", ln)
        out[ln.split()[0].rstrip(";")] += 1
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("audit_study: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.api.session import CompilePool, compile_workers_for
    from repro_torch.core import chains
    from repro_torch.kernels import _build

    args = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--"))
    out = Path(args.get("out", ROOT / "build" / "audit_study.json"))
    lens = tuple(int(x) for x in args.get("lens", "4,8").split(","))
    rows = [s.name for s in chains.default_registry() if s.kernel is None]
    if "ops" in args:
        rows = [r for r in rows if r in args["ops"].split(",")]
    dev = "cuda:0"
    import triton
    print(f"torch {torch.__version__}, triton {triton.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    dump: dict = {"chains": {}, "libs": {}}
    tasks = [(dump_chain, (name, n, dev)) for name in rows for n in lens]
    with CompilePool(compile_workers_for(torch.device(dev), len(tasks))) as pool:
        futs = pool.submit(tasks)
        build = _build.build()
        cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
        for lib in ("alu_chain", "op_chain", "op_chain_timed", "chase"):
            so = build / f"lib{lib}.so"
            dump["libs"][lib] = {
                flag: subprocess.run([str(cuobjdump), f"-{flag}", str(so)], capture_output=True,
                                     text=True).stdout for flag in ("ptx", "sass")}
            print(f"lib{lib}.so: ptx {len(dump['libs'][lib]['ptx'])} chars, "
                  f"sass {len(dump['libs'][lib]['sass'])} chars", flush=True)
        for (_, (name, n, _)), fut in zip(tasks, futs):
            try:
                dump["chains"][f"{name} {n}"] = fut.result()
            except Exception as e:  # noqa: BLE001 - a study: print and go on
                print(f"{name} n {n}: {type(e).__name__}: {e}", flush=True)
    for name in rows:
        got = [dump["chains"].get(f"{name} {n}") for n in lens]
        if None in got:
            continue
        c1, c2 = (sum((ptx_opcodes(t) for t in g["ptx"]), Counter()) for g in got)
        per = {k: (c2[k] - c1[k]) / (lens[1] - lens[0]) for k in c1 | c2 if c2[k] != c1[k]}
        print(f"ptx {name}: {len(got[1]['ptx'])} PTX file(s); a step: "
              + ", ".join(f"{k} {v:g}" for k, v in sorted(per.items(), key=lambda kv: -kv[1])),
              flush=True)
    print(f"layout of one chain's cache directory: {next(iter(dump['chains'].values()))['layout']}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dump, indent=1, default=str))
    print(f"wrote {out} ({out.stat().st_size} bytes) in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
