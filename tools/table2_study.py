#!/usr/bin/env python3
"""What ``characterize --plan table2`` costs and runs on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    REPRO_LOGLEVEL=DEBUG python3 tools/table2_study.py [k2] [budget] [half]
        [half=VARIANT,...] [profile] [configs] [dump] [--out=PATH]

Parts (k2, budget and half when none is named):

* ``k2``: build the kernels and check, as ``chip_smoke.py`` does, that
  K2's steps are bit-exact against their plain versions and that the SASS
  of its uint32 divides and high multiply shows each divisor class;
* ``budget``: the table2 plan alone through the CLI on an empty DB and
  empty compile caches, its O3 chains warmed in one compile worker pool as
  the session starts it: every chain's compile seconds by phase, the SASS
  a step of each row runs, the plan's wall time by stage;
* ``half``: the O3 chains of the half-precision rows under other Inductor
  option sets than ``measure.inductor_options`` gives them (``VARIANTS``;
  ``half=`` names some), in the pool: whether each equals its eager chain at n 64 and 512,
  the SASS a step runs, and the compile seconds;
* ``profile``: a cProfile of one cold compile of ``add``'s 512-op chain;
* ``configs``: Inductor settings that may change how a chain compiles but
  not what it emits (``CONFIGS``), each on quick's Inductor rows: their
  Triton kernels' source hashed against the defaults', and the seconds;
* ``dump``: the generated code and PTX of the folded rows' chains.

Everything it prints goes to standard output; a JSON file (``--out``, by
default ``build/table2_study.json``) keeps every chain's compile phases and
SASS counts, the profile and the dumped code.
"""
from __future__ import annotations

import json
import re
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.audit import artifacts  # noqa: E402

VARIANTS = {"none": {},
            "no_upcast": {"triton.codegen_upcast_to_fp32": False},
            "epc+no_upcast": {"emulate_precision_casts": True,
                              "triton.codegen_upcast_to_fp32": False}}


def compile_variant(name: str, n: int, variant: str, device: str) -> dict:
    """A half row's O3 chain under ``VARIANTS[variant]``, compiled and run
    once (the shape of ``measure.warm_chain``'s result)."""
    from repro_torch.core import chains, measure
    from repro_torch.core.optlevels import compile_at_level
    from repro_torch.utils import block

    before = measure.compile_phases()
    t0 = time.perf_counter()
    spec = chains.spec_by_name(name)
    tag = "".join(c if c.isalnum() else "_" for c in f"{name}_{n}_{variant}")
    fn = compile_at_level(chains.chain_fn(spec, n), "O3", name=f"variant_{tag}",
                          options=VARIANTS[variant])
    out = fn(spec.carry(device), *spec.operand_tensors(device))
    block(out)
    seconds = time.perf_counter() - t0
    phases = {k: v - before.get(k, 0.0) for k, v in measure.compile_phases().items()}
    return {"s": seconds, "phases": {k: v for k, v in phases.items() if v > 0},
            "out": out.item()}


# Inductor settings that may change how a chain compiles but not what it
# emits, each tried alone (``configs``)
CONFIGS = {
    "default": {},
    "no_loop_ordering": {"loop_ordering_after_fusion": False},
    "no_peak_memory_reorder": {"reorder_for_peak_memory": False},
    "no_pattern_matcher": {"pattern_matcher": False},
}
QUICK_INDUCTOR_ROWS = ("add", "mul", "mad", "div.s.regular", "div.s.irregular",
                       "div.s.runtime", "fma.float32", "div.runtime.float32", "sqrt",
                       "rsqrt", "sin", "ex2", "add.bfloat16")
TRITON_SOURCE = re.compile(r"async_compile\.triton\('\w+', '''(.*?)'''", re.DOTALL)


def compile_config(name: str, n: int, config: str, device: str) -> dict:
    """Row ``name``'s O3 chain compiled with its own options plus
    ``CONFIGS[config]``, in a fresh Inductor cache: the seconds, the compile
    phases, and a hash of its Triton kernels' source (the generated code
    without the wrapper around it)."""
    import hashlib

    from torch._inductor.utils import fresh_inductor_cache, run_and_get_code

    from repro_torch.core import chains, measure
    from repro_torch.core.optlevels import compile_at_level

    spec = chains.spec_by_name(name)
    opts = {**(measure.inductor_options(spec, device) or {}), **CONFIGS[config]}
    tag = "".join(c if c.isalnum() else "_" for c in f"{name}_{n}")
    with fresh_inductor_cache():
        before = measure.compile_phases()
        t0 = time.perf_counter()
        fn = compile_at_level(chains.chain_fn(spec, n), "O3", name=f"chain_{tag}",
                              options=opts)
        out, codes = run_and_get_code(fn, spec.carry(device), *spec.operand_tensors(device))
        seconds = time.perf_counter() - t0
    kernels = [k for code in codes for k in TRITON_SOURCE.findall(code)]
    phases = {k: v - before.get(k, 0.0) for k, v in measure.compile_phases().items()}
    return {"s": seconds, "phases": {k: v for k, v in phases.items() if v > 0},
            "out": out.item(), "kernels": len(kernels),
            "hash": hashlib.sha256("".join(kernels).encode()).hexdigest()[:16]}


def profile_chain(name: str, n: int, device: str) -> str:
    """cProfile of one cold compile of row ``name``'s O3 chain at length n:
    the top functions by cumulative and by own time."""
    import cProfile
    import io
    import pstats

    from torch._inductor.utils import fresh_inductor_cache

    from repro_torch.core import chains, measure

    spec = chains.spec_by_name(name)
    with fresh_inductor_cache():
        prof = cProfile.Profile()
        prof.enable()
        fn = measure.compile_chain(spec, n, "O3", device)
        fn(spec.carry(device), *spec.operand_tensors(device)).item()
        prof.disable()
    text = io.StringIO()
    stats = pstats.Stats(prof, stream=text)
    stats.sort_stats("cumulative").print_stats(90)
    stats.sort_stats("tottime").print_stats(30)
    return text.getvalue()


def part_profile(dev, pool, dump: dict) -> None:
    t0 = time.perf_counter()
    text = pool._executor.submit(profile_chain, "add", 512, str(dev)).result()
    dump["profile"] = text
    keep = [ln for ln in text.splitlines() if "_inductor" in ln or "_functorch" in ln
            or "_dynamo" in ln or "function calls" in ln or "triton" in ln]
    print("\n".join(f"profile: {ln[:220]}" for ln in keep[:120]))
    chip_smoke.phase("profile", t0)


def part_configs(dev, pool, dump: dict) -> None:
    """Each of CONFIGS on quick's 13 Inductor rows at n 64 (their kernels'
    source hashed) and on four of them at n 512 (timed)."""
    t0 = time.perf_counter()
    tasks = {(c, name, n): pool._executor.submit(compile_config, name, n, c, str(dev))
             for n, rows in ((512, ("add", "fma.float32", "sin", "add.bfloat16")),
                             (64, QUICK_INDUCTOR_ROWS))
             for name in rows for c in CONFIGS}
    results = {}
    for key, fut in tasks.items():
        try:
            results[key] = fut.result()
        except Exception as e:  # noqa: BLE001 - a setting Inductor refuses is a finding
            print(f"configs: {key}: {type(e).__name__}: {e}")
    dump["configs"] = {" ".join(map(str, k)): v for k, v in results.items()}
    for c in CONFIGS:
        mine = {(name, n): r for (cc, name, n), r in results.items() if cc == c}
        same = [k for k, r in mine.items()
                if r["hash"] == results.get(("default", *k), {}).get("hash")]
        secs = {f"{name} {n}": round(r["s"], 1) for (name, n), r in mine.items()}
        print(f"configs: {c}: {len(same)} of {len(mine)} chains' kernel source equal to "
              f"default's; {sum(secs.values()):.1f} s in all: {secs}")
    chip_smoke.phase("configs", t0)


def part_dump(dev, pool, dump: dict) -> None:
    """The generated code of the rows whose O3 chain folds (not, bfi,
    mul24), and of min, at n 64, and their PTX, into the dump."""
    from torch._inductor.utils import run_and_get_code

    from repro_torch.core import chains, measure

    for name in ("not", "bfi", "mul24", "min"):
        spec = chains.spec_by_name(name)
        before = {id(m) for m in artifacts.loaded_inductor_modules()}
        _, codes = run_and_get_code(measure.compile_chain(spec, 64, "O3", dev), spec.carry(dev),
                                    *spec.operand_tensors(dev))
        cubins = artifacts.triton_cubins([m for m in artifacts.loaded_inductor_modules()
                                           if id(m) not in before])
        ptx = [p.read_text() for c in cubins for p in c.parent.glob("*.ptx")]
        dump.setdefault("dump", {})[name] = {"code": codes, "ptx": ptx}
        print(f"dump: {name}@O3 n 64: {len(codes)} modules, {len(ptx)} PTX files")


def part_k2() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    build = _build.build()
    try:
        chip_smoke.sass_checks(build)
        chip_smoke.check_kernels(torch.device("cuda:0"))
    except SystemExit as e:  # a failed check is a finding; the other parts still run
        print(e)
    chip_smoke.phase("k2", t0)


def part_budget(dev, pool, dump: dict) -> None:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        chip_smoke.run_table2(dev, str(Path(tmp) / "table2_db.json"), pool)
    chip_smoke.phase("budget (table2 alone, cold caches)", t0)
    dump["budget"] = {f"{k[2]}@{k[3]} n {k[4]}": f.result() for k, f in pool.futures.items()
                      if f.done() and f.exception() is None}


def part_half(dev, pool, dump: dict, variants=tuple(VARIANTS)) -> None:
    from repro_torch.core import chains, measure
    t0 = time.perf_counter()
    rows = [s for s in chains.default_registry() if s.dtype in measure.HALF_DTYPES]
    lens = measure._CHAIN_LENS["O3"]
    tasks = {(s.name, n, v): pool._executor.submit(artifacts.warm_and_read, compile_variant,
                                                   s.name, n, v, str(dev))
             for v in variants for s in rows for n in lens
             if v != "none" or s.name.startswith("add.")}
    for (name, n, v), fut in tasks.items():
        try:
            r = fut.result()
        except Exception as e:  # noqa: BLE001 - a variant Inductor refuses is a finding
            print(f"half: {name}@O3 n {n} [{v}]: {type(e).__name__}: {e}")
            continue
        spec = chains.spec_by_name(name)
        eager = chains.chain_fn(spec, n)(spec.carry(dev), *spec.operand_tensors(dev)).item()
        dump.setdefault("half", {})[f"{name} n {n} {v}"] = r
        print(f"half: {name}@O3 n {n} [{v}]: {r['out']!r} (eager {eager!r}, "
              f"{'equal' if r['out'] == eager else 'DIFFERS'}); {r['s']:.1f} s; "
              f"{sum(r['sass'].values())} SASS instructions")
    for v in variants:
        results = {(name, n): fut.result() for (name, n, vv), fut in tasks.items()
                   if vv == v and fut.exception() is None}
        for s in rows:
            if all((s.name, n) in results for n in lens):
                per, hist = chip_smoke.per_step_sass(results, s.name, lens)
                print(f"half: {s.name}@O3 [{v}]: a step runs {per:.2f} instructions: {hist}")
    chip_smoke.phase("half", t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("table2_study: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.api.session import CompilePool, compile_workers_for

    out = next((Path(a[6:]) for a in sys.argv[1:] if a.startswith("--out=")),
               ROOT / "build" / "table2_study.json")
    parts = [a for a in sys.argv[1:] if not a.startswith("--out=")] or ["k2", "budget", "half"]
    more = {"profile": part_profile, "configs": part_configs, "dump": part_dump}
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(dev)}; emulate_precision_casts in Inductor's "
          f"config: {hasattr(torch._inductor.config, 'emulate_precision_casts')}", flush=True)
    dump: dict = {}
    if "k2" in parts:
        part_k2()
    with CompilePool(compile_workers_for(dev, 1 << 10),
                     runner=artifacts.warm_and_read) as pool:
        if "budget" in parts:
            part_budget(dev, pool, dump)
        if "half" in parts:
            part_half(dev, pool, dump)
        for part in parts:  # half=<variant>,<variant>: those variants only
            if part.startswith("half="):
                part_half(dev, pool, dump, tuple(part[5:].split(",")))
        for name, part in more.items():
            if name in parts:
                part(dev, pool, dump)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dump, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
