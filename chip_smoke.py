#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (into ``build/``);
2. hold each kernel against its plain PyTorch version on the card, at the
   quick plan's shapes and one larger shape: alu_chain within rtol 1e-5,
   op_chain and chase bit-exact;
3. run ``characterize --plan quick`` through the port's CLI, with every
   kernel's launch count set to 0 just before and read just after; the run
   must measure every row of the plan, with no failure, and launch every
   kernel;
4. time each kernel, its plain version and its bound at the shapes the quick
   plan gives it, count non-positive slopes of the host clock and of CUDA
   events over repeated trials, and time op_chain's loop: each step's time
   with 1 and with 32 steps to an iteration;
5. print the ``{"kernels": [...]}`` line, the card's name and power limit,
   and, last, ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA card is visible or the
repository's sources are missing.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12     # non-tensor float32; also used for int32 ops
ALU_RTOL = 1e-5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def wall_ms(fn, reps: int = 5) -> float:
    """Median wall time of one call of ``fn`` to completion on the card."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def check_kernels(dev: torch.device) -> dict[str, float]:
    """Phase 2: every kernel against its plain version on the card; returns
    the largest absolute error seen per kernel."""
    from repro_torch.core.membench import build_ring
    from repro_torch.kernels.alu_chain import OPS, alu_chain, alu_chain_plain
    from repro_torch.kernels.chase import chase, chase_plain
    from repro_torch.kernels.opchain import STEPS, UNROLLS, op_chain, op_chain_plain

    rng = np.random.RandomState(0)
    err = {"alu_chain": 0.0, "op_chain": 0.0, "chase": 0.0}
    for shape in ((8, 128), (1024, 1024)):
        x = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32)).to(dev)
        a = torch.from_numpy(rng.uniform(0.5, 1.0, shape).astype(np.float32)).to(dev)
        for op in OPS:
            for n in (8, 64):
                got = alu_chain(x, a, n=n, op=op)
                want = alu_chain_plain(x, a, n=n, op=op)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"alu_chain {op} n={n} {shape}: non-finite output")
                torch.testing.assert_close(got, want, rtol=ALU_RTOL, atol=0)
                err["alu_chain"] = max(err["alu_chain"], float((got - want).abs().max()))
    print(f"K1 alu_chain: {len(OPS)} ops x n in (8, 64) x (8, 128), (1024, 1024) "
          f"agree, max abs err {err['alu_chain']:.3g} (rtol {ALU_RTOL})")

    for step, (dtype, n_ops, _) in STEPS.items():
        np_dtype = np.int32 if dtype == torch.int32 else np.uint32
        for shape in ((), (8, 128), (256, 1024)):
            draw = lambda: torch.from_numpy(np.asarray(  # noqa: E731
                rng.randint(0, 2 ** 32, shape, dtype=np.uint64).astype(np_dtype))).to(dev)
            x, ops = draw(), tuple(draw() for _ in range(n_ops))
            for n in (1, 45, 64, 512):
                want = op_chain_plain(x, *ops, step=step, n=n).cpu()
                for unroll in UNROLLS:
                    got = op_chain(x, *ops, step=step, n=n, unroll=unroll).cpu()
                    if not torch.equal(got, want):
                        fail(f"op_chain {step} n={n} unroll={unroll} {shape}: "
                             "differs from the plain version")
    print(f"K2 op_chain: steps {tuple(STEPS)} x n in (1, 45, 64, 512) x unroll "
          f"{UNROLLS} x (), (8, 128), (256, 1024) bit-exact")

    for ws in (1 << 13, 1 << 17, 1 << 21, 1 << 25):
        ring, start = build_ring(ws, device=dev)
        for steps in (512, 1536):
            got = chase(ring, start, steps=steps).cpu()
            if not torch.equal(got, chase_plain(ring, start, steps=steps).cpu()):
                fail(f"chase ws={ws} steps={steps}: differs from the plain version")
    print("K3 chase: ws 8 KiB, 128 KiB, 2 MiB, 32 MiB x steps (512, 1536) bit-exact")
    return err


def run_quick(dev: torch.device) -> dict[str, int]:
    """Phase 3: the quick plan through the CLI; returns each kernel's
    launches during that run."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment
    from repro_torch.kernels.ops import KERNELS

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        db_path = str(Path(tmp) / "quick_db.json")
        for k in KERNELS:
            k.launches = 0
        rc = cli_main(["characterize", "--plan", "quick", "--db", db_path, "--table"])
        launches = {k.__name__: k.launches for k in KERNELS}
        if rc != 0:
            fail(f"characterize --plan quick exited {rc}")
        db = LatencyDB(db_path)
    env = current_environment(dev)
    if db.failures():
        fail(f"ProbeFailures in the quick DB: {[f.op for f in db.failures()]}")
    for probe in named_plan("quick"):
        rec = db.get(probe.key(env))
        if rec is None:
            fail(f"no record for {probe.op}@{probe.opt_level}")
        if not (math.isfinite(rec.latency_ns) and rec.latency_ns >= 0
                and rec.n_samples > 0 and "clock=events" in rec.notes):
            fail(f"bad record {rec}")
    print(f"quick: {len(db)} records for the {len(named_plan('quick'))} probes of "
          f"the plan, no failures; launches {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched by the quick run")
    return launches


def time_kernels(dev: torch.device, err: dict, launches: dict) -> list[dict]:
    """Phase 4: each kernel at the largest call the quick plan makes of it:
    the kernel's time on the card (CUDA events behind a lead, as the probes
    time), the plain version's wall time to completion (it may wait for the
    card inside, as the chase's host loop does), and the bound."""
    from repro_torch.core.chains import KERNEL_CHAIN_UNROLL
    from repro_torch.core.membench import build_ring
    from repro_torch.core.timing import Timer
    from repro_torch.kernels.alu_chain import alu_chain, alu_chain_plain
    from repro_torch.kernels.chase import chase, chase_plain
    from repro_torch.kernels.opchain import op_chain, op_chain_plain

    x = torch.full((8, 128), 1.0, device=dev)
    a = torch.full((8, 128), 0.5, device=dev)
    c = torch.tensor(0xF0F0F0F0, dtype=torch.uint32, device=dev)
    p = torch.tensor(0xA5A5A5A5, dtype=torch.uint32, device=dev)
    ring, start = build_ring(1 << 21, device=dev)
    rows = [
        # name, source, replaces, kernel call, plain call, bytes, ops
        ("alu_chain", "src/repro_torch/csrc/alu_chain.cu",
         "src/repro/kernels/alu_chain.py:43",
         lambda: alu_chain(x, a, n=64, op="fma"),
         lambda: alu_chain_plain(x, a, n=64, op="fma"),
         3 * x.numel() * 4, 2 * 64 * x.numel(),
         "fma, tile (8, 128), n=64"),
        ("op_chain", "src/repro_torch/csrc/op_chain.cu",
         "src/repro/kernels/opchain.py:39",
         lambda: op_chain(c, p, step="popc", n=512, unroll=KERNEL_CHAIN_UNROLL),
         lambda: op_chain_plain(c, p, step="popc", n=512),
         3 * 4, 2 * 512,
         f"popc, 0-dim uint32 carry, n=512, unroll={KERNEL_CHAIN_UNROLL}"),
        ("chase", "src/repro_torch/csrc/chase.cu",
         "src/repro/kernels/chase.py:119",
         lambda: chase(ring, start, steps=1536),
         lambda: chase_plain(ring, start, steps=1536),
         # one 4-byte word per step, all on distinct lines (the 2 MiB ring has
         # 32768 live slots), plus start and the result
         1536 * 4 + 4 + 4, 0, "ring 2 MiB (32768 lines), steps=1536"),
    ]
    out = []
    timer = Timer(warmup=3, reps=50, device=dev)
    for name, source, replaces, kernel, plain, nbytes, nops, shape in rows:
        ms = timer.time_callable(kernel).median_ns / 1e6
        plain_ms = wall_ms(plain)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_OPS_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        print(f"{name}: {ms:.6f} ms/launch on the card, plain {plain_ms:.6f} ms wall, bound "
              f"{bound_ms:.3g} ms ({bound_by}: {nbytes} B, {nops} ops), "
              f"{launches[name]} launches on the main path [{shape}]")
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return out


def clock_study(dev: torch.device, trials: int = 20, reps: int = 5) -> None:
    """How often a two-length slope comes out non-positive, min over ``reps``
    per length as core.timing's slope takes it, with three clocks: the host
    clock (perf_counter_ns around the call plus a synchronize), bare CUDA
    events around the call, and the port's clock (the events behind a lead,
    ``Timer.time_once``)."""
    from repro_torch.core.chains import KERNEL_CHAIN_UNROLL
    from repro_torch.core.timing import Timer
    from repro_torch.kernels.alu_chain import alu_chain
    from repro_torch.kernels.opchain import op_chain

    x = torch.full((8, 128), 1.0, device=dev)
    a = torch.full((8, 128), 0.5, device=dev)
    c = torch.tensor(0xF0F0F0F0, dtype=torch.uint32, device=dev)
    p = torch.tensor(0xA5A5A5A5, dtype=torch.uint32, device=dev)
    chains = {"kernel.alu_chain.fma (8, 64)": (lambda n: alu_chain(x, a, n=n), (8, 64)),
              f"op_chain.popc unroll {KERNEL_CHAIN_UNROLL} (64, 512)": (
                  lambda n: op_chain(c, p, step="popc", n=n, unroll=KERNEL_CHAIN_UNROLL),
                  (64, 512))}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    timer = Timer(device=dev)

    def host(fn):
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter_ns() - t0

    def bare_events(fn):
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e6

    for label, (fn, (n1, n2)) in chains.items():
        for clock, sample in (("host", host), ("events", bare_events),
                              ("events+lead", timer.time_once)):
            slopes = []
            for _ in range(trials):
                t1 = min(sample(lambda: fn(n1)) for _ in range(reps))
                t2 = min(sample(lambda: fn(n2)) for _ in range(reps))
                slopes.append((t2 - t1) / (n2 - n1))
            q1, med, q3 = np.percentile(slopes, (25, 50, 75))
            print(f"clock {clock:11s} {label}: {sum(s <= 0 for s in slopes)} of "
                  f"{trials} slopes non-positive; ns/step q1 {q1:.3f} "
                  f"median {med:.3f} q3 {q3:.3f}")


def loop_study(dev: torch.device, lens: tuple[int, int] = (64, 512),
               reps: int = 30) -> None:
    """op_chain's loop on the card: each step's time per step (the slope at
    ``lens``, events behind the lead) with 1 step to an iteration of the
    kernel's loop, as the fori_loop runs, and with 32, as the O3 rows run.
    With s the step and L the loop's cost per iteration, the two are s + L
    and s + L/32, so L = (t1 - t32) * 32/31."""
    from repro_torch.core.chains import spec_by_name
    from repro_torch.core.timing import Timer
    from repro_torch.kernels.opchain import STEPS, UNROLLS, op_chain

    timer = Timer(warmup=3, reps=reps, device=dev)
    for step in STEPS:
        spec = spec_by_name(step)
        carry, ops = spec.carry(dev), spec.operand_tensors(dev)
        per_step = {}
        for unroll in UNROLLS:
            m = timer.slope(lambda n, u=unroll: (
                lambda: op_chain(carry, *ops, step=step, n=n, unroll=u)), *lens)
            per_step[unroll] = m.median_ns
        lo, hi = min(UNROLLS), max(UNROLLS)
        loop_ns = (per_step[lo] - per_step[hi]) * hi / (hi - lo)
        print(f"loop op_chain.{step} {lens}: ns/step "
              + ", ".join(f"unroll {u} {t:.3f}" for u, t in per_step.items())
              + f"; loop {loop_ns:.3f} ns per iteration")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import resolve_device

    t_all = time.perf_counter()
    dev = resolve_device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(dev)}")

    t0 = time.perf_counter()
    build = _build.build()
    print(f"library: {build} ({', '.join(f'lib{k}.so' for k in _build.KERNELS)})")
    for line in (build / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    phase("build", t0)

    t0 = time.perf_counter()
    err = check_kernels(dev)
    phase("kernels", t0)

    t0 = time.perf_counter()
    launches = run_quick(dev)
    phase("quick", t0)

    t0 = time.perf_counter()
    kernels = time_kernels(dev, err, launches)
    clock_study(dev)
    loop_study(dev)
    phase("timing", t0)
    phase("total", t_all)

    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
