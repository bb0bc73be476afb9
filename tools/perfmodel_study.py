#!/usr/bin/env python3
"""The serving cells' op records and their prices, on the CPU, before a card.

Run from the root of a checkout (no card, no nvcc):

    python3 tools/perfmodel_study.py [--fma-ns=2,5] [--cells=full,tiny]

``full``: Jamba-v0.1 cut to one period (``chip_smoke.py``'s phase serving
model) made on the meta device, its prefill of 8 x 2048 tokens and its
decode step at 2048 on a cache of 2080 recorded
(``core.hlo_analysis.record_ops``) with the kernel wrappers' plain
versions in their place (the record keeps them as the same sites), about
30 s. ``tiny``: the serving plan's four serving-tiny cells on the CPU. It
prints each record's matmul FLOPs, eager bytes and sites, then prices it
with ``RecordLatencyEstimator`` over a DB of assumed rows: every registry
row at ``--fma-ns`` (a value each) but tanh 20, sin and cos 180, ex2,
rsqrt and div.runtime.float32 10 ns; the chase rungs 8 KiB 20, 128 KiB 20,
2 MiB 142, 32 MiB 252.5 and the in-kernel 64 KiB 14.65 and 64 MiB 340.5 ns
a line; the fused rows flash_attention 440, mamba_scan 328, flash_decode
128, rmsnorm 16 ns a unit with the port's ``unit_bytes``. The structure is
exact; the row values are assumptions, to be replaced by a card's.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SPECIAL_NS = {"tanh": 20.0, "sin": 180.0, "cos": 180.0, "ex2": 10.0, "rsqrt": 10.0,
              "div.runtime.float32": 10.0}
RUNGS = (("mem.chase.ws8192", 20.0), ("mem.chase.ws131072", 20.0),
         ("mem.chase.ws2097152", 142.0), ("mem.chase.ws33554432", 252.5),
         ("inkernel.mem.65536", 14.65), ("inkernel.mem.67108864", 340.5))
FUSED_NS = {"flash_attention": 440.0, "mamba_scan": 328.0, "flash_decode": 128.0,
            "rmsnorm": 16.0}


def assumed_db(fma_ns: float):
    from repro_torch import inkernel
    from repro_torch.core import chains
    from repro_torch.core.latency_db import LatencyDB, LatencyRecord

    def row(op, ns, cat, notes=""):
        return LatencyRecord(op=op, category=cat, dtype="float32", opt_level="O3",
                             latency_ns=ns, mad_ns=0.0, cycles=ns, guard=0, net_latency_ns=ns,
                             n_samples=1, measured_at="assumed", notes=notes,
                             device_kind="assumed", backend="cuda", jax_version="assumed")

    db = LatencyDB()
    for spec in chains.default_registry():
        db.add(row(spec.name, SPECIAL_NS.get(spec.name, fma_ns), spec.category))
    for op, ns in RUNGS:
        db.add(row(op, ns, "memory", "line=64"))
    for name, ns in FUSED_NS.items():
        db.add(row(f"inkernel.fused.{name}", ns, "kernel",
                   f"unit_bytes={inkernel.unit_bytes(name)}"))
    return db


def full_records() -> dict:
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.core.hlo_analysis import record_ops
    from repro_torch.kernels import flash_attention, mamba_scan, ops
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.serving.engine import Engine

    spec = get("jamba-v0.1-52b").config
    cfg = dataclasses.replace(spec, n_layers=len(spec.period))
    rt = Runtime(remat=False, moe_groups=1, mamba_chunk=16, mlstm_chunk=16,
                 attn_impl="pallas", use_pallas=True)
    eng = Engine(transformer.LM(cfg, device="meta"), rt)
    real = ops.flash_attention, ops.mamba_scan
    ops.flash_attention = flash_attention.flash_attention_plain
    ops.mamba_scan = mamba_scan.mamba_scan_plain
    try:
        with torch.no_grad():
            return {"prefill b8p2048": record_ops(*_flat(eng.lower_prefill(8, 2048))),
                    "decode b8p2048 c2080": record_ops(*_flat(eng.lower_decode(8, 2048, 2080)))}
    finally:
        ops.flash_attention, ops.mamba_scan = real


def tiny_records() -> dict:
    from repro_torch.api.plan import SERVING_CELLS
    from repro_torch.api.probes import serving_tiny_config
    from repro_torch.core.hlo_analysis import record_ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine

    cfg, rt = serving_tiny_config()
    eng = Engine(transformer.init_lm(cfg, seed=0, device="cpu"), rt)
    out = {}
    for b, p in SERVING_CELLS:
        out[f"tiny prefill b{b}p{p}"] = record_ops(*_flat(eng.lower_prefill(b, p)))
        out[f"tiny decode b{b}p{p}"] = record_ops(*_flat(eng.lower_decode(b, p)))
    return out


def _flat(step_args):
    step, args = step_args
    return (step, *args)


def main(argv=None) -> int:
    from repro_torch.core.perfmodel import RecordLatencyEstimator

    ap = argparse.ArgumentParser()
    ap.add_argument("--fma-ns", default="2,5")
    ap.add_argument("--cells", default="full,tiny")
    args = ap.parse_args(argv)
    records = {}
    for cells in args.cells.split(","):
        t0 = time.perf_counter()
        records.update(full_records() if cells == "full" else tiny_records())
        print(f"recorded {cells} in {time.perf_counter() - t0:.1f} s")
    for name, rec in records.items():
        print(f"{name}: {sum(rec.histogram.values())} ops, {rec.matmul_flops:.6g} matmul FLOPs, "
              f"{rec.bytes:.6g} B, sites {[(s.name, s.bytes) for s in rec.sites]}")
    for fma_ns in (float(v) for v in args.fma_ns.split(",")):
        est = RecordLatencyEstimator(assumed_db(fma_ns))
        for name, rec in records.items():
            r = est.estimate(rec)
            classes = {k: round(v.ns / 1e6, 3) for k, v in r.by_class.items()}
            print(f"rows at {fma_ns} ns: {name}: predicted {r.total_ns:.6g} ns (compute "
                  f"{r.compute_ns:.6g}, memory {r.memory_ns:.6g}), coverage {r.coverage:.4f}, "
                  f"{r.bound}-bound; ms by class {classes}; unpriced {r.unpriced_opcodes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
