"""``python -m repro_torch characterize`` — the paper pipeline, one command.

Examples::

    python -m repro_torch characterize --plan quick --db db.json --table
    python -m repro_torch characterize --plan quick --db db.json   # cache hits
    python -m repro_torch characterize --plan quick --db db.json --force
    python -m repro_torch characterize --plan quick --db db.json --device cpu
    python -m repro_torch characterize --plan table2 --db db.json --table
    python -m repro_torch characterize --plan inkernel --db db.json --table
    python -m repro_torch characterize --plan inkernel --db db.json --device cpu \
        --ops add,popc,fma.float32 --table
    python -m repro_torch characterize --plan fused --db db.json --table
    python -m repro_torch characterize --plan memory --db db.json --table
    python -m repro_torch characterize --plan memory-inkernel --db db.json --table
    python -m repro_torch characterize --plan memory-inkernel --db db.json --device cpu \
        --ops inkernel.mem.65536,mem.chase.ws65536 --table

``--plan memory`` is the pointer-chase ladder, 4 KiB to 32 MiB, through
K3's global path; ``--plan memory-inkernel`` times the chase inside K3 (on
the card by the SM clock sandwich) at 64 KiB (from shared memory) to 64 MiB
(from global memory) beside the same sizes' host chase, and ``--table``
pairs ``inkernel.mem.<N>`` with ``mem.chase.ws<N>``; on a DB that holds the
memory plan's rows those twins are cache hits.

``--plan inkernel`` times each of the 58 in-kernel rows inside the kernel
(on the card by the SM clock sandwich) beside its dispatch-level O3 twin;
``--table`` then prints the pairing, dispatch against in-kernel (the
paper's in-pipeline method). On a DB that already holds table2's rows the
twins are cache hits.

It runs on ``cuda:0`` unless ``--device`` names another device; where the
card is asked for and there is none it exits with an error, it does not run
on the CPU. Scheduling is cache-aware: probes already in the DB for this
(device, backend, torch build) are cache hits, and partial results are
flushed after every probe, so re-running an interrupted command resumes it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Sequence

from repro_torch.api.plan import PLAN_NAMES, named_plan
from repro_torch.api.session import Session
from repro_torch.core.latency_db import LatencyDB
from repro_torch.core.timing import Timer
from repro_torch.kernels.common import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Instruction/memory latency characterization on a CUDA "
                    "card (paper pipeline, PyTorch port).")
    sub = ap.add_subparsers(dest="command", required=True)

    ch = sub.add_parser("characterize",
                        help="run a characterization plan into a LatencyDB")
    ch.add_argument("--plan", choices=PLAN_NAMES, default="quick",
                    help="named probe plan (default: quick; ported so far: "
                         "quick, table2, memory, inkernel, memory-inkernel, fused)")
    ch.add_argument("--db", required=True,
                    help="LatencyDB JSON path (loaded if present; flushed "
                         "after every probe)")
    ch.add_argument("--device", default="cuda",
                    help="device to measure: cuda[:N] (default cuda:0) or cpu")
    ch.add_argument("--force", action="store_true",
                    help="re-measure probes already in the DB")
    ch.add_argument("--ops", default=None,
                    help="comma-separated op filter applied to the plan "
                         "(e.g. add,mul,clock_overhead)")
    ch.add_argument("--opt-levels", default=None,
                    help="comma-separated opt-level filter (e.g. O0,O3)")
    ch.add_argument("--table", action="store_true",
                    help="print the Table II analog after the run, and the "
                         "dispatch vs in-kernel pairing where the DB has both")
    ch.add_argument("--recover", action="store_true",
                    help="salvage complete records from a truncated/corrupt "
                         "DB file instead of refusing to load it")
    ch.add_argument("--warmup", type=int, default=2)
    ch.add_argument("--reps", type=int, default=10,
                    help="timed repetitions per measurement point")
    ch.add_argument("--adaptive", action="store_true",
                    help="adaptive fidelity: stop repeating a probe once its "
                         "MAD/median converges, spend the saved reps on "
                         "noisy rows (reps_eff=N in record notes)")
    ch.set_defaults(func=cmd_characterize)
    return ap


def cmd_characterize(args: argparse.Namespace) -> int:
    try:
        device = resolve_device(args.device)
        plan = named_plan(args.plan)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.ops:
        plan = plan.filter(ops=[o.strip() for o in args.ops.split(",")])
    if args.opt_levels:
        plan = plan.filter(opt_levels=[l.strip() for l in args.opt_levels.split(",")])
    if not len(plan):
        print("error: plan is empty after filters", file=sys.stderr)
        return 2

    try:
        db = LatencyDB.recover(args.db) if args.recover else LatencyDB(args.db)
    except Exception as e:  # unreadable/corrupt DB file: report, don't clobber
        print(f"error: could not load DB {args.db}: {type(e).__name__}: {e} "
              "(pass --recover to salvage complete records)", file=sys.stderr)
        return 2
    session = Session(db=db, device=device,
                      timer=Timer(warmup=args.warmup, reps=args.reps, device=device),
                      adaptive=args.adaptive)
    print(f"plan '{plan.name}': {len(plan)} probes -> {args.db} "
          f"[{session.env['backend']}/{session.env['device_kind']}, "
          f"{session.env['jax_version']}]")
    result = session.run(plan, force=args.force)

    print(f"plan '{plan.name}': {result.summary()}")
    if result.cached and not result.measured and not result.failed:
        print("all probes were cache hits; pass --force to re-measure")
    for r in result.failed:
        f = r.failure
        print(f"  FAILED {f.op}@{f.opt_level}: {f.error_type}: {f.message}")
    if args.table:
        print()
        print(result.table_markdown())
        compare = session.db.compare_markdown()
        if compare.count("\n") > 1:  # header + separator + >=1 paired row
            print("\n== host vs in-kernel (paper's in-pipeline method) ==")
            print(compare)
    return 1 if result.failed else 0


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
