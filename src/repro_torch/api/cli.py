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
    python -m repro_torch characterize --plan serving --db db.json --table

``--plan memory`` is the pointer-chase ladder, 4 KiB to 32 MiB, through
K3's global path; ``--plan memory-inkernel`` times the chase inside K3 (on
the card by the SM clock sandwich) at 64 KiB (from shared memory) to 64 MiB
(from global memory) beside the same sizes' host chase, and ``--table``
pairs ``inkernel.mem.<N>`` with ``mem.chase.ws<N>``; on a DB that holds the
memory plan's rows those twins are cache hits.

``python -m repro_torch audit --db DB [--lint [--lowering] [--zoo [--archs
A,B]] [--dataflow]] [--compile-cache DIR] [--attribution PATH] [--strict]``
judges the code behind every record of a DB (PTX and SASS on the card, the
dispatched ops at O0, AOTAutograd's graph at O1, the fused rows' signatures
and instances) and writes each verdict into the record's notes
(``audit=...``); ``--lint`` runs the static lints (the pricing table's
mapping, guard identity; ``--zoo`` also the op records of the ten
architectures' smoke steps, on the CPU; ``--dataflow`` every kernel
family's certificate, as ``audit.lint.lint_dataflow`` states it);
``--compile-cache DIR`` reads an O3 chain's device code from the cache a
characterize run kept, so a separate process audits without compiling;
``characterize --audit`` attaches the verdicts as the records are measured.
On the CPU the O0 and O1 rows get their verdicts and the O3 rows
``unaudited:no-device-code``. Exit codes: 0 clean (or advisory-only
without ``--strict``), 1 integrity violations under ``--strict``, 2 usage
or IO errors.

``--plan serving`` measures the serving cells of the JAX package's tiny
dense model (prefill and one decode step at batch 1 × 16 and 2 × 64
tokens), each priced by the performance model from the DB's rows (the
``QUICK_OPS`` at O3 and three chase rungs, which the plan runs first: on a
DB that holds the quick and memory plans' rows they are cache hits), and
``--table`` prints the predicted against measured table.

``python -m repro_torch serve-slo --db DB [--rates 20,50,100] [--trace
PATH] [--n-requests N] [--slots S] [--seed K]`` is the predicted-vs-measured
serving SLO sweep: ``Plan.slo`` (the ``QUICK_OPS`` at O3 and three chase
rungs, then one ``slo.r<rate>`` point a rate) through the session, and the
throughput-vs-latency table. Each point replays one seeded arrival trace
through serving-tiny's continuous-batching slot pool (measured, on the
host's wall clock) and through the scheduler with the steps' costs priced
from the DB's rows (predicted). ``--trace`` replays a saved trace
(``traffic.save_trace``, from either package) as one uncached point.

``--plan inkernel`` times each of the 58 in-kernel rows inside the kernel
(on the card by the SM clock sandwich) beside its dispatch-level O3 twin;
``--table`` then prints the pairing, dispatch against in-kernel (the
paper's in-pipeline method). On a DB that already holds table2's rows the
twins are cache hits.

It runs on ``cuda:0`` unless ``--device`` names another device; where the
card is asked for and there is none it exits with an error, it does not run
on the CPU. Scheduling is cache-aware: probes already in the DB for this
(device, backend, torch build) are cache hits (``--resume``, the default;
``--force`` re-measures), and partial results are flushed after every
probe, so re-running an interrupted command resumes it. On the card every
probe is prepared before any is timed, so no timing runs beside the compile
workers (``--serial``, there the default); on the CPU each probe is timed as
soon as it and the probes before it are prepared, unless ``--serial``.
``--compile-cache DIR`` keeps Inductor's and Triton's caches and each O3
chain's device code under DIR, so a re-run or a resumed sweep compiles
nothing (its summary: ``compile cache: N hits, 0 compiled``).
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
                         "quick, table2, memory, inkernel, memory-inkernel, fused, "
                         "serving, slo)")
    ch.add_argument("--db", required=True,
                    help="LatencyDB JSON path (loaded if present; flushed "
                         "after every probe)")
    ch.add_argument("--device", default="cuda",
                    help="device to measure: cuda[:N] (default cuda:0) or cpu")
    ch.add_argument("--force", action="store_true",
                    help="re-measure probes already in the DB")
    ch.add_argument("--resume", action="store_true",
                    help="skip probes already in the DB (the default; flag "
                         "kept for explicit scripts)")
    ch.add_argument("--ops", default=None,
                    help="comma-separated op filter applied to the plan "
                         "(e.g. add,mul,clock_overhead)")
    ch.add_argument("--opt-levels", default=None,
                    help="comma-separated opt-level filter (e.g. O0,O3)")
    ch.add_argument("--table", action="store_true",
                    help="print the Table II analog after the run, the "
                         "dispatch vs in-kernel pairing where the DB has both, and "
                         "the serving cells' predicted vs measured table")
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
    ch.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="persistent compile cache directory: Inductor's and "
                         "Triton's caches and each O3 chain's device code live "
                         "there, so a re-run or a resumed sweep compiles nothing")
    ch.add_argument("--serial", action="store_true",
                    help="disable the compile-ahead pipeline: every chain lands "
                         "and every probe is prepared before any is timed (the "
                         "default on the card; on the CPU each probe is timed as "
                         "soon as it and those before it are prepared, while the "
                         "rest compile)")
    ch.add_argument("--audit", action="store_true",
                    help="statically verify each probe's compiled code as it "
                         "is prepared (chain count, guard accounting, "
                         "dependent path) and attach the verdict to the "
                         "record notes")
    ch.set_defaults(func=cmd_characterize)

    au = sub.add_parser(
        "audit",
        help="statically verify the code behind a LatencyDB's records "
             "(chain counts, guard accounting, dependent paths)")
    au.add_argument("--db", default=None,
                    help="LatencyDB JSON path to audit; verdicts are "
                         "persisted into record notes")
    au.add_argument("--plan", choices=PLAN_NAMES, default=None,
                    help="restrict the audit to records the named plan "
                         "would produce (default: every record)")
    au.add_argument("--strict", action="store_true",
                    help="exit 1 on any transformed verdict or lint finding "
                         "(default: report and exit 0)")
    au.add_argument("--recheck", action="store_true",
                    help="re-derive verdicts even for records already "
                         "carrying an audit= note")
    au.add_argument("--lint", action="store_true",
                    help="also run the static lints (table mapping, guard identity)")
    au.add_argument("--lowering", action="store_true",
                    help="with --lint: also check that each registry row's "
                         "expected ops appear in a short chain (O1's graph; "
                         "O3's PTX where this process has it)")
    au.add_argument("--zoo", action="store_true",
                    help="with --lint: also record each architecture's smoke "
                         "prefill and decode step on the CPU and check that every "
                         "op is priced, structural or allowlisted")
    au.add_argument("--archs", default=None,
                    help="comma-separated arch filter for --zoo (default: all ten)")
    au.add_argument("--dataflow", action="store_true",
                    help="with --lint: also certify every kernel family from its "
                         "compiled code: the four fused kernels (signature linear "
                         "in the workload, no local memory), the five ALU chains, "
                         "one op chain and both chase residencies")
    au.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="the compile cache the characterize run used: the O3 "
                         "chains' device code is read from its entries instead "
                         "of being compiled")
    au.add_argument("--attribution", default=None, metavar="PATH",
                    help="write the per-op O0->O1->O3 transform attribution "
                         "table (markdown) to PATH ('-' for stdout)")
    au.add_argument("--attribution-ops", default="quick",
                    help="'quick' (QUICK_OPS), 'all' (full registry), or a "
                         "comma-separated op list for --attribution")
    au.set_defaults(func=cmd_audit)

    ss = sub.add_parser(
        "serve-slo",
        help="predicted-vs-measured serving SLO sweep over arrival rates")
    ss.add_argument("--db", default="latency_db.json",
                    help="LatencyDB JSON path: pricing inputs are read from "
                         "it, slo.<rate> records are flushed back to it")
    ss.add_argument("--rates", default=None,
                    help="comma-separated arrival rates in req/s "
                         "(default: the Plan.slo sweep 20,50,100)")
    ss.add_argument("--trace", default=None,
                    help="replay a saved trace JSON (traffic.save_trace) "
                         "as one uncached point instead of the rate sweep")
    ss.add_argument("--n-requests", type=int, default=12,
                    help="requests per generated trace (rate sweep only)")
    ss.add_argument("--slots", type=int, default=4,
                    help="slot-pool size (max batch in flight)")
    ss.add_argument("--seed", type=int, default=0,
                    help="trace seed: same seed -> identical request stream")
    ss.add_argument("--force", action="store_true",
                    help="re-run slo points already in the DB")
    ss.add_argument("--device", default="cuda",
                    help="device to serve on: cuda[:N] (default cuda:0) or cpu")
    ss.add_argument("--warmup", type=int, default=2)
    ss.add_argument("--reps", type=int, default=10)
    ss.set_defaults(func=cmd_serve_slo)
    return ap


def cmd_characterize(args: argparse.Namespace) -> int:
    if args.force and args.resume:
        print("error: --force and --resume are mutually exclusive", file=sys.stderr)
        return 2
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
                      adaptive=args.adaptive, audit=args.audit,
                      compile_cache=args.compile_cache,
                      pipeline=False if args.serial else None)
    print(f"plan '{plan.name}': {len(plan)} probes -> {args.db} "
          f"[{session.env['backend']}/{session.env['device_kind']}, "
          f"{session.env['jax_version']}]")
    result = session.run(plan, force=args.force)

    print(f"plan '{plan.name}': {result.summary()}")
    if session.compile_cache is not None:
        print(compile_cache_line(session.compile_cache.root, result))
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
        serving = session.db.compare_markdown(prefix="serving.")
        if serving.count("\n") > 1:
            print("\n== serving predicted vs measured (LatencyDB x perfmodel) ==")
            print(serving)
    return 1 if result.failed else 0


def compile_cache_line(root: str, result) -> str:
    """What the run's compiles did, for a run with a compile cache: the
    cache's counts, Inductor's own cache counters in this process, the
    seconds of Inductor lowering (``GraphLowering.run``) and of preparing
    the probes."""
    import json

    from repro_torch.core.compile_cache import inductor_counts
    from repro_torch.core.measure import compile_phases

    counts = {k: v for k, v in inductor_counts().items()
              if "cache" in k or k.startswith(("inductor.triton_bundler", "triton."))}
    lowering = compile_phases().get("GraphLowering.run", 0.0)
    return (f"compile cache {root}: {result.cache_stats.hits} hits, "
            f"{result.cache_stats.misses} compiled; inductor {json.dumps(counts, sort_keys=True)}; "
            f"lowering {lowering:.3f} s; prepare {result.stage_ns.get('compile', 0) / 1e9:.3f} s")


def cmd_audit(args: argparse.Namespace) -> int:
    """Static verification: lints and/or per-record audits.

    Exit codes: 0 clean (or advisory-only without ``--strict``), 1 integrity
    violations under ``--strict``, 2 usage/IO errors.
    """
    import os

    if not (args.db or args.lint or args.attribution):
        print("error: nothing to do: pass --db, --lint or --attribution", file=sys.stderr)
        return 2
    failed = 0

    if args.lint:
        from repro_torch.audit import run_lints

        archs = [a.strip() for a in args.archs.split(",")] if args.archs else None
        findings = run_lints(lowering=args.lowering, zoo=args.zoo, archs=archs,
                             dataflow=args.dataflow)
        if findings:
            print(f"{len(findings)} lint finding(s):")
            for f in findings:
                print(f"  [{f.lint}] {f.subject}: {f.message}")
            failed += len(findings)
        else:
            print("lints clean (mapping+guards" + ("+lowering" if args.lowering else "")
                  + ("+zoo" if args.zoo else "") + ("+dataflow" if args.dataflow else "")
                  + ")")

    did_db = False
    if args.db and os.path.exists(args.db):
        from repro_torch.audit import audit_db
        from repro_torch.core.compile_cache import CompileCache
        from repro_torch.utils import parse_kv_notes

        try:
            db = LatencyDB(args.db)
        except Exception as e:  # noqa: BLE001 - unreadable DB is a usage error
            print(f"error: could not load DB {args.db}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
        cache = CompileCache(args.compile_cache) if args.compile_cache else None
        skipped = 0
        if args.plan:
            try:
                wanted = {(p.op, p.opt_level) for p in named_plan(args.plan)}
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            # audit in place but only the plan's rows: filter via a view DB
            sub = LatencyDB()
            for rec in db.records():
                if (rec.op, rec.opt_level) in wanted:
                    sub.add(rec)
                else:
                    skipped += 1
            verdicts = audit_db(sub, recheck=args.recheck, cache=cache)
            for rec in sub.records():
                kv = parse_kv_notes(rec.notes)
                db.annotate(rec.key(), audit=kv.get("audit"),
                            audit_transform=kv.get("audit_transform"))
        else:
            verdicts = audit_db(db, recheck=args.recheck, cache=cache)
        db.save()
        did_db = True
        by_status: dict[str, int] = {}
        for v in verdicts:
            by_status[v.status] = by_status.get(v.status, 0) + 1
        print(f"audited {len(verdicts)} record(s)"
              + (f" ({skipped} outside plan '{args.plan}')" if skipped else "")
              + ": " + ", ".join(f"{k}={v}" for k, v in sorted(by_status.items())))
        bad = [v for v in verdicts if v.failed]
        for v in bad:
            print(f"  TRANSFORMED {v.op}@{v.opt_level}: {v.cause}"
                  + (f" — {v.detail}" if v.detail else ""))
        for v in verdicts:
            if v.status in ("opaque", "unaudited"):
                print(f"  {v.status.upper()} {v.op}@{v.opt_level}: {v.cause}")
        for v in verdicts:
            if v.status == "audited":
                print(f"  AUDITED {v.op}@{v.opt_level}" + (f": {v.detail}" if v.detail else ""))
        failed += len(bad)
        if cache is not None:
            import json

            from repro_torch.core.compile_cache import inductor_counts
            from repro_torch.core.measure import compile_phases
            counts = {k: v for k, v in inductor_counts().items()
                      if "cache" in k or k.startswith("triton.")}
            print(f"compile cache {cache.root}: device code read from its entries; inductor "
                  f"{json.dumps(counts, sort_keys=True)}; lowering "
                  f"{compile_phases().get('GraphLowering.run', 0.0):.3f} s")
    elif args.db and not args.lint and not args.attribution:
        print(f"error: DB {args.db} does not exist (nothing to audit; "
              "pass --lint for the static checks)", file=sys.stderr)
        return 2

    if args.attribution:
        from repro_torch.audit import write_attribution

        if args.attribution_ops == "all":
            ops = None
        elif args.attribution_ops == "quick":
            from repro_torch.api.plan import QUICK_OPS

            ops = QUICK_OPS
        else:
            ops = [o.strip() for o in args.attribution_ops.split(",")]
        db_for_attr = LatencyDB(args.db) if did_db else None
        if args.attribution == "-":
            n = write_attribution(sys.stdout, ops, db=db_for_attr)
        else:
            with open(args.attribution, "w") as f:
                n = write_attribution(f, ops, db=db_for_attr)
        print(f"attribution table: {n} op(s) -> {args.attribution}")

    if failed and args.strict:
        return 1
    return 0


def cmd_serve_slo(args: argparse.Namespace) -> int:
    import os

    from repro_torch.api.plan import Plan
    from repro_torch.core.perfmodel import slo_markdown, slopoint_from_record

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.trace:
        # Replay a saved trace as a one-off point: no Session, no caching —
        # a trace file is an arbitrary workload, not a stable cache identity.
        from repro_torch.api.probes import serving_tiny_config
        from repro_torch.core.latency_db import current_environment
        from repro_torch.models import transformer
        from repro_torch.serving.engine import Engine
        from repro_torch.traffic import load_trace, run_slo_point, slo_table

        trace = load_trace(args.trace)
        if not trace:
            print(f"error: trace {args.trace} holds no requests", file=sys.stderr)
            return 2
        cfg, rt = serving_tiny_config()
        eng = Engine(transformer.init_lm(cfg, seed=0, device=device), rt)
        db = LatencyDB(args.db) if os.path.exists(args.db) else LatencyDB()
        pred, meas, cov = run_slo_point(eng, db, trace, n_slots=args.slots,
                                        filters=current_environment(device))
        span_s = trace[-1].arrival_ns * 1e-9
        rate = len(trace) / span_s if span_s > 0 else float(len(trace))
        print(f"trace {args.trace}: {len(trace)} requests, effective rate "
              f"{rate:.3g} req/s, estimator coverage {cov:.1%}")
        print(slo_table([{"rate_rps": rate, "predicted": pred, "measured": meas}]))
        return 0

    rates = [float(r) for r in args.rates.split(",")] if args.rates else None
    kw = dict(n_requests=args.n_requests, n_slots=args.slots, seed=args.seed)
    plan = Plan.slo(rates, **kw) if rates is not None else Plan.slo(**kw)
    session = Session(db=args.db, device=device,
                      timer=Timer(warmup=args.warmup, reps=args.reps, device=device))
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
    wanted = {p.op for p in plan if p.category == "slo"}
    points = sorted((slopoint_from_record(rec)
                     for rec in session.db.query(category="slo", **session.env)
                     if rec.op in wanted),
                    key=lambda p: p.rate_rps)
    print()
    print(slo_markdown(points))
    return 1 if result.failed else 0


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
