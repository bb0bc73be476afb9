"""Classify *why* a chain count is wrong, and attribute opt-level deltas.

When :mod:`repro_torch.audit.chain_check` finds a chain's opcode delta
differing from the expectation, :func:`classify` names the compiler pass
family responsible by comparing what went missing against what appeared:
the JAX package's taxonomy, the paper's Table III (constant folding,
dead-code elimination, strength reduction, algebraic simplification,
loop-invariant CSE/hoisting), with the same causes on the same counters.

:func:`write_attribution` renders the per-step opcode multisets of each row
at O0, O1 and O3 in one vocabulary, PTX opcodes (the O0 and O1 ATen ops
mapped through ``chain_check.ATEN_TO_PTX``, as the JAX package maps jaxpr
primitives into HLO), names the transform class of each stage, and adds
what a step runs in SASS and, for the row's in-kernel twin, what a step of
K2's timed form runs. O3's column is read from the chains the
measurement compiled, at the plan's lengths (64, 512), not compiled anew
at the JAX package's ``ATTR_LENS``: per-step deltas do not depend on the
length (the JAX package's own premise), and on the card no chain may be
compiled for the audit.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, Mapping, TextIO

# Ordered, documented cause taxonomy (values are the note-safe token — no
# spaces; ``parse_kv_notes`` splits notes on whitespace).
CAUSES = (
    "folded-to-constant",       # whole chain evaluated at compile time
    "dead-code-eliminated",     # ops vanished but root still reads inputs
    "strength-reduction",       # op replaced by cheaper equivalents
    "algebraic-simplification", # ops removed by identities, nothing added
    "rematerialized",           # extra copies of expected ops appeared
    "loop-invariant-cse",       # per-step op shared across steps
    "hoisted",                  # right count, but off the dependent path
    "guard-mismatch",           # declared guard algebra inconsistent
    "plumbing-nonlinear",       # convert traffic not linear in chain length
    "unknown",
)


def classify(expected: Counter, observed: Counter,
             ptx_text: str | None = None) -> str:
    """Name the pass family that best explains ``observed != expected``.

    Both counters are *positive* per-delta opcode counts (expected per-step
    x ``dn`` vs measured delta). ``ptx_text`` (the longer length's module)
    sharpens the empty-observation case: a store that depends on no input
    means the chain folded to a literal, a store still reading inputs
    means the ops were dead-code-eliminated.
    """
    if not +observed:
        if not +expected:
            return "unknown"
        if ptx_text is not None:
            from repro_torch.audit.artifacts import root_is_constant

            if root_is_constant(ptx_text):
                return "folded-to-constant"
            return "dead-code-eliminated"
        return "folded-to-constant"
    missing = expected - observed
    gained = observed - expected
    if missing and gained:
        return "strength-reduction"
    if missing:
        return "algebraic-simplification"
    if gained:
        return "rematerialized"
    return "unknown"


# ------------------------------------------------------------- attribution
# Short lengths for an O1 graph no measurement traced in this process:
# per-step deltas are length-invariant, and 4->12 keeps a sweep to seconds.
ATTR_LENS = (4, 12)


def _per_step_aten(spec, opt_level: str) -> dict[str, float]:
    """Per-step PTX multiset of ``spec``'s O0 dispatched ops or O1 graph
    ops, mapped through ``chain_check.aten_to_ptx``."""
    from repro_torch.audit import chain_check as cc
    from repro_torch.core import measure
    from repro_torch.core.chains import chain_fn, operator_form
    from repro_torch.core.optlevels import O1_GRAPHS

    if opt_level == "O0":
        n1, n2 = cc.chain_lens(spec, "O0")
        c1, c2 = (cc.dispatched_ops(chain_fn(operator_form(spec), n), *cc._cpu_args(spec))
                  for n in (n1, n2))
    else:
        n1, n2 = cc.chain_lens(spec, "O1")
        if not all(measure.chain_name(spec.name, n) in O1_GRAPHS for n in (n1, n2)):
            n1, n2 = ATTR_LENS
        c1, c2 = (cc.o1_graph_ops(spec, n) for n in (n1, n2))
    dtypes = {op: (i, o) for op, i, o in cc.traced_ops(operator_form(spec).step,
                                                        *cc._cpu_args(spec))}
    mapped: Counter = Counter()
    for op, k in (c2 - c1).items():
        i, o = dtypes.get(op, ("", ""))
        for p in cc.aten_to_ptx(op, i, o, spec) or (f"<{op}>",):
            mapped[p] += k
    return {k: v / (n2 - n1) for k, v in mapped.items()}


def _per_step_o3(spec) -> tuple[dict[str, float] | None, dict[str, float]]:
    """Per-step PTX and SASS multisets of ``spec``'s O3 chains as their
    compile workers read them (None and empty where this process has
    none)."""
    from repro_torch.audit import artifacts
    from repro_torch.audit import chain_check as cc
    from repro_torch.core import measure

    if spec.kernel is not None:
        try:
            paths, sass = cc.k2_loop_paths(spec.kernel), cc.k2_loop_sass(spec.kernel)
        except (artifacts.ToolchainMissing, RuntimeError, OSError):
            return None, {}
        if sorted(paths) != [1, 32] or None in paths.values():
            return None, {}
        return (_delta_per(paths[1], paths[32], 31), _delta_per(sass[1], sass[32], 31))
    n1, n2 = cc.chain_lens(spec, "O3")
    found = [artifacts.chain_artifacts(measure.chain_name(spec.name, n)) for n in (n1, n2)]
    if None in found:
        return None, {}
    h1, h2 = (artifacts.ptx_histogram("\n".join(f["ptx"]))[0] for f in found)
    return _delta_per(h1, h2, n2 - n1), _delta_per(Counter(found[0]["sass"]),
                                                   Counter(found[1]["sass"]), n2 - n1)


def _delta_per(c1: Mapping[str, int], c2: Mapping[str, int], dn: int) -> dict[str, float]:
    return {k: (c2.get(k, 0) - c1.get(k, 0)) / dn for k in set(c1) | set(c2)
            if c2.get(k, 0) != c1.get(k, 0)}


def _inkernel_sass(spec) -> dict[str, float]:
    """What a step of K2's timed form runs for ``spec`` (its in-kernel
    twin), empty where the row has none or the library cannot be read."""
    from repro_torch import inkernel
    from repro_torch.audit import artifacts, dataflow
    from repro_torch.kernels.opchain import TIMED_LENS

    if not inkernel.supported(spec):
        return {}
    try:
        certs = dataflow.timed_certs("op_chain_timed", dataflow.inkernel_op_pattern(spec.name),
                                     tuple(TIMED_LENS))
    except (artifacts.ToolchainMissing, RuntimeError, OSError):
        return {}
    if certs is None:
        return {}
    return dataflow.per_step(certs, TIMED_LENS)


def _stage_cause(before: Mapping[str, float], after: Mapping[str, float]) -> str:
    """Transform class for one opt-level stage; ``none`` when the per-step
    multiset is unchanged (any latency delta is pure dispatch overhead)."""
    b = Counter({k: round(v * 12) for k, v in before.items()})
    a = Counter({k: round(v * 12) for k, v in after.items()})
    if b == a:
        return "none"
    return classify(b, a)


def _fmt_multiset(ms: Mapping[str, float], top: int | None = None) -> str:
    if not ms:
        return "(empty)"
    items = sorted(ms.items(), key=lambda kv: (-kv[1], kv[0]))
    more = ""
    if top is not None and len(items) > top:
        more = f", +{len(items) - top} more ({sum(v for _, v in items[top:]):g})"
        items = items[:top]
    return ", ".join(f"{k} x{v:g}" for k, v in items) + more


def attribution_rows(ops: Iterable[str] | None = None, db=None) -> list[dict]:
    """One attribution row per op: per-step multisets at O0/O1/O3 (PTX
    vocabulary), the O3 step in SASS and the in-kernel twin's step in SASS,
    the named transform class per stage, and measured latencies when ``db``
    has them (matched on ``(op, opt_level)`` across environments)."""
    from repro_torch.audit import chain_check as cc
    from repro_torch.core.chains import default_registry

    registry = {s.name: s for s in default_registry()}
    names = list(ops) if ops is not None else list(registry)
    measured: dict[tuple[str, str], float] = {}
    if db is not None:
        for rec in db.records():
            measured.setdefault((rec.op, rec.opt_level), rec.latency_ns)
    rows = []
    for name in names:
        spec = registry.get(name)
        if spec is None:
            continue
        o0 = _per_step_aten(spec, "O0")
        o1 = _per_step_aten(spec, "O1")
        o3, o3_sass = _per_step_o3(spec)
        declared = cc._lookup(cc.EXPECTED_TRANSFORMS, name)
        rows.append({
            "op": name, "o0": o0, "o1": o1, "o3": o3, "o3_sass": o3_sass,
            "inkernel_sass": _inkernel_sass(spec),
            "stage_o0_o1": _stage_cause(o0, o1),
            "stage_o1_o3": "(no device code)" if o3 is None else _stage_cause(o1, o3),
            "declared": f"{declared[0]} ({declared[1]})" if declared else "",
            "lat_o0": measured.get((name, "O0")), "lat_o1": measured.get((name, "O1")),
            "lat_o3": measured.get((name, "O3")),
            "lat_inkernel": measured.get((f"inkernel.{name}", "O3")),
        })
    return rows


def write_attribution(out: TextIO, ops: Iterable[str] | None = None, db=None) -> int:
    """Render the O0 -> O1 -> O3 attribution table as markdown; returns the
    row count."""
    rows = attribution_rows(ops, db=db)
    out.write("# Opt-level attribution (O0 -> O1 -> O3)\n\n")
    out.write(
        "Per-step opcode multisets of each registry chain at every opt level,\n"
        "in PTX opcodes (O0: the dispatched ATen ops, O1: the ops of the graph\n"
        "AOTAutograd traced, both mapped through chain_check.ATEN_TO_PTX; O3:\n"
        "the PTX of the chain's Triton kernel, or K2's loop form, at the plan's\n"
        "lengths), with the transform class responsible for each stage delta\n"
        "(`none` = multiset unchanged; the latency delta at that stage is pure\n"
        "dispatch overhead), what an O3 step runs in SASS and what a step of\n"
        "the in-kernel twin (K2's timed form) runs. Generated by\n"
        "`python -m repro_torch audit --attribution`.\n\n")
    out.write("| op | O0 per-step | O1 per-step | O3 per-step (PTX) | O3 step (SASS) "
              "| in-kernel step (SASS) | O0->O1 | O1->O3 | declared | O0 ns | O1 ns "
              "| O3 ns | in-kernel ns |\n")
    out.write("|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    for r in rows:
        lat = [f"{r[k]:.1f}" if r[k] is not None else "-"
               for k in ("lat_o0", "lat_o1", "lat_o3", "lat_inkernel")]
        o3 = "(no device code)" if r["o3"] is None else _fmt_multiset(r["o3"], 6)
        out.write(
            f"| `{r['op']}` | {_fmt_multiset(r['o0'])} | {_fmt_multiset(r['o1'])} "
            f"| {o3} | {_sass_cell(r['o3_sass'])} | {_sass_cell(r['inkernel_sass'])} "
            f"| {r['stage_o0_o1']} | {r['stage_o1_o3']} | {r['declared'] or '-'} "
            f"| {' | '.join(lat)} |\n")
    return len(rows)


def _sass_cell(ms: Mapping[str, float]) -> str:
    if not ms:
        return "-"
    return f"{sum(ms.values()):g}: " + _fmt_multiset(ms, 4)
