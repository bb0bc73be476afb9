"""Static integrity auditing of what the card runs.

The measurement *times* compiled chains; this package *inspects* them,
closing the loop on the method's two unstated assumptions:

1. a timed chain of length ``n`` really holds ``n`` dependent target ops
   (``Timer.slope``'s denominator) — :mod:`repro_torch.audit.chain_check`,
   on the PTX and SASS of each chain's Triton kernel and of K2's loop form,
   on the dispatched ATen ops at O0 and on AOTAutograd's graph at O1;
2. the declared ``guard`` count matches the ops in the chain
   (``net_latency_ns``'s subtraction) — same module, and the static lints
   in :mod:`repro_torch.audit.lint`.

When a count is wrong, :mod:`repro_torch.audit.transforms` names the
compiler pass family responsible (folded, strength-reduced, CSE'd,
hoisted, ...), the paper's Table III taxonomy, and writes the O0 -> O1 ->
O3 attribution table. K1-K3's timed forms are opened by
:mod:`repro_torch.audit.dataflow` (serialization, residency, signature, on
their SASS), and so are the fused kernels K4-K7 (a signature linear in the
workload, no local memory): ``audited``.

Entry points: ``python -m repro_torch audit`` (CLI),
``Session(audit=True)`` / ``characterize --audit`` (verdicts attached as
records are measured), or :func:`audit_db`. Verdicts persist in record
notes as ``audit=ok`` / ``audit=audited`` / ``audit=transformed:<cause>``
/ ``audit=opaque:<reason>`` / ``audit=unaudited:<reason>``, the JAX
package's tokens, and round-trip through :func:`repro_torch.utils.parse_kv_notes`.
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.audit.chain_check import (ChainVerdict, audit_chase, audit_clock_overhead,
                                           audit_kernel, audit_spec, audit_target,
                                           expected_step, ptx_path_counts)
from repro_torch.audit.dataflow import (audit_alu_kernel, audit_fused, audit_inkernel_mem,
                                        audit_inkernel_op, fused_registry, fused_unit)
from repro_torch.audit.lint import LintFinding, lint_dataflow, run_lints
from repro_torch.audit.transforms import classify, write_attribution

__all__ = [
    "ChainVerdict", "LintFinding", "audit_alu_kernel", "audit_chase",
    "audit_clock_overhead", "audit_db", "audit_fused", "audit_inkernel_mem",
    "audit_inkernel_op", "audit_kernel", "audit_record", "audit_spec", "audit_target",
    "classify", "expected_step", "fused_registry", "fused_unit", "lint_dataflow",
    "ptx_path_counts", "run_lints", "write_attribution",
]


def audit_record(rec, *, env: Mapping[str, str] | None = None, cache=None) -> ChainVerdict:
    """Audit one LatencyRecord's artifact. Records measured under a different
    environment fingerprint than the current process cannot be re-derived
    here and come back ``unaudited:environment-mismatch``. ``cache``: a
    compile cache that keeps the O3 chains' device code."""
    if env is not None and (rec.device_kind, rec.backend, rec.jax_version) != (
            env.get("device_kind"), env.get("backend"), env.get("jax_version")):
        return ChainVerdict(
            rec.op, rec.opt_level, "unaudited", cause="environment-mismatch",
            detail=f"record from {rec.device_kind}/{rec.jax_version}, "
                   f"auditing on {env.get('device_kind')}/{env.get('jax_version')}")
    return audit_target(rec.op, rec.opt_level, env=env, cache=cache)


def annotation(v: ChainVerdict) -> dict[str, str | None]:
    """The notes tokens of a verdict, as ``LatencyDB.annotate`` takes them."""
    return {"audit": v.status if not v.cause or v.status == "ok" else f"{v.status}:{v.cause}",
            "audit_transform": v.cause if (v.status == "ok" and v.cause) else None}


def audit_db(db, *, env: Mapping[str, str] | None = None, recheck: bool = False,
             annotate: bool = True, cache=None) -> list[ChainVerdict]:
    """Audit every record in ``db``; returns verdicts in record order.

    Verdicts are persisted into each record's notes (``annotate=False`` for
    a dry run); existing verdicts are kept unless ``recheck``. Environment-
    mismatched records are reported but never annotated — their artifacts
    are not reconstructible in this process and a previously attached
    verdict from the measuring environment stays authoritative. ``env``
    defaults to this process's CUDA card, or the CPU where there is none.
    ``cache``: a compile cache whose entries hold the O3 chains' device
    code (``audit --compile-cache``), read where this process holds none.
    """
    from repro_torch.audit.chain_check import _verdict_from_note
    from repro_torch.core.latency_db import current_environment

    if env is None:
        import torch
        env = current_environment("cuda:0" if torch.cuda.is_available() else "cpu")
    verdicts = []
    for rec in db.records():
        existing = _verdict_from_note(rec.op, rec.opt_level, rec.notes)
        mismatch = (rec.device_kind, rec.backend, rec.jax_version) != (
            env["device_kind"], env["backend"], env["jax_version"])
        if mismatch and existing is not None:
            verdicts.append(existing)
            continue
        if existing is not None and not recheck:
            verdicts.append(existing)
            continue
        v = audit_record(rec, env=env, cache=cache)
        verdicts.append(v)
        if annotate and not mismatch:
            db.annotate(rec.key(), **annotation(v))
    return verdicts
