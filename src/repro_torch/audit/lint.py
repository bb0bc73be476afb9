"""Static lints over the port's opcode plumbing.

* **guard identity** — every registry row's declared ``guard`` count must
  match the audit's declared guard opcodes, and those opcodes must be in
  the row's own per-step multiset (else ``net_latency_ns`` subtracts
  baselines that are not in the chain). Trace only: no compile, no card.
* **registry lowering** — the cheap presence-only cousin of
  :func:`repro_torch.audit.chain_check.audit_spec`: each row's expected
  target ops appear in one short chain at each level. At O1 these are the
  ATen ops of the graph AOTAutograd traces (on the CPU and on the card
  alike); at O3 the PTX opcodes of a chain this process compiled or loaded
  (on the card: the measurement's own, so nothing is compiled for the
  lint), and where it has none the row is skipped, not failed.

``lint_table_mapping`` waits for the port's pricing table
(``core/hlo_analysis.py``'s counterpart), ``lint_zoo`` for the model zoo
and ``lint_dataflow`` for the fused half of ``audit/dataflow.py``:
:func:`run_lints` raises for ``zoo`` and ``dataflow``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter


# the length of the short chain the registry-lowering lint reads at O1
LINT_LEN = 4


@dataclasses.dataclass(frozen=True)
class LintFinding:
    lint: str       # which lint fired
    subject: str    # op / spec the finding is about
    message: str

    def __str__(self) -> str:  # pragma: no cover - display helper
        return f"[{self.lint}] {self.subject}: {self.message}"


def lint_guard_identity() -> list[LintFinding]:
    """Declared guard counts vs declared guard opcodes vs per-step multiset."""
    from repro_torch.audit.chain_check import GUARDS, _lookup, expected_step, guards_contained
    from repro_torch.core.chains import default_registry

    findings = []
    for spec in default_registry():
        try:
            exp = expected_step(spec, "O3")
        except Exception as e:  # noqa: BLE001 - a row that won't trace is a finding
            findings.append(LintFinding("guard-identity", spec.name,
                                        f"step does not trace: {e}"))
            continue
        if exp.unknown:
            findings.append(LintFinding(
                "guard-identity", spec.name,
                f"ATen ops with no PTX mapping: {list(exp.unknown)}"))
            continue
        if spec.guard == 0:
            continue
        if _lookup(GUARDS, spec.name) is None:
            findings.append(LintFinding(
                "guard-identity", spec.name,
                f"spec.guard={spec.guard} but no guard opcodes declared in audit GUARDS"))
            continue
        if sum(exp.guards.values()) != spec.guard:
            findings.append(LintFinding(
                "guard-identity", spec.name,
                f"spec.guard={spec.guard} != declared guard opcodes {dict(exp.guards)}"))
        if not guards_contained(exp.guards, exp.semantic):
            findings.append(LintFinding(
                "guard-identity", spec.name,
                f"declared guard opcodes {dict(exp.guards)} not contained in the "
                f"per-step multiset {dict(exp.semantic)}"))
    return findings


def lint_registry_lowering(opt_levels: tuple[str, ...] = ("O1", "O3"),
                           chain_len: int = LINT_LEN) -> list[LintFinding]:
    """Presence check: each row's expected ops appear in one short chain at
    each opt level (O1: the traced graph's ATen ops at ``chain_len``; O3:
    the PTX of the shorter measured chain, where this process has it)."""
    from repro_torch.audit import artifacts
    from repro_torch.audit.chain_check import (chain_lens, expected_step, o1_graph_ops,
                                               step_ops)
    from repro_torch.core import measure
    from repro_torch.core.chains import default_registry

    findings = []
    for spec in default_registry():
        for level in opt_levels:
            subject = f"{spec.name}@{level}"
            try:
                if level == "O1":
                    n = chain_len if spec.max_chain is None else min(chain_len, spec.max_chain)
                    want, have = Counter({k: v * n for k, v in step_ops(spec).items()}), \
                        o1_graph_ops(spec, n)
                else:
                    exp = expected_step(spec, level)
                    if exp.unknown or exp.library:
                        continue  # reported by lint_guard_identity / a libdevice step
                    if spec.kernel is not None:
                        continue  # K2's loop form: audited by audit_spec
                    n = chain_lens(spec, level)[0]
                    found = artifacts.chain_artifacts(measure.chain_name(spec.name, n))
                    if found is None:
                        continue  # no device code here
                    want = Counter(exp.targets)
                    have = artifacts.ptx_histogram("\n".join(found["ptx"]))[0]
            except Exception as e:  # noqa: BLE001 - a row that won't lower is a finding
                findings.append(LintFinding("registry-lowering", subject,
                                            f"chain does not compile: {e}"))
                continue
            missing = {op: k for op, k in want.items() if have.get(op, 0) < k}
            if missing:
                findings.append(LintFinding(
                    "registry-lowering", subject,
                    f"expected ops {missing} absent from the chain (got {dict(have)})"))
    return findings


def run_lints(lowering: bool = False, zoo: bool = False,
              dataflow: bool = False) -> list[LintFinding]:
    """All ported static lints. The trace-only set always runs; ``lowering``
    opts into the registry-lowering lint. ``zoo`` and ``dataflow`` are not
    ported yet and raise."""
    if zoo or dataflow:
        raise NotImplementedError(
            f"lint {'zoo' if zoo else 'dataflow'} is not ported yet (it waits for "
            f"{'the model zoo' if zoo else 'the fused half of audit/dataflow.py'}; "
            "see ROADMAP.md)")
    findings = lint_guard_identity()
    if lowering:
        findings += lint_registry_lowering()
    return findings
