"""Static lints over the port's opcode plumbing.

* **table mapping** — every ``ATEN_TO_TABLE`` value must name a registry
  row (else the estimator prices an op against a row no probe measures),
  and no op may be both priced and structural.
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
* **zoo coverage** — every op in the op records of the model zoo must be
  priced (``ATEN_TO_TABLE``), structural (``STRUCTURAL_OPS``), on the
  explicit :data:`ZOO_ALLOWLIST` or a documented library call
  (:data:`KNOWN_LIBRARY_CALLS`), and every kernel site must be a fused
  kernel the ``fused`` plan measures (else a new model quietly fills the
  estimator's default-cost bucket). The JAX lint lowers each
  architecture's train step; the port has no training yet (ROADMAP item
  14b), so it records each smoke config's prefill and first decode step
  on the CPU, with the kernels on (``attn_impl="pallas"``,
  ``use_pallas``) so that their sites appear, and otherwise the JAX
  recipe: batch 2, sequence 32, [3, B, S] positions under M-RoPE, frames
  of S / 4 for the encoder-decoder.

* **dataflow** — every kernel family certified from its compiled code by
  :mod:`repro_torch.audit.dataflow`, as the JAX package's lint does: the
  four fused kernels (signature linear in the workload, no local memory),
  the five ALU chains (K1), one op chain (K2's ``add.float32``) and both
  chase residencies (K3's ``smem`` and
  ``global``, the JAX package's ``vmem`` and ``any``). Where this process
  has no device code (the CPU, or no ``cuobjdump``) a family's verdict is
  ``unaudited:no-device-code`` or ``no-toolchain`` and is skipped, not
  failed, as the lowering lint skips an O3 chain it has no code for; the
  fused kernels' signatures are checked all the same.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Iterable

import torch


# the length of the short chain the registry-lowering lint reads at O1
LINT_LEN = 4

# Ops the zoo's records may hold that are *deliberately* not in
# ATEN_TO_TABLE. Every entry needs a reason: this list is the documented
# boundary of the estimator's default-cost bucket, kept by the zoo lint.
ZOO_ALLOWLIST: dict[str, str] = {
    # special-cased by the estimator's matmul term, never table-priced
    "mm": "priced by the estimator's dedicated matmul/FLOP term",
    "bmm": "priced by the estimator's dedicated matmul/FLOP term",
    "addmm": "priced by the estimator's dedicated matmul/FLOP term",
    "baddbmm": "priced by the estimator's dedicated matmul/FLOP term",
    # data-dependent reshuffles: their cost is memory traffic (the record's
    # bytes), and no dispatch-level chain can serialize them into a row
    "embedding": "a gather of table rows; memory-bound, priced by the bytes",
    "index": "memory-bound gather; priced by the bytes",
    "index_select": "memory-bound gather; priced by the bytes",
    "gather": "memory-bound data movement; priced by the bytes",
    "scatter": "memory-bound data movement; priced by the bytes",
    "scatter_add": "memory-bound data movement; priced by the bytes",
    "index_put": "memory-bound data movement; priced by the bytes",
    # lane-local ALU ops with no table row in the paper's ISA set
    "where": "predication; folded into the comparison it consumes",
    "eq": "sets predicates; no standalone table row",
    "ne": "sets predicates; no standalone table row",
    "lt": "sets predicates; no standalone table row",
    "le": "sets predicates; no standalone table row",
    "gt": "sets predicates; no standalone table row",
    "ge": "sets predicates; no standalone table row",
    "_to_copy": "dtype plumbing (XLA's convert); audited as linear, not priced",
    "clamp": "min+max macro of two mapped rows",
    "floor": "rounding mode of a mapped convert-class op",
    "ceil": "rounding mode of a mapped convert-class op",
    "round": "rounding mode of a mapped convert-class op",
    "sign": "compare/select macro",
    "erf": "libm composite; no table row in the paper",
    "atan2": "libm composite; no table row in the paper",
    # reductions and scans: one eager op each, a reduce tree inside
    "sum": "reduction (XLA's reduce); no table row times a reduce tree",
    "amax": "reduction (XLA's reduce); no table row times a reduce tree",
    "amin": "reduction (XLA's reduce); no table row times a reduce tree",
    "max": "reduction (XLA's reduce); no table row times a reduce tree",
    "min": "reduction (XLA's reduce); no table row times a reduce tree",
    "argmax": "reduction (XLA's reduce); no table row times a reduce tree",
    "any": "reduction (XLA's reduce); no table row times a reduce tree",
    "cumsum": "a scan (XLA's reduce-window); no table row times it",
    "var": "reduction (XLA's reduce); no table row times a reduce tree",
}

# Ops that run library code with no dependence chain to measure: the
# counterpart of the JAX lint's custom-call library targets. The lint
# accepts them (reason required); the estimator still reports each as
# unpriced, so they keep counting against coverage.
KNOWN_LIBRARY_CALLS: dict[str, str] = {
    "sort": "the MoE router's top-k (the JAX package's TopK library call): a "
            "radix sort of library code with no serializable dependence chain",
}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    lint: str       # which lint fired
    subject: str    # op / spec the finding is about
    message: str

    def __str__(self) -> str:  # pragma: no cover - display helper
        return f"[{self.lint}] {self.subject}: {self.message}"


def lint_table_mapping() -> list[LintFinding]:
    """Every ``ATEN_TO_TABLE`` value must name a measurable registry row."""
    from repro_torch.core.chains import default_registry
    from repro_torch.core.hlo_analysis import ATEN_TO_TABLE, STRUCTURAL_OPS

    spec_names = {s.name for s in default_registry()}
    findings = []
    for op, table_op in sorted(ATEN_TO_TABLE.items()):
        if table_op not in spec_names:
            findings.append(LintFinding(
                "table-mapping", op,
                f"maps to '{table_op}' which is not a registry spec — the "
                f"estimator would price it with a row no probe measures"))
        if op in STRUCTURAL_OPS:
            findings.append(LintFinding(
                "table-mapping", op,
                "is both priced (ATEN_TO_TABLE) and structural "
                "(STRUCTURAL_OPS); the estimator would double-classify it"))
    return findings


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


ZOO_BATCH, ZOO_SEQ = 2, 32


def zoo_records(arch: str):
    """The op records of one architecture's smoke config on the CPU: its
    prefill of ``ZOO_BATCH`` x ``ZOO_SEQ`` tokens and the first decode step
    after it, the kernels on (their plain versions run on the CPU), weights
    and inputs from seed 0."""
    from repro_torch.configs.registry import get
    from repro_torch.core.hlo_analysis import record_ops
    from repro_torch.models import encdec, transformer
    from repro_torch.models.config import Runtime

    rt = Runtime(moe_groups=2, mamba_chunk=8, mlstm_chunk=8, xent_chunk=16, remat=False,
                 attn_impl="pallas", use_pallas=True)
    b, s = ZOO_BATCH, ZOO_SEQ
    cfg = get(arch).smoke
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    nxt = tokens[:, -1:]
    if cfg.n_encoder_layers:
        frames = torch.randn(b, s // 4, cfg.d_model, generator=g)
        model = encdec.init_encdec(cfg, seed=0, device="cpu")
        prefill = record_ops(encdec.prefill, model, rt, frames, tokens)
        cache = encdec.pad_cache(encdec.prefill(model, rt, frames, tokens)[1], s + 1)
        decode = record_ops(encdec.decode_step, model, cache, nxt, s, rt)
        return prefill, decode
    model = transformer.init_lm(cfg, seed=0, device="cpu")
    pos = dec_pos = None
    if cfg.mrope_sections:
        pos = torch.arange(s).expand(3, b, s)
        dec_pos = torch.full((3, b, 1), s)
    prefill = record_ops(transformer.prefill, model, rt, tokens=tokens, positions=pos)
    cache = transformer.pad_cache(
        transformer.prefill(model, rt, tokens=tokens, positions=pos)[1], cfg, s + 1)
    decode = record_ops(transformer.decode_step, model, cache, nxt, s, rt, positions=dec_pos)
    return prefill, decode


def lint_zoo(archs: Iterable[str] | None = None) -> list[LintFinding]:
    """Every op in the model zoo's op records must be priced, structural,
    allowlisted or a documented library call, and every kernel site a
    fused kernel with a measured row. Records each architecture's smoke
    prefill and decode step on the CPU (seconds an architecture); times
    nothing."""
    from repro_torch.configs.registry import all_arch_ids
    from repro_torch.core.hlo_analysis import (ATEN_TO_TABLE, KERNEL_SITES,
                                               STRUCTURAL_OPS)
    from repro_torch.inkernel import FUSED_KERNELS

    findings = []
    for arch in (archs if archs is not None else all_arch_ids()):
        try:
            records = zoo_records(arch)
        except Exception as e:  # noqa: BLE001 - an arch that does not run is a finding
            findings.append(LintFinding("zoo-coverage", arch,
                                        f"prefill or decode step does not run: {e}"))
            continue
        ops = {op for rec in records for (op, _e) in rec.histogram}
        for op in sorted(ops):
            if (op not in ATEN_TO_TABLE and op not in STRUCTURAL_OPS
                    and op not in ZOO_ALLOWLIST and op not in KNOWN_LIBRARY_CALLS):
                findings.append(LintFinding(
                    "zoo-coverage", arch,
                    f"op '{op}' is neither priced (ATEN_TO_TABLE), structural, "
                    f"allowlisted nor a known library call"))
        for name in sorted({site.name for rec in records for site in rec.sites}):
            if KERNEL_SITES.get(name) not in FUSED_KERNELS:
                findings.append(LintFinding(
                    "zoo-coverage", arch,
                    f"kernel site '{name}' resolves to no fused-kernel row "
                    f"(KERNEL_SITES) — the estimator would default-price an opaque kernel"))
    return findings


# the K3 rung the dataflow lint certifies in each space (the JAX lint's 8 KiB)
DATAFLOW_RING = 8192
# the verdicts that say a family has no device code here, not that it failed
NO_CODE = ("no-device-code", "no-toolchain")


def lint_dataflow(env=None) -> list[LintFinding]:
    """Certify every kernel family from its compiled code (see the module
    docstring): the four fused kernels, the five ALU chains, the ``add``
    op chain and the chase in both spaces. ``env`` is the environment whose
    code is read (default this process's card, else the CPU)."""
    from repro_torch.audit import dataflow
    from repro_torch.audit.chain_check import _no_device_code
    from repro_torch.core.chains import spec_by_name
    from repro_torch.core.latency_db import current_environment
    from repro_torch.inkernel import FUSED_KERNELS

    if env is None:
        env = current_environment("cuda:0" if torch.cuda.is_available() else "cpu")
    findings = []

    def check(v) -> None:
        if not v.ok and not (v.status == "unaudited" and v.cause in NO_CODE):
            findings.append(LintFinding(
                "dataflow", f"{v.op}@{v.opt_level}",
                f"{v.status}:{v.cause}" + (f" — {v.detail}" if v.detail else "")))

    for name in FUSED_KERNELS:
        check(dataflow.audit_fused(name, env=env))
    kernels = [(f"kernel.alu_chain.{op}", functools.partial(dataflow.audit_alu_kernel, op, "O3"))
               for op in dataflow.ALU_OPS]
    kernels.append(("inkernel.add.float32", functools.partial(
        dataflow.audit_inkernel_op, spec_by_name("add.float32"), "O3")))
    for space in ("smem", "global"):
        kernels.append((f"inkernel.mem.{DATAFLOW_RING}.{space}", functools.partial(
            dataflow.audit_inkernel_mem, DATAFLOW_RING, "O3", space=space)))
    for op, audit in kernels:
        check(_no_device_code(op, "O3", env) or audit(op=op))
    return findings


def run_lints(lowering: bool = False, zoo: bool = False,
              archs: Iterable[str] | None = None,
              dataflow: bool = False) -> list[LintFinding]:
    """All static lints. The table mapping and guard identity always run;
    ``lowering``, ``zoo`` and ``dataflow`` opt into the slower sets."""
    findings = lint_table_mapping() + lint_guard_identity()
    if lowering:
        findings += lint_registry_lowering()
    if zoo:
        findings += lint_zoo(archs)
    if dataflow:
        findings += lint_dataflow()
    return findings
