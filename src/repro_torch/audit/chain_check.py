"""Static chain-integrity verification of what the card runs.

The paper's validity claim, and this repo's, is that a timed chain of
length ``n`` really executes ``n`` dependent instances of the target
instruction. The JAX package checks it on XLA's optimized HLO; this module
checks it on the code the card runs. Given a row's two chain lengths it

1. derives the **expected per-step opcode multiset** from the semantic
   program: one step's ATen ops, traced as they are dispatched, mapped
   through :data:`ATEN_TO_PTX` (per dtype) into PTX opcodes, and adjusted by
   the compiler transforms declared in :data:`EXPECTED_TRANSFORMS`, each
   with its cause (``transforms.CAUSES``) and the stage that makes it
   (Inductor, LLVM behind Triton, nvcc, ptxas);
2. checks the **two-length delta**: the PTX opcode counts of the chain's
   Triton kernel at ``n2`` less those at ``n1`` must be exactly ``(n2-n1)``
   times that multiset, the denominator ``Timer.slope`` assumes; ``cvt``
   is dtype plumbing and must only scale linearly;
3. checks the **guard identity**: the declared guard opcodes
   (:data:`GUARDS`) sum to ``spec.guard`` and are in the step's semantic
   multiset, which licenses ``net_latency_ns``'s subtraction;
4. walks the **dependent path** (PTX is SSA over virtual registers) from
   the carry's load to the store and requires every expected op on it
   ``count x n2`` times; an op with the right count off the path was
   hoisted and is not serialized by the measurement;
5. cross-checks on **SASS**: a step that holds fewer than one SASS
   instruction (ptxas folded what the PTX still had) is never ``ok``.

At O0 the dispatched ATen ops are counted (their delta between the O0
lengths must be ``dn`` steps' ops); at O1 the ATen ops of the graph
AOTAutograd traced. Both are device-independent. O3 needs device code:
on the CPU an O3 verdict is ``unaudited:no-device-code``, never ``ok``.

Verdicts are :class:`ChainVerdict`\\ s, whose :meth:`~ChainVerdict.note`
is the JAX package's token format (``audit=ok`` /
``audit=transformed:<cause>`` / ``audit=unaudited:<cause>`` ...).
"""
from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import Any, Iterable, Mapping

import torch

from repro_torch.audit import artifacts
from repro_torch.core import measure
from repro_torch.core.chains import OpSpec, chain_fn, default_registry, operator_form

# dtype plumbing, never measured arithmetic: required to be linear in the
# chain length but never matched against the expectation
PLUMBING_OPS = artifacts.PTX_PLUMBING

_INT = ("int32", "int64", "uint32")
# PTX type suffixes of a dtype: (arithmetic, bitwise, float, select)
_TYPES = {"int32": ("s32", "b32", "", "b32"), "int64": ("s64", "b64", "", "b64"),
          "uint32": ("u32", "b32", "", "b32"), "float32": ("", "", "f32", "f32"),
          "float64": ("", "", "f64", "f64"), "bfloat16": ("", "", "bf16", "b16"),
          "float16": ("", "", "f16", "b16")}

# ATen op -> the PTX opcodes it lowers to through Inductor and Triton, by
# the kind of its input dtype; ``{s}``, ``{b}``, ``{f}``, ``{sel}`` are
# the dtype's arithmetic, bitwise, float and select types (:data:`_TYPES`).
# A value of several opcodes is a lowering expansion (Triton's
# NaN-propagating minimum is a compare, a NaN test and two selects), not
# an optimization. A ``libdevice.`` value marks a step that lowers to a
# libdevice sequence with branches (its slow paths): no one target
# instruction counts it.
LIBRARY = "libdevice."
ATEN_TO_PTX: dict[tuple[str, str], tuple[str, ...]] = {
    ("add", "int"): ("add.{s}",), ("add", "float"): ("add.{f}",),
    ("sub", "int"): ("sub.{s}",), ("sub", "float"): ("sub.{f}",),
    ("mul", "int"): ("mul.lo.{s}",), ("mul", "float"): ("mul.{f}",),
    ("bitwise_xor", "int"): ("xor.{b}",), ("bitwise_and", "int"): ("and.{b}",),
    ("bitwise_or", "int"): ("or.{b}",), ("bitwise_not", "int"): ("not.{b}",),
    ("__lshift__", "int"): ("shl.{b}",), ("__rshift__", "int"): ("shr.{s}",),
    ("minimum", "int"): ("min.{s}",), ("maximum", "int"): ("max.{s}",),
    ("minimum", "float"): ("setp.{f}", "setp.{f}", "selp.{sel}", "selp.{sel}"),
    ("maximum", "float"): ("setp.{f}", "setp.{f}", "selp.{sel}", "selp.{sel}"),
    ("abs", "int"): ("abs.{s}",),
    ("div", "int"): ("div.{s}",),            # rounding_mode="trunc"
    ("fmod", "int"): ("rem.{s}",),
    ("eq", "int"): ("setp.{b}",),
    ("_to_copy", "bool"): ("selp.{b}",),     # a predicate made an integer
    # Triton's float division: div.full.f32 (approximate), div.rn.f64
    ("div", "float32"): ("div.full.f32",), ("div", "float64"): ("div.f64",),
    ("reciprocal", "float32"): ("div.full.f32",),
    ("sqrt", "float"): ("sqrt.{f}",), ("rsqrt", "float"): ("rsqrt.approx.{f}",),
    ("exp2", "float"): ("ex2.approx.{f}",), ("copysign", "float"): ("copysign.{f}",),
    ("sin", "float"): ("libdevice.sinf",), ("cos", "float"): ("libdevice.cosf",),
    ("log2", "float"): ("libdevice.log2f",), ("tanh", "float"): ("libdevice.tanhf",),
}

# What one step of each K2 row (``OpSpec.kernel``) computes, in PTX opcodes,
# from its C++ step in ``csrc/op_chain_steps.cuh``: the row's one ATen op,
# ``repro_torch.op_chain_step``, stands for it.
KERNEL_STEP_PTX: dict[str, dict[str, int]] = {
    "add": {"add.s32": 1, "xor.b32": 1},                       # (x + a) ^ b
    "popc": {"popc.b32": 1, "xor.b32": 1},                     # __popc(x) ^ a
    "clz": {"clz.b32": 1, "add.s32": 1},                       # __clz(x) + a
    "div.u.regular": {"div.u32": 1, "add.s32": 1},             # x / 8u + a
    "div.u.irregular": {"div.u32": 1, "add.s32": 1},           # x / 6u + a
    "div.u.runtime": {"div.u32": 1, "add.s32": 1},             # x / a + b
    "rem.u": {"rem.u32": 1, "add.s32": 1},                     # x % a + b
    # (uint32)(((uint64)x * a) >> 32) | 1u
    "mul64hi": {"mul.lo.s64": 1, "shr.u64": 1, "or.b32": 1},
}

# Declared guard opcodes per row (with multiplicity), by PTX root: the JAX
# package's table, keyed the same way (a row's name with any trailing dtype
# component stripped). Rows with ``guard == 0`` never consult it.
GUARDS: dict[str, tuple[str, ...]] = {
    "add": ("xor",), "sub": ("xor",), "mul": ("xor",), "mad": ("xor",),
    "min": ("add",), "max": ("sub",), "abs": ("sub",),
    "div.s.regular": ("add",), "div.s.irregular": ("add",),
    "div.s.runtime": ("add",), "div.u.regular": ("add",),
    "div.u.irregular": ("add",), "div.u.runtime": ("add",),
    "rem.s": ("add",), "rem.u": ("add",),
    "and": ("add",), "or": ("add",), "xor": ("add",), "not": ("add",),
    "cnot": ("add",), "shl": ("or",), "shr": ("or",),
    "div.regular": ("add",), "div.irregular": ("add",),
    "div.runtime": ("add",),
    "add.cc": ("xor",), "sub.cc": ("xor",), "mad.cc": ("xor",),
    "mul.wide": ("xor",), "mul64hi": ("or", "shr"),
    "rcp": ("add",), "sqrt": ("add",), "rsqrt": ("add",), "sin": ("add",),
    "lg2": ("add",), "ex2": ("sub",), "tanh": ("add",),
    "copysign": ("add",), "sad": ("add",), "popc": ("xor",),
    "clz": ("add",), "bfe": ("and", "add"), "bfi": ("and", "or"),
    "mul24": ("and", "and"),
}

# Compiler transforms the audit expects at O3, each with its cause, the
# stage that makes it, and the per-step opcodes it removes and adds. A row
# matching its transformed expectation audits ``ok`` with the cause noted;
# anything else is ``transformed:<cause>``. Keyed by row (or base) name.
EXPECTED_TRANSFORMS: dict[str, tuple[str, str, dict[str, int], dict[str, int]]] = {
    # a multiply feeding an add becomes one multiply-add (the row's target)
    "mad": ("strength-reduction", "LLVM", {"mul.lo.s32": 1, "add.s32": 1},
            {"mad.lo.s32": 1}),
    "mad.cc": ("strength-reduction", "LLVM", {"mul.lo.s64": 1, "add.s64": 1},
               {"mad.lo.s64": 1}),
    "fma.float32": ("strength-reduction", "LLVM", {"mul.f32": 1, "add.f32": 1},
                    {"fma.f32": 1}),
    "fma.float64": ("strength-reduction", "LLVM", {"mul.f64": 1, "add.f64": 1},
                    {"fma.f64": 1}),
    # signed divide by a constant: by 4, the shift with its round-toward-zero
    # fixup (sra 31, srl 30, add, sra 2); by 5, a magic multiply (mulhs, sra,
    # srl 31, add)
    "div.s.regular": ("strength-reduction", "LLVM", {"div.s32": 1},
                      {"shr.s32": 2, "shr.u32": 1, "add.s32": 1}),
    "div.s.irregular": ("strength-reduction", "LLVM", {"div.s32": 1},
                        {"mul.hi.s32": 1, "shr.s32": 1, "shr.u32": 1, "add.s32": 1}),
    # unsigned divide by a constant in K2: by 8 a shift; by 6 a wide magic
    # multiply and a shift of its high word
    "div.u.regular": ("strength-reduction", "nvcc", {"div.u32": 1}, {"shr.u32": 1}),
    "div.u.irregular": ("strength-reduction", "nvcc", {"div.u32": 1},
                        {"mul.wide.u32": 1, "shr.u64": 1}),
    # the | 1 is taken on the 64-bit value before the truncation (same word)
    "mul64hi": ("strength-reduction", "nvcc", {"or.b32": 1}, {"or.b64": 1}),
    # float divide by a constant: Inductor multiplies by the reciprocal (1/4
    # exact, 1/3 rounded) and LLVM contracts the multiply with the add
    "div.regular.float32": ("strength-reduction", "Inductor+LLVM",
                            {"div.full.f32": 1, "add.f32": 1}, {"fma.f32": 1}),
    "div.irregular.float32": ("strength-reduction", "Inductor+LLVM",
                              {"div.full.f32": 1, "add.f32": 1}, {"fma.f32": 1}),
    "div.regular.float64": ("strength-reduction", "Inductor+LLVM",
                            {"div.f64": 1, "add.f64": 1}, {"fma.f64": 1}),
    "div.irregular.float64": ("strength-reduction", "Inductor+LLVM",
                              {"div.f64": 1, "add.f64": 1}, {"fma.f64": 1}),
    # 1.0 / x traces as reciprocal(x) * 1.0; the multiply by one folds
    "rcp": ("algebraic-simplification", "LLVM", {"mul.f32": 1}, {}),
    # the (a & mask) operand-side masks are loop-invariant and CSE'd (as the
    # JAX package declares)
    "bfi": ("loop-invariant-cse", "LLVM", {"and.b32": 1}, {}),
    "mul24": ("loop-invariant-cse", "LLVM", {"and.b32": 1}, {}),
}

_DTYPE_TOKENS = frozenset({"float32", "float64", "float16", "bfloat16",
                           "int32", "int64", "uint32", "uint64"})


def base_name(op: str) -> str:
    """Spec name with trailing dtype components stripped
    (``div.regular.float32`` -> ``div.regular``)."""
    parts = op.split(".")
    while len(parts) > 1 and parts[-1] in _DTYPE_TOKENS:
        parts.pop()
    return ".".join(parts)


def _lookup(table: Mapping[str, Any], op: str) -> Any:
    for key in (op, base_name(op)):
        if key in table:
            return table[key]
    return None


# -------------------------------------------------------------- ATen side
def _dtype_name(t: Any) -> str:
    return str(t.dtype).removeprefix("torch.") if isinstance(t, torch.Tensor) else ""


def traced_ops(fn, *args) -> list[tuple[str, str, str]]:
    """The ATen ops ``fn(*args)`` dispatches, in order, as ``(op, input
    dtype, output dtype)``: ``op`` is the overload's name
    (``aten.add.Tensor``, ``repro_torch.op_chain_step.default``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen: list[tuple[str, str, str]] = []

    class _Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            first = next((x for x in a if isinstance(x, torch.Tensor)), None)
            seen.append((str(func), _dtype_name(first), _dtype_name(out)))
            return out

    with _Trace():
        fn(*args)
    return seen


def dispatched_ops(fn, *args) -> Counter:
    """How often each ATen op is dispatched by ``fn(*args)``."""
    return Counter(op for op, _, _ in traced_ops(fn, *args))


def _cpu_args(spec: OpSpec) -> tuple:
    return (spec.carry("cpu"), *spec.operand_tensors("cpu"))


def step_ops(spec: OpSpec) -> Counter:
    """One chain step's dispatched ATen ops: the semantic program (a K2
    row's step, one ``op_chain`` launch, as the one ``op_chain_step``
    operator: ``chains.operator_form``)."""
    return dispatched_ops(operator_form(spec).step, *_cpu_args(spec))


def aten_to_ptx(op: str, in_dtype: str, out_dtype: str, spec: OpSpec | None = None
                ) -> tuple[str, ...] | None:
    """The PTX opcodes ATen op ``op`` lowers to (:data:`ATEN_TO_PTX`), or
    None when it has no mapping."""
    if op.startswith("repro_torch.op_chain_step") and spec is not None and spec.kernel:
        step = KERNEL_STEP_PTX.get(spec.kernel)
        return tuple(o for o, k in step.items() for _ in range(k)) if step else None
    name = op.split(".")[1] if op.count(".") >= 2 else op
    if name == "_to_copy" and in_dtype == "bool":
        key = (name, "bool")
        s, b, f, sel = _TYPES.get(out_dtype, ("", "", "", ""))
    else:
        kind = "int" if in_dtype in _INT else "float"
        key = next((k for k in ((name, in_dtype), (name, kind)) if k in ATEN_TO_PTX), None)
        s, b, f, sel = _TYPES.get(in_dtype, ("", "", "", ""))
    if key is None or key not in ATEN_TO_PTX:
        return None
    return tuple(o.format(s=s, b=b, f=f, sel=sel) for o in ATEN_TO_PTX[key])


def map_ops(traced: Iterable[tuple[str, str, str]], spec: OpSpec | None = None
            ) -> tuple[Counter, list[str]]:
    """``(PTX opcode counts, ATen ops with no mapping)`` of traced ops."""
    counts, unknown = Counter(), []
    for op, i, o in traced:
        ptx = aten_to_ptx(op, i, o, spec)
        if ptx is None:
            unknown.append(op)
            continue
        for p in ptx:
            if artifacts.ptx_root(p) not in PLUMBING_OPS:
                counts[p] += 1
    return counts, unknown


@dataclasses.dataclass(frozen=True)
class ExpectedStep:
    """Per-step PTX expectation for one spec at one opt level."""

    counts: Counter              # PTX opcodes per step (after transforms)
    guards: Counter              # declared guard roots
    semantic: Counter            # PTX opcodes per step before any transform
    transform: str = ""          # named expected-transform cause, "" if none
    stage: str = ""              # the compiler stage that makes it
    unknown: tuple[str, ...] = ()  # ATen ops with no PTX mapping
    library: bool = False        # the step lowers to a library sequence

    @property
    def targets(self) -> Counter:
        """The expected opcodes that are not guards (by root)."""
        out = Counter(self.counts)
        for root, k in self.guards.items():
            for op in sorted(out):
                if artifacts.ptx_root(op) == root and k:
                    take = min(out[op], k)
                    out[op] -= take
                    k -= take
        return +out


def guards_contained(guards: Counter, counts: Counter) -> bool:
    """Whether every declared guard root has that many ops in ``counts``."""
    roots = Counter()
    for op, k in counts.items():
        roots[artifacts.ptx_root(op)] += k
    return not (guards - roots)


def expected_step(spec: OpSpec, opt_level: str) -> ExpectedStep:
    """Derive the expected per-step PTX multiset for ``spec``: one step's
    ATen ops -> :data:`ATEN_TO_PTX` -> :data:`EXPECTED_TRANSFORMS` (O3
    only: eager dispatch and AOTAutograd's graph execute the ops as they
    are)."""
    traced = traced_ops(operator_form(spec).step, *_cpu_args(spec))
    counts, unknown = map_ops(traced, spec)
    library = any(op.startswith(LIBRARY) for op in counts)
    counts = Counter({op: k for op, k in counts.items() if not op.startswith(LIBRARY)})
    semantic = Counter(counts)
    transform = stage = ""
    if opt_level == "O3":
        override = _lookup(EXPECTED_TRANSFORMS, spec.name)
        if override is not None:
            cause, where, remove, add = override
            removed = Counter(remove)
            if removed - counts:  # the declared transform doesn't apply here
                unknown.append(f"transform:{cause}")
            else:
                counts = counts - removed + Counter(add)
                transform, stage = cause, where
    guards = Counter(_lookup(GUARDS, spec.name) or ()) if spec.guard else Counter()
    return ExpectedStep(counts=counts, guards=guards, semantic=semantic,
                        transform=transform, stage=stage, unknown=tuple(unknown),
                        library=library)


# ------------------------------------------------------------------ verdict
@dataclasses.dataclass(frozen=True)
class ChainVerdict:
    """Outcome of one static integrity check.

    ``status``: ``ok`` (chain count + guard accounting exact), ``audited``
    (a K1-K3 kernel's compiled code itself was opened and certified by
    ``repro_torch.audit.dataflow``: serialization + residency + signature),
    ``transformed`` (the compiler broke the chain assumption; ``cause``
    names the pass family), ``opaque`` (artifact is not inspectable),
    ``unaudited`` (no checker covers this record family, no device code
    exists for it, or the environment doesn't match).
    """

    op: str
    opt_level: str
    status: str
    cause: str = ""
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "audited")

    @property
    def failed(self) -> bool:
        return self.status == "transformed"

    def note(self) -> str:
        """The ``audit=...`` token persisted into LatencyDB record notes."""
        if self.status == "ok":
            tok = "audit=ok"
            if self.cause:
                tok += f" audit_transform={self.cause}"
            return tok
        if self.cause:
            return f"audit={self.status}:{self.cause}"
        return f"audit={self.status}"


def _verdict_from_note(op: str, opt_level: str, notes: str
                       ) -> ChainVerdict | None:
    """Parse a persisted ``audit=`` token back into a verdict, or None."""
    from repro_torch.utils import parse_kv_notes

    kv = parse_kv_notes(notes)
    tok = kv.get("audit")
    if not tok:
        return None
    status, _, cause = tok.partition(":")
    if status == "ok":
        cause = kv.get("audit_transform", "")
    return ChainVerdict(op=op, opt_level=opt_level, status=status, cause=cause)


def _delta(c2: Counter, c1: Counter) -> dict[str, int]:
    return {k: c2.get(k, 0) - c1.get(k, 0)
            for k in set(c2) | set(c1)
            if c2.get(k, 0) != c1.get(k, 0)}


def _fmt(counts: Mapping[str, float]) -> str:
    return " ".join(f"{k}:{v:g}" for k, v in sorted(counts.items())) or "(none)"


def _no_device_code(op: str, opt_level: str, env: Mapping[str, str] | None) -> ChainVerdict | None:
    """``unaudited:no-device-code`` for a row measured on the CPU (no code
    ran on a card), ``unaudited:no-toolchain`` where cuobjdump is missing;
    None when device code can be read."""
    if env is not None and env.get("backend") != "cuda":
        return ChainVerdict(op, opt_level, "unaudited", cause="no-device-code",
                            detail=f"measured on {env.get('backend')}: no code ran on a card")
    try:
        artifacts.cuobjdump()
    except artifacts.ToolchainMissing as e:
        return ChainVerdict(op, opt_level, "unaudited", cause="no-toolchain", detail=str(e))
    return None


# ----------------------------------------------------------- spec auditing
def chain_lens(spec: OpSpec, opt_level: str) -> tuple[int, int]:
    """The two chain lengths a row is measured at (``measure._CHAIN_LENS``,
    capped at ``max_chain``)."""
    n1, n2 = measure._CHAIN_LENS[opt_level]
    if spec.max_chain is not None:
        n1, n2 = min(n1, spec.max_chain // 3), min(n2, spec.max_chain)
    return n1, n2


def o1_graph_ops(spec: OpSpec, n: int) -> Counter:
    """The ATen ops of the graph AOTAutograd traced for ``spec``'s O1 chain
    of length ``n``: the one an O1 compile of this process kept
    (``optlevels.O1_GRAPHS``), or that of a compile on the CPU now (the
    graph does not depend on the device)."""
    from repro_torch.core.optlevels import O1_GRAPHS

    name = measure.chain_name(spec.name, n)
    if name not in O1_GRAPHS:
        measure._first_call(measure.compile_chain(spec, n, "O1", "cpu"), *_cpu_args(spec))
    return Counter(O1_GRAPHS[name])


def audit_spec(spec: OpSpec, opt_level: str, *, env: Mapping[str, str] | None = None,
               lens: tuple[int, int] | None = None, cache=None) -> ChainVerdict:
    """Full chain-integrity check of one registry spec at one opt level. An
    O3 chain's device code is what this process holds, else what compile
    cache ``cache`` keeps for it (``core.compile_cache``)."""
    n1, n2 = lens if lens is not None else chain_lens(spec, opt_level)
    if opt_level in ("O0", "O1"):
        return _audit_spec_aten(spec, opt_level, (n1, n2))
    exp = expected_step(spec, opt_level)
    if exp.unknown:
        return ChainVerdict(spec.name, opt_level, "unaudited", cause="unmapped-op",
                            detail=f"no PTX mapping for {list(exp.unknown)}")
    # guard identity: declared guard count == declared guard opcodes, all
    # of them in the step's semantic multiset
    if sum(exp.guards.values()) != spec.guard or not guards_contained(exp.guards, exp.semantic):
        return ChainVerdict(
            spec.name, opt_level, "transformed", cause="guard-mismatch",
            detail=f"spec.guard={spec.guard} but declared guard ops "
                   f"[{_fmt(exp.guards)}] vs step [{_fmt(exp.semantic)}]")
    missing = _no_device_code(spec.name, opt_level, env)
    if missing is not None:
        return missing
    if spec.kernel is not None:
        return _audit_kernel_row(spec, exp)
    found = [artifacts.chain_artifacts(
        measure.chain_name(spec.name, n), cache,
        measure.chain_cache_key(spec, n, opt_level, env) if env is not None else None)
        for n in (n1, n2)]
    if None in found:
        return ChainVerdict(spec.name, opt_level, "unaudited", cause="artifact-missing",
                            detail=f"no compile worker handed this process the Triton "
                                   f"kernels of this row's chains at n {n1}, {n2}")
    return judge_ptx(spec.name, exp, ["\n".join(f["ptx"]) for f in found], (n1, n2),
                     carry=found[1]["carry"], sass=[f.get("sass") for f in found])


def judge_ptx(op: str, exp: ExpectedStep, texts: list[str], lens: tuple[int, int],
              carry: Mapping[str, str], sass: list[Mapping[str, int] | None] | None = None,
              opt_level: str = "O3") -> ChainVerdict:
    """Judge one row's two chains from their PTX (and SASS mnemonic counts,
    if given) against the expected step: the two-length delta, the plumbing's
    linearity, the dependent path from the carry's load (``carry``: the
    parameter of each kernel of the longer chain that holds the carry, by
    kernel name), the SASS cross-check."""
    from repro_torch.audit.transforms import classify

    n1, n2 = lens
    dn = n2 - n1
    (c1, p1), (c2, p2) = artifacts.ptx_histogram(texts[0]), artifacts.ptx_histogram(texts[1])
    branches = artifacts.ptx_branches(texts[1]) - artifacts.ptx_branches(texts[0])
    if exp.library:
        if branches > 0:
            return ChainVerdict(op, opt_level, "unaudited", cause="branching-step",
                                detail=f"a libdevice sequence with {branches / dn:g} branches "
                                       "a step: its slow paths leave the def-use walk")
        return ChainVerdict(op, opt_level, "unaudited", cause="library-step",
                            detail="a libdevice sequence with no declared target instruction")
    observed = _delta(c2, c1)
    expected = {k: v * dn for k, v in exp.counts.items()}
    if observed != expected:
        cause = classify(Counter(expected), Counter({k: v for k, v in observed.items() if v > 0}),
                         texts[1])
        return ChainVerdict(op, opt_level, "transformed", cause=cause,
                            detail=f"lens {n1}->{n2}: expected delta [{_fmt(expected)}], "
                                   f"got [{_fmt(observed)}]")
    for opcode in set(p1) | set(p2):
        d = p2.get(opcode, 0) - p1.get(opcode, 0)
        if d < 0 or d % dn:
            return ChainVerdict(op, opt_level, "transformed", cause="plumbing-nonlinear",
                                detail=f"{opcode} delta {d} over {dn} steps is not an "
                                       "integer per-step count")
    pc = ptx_path_counts(texts[1], carry)
    if pc is None:
        return ChainVerdict(op, opt_level, "unaudited", cause="carry-not-found",
                            detail=f"no unique global load through the carry's parameter "
                                   f"({dict(carry)}) in a kernel of the chain at len {n2}")
    want = {k: v * n2 for k, v in exp.counts.items()}
    if dict(pc) != want:
        return ChainVerdict(op, opt_level, "transformed", cause="hoisted",
                            detail=f"on-path counts [{_fmt(pc)}] != expected [{_fmt(want)}] "
                                   f"at len {n2}")
    if sass is not None and None not in sass:
        per = (sass_count(sass[1]) - sass_count(sass[0])) / dn
        if per < 1.0:
            return ChainVerdict(op, opt_level, "transformed", cause="dead-code-eliminated",
                                detail=f"ptxas: {per:g} SASS instructions a step")
    return ChainVerdict(op, opt_level, "ok", cause=exp.transform)


def sass_count(mnemonics: Mapping[str, int]) -> int:
    """Instructions in SASS mnemonic counts, less the NOPs that pad a
    function to its alignment (they shrink as the code grows)."""
    return sum(k for m, k in mnemonics.items() if m != "NOP")


def ptx_path_counts(text: str, carry: Mapping[str, str]) -> Counter | None:
    """Opcode counts on the dependent path of a Triton chain's PTX: from the
    load of its carry (``artifacts.carry_load`` through ``carry[kernel]``,
    the carry's parameter) to the store, summed over the module's
    functions; None when a function's carry load is not found."""
    counts = Counter()
    for name, body in artifacts.ptx_functions(text).items():
        instrs = artifacts.parse_ptx(body)
        src = artifacts.carry_load(instrs, carry[name]) if name in carry else None
        if src is None:
            return None
        counts += artifacts.dependent_path(instrs, src)
    return counts


def _audit_spec_aten(spec: OpSpec, opt_level: str, lens: tuple[int, int]) -> ChainVerdict:
    """O0 and O1: eager dispatch and AOTAutograd's graph run the ATen ops as
    traced, so integrity is checked on them: the chain's op delta must be
    exactly ``(n2-n1)`` x one step's ops (at O0 the dispatched ops, at O1
    the ops of the traced graph)."""
    from repro_torch.audit.transforms import classify

    n1, n2 = lens
    if opt_level == "O0":  # a K2 row's O0 step is one op_chain launch: one operator
        c1, c2 = (dispatched_ops(chain_fn(operator_form(spec), n), *_cpu_args(spec))
                  for n in (n1, n2))
    else:
        c1, c2 = (o1_graph_ops(spec, n) for n in (n1, n2))
    step = step_ops(spec)
    dn = n2 - n1
    observed = _delta(c2, c1)
    expected = {k: v * dn for k, v in step.items()}
    if observed != expected:
        cause = classify(Counter(expected), Counter({k: v for k, v in observed.items() if v > 0}))
        what = "dispatched ops" if opt_level == "O0" else "graph ops"
        return ChainVerdict(spec.name, opt_level, "transformed", cause=cause,
                            detail=f"{what} over lens {n1}->{n2}: expected "
                                   f"[{_fmt(expected)}], got [{_fmt(observed)}]")
    return ChainVerdict(spec.name, opt_level, "ok")


# --------------------------------------------------------- K2's loop form
def k2_struct(step: str) -> str:
    """A K2 step's struct as it appears, length first, in a mangled kernel
    name (``add.float32`` -> ``11AddFloat32E``)."""
    name = "".join(p[:1].upper() + p[1:] for p in step.split("."))
    return f"{len(name)}{name}E"


def k2_loop_paths(step: str) -> dict[int, Counter | None]:
    """The opcodes on the carry's dependent path in K2's loop form for
    ``step``, by unroll (1 and 32): from the load through the kernel's
    first parameter, ``x``, to the store; None for an instance whose carry
    load is not found."""
    out = {}
    for name, body in artifacts.library_ptx("op_chain").items():
        m = re.search(r"op_chain_kernelIN2k2" + re.escape(k2_struct(step)) + r"Li(\d+)E", name)
        if m:
            instrs = artifacts.parse_ptx(body)
            src = artifacts.carry_load(instrs, f"{name}_param_0")
            out[int(m.group(1))] = (None if src is None
                                    else artifacts.dependent_path(instrs, src))
    return out


def k2_loop_sass(step: str) -> dict[int, Counter]:
    """Each SASS mnemonic's count in K2's loop form for ``step``, by unroll."""
    out = {}
    for name, body in artifacts.library_sass("op_chain").items():
        m = re.search(r"op_chain_kernelIN2k2" + re.escape(k2_struct(step)) + r"Li(\d+)E", name)
        if m:
            out[int(m.group(1))] = Counter(artifacts.sass_mnemonics(body))
    return out


def _audit_kernel_row(spec: OpSpec, exp: ExpectedStep) -> ChainVerdict:
    """A K2 row at O3 (one launch of the loop form, 32 steps a trip): the
    unroll-32 instance less the unroll-1 instance holds 31 steps on the
    carry's dependent path (the loop's counter is off it), each the expected
    step; and a step runs at least one SASS instruction."""
    from repro_torch.audit.transforms import classify

    paths = k2_loop_paths(spec.kernel)
    if sorted(paths) != [1, 32]:
        return ChainVerdict(spec.name, "O3", "unaudited", cause="artifact-missing",
                            detail=f"K2's {spec.kernel} at unroll {sorted(paths)} in the PTX")
    if None in paths.values():
        return ChainVerdict(spec.name, "O3", "unaudited", cause="carry-not-found",
                            detail=f"no unique global load through K2's x in {spec.kernel}")
    observed = _delta(paths[32], paths[1])
    expected = {k: v * 31 for k, v in exp.counts.items()}
    if observed != expected:
        cause = classify(Counter(expected), Counter({k: v for k, v in observed.items() if v > 0}))
        return ChainVerdict(spec.name, "O3", "transformed", cause=cause,
                            detail=f"unroll 1->32, on the carry's path: expected "
                                   f"[{_fmt(expected)}], got [{_fmt(observed)}]")
    sass = k2_loop_sass(spec.kernel)
    per = (sass_count(sass[32]) - sass_count(sass[1])) / 31
    if per < 1.0:
        return ChainVerdict(spec.name, "O3", "transformed", cause="dead-code-eliminated",
                            detail=f"ptxas: {per:g} SASS instructions a step")
    return ChainVerdict(spec.name, "O3", "ok", cause=exp.transform)


# ----------------------------------------------- non-instruction artifacts
def audit_clock_overhead(opt_level: str) -> ChainVerdict:
    """The null timed region must contain zero countable ops: no op is
    dispatched at O0, and the graph Dynamo captures at O1 and O3 holds none
    (so no kernel is generated)."""
    x = torch.ones((), dtype=torch.float32)
    if opt_level == "O0":
        c = dispatched_ops(lambda v: v, x)
    else:
        captured: list[Counter] = []

        def backend(gm, example_inputs):
            from repro_torch.core.optlevels import graph_ops
            captured.append(graph_ops(gm))
            return gm.forward

        torch.compile(lambda v: v, backend=backend, fullgraph=True, dynamic=False)(x)
        c = sum(captured, Counter())
    if c:
        return ChainVerdict("clock_overhead", opt_level, "transformed",
                            cause="non-empty-null-region", detail=f"ops: {_fmt(c)}")
    return ChainVerdict("clock_overhead", opt_level, "ok")


def ptx_loops(body: str) -> list[list[artifacts.PtxInstr]]:
    """The loops of a PTX function: each label with a branch back to it
    before the next label, and the instructions between."""
    instrs = artifacts.parse_ptx(body)
    loops = []
    for i, ins in enumerate(instrs):
        if ins.opcode != "label":
            continue
        for j in range(i + 1, len(instrs)):
            if instrs[j].opcode == "label":
                break
            if instrs[j].opcode.startswith("bra") and instrs[j].operands == ins.param:
                loops.append(instrs[i + 1:j + 1])
                break
    return loops


def audit_chase(working_set_bytes: int, steps: tuple[int, int], line_bytes: int = 64, *,
                env: Mapping[str, str] | None = None, op: str | None = None) -> ChainVerdict:
    """Host pointer chase (``mem.chase.ws<N>``), K3's global loop form: each
    of its loops, trip-weighted (its body over the count it steps by), holds
    exactly one dependent load a step, an ``ld.global.ca`` whose address
    comes from the load before it; and the SASS loads by LDG."""
    op = op or f"mem.chase.ws{working_set_bytes}"
    missing = _no_device_code(op, "O3", env)
    if missing is not None:
        return missing
    bodies = [b for n, b in artifacts.library_ptx("chase").items()
              if "chase_kernelILb0ELb0ELi0E" in n]
    if len(bodies) != 1:
        return ChainVerdict(op, "O3", "unaudited", cause="artifact-missing",
                            detail=f"{len(bodies)} global untimed chase kernels in the PTX")
    loops = ptx_loops(bodies[0])
    per_step = []
    for loop in loops:
        loads = [i for i, ins in enumerate(loop) if ins.opcode.startswith("ld.global")]
        inc = _loop_step(loop)
        if not loads or inc is None:
            continue
        if any(not loop[i].opcode.startswith("ld.global.ca") for i in loads):
            return ChainVerdict(op, "O3", "transformed", cause="cache-operator",
                                detail="a chase load is not ld.global.ca")
        per_step.append(len(loads) / inc)
        if not _loads_chained(loop, loads):
            return ChainVerdict(op, "O3", "transformed", cause="hoisted",
                                detail="a chase load's address does not come from the "
                                       "load before it")
    if not per_step or any(p != 1.0 for p in per_step):
        cause = "hoisted" if any(p < 1.0 for p in per_step) else "duplicated-load"
        return ChainVerdict(op, "O3", "transformed", cause=cause,
                            detail=f"dependent loads a step by loop: {per_step} "
                                   f"(expected exactly 1)")
    sass = [b for n, b in artifacts.library_sass("chase").items()
            if "chase_kernelILb0ELb0ELi0E" in n]
    if not any(m.startswith("LDG") for b in sass for m in artifacts.sass_mnemonics(b)):
        return ChainVerdict(op, "O3", "transformed", cause="residency",
                            detail="no LDG in the global chase's SASS")
    return ChainVerdict(op, "O3", "ok",
                        detail=f"{len(per_step)} loops, one ld.global.ca a step each")


def _loop_step(loop: list[artifacts.PtxInstr]) -> int | None:
    """What a loop's counter steps by: the constant of the ``add`` that
    updates a register its back-edge compare reads."""
    setps = [ins for ins in loop if ins.opcode.startswith("setp")]
    if not setps:
        return None
    regs = set(setps[-1].srcs)
    for ins in loop:
        if ins.opcode.startswith("add.") and ins.dests and ins.dests[0] in regs:
            m = re.search(r",\s*(-?\d+)\s*$", ins.operands)
            if m:
                return abs(int(m.group(1)))
    return None


def _reaches(instrs: list[artifacts.PtxInstr], regs: set[str], target: artifacts.PtxInstr
             ) -> bool:
    """Whether values in ``regs`` flow through ``instrs`` into ``target``."""
    live = set(regs)
    for ins in instrs:
        if live & set(ins.srcs):
            live |= set(ins.dests)
    return bool(live & set(target.srcs))


def _loads_chained(loop: list[artifacts.PtxInstr], loads: list[int]) -> bool:
    """Each load's address depends on the load before it, the first on the
    last around the loop."""
    for a, b in zip(loads, loads[1:]):
        if not _reaches(loop[a + 1:b], set(loop[a].dests), loop[b]):
            return False
    last, first = loads[-1], loads[0]
    return _reaches(loop[last + 1:] + loop[:first], set(loop[last].dests), loop[first])


def audit_kernel(kernel_op: str, lens: tuple[int, int] = (8, 64), *,
                 env: Mapping[str, str] | None = None, op: str | None = None) -> ChainVerdict:
    """In-kernel ALU chain (``kernel.alu_chain.<op>``): K1's timed form
    opened by ``dataflow.audit_alu_kernel`` (``audited`` when its chain is
    one dependent path of ``n`` of the op's instructions)."""
    from repro_torch.audit import dataflow

    op = op or f"kernel.alu_chain.{kernel_op}"
    missing = _no_device_code(op, "O3", env)
    return missing or dataflow.audit_alu_kernel(kernel_op, "O3", op=op, lens=lens)


# ------------------------------------------------------------ dispatching
_MEM_RE = re.compile(r"^mem\.chase\.ws(\d+)(?:\.s(\d+)-(\d+))?(?:\.line(\d+))?$")
_KERNEL_RE = re.compile(
    r"^kernel\.alu_chain\.([a-z0-9]+)(?:\.l(\d+)-(\d+))?(?:\.t(\d+)x(\d+))?$")
_FUSED_RE = re.compile(r"^inkernel\.fused\.([a-z0-9_]+)(?:\.l(\d+)-(\d+))?$")
_INKERNEL_MEM_RE = re.compile(
    r"^inkernel\.mem\.(\d+)(?:\.l(\d+)-(\d+))?(?:\.line(\d+))?"
    r"(?:\.(smem|global|vmem|any))?$")
_INKERNEL_OP_RE = re.compile(
    r"^inkernel\.(.+?)(?:\.l(\d+)-(\d+))?(?:\.t(\d+)x(\d+))?$")


def _audit_kernel_row_family(op: str, opt_level: str, env: Mapping[str, str] | None,
                             registry: Iterable[OpSpec] | None) -> ChainVerdict:
    """Route an ``inkernel.*`` row to the dataflow auditor: K2's or K3's
    timed form opened and certified, a fused row's signature and residency
    (``dataflow.audit_fused``)."""
    from repro_torch.audit import dataflow

    m = _FUSED_RE.match(op)
    if m:
        lens = (int(m.group(2)), int(m.group(3))) if m.group(2) else None
        return dataflow.audit_fused(m.group(1), opt_level, op=op, lens=lens, env=env)
    missing = _no_device_code(op, opt_level, env)
    if missing is not None:
        return missing
    m = _INKERNEL_MEM_RE.match(op)
    if m:
        lens = (int(m.group(2)), int(m.group(3))) if m.group(2) else None
        space = {"vmem": "smem", "any": "global"}.get(m.group(5), m.group(5))
        return dataflow.audit_inkernel_mem(int(m.group(1)), opt_level, op=op, space=space,
                                           lens=lens)
    m = _INKERNEL_OP_RE.match(op)
    if m:
        specs = list(registry) if registry is not None else default_registry()
        spec = next((s for s in specs if s.name == m.group(1)), None)
        if spec is not None:
            lens = (int(m.group(2)), int(m.group(3))) if m.group(2) else None
            return dataflow.audit_inkernel_op(spec, opt_level, op=op, lens=lens)
    return ChainVerdict(op, opt_level, "unaudited", cause="unknown-kernel",
                        detail="no registry spec or builder for this row")


def audit_target(op: str, opt_level: str, *, env: Mapping[str, str] | None = None,
                 registry: Iterable[OpSpec] | None = None, cache=None) -> ChainVerdict:
    """Audit whatever artifact the record row ``op@opt_level`` was measured
    from. Rows no static checker covers come back ``unaudited`` with a
    reason, never silently ``ok``. ``env`` is the environment the row was
    measured in (its backend decides whether device code exists); ``cache``
    a compile cache whose entries hold the O3 chains' device code."""
    if op == "clock_overhead":
        return audit_clock_overhead(opt_level)
    m = _MEM_RE.match(op)
    if m:
        steps = (int(m.group(2)), int(m.group(3))) if m.group(2) else (2048, 6144)
        line = int(m.group(4)) if m.group(4) else 64
        return audit_chase(int(m.group(1)), steps, line, env=env, op=op)
    m = _KERNEL_RE.match(op)
    if m:
        lens = (int(m.group(2)), int(m.group(3))) if m.group(2) else (8, 64)
        return audit_kernel(m.group(1), lens, env=env, op=op)
    if op.startswith("coll."):
        return ChainVerdict(op, opt_level, "unaudited", cause="collectives-not-ported",
                            detail="the collective ladders are not ported yet")
    if op.startswith(("serving.", "slo.")):
        return ChainVerdict(op, opt_level, "unaudited", cause="consumer-row",
                            detail="predicted-vs-measured consumer record; "
                                   "integrity rides on the rows it prices")
    if op.startswith("inkernel."):
        return _audit_kernel_row_family(op, opt_level, env, registry)
    specs = list(registry) if registry is not None else default_registry()
    spec = next((s for s in specs if s.name == op), None)
    if spec is not None:
        return audit_spec(spec, opt_level, env=env, cache=cache)
    return ChainVerdict(op, opt_level, "unaudited", cause="unknown-family")
