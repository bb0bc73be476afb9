"""The audit slice on the CPU: O1, the static audit (``repro_torch.audit``)
and its LatencyDB methods, held against the JAX package on the same inputs.

What runs here: the cause taxonomy and the verdict tokens against the JAX
package's, the LatencyDB's audit methods on the same records, the O0
verdicts of all 72 rows against the JAX package's jaxpr audit, every row's
O1 chain against its O0 chain and the JAX package's O1 chain, the guard
lint, the CLI and ``Session(audit=True)``, and the PTX and SASS readers on
short texts written here (there is no device code on the CPU: an O3
verdict here is ``unaudited:no-device-code``). Chains are cut to test
lengths by monkeypatching ``measure._CHAIN_LENS`` (O1 and O3 to (4, 8)).

Tolerances: O1 chains bit for bit against the port's O0 chain; against the
JAX package's O1 chain bit for bit, but within ``ULPS`` = 2 units in the
last place for the transcendental and reciprocal rows (as
``test_torch_table2.py``) and for the rows ``XLA_ROUNDS_OTHERWISE`` names.
The 64-bit rows take JAX's x64 switch as ``test_torch_table2.py`` does.
"""
import contextlib
import dataclasses
import io
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from repro.audit import chain_check as jax_chain_check
from repro.audit import transforms as jax_transforms
from repro.core import chains as jax_chains
from repro.core import latency_db as jax_latency_db
from repro.core import measure as jax_measure
from repro.core import optlevels as jax_optlevels
from repro_torch.api.cli import main as cli_main
from repro_torch.api.plan import QUICK_OPS, Plan
from repro_torch.api.probes import InstructionProbe
from repro_torch.api.session import Session
from repro_torch.audit import artifacts, audit_db, audit_spec, audit_target, classify, dataflow
from repro_torch.audit.chain_check import (GUARDS, ChainVerdict, _verdict_from_note,
                                           expected_step, judge_ptx)
from repro_torch.audit.lint import lint_guard_identity, run_lints
from repro_torch.audit.transforms import CAUSES
from repro_torch.core import chains, measure, optlevels
from repro_torch.core.latency_db import LatencyDB, LatencyRecord
from repro_torch.core.timing import Timer
from repro_torch.utils import parse_kv_notes

ULPS = 2
ULP_ROWS = ("sin", "cos", "lg2", "ex2", "tanh", "rsqrt", "rcp")
NAMES = [s.name for s in jax_chains.default_registry()]
JAX_ROWS = {s.name: s for s in jax_chains.default_registry()}
TEST_LENS = (4, 8)


def _x64(spec):
    """JAX's x64 switch for a 64-bit row, whichever this jax has."""
    if not (spec.requires_x64 or spec.dtype in ("int64", "uint64", "float64")):
        return contextlib.nullcontext()
    switch = getattr(jax, "enable_x64", None)
    return switch(True) if switch is not None else jax.experimental.enable_x64()


@pytest.fixture
def jax_x64(monkeypatch):
    """The JAX package's own x64 switch (``jax.experimental.enable_x64``,
    which this jax lacks) replaced by the one it has."""
    monkeypatch.setattr(jax_measure, "_x64_ctx", _x64)


@pytest.fixture
def short(monkeypatch):
    monkeypatch.setitem(measure._CHAIN_LENS, "O1", TEST_LENS)
    monkeypatch.setitem(measure._CHAIN_LENS, "O3", TEST_LENS)


def _record(op="add", opt_level="O3", notes="", **over):
    base = dict(op=op, category="int_arith", dtype="int32", opt_level=opt_level,
                latency_ns=10.0, mad_ns=0.1, cycles=30.0, guard=1, net_latency_ns=5.0,
                device_kind="TestDev", backend="cpu", jax_version="0.0.test", n_samples=3,
                measured_at="2026-08-09T00:00:00", notes=notes)
    base.update(over)
    return base


# ----------------------------------------------------------- the taxonomy
CLASSIFY_CASES = [
    (Counter(), Counter()),                                        # unknown
    (Counter({"divide": 4}), Counter()),                           # folded
    (Counter({"divide": 4}), Counter({"shift-right-logical": 4})),  # strength
    (Counter({"add": 4, "abs": 4}), Counter({"add": 4})),           # algebraic
    (Counter({"add": 4}), Counter({"add": 8})),                     # rematerialized
    (Counter({"add": 4}), Counter({"add": 4})),                     # unknown (equal)
    (Counter({"add": 4, "xor": 4}), Counter({"xor": 4, "mad": 4})),  # strength
]


@pytest.mark.parametrize("expected,observed", CLASSIFY_CASES)
def test_classify_gives_the_jax_cause_on_the_same_counters(expected, observed):
    assert classify(expected, observed) == jax_transforms.classify(expected, observed)
    assert classify(expected, observed) in CAUSES


def test_causes_are_the_jax_taxonomy():
    assert CAUSES == jax_transforms.CAUSES


def _module(steps_n: list[str], store: str, carry: int = 0) -> str:
    """A PTX module shaped like a Triton chain: three loaded parameters, each
    into ``%r<i + 1>`` in parameter order (the carry's is parameter
    ``carry``), the step lines, a store of ``store`` through parameter 3."""
    loads = "".join(f"\tld.param.u64 %rd{i + 1}, [k_param_{i}];\n"
                    f"\tld.global.b32 %r{i + 1}, [ %rd{i + 1} + 0 ];\n" for i in range(3))
    return (".visible .entry k(\n\t.param .u64 k_param_0,\n\t.param .u64 k_param_1,\n"
            "\t.param .u64 k_param_2,\n\t.param .u64 k_param_3\n)\n{\n\t.reg .b32 %r<99>;\n"
            + loads + "\tld.param.u64 %rd4, [k_param_3];\n" + "".join(f"\t{s};\n" for s in steps_n)
            + f"\tst.global.b32 [ %rd4 + 0 ], {{ {store} }};\n\tret;\n}}\n")


CARRY = {"k": "k_param_0"}  # the carry's parameter in _module's kernel


def _add_chain(n: int, hoist: bool = False, cvts: int = 0, carry: int = 0) -> str:
    """The ``add`` row's chain, (x + a) ^ b, n steps, its carry loaded from
    parameter ``carry`` and a, b from the other two in order; ``hoist``:
    each step's add reads a value computed from the operands alone (off the
    path); ``cvts``: that many conversions."""
    x, a, b = (f"%r{i + 1}" for i in (carry, *(j for j in range(3) if j != carry)))
    lines = []
    for i in range(n):
        t, y = f"%r{10 + 2 * i}", f"%r{11 + 2 * i}"
        if hoist:
            lines += [f"add.s32 {t}, {a}, {b}", f"xor.b32 {y}, {x}, {t}"]
        else:
            lines += [f"add.s32 {t}, {a}, {x}", f"xor.b32 {y}, {t}, {b}"]
        x = y
    lines += [f"cvt.u32.u16 %r{90 + i}, %rs1" for i in range(cvts)]
    return _module(lines, x, carry)


@pytest.mark.parametrize("texts,status,cause", [
    ((_add_chain(2), _add_chain(4)), "ok", ""),
    ((_module([], "%r1"), _module([], "%r1")), "transformed", "dead-code-eliminated"),
    ((_module(["mov.u32 %r9, 7"], "%r9"),) * 2, "transformed", "folded-to-constant"),
    ((_add_chain(2, hoist=True), _add_chain(4, hoist=True)), "transformed", "hoisted"),
    ((_add_chain(2, cvts=1), _add_chain(4, cvts=2)), "transformed", "plumbing-nonlinear"),
    ((_add_chain(2, cvts=2), _add_chain(4, cvts=4)), "ok", ""),
])
def test_ptx_judge_on_short_texts(texts, status, cause):
    """The O3 judge on PTX written here: a sound chain, a chain with its
    steps removed (the store still reads the carry), one folded to a
    constant, one whose add is off the carry's path, and conversions that do
    not scale with the length (and ones that do)."""
    exp = expected_step(chains.spec_by_name("add"), "O3")
    v = judge_ptx("add", exp, list(texts), (2, 4), carry=CARRY)
    assert (v.status, v.cause) == (status, cause), v
    assert v.cause == "" or v.cause in CAUSES


@pytest.mark.parametrize("hoist,status,cause", [(False, "ok", ""),
                                                (True, "transformed", "hoisted")])
def test_ptx_judge_finds_the_carry_by_its_parameter(hoist, status, cause):
    """The carry is the last of the three loads: the walk starts from the
    load through its parameter, not from the first load (an operand that
    feeds every step, off which a hoisted add would pass for sound)."""
    exp = expected_step(chains.spec_by_name("add"), "O3")
    texts = [_add_chain(n, hoist=hoist, carry=2) for n in (2, 4)]
    v = judge_ptx("add", exp, texts, (2, 4), carry={"k": "k_param_2"})
    assert (v.status, v.cause) == (status, cause), v


# the launch lines of a wrapper Inductor generated for a 64-step chain (the
# output buffer is the kernel's first pointer) and of a second kernel that
# the carry reaches only through a buffer
WRAPPER = """
def call(self, args):
        arg0_1, arg1_1, arg2_1 = args
        buf0 = empty_strided_cuda((), (), torch.int32)
        buf1 = buf0; del buf0  # reuse
        triton_poi_fused_add_bitwise_xor_0.run(buf1, arg0_1, arg1_1, arg2_1, 1, stream=stream0)
        triton_poi_fused_add_bitwise_xor_1.run(buf2, buf1, arg1_1, arg2_1, 1, stream=stream0)
"""
SIGNATURE = {"in_out_ptr0": "*i32", "in_ptr0": "*i32", "in_ptr1": "*i32", "in_ptr2": "*i32",
             "xnumel": "constexpr", "XBLOCK": "constexpr"}


def test_carry_parameter_is_the_one_the_wrapper_passes_the_carry():
    """The carry's PTX parameter is where the wrapper passes the chain's
    first input: the second pointer here, after the output; a kernel the
    carry reaches only through a buffer gets none."""
    sigs = {"triton_poi_fused_add_bitwise_xor_0": SIGNATURE,
            "triton_poi_fused_add_bitwise_xor_1": SIGNATURE}
    assert artifacts.carry_params_of(WRAPPER, sigs) == {
        "triton_poi_fused_add_bitwise_xor_0": "triton_poi_fused_add_bitwise_xor_0_param_1"}
    # a compile-time constant before the carry holds no PTX parameter
    assert artifacts.carry_params_of("k.run(buf1, 7, arg0_1, stream=stream0)", {
        "k": {"in_out_ptr0": "*i32", "K": "constexpr", "in_ptr0": "*i32"}}) == {"k": "k_param_1"}


@pytest.mark.parametrize("carry", [{"k": "k_param_3"}, {"k": "k_param_9"}, {}])
def test_ptx_judge_without_a_unique_carry_load_is_unaudited(carry):
    """No global load through the carry's parameter (parameter 3 is only
    stored through; parameter 9 is never read; no parameter named): never
    ok."""
    exp = expected_step(chains.spec_by_name("add"), "O3")
    v = judge_ptx("add", exp, [_add_chain(2), _add_chain(4)], (2, 4), carry=carry)
    assert (v.status, v.cause) == ("unaudited", "carry-not-found"), v


def test_ptx_judge_sass_cross_check():
    """A step that holds fewer than one SASS instruction is never ok."""
    exp = expected_step(chains.spec_by_name("add"), "O3")
    texts = [_add_chain(2), _add_chain(4)]
    assert judge_ptx("add", exp, texts, (2, 4), carry=CARRY,
                     sass=[{"IADD3": 6, "NOP": 4}, {"IADD3": 10, "NOP": 0}]).ok
    v = judge_ptx("add", exp, texts, (2, 4), carry=CARRY,
                  sass=[{"LOP3.LUT": 6}, {"LOP3.LUT": 7}])
    assert (v.status, v.cause) == ("transformed", "dead-code-eliminated")


def test_guard_mismatch_caught():
    wrong = dataclasses.replace(chains.spec_by_name("add"), guard=3)
    v = audit_spec(wrong, "O3")
    assert (v.status, v.cause) == ("transformed", "guard-mismatch"), v


# --------------------------------------------------------------- SASS
SASS = """
        code for sm_90a
                Function : _Z5chainPfS_
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                         /* 0x000fe20000000800 */
        /*0010*/                   LDG.E R2, desc[UR4][R6.64] ;          /* 0x0000000406027981 */
        /*0020*/                   CS2R R4, SR_CLOCKLO ;                 /* 0x0000000000047805 */
        /*0030*/                   FFMA R3, R2, R3, R8 ;                 /* 0x0000000302037223 */
        /*0040*/                   FFMA R3, R2, R3, R8 ;                 /* 0x0000000302037223 */
        /*0050*/                   FFMA R9, R2, R8, R8 ;                 /* 0x0000000802097223 */
        /*0060*/                   CS2R R10, SR_CLOCKLO ;                /* 0x00000000000a7805 */
        /*0070*/                   ISETP.NE.AND P0, PT, R3, RZ, PT ;     /* 0x000000ff0300720c */
        /*0080*/              @!P0 IMAD.WIDE.U32 R6, R3, 0x4, R6 ;       /* 0x0000000403068825 */
        /*0090*/                   STG.E desc[UR4][R6.64], R3 ;          /* 0x0000000306007986 */
        /*00a0*/                   EXIT ;                                /* 0x000000000000794d */
        /*00b0*/                   BRA 0xb0;                             /* 0xfffffffc00fc7947 */
"""


def test_sass_reader_on_a_cuobjdump_excerpt():
    funcs = artifacts.sass_functions_of(SASS)
    assert list(funcs) == ["_Z5chainPfS_"]
    body = funcs["_Z5chainPfS_"]
    assert artifacts.sass_mnemonics(body) == [
        "LDC", "LDG.E", "CS2R", "FFMA", "FFMA", "FFMA", "CS2R", "ISETP.NE.AND",
        "IMAD.WIDE.U32", "STG.E", "EXIT", "BRA"]
    ins = artifacts.parse_sass(body)
    assert (ins[1].dests, ins[1].srcs) == (("R2",), ("UR4", "R6", "R7"))
    assert (ins[3].dests, ins[3].srcs) == (("R3",), ("R2", "R3", "R8"))
    assert ins[7].dests == ("P0",) and ins[7].srcs == ("R3",)
    assert ins[8].dests == ("R6", "R7") and ins[8].srcs == ("P0", "R3", "R6", "R7")
    assert ins[9].dests == () and ins[9].srcs == ("UR4", "R6", "R7", "R3")
    cert = dataflow.region_cert(body)
    # the two dependent FFMAs make the path; the third reads no carry
    assert (cert.mnemonics["FFMA"], cert.depth, cert.branches, cert.reads) == (3, 2, 0, (2, 6))


def test_ptx_reader_splits_functions_and_reads_registers():
    text = _add_chain(2)
    (name, body), = artifacts.ptx_functions(text).items()
    instrs = artifacts.parse_ptx(body)
    assert name == "k" and artifacts.carry_load(instrs, "k_param_0") == 1
    assert artifacts.carry_load(instrs, "k_param_2") == 5
    assert artifacts.carry_load(instrs, "k_param_3") is None  # only stored through
    assert instrs[1].opcode == "ld.global.b32" and instrs[1].dests == ("%r1",)
    assert artifacts.ptx_histogram(text)[0] == Counter({"add.s32": 2, "xor.b32": 2})
    assert artifacts.ptx_op("fma.rn.ftz.f32") == "fma.f32"
    assert artifacts.ptx_op("setp.lt.f32") == "setp.f32"
    assert artifacts.ptx_op("rsqrt.approx.ftz.f32") == "rsqrt.approx.f32"


# ------------------------------------------------------------ verdict notes
VERDICTS = [("ok", ""), ("ok", "strength-reduction"), ("audited", ""),
            ("opaque", "custom-call"), ("unaudited", "no-device-code"),
            ("unaudited", "environment-mismatch")] + [("transformed", c) for c in CAUSES]


@pytest.mark.parametrize("status,cause", VERDICTS)
def test_verdict_note_roundtrip_matches_jax(status, cause):
    ours = ChainVerdict("add", "O3", status, cause)
    theirs = jax_chain_check.ChainVerdict("add", "O3", status, cause)
    assert ours.note() == theirs.note()
    assert (ours.ok, ours.failed) == (theirs.ok, theirs.failed)
    for parse, verdict in ((_verdict_from_note, ours),
                           (jax_chain_check._verdict_from_note, theirs)):
        back = parse("add", "O3", f"reps_eff=3 {verdict.note()} clock=events")
        assert (back.status, back.cause) == (status, cause)


# ------------------------------------------------------------ LatencyDB
def _both(*raws):
    ours, theirs = LatencyDB(), jax_latency_db.LatencyDB()
    for raw in raws:
        ours.add(LatencyRecord(**raw))
        theirs.add(jax_latency_db.LatencyRecord(**raw))
    return ours, theirs


def test_latency_db_audit_methods_match_jax():
    raws = [_record("add", notes="audit=ok"), _record("mul", notes="audit=transformed:hoisted"),
            _record("popc", notes="reps_eff=4"),
            _record("div.s.regular", notes="audit=ok audit_transform=strength-reduction"),
            _record("mem.chase.ws65536", opt_level="O3", notes="audit=ok"),
            _record("add", opt_level="O0", latency_ns=2000.0, jax_version="v1",
                    measured_at="2026-08-09T00:00:01"),
            _record("add", opt_level="O0", latency_ns=2500.0, jax_version="v2",
                    measured_at="2026-08-09T00:00:02"),
            _record("mul", opt_level="O0", latency_ns=2000.0, jax_version="v1"),
            _record("mul", opt_level="O0", latency_ns=2100.0, jax_version="v2")]
    ours, theirs = _both(*raws)
    assert ours.audit_markdown() == theirs.audit_markdown()
    assert ({k: [r.op for r in v] for k, v in ours.audit_status().items()}
            == {k: [r.op for r in v] for k, v in theirs.audit_status().items()})
    for filters in ({"op": "add"}, {"opt_level": "O0"}, {"op": "mul", "jax_version": "v2"}):
        assert ([dataclasses.asdict(r) for r in ours.query(**filters)]
                == [dataclasses.asdict(r) for r in theirs.query(**filters)])
    for args, kw in ((("add", "O0"), {}), (("add",), {}), (("nope",), {"default": 1.5}),
                     (("mul", "O0"), {"jax_version": "v1"})):
        assert ours.lookup_ns(*args, **kw) == theirs.lookup_ns(*args, **kw)
    for level in ("O0", "O3"):
        for thr in (0.10, 0.01):
            assert (ours.diff_markdown("v1", "v2", opt_level=level, rel_threshold=thr)
                    == theirs.diff_markdown("v1", "v2", opt_level=level, rel_threshold=thr))
    key = tuple(_record("popc").values())  # not a key: annotate of an absent key
    assert ours.annotate(key[:6], audit="ok") is None
    rec = LatencyRecord(**_record("popc", notes="reps_eff=4"))
    for db in (ours, theirs):
        db.annotate(rec.key(), audit="transformed:folded-to-constant")
        db.annotate(rec.key(), audit="ok", audit_transform="strength-reduction")
    assert ours.get(rec.key()).notes == theirs.get(rec.key()).notes \
        == "reps_eff=4 audit=ok audit_transform=strength-reduction"
    assert ours.audit_markdown() == theirs.audit_markdown()


# ---------------------------------------------------------- O0 and O1
@pytest.mark.parametrize("name", NAMES)
def test_o0_verdict_matches_jax_audit(name, jax_x64):
    """Every row's O0 verdict is the JAX package's (``audit_spec(spec,
    "O0")`` on its jaxpr): the dispatched ops of the chain at (2, 10) are
    8 steps' ops."""
    ours = audit_spec(chains.spec_by_name(name), "O0")
    theirs = jax_chain_check.audit_spec(JAX_ROWS[name], "O0")
    assert (ours.status, ours.cause) == (theirs.status, theirs.cause) == ("ok", ""), ours


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    ints = {2: np.int16, 4: np.int32, 8: np.int64}[want.dtype.itemsize]
    return int(np.max(np.abs(got.view(ints).astype(np.int64) - want.view(ints).astype(np.int64))))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.reshape(1).view(torch.uint8).numpy()


# rows whose XLA-compiled chain rounds otherwise than op by op: XLA divides
# by a constant through its reciprocal (div.irregular.float32, x / 3 + a:
# fma(x, rn(1/3), a); ROADMAP Queue 3), held to ULPS
XLA_ROUNDS_OTHERWISE = ("div.irregular.float32", "div.irregular.float64")


@pytest.mark.parametrize("name", NAMES)
def test_o1_chain_equals_o0_and_jax_o1(name, short):
    """Each row's O1 chain (aot_eager) equals its eager chain bit for bit,
    and the JAX package's O1 chain, at both test lengths; its graph holds
    n steps' ATen ops, which the O1 audit checks."""
    spec, j = chains.spec_by_name(name), JAX_ROWS[name]
    args = (spec.carry("cpu"), *spec.operand_tensors("cpu"))
    for n in TEST_LENS:
        got = measure.compile_chain(spec, n, "O1", "cpu")(*args)
        eager = chains.chain_fn(spec, n)(*args)
        assert _bits(got).tobytes() == _bits(eager).tobytes(), (name, n)
        with _x64(j):
            jargs = (j.carry(), *j.operand_arrays())
            want = np.asarray(jax_optlevels.compile_at_level(
                jax_chains.chain_fn(j, n), "O1", *jargs)(*jargs))
        mine = got.reshape(1).numpy() if got.dtype != torch.bfloat16 else \
            got.reshape(1).view(torch.int16).numpy().view(want.dtype)
        if name in ULP_ROWS or name in XLA_ROUNDS_OTHERWISE:
            assert _ulps(mine, want.reshape(1)) <= ULPS, (name, n, mine, want)
        else:
            assert mine.tobytes() == want.reshape(1).tobytes(), (name, n, mine, want)
        assert optlevels.O1_GRAPHS[measure.chain_name(name, n)] == Counter(
            {k: v * n for k, v in Counter(
                op for op, _, _ in _traced(spec)).items()}), name
    assert audit_spec(spec, "O1").ok


def _traced(spec):
    from repro_torch.audit.chain_check import traced_ops
    return traced_ops(chains.operator_form(spec).step, spec.carry("cpu"),
                      *spec.operand_tensors("cpu"))


def test_o1_option_string_and_levels():
    assert optlevels.OPT_LEVELS == jax_optlevels.OPT_LEVELS == ("O0", "O1", "O3")
    assert optlevels.o1_option_string() == "backend:aot_eager,fullgraph:True,dynamic:False"
    assert measure._CHAIN_LENS["O1"] == jax_measure._CHAIN_LENS["O1"]
    assert measure._REPS["O1"] == jax_measure._REPS["O1"]
    assert [p.opt_level for p in Plan.clock_overhead()] == ["O0", "O1", "O3"]


def test_clock_overhead_null_region_at_every_level():
    for level in ("O0", "O1", "O3"):
        assert audit_target("clock_overhead", level).status == "ok"
        assert jax_chain_check.audit_clock_overhead(level).status == "ok"


# ------------------------------------------------------------------ lints
def test_guard_lint_clean_on_the_registry():
    assert lint_guard_identity() == []


def test_lint_catches_guard_mismatch(monkeypatch):
    monkeypatch.setitem(GUARDS, "popc", ("xor", "xor"))
    findings = lint_guard_identity()
    assert any(f.subject == "popc" for f in findings)


def test_lints_not_ported_raise():
    """No lint is left unported: the dataflow lint, which raised until the
    fused half of the dataflow audit was ported, runs (clean on the CPU,
    where the kernels' device code is skipped)."""
    assert run_lints(dataflow=True) == []


# -------------------------------------------------------- CLI and session
def test_cli_strict_exit_code(tmp_path):
    db_path = str(tmp_path / "db.json")
    db = LatencyDB(path=db_path)
    db.add(LatencyRecord(**_record("add", notes="audit=transformed:folded-to-constant")))
    db.save()
    # existing verdicts are kept without re-deriving (foreign env here), so
    # the failed verdict drives the exit code
    assert cli_main(["audit", "--db", db_path, "--strict"]) == 1
    assert cli_main(["audit", "--db", db_path]) == 0


def test_cli_missing_db_is_usage_error(tmp_path):
    assert cli_main(["audit", "--db", str(tmp_path / "nope.json")]) == 2


def test_cli_lint_only_without_db(tmp_path):
    assert cli_main(["audit", "--db", str(tmp_path / "nope.json"), "--lint"]) == 0


@pytest.mark.parametrize("flag", ["--dataflow", "--compile-cache=x"])
def test_cli_not_ported_flags_exit_2(flag, capsys, tmp_path, monkeypatch):
    """The two flags that exited 2 as not ported are ported now: the lints
    run with them and exit 0."""
    monkeypatch.chdir(tmp_path)  # --compile-cache=x makes its directory here
    assert cli_main(["audit", "--lint", *flag.split("=", 1)[:1],
                     *flag.split("=", 1)[1:]]) == 0
    out, err = capsys.readouterr()
    assert "not ported yet" not in err and "lints clean" in out


def test_cli_attribution_writes_table(tmp_path, short):
    out = str(tmp_path / "attr.md")
    rc = cli_main(["audit", "--lint", "--attribution", out, "--attribution-ops", "add,popc"])
    assert rc == 0
    text = open(out).read()
    assert "| `add` |" in text and "| `popc` |" in text and "O0 -> O1 -> O3" in text
    assert "popc.b32 x1, xor.b32 x1" in text and "(no device code)" in text


def test_audit_db_skips_foreign_env_and_keeps_existing():
    db = LatencyDB()
    db.add(LatencyRecord(**_record("mul", notes="audit=ok")))
    db.add(LatencyRecord(**_record("popc")))
    env = {"device_kind": "Other", "backend": "cpu", "jax_version": "9.9"}
    by_op = {v.op: v for v in audit_db(db, env=env)}
    assert by_op["mul"].status == "ok"
    assert (by_op["popc"].status, by_op["popc"].cause) == ("unaudited", "environment-mismatch")
    assert "audit=" not in db.get(LatencyRecord(**_record("popc")).key()).notes


def test_session_audit_attaches_notes_and_cli_audits_a_cpu_db(tmp_path, short, capsys):
    """``Session(audit=True)`` on the CPU: O0 and O1 verdicts ``ok`` (the
    strength reduction of div.s.regular is an O3 transform), O3
    ``unaudited:no-device-code`` (popc: K2's plain chain, whose steps the
    host clock resolves); an O1 record states O1's settings; then
    ``audit --db --lint --lowering --strict`` on that DB keeps them and
    exits 0."""
    db_path = str(tmp_path / "db.json")
    plan = Plan(name="t", probes=tuple(
        InstructionProbe(chains.spec_by_name(n), lv) for n in ("add", "div.s.regular", "popc")
        for lv in ("O0", "O1", "O3") if lv != "O3" or n == "popc")) + Plan.clock_overhead()
    result = Session(db=db_path, device="cpu", timer=Timer(warmup=0, reps=2, device="cpu"),
                     audit=True).run(plan)
    assert not result.failed, [r.failure for r in result.failed]
    for r in result.results:
        kv = parse_kv_notes(r.record.notes)
        want = "unaudited:no-device-code" if r.probe.opt_level == "O3" and \
            r.probe.op != "clock_overhead" else "ok"
        assert kv["audit"] == want, (r.probe, kv)
        assert ("o1" in kv) == (r.probe.opt_level == "O1"), kv
    capsys.readouterr()
    assert cli_main(["audit", "--db", db_path, "--lint", "--lowering", "--strict"]) == 0
    out = capsys.readouterr().out
    assert "lints clean (mapping+guards+lowering)" in out
    assert "audited 10 record(s): ok=9, unaudited=1" in out


def test_failure_message_carries_the_verdict(tmp_path, monkeypatch):
    """A probe that fails after it was judged keeps the verdict in its
    failure's message: the DB tells a folded row from a failed one."""
    def boom(self, ctx, prepared):
        raise RuntimeError("slope")

    monkeypatch.setattr(InstructionProbe, "run_prepared", boom)
    plan = Plan(name="t", probes=(InstructionProbe(chains.spec_by_name("add"), "O0"),))
    result = Session(device="cpu", timer=Timer(warmup=0, reps=1, device="cpu"),
                     audit=True).run(plan)
    assert result.failed[0].failure.message == "slope [audit=ok]"


def test_worker_result_is_filed_by_its_chain_name(monkeypatch):
    """A warm task's result names its chain; the session files the device
    code a worker read under that name, whatever the task's arguments."""
    import concurrent.futures

    result = measure.warm_chain("add", "O1", 4, "cpu")
    assert result["chain"] == measure.chain_name("add", 4) == "chain_add_4"
    monkeypatch.setattr(artifacts, "_CHAINS", {})
    fut = concurrent.futures.Future()
    fut.set_result({**result, "ptx": ["// k"], "carry": {}, "sass": {}, "cubins": 1})
    Session._log_warm(InstructionProbe(chains.spec_by_name("add"), "O3"), fut)
    assert artifacts.chain_artifacts("chain_add_4")["ptx"] == ["// k"]
    assert artifacts.chain_artifacts("chain_add_8") is None


def test_launch_counts_add_and_take_back():
    """The counts a CUDA graph's replay adds (``kernels.ops.add_launches``)
    and takes back after its capture, by wrapper and by K3's form and path."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chase import chase

    before = ops.launch_counts()
    delta = {"op_chain": 37, "chase": 2, "chase/timed/smem": 2}
    try:
        ops.add_launches(delta)
        assert ops.launches_since(before) == delta
        ops.add_launches({k: -n for k, n in delta.items()})
        assert ops.launches_since(before) == {} and ops.launch_counts() == before
    finally:
        for k in ops.COUNTED:
            k.launches = before[k.__name__]
        chase.launches_by_path.clear()
        chase.launches_by_path.update({k.removeprefix("chase/"): n for k, n in before.items()
                                       if k.startswith("chase/")})


def test_quick_ops_rows_have_ptx_mappings():
    """Every QUICK_OPS row's step maps into PTX (the attribution's
    vocabulary), libdevice sequences named as such."""
    for name in QUICK_OPS:
        exp = expected_step(chains.spec_by_name(name), "O3")
        assert not exp.unknown, (name, exp.unknown)
        assert exp.library == (name == "sin"), name


def test_attribution_rows_on_the_cpu_name_no_o3(short):
    from repro_torch.audit.transforms import attribution_rows

    (row,) = attribution_rows(["div.s.regular"])
    assert row["o0"] == row["o1"] == {"div.s32": 1.0, "add.s32": 1.0}
    assert row["o3"] is None and row["stage_o0_o1"] == "none"
    assert row["declared"] == "strength-reduction (LLVM)"
    buf = io.StringIO()
    from repro_torch.audit import write_attribution
    assert write_attribution(buf, ["div.s.regular"]) == 1
