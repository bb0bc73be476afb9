"""The ``table2`` slice on the CPU: the 72-row registry, each row's chain,
K2's uint32 divides and high multiply, the half-precision rows' O3 chains
and ``characterize --plan table2``, held against the JAX package on the
same inputs.

Tolerances: integer, uint32 and 64-bit rows bit-exact, and float rows whose
steps round correctly (add, sub, mul, fma, min, max, the divides, sqrt,
copysign, in every float dtype); within ``ULPS`` = 2 units in the last
place for the rows whose step is a transcendental or reciprocal function
(sin, cos, lg2, ex2, tanh, rsqrt, rcp): neither library rounds those
correctly, and each step contracts the error, so it does not grow with n.

The 64-bit rows need JAX's x64 switch, else JAX quietly computes them in
32 bits. jax 0.9.0 has ``jax.enable_x64`` and no
``jax.experimental.enable_x64``; older releases only the second.

No 512-op chain is compiled here: the O3 chains run at n 64 at most.
"""
import contextlib
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.api import plan as jax_plan
from repro.core import chains as jax_chains
from repro.kernels.opchain import op_chain as jax_op_chain
from repro_torch.api import cli
from repro_torch.api import plan as torch_plan
from repro_torch.core import chains, measure
from repro_torch.core.latency_db import LatencyDB
from repro_torch.kernels import opchain
from repro_torch.kernels.opchain import op_chain
from repro_torch.utils import from_numpy

ULPS = 2
ULP_ROWS = ("sin", "cos", "lg2", "ex2", "tanh", "rsqrt", "rcp")
JAX_REG = jax_chains.default_registry()
JAX_ROWS = {s.name: s for s in JAX_REG}
NAMES = [s.name for s in JAX_REG]
NEW_STEPS = ("div.u.regular", "div.u.irregular", "div.u.runtime", "rem.u", "mul64hi")
HALF_ROWS = [s.name for s in JAX_REG if s.dtype in ("bfloat16", "float16")]


def _x64(spec):
    """JAX's x64 switch for a 64-bit row, whichever this jax has."""
    if not (spec.requires_x64 or spec.dtype in ("int64", "uint64", "float64")):
        return contextlib.nullcontext()
    switch = getattr(jax, "enable_x64", None)
    return switch(True) if switch is not None else jax.experimental.enable_x64()


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.reshape(-1).view(torch.uint8).numpy()


def _ulps(got: torch.Tensor, want: np.ndarray) -> int:
    ints = {2: np.int16, 4: np.int32, 8: np.int64}[want.dtype.itemsize]
    g = _bits(got).view(ints).astype(np.int64)
    w = np.asarray(want).reshape(-1).view(ints).astype(np.int64)
    return int(np.max(np.abs(g - w)))


# ---------------------------------------------------------------- registry
def test_registry_matches_jax_field_for_field():
    """All 72 rows in the reference's order; every field the two OpSpecs
    share is equal. The port drops ``requires_x64`` (torch computes 64-bit
    dtypes without a switch) and adds ``kernel``: the 7 rows that run
    through op_chain."""
    rows = chains.default_registry()
    assert [r.name for r in rows] == NAMES and len(rows) == 72
    shared = {f.name for f in dataclasses.fields(jax_chains.OpSpec)} - {"step", "requires_x64"}
    assert {f.name for f in dataclasses.fields(chains.OpSpec)} == shared | {"step", "kernel"}
    for r in rows:
        j = JAX_ROWS[r.name]
        for field in sorted(shared):
            assert getattr(r, field) == getattr(j, field), (r.name, field)
    kernel_rows = {r.name: r.kernel for r in rows if r.kernel is not None}
    assert kernel_rows == {n: n for n in ("popc", "clz", *NEW_STEPS)}
    assert {s.name for s in JAX_REG if s.requires_x64} <= set(kernel_rows)


def test_registry_names_unique_and_categorized():
    rows = chains.default_registry()
    assert len({r.name for r in rows}) == len(rows)
    assert {r.category for r in rows} == set(jax_chains.CATEGORIES)


@pytest.mark.parametrize("name", NAMES)
def test_row_inputs_are_the_jax_inputs_bit_for_bit(name):
    spec, j = chains.spec_by_name(name), JAX_ROWS[name]
    with _x64(j):
        want = (j.carry(), *j.operand_arrays())
        got = (spec.carry("cpu"), *spec.operand_tensors("cpu"))
        for g, w in zip(got, want, strict=True):
            assert g.shape == () and g.element_size() == w.dtype.itemsize, name
            assert _bits(g).tobytes() == np.asarray(w).tobytes(), name


# ------------------------------------------------------------------ chains
@pytest.mark.parametrize("name", NAMES)
def test_row_chain_matches_jax_chain_fn(name):
    """The eager chain (what O0 times) against the JAX ``chain_fn``."""
    spec, j = chains.spec_by_name(name), JAX_ROWS[name]
    with _x64(j):
        for n in (1, 2, 7, 64, 256):
            want = np.asarray(jax_chains.chain_fn(j, n)(j.carry(), *j.operand_arrays()))
            assert want.dtype == jnp.dtype(j.dtype), (name, n)  # x64 really on
            got = chains.chain_fn(spec, n)(spec.carry("cpu"), *spec.operand_tensors("cpu"))
            assert got.shape == () and str(got.dtype) == f"torch.{spec.dtype}", (name, n)
            if name in ULP_ROWS:
                assert _ulps(got, want) <= ULPS, (name, n)
            else:
                assert _bits(got).tobytes() == want.tobytes(), (name, n)


@pytest.mark.parametrize("name", HALF_ROWS)
def test_half_row_o3_chain_rounds_every_step_like_jax_jit(name):
    """The O3 chain of a bfloat16 or float16 row equals ``jax.jit`` of the
    reference chain at n 64 bit for bit: Inductor rounds after every step.
    By default it keeps a fused chain in float32 and rounds once at the
    store (add.bfloat16: 1.0625 against 1.0)."""
    spec, j = chains.spec_by_name(name), JAX_ROWS[name]
    want = np.asarray(jax.jit(jax_chains.chain_fn(j, 64))(j.carry(), *j.operand_arrays()))
    got = measure.compile_chain(spec, 64, "O3", "cpu")(spec.carry("cpu"),
                                                      *spec.operand_tensors("cpu"))
    assert _bits(got).tobytes() == want.tobytes(), (name, float(got), float(want))


def test_inductor_options_only_for_half_rows():
    """On the card the half rows compute in their dtype, the fma rows with
    a cast after every op (else LLVM fuses the multiply-add and rounds once);
    on the CPU, whose code generator computes in float32, every half row
    keeps the casts."""
    casts, native = {"emulate_precision_casts": True}, {"triton.codegen_upcast_to_fp32": False}
    for spec in chains.default_registry():
        cpu = measure.inductor_options(spec, "cpu")
        card = measure.inductor_options(spec, torch.device("cuda:0"))
        if spec.dtype in ("bfloat16", "float16"):
            assert cpu == casts, spec.name
            assert card == (casts if spec.name.startswith("fma.") else native), spec.name
        else:
            assert cpu is None and card is None, spec.name


def test_non_half_chain_compiles_to_the_same_kernel_source():
    """A row outside the half dtypes compiles with exactly the options it
    had before the half rows got theirs: the generated code is the same."""
    from torch._inductor.utils import run_and_get_code

    from repro_torch.core.optlevels import _own_code

    spec = chains.spec_by_name("fma.float32")
    args = (spec.carry("cpu"), *spec.operand_tensors("cpu"))
    _, new = run_and_get_code(measure.compile_chain(spec, 4, "O3", "cpu"), *args)
    old_fn = torch.compile(_own_code(chains.chain_fn(spec, 4), "chain_fma_float32_4"),
                           backend="inductor", fullgraph=True, dynamic=False,
                           options={"compile_threads": 1})
    _, old = run_and_get_code(old_fn, *args)
    assert new == old and new


# ------------------------------------------------------------ K2's new steps
def _step_inputs(step, shape=(8, 128), seed=3):
    rng = np.random.RandomState(seed)
    n_ops = opchain.STEPS[step][1]
    draw = lambda low=0: rng.randint(low, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)  # noqa: E731
    return draw(), tuple(draw(1 if i == 0 and step in opchain.DIVIDES else 0)
                         for i in range(n_ops))


@pytest.mark.parametrize("n", [1, 7, 64, 256])
@pytest.mark.parametrize("step", NEW_STEPS)
def test_op_chain_new_steps_match_jax_chain_fn_and_pallas(step, n):
    """op_chain's plain version (what it runs for CPU tensors) against the
    JAX ``chain_fn`` and the Pallas ``op_chain`` in interpret mode, on
    random uint32 carries and operands (divisors nonzero)."""
    j = JAX_ROWS[step]
    x, ops = _step_inputs(step)
    got = op_chain(*from_numpy((x, *ops), "cpu"), step=step, n=n)
    assert got.dtype == torch.uint32 and tuple(got.shape) == x.shape
    with _x64(j):
        args = (jnp.asarray(x), *map(jnp.asarray, ops))
        want = np.asarray(jax_chains.chain_fn(j, n)(*args))
        pallas = np.asarray(jax_op_chain(*args, step=j.step, n=n, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_mul64hi_plain_high_word_past_the_int64_range():
    """The row's own product, 0xDEADBEEF * 0x9E3779B9, is above 2**63: the
    plain version takes the high word without a signed overflow."""
    x, a = 0xDEADBEEF, 0x9E3779B9
    assert x * a >= 2 ** 63
    for xs, as_ in ((x, a), (0xFFFFFFFF, 0xFFFFFFFF), (0, 0xFFFFFFFF), (1, 1)):
        got = op_chain(torch.tensor(xs, dtype=torch.uint32), torch.tensor(as_, dtype=torch.uint32),
                       step="mul64hi", n=1)
        assert int(got) == ((xs * as_) >> 32) | 1


@pytest.mark.parametrize("step", NEW_STEPS)
def test_new_steps_o3_chain_is_one_launch_of_the_same_chain(step):
    spec = chains.spec_by_name(step)
    x, ops = spec.carry("cpu"), spec.operand_tensors("cpu")
    o0 = measure.compile_chain(spec, 64, "O0")(x, *ops)
    o3 = measure.compile_chain(spec, 64, "O3")(x, *ops)
    assert o3.dtype == torch.uint32 and int(o0) == int(o3)


# ------------------------------------------------------- stability properties
@pytest.mark.parametrize("name", NAMES)
@given(n=st.integers(min_value=1, max_value=256))
@settings(max_examples=5, deadline=None)
def test_chain_stable_at_any_length(name, n):
    """Finite, dtype-invariant carry for every chain length (the port of
    tests/test_chains_properties.py's property)."""
    spec = chains.spec_by_name(name)
    out = chains.chain_fn(spec, n)(spec.carry("cpu"), *spec.operand_tensors("cpu"))
    assert str(out.dtype) == f"torch.{spec.dtype}", (name, n)
    if out.is_floating_point():
        assert bool(torch.isfinite(out)), (name, n)


@given(name=st.sampled_from(NAMES))
@settings(max_examples=25, deadline=None)
def test_operands_match_carry_dtype(name):
    spec = chains.spec_by_name(name)
    carry = spec.carry("cpu")
    assert all(o.dtype == carry.dtype for o in spec.operand_tensors("cpu")), name


@pytest.mark.parametrize("name", NAMES)
def test_guard_accounting_consistent(name):
    """``guard`` counts the extra ops inside ``step``: the step's traced
    graph holds at least 1 + guard operations, and guard stays small."""
    from torch.fx.experimental.proxy_tensor import make_fx

    spec = chains.spec_by_name(name)
    assert 0 <= spec.guard <= 3, name
    graph = make_fx(spec.step)(spec.carry("cpu"), *spec.operand_tensors("cpu")).graph
    n_ops = sum(node.op == "call_function" for node in graph.nodes)
    assert n_ops >= 1 + spec.guard, (name, n_ops)


# -------------------------------------------------------------------- plan
def test_table2_plan_matches_jax():
    t, j = torch_plan.named_plan("table2"), jax_plan.named_plan("table2")
    assert [p.logical_key() for p in t] == [p.logical_key() for p in j]
    assert [p.match_names() for p in t] == [p.match_names() for p in j]
    assert len(t) == 146 and t.name == "table2"
    assert "table2" in torch_plan.PORTED_PLANS


# one row of each category, and a uint32 divide through K2
CLI_OPS = ("rem.s", "div.u.irregular", "xor", "min.float32", "add.float64",
           "fma.float16", "mul64hi", "tanh", "bfe")


def test_table2_cli_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    """``characterize --plan table2 --ops ...`` on the CPU, the chains cut
    to (4, 8) at O3: every probe ends as a record or a NoisySlopeError of a
    few-op O3 chain on the host clock, and a second run is cache hits."""
    monkeypatch.setattr(measure, "_CHAIN_LENS", {"O0": (2, 4), "O3": (4, 8)})
    db_path = tmp_path / "table2.json"
    args = ["characterize", "--plan", "table2", "--db", str(db_path), "--device", "cpu",
            "--reps", "3", "--warmup", "1", "--ops", ",".join(CLI_OPS), "--table"]
    rc = cli.main(args)
    out = capsys.readouterr().out
    db = LatencyDB(str(db_path))
    rows = {(r.op, r.opt_level) for r in db.records()}
    failed = {(f.op, f.opt_level) for f in db.failures()}
    assert rows | failed == {(op, lv) for op in CLI_OPS for lv in ("O0", "O3")}
    assert not rows & failed
    assert all(f.error_type == "NoisySlopeError" and f.opt_level == "O3"
               for f in db.failures())
    assert {(op, "O0") for op in CLI_OPS} <= rows
    assert rc == (1 if failed else 0)
    assert f"{len(rows)} measured, 0 cached, {len(failed)} failed (18 probes)" in out
    for r in db.records():
        assert r.category == chains.spec_by_name(r.op).category and "clock=host" in r.notes
        if r.op in ("div.u.irregular", "mul64hi"):
            assert f"kernel=op_chain.{r.op}" in r.notes and r.dtype == "uint32"
    cli.main(args)  # resume: every record is a cache hit; failed rows run again
    m = re.search(r"(\d+) measured, (\d+) cached, (\d+) failed \(18 probes\)",
                  capsys.readouterr().out)
    assert m and int(m[2]) == len(rows) and int(m[1]) + int(m[3]) == len(failed)
