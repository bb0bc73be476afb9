"""The port on a CUDA card: each kernel against its plain PyTorch version on
the same inputs, the event clock, and a small plan end to end.

Every test here is marked ``cuda`` and skips where no card is visible. The
file imports neither jax nor the JAX package, so on a machine without jax it
runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: op_chain and chase bit-exact (a NaN matching any NaN, a zero's
sign counted), but for the in-kernel rows whose
step is a transcendental or reciprocal function (sin, cos, lg2, ex2, tanh,
rsqrt, rcp), within 2 units in the last place; alu_chain rtol 1e-5 (its fma step
rounds once in the kernel, twice in the plain version; its rsqrt and exp
steps differ by an ulp or two; every step contracts an error). The fused
kernels K4-K7 are held element by element to ``tol * (|want| + rms(want's
row))``, a row being the last dimension: tol 2^-7 in bfloat16 (one rounding
of the output; two roundings of nearby float32 values differ by at most
an ulp, 2^-8 to 2^-7 of the value) and 2^-13 in float32 (float32 sums in
another order; below TF32's 2^-11). A flat 3e-2 would pass a kernel that
accumulates p . v in bfloat16 once a row averages over hundreds of keys.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import inkernel
from repro_torch.api import MemoryChaseProbe, Plan, Session
from repro_torch.api.cli import main as cli_main
from repro_torch.core import measure, membench
from repro_torch.core.chains import spec_by_name
from repro_torch.core.timing import Timer, sandwich_slope, sm_clock_hz
from repro_torch.kernels import opchain
from repro_torch.kernels.alu_chain import OPS, alu_chain, alu_chain_plain, alu_chain_timed
from repro_torch.kernels.chase import SMEM_BUDGET_BYTES, chase, chase_plain, chase_timed
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
from repro_torch.kernels.opchain import op_chain, op_chain_plain, op_chain_timed
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

pytestmark = pytest.mark.cuda
ALU_RTOL = 1e-5
ROW_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -13}
ULPS = 2
ULP_ROWS = ("sin", "cos", "lg2", "ex2", "tanh", "rsqrt", "rcp")
INT_STEPS = [s for s, (dtype, _, _) in opchain.STEPS.items() if not dtype.is_floating_point]
# the float rows held bit for bit: all but the ulp-bounded ones
EXACT_FLOAT_STEPS = [s for s, (dtype, _, _) in opchain.STEPS.items()
                     if dtype.is_floating_point and s not in ULP_ROWS]
SPECIALS = (float("nan"), 0.0, -0.0, float("inf"), float("-inf"))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    # the plain versions' einsums run in full float32 (TF32 is off by default)
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda:0")


def _hold(got, want):
    """Every element within tol * (|want| + rms(want's row)); an all-zero
    row of want must be matched exactly."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    g, w = got.float().cpu(), want.float().cpu()
    limit = ROW_TOL[want.dtype] * (w.abs() + w.pow(2).mean(dim=-1, keepdim=True).sqrt())
    bad = (g - w).abs() > limit
    assert not bad.any(), (f"{int(bad.sum())} elements over the limit; worst "
                           f"{float(((g - w).abs() - limit).max()):.3g} above it")


def _randn(dev, *shape, dtype=torch.float32, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(dtype).to(dev)


def _draw(rng, dtype, shape):
    np_dtype = np.int32 if dtype == torch.int32 else np.uint32
    return np.asarray(rng.randint(0, 2 ** 32, shape, dtype=np.uint64).astype(np_dtype))


@pytest.mark.parametrize("n", [1, 8, 45, 64])  # straight-line at 8 and 64, else a loop
@pytest.mark.parametrize("op", OPS)
def test_alu_chain_kernel_matches_plain(dev, op, n):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, (8, 128)).astype(np.float32)).to(dev)
    a = torch.from_numpy(rng.uniform(0.75, 1.25, (8, 128)).astype(np.float32)).to(dev)
    want = alu_chain_plain(x.cpu(), a.cpu(), n=n, op=op)
    before = alu_chain.launches
    got = alu_chain(x, a, n=n, op=op)
    timed, cycles = alu_chain_timed(x, a, n=n, op=op)  # the form the probe runs
    torch.cuda.synchronize()
    assert alu_chain.launches == before + 2
    for out in (got, timed):
        torch.testing.assert_close(out.cpu(), want, rtol=ALU_RTOL, atol=0)
    assert bool((cycles > 0).all())


@pytest.mark.parametrize("shape", [(), (8, 128), (3, 1000)])
@pytest.mark.parametrize("step", INT_STEPS)
def test_op_chain_kernel_bit_exact(dev, step, shape):
    dtype, n_ops, _ = opchain.STEPS[step]
    rng = np.random.RandomState(1)
    x, *ops = (torch.from_numpy(_draw(rng, dtype, shape)) for _ in range(1 + n_ops))
    if step in opchain.DIVIDES:  # a divisor of 0 has no defined quotient
        ops[0] = ops[0] | 1
        if dtype == torch.int32:  # nor has INT_MIN / -1
            ops[0] = ops[0] & 0x7FFFFFFF
    before = op_chain.launches
    lens = (0, 1, 45, 64, 512)  # 45: 32 steps in the loop, 13 in the remainder
    for unroll in opchain.UNROLLS:
        for n in lens:
            got = op_chain(x.to(dev), *(o.to(dev) for o in ops), step=step, n=n,
                           unroll=unroll)
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(got.cpu(), op_chain_plain(x, *ops, step=step, n=n)), \
                (n, unroll)
    assert op_chain.launches == before + len(lens) * len(opchain.UNROLLS)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Units in the last place between two float tensors of one sign."""
    ints = {2: torch.int16, 4: torch.int32}[want.element_size()]
    return int((got.view(ints).long() - want.view(ints).long()).abs().max())


@pytest.mark.parametrize("name", [s.name for s in inkernel.supported_specs()])
def test_op_chain_inkernel_rows_match_plain_in_both_forms(dev, name):
    """Each of the 58 in-kernel rows on its tile and inputs: the timed form
    at the inkernel plan's lengths, every thread's cycles positive, and the
    loop form at an odd n, against op_chain_plain."""
    spec = spec_by_name(name)
    carry, ops = inkernel.tiles(spec)
    args = (carry.to(dev), *(o.to(dev) for o in ops))
    before = op_chain.launches
    runs = [(n, op_chain_timed(*args, step=name, n=n)) for n in opchain.TIMED_LENS]
    runs += [(37, (op_chain(*args, step=name, n=37, unroll=u), None)) for u in opchain.UNROLLS]
    torch.cuda.synchronize()
    assert op_chain.launches == before + len(runs)
    for n, (got, cycles) in runs:
        want = op_chain_plain(carry, *ops, step=name, n=n)
        got = got.cpu()
        assert got.dtype == want.dtype and got.shape == want.shape == carry.shape
        if name in ULP_ROWS:
            assert _ulps(got, want) <= ULPS, n
        else:
            assert torch.equal(got, want), n
        if cycles is not None:
            assert cycles.dtype == torch.int64 and bool((cycles > 0).all()), n


def _with_specials(rng, dtype, shape, dev, scale=4.0):
    """Random values of ``dtype`` with NaN, +-0 and +-inf in a quarter of
    the elements."""
    vals = rng.standard_normal(shape) * scale
    special = rng.random_sample(shape) < 0.25
    vals[special] = rng.choice(SPECIALS, int(special.sum()))
    return torch.from_numpy(vals.astype(np.float32)).to(dtype).to(dev)


def _same_bits_or_both_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit (the sign of a zero counts); a NaN matches any NaN."""
    ints = {2: torch.int16, 4: torch.int32}[want.element_size()]
    both_nan = got.isnan() & want.isnan()
    return bool((both_nan | (got.view(ints) == want.view(ints))).all())


@pytest.mark.parametrize("step", EXACT_FLOAT_STEPS)
def test_op_chain_float_steps_carry_nan_and_signed_zero(dev, step):
    """Each float row that is held bit for bit, on random inputs with NaN,
    +-0 and +-inf among them, in both forms, against op_chain_plain on the
    card: a NaN goes through every step (min and max too), and every other
    value, a zero's sign included, is the plain version's. fma.float32's a
    is a power of two or a special: the kernel rounds x*a + b once (FFMA),
    the registry's step twice, and the two agree where the product is exact
    (as on the row's own inputs)."""
    dtype, n_ops, _ = opchain.STEPS[step]
    rng = np.random.RandomState(2)
    shape = inkernel.default_tile(str(dtype).removeprefix("torch."))
    x, *ops = (_with_specials(rng, dtype, shape, dev) for _ in range(1 + n_ops))
    if step == "fma.float32":
        ops[0] = torch.from_numpy(rng.choice((0.5, 2.0, -0.5, -2.0) + SPECIALS, shape)
                                  .astype(np.float32)).to(dev)
    before = op_chain.launches
    for n in (1, 8, 37, 64):  # straight-line in the timed form at 8 and 64
        want = op_chain_plain(x, *ops, step=step, n=n)
        got = {f"unroll {u}": op_chain(x, *ops, step=step, n=n, unroll=u)
               for u in opchain.UNROLLS}
        got["timed"] = op_chain_timed(x, *ops, step=step, n=n)[0]
        for form, g in got.items():
            assert _same_bits_or_both_nan(g, want), (form, n)
    assert op_chain.launches == before + 4 * (len(opchain.UNROLLS) + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_op_chain_min_max_follow_jnp_on_nan_and_signed_zero(dev, dtype):
    """One step of min and max where fminf-style instructions part from
    jnp.minimum / jnp.maximum: a NaN operand gives NaN, and -0 is below +0
    in either order (min(+0, -0) == -0, max(-0, +0) == +0). b is -0 for min
    and +0 for max, so the step's add or subtract keeps the zero's sign."""
    nan = float("nan")
    t = lambda *v: torch.tensor(v, dtype=getattr(torch, dtype), device=dev)  # noqa: E731
    x, a = t(nan, 1.0, nan, -0.0, 0.0, 2.0), t(1.0, nan, nan, 0.0, -0.0, 3.0)
    cases = {"min": (-0.0, t(nan, nan, nan, -0.0, -0.0, 2.0)),
             "max": (0.0, t(nan, nan, nan, 0.0, 0.0, 3.0))}
    for op, (b, want) in cases.items():
        b = torch.full_like(x, b)
        step = f"{op}.{dtype}"
        got = {f"unroll {u}": op_chain(x, a, b, step=step, n=1, unroll=u)
               for u in opchain.UNROLLS}
        got["timed"] = op_chain_timed(x, a, b, step=step, n=8)[0]  # 8 steps: a fixed point
        for form, g in got.items():
            assert _same_bits_or_both_nan(g.cpu(), want.cpu()), (step, form, g)


def test_op_chain_refuses_unknown_step_or_operand_count(dev):
    carry, ops = inkernel.tiles(spec_by_name("add"), device=dev)
    before = op_chain.launches
    for fn in (op_chain, op_chain_timed):
        with pytest.raises(ValueError, match="step must be one of"):
            fn(carry, *ops, step="add.int128", n=8)
        with pytest.raises(ValueError, match="takes 2 operand"):
            fn(carry, ops[0], step="add", n=8)
        with pytest.raises(TypeError, match="int32"):
            fn(carry.float(), *(o.float() for o in ops), step="add", n=8)
    assert op_chain.launches == before


def test_inkernel_rows_on_the_sm_clock_sandwich(dev, tmp_path):
    """A few rows of the inkernel plan on the card: each timed by K2's clock
    sandwich, its cycles SM cycles at the session's clock."""
    session = Session(db=str(tmp_path / "db.json"), device=dev,
                      timer=Timer(warmup=1, reps=5, device=dev))
    before = op_chain.launches
    result = session.run(Plan.inkernel(ops=("add", "fma.bfloat16", "sin", "popc"),
                                       dispatch_pair=False))
    assert not result.failed, [r.failure for r in result.failed]
    assert op_chain.launches > before
    hz = session.clock_hz()
    for rec in result.records():
        assert rec.op.startswith("inkernel.") and rec.latency_ns > 0
        assert f"clock=sm_clock64@{hz / 1e6:.0f}" in rec.notes
        assert rec.cycles == pytest.approx(rec.latency_ns * hz / 1e9)


def test_table2_row_cycles_count_the_sm_clock(dev, tmp_path):
    """On the card every row's cycles count the SM clock, sampled once a
    session: a table2 row timed by events too."""
    session = Session(db=str(tmp_path / "db.json"), device=dev,
                      timer=Timer(warmup=1, reps=5, device=dev))
    hz = session.clock_hz()
    assert hz == session.clock_hz() and hz == pytest.approx(sm_clock_hz(dev), rel=0.05)
    (rec,) = session.run(Plan.instructions(ops=("add",), opt_levels=("O0",))).records()
    assert rec.cycles == pytest.approx(rec.latency_ns * hz / 1e9)
    assert f"cycles_at=sm_clock64@{hz / 1e6:.0f} clock=events" in rec.notes


@pytest.mark.parametrize("step", ["div.u.regular", "div.u.irregular", "div.u.runtime",
                                  "rem.u", "mul64hi"])
def test_op_chain_table2_steps_on_the_rows_inputs(dev, step):
    """K2's uint32 divides and high multiply on their registry rows' own
    carry and operands (mul64hi's product passes 2**63), one launch a call."""
    spec = spec_by_name(step)
    x, ops = spec.carry("cpu"), spec.operand_tensors("cpu")
    for unroll in opchain.UNROLLS:
        before = op_chain.launches
        got = op_chain(x.to(dev), *(o.to(dev) for o in ops), step=step, n=512, unroll=unroll)
        assert op_chain.launches == before + 1
        assert torch.equal(got.cpu(), op_chain_plain(x, *ops, step=step, n=512)), unroll


@pytest.mark.parametrize("name", ["add.bfloat16", "fma.bfloat16", "max.bfloat16",
                                  "sub.float16", "mul.float16", "min.float16"])
def test_half_row_o3_chain_equals_eager(dev, name):
    """F3: a half-precision row's O3 chain rounds every step, as eager does
    (the fma rows through casts, the others in their own dtype)."""
    spec = spec_by_name(name)
    args = (spec.carry(dev), *spec.operand_tensors(dev))
    o3 = measure.compile_chain(spec, 64, "O3", dev)(*args)
    eager = measure.compile_chain(spec, 64, "O0", dev)(*args)
    assert o3.dtype == eager.dtype and o3.item() == eager.item()


def test_table2_plan_records_every_probe_on_card(dev, tmp_path, monkeypatch):
    """``--plan table2`` on the card, cut to a row of each category, K2's
    five new rows and clock overhead, O3 chains of the plan's own (64, 512)
    ops: a record for every probe, each timed by events, and K2 launched.
    (At (8, 32) the 24 steps between the chains of ``add.float64``, 4.1 ns
    each, were within the events' noise: a slope of -1.333 ns/op.)"""
    monkeypatch.setattr(measure, "_CHAIN_LENS", {"O0": (2, 10), "O3": (64, 512)})
    ops = ("clock_overhead", "rem.s", "xor", "min.float32", "add.float64", "fma.float16",
           "add.cc", "tanh", "bfe", "div.u.regular", "div.u.irregular", "div.u.runtime",
           "rem.u", "mul64hi")
    before = op_chain.launches
    rc = cli_main(["characterize", "--plan", "table2", "--db", str(tmp_path / "db.json"),
                   "--ops", ",".join(ops), "--reps", "5"])
    blob = json.loads((tmp_path / "db.json").read_text())
    assert rc == 0 and not blob.get("failures")
    assert len(blob["records"]) == 2 * len(ops)
    assert all("clock=events" in r["notes"] for r in blob["records"])
    assert op_chain.launches > before


@pytest.mark.parametrize("ws", [1 << 13, 1 << 17, 1 << 21])
def test_chase_kernel_bit_exact(dev, ws):
    ring, start = membench.build_ring(ws, device=dev)
    for steps in (0, 1, 512, 1536):
        got = chase(ring, start, steps=steps)
        assert got.device == ring.device
        assert torch.equal(got.cpu(), chase_plain(ring.cpu(), start.cpu(), steps=steps))


@pytest.mark.parametrize("form", ["chase", "chase_timed"])
@pytest.mark.parametrize("ws,space", [(4096, "smem"), (4096, "global"), (1 << 16, "smem"),
                                      (1 << 16, "global"), (SMEM_BUDGET_BYTES, "smem"),
                                      (1 << 21, "global")])
def test_chase_paths_and_forms_bit_exact(dev, ws, space, form):
    """K3 on both paths, in both forms, with and without a warm lap, equals
    the plain chase; the timed form's cycles are positive."""
    ring, start = membench.build_ring(ws, device=dev)
    lap = ring.numel() // 16
    for steps in (64, 192, 37):
        for warm in (0, lap):
            want = chase_plain(ring.cpu(), start.cpu(), steps=steps, warm=warm)
            if form == "chase":
                got = chase(ring, start, steps=steps, warm=warm, memory_space=space)
            else:
                got, cycles = chase_timed(ring, start, steps=steps, warm=warm,
                                          memory_space=space)
                assert cycles.dtype == torch.int64 and int(cycles[0]) > 0
            assert torch.equal(got.cpu(), want), (steps, warm)


@pytest.mark.parametrize("space", ["smem", "global"])
def test_chase_carried_start_continues(dev, space):
    ring, start = membench.build_ring(1 << 16, device=dev)
    pos = start.clone()
    for _ in range(2):
        assert chase(ring, pos, steps=37, memory_space=space, out=pos) is pos
        p, _ = chase_timed(ring, pos, steps=64, memory_space=space, out=pos)
        assert p is pos
    assert int(pos[0]) == int(chase_plain(ring.cpu(), start.cpu(), steps=2 * (37 + 64))[0])


def test_chase_smem_above_the_budget_raises(dev):
    ring, start = membench.build_ring(SMEM_BUDGET_BYTES + 64, device=dev)
    before = chase.launches
    for form in (chase, chase_timed):
        with pytest.raises(ValueError, match="does not fit"):
            form(ring, start, steps=64, memory_space="smem")
    assert chase.launches == before
    got, _ = chase_timed(ring, start, steps=64)  # by footprint: global
    assert torch.equal(got.cpu(), chase_plain(ring.cpu(), start.cpu(), steps=64))
    assert chase.launches_by_path["timed/global"] > 0


def test_session_runs_the_inkernel_memory_rungs_on_card(dev, tmp_path):
    """An smem rung and a carried global rung beside their host twins: every
    in-kernel record on the SM clock sandwich, with its path and the level
    rule in its notes."""
    plan = Plan.memory_inkernel((1 << 16, 1 << 20), host_steps=(512, 1536))
    session = Session(db=str(tmp_path / "db.json"), device=dev,
                      timer=Timer(warmup=1, reps=5, device=dev))
    result = session.run(plan)
    assert not result.failed, [r.failure for r in result.failed]
    recs = {r.op: r for r in result.records()}
    assert recs["inkernel.mem.65536"].notes.startswith(
        "cuda chase ws=65536 line=64 space=smem lens=64-192 warm=1024 carry=0")
    assert recs["inkernel.mem.1048576"].notes.startswith(
        "cuda chase ws=1048576 line=64 space=global lens=64-192 warm=0 carry=1")
    for op in ("inkernel.mem.65536", "inkernel.mem.1048576"):
        assert "clock=sm_clock64@" in recs[op].notes and recs[op].latency_ns > 0
    assert "clock=events" in recs["mem.chase.ws1048576.s512-1536"].notes
    assert recs["inkernel.mem.65536"].latency_ns < recs["inkernel.mem.1048576"].latency_ns
    assert isinstance(plan.probes[0], MemoryChaseProbe)


def test_wrapper_refuses_mixed_devices(dev):
    x = torch.ones(8, 128, device=dev)
    with pytest.raises(ValueError, match="one device"):
        alu_chain(x, torch.ones(8, 128), n=1)


def test_event_clock_times_the_card(dev):
    timer = Timer(warmup=1, reps=5, device=dev)
    assert timer.clock == "events"
    ring, start = membench.build_ring(1 << 21, device=dev)
    short = timer.time_callable(lambda: chase(ring, start, steps=64))
    long = timer.time_callable(lambda: chase(ring, start, steps=4096))
    assert 0 < short.min_ns < long.min_ns


def test_session_runs_kernel_and_memory_probes_on_card(dev, tmp_path):
    plan = (Plan.memory((1 << 13,), steps=(512, 1536)) + Plan.kernels(("fma",))
            + Plan.instructions(ops=("popc",), opt_levels=("O0", "O3")))
    session = Session(db=str(tmp_path / "db.json"), device=dev,
                      timer=Timer(warmup=1, reps=5, device=dev))
    result = session.run(plan)
    assert not result.failed, [r.failure for r in result.failed]
    for rec in result.records():
        # the in-kernel chain is timed by the clock sandwich, the rest by events
        clock = "clock=sm_clock64@" if rec.op.startswith("kernel.") else "clock=events"
        assert rec.backend == "cuda" and clock in rec.notes
        assert rec.jax_version.startswith("torch-") and "+cu" in rec.jax_version
    assert session.run(plan).summary().startswith("0 measured, 4 cached")


def test_clock_sandwich_resolves_the_fma_chain(dev):
    hz = sm_clock_hz(dev)
    assert 0.5e9 < hz < 2.5e9
    x = torch.full((8, 128), 1.0, device=dev)
    a = torch.full((8, 128), 0.5, device=dev)
    out, cycles = alu_chain_timed(x, a, n=64)
    assert torch.equal(out, alu_chain(x, a, n=64))
    assert cycles.dtype == torch.int64 and cycles.shape == x.shape and bool((cycles > 0).all())
    for _ in range(5):
        m = sandwich_slope(lambda n: lambda: alu_chain_timed(x, a, n=n)[1], 8, 64, clock_hz=hz)
        assert m.median_ns > 0   # a non-positive slope raises NoisySlopeError


def test_cli_defaults_to_the_card(dev, tmp_path, capsys):
    db = tmp_path / "db.json"
    rc = cli_main(["characterize", "--db", str(db), "--ops", "clock_overhead,fma",
                   "--reps", "3"])
    assert rc == 0, capsys.readouterr()
    blob = json.loads(db.read_text())
    assert {r["backend"] for r in blob["records"]} == {"cuda"}


# ------------------------------------------------------------ the audit
@pytest.mark.parametrize("name,status,cause", [
    ("add", "ok", ""), ("div.s.regular", "ok", "strength-reduction"),
    ("not", "transformed", "dead-code-eliminated"), ("popc", "ok", "")])
def test_audit_of_o3_chains_on_the_card(dev, name, status, cause, monkeypatch):
    """An O3 row's verdict from the PTX and SASS of its own chains,
    compiled here at short lengths as a compile worker compiles them: add's
    chain is sound, div.s.regular's strength-reduced as declared, not's
    folded by LLVM (two steps are one add of a constant), popc's K2 loop
    form sound."""
    from repro_torch.audit import artifacts, audit_spec
    from repro_torch.core.latency_db import current_environment

    monkeypatch.setitem(measure._CHAIN_LENS, "O3", (4, 8))
    spec = spec_by_name(name)
    if spec.kernel is None:
        for n in (4, 8):  # what the compile pool's runner hands back, filed by its name
            found = artifacts.warm_and_read(measure.warm_chain, name, "O3", n, str(dev))
            artifacts.remember(found["chain"], found)
    v = audit_spec(spec, "O3", env=current_environment(dev))
    assert (v.status, v.cause) == (status, cause), v


@pytest.mark.parametrize("op,status,cause,detail", [
    ("inkernel.add", "audited", "", "step=IMAD.IADDx1+LOP3.LUTx1"),
    ("inkernel.bfi", "transformed", "dead-code-eliminated", ""),
    ("inkernel.mem.65536", "audited", "", "LDSx1"),
    ("inkernel.mem.1048576", "audited", "", "LDG"),
    ("kernel.alu_chain.fma", "audited", "", "step=FFMAx1"),
    ("mem.chase.ws2097152", "ok", "", "one ld.global.ca a step")])
def test_audit_of_k1_k3_on_the_card(dev, op, status, cause, detail):
    """K1-K3's compiled code opened: K2's timed add serialized, its bfi
    folded by ptxas; K3's timed chase one dependent LDS (64 KiB) or LDG
    (1 MiB) a step; K1's fma chain one FFMA a step; K3's global loop one
    ld.global.ca a step."""
    from repro_torch.audit import audit_target
    from repro_torch.core.latency_db import current_environment

    v = audit_target(op, "O3", env=current_environment(dev))
    assert (v.status, v.cause) == (status, cause) and detail in v.detail, v


def test_o1_chain_on_the_card_equals_eager_and_is_timed(dev, tmp_path):
    """O1 on the card: the graph's kernels replayed from one CUDA graph give
    the eager chain's result; the row is timed by events and says so, and
    names the graph it replays from. Capturing popc's chain counts no
    launch; each replay counts its n launches of op_chain."""
    from repro_torch.api.plan import Plan
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.kernels.opchain import op_chain
    from repro_torch.utils import parse_kv_notes

    spec = spec_by_name("popc")
    measure.prepare_o1_chain("popc", 37, str(dev))  # compiled and captured, not replayed
    before = launch_counts()
    fn = measure.compile_chain(spec, 37, "O1", dev)
    fn.capture(spec.carry(dev), *spec.operand_tensors(dev))  # a second capture: no count
    assert launch_counts() == before
    fn(spec.carry(dev), *spec.operand_tensors(dev))
    fn(spec.carry(dev), *spec.operand_tensors(dev))
    assert op_chain.launches - before["op_chain"] == 2 * 37
    for name in ("add", "popc", "add.bfloat16"):
        spec = spec_by_name(name)
        args = (spec.carry(dev), *spec.operand_tensors(dev))
        for n in (64, 512):
            got = measure.compile_chain(spec, n, "O1", dev)(*args)
            want = measure.chains.chain_fn(spec, n)(*args)
            assert torch.equal(got.reshape(1).view(torch.uint8),
                               want.reshape(1).view(torch.uint8)), (name, n)
    plan = Plan.instructions(ops=("add", "popc"), opt_levels=("O1",)) + Plan.clock_overhead(("O1",))
    result = Session(db=str(tmp_path / "db.json"), device=dev, audit=True).run(plan)
    assert not result.failed, [r.failure for r in result.failed]
    for r in result.results:
        kv = parse_kv_notes(r.record.notes)
        assert kv["clock"] == "events" and kv["audit"] == "ok" and "o1" in kv, kv
        assert kv.get("launch") == {"add": "cuda_graph", "popc": "per-step,cuda_graph",
                                    "clock_overhead": None}[r.record.op], kv


# ------------------------------------------------------------ K4-K7
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("offset", [0, 1])  # elements: 1 puts x off a 16-byte boundary
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 128), (96, 256), (256, 64), (3, 1000),
                                   (2, 5, 4096), (5, 7), (3, 4100), (2, 8192), (2, 9000)])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype, offset):
    """Every instance rmsnorm_plan picks: 16-byte vectors or scalars (D 7,
    bf16 D 4100, and x 2 or 4 bytes off a 16-byte boundary), a warp or a
    block per row, and a row longer than the registers (D 9000)."""
    n = int(np.prod(shape))
    x = _randn(dev, n + 8, dtype=dtype, seed=1)[offset:offset + n].view(shape)
    w = _randn(dev, shape[-1], dtype=dtype, seed=2)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = rmsnorm.launches
    got = rmsnorm(x, w)
    assert rmsnorm.launches == before + 1
    _hold(got, rmsnorm_plain(x, w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal", [
    (1, 128, 128, 4, 4, 64, True),      # MHA square
    (2, 128, 128, 4, 2, 32, True),      # GQA
    (1, 64, 192, 6, 3, 16, True),       # sq != sk (prefix cache)
    (2, 256, 256, 8, 1, 64, True),      # MQA
    (2, 64, 96, 4, 2, 32, False),       # non-causal
    (1, 100, 37, 4, 2, 128, True),      # sq > sk: rows that see no key are 0
    (1, 1000, 1000, 8, 2, 128, True),   # a long row: the row-scaled limit bites
])
def test_flash_attention_kernel_matches_plain(dev, b, sq, sk, h, kh, d, causal, dtype):
    q = _randn(dev, b, sq, h, d, dtype=dtype, seed=3)
    k = _randn(dev, b, sk, kh, d, dtype=dtype, seed=4)
    v = _randn(dev, b, sk, kh, d, dtype=dtype, seed=5)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    _hold(got, want)
    if causal and sq > sk:
        assert torch.all(got[:, :sq - sk].float() == 0)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,sq,sk,h,kh,causal", [
    (1, 200, 200, 4, 4, True),     # g = 1, Sq not a multiple of 64
    (2, 100, 37, 8, 2, True),      # g = 4, Sq > Sk: rows that see no key are 0
    (1, 130, 300, 8, 1, True),     # g = 8, a prefix (Sq < Sk)
    (2, 77, 150, 8, 2, False),     # non-causal, neither a multiple of 64
])
def test_flash_attention_bf16_tensor_core_design(dev, b, sq, sk, h, kh, causal, d):
    q = _randn(dev, b, sq, h, d, dtype=torch.bfloat16, seed=15)
    k = _randn(dev, b, sk, kh, d, dtype=torch.bfloat16, seed=16)
    v = _randn(dev, b, sk, kh, d, dtype=torch.bfloat16, seed=17)
    got = flash_attention(q, k, v, causal=causal)
    _hold(got, flash_attention_plain(q, k, v, causal=causal))
    if causal and sq > sk:
        assert torch.all(got[:, :sq - sk].float() == 0)
    assert torch.equal(flash_attention(q, k, v, causal=causal), got)  # no atomics


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,sq,sk,h,kh,causal", [
    (1, 200, 200, 4, 4, True),      # g = 1, Sq not a multiple of 16
    (2, 100, 37, 8, 2, True),       # g = 4, Sq > Sk: rows that see no key are 0
    (1, 130, 300, 8, 1, True),      # g = 8, a prefix (Sq < Sk)
    (2, 77, 150, 8, 2, False),      # non-causal, neither a multiple of 32
    (1, 1000, 1937, 32, 8, True),   # Jamba's heads, ragged: a long row
])
def test_flash_attention_f32_tensor_core_design(dev, b, sq, sk, h, kh, causal, d):
    """3xTF32 on mma.sync within the float32 row-scaled limit (one TF32
    product would fail it), the rows that see no key exactly 0, and two
    calls give the same bits."""
    q = _randn(dev, b, sq, h, d, seed=18)
    k = _randn(dev, b, sk, kh, d, seed=19)
    v = _randn(dev, b, sk, kh, d, seed=20)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    _hold(got, flash_attention_plain(q, k, v, causal=causal))
    if causal and sq > sk:
        assert torch.all(got[:, :sq - sk] == 0)
    assert torch.equal(flash_attention(q, k, v, causal=causal), got)


def test_flash_attention_f32_refuses_a_misaligned_view(dev):
    """K and V arrive by 16-byte cp.async: a view 4 bytes in is refused."""
    base = _randn(dev, 1 * 64 * 4 * 64 + 4, seed=22)
    aligned, odd = base[4:].view(1, 64, 4, 64), base[1:1 + 64 * 4 * 64].view(1, 64, 4, 64)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(aligned, odd, aligned)
    assert flash_attention.launches == before
    _hold(flash_attention(aligned, aligned, aligned),
          flash_attention_plain(aligned, aligned, aligned))


def test_flash_attention_bf16_refuses_a_misaligned_view(dev):
    """TMA reads from 16-byte aligned bases: a view 2 bytes in is refused,
    not copied and not run through the plain version."""
    base = _randn(dev, 1 * 64 * 4 * 64 + 8, dtype=torch.bfloat16, seed=21)
    aligned, odd = base[8:].view(1, 64, 4, 64), base[1:1 + 64 * 4 * 64].view(1, 64, 4, 64)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(odd, aligned, aligned)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(aligned, aligned, odd)
    assert flash_attention.launches == before
    _hold(flash_attention(aligned, aligned, aligned),
          flash_attention_plain(aligned, aligned, aligned))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,kh,d,lens", [
    (2, 256, 8, 2, 64, (256, 243)), (3, 128, 4, 4, 32, (128, 115, 102)),
    (1, 512, 2, 1, 128, (512,)), (2, 64, 8, 1, 16, (64, 0)),
    (4, 1000, 32, 8, 128, (1000, 999, 1, 0)),
    (1, 4608, 32, 8, 128, (4608,)),                  # batch 1, 9 splits
    (5, 1537, 8, 2, 64, (511, 512, 513, 1537, 0)),   # lengths at split boundaries
    (2, 1100, 4, 4, 32, (1100, 700)),                # g = 1
    (2, 1100, 16, 2, 128, (1100, 513)),              # g = 8
    (3, 300, 12, 2, 16, (300, 0, 1)),                # one split (S <= 512), g = 6
])
def test_flash_decode_kernel_matches_plain(dev, b, s, h, kh, d, lens, dtype):
    """Split-KV (512 keys a split; one split writes the output itself, more
    are merged by a second pass): within the row-scaled limit, kv_len = 0
    rows exactly 0, and two calls give the same bits (no atomics)."""
    q = _randn(dev, b, h, d, dtype=dtype, seed=6)
    k = _randn(dev, b, s, kh, d, dtype=dtype, seed=7)
    v = _randn(dev, b, s, kh, d, dtype=dtype, seed=8)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = flash_decode.launches
    got = flash_decode(q, k, v, kv_len)
    assert flash_decode.launches == before + 1
    _hold(got, flash_decode_plain(q, k, v, kv_len))
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(got[i].float() == 0)
    assert torch.equal(flash_decode(q, k, v, kv_len), got)


@pytest.mark.parametrize("b,s,dm,n,chunk", [
    (2, 64, 16, 8, 16), (1, 96, 8, 4, 32), (1, 100, 200, 16, 32), (2, 1024, 256, 16, 64),
    (1, 77, 1001, 8, 16),   # Dm not a multiple of 4: the 4-byte copies
])
def test_mamba_scan_kernel_matches_plain(dev, b, s, dm, n, chunk):
    args = (_randn(dev, b, s, dm, scale=0.5, seed=9), _randn(dev, b, s, dm, scale=0.1, seed=10),
            -torch.exp(_randn(dev, dm, n, scale=0.3, seed=11)),
            _randn(dev, b, s, n, scale=0.5, seed=12), _randn(dev, b, s, n, scale=0.5, seed=13),
            _randn(dev, dm, scale=0.1, seed=14))
    before = mamba_scan.launches
    got = mamba_scan(*args, chunk=chunk)
    assert mamba_scan.launches == before + 1
    _hold(got, mamba_scan_plain(*args, chunk=chunk))


@pytest.mark.parametrize("chunk", [1, 7])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_mamba_scan_staged_design_and_final_state(dev, n, chunk):
    """Dm 1000 (not a multiple of a block's 64 channels), batch 2, S 4096
    (128 staged tiles): y with D folded in and the final state h, within
    the float32 row-scaled limit of the plain version; chunk sets nothing."""
    b, s, dm = 2, 4096, 1000
    args = (_randn(dev, b, s, dm, scale=0.5, seed=23), _randn(dev, b, s, dm, scale=0.1, seed=24),
            -torch.exp(_randn(dev, dm, n, scale=0.3, seed=25)),
            _randn(dev, b, s, n, scale=0.5, seed=26), _randn(dev, b, s, n, scale=0.5, seed=27),
            _randn(dev, dm, scale=0.1, seed=28))
    before = mamba_scan.launches
    y, h = mamba_scan(*args, chunk=chunk, return_state=True)
    assert mamba_scan.launches == before + 1
    assert h.shape == (b, dm, n) and h.dtype == torch.float32
    want_y, want_h = mamba_scan_plain(*args, chunk=chunk, return_state=True)
    _hold(y, want_y)
    _hold(h, want_h)
    assert torch.equal(mamba_scan(*args, chunk=64), y)


def test_fused_kernels_refuse_what_they_have_no_instance_for(dev):
    q = torch.zeros(1, 8, 4, 48, device=dev)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    kv = torch.zeros(1, 8, 1, 16, device=dev)
    kv_len = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at most 8"):
        flash_decode(torch.zeros(1, 16, 16, device=dev), kv, kv, kv_len)
    x = torch.zeros(1, 8, 4, device=dev)
    with pytest.raises(ValueError, match="N=5"):
        mamba_scan(x, x, torch.zeros(4, 5, device=dev), torch.zeros(1, 8, 5, device=dev),
                   torch.zeros(1, 8, 5, device=dev), torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="kv_len on"):
        flash_decode(torch.zeros(1, 2, 16, device=dev), kv, kv, kv_len.cpu())
    odd = torch.zeros(1 * 8 * 1 * 16 + 1, device=dev)[1:].view(1, 8, 1, 16)
    with pytest.raises(ValueError, match="16-byte boundary"):  # cp.async reads 16 bytes
        flash_decode(torch.zeros(1, 2, 16, device=dev), odd, kv, kv_len)


def test_fused_plan_runs_every_kernel_on_the_card(dev, tmp_path):
    from repro_torch.api import Plan
    from repro_torch.kernels.ops import KERNELS

    for k in KERNELS:
        k.launches = 0
    session = Session(db=str(tmp_path / "db.json"), device=dev,
                      timer=Timer(warmup=1, reps=5, device=dev))
    result = session.run(Plan.fused())
    for name in ("rmsnorm", "flash_attention", "flash_decode", "mamba_scan"):
        assert {k.__name__: k.launches for k in KERNELS}[name] > 0
    for r in result.failed:  # only the row-parallel rmsnorm may drown in noise
        assert r.probe.name == "rmsnorm" and r.failure.error_type == "NoisySlopeError"
    for rec in result.records():
        assert rec.notes.startswith("cuda fused kernel lens=2-6 unit_bytes=")


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-3-8b"])
def test_serving_kernel_path_holds_against_the_plain_path(dev, arch, monkeypatch):
    """The smoke config's prefill through K5 (and K7) launches K5 once an
    attention layer and K7 once a Mamba layer. Layer by layer
    (``models.pathcheck``: each layer of both paths given the plain path's
    input and the same expert choices), every layer's output, its caches,
    the logits and the first decode step stay within LAYER_TOL and
    STATE_TOL; a K7 without its D skip and the decode step from zero Mamba
    states (R3) do not."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import launch_counts, launches_since
    from repro_torch.models import pathcheck, transformer
    from repro_torch.models.config import Runtime

    cfg = get(arch).smoke
    model = transformer.init_lm(cfg, seed=0, device=dev)
    kern = Runtime(mamba_chunk=16, attn_impl="pallas", use_pallas=True)
    plain = dataclasses.replace(kern, attn_impl="plain", use_pallas=False)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (2, 97), generator=g).to(dev)
    before = launch_counts()
    transformer.prefill(model, kern, tokens=toks[:, :96])
    layers = [m for m, _ in cfg.layer_list()]
    want = {"flash_attention": layers.count("attn"), "mamba_scan": layers.count("mamba")}
    assert launches_since(before) == {k: n for k, n in want.items() if n}
    rows, ck, cp = pathcheck.prefill_layers(model, kern, plain, toks[:, :96])
    rows += pathcheck.decode_layers(model, ck, cp, toks[:, 96:], 96, kern, plain)
    assert max(r["worst"] for r in rows) <= 1.0, rows
    if "mamba" not in layers:
        return
    real = ops.mamba_scan
    with monkeypatch.context() as m:
        m.setattr(ops, "mamba_scan", lambda x, dt, A, B, C, D, **kw: real(
            x, dt, A, B, C, torch.zeros_like(D), **kw))
        no_skip, _, _ = pathcheck.prefill_layers(model, kern, plain, toks[:, :96])
    assert max(r["out"] for r in no_skip) > 1.0
    zero = pathcheck.decode_layers(model, pathcheck.zero_states(ck), cp, toks[:, 96:], 96,
                                   kern, plain)
    assert max(r["out"] for r in zero) > 1.0


def test_serve_launcher_runs_the_kernels_on_the_card(dev, capsys):
    from repro_torch.kernels.ops import launch_counts, launches_since
    from repro_torch.launch import serve

    before = launch_counts()
    eng = serve.main(["--arch", "jamba-v0.1-52b", "--kernels", "--requests", "3",
                      "--max-new", "4"])
    assert eng.device == dev
    assert launches_since(before) == {"flash_attention": 1, "mamba_scan": 7}
    out = capsys.readouterr().out
    assert "kernels on" in out and "peak memory allocated" in out


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_embedding_archs_kernel_path_holds_against_the_plain_path(dev, arch):
    """The smoke configs of the two architectures that take a frontend's
    embeddings, on the card: K5 launched once a prefill attention (qwen2-vl
    causal, 6 query heads a KV head, M-RoPE; seamless's encoder non-causal,
    its cross-attention of 96 queries to 24 keys), and each layer of the
    kernel path within the layer check's limits of the plain path's."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.kernels.ops import launch_counts, launches_since
    from repro_torch.models import encdec, pathcheck, transformer
    from repro_torch.models.config import Runtime

    cfg = get(arch).smoke
    kern = Runtime(attn_impl="pallas")
    plain = dataclasses.replace(kern, attn_impl="plain")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (2, 97), generator=g).to(dev)
    before = launch_counts()
    if cfg.n_encoder_layers:
        model = encdec.init_encdec(cfg, seed=0, device=dev)
        frames = torch.randn(2, 24, cfg.d_model, generator=g).to(dev, torch.bfloat16)
        encdec.prefill(model, kern, frames, toks[:, :96])
        assert launches_since(before) == {"flash_attention": cfg.n_encoder_layers
                                          + 2 * cfg.n_layers}
        rows, ck, cp = pathcheck.encdec_prefill_layers(model, kern, plain, frames, toks[:, :96])
        rows += pathcheck.encdec_decode_layers(model, ck, cp, toks[:, 96:], 96, kern, plain)
    else:
        model = transformer.init_lm(cfg, seed=0, device=dev)
        emb = torch.randn(2, 96, cfg.d_model, generator=g).to(dev, torch.bfloat16)
        h, w = torch.meshgrid(torch.arange(8), torch.arange(12), indexing="ij")
        pos = torch.stack([torch.zeros(96, dtype=torch.long), h.flatten(), w.flatten()])
        pos = pos[:, None].expand(3, 2, 96).to(dev)
        transformer.prefill(model, kern, embeds=emb, positions=pos)
        assert launches_since(before) == {"flash_attention": cfg.n_layers}
        rows, ck, cp = pathcheck.prefill_layers(model, kern, plain, embeds=emb, positions=pos)
        nxt = torch.full((3, 2, 1), 12, device=dev)
        rows += pathcheck.decode_layers(model, ck, cp, toks[:, 96:], 96, kern, plain,
                                        positions=nxt)
    assert max(r["worst"] for r in rows) <= 1.0, rows


def test_xlstm_serves_on_the_card(dev, capsys):
    """The xLSTM smoke config through the launcher on the card: no kernel
    (the JAX package has none for these mixers), tokens in the vocabulary."""
    from repro_torch.kernels.ops import launch_counts, launches_since
    from repro_torch.launch import serve

    before = launch_counts()
    eng = serve.main(["--arch", "xlstm-350m", "--requests", "3", "--max-new", "4"])
    assert eng.device == dev and launches_since(before) == {}
    assert "xlstm-smoke (8 layers" in capsys.readouterr().out


def test_serving_plan_measures_its_four_cells_on_the_card(dev, tmp_path, monkeypatch, capsys):
    """``characterize --plan serving`` on the card: its deps first (the
    QUICK_OPS' O3 chains cut to (8, 32) here, so a short chain may end as a
    NoisySlopeError; the three chase rungs), then the four serving-tiny
    cells, each measured on events with ``exec=eager``, a positive
    prediction priced from the deps' rows, a coverage in (0, 1], and no
    fused kernel launched; the serving table printed."""
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment
    from repro_torch.kernels.ops import launch_counts, launches_since
    from repro_torch.utils import parse_kv_notes

    monkeypatch.setitem(measure._CHAIN_LENS, "O3", (8, 32))
    db_path = tmp_path / "serving.json"
    before = launch_counts()
    rc = cli_main(["characterize", "--plan", "serving", "--db", str(db_path), "--table"])
    out = capsys.readouterr().out
    db = LatencyDB(str(db_path))
    assert all(f.error_type == "NoisySlopeError" and not f.op.startswith("serving.")
               for f in db.failures()), db.failures()
    assert rc == (1 if db.failures() else 0)
    # the deps launch K2 (popc, clz) and K3 (the rungs); the cells no fused kernel
    assert not set(launches_since(before)) & {"rmsnorm", "flash_attention", "flash_decode",
                                              "mamba_scan"}
    env = current_environment(dev)
    cells = [p for p in named_plan("serving") if p.category == "serving"]
    assert len(cells) == 4
    for probe in cells:
        rec = db.get(probe.key(env))
        kv = parse_kv_notes(rec.notes)
        assert kv["exec"] == "eager" and kv["lead"] == "none" and "clock=events" in rec.notes
        assert float(kv["predicted_ns"]) > 0 and 0 < float(kv["coverage"]) <= 1
        assert rec.latency_ns > 0
    assert "== serving predicted vs measured" in out


def test_slo_plan_measures_a_point_on_the_card(dev, tmp_path, monkeypatch):
    """``Plan.slo((50.0,), n_requests=4, n_slots=2)`` on the card: its deps
    first (the QUICK_OPS' O3 chains cut to (8, 32) here, so a short chain may
    end as a NoisySlopeError; the three chase rungs), then the point: both
    sides positive, each request its whole budget, a coverage in (0, 1],
    the measured side on the host's wall clock (``exec=eager clock=wall``),
    and no fused kernel launched (serving-tiny runs ``attn_impl="auto"``)."""
    from repro_torch.api import SloProbe
    from repro_torch.core.perfmodel import SloPoint, slopoint_from_record
    from repro_torch.kernels.ops import launch_counts, launches_since
    from repro_torch.traffic import generate_trace
    from repro_torch.utils import parse_kv_notes

    monkeypatch.setitem(measure._CHAIN_LENS, "O3", (8, 32))
    session = Session(db=str(tmp_path / "slo.json"), device=dev,
                      timer=Timer(warmup=2, reps=10, device=dev))
    plan = Plan.slo((50.0,), n_requests=4, n_slots=2)
    before = launch_counts()
    result = session.run(plan)
    assert all(r.failure.error_type == "NoisySlopeError" and r.probe.category != "slo"
               for r in result.failed), [r.failure for r in result.failed]
    assert not set(launches_since(before)) & {"rmsnorm", "flash_attention", "flash_decode",
                                              "mamba_scan"}
    (probe,) = [p for p in plan if isinstance(p, SloProbe)]
    rec = session.db.get(probe.key(session.env))
    assert rec.op == "slo.r50.n4s2" and rec.latency_ns > 0
    kv = parse_kv_notes(rec.notes)
    assert (kv["exec"], kv["clock"]) == ("eager", "wall") and "cycles_at" in kv
    pt = slopoint_from_record(rec)
    for side in (pt.predicted, pt.measured):
        assert set(side) == set(SloPoint.METRICS) and all(v > 0 for v in side.values())
    assert 0 < pt.coverage <= 1
    pred, meas, _ = probe.last_result
    assert meas.n_tokens == pred.n_tokens == sum(
        r.max_new for r in generate_trace(probe.trace_config()))


def test_fused_rows_are_audited_from_their_instances_sass(dev, tmp_path):
    """The fused plan's four rows, audited on the card: each signature linear
    in its workload and the instances its unit workload launches free of
    local memory (their SASS and ptxas's report), ``unit_bytes`` as its
    notes; causal self-attention is rejected as non-linear."""
    from repro_torch.audit import audit_target, dataflow
    from repro_torch.core.latency_db import current_environment
    from repro_torch.utils import parse_kv_notes

    env = current_environment(dev)
    result = Session(db=str(tmp_path / "db.json"), device=dev, timer=Timer(device=dev),
                     audit=True).run(Plan.fused())
    for probe in Plan.fused():
        v = audit_target(probe.op, "O3", env=env)
        assert v.status == "audited", v
        assert dataflow.fused_instances(probe.name)
        rec = result.db.get(probe.key(env))
        if rec is not None:  # rmsnorm may end as a NoisySlopeError
            notes = parse_kv_notes(rec.notes)
            assert notes["audit"] == "audited"
            assert notes["unit_bytes"] == parse_kv_notes(v.detail)["unit_bytes"]
    control = dataflow.audit_fused("flash_attention", overrides={"causal": True},
                                   query_grows=True, env=env)
    assert control.status == "transformed" and control.cause.startswith("nonlinear-")


def test_a_warm_characterize_process_compiles_nothing(dev, tmp_path):
    """``characterize --compile-cache`` twice in fresh processes: the first
    compiles the two rows' four chains in its workers, the second loads them
    all (``0 compiled``) with no Inductor miss, no lowering and no Triton
    compile that missed Triton's cache."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    cache = tmp_path / "cc"
    args = [sys.executable, "-m", "repro_torch", "characterize", "--plan", "quick",
            "--opt-levels", "O3", "--ops", "add,mul", "--force", "--db",
            str(tmp_path / "db.json"), "--compile-cache", str(cache)]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    cold = subprocess.run(args, capture_output=True, text=True, env=env, timeout=900)
    assert cold.returncode == 0, cold.stderr[-2000:]
    assert "compile cache: 0 hits, 4 compiled" in cold.stdout
    warm = subprocess.run(args, capture_output=True, text=True, env=env, timeout=900)
    assert warm.returncode == 0, warm.stderr[-2000:]
    assert "compile cache: 4 hits, 0 compiled" in warm.stdout
    line = re.search(r"inductor (\{.*?\}); lowering ([\d.]+) s", warm.stdout)
    counts = json.loads(line[1])
    # (async_compile_cache_miss is Inductor's in-process table of kernels)
    for k in ("inductor.fxgraph_cache_miss", "aot_autograd.autograd_cache_miss"):
        assert not counts.get(k), counts
    assert float(line[2]) == 0.0
    assert counts.get("triton.compile_cache_miss", 1) == 0
