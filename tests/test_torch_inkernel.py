"""The ``inkernel`` slice on the CPU: which registry rows run inside a
kernel, each row's in-kernel chain, ``KernelChainProbe``, ``Plan.inkernel``,
the dispatch-vs-in-kernel pairing and ``characterize --plan inkernel``,
held against the JAX package on the same inputs.

Each row's chain is K2's plain version here (what ``op_chain`` runs for CPU
tensors), held against the JAX package's Pallas ``op_chain`` in interpret
mode at the in-kernel plan's two lengths, on the row's own tile and
inputs. Tolerances: integer and uint32 rows bit-exact, and float rows whose
steps round correctly (add, sub, mul, fma, min, max, the divides, sqrt,
copysign, in every float dtype); within ``ULPS`` = 2 units in the last place
for the rows whose step is a transcendental or reciprocal function (sin,
cos, lg2, ex2, tanh, rsqrt, rcp): neither library rounds those correctly,
and each step contracts the error, so it does not grow with n. K2 itself is
held against this plain version on the card (``test_torch_cuda.py``).
"""
import re

import numpy as np
import pytest
import torch

import repro.inkernel as jax_inkernel
from repro.api import plan as jax_plan
from repro.api import probes as jax_probes
from repro.core import chains as jax_chains
from repro.core import latency_db as jax_latency_db
from repro_torch import inkernel
from repro_torch.api import KernelChainProbe, Plan, Session, cli, named_plan
from repro_torch.api import session as session_mod
from repro_torch.api.probes import Probe, ProbeContext
from repro_torch.core import chains, measure
from repro_torch.core.latency_db import LatencyDB, LatencyRecord, current_environment
from repro_torch.core.timing import Measurement, Timer
from repro_torch.kernels import opchain
from repro_torch.kernels.opchain import op_chain, op_chain_timed

ULPS = 2
ULP_ROWS = ("sin", "cos", "lg2", "ex2", "tanh", "rsqrt", "rcp")
JAX_SPECS = jax_inkernel.supported_specs()
NAMES = [s.name for s in JAX_SPECS]


def _jax_spec(name):
    return next(s for s in JAX_SPECS if s.name == name)


def _ulps(got: torch.Tensor, want: np.ndarray) -> int:
    ints = {2: np.int16, 4: np.int32}[want.dtype.itemsize]
    g = got.reshape(-1).view(torch.uint8).numpy().view(ints).astype(np.int64)
    w = np.asarray(want).reshape(-1).view(ints).astype(np.int64)
    return int(np.max(np.abs(g - w)))


# ------------------------------------------------------------------ factory
def test_supported_specs_are_the_jax_packages_58():
    ours = inkernel.supported_specs()
    assert [s.name for s in ours] == NAMES and len(ours) == 58
    for spec in chains.default_registry():  # the same rule, row for row
        j = next(s for s in jax_chains.default_registry() if s.name == spec.name)
        assert inkernel.supported(spec) == jax_inkernel.supported(j), spec.name
    for spec in ours:
        assert inkernel.default_tile(spec.dtype) == jax_inkernel.default_tile(spec.dtype)
    assert [s.name for s in inkernel.supported_specs(ops=["add", "sin", "add.float64"],
                                                     categories=["int_arith"])] == ["add"]


@pytest.mark.parametrize("name", NAMES)
def test_tiles_are_the_jax_tiles_bit_for_bit(name):
    carry, ops = inkernel.tiles(chains.spec_by_name(name))
    jc, jops = jax_inkernel.tiles(_jax_spec(name))
    assert len(ops) == len(jops)
    for got, want in zip((carry, *ops), (jc, *jops), strict=True):
        assert tuple(got.shape) == want.shape and got.is_contiguous()
        assert got.reshape(-1).view(torch.uint8).numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_inkernel_chain_matches_pallas_interpret(name):
    """The row's in-kernel chain at the plan's two lengths, on its tile:
    the port's ``build_chain`` (K2's plain version on the CPU) against the
    JAX package's ``build_chain`` in interpret mode."""
    spec, j = chains.spec_by_name(name), _jax_spec(name)
    carry, ops = inkernel.tiles(spec)
    jc, jops = jax_inkernel.tiles(j)
    for n in inkernel.INKERNEL_LENS:
        want = np.asarray(jax_inkernel.build_chain(j, n, interpret=True)(jc, *jops))
        got = inkernel.build_chain(spec, n)(carry, *ops)
        assert str(got.dtype) == f"torch.{spec.dtype}" and tuple(got.shape) == want.shape
        if name in ULP_ROWS:
            assert _ulps(got, want) <= ULPS, (name, n)
        else:
            assert got.reshape(-1).view(torch.uint8).numpy().tobytes() == want.tobytes(), (name, n)


@pytest.mark.parametrize("name", ["mul64hi", "add.float64", "add.cc"])
def test_build_chain_refuses_the_64_bit_rows(name):
    with pytest.raises(ValueError, match="cannot lower in-kernel"):
        inkernel.build_chain(chains.spec_by_name(name), 8)
    with pytest.raises(ValueError, match="cannot lower in-kernel"):
        KernelChainProbe(chains.spec_by_name(name))


def _f32(v):
    return np.asarray(v, np.float64).astype(np.float32)


# The rows whose JAX chain, compiled by XLA, rounds otherwise than eager jnp
# does op by op: (port's plain step, JAX package's compiled step), in numpy.
# The port's K2 follows eager for the last two and XLA for fma.float32 (one
# FFMA), so test_torch_cuda.py holds that row's kernel on exact products.
COMPILED_DIFFER = {
    "fma.float32": (lambda x, a, b: _f32(_f32(x * a) + b),  # two roundings
                    lambda x, a, b: _f32(x.astype(np.float64) * a + b)),  # one
    "fma.float16": (lambda x, a, b: ((x * a).astype(np.float16) + b).astype(np.float16),
                    lambda x, a, b: (x.astype(np.float32) * a + b).astype(np.float16)),
    # the IEEE divide, then the add; XLA: the reciprocal of 3 in one FMA
    "div.irregular.float32": (lambda x, a: _f32(_f32(x.astype(np.float64) / 3.0) + a),
                              lambda x, a: _f32(x.astype(np.float64) * _f32(1 / 3) + a)),
}


@pytest.mark.parametrize("name", list(COMPILED_DIFFER))
def test_rows_where_the_compiled_jax_chain_rounds_otherwise(name):
    """A stated divergence (ROADMAP Queue 3): on random inputs, one step of
    the port's plain chain is eager's formula and the JAX package's
    interpret-mode chain XLA's, bit for bit, and the two differ in some
    elements; on the row's own tile they agree at n 8 and 64
    (test_inkernel_chain_matches_pallas_interpret)."""
    spec, j = chains.spec_by_name(name), _jax_spec(name)
    rng = np.random.RandomState(3)
    np_dtype = np.float16 if spec.dtype == "float16" else np.float32
    args = [(rng.standard_normal(inkernel.default_tile(spec.dtype)) * 4).astype(np_dtype)
            for _ in range(1 + len(spec.operands))]
    ours, compiled = COMPILED_DIFFER[name]
    got = op_chain(*map(torch.from_numpy, args), step=name, n=1).numpy()
    want = np.asarray(jax_inkernel.build_chain(j, 1, interpret=True)(*args))
    assert got.tobytes() == ours(*args).tobytes()
    assert want.tobytes() == compiled(*args).tobytes()
    assert (got != want).sum() > 0


def test_k2_steps_are_the_registry_rows():
    """Every K2 step is a registry row, with its dtype and operand count; it
    has a step for each in-kernel row (and mul64hi, a table2 row)."""
    for name, (dtype, n_ops, _) in opchain.STEPS.items():
        spec = chains.spec_by_name(name)
        assert dtype == getattr(torch, spec.dtype) and n_ops == len(spec.operands), name
    assert set(opchain.STEPS) == set(NAMES) | {"mul64hi"}


def test_op_chain_timed_and_op_chain_refuse_bad_calls():
    carry, ops = inkernel.tiles(chains.spec_by_name("add"))
    with pytest.raises(RuntimeError, match="only on a CUDA card"):
        op_chain_timed(carry, *ops, step="add", n=8)
    with pytest.raises(ValueError, match="step must be one of"):
        op_chain_timed(carry, *ops, step="add.int128", n=8)
    with pytest.raises(ValueError, match="takes 2 operand"):
        op_chain(carry, ops[0], step="add", n=8)
    cos = inkernel.tiles(chains.spec_by_name("cos"))[0]
    assert torch.equal(op_chain(cos, step="cos", n=3), torch.cos(torch.cos(torch.cos(cos))))


# ------------------------------------------------------------ probe, plan
def test_named_plan_inkernel_matches_jax_probe_for_probe():
    t, j = named_plan("inkernel"), jax_plan.named_plan("inkernel")
    assert [p.logical_key() for p in t] == [p.logical_key() for p in j]
    assert [p.match_names() for p in t] == [p.match_names() for p in j]
    assert [p.category for p in t] == [p.category for p in j]
    assert len(t) == 116 and t.name == "inkernel" and "inkernel" in cli.PLAN_NAMES
    kept = t.filter(ops=["add"])
    assert [p.op for p in kept] == ["inkernel.add", "add"]
    jp = jax_plan.Plan.inkernel(ops=["sin", "popc"], dispatch_pair=False)
    assert [p.logical_key() for p in Plan.inkernel(ops=["sin", "popc"], dispatch_pair=False)] \
        == [p.logical_key() for p in jp]


@pytest.mark.parametrize("lens,shape", [(None, None), ((4, 32), None), (None, (16, 128)),
                                        ((8, 64), (8, 256)), ((2, 6), (4, 128))])
def test_kernel_chain_probe_names_match_jax(lens, shape):
    for name in ("add", "fma.bfloat16", "cos"):
        t = KernelChainProbe(chains.spec_by_name(name), lens=lens, shape=shape)
        j = jax_probes.KernelChainProbe(_jax_spec(name), lens=lens, shape=shape)
        assert (t.op, t.opt_level, t.dtype, t.category) == (j.op, j.opt_level, j.dtype,
                                                           j.category)
        assert t.match_names() == j.match_names() and t.logical_key() == j.logical_key()


def test_guard_is_netted_with_the_inkernel_add_baseline(monkeypatch, tmp_path):
    """A guarded row nets ``guard x`` the in-kernel add chain's latency /
    (1 + its guard), measured the same way, never the dispatch baselines."""
    monkeypatch.setattr(inkernel, "run_prepared_inkernel",
                        lambda prepared, timer, clock_hz=None: Measurement(6.0, 0.5, 6.0, 3))
    session = Session(db=str(tmp_path / "db.json"), device="cpu",
                      timer=Timer(warmup=0, reps=3, device="cpu"))

    def no_dispatch_baseline(*args, **kwargs):
        raise AssertionError("a dispatch baseline netted an in-kernel row")

    monkeypatch.setattr(session, "baseline_ns", no_dispatch_baseline)
    monkeypatch.setattr(session, "kernel_baseline_ns", no_dispatch_baseline)
    result = session.run(Plan.inkernel(ops=["sub", "bfe", "add.float32"],
                                       dispatch_pair=False))
    assert not result.failed, [r.failure for r in result.failed]
    recs = {r.op: r for r in result.records()}
    assert recs["inkernel.sub"].net_latency_ns == pytest.approx(6.0 - 1 * 3.0)
    assert recs["inkernel.bfe"].net_latency_ns == pytest.approx(6.0 - 2 * 3.0)
    assert recs["inkernel.add.float32"].net_latency_ns == pytest.approx(6.0)
    assert recs["inkernel.bfe"].notes == "plain op_chain lens=8-64 tile=8x128 clock=host"


# ------------------------------------------------------------- cycles clock
def test_cpu_session_counts_cycles_on_the_host_pseudo_clock(monkeypatch, tmp_path):
    def no_sm_clock(*args):
        raise AssertionError("the CPU read an SM clock")

    monkeypatch.setattr(session_mod, "sm_clock_hz", no_sm_clock)
    monkeypatch.setattr(Timer, "calibrate_clock_hz", lambda self: 1.25e9)
    monkeypatch.setattr(inkernel, "run_prepared_inkernel",
                        lambda prepared, timer, clock_hz=None: Measurement(6.0, 0.5, 6.0, 3))
    session = Session(db=str(tmp_path / "db.json"), device="cpu",
                      timer=Timer(warmup=0, reps=3, device="cpu"))
    assert session.clock_hz() == 1.25e9 and session._context().clock_hz == 1.25e9
    result = session.run(Plan.inkernel(ops=["add"], dispatch_pair=False))
    (rec,) = result.records()
    assert rec.latency_ns == 6.0 and rec.cycles == pytest.approx(7.5)
    assert "cycles_at" not in rec.notes and rec.notes.endswith("clock=host")


def test_card_records_name_the_sm_clock_of_their_cycles():
    """On the card a record's ``cycles`` count at the session's SM clock,
    and its notes say so; the clock that timed it stays last."""
    ctx = ProbeContext(timer=Timer(device="cpu"), env=current_environment("cpu"),
                       clock_hz=1.98e9, baseline_ns=lambda lv: 0.0,
                       kernel_baseline_ns=lambda: 0.0, device=torch.device("cuda", 0))
    rec = Probe()._record(ctx, Measurement(5.0, 1.0, 5.0, 5), clock="events")
    assert rec.cycles == pytest.approx(9.9)
    assert rec.notes.split() == ["cycles_at=sm_clock64@1980", "clock=events"]


# ------------------------------------------------------------------ pairing
def _records(env_a, env_b):
    """Dispatch and in-kernel rows: a pair in env_a, the in-kernel half of a
    pair in env_b only, a fidelity-suffixed row, a memory pair, an O0 row."""
    rows = [(env_a, "add", "O3", 400.0), (env_a, "inkernel.add", "O3", 2.0),
            (env_a, "inkernel.add.l4-32", "O3", 2.5), (env_a, "sin", "O3", 180.0),
            (env_b, "inkernel.sin", "O3", 30.0), (env_a, "mem.chase.ws8192", "O3", 20.0),
            (env_a, "inkernel.mem.8192", "O3", 10.0), (env_a, "popc", "O0", 2000.0),
            (env_a, "inkernel.popc", "O3", 4.0), (env_b, "popc", "O3", 11.0),
            (env_a, "fma.bfloat16", "O3", 4.0), (env_a, "inkernel.fma.bfloat16", "O3", 0.0)]
    out = []
    for env, op, level, ns in rows:
        base = op.removeprefix("inkernel.").split(".l4")[0]
        spec = next((s for s in chains.default_registry() if s.name == base), None)
        out.append(dict(op=op, category=spec.category if spec else "memory",
                        dtype=spec.dtype if spec else "int32", opt_level=level,
                        latency_ns=ns, mad_ns=ns / 10, cycles=ns * 2, guard=0,
                        net_latency_ns=ns, n_samples=5, **env))
    return out


def test_compare_markdown_pairs_like_the_jax_package():
    """Only the same dtype, opt level and environment pair; a
    fidelity-suffixed row does not; ``inkernel.mem.<N>`` pairs with
    ``mem.chase.ws<N>``; the table is the JAX package's, character for
    character."""
    env_a = dict(device_kind="NVIDIA H100 80GB HBM3", backend="cuda",
                 jax_version="torch-2.11.0+cu12.8")
    env_b = dict(env_a, device_kind="cpu", backend="cpu")
    ours, theirs = LatencyDB(), jax_latency_db.LatencyDB()
    for raw in _records(env_a, env_b):
        ours.add(LatencyRecord(**raw))
        theirs.add(jax_latency_db.LatencyRecord(**raw))
    table = ours.compare_markdown()
    assert table == theirs.compare_markdown()
    paired = [line.split(" | ")[1] for line in table.splitlines()[2:]]
    assert paired == ["fma.bfloat16", "add", "mem.chase.ws8192"]
    assert "| 0.005 |" in table and "| — |" not in table
    assert ours.compare_markdown(opt_level="O0").count("\n") == 1  # header only
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ours.compare_markdown(prefix="coll.")


# -------------------------------------------------------------------- CLI
def test_inkernel_cli_on_cpu_prints_the_pairing(tmp_path, monkeypatch, capsys):
    """``characterize --plan inkernel --table --ops add,popc,fma.float32`` on
    the CPU, the dispatch twins' O3 chains cut to (4, 8): every in-kernel row
    is measured on the plain chain, each twin ends as a record or as a
    NoisySlopeError of a few-op O3 chain on the host clock, the pairing
    table holds every row measured both ways, and a second run is cache
    hits."""
    monkeypatch.setattr(measure, "_CHAIN_LENS", {"O0": (2, 4), "O3": (4, 8)})
    db_path = tmp_path / "inkernel.json"
    args = ["characterize", "--plan", "inkernel", "--db", str(db_path), "--device", "cpu",
            "--reps", "5", "--warmup", "1", "--ops", "add,popc,fma.float32", "--table"]
    rc = cli.main(args)
    out = capsys.readouterr().out
    db = LatencyDB(str(db_path))
    rows = {r.op: r for r in db.records()}
    failed = {f.op: f for f in db.failures()}
    assert set(rows) | set(failed) == {"add", "popc", "fma.float32", "inkernel.add",
                                       "inkernel.popc", "inkernel.fma.float32"}
    assert {"inkernel.add", "inkernel.popc", "inkernel.fma.float32"} <= set(rows)
    assert all(f.error_type == "NoisySlopeError" for f in failed.values())
    assert rc == (1 if failed else 0)
    for name in ("add", "popc", "fma.float32"):
        rec = rows[f"inkernel.{name}"]
        assert rec.opt_level == "O3" and rec.latency_ns > 0
        assert re.fullmatch(r"plain op_chain lens=8-64 tile=8x128( clamped=1)? clock=host",
                            rec.notes), rec.notes
    assert "== host vs in-kernel (paper's in-pipeline method) ==" in out
    pairing = out.split("== host vs in-kernel")[1]
    for name in ("add", "popc", "fma.float32"):
        assert (f"| {name} |" in pairing) == (name in rows), name
    cli.main(args)  # resume: every record is a cache hit; failed rows run again
    m = re.search(r"(\d+) measured, (\d+) cached, (\d+) failed \(6 probes\)",
                  capsys.readouterr().out)
    assert m and int(m[2]) == len(rows) and int(m[1]) + int(m[3]) == len(failed)
