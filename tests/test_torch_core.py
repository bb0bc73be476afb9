"""Port parity for the measurement core: the ring, the quick rows' chains,
the timer's slope algebra, the LatencyDB format and the quick plan, held
against the JAX package on the same inputs.

Tolerances: integer chains bit-exact; float chains within 2 ulp (sqrt,
rsqrt, sin and exp2 are not correctly rounded in either library, and each
step contracts the error, so it does not grow with the chain).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch


from repro.api import plan as jax_plan
from repro.core import chains as jax_chains
from repro.core import latency_db as jax_db
from repro.core import membench as jax_membench
from repro_torch.api import plan as torch_plan
from repro_torch.core import chains, latency_db, measure, membench
from repro_torch.core import timing
from repro_torch.core.timing import (AdaptiveFidelity, Measurement,
                                     NoisySlopeError, Timer, _summarize)

FLOAT_ULPS = 2
JAX_ROWS = {s.name: s for s in jax_chains.default_registry()}


# ---------------------------------------------------------------- the ring
@pytest.mark.parametrize("ws,line,seed", [(4096, 64, 0), (1 << 17, 64, 0),
                                          (1 << 21, 64, 0), (8192, 128, 7),
                                          (100, 64, 3)])
def test_build_ring_identical_to_jax(ws, line, seed):
    ring_j, start_j = jax_membench.build_ring(ws, line, seed)
    ring, start = membench.build_ring(ws, line, seed, device="cpu")
    assert ring.dtype == torch.int32 and start.dtype == torch.int32
    np.testing.assert_array_equal(ring.numpy(), np.asarray(ring_j))
    np.testing.assert_array_equal(start.numpy(), np.asarray(start_j))


def test_ring_is_one_cycle_over_live_slots():
    ring, start = membench.build_ring(1 << 14, device="cpu")
    r, p, seen = ring.tolist(), int(start[0]), set()
    for _ in range(len(r) // 16):
        seen.add(p)
        p = r[p]
    assert p == int(start[0]) and len(seen) == len(r) // 16


# ---------------------------------------------------------- the quick rows
def test_registry_rows_match_jax_rows():
    rows = chains.default_registry()
    assert tuple(r.name for r in rows) == tuple(s.name for s in jax_chains.default_registry())
    for r in rows:
        j = JAX_ROWS[r.name]
        for field in ("category", "dtype", "init", "operands", "guard", "notes",
                      "max_chain"):
            assert getattr(r, field) == getattr(j, field), (r.name, field)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    bits = {2: np.int16, 4: np.int32}[a.dtype.itemsize]
    return int(np.max(np.abs(a.view(bits).astype(np.int64) - b.view(bits).astype(np.int64))))


@pytest.mark.parametrize("name", torch_plan.QUICK_OPS)
def test_quick_row_chain_matches_jax_chain_fn(name):
    spec, j = chains.spec_by_name(name), JAX_ROWS[name]
    for n in (1, 16, 256):
        want = np.asarray(jax_chains.chain_fn(j, n)(j.carry(), *j.operand_arrays()))
        got = chains.chain_fn(spec, n)(spec.carry("cpu"), *spec.operand_tensors("cpu"))
        assert got.shape == () and str(got.dtype) == f"torch.{spec.dtype}"
        if spec.dtype == "bfloat16":
            assert _ulps(got.view(torch.int16).numpy(), want.view(np.int16)) <= FLOAT_ULPS
        elif got.is_floating_point():
            assert _ulps(got.numpy(), want) <= FLOAT_ULPS, (name, n)
        else:
            assert int(got) == int(want), (name, n)


@pytest.mark.parametrize("name", ["popc", "clz"])
def test_kernel_rows_o3_chain_is_one_launch_of_the_same_chain(name):
    spec = chains.spec_by_name(name)
    x, ops = spec.carry("cpu"), spec.operand_tensors("cpu")
    o0 = measure.compile_chain(spec, 64, "O0")(x, *ops)
    o3 = measure.compile_chain(spec, 64, "O3")(x, *ops)
    assert int(o0) == int(o3)


@pytest.mark.parametrize("name", torch_plan.QUICK_OPS)
def test_quick_row_inputs_are_the_jax_inputs_bit_for_bit(name):
    spec, j = chains.spec_by_name(name), JAX_ROWS[name]
    got = (spec.carry("cpu"), *spec.operand_tensors("cpu"))
    want = (j.carry(), *j.operand_arrays())
    for g, w in zip(got, want, strict=True):
        assert g.shape == () and g.element_size() == w.dtype.itemsize
        assert g.reshape(1).view(torch.uint8).numpy().tobytes() == np.asarray(w).tobytes(), name


# ------------------------------------------------------------------- timer
def _virtual_clock(monkeypatch):
    now = [0]
    monkeypatch.setattr(timing.time, "perf_counter_ns", lambda: now[0])
    return now


def test_summarize_and_measurement_algebra():
    m = _summarize([10.0, 20.0, 30.0])
    assert (m.median_ns, m.mad_ns, m.min_ns, m.n) == (20.0, 10.0, 10.0, 3)
    d = Measurement(100.0, 3.0, 90.0, 10) - Measurement(40.0, 4.0, 35.0, 8)
    assert (d.median_ns, d.min_ns, d.n) == (60.0, 55.0, 8)
    assert d.mad_ns == pytest.approx(5.0)
    s = Measurement(100.0, 8.0, 90.0, 10).scaled(0.25)
    assert (s.median_ns, s.mad_ns, s.min_ns, s.n) == (25.0, 2.0, 22.5, 10)


def test_timer_clock_follows_device():
    assert Timer(device="cpu").clock == "host"
    if torch.cuda.is_available():
        assert Timer(device="cuda:0").clock == "events"
    else:  # the card is asked for and absent: no timer on the host clock
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Timer(device="cuda:0")


@pytest.mark.parametrize("build", [
    lambda: Timer().device,
    lambda: measure.prepare_op(chains.spec_by_name("add"), "O0").device,
    lambda: membench.build_ring(4096)[0].device,
    lambda: membench.prepare_chase(4096, steps=(4, 8)).ring.device,
], ids=["Timer", "prepare_op", "build_ring", "prepare_chase"])
def test_building_blocks_default_to_the_card(build):
    """With no device named, a building block runs on cuda:0, as the entry
    points do; without a card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert build() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_slope_exact_on_synthetic_linear_cost(monkeypatch):
    now = _virtual_clock(monkeypatch)
    SLOPE, INTERCEPT = 700, 50_000

    def fn_by_len(n):
        def fn():
            now[0] += INTERCEPT + SLOPE * n
        return fn

    est = Timer(device="cpu", warmup=1, reps=4).slope(fn_by_len, 8, 64)
    assert est.median_ns == pytest.approx(SLOPE)
    assert est.min_ns == pytest.approx(SLOPE)
    assert est.mad_ns == 0.0 and est.n == 4


def test_slope_raises_noisy_after_widened_retry(monkeypatch):
    now = _virtual_clock(monkeypatch)

    def fn_by_len(n):  # cost independent of chain length
        return lambda: now.__setitem__(0, now[0] + 50_000)

    with pytest.raises(NoisySlopeError, match="widened retry"):
        Timer(device="cpu", warmup=0, reps=3).slope(fn_by_len, 8, 64)


def test_slope_retry_disabled_when_lens_capped(monkeypatch):
    now = _virtual_clock(monkeypatch)

    def fn_by_len(n):
        return lambda: now.__setitem__(0, now[0] + 50_000)

    with pytest.raises(NoisySlopeError) as ei:
        Timer(device="cpu", warmup=0, reps=3).slope(fn_by_len, 8, 64, retry_lens=(8, 64))
    assert "widened retry" not in str(ei.value)


def test_slope_retry_recovers_at_widened_spread(monkeypatch):
    now = _virtual_clock(monkeypatch)

    def fn_by_len(n):
        cost = 50_000 if n < 100 else 1000 * n
        return lambda: now.__setitem__(0, now[0] + cost)

    est = Timer(device="cpu", warmup=0, reps=3).slope(fn_by_len, 8, 64)
    assert est.median_ns == pytest.approx((1000 * 232 - 50_000) / (232 - 8))
    assert est.retry_lens == (8, 232)


def test_record_notes_name_the_widened_retry():
    from repro_torch.api.probes import ProbeContext, Probe
    from repro_torch.core.latency_db import current_environment
    ctx = ProbeContext(timer=Timer(device="cpu"), env=current_environment("cpu"),
                       clock_hz=1e9, baseline_ns=lambda lv: 0.0,
                       kernel_baseline_ns=lambda: 0.0, device=torch.device("cpu"),
                       adaptive=False)
    probe = Probe()
    plain = probe._record(ctx, Measurement(5.0, 1.0, 5.0, 5))
    retried = probe._record(ctx, Measurement(5.0, 1.0, 5.0, 5, retry_lens=(8, 232)))
    assert "retry_lens" not in plain.notes
    assert "retry_lens=8-232" in retried.notes.split()
    assert retried.notes.endswith("clock=host")


def test_retry_lens_for_caps_at_max_chain():
    spec = chains.spec_by_name("add")
    assert measure.retry_lens_for(spec, 8, 64) == (8, 232)
    assert measure.retry_lens_for(dataclasses.replace(spec, max_chain=100), 8, 64) == (8, 100)
    assert measure.retry_lens_for(dataclasses.replace(spec, max_chain=64), 8, 64) == (8, 64)


def test_adaptive_convergence_banks_and_spends(monkeypatch):
    af = AdaptiveFidelity(rel_mad=0.05, min_reps=4)
    assert not af.converged([100.0] * 3) and af.converged([100.0] * 4)
    assert not af.converged([0.0] * 8)
    now = _virtual_clock(monkeypatch)
    t = Timer(device="cpu", warmup=0, reps=10, adaptive=AdaptiveFidelity(min_reps=4))
    quiet = t.time_callable(lambda: now.__setitem__(0, now[0] + 1000))
    assert quiet.n == 4 and t._rep_bank == 6
    state = [0]

    def noisy():
        state[0] += 1
        now[0] += 1000 * state[0]

    assert t.time_callable(noisy).n == 16 and t._rep_bank == 0
    assert Timer(device="cpu", warmup=0, reps=10).time_callable(
        lambda: now.__setitem__(0, now[0] + 1000)).n == 10


# --------------------------------------------------------------- LatencyDB
def _jax_record(op="add", ns=7.0, at="2026-01-01T00:00:00"):
    return jax_db.LatencyRecord(
        op=op, category="int_arith", dtype="int32", opt_level="O3",
        latency_ns=ns, mad_ns=0.25, cycles=ns, guard=1, net_latency_ns=ns / 2,
        device_kind="cpu", backend="cpu", jax_version="0.9.0", n_samples=30,
        measured_at=at)


def test_record_schema_is_the_jax_schema():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(latency_db.LatencyRecord) == names(jax_db.LatencyRecord)
    assert names(latency_db.ProbeFailure) == names(jax_db.ProbeFailure)


def test_each_package_reads_the_others_db(tmp_path):
    tdb = latency_db.LatencyDB()
    tdb.add(_torch_record())
    tdb.add_failure(latency_db.ProbeFailure(
        op="popc", dtype="uint32", opt_level="O0",
        device_kind="NVIDIA H100 80GB HBM3", backend="cuda",
        jax_version="torch-2.9.0+cu12.8", error_type="NoisySlopeError",
        message="m", failed_at="t"))
    tpath = str(tmp_path / "torch.json")
    tdb.save(tpath)
    read_by_jax = jax_db.LatencyDB(tpath)
    assert [r.key() for r in read_by_jax.records()] == [r.key() for r in tdb.records()]
    assert [f.key() for f in read_by_jax.failures()] == [f.key() for f in tdb.failures()]

    jdb = jax_db.LatencyDB()
    jdb.add(_jax_record())
    jpath = str(tmp_path / "jax.json")
    jdb.save(jpath)
    jdb.add(_jax_record("mul"))
    jdb.flush(jpath)  # a journal line too
    read_by_torch = latency_db.LatencyDB(jpath)
    assert {r.op for r in read_by_torch.records()} == {"add", "mul"}

    merged = latency_db.LatencyDB(tpath).merge(read_by_torch)
    assert len(merged) == 3  # the TPU/CPU and H100 rows side by side
    merged.save(str(tmp_path / "merged.json"))
    blob = json.loads((tmp_path / "merged.json").read_text())
    assert {r["backend"] for r in blob["records"]} == {"cpu", "cuda"}
    assert "| int_arith | add | int32 |" in merged.table_markdown()


def _torch_record():
    """An H100 row as the port writes it."""
    return latency_db.LatencyRecord(**{**dataclasses.asdict(_jax_record()), **{
        "device_kind": "NVIDIA H100 80GB HBM3", "backend": "cuda",
        "jax_version": "torch-2.9.0+cu12.8", "notes": "clock=events"}})


def test_current_environment_names_the_torch_build():
    env = latency_db.current_environment("cpu")
    assert env == {"device_kind": "cpu", "backend": "cpu",
                   "jax_version": "torch-" + torch.__version__.split("+")[0] + "+cpu"}


# -------------------------------------------------------------------- plan
def test_quick_plan_logical_keys_match_jax_in_order():
    jax_keys = [p.logical_key() for p in jax_plan.named_plan("quick")]
    torch_keys = [p.logical_key() for p in torch_plan.named_plan("quick")]
    assert torch_keys == jax_keys
    assert len(torch_keys) == 36


def test_plan_algebra_matches_jax():
    for ops, levels in ((("add", "mul"), ("O0", "O3")), (("popc",), ("O3",))):
        j = jax_plan.Plan.instructions(ops=ops, opt_levels=levels)
        t = torch_plan.Plan.instructions(ops=ops, opt_levels=levels)
        assert [p.logical_key() for p in t + t] == [p.logical_key() for p in j + j]
    quick = torch_plan.named_plan("quick")
    assert {p.op for p in quick.filter(ops=["mem"])} == {
        "mem.chase.ws8192.s512-1536", "mem.chase.ws131072.s512-1536",
        "mem.chase.ws2097152.s512-1536"}
    assert len(quick.filter(opt_levels=["O0"])) == 16


@pytest.mark.parametrize("name", ["collectives", "full"])
def test_unported_plans_raise(name):
    with pytest.raises(ValueError, match="not ported yet"):
        torch_plan.named_plan(name)
    with pytest.raises(ValueError, match="unknown plan"):
        torch_plan.named_plan("nope")


# ------------------------------------------------------------------- utils
@pytest.mark.parametrize("samples,ps", [([5.0], (0, 50, 100)), (list(range(1, 101)), (50, 90, 99)),
                                        ([3.0, 1.0, 2.0, 2.0], (10, 50, 75))])
def test_percentiles_match_jax_utils(samples, ps):
    from repro import utils as jax_utils
    from repro_torch import utils

    assert utils.percentiles(samples, ps) == jax_utils.percentiles(samples, ps)
    with pytest.raises(ValueError):
        utils.percentiles([], ps)


@pytest.mark.parametrize("notes", ["", "ws=8192 line=64 space=vmem", "free text k=v =x a==b",
                                   "clock=events kernel=op_chain.popc launch=per-step"])
def test_parse_kv_notes_and_markdown_match_jax_utils(notes):
    from repro import utils as jax_utils
    from repro_torch import utils

    assert utils.parse_kv_notes(notes) == jax_utils.parse_kv_notes(notes)
    rows = [[notes, 1, 2.5]]
    assert utils.markdown_table(["a", "b", "c"], rows) == \
        jax_utils.markdown_table(["a", "b", "c"], rows)


def test_dump_json_is_atomic_and_round_trips(tmp_path):
    from repro_torch import utils

    path = str(tmp_path / "sub" / "x.json")
    obj = {"a": np.int32(3), "b": np.float32(0.5), "c": np.arange(3), "d": [1, "x"]}
    utils.dump_json(obj, path)
    assert utils.load_json(path) == {"a": 3, "b": 0.5, "c": [0, 1, 2], "d": [1, "x"]}
    assert [p.name for p in (tmp_path / "sub").iterdir()] == ["x.json"]


def test_from_numpy_keeps_dtype_and_bits():
    from repro_torch.utils import from_numpy

    tree = {"u": np.array([0xFFFFFFFF, 1], np.uint32), "f": (np.float32(1.5), [np.int32(-2)])}
    out = from_numpy(tree, "cpu")
    assert out["u"].dtype == torch.uint32 and out["u"].tolist() == [0xFFFFFFFF, 1]
    assert out["f"][0].dtype == torch.float32 and float(out["f"][0]) == 1.5
    assert out["f"][1][0].dtype == torch.int32 and int(out["f"][1][0]) == -2
