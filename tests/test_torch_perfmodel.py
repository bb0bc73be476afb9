"""The port's performance model (``repro_torch.core.hlo_analysis`` and
``repro_torch.core.perfmodel``) against the JAX package's on the CPU.

The oracle tests are those of ``tests/test_perfmodel.py`` on op records in
the place of hand-written HLO: each expected nanosecond is computed by hand
from the documented pricing rules (lanes 8, ``THROUGHPUT_FACTOR`` 0.25,
``default_ns`` 5, 8 memory streams). The parity tests feed the port's
pricing core the numbers of a JAX ``ModuleCost`` and hold every field of its
report to the JAX estimator's on the same rows (rel 1e-12); the roofline is
held to the JAX package's the same way.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import hlo_analysis as jax_hlo
from repro.core import latency_db as jax_latency_db
from repro.core import perfmodel as jax_perfmodel
from repro_torch.audit import lint
from repro_torch.core import chains, hlo_analysis, perfmodel
from repro_torch.core.latency_db import LatencyDB, LatencyRecord
from repro_torch.kernels import ops

REL = 1e-12
ENV = {"device_kind": "cpu", "backend": "cpu", "jax_version": "x"}


def _raw(op, ns, cat="fp32", dtype="float32", opt="O3", notes="", env=None):
    return dict(op=op, category=cat, dtype=dtype, opt_level=opt, latency_ns=ns, mad_ns=0,
                cycles=ns, guard=0, net_latency_ns=ns, n_samples=5, measured_at="t",
                notes=notes, **(env or ENV))


def _db(*raws):
    db = LatencyDB()
    for raw in raws:
        db.add(LatencyRecord(**raw))
    return db


def _f32(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(shape)
                            .astype(np.float32))


def _add_record():
    return hlo_analysis.record_ops(torch.add, _f32(256), _f32(256, seed=1))


def _loop_record():
    """The counterpart of the JAX oracle's while loop (5 trips of a
    tanh(f32[8]) and a scalar add): an eager loop issues every trip."""
    def f(x, i):
        for _ in range(5):
            x = torch.tanh(x)
            i = i + 1
        return x, i
    return hlo_analysis.record_ops(f, _f32(8), torch.zeros((), dtype=torch.int32))


# ================================================================== record
def test_record_counts_ops_elements_and_bytes():
    rec = _add_record()
    assert dict(rec.histogram) == {("add", 256): 1}
    assert rec.bytes == 3 * 1024          # two inputs read, one output written
    assert rec.sites == [] and rec.matmul_flops == 0.0
    assert hlo_analysis.op_histogram(rec) == rec.histogram


def test_record_is_dynamic_without_trip_counts():
    rec = _loop_record()
    assert rec.histogram[("tanh", 8)] == 5
    assert rec.histogram[("add", 1)] == 5


def test_record_matmul_flops_follow_the_dot_convention():
    a, b = _f32(4, 8), _f32(8, 16, seed=1)
    rec = hlo_analysis.record_ops(torch.mm, a, b)
    assert rec.matmul_flops == 2 * 4 * 16 * 8 and dict(rec.histogram) == {("mm", 64): 1}
    bias, x, w = _f32(3, 5), _f32(3, 7, seed=1), _f32(7, 5, seed=2)
    assert hlo_analysis.record_ops(torch.addmm, bias, x, w).matmul_flops == 2 * 3 * 5 * 7
    rec = hlo_analysis.record_ops(torch.einsum, "bij,bjk->bik", _f32(2, 3, 4), _f32(2, 4, 6))
    assert rec.matmul_flops == 2 * 2 * 3 * 6 * 4


def test_compound_ops_count_as_the_ops_they_expand_to():
    """silu and softmax are one ATen op each in eager and several opcodes in
    an HLO module: the record holds what they expand to."""
    rec = hlo_analysis.record_ops(torch.nn.functional.silu, _f32(4, 8))
    assert {op for op, _ in rec.histogram} == {"sigmoid", "mul"}
    assert rec.bytes == 2 * 128            # the eager op's own input and output
    rec = hlo_analysis.record_ops(torch.softmax, _f32(4, 8), -1)
    ops_ = {op for op, _ in rec.histogram}
    assert {"amax", "sub", "exp", "sum", "div"} <= ops_


def test_views_and_allocations_move_no_bytes_and_in_place_writes_count_once():
    x = _f32(4, 8)
    rec = hlo_analysis.record_ops(lambda t: t.view(8, 4).permute(1, 0), x)
    assert rec.bytes == 0
    dst, src = torch.zeros(4, 8), _f32(4, 8)
    rec = hlo_analysis.record_ops(lambda d, s: d.copy_(s), dst, src)
    assert rec.bytes == 2 * 128            # src read, dst written once
    cache, upd = torch.zeros(64, 8), _f32(1, 8)
    rec = hlo_analysis.record_ops(lambda c, u: c.index_copy_(0, torch.tensor([3]), u),
                                  cache, upd)
    assert rec.bytes == 8 + 2 * 32         # index and update read, update written


def test_kernel_sites_hide_their_inner_ops_and_record_the_call_bytes():
    x, w = _f32(16, 64), torch.ones(64)

    def f(x, w):
        return ops.rmsnorm(torch.tanh(x), w) * 2.0
    rec = hlo_analysis.record_ops(f, x, w)
    assert [s.name for s in rec.sites] == ["rmsnorm"]
    assert rec.sites[0].bytes == 16 * 64 * 4 + 64 * 4 + 16 * 64 * 4   # x and w in, y out
    assert {op for op, _ in rec.histogram} == {"tanh", "mul"}
    from repro_torch.kernels import rmsnorm as k4
    assert ops.rmsnorm is k4.rmsnorm      # the hook is gone after the record


# ========================================================== estimator oracles
def test_oracle_lane_amortization():
    r = perfmodel.RecordLatencyEstimator(_db(_raw("add.float32", 2.0))).estimate(_add_record())
    assert r.compute_ns == pytest.approx(2.0 + (255 / 8) * 0.25 * 2.0)
    assert r.compute_ns == pytest.approx(17.9375)
    assert r.coverage == 1.0
    assert r.memory_ns == 0.0               # no ladder in the DB
    assert r.total_ns == r.compute_ns


def test_oracle_loop_counts():
    """5 tanh(f32[8]) + 5 add(int[]): 5 * (10 + 7/8*0.25*10) + 5 * 2."""
    db = _db(_raw("tanh", 10.0, cat="special_math"), _raw("add.float32", 2.0))
    r = perfmodel.RecordLatencyEstimator(db).estimate(_loop_record())
    assert r.compute_ns == pytest.approx(70.9375)
    assert r.coverage == 1.0 and r.priced_instances == 10.0
    assert r.by_class["special_math"].ns == pytest.approx(60.9375)
    assert r.by_class["special_math"].instances == 5.0
    assert r.by_class["fp32"].ns == pytest.approx(10.0)


def test_oracle_matmul_fma_pricing():
    """mm [4,8]x[8,16]: 1024 FLOPs = 512 fma issues: 4 + 511/8*0.25*4."""
    rec = hlo_analysis.record_ops(torch.mm, _f32(4, 8), _f32(8, 16, seed=1))
    r = perfmodel.RecordLatencyEstimator(_db(_raw("fma.float32", 4.0))).estimate(rec)
    assert r.compute_ns == pytest.approx(67.875)
    assert r.by_class["matmul"].instances == 1.0
    assert r.by_class["matmul"].elements == pytest.approx(512.0)
    assert r.coverage == 1.0


def test_oracle_memory_term():
    """3072 bytes off the ws4096 rung (6.4 ns a 64-byte line) over 8 streams."""
    db = _db(_raw("add.float32", 2.0),
             _raw("mem.chase.ws4096", 6.4, cat="memory", dtype="int32",
                  notes="cold_ns=1 stride=64"))
    r = perfmodel.RecordLatencyEstimator(db).estimate(_add_record())
    assert r.bytes_accessed == 3072.0
    assert r.memory_ns == pytest.approx(38.4)
    assert r.total_ns == pytest.approx(38.4) and r.bound == "memory"


def test_memory_ladder_rung_selection_and_inkernel_preference():
    db = _db(_raw("mem.chase.ws4096", 4.0, cat="memory", dtype="int32", notes="stride=64"),
             _raw("mem.chase.ws1048576", 40.0, cat="memory", dtype="int32",
                  notes="stride=64"),
             _raw("inkernel.mem.4096", 2.0, cat="memory", dtype="int32",
                  notes="ws=4096 line=64 space=smem"),
             _raw("inkernel.mem.4096.smem", 99.0, cat="memory", dtype="int32",
                  notes="ws=4096 line=64 space=smem"))
    est = perfmodel.RecordLatencyEstimator(db)
    assert [(g.working_set_bytes, g.ns_per_line, g.source) for g in est.memory_ladder()] \
        == [(4096, 2.0, "inkernel"), (1048576, 40.0, "host")]
    assert est._memory_ns(3072) == pytest.approx(12.0)
    assert est._memory_ns(1 << 21) == pytest.approx((1 << 21) * (40 / 64) / 8)


def test_oracle_coverage_fraction():
    """tanh is measured; floor has no table row: default-priced, unpriced."""
    rec = hlo_analysis.record_ops(lambda x: torch.floor(torch.tanh(x)), _f32(8))
    est = perfmodel.RecordLatencyEstimator(_db(_raw("tanh", 10.0, cat="special_math")),
                                           default_ns=5.0)
    r = est.estimate(rec)
    assert r.coverage == pytest.approx(0.5)
    assert r.priced_instances == 1.0 and r.unpriced_instances == 1.0
    assert dict(r.unpriced_opcodes) == {"floor": 1.0}
    per_op = 7 / 8 * 0.25
    assert r.compute_ns == pytest.approx(10 * (1 + per_op) + 5 * (1 + per_op))
    assert r.by_class["unpriced"].ns == pytest.approx(5 * (1 + per_op))


def test_mapped_but_unmeasured_counts_as_unpriced():
    est = perfmodel.RecordLatencyEstimator(LatencyDB(), default_ns=3.0)
    r = est.estimate(_add_record())
    assert r.coverage == 0.0
    assert dict(r.unpriced_opcodes) == {"add": 1.0}
    assert r.compute_ns == pytest.approx(3.0 * (1 + (255 / 8) * 0.25))


def _site_record():
    return hlo_analysis.record_ops(lambda x, w: ops.rmsnorm(torch.tanh(x), w),
                                   _f32(8, 64), torch.ones(64))


def test_kernel_site_without_a_fused_row_is_unpriced():
    r = perfmodel.RecordLatencyEstimator(_db(_raw("tanh", 10.0, cat="special_math"))
                                         ).estimate(_site_record())
    assert r.coverage == pytest.approx(0.5)
    assert dict(r.unpriced_opcodes) == {"kernel:rmsnorm": 1.0}
    assert r.by_class["unpriced"].ns == pytest.approx(5.0)


def test_kernel_site_with_a_fused_row_is_priced_by_its_bytes():
    rec = _site_record()
    site_bytes = rec.sites[0].bytes
    db = _db(_raw("tanh", 10.0, cat="special_math"),
             _raw("inkernel.fused.rmsnorm", 16.0, cat="kernel",
                  notes="cuda fused kernel lens=2-6 unit_bytes=4096"))
    r = perfmodel.RecordLatencyEstimator(db).estimate(rec)
    assert r.coverage == 1.0 and r.unpriced_opcodes == ()
    assert r.by_class["fused:rmsnorm"].ns == pytest.approx(site_bytes / 4096 * 16.0)
    # a row without unit_bytes falls back on the port's own count of them
    from repro_torch import inkernel
    db = _db(_raw("inkernel.fused.rmsnorm", 16.0, cat="kernel", notes="lens=2-6"))
    r = perfmodel.RecordLatencyEstimator(db).estimate(rec)
    assert r.by_class["fused:rmsnorm"].ns == pytest.approx(
        site_bytes / inkernel.unit_bytes("rmsnorm") * 16.0)


def test_structural_ops_do_not_count():
    def f(x):
        y = torch.cat([x, x]).reshape(4, 8).t().contiguous()
        return torch.tanh(y)
    rec = hlo_analysis.record_ops(f, _f32(16))
    r = perfmodel.RecordLatencyEstimator(_db(_raw("tanh", 10.0, cat="special_math"))
                                         ).estimate(rec)
    assert r.priced_instances + r.unpriced_instances == 1.0
    assert r.bytes_accessed > 0            # cat and the copy moved bytes


def test_estimate_ns_attaches_report():
    ns = perfmodel.RecordLatencyEstimator(_db(_raw("add.float32", 2.0))
                                          ).estimate_ns(_add_record())
    assert isinstance(ns, float) and ns > 0
    assert ns.report.coverage == 1.0 and float(ns) == ns.report.total_ns
    assert "coverage" in ns.report.summary()


def test_estimator_env_filters():
    other = {"device_kind": "tpu", "backend": "tpu", "jax_version": "y"}
    db = _db(_raw("add.float32", 100.0, env=other), _raw("add.float32", 2.0))
    est = perfmodel.RecordLatencyEstimator(db, filters=ENV)
    assert est.estimate(_add_record()).compute_ns == pytest.approx(17.9375)
    est_tpu = perfmodel.RecordLatencyEstimator(db, filters=other)
    assert est_tpu.estimate(_add_record()).compute_ns > 100.0


# ============================================================ pricing parity
ELEMWISE_HLO = """
HloModule elemwise

ENTRY %main (a: f32[256], b: f32[256]) -> f32[256] {
  %a = f32[256] parameter(0)
  %b = f32[256] parameter(1)
  ROOT %s = f32[256] add(f32[256] %a, f32[256] %b)
}
"""

CUSTOM_CALL_HLO = """
HloModule opaque

ENTRY %main (a: f32[8]) -> f32[8] {
  %a = f32[8] parameter(0)
  %t = f32[8] tanh(f32[8] %a)
  %k = f32[8] custom-call(f32[8] %t), custom_call_target="my_kernel"
  ROOT %f = f32[8] custom-call(f32[8] %k), custom_call_target="flash_attention"
}
"""


def _scan_hlo():
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w) * jnp.exp(c) - jnp.floor(c), None
        return lax.scan(body, x, None, length=8)[0]
    x = jax.ShapeDtypeStruct((16, 32), jnp.float32)
    w = jax.ShapeDtypeStruct((32, 32), jnp.float32)
    return jax.jit(f).lower(x, w).compile().as_text()


def _pricing_rows():
    rows = [_raw("add.float32", 2.0), _raw("tanh", 10.0, cat="special_math"),
            _raw("fma.float32", 4.0), _raw("ex2", 7.5, cat="special_math"),
            _raw("mul.float32", 3.0),
            _raw("mem.chase.ws4096", 6.4, cat="memory", dtype="int32", notes="stride=64"),
            _raw("inkernel.mem.1048576", 48.0, cat="memory", dtype="int32",
                 notes="ws=1048576 line=64"),
            _raw("inkernel.fused.flash_attention", 440.0, cat="kernel",
                 notes="cuda fused kernel lens=2-6 unit_bytes=16")]
    return rows


@pytest.mark.parametrize("hlo", ["elemwise", "custom_call", "scan"])
@pytest.mark.parametrize("measured", [True, False])
def test_pricing_core_gives_the_jax_estimators_report(hlo, measured):
    """The port's pricing core, fed a JAX ModuleCost's histogram, dot FLOPs,
    custom calls, bytes and collectives, over a DB with the same rows as
    the JAX estimator's, gives the JAX PricedReport field for field."""
    text = {"elemwise": ELEMWISE_HLO, "custom_call": CUSTOM_CALL_HLO,
            "scan": None}[hlo] or _scan_hlo()
    rows = _pricing_rows() if measured else []
    ours = LatencyDB()
    theirs = jax_latency_db.LatencyDB()
    for raw in rows:
        ours.add(LatencyRecord(**raw))
        theirs.add(jax_latency_db.LatencyRecord(**raw))
    want = jax_perfmodel.HloLatencyEstimator(theirs).estimate(text)

    mc = jax_hlo.ModuleCost(text)
    hist = {k: v for k, v in mc.dynamic_histogram().items() if k[0] != "custom-call"}
    flops = mc.dynamic_flops()
    sites = [perfmodel.Site(fused=jax_hlo.resolve_custom_call(t, rest), bytes=b,
                            executions=e, label=f"custom-call:{t or '?'}")
             for t, b, e, rest in mc.dynamic_custom_calls()]
    got = perfmodel.RecordLatencyEstimator(ours).price(
        hist, flops.get("dot", 0.0) + flops.get("convolution", 0.0), sites,
        mc.total().bytes, mc.total().collectives,
        table=jax_hlo.HLO_TO_TABLE, structural=jax_hlo.STRUCTURAL_OPS,
        matmul_ops=frozenset({"dot", "convolution"}), matmul_label="dot")
    for field in ("total_ns", "compute_ns", "memory_ns", "coverage", "priced_instances",
                  "unpriced_instances", "bytes_accessed", "collective_ns"):
        assert getattr(got, field) == pytest.approx(getattr(want, field), rel=REL, abs=0), field
    assert got.opt_level == want.opt_level and got.bound == want.bound
    assert [op for op, _ in got.unpriced_opcodes] == [op for op, _ in want.unpriced_opcodes]
    for (_, a), (_, b) in zip(got.unpriced_opcodes, want.unpriced_opcodes):
        assert a == pytest.approx(b, rel=REL)
    assert got.by_class.keys() == want.by_class.keys()
    for cls, cost in want.by_class.items():
        for f in ("ns", "instances", "elements"):
            assert getattr(got.by_class[cls], f) == pytest.approx(getattr(cost, f), rel=REL,
                                                                   abs=0), (cls, f)


def test_pricing_core_prices_collectives_as_the_jax_estimator():
    """The collective branch (no record of the port holds one yet): the same
    rungs and collectives give the JAX term."""
    colls = [jax_hlo.CollectiveOp("all-reduce", 4096, 4, 6144.0, executions=3.0),
             jax_hlo.CollectiveOp("all-gather", 1 << 20, 2, float(1 << 19)),
             jax_hlo.CollectiveOp("all-to-all", 1024, 4, 768.0)]
    raws = [_raw("coll.psum.d4.4096", 900.0, cat="collective",
                 notes="kind=psum devices=4 payload_bytes=4096 wire_bytes=6144"),
            _raw("coll.all_gather.d2.65536", 1200.0, cat="collective",
                 notes="kind=all_gather devices=2 payload_bytes=65536")]
    ours = perfmodel.RecordLatencyEstimator(_db(*raws))
    want_db = jax_latency_db.LatencyDB()
    for raw in raws:
        want_db.add(jax_latency_db.LatencyRecord(**raw))
    jest = jax_perfmodel.HloLatencyEstimator(want_db)
    got = ours.price({}, 0.0, (), 0.0, colls)
    # the JAX estimator's collective branch over the same list, by hand
    # through its ladder: the pricing rule is the one the core copies
    ladder = jest.collective_ladder()
    assert {k: [dataclasses.astuple(g) for g in v] for k, v in ours.collective_ladder().items()} \
        == {k: [dataclasses.astuple(g) for g in v] for k, v in ladder.items()}
    want_ns = 0.0
    for c in colls:
        rungs = ladder.get(c.kind, [])
        sized = [g for g in rungs if g.devices == c.group_size] or rungs
        rung = next((g for g in sized if g.wire_bytes >= c.wire_bytes),
                    sized[-1] if sized else None)
        if rung is not None:
            want_ns += c.executions * (c.wire_bytes / rung.wire_bytes) * rung.ns
    assert got.collective_ns == pytest.approx(want_ns, rel=REL)
    assert dict(got.unpriced_opcodes) == {"collective:all-to-all": 1.0}
    assert got.coverage == pytest.approx(4.0 / 5.0)


# ================================================================= roofline
@pytest.mark.parametrize("spec", ["TPU_V5E", "CPU_HOST"])
@pytest.mark.parametrize("flops,bts,chips", [(197e12 * 0.01, 819e9 * 0.001, 256),
                                            (197e12 * 0.001, 819e9 * 0.01, 256),
                                            (197e12, 819e9, 256), (1e12, 1e10, 1),
                                            (0.0, 0.0, 4)])
def test_roofline_equals_the_jax_roofline(spec, flops, bts, chips):
    kw = dict(arch="a", shape="s", mesh="m", chips=chips,
              cost={"flops": flops, "bytes accessed": bts}, model_flops=flops * chips * 0.5)
    want = jax_perfmodel.Roofline(getattr(jax_perfmodel, spec)).analyze(hlo_text="", **kw)
    got = perfmodel.Roofline(getattr(perfmodel, spec)).analyze(**kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float):
            assert a == pytest.approx(b, rel=REL, abs=0), f.name
        else:
            assert a == b, f.name
    assert perfmodel.Roofline.markdown_row(got) == jax_perfmodel.Roofline.markdown_row(want)
    assert perfmodel.Roofline.MD_HEADERS == jax_perfmodel.Roofline.MD_HEADERS
    assert got.bound_summary() == want.bound_summary()


def test_roofline_terms_and_knee():
    r = perfmodel.Roofline().analyze(arch="a", shape="s", mesh="m", chips=256,
                                     cost={"flops": 197e12, "bytes accessed": 819e9},
                                     model_flops=197e12 * 256 * 0.5)
    assert r.t_compute == pytest.approx(1.0) and r.t_memory == pytest.approx(1.0)
    assert r.useful_ratio == pytest.approx(0.5) and r.roofline_fraction == pytest.approx(0.5)
    for spec in ("TPU_V5E", "CPU_HOST"):
        assert getattr(perfmodel, spec) == dataclasses.replace(
            getattr(perfmodel, spec), **dataclasses.asdict(getattr(jax_perfmodel, spec)))
    assert perfmodel.H100.arithmetic_intensity_knee == pytest.approx(989e12 / 3.35e12)
    assert (perfmodel.H100.hbm_bytes, perfmodel.H100.clock_hz) == (80e9, 1.98e9)


def test_roofline_reads_an_op_record():
    rec = hlo_analysis.record_ops(torch.mm, _f32(4, 8), _f32(8, 16, seed=1))
    r = perfmodel.Roofline(perfmodel.H100).analyze(
        arch="a", shape="s", mesh="m", chips=1, cost={}, record=rec, model_flops=1024.0)
    assert r.flops_per_dev == 1024.0 and r.bytes_per_dev == rec.bytes == (32 + 128 + 64) * 4
    assert r.t_compute == pytest.approx(1024.0 / 989e12)
    assert r.useful_ratio == pytest.approx(1.0)


# ============================================================ tables, lints
def test_pure_pieces_equal_the_jax_modules():
    assert hlo_analysis.COLLECTIVE_KINDS == jax_hlo.COLLECTIVE_KINDS
    assert hlo_analysis.LADDER_TO_COLLECTIVE == jax_hlo.LADDER_TO_COLLECTIVE
    assert hlo_analysis.COLLECTIVE_TO_LADDER == jax_hlo.COLLECTIVE_TO_LADDER
    assert hlo_analysis.KERNEL_SITES == jax_hlo.CUSTOM_CALL_TARGETS
    for kind in hlo_analysis.COLLECTIVE_KINDS:
        for group in (1, 2, 4, 8):
            assert hlo_analysis.ring_factor(kind, group) == jax_hlo.ring_factor(kind, group)
    with pytest.raises(ValueError):
        hlo_analysis.ring_factor("broadcast", 2)


def test_table_maps_onto_the_jax_tables_rows():
    """Every row the port's table prices with is a row of the JAX table,
    and an ATen op named as an HLO opcode maps to the same row."""
    assert set(hlo_analysis.ATEN_TO_TABLE.values()) <= set(jax_hlo.HLO_TO_TABLE.values())
    same = {"add": "add", "sub": "subtract", "mul": "multiply", "div": "divide",
            "maximum": "maximum", "minimum": "minimum", "exp": "exponential",
            "expm1": "exponential-minus-one", "log": "log", "log1p": "log-plus-one",
            "tanh": "tanh", "rsqrt": "rsqrt", "sqrt": "sqrt", "sin": "sine",
            "cos": "cosine", "abs": "abs", "neg": "negate", "bitwise_and": "and",
            "bitwise_or": "or", "bitwise_xor": "xor", "bitwise_not": "not",
            "bitwise_left_shift": "shift-left", "remainder": "remainder",
            "pow": "power", "sigmoid": "logistic"}
    for aten, hlo in same.items():
        assert hlo_analysis.ATEN_TO_TABLE[aten] == jax_hlo.HLO_TO_TABLE[hlo], aten
    assert not set(hlo_analysis.ATEN_TO_TABLE) & hlo_analysis.STRUCTURAL_OPS
    assert hlo_analysis.ZERO_BYTE_OPS <= hlo_analysis.STRUCTURAL_OPS


def test_table_rows_are_measured_rows():
    db = LatencyDB()
    for o in chains.default_registry():
        db.add(LatencyRecord(**_raw(o.name, 1.0, cat=o.category, dtype=o.dtype)))
    est = perfmodel.RecordLatencyEstimator(db)
    for table_op in set(hlo_analysis.ATEN_TO_TABLE.values()):
        assert est._table_latency(table_op)[1], table_op


@pytest.mark.parametrize("row", sorted(set(jax_hlo.HLO_TO_TABLE.values()))
                         + ["add.float32", "no.such.row"])
def test_table_category_equals_the_jax_packages(row):
    assert perfmodel._table_category(row) == jax_perfmodel._table_category(row)


def test_lint_table_mapping_is_clean_and_catches_a_phantom_row(monkeypatch):
    assert lint.lint_table_mapping() == []
    monkeypatch.setitem(hlo_analysis.ATEN_TO_TABLE, "erfinv", "erfinv.float32")
    monkeypatch.setitem(hlo_analysis.ATEN_TO_TABLE, "clone", "add.float32")
    found = {f.subject for f in lint.lint_table_mapping()}
    assert found == {"erfinv", "clone"}


def test_allowlists_state_their_reasons():
    for table in (lint.ZOO_ALLOWLIST, lint.KNOWN_LIBRARY_CALLS):
        assert all(isinstance(r, str) and len(r) > 10 for r in table.values())
    assert not set(lint.ZOO_ALLOWLIST) & set(hlo_analysis.ATEN_TO_TABLE)
    assert hlo_analysis.MATMUL_OPS <= set(lint.ZOO_ALLOWLIST)


def test_run_lints_with_the_zoo_is_clean():
    """Every op of the ten architectures' smoke prefill and decode records
    is priced, structural, allowlisted or a known library call, and every
    kernel site has a fused row."""
    assert lint.run_lints(zoo=True) == []


def test_lint_zoo_catches_an_unlisted_op(monkeypatch):
    monkeypatch.delitem(lint.ZOO_ALLOWLIST, "where")
    found = lint.lint_zoo(["granite-3-8b"])
    assert [f.subject for f in found] == ["granite-3-8b"]
    assert "'where'" in found[0].message
    # the dataflow lint, once not ported, runs beside it (the zoo off)
    assert lint.run_lints(dataflow=True) == []


def test_zoo_records_hold_the_kernel_sites():
    prefill, decode = lint.zoo_records("jamba-v0.1-52b")
    assert dict(prefill.site_counts()) == {"flash_attention": 1, "mamba_scan": 7}
    assert decode.sites == []              # decode bypasses K6 and K4
    assert math.isfinite(prefill.bytes) and prefill.bytes > decode.bytes > 0
