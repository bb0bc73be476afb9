"""``repro_torch.traffic``, ``SloProbe``, ``Plan.slo``, the SLO points and the
``serve-slo`` CLI on the CPU, against the JAX package's ``repro.traffic``.

Traces, schedules, metrics, names, notes and plan contents are compared
exactly (the trace generators and the scheduler are numpy and Python on
both sides). The measured side is compared through its greedy tokens:
serving-tiny on the JAX package's weights (``load_jax_params``) gives every
request the tokens the JAX ``EngineExecutor`` gives it; in float32 the two
models' logits agree to about 1e-6 (``tests/test_torch_models.py``), and no
argmax on these inputs is that close. Prompt ranges stay narrow: the JAX
side compiles a prefill for each prompt length.
"""
import dataclasses
import math
import weakref

import jax
import numpy as np
import pytest

from repro.api import plan as jax_plan
from repro.api import probes as jax_probes
from repro.core import latency_db as jax_latency_db
from repro.core import perfmodel as jax_perfmodel
from repro.models import transformer as jax_transformer
from repro.parallel.sharding import unbox
from repro.serving import Engine as JaxEngine
from repro import traffic as jax_traffic
from repro_torch import traffic
from repro_torch.api import (PORTED_PLANS, SLO_RATES, Plan, Session, SloProbe, cli, named_plan,
                             serving_tiny_config)
from repro_torch.api import probes as torch_probes
from repro_torch.core import hlo_analysis, perfmodel
from repro_torch.core.latency_db import LatencyDB, LatencyRecord, current_environment
from repro_torch.core.timing import Timer
from repro_torch.models import transformer
from repro_torch.serving.engine import Engine
from repro_torch.traffic import (ContinuousBatchingScheduler, Request, TraceConfig,
                                 generate_trace, load_trace, save_trace, simulate, slo_table,
                                 summarize)
from repro_torch.traffic.metrics import request_metrics
from repro_torch.utils import parse_kv_notes

CFG, RT = serving_tiny_config()
CPU = current_environment("cpu")


def _same(a, b) -> bool:
    """Equality of nested dicts/lists/floats, a NaN equal to a NaN."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b and type(a) is type(b)


# ==================================================================== traces
TRACE_CONFIGS = [
    dict(n_requests=1, rate_rps=1.0),
    dict(n_requests=12, rate_rps=20.0),
    dict(n_requests=12, rate_rps=100.0, seed=3, prompt_len=(256, 2048), max_new=(8, 32),
         vocab_size=65536),
    dict(n_requests=40, rate_rps=7.5, seed=11, process="gamma", burstiness_cv=3.0),
    dict(n_requests=40, rate_rps=50.0, seed=2, process="gamma", burstiness_cv=0.5,
         prompt_len=(1, 1), max_new=(1, 3), vocab_size=1),
    dict(n_requests=9, rate_rps=1e6, seed=2**33, process="gamma"),
]


@pytest.mark.parametrize("kw", TRACE_CONFIGS)
def test_traces_are_the_jax_packages_to_every_float_and_token(kw):
    ours = generate_trace(TraceConfig(**kw))
    theirs = jax_traffic.generate_trace(jax_traffic.TraceConfig(**kw))
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]
    assert len(ours) == kw["n_requests"]
    assert all(type(r.arrival_ns) is float and type(r.max_new) is int for r in ours)
    assert [r.prompt_len for r in ours] == [r.prompt_len for r in theirs]


def test_trace_config_fields_are_the_jax_packages():
    ours = [(f.name, f.default) for f in dataclasses.fields(TraceConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jax_traffic.TraceConfig)]
    assert ours == theirs


@pytest.mark.parametrize("kw,match", [
    (dict(n_requests=0, rate_rps=1.0), "n_requests"),
    (dict(n_requests=1, rate_rps=0.0), "rate_rps"),
    (dict(n_requests=1, rate_rps=1.0, process="uniform"), "process"),
    (dict(n_requests=1, rate_rps=1.0, burstiness_cv=0.0), "burstiness_cv"),
    (dict(n_requests=1, rate_rps=1.0, prompt_len=(0, 4)), "prompt_len"),
    (dict(n_requests=1, rate_rps=1.0, max_new=(5, 4)), "max_new"),
])
def test_trace_config_validation_is_the_jax_packages(kw, match):
    with pytest.raises(ValueError, match=match) as ours:
        TraceConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jax_traffic.TraceConfig(**kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trace_files_load_across_packages(tmp_path, writer):
    kw = dict(n_requests=6, rate_rps=40.0, seed=5, process="gamma", burstiness_cv=2.0)
    cfg, jcfg = TraceConfig(**kw), jax_traffic.TraceConfig(**kw)
    path = str(tmp_path / "trace.json")
    if writer == "port":
        save_trace(path, generate_trace(cfg), cfg)
    else:
        jax_traffic.save_trace(path, jax_traffic.generate_trace(jcfg), jcfg)
    ours, theirs = load_trace(path), jax_traffic.load_trace(path)
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]
    assert ours == generate_trace(cfg)


def test_load_trace_sorts_by_arrival_then_uid(tmp_path):
    reqs = [Request(uid=2, arrival_ns=5.0, prompt=(1,), max_new=1),
            Request(uid=1, arrival_ns=5.0, prompt=(2, 3), max_new=2),
            Request(uid=0, arrival_ns=9.0, prompt=(4,), max_new=1)]
    path = save_trace(str(tmp_path / "t.json"), reqs)
    assert [r.uid for r in load_trace(path)] == [1, 2, 0]
    assert [r.uid for r in jax_traffic.load_trace(path)] == [1, 2, 0]


# ================================================================= scheduler
class ScriptedExecutor:
    """Deterministic executor: costs by prompt length and a fixed step cost,
    and scripted tokens. ``eos_at[uid] = k`` makes that request's k-th
    decode token the eos (99), ``first_eos`` makes its first token the eos;
    every other token is ``uid + 7 * n`` (so streams are told apart)."""

    EOS = 99

    def __init__(self, n_slots=2, admit_ns=1000.0, step_ns=500.0, eos_at=None,
                 first_eos=()):
        self.n_slots = n_slots
        self.admit_ns, self.step_ns = admit_ns, step_ns
        self.eos_at = eos_at or {}
        self.first_eos = set(first_eos)
        self.slot_state = {}        # slot -> [uid, tokens emitted after first]
        self.evictions = []

    def admit(self, slot, req):
        assert slot not in self.slot_state, "admitted into an occupied slot"
        self.slot_state[slot] = [req.uid, 0]
        tok = self.EOS if req.uid in self.first_eos else req.uid
        return tok, self.admit_ns + 10.0 * req.prompt_len

    def step(self):
        toks = np.zeros(self.n_slots, np.int32)
        for slot, st in self.slot_state.items():
            st[1] += 1
            toks[slot] = self.EOS if self.eos_at.get(st[0]) == st[1] else st[0] + 7 * st[1]
        return toks, self.step_ns

    def evict(self, slot):
        self.evictions.append((slot, self.slot_state.pop(slot)[0]))


SCHEDULES = [
    # (trace config, n_slots, eos_at, first_eos, eos_id)
    (dict(n_requests=10, rate_rps=1e6, seed=2), 2, {1: 3}, (), 99),
    (dict(n_requests=12, rate_rps=50.0, max_new=(1, 5)), 4, {}, (), None),
    (dict(n_requests=16, rate_rps=2000.0, seed=7, process="gamma", burstiness_cv=4.0), 3,
     {0: 1, 5: 2, 9: 4}, (3, 4), 99),
    (dict(n_requests=8, rate_rps=1.0, seed=1), 1, {2: 1}, (6,), 99),
]


@pytest.mark.parametrize("kw,n_slots,eos_at,first_eos,eos_id", SCHEDULES)
def test_schedules_equal_the_jax_schedulers_field_by_field(kw, n_slots, eos_at, first_eos,
                                                           eos_id):
    ours_ex = ScriptedExecutor(n_slots, eos_at=eos_at, first_eos=first_eos)
    theirs_ex = ScriptedExecutor(n_slots, eos_at=eos_at, first_eos=first_eos)
    ours = ContinuousBatchingScheduler(ours_ex, eos_id=eos_id).run(
        generate_trace(TraceConfig(**kw)))
    theirs = jax_traffic.ContinuousBatchingScheduler(theirs_ex, eos_id=eos_id).run(
        jax_traffic.generate_trace(jax_traffic.TraceConfig(**kw)))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours_ex.evictions == theirs_ex.evictions
    assert sorted(ours.by_uid()) == list(range(kw["n_requests"]))
    if eos_id is not None and (eos_at or first_eos):
        assert {r.finish_reason for r in ours.requests} == {"eos", "max_new"}


def _req(uid, arrival_ns, max_new=8, plen=2):
    return Request(uid=uid, arrival_ns=arrival_ns, prompt=tuple(range(1, plen + 1)),
                   max_new=max_new)


def test_scheduler_eos_frees_a_slot_for_a_late_request_before_the_batch_drains():
    ex = ScriptedExecutor(n_slots=2, eos_at={0: 2})
    trace = [_req(0, 0.0), _req(1, 0.0), _req(2, 1.0)]
    res = ContinuousBatchingScheduler(ex, eos_id=ScriptedExecutor.EOS).run(trace)
    by = res.by_uid()
    assert by[0].finish_reason == "eos" and by[0].n_tokens == 3
    assert by[2].slot == by[0].slot and by[2].admitted_ns == by[0].finish_ns
    assert by[2].admitted_ns < by[1].finish_ns
    assert ex.evictions[0] == (by[0].slot, 0)


def test_scheduler_idles_to_the_next_arrival_and_queueing_lands_in_ttft():
    ex = ScriptedExecutor(n_slots=1)
    res = ContinuousBatchingScheduler(ex).run([_req(0, 5e6, max_new=2), _req(1, 5e6, max_new=1)])
    a, b = res.by_uid()[0], res.by_uid()[1]
    assert a.admitted_ns == 5e6 and a.first_token_ns == 5e6 + 1020.0
    assert b.admitted_ns == a.finish_ns == 5e6 + 1020.0 + 500.0
    m = request_metrics(b)
    assert m.queue_ns == b.admitted_ns - 5e6 and m.ttft_ns == m.queue_ns + 1020.0
    assert math.isnan(m.tpot_ns) and res.decode_steps == 1 and res.admissions == 2


# =================================================================== metrics
@pytest.mark.parametrize("kw,n_slots,eos_at,first_eos,eos_id", SCHEDULES)
def test_metrics_and_table_equal_the_jax_packages(kw, n_slots, eos_at, first_eos, eos_id):
    ours = ContinuousBatchingScheduler(
        ScriptedExecutor(n_slots, eos_at=eos_at, first_eos=first_eos), eos_id=eos_id).run(
        generate_trace(TraceConfig(**kw)))
    theirs = jax_traffic.ContinuousBatchingScheduler(
        ScriptedExecutor(n_slots, eos_at=eos_at, first_eos=first_eos), eos_id=eos_id).run(
        jax_traffic.generate_trace(jax_traffic.TraceConfig(**kw)))
    for a, b in zip(ours.requests, theirs.requests):
        assert _same(dataclasses.asdict(request_metrics(a)),
                     dataclasses.asdict(jax_traffic.request_metrics(b)))
    s, js = summarize(ours), jax_traffic.summarize(theirs)
    assert _same(dataclasses.asdict(s), dataclasses.asdict(js))
    assert _same(s.as_record(), js.as_record())
    pcts = (10.0, 50.0, 75.0, 100.0)
    assert _same(dataclasses.asdict(summarize(ours, pcts)),
                 dataclasses.asdict(jax_traffic.summarize(theirs, pcts)))
    rows = [{"rate_rps": kw["rate_rps"], "predicted": s, "measured": s},
            {"rate_rps": 2.5, "predicted": s, "measured": None}]
    jrows = [{"rate_rps": kw["rate_rps"], "predicted": js, "measured": js},
             {"rate_rps": 2.5, "predicted": js, "measured": None}]
    assert slo_table(rows) == jax_traffic.slo_table(jrows)


def test_single_token_requests_summarize_to_nan_tpot_as_in_the_jax_package():
    trace = [_req(i, 0.0, max_new=1) for i in range(3)]
    ours = summarize(ContinuousBatchingScheduler(ScriptedExecutor(1)).run(trace))
    jtrace = [jax_traffic.Request(**dataclasses.asdict(r)) for r in trace]
    theirs = jax_traffic.summarize(jax_traffic.ContinuousBatchingScheduler(
        ScriptedExecutor(1)).run(jtrace))
    assert all(math.isnan(v) for v in ours.tpot_ns.values())
    assert _same(ours.as_record(), theirs.as_record())
    assert "| nan |" in slo_table([{"rate_rps": 1.0, "predicted": ours}])


def test_summarize_rejects_an_empty_result():
    with pytest.raises(ValueError, match="empty"):
        summarize(traffic.ScheduleResult([], 1, 0.0, 0, 0))


def test_simulator_runs_every_budget_and_replays():
    class FlatCosts:
        n_slots = 2

        def prefill_ns(self, plen):
            return 1000.0 + plen

        def decode_ns(self):
            return 500.0

    trace = generate_trace(TraceConfig(n_requests=8, rate_rps=50.0, seed=4))
    ours, again = simulate(trace, FlatCosts()), simulate(trace, FlatCosts())
    theirs = jax_traffic.simulate(jax_traffic.generate_trace(
        jax_traffic.TraceConfig(n_requests=8, rate_rps=50.0, seed=4)), FlatCosts())
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs) == dataclasses.asdict(again)
    assert [rr.n_tokens for rr in ours.requests] == [r.max_new for r in trace]
    assert {rr.finish_reason for rr in ours.requests} == {"max_new"}


def test_traffic_exports_the_jax_packages_names():
    assert traffic.__all__ == jax_traffic.__all__


# ============================================================ probe, points
OTHER = dataclasses.replace(CFG, name="other-model")
PROBE_CASES = [
    ((20.0,), {}),
    ((50,), {"n_requests": 4, "n_slots": 2}),
    ((100.0,), {"n_requests": 12, "n_slots": 2}),
    ((2.5,), {"seed": 3}),
    ((1.0,), {"process": "gamma", "burstiness_cv": 2.0}),
    ((1.0,), {"process": "gamma"}),
    ((16.0,), {"max_len": 2080, "prompt_len": (256, 2048), "max_new": (8, 32)}),
    ((4.0,), {"n_requests": 12, "n_slots": 4, "seed": 1, "process": "gamma",
              "burstiness_cv": 0.5, "max_len": 64, "model": True}),
]


def _probe_pair(args, kw):
    kw = dict(kw)
    jkw = dict(kw)
    if kw.pop("model", False):
        jkw.pop("model")
        kw.update(cfg=OTHER, rt=RT)
        jkw.update(cfg=dataclasses.replace(jax_probes.serving_tiny_config()[0],
                                           name="other-model"),
                   rt=jax_probes.serving_tiny_config()[1])
    return SloProbe(*args, **kw), jax_probes.SloProbe(*args, **jkw)


@pytest.mark.parametrize("args,kw", PROBE_CASES)
def test_probe_names_as_the_jax_package(args, kw):
    ours, theirs = _probe_pair(args, kw)
    assert ours.op == theirs.op and ours.base_op == theirs.base_op
    assert ours.logical_key() == theirs.logical_key()
    assert ours.match_names() == theirs.match_names()
    assert (ours.category, ours.opt_level, ours.dtype) == (
        theirs.category, theirs.opt_level, theirs.dtype) == ("slo", "O3", "float32")
    assert dataclasses.asdict(ours.trace_config()) == dataclasses.asdict(theirs.trace_config())


def test_probe_name_examples():
    assert SloProbe(20).op == "slo.r20"
    assert SloProbe(50, n_requests=4, n_slots=2).op == "slo.r50.n4s2"
    assert SloProbe(1, seed=2, process="gamma", burstiness_cv=2.0, max_len=2080,
                    cfg=OTHER, rt=RT).op == "slo.r1.seed2.gamma2.c2080.other-model"


def _slo_raws():
    full = ("rate=50 n=12 slots=4 seed=0 model=serving-tiny "
            "pred_ttft_p50_ns=100.0 pred_ttft_p99_ns=200.0 pred_tpot_p50_ns=50.0 "
            "pred_tpot_p99_ns=80.0 pred_e2e_p50_ns=400.0 pred_goodput_tok_s=1000.0 "
            "meas_ttft_p50_ns=1000.0 meas_ttft_p99_ns=2000.0 meas_tpot_p50_ns=60.0 "
            "meas_tpot_p99_ns=90.0 meas_e2e_p50_ns=4000.0 meas_goodput_tok_s=900.0 "
            "coverage=0.7100 exec=eager clock=wall")
    nan_tpot = ("rate=20 n=4 slots=2 seed=0 model=serving-tiny "
                "pred_ttft_p50_ns=1.5 pred_ttft_p99_ns=2.5 pred_tpot_p50_ns=nan "
                "pred_tpot_p99_ns=nan pred_e2e_p50_ns=3.0 pred_goodput_tok_s=0.000 "
                "meas_ttft_p50_ns=1e9 meas_ttft_p99_ns=2e9 meas_tpot_p50_ns=nan "
                "meas_tpot_p99_ns=nan meas_e2e_p50_ns=3e9 meas_goodput_tok_s=1.000 "
                "coverage=1.0000")
    partial = "rate=100 coverage=0.5 pred_ttft_p50_ns=7e6"
    out = []
    for op, lat, notes in (("slo.r50", 1000.0, full), ("slo.r20.n4s2", 1e9, nan_tpot),
                           ("slo.r100.other-model", 0.0, partial)):
        out.append(dict(op=op, category="slo", dtype="float32", opt_level="O3",
                        latency_ns=lat, mad_ns=0.0, cycles=0.0, guard=0,
                        net_latency_ns=lat, n_samples=12, measured_at="", notes=notes, **CPU))
    return out


METRICS = perfmodel.SloPoint.METRICS + ("missing_metric",)


def test_slo_points_parse_and_render_as_the_jax_package():
    ours = [perfmodel.slopoint_from_record(LatencyRecord(**raw)) for raw in _slo_raws()]
    theirs = [jax_perfmodel.slopoint_from_record(jax_latency_db.LatencyRecord(**raw))
              for raw in _slo_raws()]
    assert perfmodel.SloPoint.METRICS == jax_perfmodel.SloPoint.METRICS
    for a, b in zip(ours, theirs):
        assert _same(dataclasses.asdict(a), dataclasses.asdict(b))
        for metric in METRICS:
            assert a.abs_log10_error(metric) == b.abs_log10_error(metric)
    assert perfmodel.slo_markdown(ours) == jax_perfmodel.slo_markdown(theirs)
    assert ours[0].abs_log10_error("ttft_p50_ns") == pytest.approx(1.0)
    assert ours[1].abs_log10_error("tpot_p50_ns") == float("inf")
    assert ours[2].measured == {} and ours[2].n_slots == 0
    with pytest.raises(AssertionError):
        perfmodel.slopoint_from_record(LatencyRecord(**{**_slo_raws()[0], "op": "serving.x"}))


# ====================================================================== plan
def test_plan_slo_equals_the_jax_plan_in_order():
    cases = [(Plan.slo(), jax_plan.Plan.slo()),
             (Plan.slo(with_deps=False), jax_plan.Plan.slo(with_deps=False)),
             (Plan.slo((50.0,), n_requests=4, n_slots=2),
              jax_plan.Plan.slo((50.0,), n_requests=4, n_slots=2)),
             (Plan.slo((30.0, 60.0), seed=2), jax_plan.Plan.slo((30.0, 60.0), seed=2)),
             (named_plan("slo"), jax_plan.named_plan("slo"))]
    for ours, theirs in cases:
        assert [p.logical_key() for p in ours] == [p.logical_key() for p in theirs]
        assert [type(p).__name__ for p in ours] == [type(p).__name__ for p in theirs]
        assert ours.name == theirs.name == "slo"
    assert SLO_RATES == jax_plan.SLO_RATES == (20.0, 50.0, 100.0)
    assert "slo" in PORTED_PLANS
    kinds = [type(p).__name__ for p in named_plan("slo")]
    assert kinds[-3:] == ["SloProbe"] * 3 and set(kinds[:-3]) == {"InstructionProbe",
                                                                 "MemoryProbe"}
    assert [p.op for p in named_plan("slo").filter(ops=["slo"])] == [
        "slo.r20", "slo.r50", "slo.r100"]


# ============================================================ measured side
@pytest.fixture(scope="module")
def jax_engine():
    cfg, rt = jax_probes.serving_tiny_config()
    return JaxEngine(jax_transformer.init_lm(jax.random.PRNGKey(0), cfg), cfg, rt)


@pytest.fixture(scope="module")
def engine(jax_engine):
    model = transformer.init_lm(CFG, seed=0, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, unbox(jax_engine.params))
    return Engine(transformer.load_jax_params(model, tree), RT)


SERVED = dict(n_requests=6, rate_rps=200.0, seed=1, prompt_len=(4, 5), max_new=(2, 6))


def test_engine_executor_tokens_equal_the_jax_executors(engine, jax_engine):
    trace = generate_trace(TraceConfig(**SERVED))
    lens = sorted({r.prompt_len for r in trace})
    ex = traffic.EngineExecutor(engine, 2, max_len=16, warm_lens=lens)
    jex = jax_traffic.EngineExecutor(jax_engine, 2, max_len=16, warm_lens=lens)
    ours = ContinuousBatchingScheduler(ex, eos_id=None).run(trace)
    theirs = jax_traffic.ContinuousBatchingScheduler(jex, eos_id=None).run(
        jax_traffic.generate_trace(jax_traffic.TraceConfig(**SERVED)))
    got = {r.request.uid: r.tokens for r in ours.requests}
    want = {r.request.uid: r.tokens for r in theirs.requests}
    assert got == want
    assert [len(got[r.uid]) for r in trace] == [r.max_new for r in trace]
    assert all(rr.first_token_ns > rr.admitted_ns for rr in ours.requests)
    assert ex.pool.active_slots() == [] and ex.n_slots == 2


def test_engine_executor_warms_each_prompt_length_and_the_decode_step(engine, monkeypatch):
    admitted, steps = [], []
    pool = engine.slots(2, max_len=16)
    monkeypatch.setattr(engine, "slots", lambda n, max_len=None: pool)
    real_admit, real_step = pool.admit, pool.step
    monkeypatch.setattr(pool, "admit", lambda s, p, **kw: admitted.append(len(p)) or
                        real_admit(s, p, **kw))
    monkeypatch.setattr(pool, "step", lambda: steps.append(1) or real_step())
    traffic.EngineExecutor(engine, 2, max_len=16, warm_lens=[5, 4, 5])
    assert admitted == [4, 5, 1] and steps == [1] and pool.active_slots() == []


def test_predicted_costs_are_the_estimators_on_the_same_records(engine):
    db = LatencyDB()
    for op, ns in (("add.float32", 2.0), ("mul.float32", 3.0), ("fma.float32", 4.0),
                   ("ex2", 9.0), ("mem.chase.ws131072", 50.0)):
        db.add(LatencyRecord(op=op, category="fp32", dtype="float32", opt_level="O3",
                             latency_ns=ns, mad_ns=0.0, cycles=ns, guard=0,
                             net_latency_ns=ns, n_samples=5, measured_at="", notes="",
                             **CPU))
    costs = traffic.PredictedCostModel(engine, db, 2, max_len=24, filters=CPU)
    est = perfmodel.RecordLatencyEstimator(db, filters=CPU)
    reports = []
    for plen in (4, 7):
        step, args = engine.lower_prefill(1, plen)
        record = hlo_analysis.record_ops(step, *args)
        reports.append(est.estimate(record))
        assert costs.prefill_ns(plen) == est.estimate_ns(record) > 0
    step, args = engine.lower_decode(2, 1, 24)
    record = hlo_analysis.record_ops(step, *args)
    reports.append(est.estimate(record))
    assert costs.decode_ns() == est.estimate_ns(record) > 0
    assert costs.min_coverage == min(r.coverage for r in reports)
    assert 0 < costs.min_coverage < 1
    # priced once a shape, and the cost model holds its engine no longer than
    # it lives itself
    assert sorted(costs._prefill) == [4, 7]
    ref = weakref.ref(costs)
    del costs
    assert ref() is None


def _session(tmp_path):
    return Session(db=str(tmp_path / "db.json"), device="cpu",
                   timer=Timer(warmup=0, reps=1, device="cpu"))


PROBE_KW = dict(n_requests=4, n_slots=2, prompt_len=(4, 5), max_new=(2, 4))


def test_probe_records_both_sides_with_the_jax_packages_notes_keys(tmp_path, jax_engine,
                                                                   monkeypatch):
    from repro.api.session import Session as JaxSession

    probe = SloProbe(30.0, **PROBE_KW)
    result = _session(tmp_path).run(Plan((probe,), name="point"))
    (rec,) = result.records()
    kv = parse_kv_notes(rec.notes)
    assert rec.op == "slo.r30.n4s2" and rec.category == "slo"
    assert (kv["exec"], kv["clock"]) == ("eager", "wall")
    pred, meas, coverage = probe.last_result
    assert rec.latency_ns == meas.ttft_ns[50.0] > 0
    assert meas.n_tokens == pred.n_tokens == sum(
        r.max_new for r in generate_trace(probe.trace_config()))
    pt = perfmodel.slopoint_from_record(rec)
    assert set(pt.predicted) == set(pt.measured) == set(perfmodel.SloPoint.METRICS)
    assert all(v > 0 for v in (*pt.predicted.values(), *pt.measured.values()))
    assert pt.coverage == coverage == 0.0          # an empty DB prices nothing
    # the JAX probe's notes keys, on the JAX package's engine (its model build
    # reused, so the point compiles only its own steps)
    monkeypatch.setattr(jax_transformer, "init_lm", lambda key, cfg: jax_engine.params)
    jprobe = jax_probes.SloProbe(30.0, **PROBE_KW)
    (jrec,) = JaxSession(db=str(tmp_path / "jax.json")).run(
        jax_plan.Plan((jprobe,), name="point")).records()
    assert list(kv) == list(parse_kv_notes(jrec.notes)) + ["exec", "clock"]
    assert jrec.op == rec.op and jrec.category == rec.category
    jpt = jax_perfmodel.slopoint_from_record(jrec)
    assert (jpt.n_requests, jpt.n_slots, jpt.model) == (pt.n_requests, pt.n_slots, pt.model)


def test_points_of_one_run_share_one_model_build(tmp_path, monkeypatch):
    built = []
    real = transformer.init_lm
    monkeypatch.setattr(transformer, "init_lm",
                        lambda *a, **k: built.append(a) or real(*a, **k))
    probes = tuple(SloProbe(r, **PROBE_KW) for r in (10.0, 40.0))
    result = _session(tmp_path).run(Plan(probes, name="points"))
    assert not result.failed and len(built) == 1
    del result, probes                  # the model goes with the run
    assert not torch_probes._SERVED_MODELS


# ======================================================================= CLI
def _seed_deps(db_path):
    """The deps' rows of Plan.slo, so that the sweep's deps are cache hits."""
    db = LatencyDB(db_path)
    for p in Plan.slo():
        if p.category != "slo":
            db.add(LatencyRecord(op=p.op, category=p.category, dtype=p.dtype,
                                 opt_level=p.opt_level, latency_ns=2.0, mad_ns=0.0,
                                 cycles=2.0, guard=0, net_latency_ns=2.0, n_samples=5,
                                 measured_at="", notes="", **CPU))
    db.save()


def test_serve_slo_cli_end_to_end(tmp_path, capsys):
    db = str(tmp_path / "db.json")
    _seed_deps(db)
    args = ["serve-slo", "--rates", "30,60", "--n-requests", "4", "--slots", "2",
            "--db", db, "--reps", "1", "--warmup", "0", "--device", "cpu"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "2 measured, 18 cached, 0 failed" in out
    assert "| predicted |" in out and "| measured |" in out
    points = sorted((perfmodel.slopoint_from_record(r) for r in LatencyDB(db).records()
                     if r.op.startswith("slo.")), key=lambda p: p.rate_rps)
    assert [p.rate_rps for p in points] == [30.0, 60.0]
    for p in points:
        for metric in ("ttft_p50_ns", "ttft_p99_ns", "tpot_p50_ns"):
            assert p.predicted[metric] > 0 and p.measured[metric] > 0
        assert 0 < p.coverage <= 1
    assert cli.main(args) == 0                     # all cache hits
    out = capsys.readouterr().out
    assert "0 measured, 20 cached" in out and "all probes were cache hits" in out
    assert out.count("| measured |") == 2


def test_serve_slo_replays_a_trace_the_jax_package_saved(tmp_path, capsys):
    path = str(tmp_path / "trace.json")
    jcfg = jax_traffic.TraceConfig(n_requests=3, rate_rps=40.0, seed=6, prompt_len=(4, 5),
                                   max_new=(2, 3))
    jax_traffic.save_trace(path, jax_traffic.generate_trace(jcfg), jcfg)
    db = str(tmp_path / "db.json")
    _seed_deps(db)
    assert cli.main(["serve-slo", "--trace", path, "--slots", "2", "--db", db,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"trace {path}: 3 requests" in out
    assert "| predicted |" in out and "| measured |" in out and "coverage" in out
    assert not any(r.op.startswith("slo.") for r in LatencyDB(db).records())  # uncached


def test_serve_slo_refuses_an_empty_trace_and_a_missing_card(tmp_path, capsys):
    path = save_trace(str(tmp_path / "empty.json"), [])
    assert cli.main(["serve-slo", "--trace", path, "--device", "cpu",
                     "--db", str(tmp_path / "db.json")]) == 2
    assert "holds no requests" in capsys.readouterr().err
    import torch

    if not torch.cuda.is_available():
        assert cli.main(["serve-slo", "--db", str(tmp_path / "db.json")]) == 2
        assert "error" in capsys.readouterr().err
