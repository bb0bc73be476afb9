"""``characterize --plan serving`` on the CPU: the Engine's lowered steps,
``ServingCostProbe``, ``Plan.serving``, the serving table and the CLI,
against the JAX package.

The op record of serving-tiny's prefill (2 x 64) and decode step (1 x 16,
cache 512) on the JAX package's weights (``load_jax_params``) is held to
the JAX module of the same cell: the same matmul FLOPs, exactly, and the
same priced table rows but for the differences the test names, each with
its cause.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import plan as jax_plan
from repro.api.probes import serving_tiny_config as jax_tiny
from repro.core import hlo_analysis as jax_hlo
from repro.core import latency_db as jax_latency_db
from repro.models import transformer as jax_transformer
from repro.parallel.sharding import unbox
from repro.serving import Engine as JaxEngine
from repro_torch.api import Plan, ServingCostProbe, Session, cli, named_plan, serving_tiny_config
from repro_torch.api import probes as torch_probes
from repro_torch.core import hlo_analysis, measure, perfmodel
from repro_torch.core.latency_db import LatencyDB, LatencyRecord, current_environment
from repro_torch.core.timing import Timer
from repro_torch.models import transformer
from repro_torch.serving import Engine
from repro_torch.utils import parse_kv_notes

CFG, RT = serving_tiny_config()
CPU = current_environment("cpu")


def _raw(op, ns, cat="fp32", dtype="float32", notes="", env=None):
    return dict(op=op, category=cat, dtype=dtype, opt_level="O3", latency_ns=ns, mad_ns=0,
                cycles=ns, guard=0, net_latency_ns=ns, n_samples=5, measured_at="t",
                notes=notes, **(env or CPU))


@pytest.fixture(scope="module")
def jax_engine():
    cfg, rt = jax_tiny()
    return JaxEngine(jax_transformer.init_lm(jax.random.PRNGKey(0), cfg), cfg, rt)


@pytest.fixture(scope="module")
def engine(jax_engine):
    model = transformer.init_lm(CFG, seed=0, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, unbox(jax_engine.params))
    return Engine(transformer.load_jax_params(model, tree), RT)


def _session(tmp_path=None):
    return Session(db=str(tmp_path / "db.json") if tmp_path else None, device="cpu",
                   timer=Timer(warmup=0, reps=2, device="cpu"))


# =================================================================== config
def test_serving_tiny_config_is_the_jax_packages():
    cfg, rt = jax_tiny()
    for f in dataclasses.fields(CFG):
        assert getattr(CFG, f.name) == getattr(cfg, f.name), f.name
    for f in ("remat", "xent_chunk", "moe_groups", "attn_impl", "use_pallas"):
        assert getattr(RT, f) == getattr(rt, f), f


# ============================================================ record parity
# Table rows one side prices and the other does not, and why:
#  - "and" (JAX prefill): jnp.take_along_axis's bounds check on the last
#    positions' gather; the port indexes h[rows, last].
#  - "sub" (JAX): negate, from jax.nn.silu, which reaches the CPU module as
#    negate, exponential, add and divide; ATEN_TO_TABLE maps neg to sub too.
#  - "tanh" (port): sigmoid, from silu's decomposition x * sigmoid(x),
#    which ATEN_TO_TABLE maps to tanh as HLO_TO_TABLE maps logistic.
#  - "not" (port): masked_fill(~mask), where the JAX model selects with
#    where(mask).
#  - "sin", "cos" (port decode): the rope of the decode position; lower_decode
#    bakes the position into the JAX module as a constant, and XLA folds
#    its sine and cosine.
ONLY_JAX = {"prefill": {"and", "sub"}, "decode": {"sub"}}
ONLY_PORT = {"prefill": {"tanh", "not"}, "decode": {"tanh", "not", "sin", "cos"}}


@pytest.mark.parametrize("phase,batch,prompt", [("prefill", 2, 64), ("decode", 1, 16)])
def test_record_matches_the_jax_module(engine, jax_engine, phase, batch, prompt):
    if phase == "prefill":
        lowered, _ = jax_engine.lower_prefill(batch, prompt)
        step, args = engine.lower_prefill(batch, prompt)
    else:
        lowered, _ = jax_engine.lower_decode(batch, prompt)
        step, args = engine.lower_decode(batch, prompt)
    mc = jax_hlo.ModuleCost(lowered.compile().as_text())
    rec = hlo_analysis.record_ops(step, *args)
    assert rec.matmul_flops == mc.dynamic_flops()["dot"]
    theirs = {jax_hlo.HLO_TO_TABLE[op] for op, _ in mc.dynamic_histogram()
              if op in jax_hlo.HLO_TO_TABLE}
    ours = {hlo_analysis.ATEN_TO_TABLE[op] for op, _ in rec.histogram
            if op in hlo_analysis.ATEN_TO_TABLE}
    assert theirs - ours == ONLY_JAX[phase]
    assert ours - theirs == ONLY_PORT[phase]
    assert rec.sites == [] and not mc.dynamic_custom_calls()
    # eager bytes (every intermediate written; the JAX module counts fusion
    # boundaries): at least every weight the step reads, read once
    weights = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    assert rec.bytes >= weights


# ========================================================== lowered steps
def test_lower_prefill_gives_the_step_and_the_jax_inputs(engine, jax_engine):
    step, (toks, last) = engine.lower_prefill(2, 64)
    _, (_, jtoks, jlast) = jax_engine.lower_prefill(2, 64)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    logits, cache = step(toks, last)
    assert logits.shape == (2, CFG.vocab_size) and torch.isfinite(logits).all()


def test_lower_decode_is_not_donating(engine):
    """The step runs again and again on the same cache: the same logits,
    the cache touched only at the step's position."""
    step, args = engine.lower_decode(1, 8)
    cache = args[0]
    first, _ = step(*args)
    snapshot = [{k: {n: t.clone() for n, t in c.items()} for k, c in pc.items()}
                for pc in cache]
    second, _ = step(*args)
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    for pc, before in zip(cache, snapshot):
        for k, c in pc.items():
            for n, t in c.items():
                assert torch.equal(t, before[k][n]), (k, n)


def test_lower_decode_cache_defaults_to_engine_max_len():
    eng = Engine(transformer.init_lm(CFG, seed=0, device="cpu"), RT, max_len=48)
    _, (cache, toks) = eng.lower_decode(1, 8)
    assert {t.shape[1] for pc in cache for c in pc.values() for t in c.values()} == {48}
    _, (cache, _) = eng.lower_decode(1, 8, 40)
    assert {t.shape[1] for pc in cache for c in pc.values() for t in c.values()} == {40}
    assert toks.shape == (1, 1) and toks.dtype == torch.long


# ==================================================================== probe
def test_probe_names_as_the_jax_package():
    from repro.api.probes import ServingCostProbe as JaxProbe

    other = dataclasses.replace(CFG, name="other-model")
    jother = dataclasses.replace(jax_tiny()[0], name="other-model")
    for args, kw, jkw in [((("prefill", 1, 8)), {}, {}),
                          (("decode", 2, 64), {}, {}),
                          (("decode", 1, 8), {"max_len": 4096}, {"max_len": 4096}),
                          (("prefill", 1, 8), {"cfg": other, "rt": RT},
                           {"cfg": jother, "rt": jax_tiny()[1]})]:
        ours, theirs = ServingCostProbe(*args, **kw), JaxProbe(*args, **jkw)
        assert ours.op == theirs.op and ours.logical_key() == theirs.logical_key()
        assert ours.match_names() == theirs.match_names()
        assert (ours.category, ours.opt_level) == ("serving", "O3")
    with pytest.raises(ValueError, match="phase"):
        ServingCostProbe("train", 1, 8)


def test_probe_records_predicted_and_measured(tmp_path):
    session = _session(tmp_path)
    probe = ServingCostProbe("prefill", 1, 8, reps=2)
    result = session.run(Plan((probe,), name="cell"))
    assert result.summary().startswith("1 measured")
    (rec,) = result.records()
    assert rec.op == "serving.prefill.b1p8" and rec.category == "serving"
    kv = parse_kv_notes(rec.notes)
    assert kv["exec"] == "eager" and kv["cache"] == "0" and kv["model"] == "serving-tiny"
    pt = perfmodel.servingpoint_from_record(rec)
    assert pt.phase == "prefill" and pt.batch == 1 and pt.prompt_len == 8
    assert pt.measured_ns == rec.latency_ns > 0
    assert pt.predicted_ns == pytest.approx(probe.last_report.total_ns, abs=1e-3)
    assert pt.coverage == pytest.approx(probe.last_report.coverage, abs=1e-4)
    assert kv["bound"] == probe.last_report.bound
    # the JAX package's parser reads the port's row the same way
    from repro.core import perfmodel as jax_perfmodel

    jrec = jax_latency_db.LatencyRecord(**dataclasses.asdict(rec))
    assert dataclasses.asdict(jax_perfmodel.servingpoint_from_record(jrec)) == \
        dataclasses.asdict(pt)


def test_probe_decode_cell_notes_its_cache_and_resumes(tmp_path):
    session = _session(tmp_path)
    plan = Plan((ServingCostProbe("decode", 1, 8, reps=2),), name="cell")
    first = session.run(plan)
    (rec,) = first.records()
    assert parse_kv_notes(rec.notes)["cache"] == "512"      # the Engine's max_len
    again = _session(tmp_path).run(plan)
    assert again.summary().startswith("0 measured, 1 cached")


def test_probe_prices_from_the_sessions_rows_only(tmp_path):
    """With rows of this environment in the DB the cell is priced from
    them; rows of another device price nothing."""
    session = _session(tmp_path)
    other = {"device_kind": "tpu", "backend": "tpu", "jax_version": "y"}
    for op in ("add.float32", "mul.float32", "fma.float32", "ex2", "rsqrt", "tanh"):
        session.db.add(LatencyRecord(**_raw(op, 1000.0, env=other)))
    probe = ServingCostProbe("decode", 1, 8, reps=1)
    session.run(Plan((probe,), name="cell"))
    assert probe.last_report.coverage == 0.0
    for op in ("add.float32", "mul.float32", "fma.float32", "ex2", "rsqrt", "tanh"):
        session.db.add(LatencyRecord(**_raw(op, 2.0)))
    probe = ServingCostProbe("decode", 1, 8, reps=1)
    session.run(Plan((probe,), name="cell"), force=True)
    assert 0.5 < probe.last_report.coverage < 1.0
    est = perfmodel.RecordLatencyEstimator(session.db, filters=dict(session.env))
    assert est.estimate(probe.last_record) == probe.last_report


def test_cells_of_one_run_share_one_model_build(monkeypatch):
    built = []
    real = transformer.init_lm
    monkeypatch.setattr(transformer, "init_lm",
                        lambda *a, **k: built.append(a) or real(*a, **k))
    probes = (ServingCostProbe("prefill", 1, 8, reps=1), ServingCostProbe("decode", 1, 8, reps=1))
    result = _session().run(Plan(probes, name="cells"))
    assert not result.failed and len(built) == 1
    del result, probes                     # the model goes with the last prepared cell
    assert not torch_probes._SERVED_MODELS


def test_full_width_recipe_records_the_kernel_sites_and_prices_them():
    """The chip's full-width cell on the smoke config: the kernels' runtime
    records one K5 site and seven K7 sites a prefill, and with the fused
    plan's rows in the DB neither is unpriced."""
    from repro_torch import inkernel
    from repro_torch.configs.registry import get
    from repro_torch.models.config import Runtime

    cfg = get("jamba-v0.1-52b").smoke
    rt = Runtime(remat=False, moe_groups=1, mamba_chunk=16, attn_impl="pallas",
                 use_pallas=True)
    session = _session()
    for name in inkernel.FUSED_KERNELS:
        session.db.add(LatencyRecord(**_raw(
            f"inkernel.fused.{name}", 300.0, cat="kernel",
            notes=f"plain fused kernel lens=2-6 unit_bytes={inkernel.unit_bytes(name)}")))
    prefill = ServingCostProbe("prefill", 2, 32, cfg=cfg, rt=rt, reps=1)
    decode = ServingCostProbe("decode", 2, 32, cfg=cfg, rt=rt, max_len=48, reps=1)
    result = session.run(Plan((prefill, decode), name="cells"))
    assert not result.failed
    assert dict(prefill.last_record.site_counts()) == {"flash_attention": 1, "mamba_scan": 7}
    assert decode.last_record.sites == []
    unpriced = dict(prefill.last_report.unpriced_opcodes)
    assert not any(k.startswith("kernel:") for k in unpriced)
    assert {"fused:flash_attention", "fused:mamba_scan"} <= set(prefill.last_report.by_class)
    assert decode.op == f"serving.decode.b2p32.c48.{cfg.name}"


# ===================================================================== plan
def test_plan_serving_equals_the_jax_plan_in_order():
    for ours, theirs in [(Plan.serving(), jax_plan.Plan.serving()),
                         (Plan.serving(with_deps=False), jax_plan.Plan.serving(with_deps=False)),
                         (named_plan("serving"), jax_plan.named_plan("serving"))]:
        assert [p.logical_key() for p in ours] == [p.logical_key() for p in theirs]
        assert [type(p).__name__ for p in ours] == [type(p).__name__ for p in theirs]
        assert ours.name == theirs.name == "serving"


def test_plan_serving_deps_come_first_and_feed_the_ladder():
    plan = Plan.serving()
    kinds = [type(p).__name__ for p in plan]
    first = kinds.index("ServingCostProbe")
    assert set(kinds[:first]) == {"InstructionProbe", "MemoryProbe"}
    assert all(k == "ServingCostProbe" for k in kinds[first:])
    for p in plan:
        if type(p).__name__ == "MemoryProbe":
            assert perfmodel._MEM_ROW_RE.match(p.op), p.op
    cells = plan.filter(ops=["serving"])
    assert [p.op for p in cells] == ["serving.prefill.b1p16", "serving.decode.b1p16",
                                     "serving.prefill.b2p64", "serving.decode.b2p64"]
    assert len(plan.filter(ops=["serving.decode"])) == 2


# ==================================================================== table
def _serving_raws():
    raws = []
    for op, pred, meas in [("serving.prefill.b2p64", 5e5, 1e6), ("serving.decode.b1p16", 2e4, 0.0),
                           ("serving.prefill.b2p16", 7e4, 3e5), ("serving.decode.b2p64", 1.0, 9.0)]:
        phase, cell = op.split(".")[1:3]
        b, p = cell[1:].split("p")
        raws.append(_raw(op, meas, cat="serving",
                         notes=f"phase={phase} batch={b} prompt={p} model=serving-tiny "
                               f"predicted_ns={pred:.3f} coverage=0.5000 bound=compute "
                               "exec=eager"))
    raws.append(_raw("add", 1.0))
    return raws


def test_serving_table_equals_the_jax_packages():
    ours, theirs = LatencyDB(), jax_latency_db.LatencyDB()
    for raw in _serving_raws():
        ours.add(LatencyRecord(**raw))
        theirs.add(jax_latency_db.LatencyRecord(**raw))
    table = ours.compare_markdown(prefix="serving.")
    assert table == theirs.compare_markdown(prefix="serving.")
    cells = [line.split(" | ")[0].strip("| ") for line in table.splitlines()[2:]]
    assert cells == ["serving.decode.b1p16", "serving.decode.b2p64",
                     "serving.prefill.b2p16", "serving.prefill.b2p64"]
    assert "| — |" in table                # the unmeasured cell's ratio
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ours.compare_markdown(prefix="coll.")


# ====================================================================== CLI
def test_cli_serving_plan_smoke(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(measure, "_CHAIN_LENS", {"O0": (2, 4), "O3": (4, 8)})
    db = tmp_path / "db.json"
    args = ["characterize", "--plan", "serving",
            "--ops", "serving.prefill.b1p16,add,fma.float32", "--device", "cpu",
            "--reps", "2", "--warmup", "0", "--db", str(db)]
    rc = cli.main(args + ["--table"])
    out = capsys.readouterr().out
    saved = LatencyDB(str(db))
    failed = saved.failures()
    # an O3 chain of a few ops may drown in host noise here; the cell may not
    assert all(f.error_type == "NoisySlopeError" and f.op != "serving.prefill.b1p16"
               for f in failed)
    assert rc == (1 if failed else 0)
    assert f"{3 - len(failed)} measured, 0 cached, {len(failed)} failed" in out
    assert "== serving predicted vs measured" in out
    assert "| serving.prefill.b1p16 | prefill | 1 | 16 | serving-tiny |" in out
    assert {r.op for r in saved.records()} | {f.op for f in failed} == {
        "add", "fma.float32", "serving.prefill.b1p16"}


def test_cli_audit_lints_the_zoo(capsys):
    assert cli.main(["audit", "--lint", "--zoo", "--archs", "granite-3-8b"]) == 0
    assert "lints clean (mapping+guards+zoo)" in capsys.readouterr().out
