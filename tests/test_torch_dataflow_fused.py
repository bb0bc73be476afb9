"""The fused half of the dataflow audit against the JAX package's.

``repro_torch.audit.dataflow.fused_unit`` gives each fused kernel's unit
signature from the op record of its blocked plain form: the reference
kernel's arithmetic one grid step at a time. It is held here against the
JAX package's ``fused_unit``, which reads the Pallas kernel's jaxpr. On
jax 0.9.0 that one raises (ROADMAP R5); two names put back in this test
file alone let it run: ``BlockMapping.array_shape_dtype`` (now
``array_aval``) and ``jax.core.Literal`` (now ``jax._src.core.Literal``).
Where the two multisets differ, each difference is named with its cause:
the JAX count also takes the grid's bookkeeping inside the kernel (index
arithmetic, the ``pl.when`` guards, the once-a-row finish branch counted at
every grid step) and the query's scaling at every KV block, and JAX's
softplus is ``logaddexp(x, 0)`` with its NaN branch. The bytes follow the
port's rule (``inkernel.measure.unit_bytes``); the JAX count reads every
block dimension as 1 on jax 0.9.0.
"""
import pytest
import torch

from repro_torch.audit import artifacts, audit_target, dataflow, lint, run_lints
from repro_torch.api import cli
from repro_torch.inkernel import FUSED_KERNELS, FUSED_LENS
from repro_torch.inkernel.measure import unit_bytes

CPU = {"device_kind": "cpu", "backend": "cpu", "jax_version": "torch-x+cpu"}
CARD = {"device_kind": "NVIDIA H100 80GB HBM3", "backend": "cuda", "jax_version": "torch-x"}

# what the JAX count has beyond the port's, a unit, by cause
GUARDS = "the pl.when guards of the grid step (ki == 0, ki == num_k - 1, k_start < kv_len)"
FINISH = "the finish branch, max(l, 1e-30) and acc / l, counted at every grid step"
INDEX = "the block's index arithmetic (qi * block_q + sk - sq, ki * block_k)"
SCALE = "the query block scaled at every KV block, where the port scales it once"
LOGADDEXP = "jax.nn.softplus is logaddexp(x, 0): x - 0, isnan, the NaN arm's add, a select"
LOOP = "fori_loop's counter, t + 1, a step"
DIFFERENCES = {
    "rmsnorm": {},
    "flash_attention": {  # two grid steps (heads) a unit
        "add": (2, INDEX), "compare": (4, GUARDS), "divide": (2, FINISH),
        "maximum": (2, FINISH), "multiply": (6, f"{SCALE}; {INDEX}")},
    "flash_decode": {  # one grid step a unit
        "compare": (3, GUARDS), "divide": (1, FINISH), "maximum": (1, FINISH),
        "multiply": (2, f"{SCALE}; {INDEX}")},
    "mamba_scan": {  # eight time steps and one grid step a unit
        "add": (16, f"{LOGADDEXP}; {LOOP}"), "compare": (9, f"{LOGADDEXP}; {GUARDS}"),
        "select": (8, LOGADDEXP), "subtract": (8, LOGADDEXP)},
}


@pytest.fixture
def jax_dataflow(monkeypatch):
    """The JAX package's dataflow module with the two names of jax 0.9.0
    put back (this test's process only)."""
    import jax
    import jax._src.core
    from jax._src.pallas import core as pallas_core

    from repro.audit import dataflow as jax_df

    monkeypatch.setattr(pallas_core.BlockMapping, "array_shape_dtype",
                        property(lambda self: self.array_aval), raising=False)
    monkeypatch.setattr(jax.core, "Literal", jax._src.core.Literal, raising=False)
    return jax_df


@pytest.mark.parametrize("name", FUSED_KERNELS)
def test_fused_unit_ops_are_the_jax_packages_but_for_named_causes(name, jax_dataflow):
    mine = dataflow.fused_unit(name, FUSED_LENS)["ops"]
    theirs = jax_dataflow.fused_unit(name, FUSED_LENS)["ops"]
    assert not [k for k in mine if k.startswith("aten:")]  # every op named
    explained = dict(mine)
    for prim, (count, cause) in DIFFERENCES[name].items():
        assert cause
        explained[prim] = explained.get(prim, 0) + count
    assert explained == theirs


@pytest.mark.parametrize("name", FUSED_KERNELS)
def test_fused_unit_bytes_follow_the_ports_rule(name, jax_dataflow):
    unit = dataflow.fused_unit(name, FUSED_LENS)
    assert unit["bytes"] == unit_bytes(name)  # what the rows' notes say
    n1, n2 = FUSED_LENS
    total = unit["total_bytes"]
    assert total[n2] - total[n1] == (n2 - n1) * unit["bytes"]
    if name == "rmsnorm":
        assert unit["bytes"] == 4096  # tests/test_dataflow.py's expectation
    # R5: jax 0.9.0 reads every block dimension as 1 (4 bytes a block)
    assert jax_dataflow.fused_unit(name, FUSED_LENS)["bytes"] < unit["bytes"]


@pytest.mark.parametrize("name", FUSED_KERNELS)
@pytest.mark.parametrize("n", FUSED_LENS)
def test_blocked_forms_compute_what_the_plain_versions_compute(name, n):
    fn, args, kw = dataflow.fused_workload(name, n)
    want = fn(*args, **kw)
    got = dataflow.BLOCKED[name](*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_causal_unit_workload_stays_linear_in_both_packages(jax_dataflow, monkeypatch):
    """Its one query block sits at the end of the keys (the causal mask is
    bottom-right aligned in both packages), so it sees every KV block."""
    mine = dataflow.audit_fused("flash_attention", overrides={"causal": True}, env=CPU)
    assert mine.status == "unaudited" and mine.cause == "no-device-code"
    assert "unit_bytes=2048" in mine.detail
    from repro.inkernel import fused as jax_fused
    from repro.kernels.flash_attention import flash_attention

    build = jax_fused.build_fused

    def causal(name, n, interpret=None):
        fn, args = build(name, n, interpret=interpret)
        return (lambda q, k, v: flash_attention(q, k, v, causal=True, block_q=16, block_k=16,
                                                interpret=interpret)), args

    monkeypatch.setattr(jax_fused, "build_fused", causal)
    jax_dataflow.fused_unit.cache_clear()
    try:
        assert jax_dataflow.audit_fused("flash_attention").status == "audited"
    finally:
        jax_dataflow.fused_unit.cache_clear()


def test_causal_self_attention_is_transformed_and_an_unknown_kernel_unaudited():
    v = dataflow.audit_fused("flash_attention", overrides={"causal": True}, query_grows=True,
                             env=CPU)
    assert v.status == "transformed" and v.cause == "nonlinear-signature"
    # per unit the masked blocks it skips grow with n: two points alone
    # cannot tell (a polynomial's delta divides), the third does
    assert "at n 2->6" in v.detail and "at n 6->10" in v.detail
    unknown = dataflow.audit_fused("nope", env=CPU)
    assert (unknown.status, unknown.cause) == ("unaudited", "unknown-kernel-op")
    with pytest.raises(ValueError):
        dataflow.fused_unit("nope", FUSED_LENS)


def test_nonlinear_traffic_is_named():
    """A workload whose bytes do not grow (the keys fixed, only a keyword
    changed) is nonlinear-traffic."""
    real = dataflow.fused_workload

    def fixed(name, n, overrides=None):
        return real(name, 2, overrides)

    mp = pytest.MonkeyPatch()
    mp.setattr(dataflow, "fused_workload", fixed)
    dataflow.fused_unit.cache_clear()
    try:
        v = dataflow.audit_fused("rmsnorm", env=CPU)
    finally:
        mp.undo()
        dataflow.fused_unit.cache_clear()
    assert v.status == "transformed" and v.cause == "nonlinear-traffic"


def test_audit_target_routes_fused_rows_to_the_fused_half():
    v = audit_target("inkernel.fused.rmsnorm", "O3", env=CPU)
    # on the CPU there is no SASS: what the K1-K3 half gives there
    assert (v.status, v.cause) == ("unaudited", "no-device-code")
    assert "unit_bytes=4096 unit_ops=[add=1 divide=1 multiply=3 reduce=1 rsqrt=1]" in v.detail
    with_lens = audit_target("inkernel.fused.mamba_scan.l2-6", "O3", env=CPU)
    assert "unit_bytes=1024" in with_lens.detail
    assert audit_target("inkernel.fused.nope", "O3", env=CPU).cause == "unknown-kernel-op"


def _sass(lines):
    return [f"        /*{i * 16:04x}*/                   {ln} ;" for i, ln in enumerate(lines)]


def test_residency_reads_the_instances_sass_and_ptxas_spills(monkeypatch):
    """On the card: the instances the unit workload launches must hold no
    local-memory access and no spill (SASS and ptxas's report written here)."""
    name = "_ZN4anon14rmsnorm_kernelIfLi4ELi1ELb1EEEvPKT_S3_PS1_xif"
    other = "_ZN4anon14rmsnorm_kernelIfLi1ELi1ELb0EEEvPKT_S3_PS1_xif"
    sass = {name: _sass(["LDG.E.128 R4, [R2.64]", "FFMA R4, R4, R5, R6", "EXIT"]),
            other: _sass(["LDL R1, [R1]"])}
    spills = {name: (0, 0)}
    monkeypatch.setattr(artifacts, "library_sass", lambda lib: sass)
    monkeypatch.setattr(dataflow, "_spills", lambda lib: spills)
    monkeypatch.setattr(dataflow, "_no_device_code", lambda op, level, env: None)
    assert dataflow.fused_instances("rmsnorm") == [name]  # not the scalar instance
    v = dataflow.audit_fused("rmsnorm", env=CARD)
    assert v.status == "audited" and "unit_bytes=4096" in v.detail
    sass[name] = _sass(["STL [R1], R4", "LDL R4, [R1]"])
    v = dataflow.audit_fused("rmsnorm", env=CARD)
    assert v.status == "transformed" and v.cause.startswith("residency-mismatch")
    sass[name] = _sass(["FFMA R4, R4, R5, R6"])
    spills[name] = (8, 8)
    assert dataflow.audit_fused("rmsnorm", env=CARD).cause.startswith("residency-mismatch")
    sass.clear()
    assert dataflow.audit_fused("rmsnorm", env=CARD).cause == "artifact-missing"


def test_run_lints_dataflow_no_longer_raises(capsys):
    assert run_lints(dataflow=True) == []
    assert cli.main(["audit", "--lint", "--dataflow"]) == 0
    assert "lints clean (mapping+guards+dataflow)" in capsys.readouterr().out
    # a card's environment without cuobjdump: every family skipped, none failed
    assert lint.lint_dataflow(env=CARD) == []


def test_lint_dataflow_reports_a_transformed_family(monkeypatch):
    real = dataflow.audit_fused

    def broken(name, *a, **kw):
        if name == "flash_decode":
            return dataflow.ChainVerdict("inkernel.fused.flash_decode", "O3", "transformed",
                                         cause="nonlinear-signature")
        return real(name, *a, **kw)

    monkeypatch.setattr(dataflow, "audit_fused", broken)
    found = lint.lint_dataflow(env=CPU)
    assert [(f.lint, f.subject) for f in found] == [("dataflow", "inkernel.fused.flash_decode@O3")]
