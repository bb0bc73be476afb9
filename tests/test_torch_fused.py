"""Port parity for the fused kernels K4-K7 and the ``fused`` plan on the CPU.

Each wrapper's plain version (what it runs for CPU tensors) is held against
the JAX package's Pallas kernel in interpret mode and against its jnp
oracle (``repro.kernels.ref``), on the same numpy inputs, over the sweeps of
``tests/test_kernels.py``. The kernels themselves are held against these
plain versions on the card in ``test_torch_cuda.py``.

Tolerances are the JAX package's own at these shapes
(``tests/test_kernels.py:12-14, :104``): float32 2e-5, bfloat16 3e-2 (one
bf16 rounding of outputs of order 1, plus the ulp by which the two
frameworks' float32 sums may differ before it), the scan 5e-5 (a
recurrence over up to 100 steps of float32 exp and multiply-adds, summed
in another order).

Two deliberate divergences from the oracles, in both packages' kernels:
``flash_decode`` with ``kv_len = 0`` is 0 (``ref_decode_attention`` gives
NaN), and a causal query row that sees no key (Sq > Sk) is 0 in the port
(the TPU kernel's value there depends on its block sizes;
``ref_attention`` gives NaN). The tests state both outputs.
"""
import importlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.api import plan as jax_plan
from repro.inkernel import fused as jax_fused
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch import inkernel
from repro_torch.api import FusedKernelProbe, Plan, cli, named_plan
from repro_torch.core.latency_db import LatencyDB
from repro_torch.core.timing import Timer
from repro_torch.kernels import common, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.mamba_scan import mamba_scan, softplus
from repro_torch.kernels.rmsnorm import rmsnorm

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
SCAN_TOL = dict(atol=5e-5, rtol=5e-5)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(arrays, dtype):
    """The same numpy float32 arrays as jax and torch arrays of ``dtype``
    (both round float32 to bfloat16 to nearest even: the same bits)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _unlaunched(fn, *args, **kwargs):
    """Run a wrapper on CPU tensors: its plain version, no kernel launch."""
    before = fn.launches
    out = fn(*args, **kwargs)
    assert fn.launches == before
    return out


# --------------------------------------------------------------------- K4
@pytest.mark.parametrize("rows,d", [(64, 128), (96, 256), (256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_and_ref(rows, d, dtype):
    rng = np.random.RandomState(rows + d)
    (xj, wj), (xt, wt) = _both([_normal(rng, (rows, d)), _normal(rng, (d,))], dtype)
    got = _unlaunched(rmsnorm, xt, wt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(jax_rmsnorm(xj, wj, interpret=True)), **tol)
    np.testing.assert_allclose(_np(got), _np(ref.ref_rmsnorm(xj, wj)), **tol)


def test_rmsnorm_takes_leading_dims():
    rng = np.random.RandomState(5)
    (xj, wj), (xt, wt) = _both([_normal(rng, (2, 3, 40)), _normal(rng, (40,))], "float32")
    np.testing.assert_allclose(_np(rmsnorm(xt, wt)), _np(ref.ref_rmsnorm(xj, wj)), **F32_TOL)


# --------------------------------------------------------------------- K5
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kh,d", [
    (1, 128, 128, 4, 4, 64),     # MHA square
    (2, 128, 128, 4, 2, 32),     # GQA
    (1, 64, 192, 6, 3, 16),      # sq != sk (prefix cache)
    (2, 256, 256, 8, 1, 64),     # MQA
])
def test_flash_attention_plain_matches_pallas_and_ref(b, sq, sk, h, kh, d, dtype):
    rng = np.random.RandomState(sq + h)
    arrays = [_normal(rng, (b, sq, h, d)), _normal(rng, (b, sk, kh, d)),
              _normal(rng, (b, sk, kh, d))]
    (qj, kj, vj), (qt, kt, vt) = _both(arrays, dtype)
    got = _unlaunched(flash_attention, qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(
        _np(got), _np(jax_flash_attention(qj, kj, vj, causal=True, interpret=True)), **tol)
    np.testing.assert_allclose(_np(got), _np(ref.ref_attention(qj, kj, vj, causal=True)),
                               **tol)


def test_flash_attention_plain_noncausal():
    rng = np.random.RandomState(11)
    arrays = [_normal(rng, (2, 64, 4, 32)), _normal(rng, (2, 96, 2, 32)),
              _normal(rng, (2, 96, 2, 32))]
    (qj, kj, vj), (qt, kt, vt) = _both(arrays, "float32")
    got = _unlaunched(flash_attention, qt, kt, vt, causal=False)
    np.testing.assert_allclose(
        _np(got), _np(jax_flash_attention(qj, kj, vj, causal=False, interpret=True)),
        **F32_TOL)
    np.testing.assert_allclose(_np(got), _np(ref.ref_attention(qj, kj, vj, causal=False)),
                               **F32_TOL)


def test_flash_attention_causal_rows_that_see_no_key():
    """Deliberate divergence (ROADMAP Queue 3): causal with Sq = 64 > Sk = 32,
    so query rows 0..31 sit before the first key. The port gives those rows
    0; ref_attention gives NaN; the TPU kernel (one 64 x 32 block here)
    gives the mean of v over the block's keys, a value that depends on its
    block sizes. The other rows agree in all three."""
    rng = np.random.RandomState(12)
    arrays = [_normal(rng, (1, 64, 2, 16)), _normal(rng, (1, 32, 1, 16)),
              _normal(rng, (1, 32, 1, 16))]
    (qj, kj, vj), (qt, kt, vt) = _both(arrays, "float32")
    got = _np(flash_attention(qt, kt, vt, causal=True))
    want_ref = _np(ref.ref_attention(qj, kj, vj, causal=True))
    want_tpu = _np(jax_flash_attention(qj, kj, vj, causal=True, interpret=True))
    blind = slice(0, 32)
    assert np.all(got[:, blind] == 0.0)
    assert np.all(np.isnan(want_ref[:, blind]))
    mean_v = arrays[2].mean(axis=1, keepdims=True)          # [1, 1, 1, 16]
    np.testing.assert_allclose(want_tpu[:, blind], np.broadcast_to(mean_v, (1, 32, 2, 16)),
                               **F32_TOL)
    np.testing.assert_allclose(got[:, 32:], want_ref[:, 32:], **F32_TOL)
    np.testing.assert_allclose(got[:, 32:], want_tpu[:, 32:], **F32_TOL)


# --------------------------------------------------------------------- K6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d", [(2, 256, 8, 2, 64), (3, 128, 4, 4, 32),
                                        (1, 512, 2, 1, 128)])
def test_flash_decode_plain_matches_pallas_and_ref(b, s, h, kh, d, dtype):
    rng = np.random.RandomState(s + b)
    arrays = [_normal(rng, (b, h, d)), _normal(rng, (b, s, kh, d)),
              _normal(rng, (b, s, kh, d))]
    kv_len = np.asarray([max(s - 13 * i, 1) for i in range(b)], np.int32)  # ragged
    (qj, kj, vj), (qt, kt, vt) = _both(arrays, dtype)
    got = _unlaunched(flash_decode, qt, kt, vt, torch.from_numpy(kv_len))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(
        _np(got), _np(jax_flash_decode(qj, kj, vj, jnp.asarray(kv_len), interpret=True)),
        **tol)
    np.testing.assert_allclose(
        _np(got), _np(ref.ref_decode_attention(qj, kj, vj, jnp.asarray(kv_len))), **tol)


def test_flash_decode_empty_cache_row_is_zero():
    """Deliberate divergence from the oracle, shared with the TPU kernel:
    kv_len = 0 gives 0 in both kernels (every KV block is skipped, acc / max(l,
    1e-30) = 0) and NaN in ref_decode_attention. The other rows agree."""
    rng = np.random.RandomState(13)
    arrays = [_normal(rng, (3, 4, 32)), _normal(rng, (3, 64, 2, 32)),
              _normal(rng, (3, 64, 2, 32))]
    kv_len = np.asarray([64, 0, 17], np.int32)
    (qj, kj, vj), (qt, kt, vt) = _both(arrays, "float32")
    got = _np(flash_decode(qt, kt, vt, torch.from_numpy(kv_len)))
    want_tpu = _np(jax_flash_decode(qj, kj, vj, jnp.asarray(kv_len), interpret=True,
                                    block_k=16))
    want_ref = _np(ref.ref_decode_attention(qj, kj, vj, jnp.asarray(kv_len)))
    assert np.all(got[1] == 0.0) and np.all(want_tpu[1] == 0.0)
    assert np.all(np.isnan(want_ref[1]))
    for row in (0, 2):
        np.testing.assert_allclose(got[row], want_ref[row], **F32_TOL)
        np.testing.assert_allclose(got[row], want_tpu[row], **F32_TOL)


# --------------------------------------------------------------------- K7
def _scan_inputs(b, s, dm, n, seed):
    rng = np.random.RandomState(seed)
    return [_normal(rng, (b, s, dm), 0.5), _normal(rng, (b, s, dm), 0.1),
            -np.exp(_normal(rng, (dm, n), 0.3)), _normal(rng, (b, s, n), 0.5),
            _normal(rng, (b, s, n), 0.5), _normal(rng, (dm,), 0.1)]


@pytest.mark.parametrize("b,s,dm,n,chunk", [
    (2, 64, 16, 8, 16), (1, 96, 8, 4, 32),
    (1, 100, 8, 16, 32),   # a chunk that does not divide S (both cut it to 25)
])
def test_mamba_scan_plain_matches_pallas_and_ref(b, s, dm, n, chunk):
    arrays = _scan_inputs(b, s, dm, n, seed=s + n)
    js, ts = _both(arrays, "float32")
    got = _unlaunched(mamba_scan, *ts, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (b, s, dm)
    np.testing.assert_allclose(_np(got), _np(jax_mamba_scan(*js, chunk=chunk, interpret=True)),
                               **SCAN_TOL)
    want, _ = ref.ref_selective_scan(*js)
    np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)


def test_softplus_is_the_stable_form_of_jax():
    import jax

    x = np.linspace(-60, 60, 1001, dtype=np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------- input checks
def test_fused_wrappers_reject_bad_inputs():
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="H % KH"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attention(q, k[..., :8], k)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, kv.transpose(1, 2).contiguous().transpose(1, 2), kv)
    with pytest.raises(TypeError, match="int32"):
        flash_decode(torch.zeros(1, 4, 16), kv, kv, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="w \\[D\\]"):
        rmsnorm(torch.zeros(4, 8), torch.zeros(7))
    with pytest.raises(TypeError, match="float32"):
        rmsnorm(torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(8))
    x = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="do not fit"):
        mamba_scan(x, x, torch.zeros(4, 4), torch.zeros(1, 8, 3), torch.zeros(1, 8, 4),
                   torch.zeros(4))
    with pytest.raises(ValueError, match="chunk"):
        mamba_scan(x, x, torch.zeros(4, 4), torch.zeros(1, 8, 4), torch.zeros(1, 8, 4),
                   torch.zeros(4), chunk=0)


def test_common_helpers_match_jax():
    from repro.kernels import common as jax_common

    assert common.NEG_INF == jax_common.NEG_INF
    for dim in (1, 7, 96, 100, 512, 1000):
        for pref in (1, 16, 32, 128, 512):
            assert common.pick_block(dim, pref) == jax_common.pick_block(dim, pref)
            assert common.cdiv(dim, pref) == jax_common.cdiv(dim, pref)
    assert [k.__name__ for k in ops.KERNELS] == [
        "alu_chain", "op_chain", "chase", "rmsnorm", "flash_attention", "flash_decode",
        "mamba_scan"]


# ------------------------------------------------------------ unit workloads
@pytest.mark.parametrize("n", inkernel.FUSED_LENS)
@pytest.mark.parametrize("name", inkernel.FUSED_KERNELS)
def test_build_fused_matches_jax_bit_for_bit(name, n):
    jfn, jargs = jax_fused.build_fused(name, n, interpret=True)
    tfn, targs = inkernel.build_fused(name, n, "cpu")
    assert len(targs) == len(jargs)
    for t, j in zip(targs, jargs):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), j)  # bit for bit
    got = _np(tfn(*targs))
    want = _np(jfn(*jargs))
    assert got.shape == want.shape
    tol = SCAN_TOL if name == "mamba_scan" else F32_TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name", inkernel.FUSED_KERNELS)
def test_fused_kwargs_are_those_of_the_unit_workload(name):
    # the plain version called with fused_kwargs(name) computes what the
    # unit workload's callable does (on the CPU both are the plain path)
    fn, args = inkernel.build_fused(name, 2, "cpu")
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    got = getattr(mod, f"{name}_plain")(*args, **inkernel.fused_kwargs(name))
    torch.testing.assert_close(got, fn(*args), rtol=0, atol=0)
    if name == "flash_attention":  # the default would be causal
        other = getattr(mod, f"{name}_plain")(*args)
        assert not torch.equal(other, got)


def test_unit_bytes():
    assert {n: inkernel.unit_bytes(n) for n in inkernel.FUSED_KERNELS} == {
        "flash_attention": 2048, "flash_decode": 2048, "mamba_scan": 1024,
        "rmsnorm": 4096}


def test_build_fused_defaults_to_the_card():
    if torch.cuda.is_available():
        assert inkernel.build_fused("rmsnorm", 2)[1][0].device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inkernel.build_fused("rmsnorm", 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inkernel.prepare_fused("rmsnorm")
    with pytest.raises(ValueError, match="unknown fused kernel"):
        inkernel.build_fused("softmax", 2, "cpu")


def test_measure_fused_full_on_the_timers_device():
    """The serial form: the scan's 8 serial steps a unit give a positive
    slope even on the host clock; the workload lands on the timer's device."""
    m = inkernel.measure_fused_full("mamba_scan", timer=Timer(warmup=0, reps=3, device="cpu"),
                                    reps=3)
    assert m.median_ns > 0 and m.n == 3


# -------------------------------------------------------------------- plan
def _keys(plan):
    return [(p.logical_key(), sorted(p.match_names())) for p in plan]


def test_fused_plan_keys_match_jax():
    assert _keys(named_plan("fused")) == _keys(jax_plan.named_plan("fused"))
    assert named_plan("fused").name == "fused"
    assert _keys(Plan.fused(lens=(2, 10))) == _keys(jax_plan.Plan.fused(lens=(2, 10)))
    assert [p.op for p in Plan.fused(lens=(2, 10))][0] == "inkernel.fused.flash_attention.l2-10"
    for p in named_plan("fused"):
        assert (p.opt_level, p.dtype, p.category, p.reps) == ("O3", "float32", "kernel", 5)
    with pytest.raises(ValueError, match="unknown fused kernel"):
        FusedKernelProbe("softmax")


def test_fused_plan_end_to_end_on_cpu(tmp_path, capsys):
    db_path = tmp_path / "fused.json"
    args = ["characterize", "--plan", "fused", "--db", str(db_path), "--device", "cpu",
            "--reps", "3", "--warmup", "1", "--table"]
    before = {k.__name__: k.launches for k in ops.KERNELS}
    rc = cli.main(args)
    out = capsys.readouterr().out
    assert {k.__name__: k.launches for k in ops.KERNELS} == before  # CPU: plain versions
    db = LatencyDB(str(db_path))
    rows = {r.op: r for r in db.records()}
    failed = {f.op: f for f in db.failures()}
    assert set(rows) | set(failed) == {p.op for p in jax_plan.named_plan("fused")}
    assert not set(rows) & set(failed)
    # the host clock cannot resolve a few-microsecond slope on a shared CPU;
    # the scan's is hundreds of sequential steps, and always positive
    assert all(f.error_type == "NoisySlopeError" for f in failed.values())
    scan = rows["inkernel.fused.mamba_scan"]
    assert scan.latency_ns > 0 and scan.n_samples > 0
    for name, rec in rows.items():
        unit = inkernel.unit_bytes(name.rsplit(".", 1)[1])
        assert rec.notes.startswith(f"plain fused kernel lens=2-6 unit_bytes={unit}")
        assert "clock=host" in rec.notes and rec.backend == "cpu"
        assert (rec.opt_level, rec.dtype, rec.category) == ("O3", "float32", "kernel")
    assert rc == (1 if failed else 0)
    assert f"{len(rows)} measured, 0 cached, {len(failed)} failed (4 probes)" in out
    assert "| kernel | inkernel.fused.mamba_scan | float32 |" in out
    # resume: every record is a cache hit; only the failed rows run again
    cli.main(args[:-1])
    m = re.search(r"(\d+) measured, (\d+) cached, (\d+) failed \(4 probes\)",
                  capsys.readouterr().out)
    assert m and int(m[2]) == len(rows) and int(m[1]) + int(m[3]) == len(failed)
