"""K6's split-KV arithmetic and K4's instance choice, on the CPU.

The split-KV kernel (``csrc/flash_decode.cu``) cannot run here, so
:func:`_split_kv_plain` repeats its arithmetic in plain PyTorch, in
float32: the cache cut into splits of ``keys_per_split`` keys; for each
split that starts below kv_len, logits in base 2 (q scaled by
log2(e) / sqrt(D)), a running max m, l = sum of 2^(s - m) and acc = sum of
2^(s - m) v over its keys below kv_len; the splits merged by log-sum-exp in
split order; the output acc / max(l, 1e-30). It is held, on the same numpy
inputs, against the JAX package's Pallas kernel in interpret mode,
``ref_decode_attention`` (where kv_len > 0; it gives NaN at 0) and
``flash_decode_plain``, to atol = rtol = 2e-5 in float32 (the JAX
package's float32 tolerance: sums in another order). bfloat16 inputs are
compared through the same float32 arithmetic on their values, and the
bfloat16 output under ``chip_smoke.py``'s row-scaled limit (one rounding
of the output). The kernel itself is held to ``flash_decode_plain`` on the
card in ``test_torch_cuda.py``.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.inkernel import FUSED_LENS, build_fused
from repro_torch.kernels import flash_decode as decode_mod
from repro_torch.kernels.flash_decode import (KEYS_PER_SPLIT, flash_decode,
                                              flash_decode_plain, split_count)
from repro_torch.kernels.rmsnorm import (DESIGNS, ROW_IN_REGISTERS, VEC, rmsnorm,
                                         rmsnorm_plain, rmsnorm_plan)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


def _split_kv_plain(q, k, v, kv_len, keys_per_split):
    """The split-KV kernel's arithmetic (see the module note); float32 [B,H,D]."""
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, kh, g, d) * (d ** -0.5 * math.log2(math.e))
    kf, vf = k.float(), v.float()
    out = torch.zeros(b, kh, g, d)
    for bi in range(b):
        n = min(max(int(kv_len[bi]), 0), s)
        parts = []  # (m, l, acc) of each live split, in split order
        for k0 in range(0, n, keys_per_split):
            keys = slice(k0, min(k0 + keys_per_split, n))
            logits = torch.einsum("kgd,skd->kgs", qf[bi], kf[bi, keys])
            m = logits.amax(dim=-1, keepdim=True)
            p = torch.exp2(logits - m)
            parts.append((m, p.sum(dim=-1, keepdim=True),
                          torch.einsum("kgs,skd->kgd", p, vf[bi, keys])))
        if not parts:  # kv_len 0: no live split, acc 0, l 0
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l = sum(torch.exp2(m - mx) * ls for m, ls, _ in parts)
        acc = sum(torch.exp2(m - mx) * a for m, _, a in parts)
        out[bi] = acc / l.clamp_min(1e-30)
    return out.reshape(b, h, d)


def _decode_inputs(seed, b, s, h, kh, d, lens, dtype):
    rng = np.random.RandomState(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, d), (b, s, kh, d), (b, s, kh, d))]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ts = [torch.from_numpy(a).to(tdt) for a in arrays]
    f32 = [t.float() for t in ts]  # the inputs' values, in float32
    return ts, f32, np.asarray(lens, np.int32)


@pytest.mark.parametrize("keys_per_split", [16, 32])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_kv_plain_matches_pallas_ref_and_plain(dtype, g, d, keys_per_split):
    kps, kh = keys_per_split, 2
    s = 3 * kps + 5
    # 0; 1 and kps - 1 (every split but the first empty); kps; kps + 1; S
    lens = (0, 1, kps - 1, kps, kps + 1, s)
    (qt, kt, vt), (qf, kf, vf), kv_len = _decode_inputs(
        g * 100 + d + kps, len(lens), s, g * kh, kh, d, lens, dtype)
    lens_t = torch.from_numpy(kv_len)
    got = _split_kv_plain(qt, kt, vt, lens_t, kps)
    assert got.dtype == torch.float32 and got.shape == qt.shape
    assert torch.isfinite(got).all()
    assert torch.all(got[0] == 0)                      # kv_len 0
    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (qf, kf, vf))
    pallas = np.asarray(jax_flash_decode(qj, kj, vj, jnp.asarray(kv_len), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **F32_TOL)
    oracle = np.asarray(ref.ref_decode_attention(qj, kj, vj, jnp.asarray(kv_len)))
    np.testing.assert_allclose(got.numpy()[1:], oracle[1:], **F32_TOL)
    assert np.all(np.isnan(oracle[0]))                 # the oracle's NaN at kv_len 0
    np.testing.assert_allclose(got.numpy(), flash_decode_plain(qf, kf, vf, lens_t).numpy(),
                               **F32_TOL)
    if dtype == "bfloat16":  # the Pallas kernel on the bfloat16 inputs themselves
        pallas_bf16 = jax_flash_decode(*(jnp.asarray(t.numpy()).astype(jnp.bfloat16)
                                         for t in (qf, kf, vf)),
                                       jnp.asarray(kv_len), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas_bf16, np.float32),
                                   **BF16_TOL)
    # the output in the inputs' dtype: one rounding of the float32 result
    want = flash_decode_plain(qt, kt, vt, lens_t)
    tol = SMOKE.ROW_TOL[want.dtype]
    assert SMOKE.row_scaled_ratio(got.to(want.dtype), want, tol) <= 1.0


def test_split_kv_plain_is_blind_to_the_split_size():
    """Only the order of the float32 sums depends on keys_per_split."""
    (qt, kt, vt), _, kv_len = _decode_inputs(3, 3, 200, 8, 2, 32, (200, 77, 0), "float32")
    lens = torch.from_numpy(kv_len)
    one = _split_kv_plain(qt, kt, vt, lens, 512)
    for kps in (16, 64, 128):
        torch.testing.assert_close(_split_kv_plain(qt, kt, vt, lens, kps), one, **F32_TOL)


def test_split_count_and_the_fused_unit_workloads_fit_one_split():
    """The fused plan's decode row walks at most 96 keys: one split, so the
    first pass writes the output and its slope times keys, not launch
    width. Past KEYS_PER_SPLIT keys the cache splits."""
    assert KEYS_PER_SPLIT % 64 == 0    # flash_decode.cu's kSplitMultiple
    assert [split_count(s) for s in (1, 511, 512, 513, 8192, 32768)] == [1, 1, 1, 2, 16, 64]
    for n in FUSED_LENS:
        _, (q, k, v, kv_len) = build_fused("flash_decode", n, "cpu")
        assert split_count(k.shape[1]) == 1 and int(kv_len.max()) <= 96
    assert decode_mod.DESIGNS[torch.bfloat16].startswith("split-KV")


def test_flash_decode_wrapper_on_cpu_tensors_runs_the_plain_version():
    (qt, kt, vt), _, kv_len = _decode_inputs(5, 2, 600, 8, 2, 64, (600, 0), "bfloat16")
    lens = torch.from_numpy(kv_len)
    before = flash_decode.launches
    got = flash_decode(qt, kt, vt, lens)
    assert flash_decode.launches == before
    assert torch.equal(got, flash_decode_plain(qt, kt, vt, lens))
    assert torch.all(got[1].float() == 0)


# --------------------------------------------------------------------- K4
@pytest.mark.parametrize("rows,d", [(6, 7), (4, 1001), (3, 4100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_wrapper_on_cpu_at_widths_off_the_vector(rows, d, dtype):
    """Widths that are not a multiple of 8 (bfloat16) or 4 (float32, but
    4100) take the scalar instance on the card; on the CPU the wrapper runs
    the plain version, held against the Pallas kernel and ref_rmsnorm."""
    rng = np.random.RandomState(rows + d)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16"
                else (torch.float32, jnp.float32))
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    before = rmsnorm.launches
    got = rmsnorm(xt, wt)
    assert rmsnorm.launches == before and torch.equal(got, rmsnorm_plain(xt, wt))
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jax_rmsnorm(xj, wj, interpret=True), np.float32),
                               **tol)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.ref_rmsnorm(xj, wj), np.float32), **tol)
    plan = rmsnorm_plan(d, tdt, aligned=True)
    assert plan.vec == (VEC[tdt] if d % VEC[tdt] == 0 else 1)


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (64, torch.float32, True, (4, 1, 128, True, False)),      # the fused plan's rows
    (4096, torch.bfloat16, True, (8, 2, 256, False, False)),  # Jamba: 16 values a thread
    (4096, torch.bfloat16, False, (1, 4, 1024, False, False)),
    (1000, torch.bfloat16, True, (8, 4, 128, True, False)),   # 1000 = 125 * 8
    (4100, torch.bfloat16, True, (1, 8, 544, False, False)),
    (4100, torch.float32, True, (4, 2, 544, False, False)),
    (8192, torch.bfloat16, True, (8, 2, 512, False, False)),
    (8192, torch.float32, True, (4, 2, 1024, False, False)),
    (7, torch.bfloat16, True, (1, 1, 128, True, False)),
    (9000, torch.bfloat16, True, (8, 8, 128, False, True)),   # past the registers
])
def test_rmsnorm_plan_picks_the_instance(d, dtype, aligned, want):
    plan = rmsnorm_plan(d, dtype, aligned)
    assert tuple(plan) == want
    held = plan.nv * plan.vec * (32 if plan.warp_per_row else plan.threads)
    assert (held < d) == plan.reread
    if not plan.warp_per_row:  # a block holds at most ROW_IN_REGISTERS elements
        assert plan.threads % 32 == 0 and plan.nv * plan.vec * plan.threads <= ROW_IN_REGISTERS
    assert plan.design.startswith("16-byte vectors" if plan.vec > 1 else "scalar")
    assert set(DESIGNS) == {torch.float32, torch.bfloat16}
