"""K5's float32 tensor-core arithmetic (3xTF32 on ``mma.sync``), on the CPU.

The float32 kernel (``csrc/flash_attention.cu``, ``flash_attention_tf32_kernel``)
cannot run here, so :func:`_tiled_3xtf32` repeats its arithmetic in plain
PyTorch: warps of 16 query rows that skip the KV tiles wholly above their
last row, KV tiles of 32 keys, q scaled and then split once, every operand
split as hi = tf32(x), lo = tf32(x - hi) with the TF32 rounding of
``cvt.rna.tf32.f32`` emulated on the int32 view (round the magnitude to 10
mantissa bits, ties away from zero), each product taken as
hi.hi + hi.lo + lo.hi into float32, the online softmax in base 2 with
masked keys weighing exactly 0, and P . V read with the kernel's key
permutation (in each group of 8 keys, the A fragment's column t stands for
key 2t and column t + 4 for key 2t + 1, and V's rows are read in that
order).

Tolerances: everything is held to ``chip_smoke.py``'s float32 row-scaled
limit, ``2^-13 * (|want| + rms(want's row))``, the limit the kernel is held
to on the card (``test_torch_cuda.py``): against ``flash_attention_plain``,
the JAX package's Pallas kernel in interpret mode and ``ref_attention``, on
the same numpy inputs. Rows that see no key (causal, Sq > Sk) are 0 in the
port and NaN in ``ref_attention`` (ROADMAP Queue 3): the comparisons with
the JAX package leave them out and require them to be exactly 0. The
one-term form (1xTF32: one TF32 product) fails that limit at D 128, which is
why the kernel takes three. Three bf16 products (each operand as two bf16
terms) also stay inside it, which is why the bound in ``chip_smoke.py``
counts them at the bf16 rate.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_attention_plain)

ROOT = Path(__file__).resolve().parents[1]
WARP_ROWS, BLOCK_N = 16, 32  # the kernel's rows a warp and keys a KV tile
# column c of an 8-key A fragment stands for key KEY_OF_COLUMN[c]
KEY_OF_COLUMN = (0, 2, 4, 6, 1, 3, 5, 7)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
ROW_TOL = SMOKE.ROW_TOL[torch.float32]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the int32 view: add half of the dropped ulp
    to the magnitude, then clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest, ties to even), back in float32."""
    return x.to(torch.bfloat16).float()


def split(x: torch.Tensor, rnd=tf32) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rnd(x)
    return hi, rnd(x - hi)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int,
             rnd=tf32) -> torch.Tensor:
    """a . b as the tensor cores take it: three products (lo.hi, hi.lo,
    hi.hi) or, with ``terms=1``, hi.hi alone, the terms rounded by ``rnd``
    (TF32 as the kernel does; bf16 for the form its bound counts)."""
    ah, al = split(a, rnd)
    bh, bl = split(b, rnd)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
    return out


def _key_order(n: int) -> torch.Tensor:
    """The order in which the kernel feeds a tile's n keys to P . V."""
    return torch.tensor([8 * (i // 8) + KEY_OF_COLUMN[i % 8] for i in range(n)])


def _tiled_3xtf32(q, k, v, *, causal=True, scale=None, terms=3, rnd=tf32):
    """The 3xTF32 kernel's arithmetic in plain PyTorch (see the module
    note); ``terms=1`` takes one TF32 product instead, ``rnd=bf16`` splits
    into bf16 terms instead."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5 if scale is None else scale
    log2e = math.log2(math.e)
    qs = q.float().reshape(b, sq, kh, g, d) * scale
    kf, vf = k.float(), v.float()
    offset = sk - sq
    out = torch.zeros(b, kh, g, sq, d)
    for p0 in range(0, sq, WARP_ROWS):
        rows = torch.arange(p0, min(p0 + WARP_ROWS, sq))
        w_kend = min(sk, max(p0 + WARP_ROWS + offset, 0)) if causal else sk
        m = torch.full((b, kh, g, len(rows), 1), common.NEG_INF)
        l = torch.zeros(b, kh, g, len(rows), 1)
        acc = torch.zeros(b, kh, g, len(rows), d)
        for k0 in range(0, w_kend, BLOCK_N):
            keys = torch.arange(k0, min(k0 + BLOCK_N, sk))
            s = _product("bqkgd,bskd->bkgqs", qs[:, rows], kf[:, keys], terms, rnd)
            visible = torch.ones(len(rows), len(keys), dtype=torch.bool)
            if causal:
                visible = keys[None, :] <= rows[:, None] + offset
            s = s.masked_fill(~visible, common.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * log2e)
            p = torch.where(visible, torch.exp2((s - m_new) * log2e), 0.0)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            order = _key_order(len(keys)) if len(keys) % 8 == 0 else torch.arange(len(keys))
            acc = acc * alpha + _product("bkgqs,bskd->bkgqd", p[..., order],
                                         vf[:, keys[order]], terms, rnd)
            m = m_new
        out[..., rows, :] = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def _inputs(seed, b, sq, sk, h, kh, d):
    rng = np.random.RandomState(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _ratio(got, want) -> float:
    return SMOKE.row_scaled_ratio(torch.from_numpy(np.array(got, dtype=np.float32)),
                                  torch.from_numpy(np.array(want, dtype=np.float32)), ROW_TOL)


# ------------------------------------------------ the TF32 rounding and split
def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one_ulp = 2.0 ** -10  # TF32's ulp at 1.0
    x = torch.tensor([1.0, 1 + one_ulp / 2, 1 + one_ulp / 2 - 2 ** -23, 1 + 1.5 * one_ulp,
                      -(1 + one_ulp / 2), 3.0e-39, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + one_ulp, 1.0, 1 + 2 * one_ulp, -(1 + one_ulp),
                         tf32(torch.tensor([3.0e-39]))[0], 0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert torch.all(tf32(x).view(torch.int32) & 0x1FFF == 0)


def test_split_carries_about_22_bits():
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert rel < 2.0 ** -21, float(rel)
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max() <= 2.0 ** -11


# -------------------------------------------------------- the key order
@pytest.mark.parametrize("lane", range(32))
def test_key_order_turns_the_accumulator_into_the_a_fragment(lane):
    """m16n8k8 fragments, g = lane / 4 and t = lane % 4, as (row, column):
    S's accumulator c0..c3 = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1);
    tf32's A a0..a3 = (g, t), (g+8, t), (g, t+4), (g+8, t+4); B b0, b1 =
    (t, g), (t+4, g) as (k, n). The kernel passes c0, c2, c1, c3 as a0..a3,
    and reads V's rows 2t and 2t+1 as b0 and b1: under KEY_OF_COLUMN both
    name the same keys, so P . V needs no shuffle."""
    g, t = lane // 4, lane % 4
    acc = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]
    a_frag = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
    passed = [acc[0], acc[2], acc[1], acc[3]]
    for (row, col), (acc_row, key) in zip(a_frag, passed):
        assert row == acc_row and KEY_OF_COLUMN[col] == key
    assert (KEY_OF_COLUMN[t], KEY_OF_COLUMN[t + 4]) == (2 * t, 2 * t + 1)


def test_key_order_is_a_permutation_that_leaves_p_v_alone():
    assert sorted(KEY_OF_COLUMN) == list(range(8))
    order = _key_order(BLOCK_N)
    assert sorted(order.tolist()) == list(range(BLOCK_N))
    rng = np.random.RandomState(1)
    p = torch.from_numpy(rng.uniform(0, 1, (16, BLOCK_N)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((BLOCK_N, 64)).astype(np.float32))
    torch.testing.assert_close(_product("qs,sd->qd", p[:, order], v[order], 3),
                               _product("qs,sd->qd", p, v, 3), rtol=1e-6, atol=1e-6)


# ------------------------------------------------ K5, float32 design
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,sq,sk,h,kh,causal", [
    (1, 100, 100, 4, 4, True),     # g = 1, Sq not a multiple of 16
    (2, 100, 37, 8, 2, True),      # g = 4, Sq > Sk: 63 rows see no key
    (1, 70, 200, 8, 1, True),      # g = 8, a prefix (Sq < Sk), ragged both
    (2, 77, 150, 4, 2, False),     # non-causal, ragged both
])
def test_tiled_3xtf32_matches_pallas_ref_and_plain(b, sq, sk, h, kh, causal, d):
    (qj, kj, vj), (qt, kt, vt) = _inputs(sq + sk + d + 1, b, sq, sk, h, kh, d)
    got = _tiled_3xtf32(qt, kt, vt, causal=causal)
    assert got.dtype == torch.float32 and got.shape == qt.shape
    assert SMOKE.row_scaled_ratio(got, flash_attention_plain(qt, kt, vt, causal=causal),
                                  ROW_TOL) <= 1.0
    seen = slice(max(sq - sk, 0) if causal else 0, sq)  # rows that see a key
    if seen.start:
        assert torch.all(got[:, :seen.start] == 0)
    pallas = jax_flash_attention(qj, kj, vj, causal=causal, interpret=True)
    want = ref.ref_attention(qj, kj, vj, causal=causal)
    for other in (pallas, want):
        assert _ratio(got.numpy()[:, seen], np.asarray(other)[:, seen]) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_product_fails_the_float32_limit_at_d128_and_three_pass(causal):
    """At D 128 and 1024 keys one TF32 product (hi.hi alone) misses the
    float32 limit; the three of the kernel stay well inside it."""
    _, (q, k, v) = _inputs(23, 1, 1024, 1024, 4, 2, 128)
    want = flash_attention_plain(q, k, v, causal=causal)
    three, one = (SMOKE.row_scaled_ratio(_tiled_3xtf32(q, k, v, causal=causal, terms=t),
                                         want, ROW_TOL) for t in (3, 1))
    assert three < 0.25 < 1.0 < one, (three, one)


@pytest.mark.parametrize("causal", [True, False])
def test_three_bf16_products_hold_the_float32_limit_at_d128(causal):
    """The form behind K5 float32's bound: every operand split into two
    bf16 terms (each keeps about 2^-16 of its value) and each product taken
    as hi.hi + hi.lo + lo.hi stays inside the float32 limit at D 128 and
    1024 keys; one bf16 product misses it by far."""
    _, (q, k, v) = _inputs(23, 1, 1024, 1024, 4, 2, 128)
    want = flash_attention_plain(q, k, v, causal=causal)
    three, one = (SMOKE.row_scaled_ratio(_tiled_3xtf32(q, k, v, causal=causal, terms=t,
                                                       rnd=bf16), want, ROW_TOL)
                  for t in (3, 1))
    assert three < 0.5 < 1.0 < one, (three, one)


@pytest.mark.parametrize("causal", [True, False])
def test_chip_smoke_1xtf32_control_fails_the_float32_limit(causal):
    """chip_smoke.py's control (the plain attention with q, k, p and v
    truncated to TF32 by bit masking, as mma reads raw float32) must fail
    the limit, as the bf16 controls fail theirs."""
    _, (q, k, v) = _inputs(29, 1, 512, 512, 8, 2, 128)
    want = flash_attention_plain(q, k, v, causal=causal)
    control = SMOKE.attention_1xtf32(q, k, v, causal=causal)
    assert SMOKE.row_scaled_ratio(control, want, ROW_TOL) > 1.0


def test_fused_unit_workload_shape_fits_the_design():
    """The fused plan's attention unit workload (D 16, g 2, Sq 16, keys
    16 n) is one block: two warps of one row tile, n / 2 KV tiles."""
    from repro_torch.inkernel import build_fused, fused_kwargs

    for n in (2, 6):
        _, (q, k, v) = build_fused("flash_attention", n, "cpu")
        assert q.shape == (1, WARP_ROWS, 2, 16) and k.shape == (1, 16 * n, 1, 16)
        got = _tiled_3xtf32(q, k, v, **fused_kwargs("flash_attention"))
        want = flash_attention(q, k, v, **fused_kwargs("flash_attention"))
        assert SMOKE.row_scaled_ratio(got, want, ROW_TOL) <= 1.0


def test_bound_of_the_float32_design_is_3xtf32_on_the_tensor_cores():
    """chip_smoke.py's bound for K5 in float32 at Jamba's causal case: the
    least of float32 FMAs (0.513 ms), three TF32 products at 495 TFLOP/s
    (0.208 ms, the kernel's own form) and three bf16 products at 989
    TFLOP/s (0.104 ms), above the bytes (0.025 ms)."""
    q = torch.empty(1, 2048, 32, 128, device="meta")
    kv = torch.empty(1, 2048, 8, 128, device="meta")
    nbytes, nops, ops_s, how = SMOKE.fused_work("flash_attention", (q, kv, kv),
                                                {"causal": True})
    assert nops == 4 * 128 * 32 * (2048 * 2049 // 2)
    assert nbytes == 4 * (2 * 2048 * 32 * 128 + 2 * 2048 * 8 * 128)
    assert ops_s == pytest.approx(3 * nops / 989e12) and how.endswith(": 3xBF16")
    assert ops_s * 1e3 == pytest.approx(0.1043, abs=1e-4)
    assert "3xTF32 0.208" in how and "FMAs 0.513" in how
    assert nbytes / SMOKE.HBM_BYTES_PER_S < ops_s < nops / 67e12
