"""K5's bfloat16 tensor-core arithmetic and K1's clock sandwich, on the CPU.

The bf16 kernel (``csrc/flash_attention.cu``, the ``wgmma`` design) cannot
run here, so :func:`_tiled_bf16` repeats its arithmetic in plain PyTorch:
query tiles of 64 rows that skip the KV tiles wholly above their last row,
KV tiles of 64 keys, logits in float32 from bf16 inputs, the online softmax
in base 2 with the scale folded into the exponent, masked keys weighing
exactly 0, ``l`` summing float32 p, and p entering P . V as two bf16 terms
(hi = bf16(p), lo = bf16(p - hi)) against float32 accumulators. It is held,
on the same numpy inputs, against the JAX package's Pallas kernel in
interpret mode and ``ref_attention`` within the JAX package's bf16
tolerance (3e-2, ``tests/test_kernels.py``), and against
``flash_attention_plain`` within ``chip_smoke.py``'s bf16 row-scaled limit
(``2^-7 * (|want| + rms(want's row))``), the limit the kernel is held to
on the card. The kernel itself is held to that limit in
``test_torch_cuda.py``.

Rows that see no key (causal, Sq > Sk) are 0 in the port and NaN in
``ref_attention`` (ROADMAP Queue 3); the comparisons with the JAX package
leave them out and require them to be exactly 0.

K1's timed form and the SM clock exist only on a card: here they raise,
and the kernel row keeps the host clock.
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
from repro_torch.api import Plan, Session
from repro_torch.core.timing import Timer, sm_clock_hz
from repro_torch.kernels import _build, common
from repro_torch.kernels.alu_chain import alu_chain_timed, sm_clock_sample
from repro_torch.kernels.flash_attention import (DESIGNS, HEAD_DIMS, flash_attention,
                                                 flash_attention_plain)

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _chip_smoke():
    """chip_smoke.py as a module: its limits and controls, without a card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
ROW_TOL = SMOKE.ROW_TOL[torch.bfloat16]


def _tiled_bf16(q, k, v, *, causal=True, scale=None, terms=2):
    """The wgmma kernel's arithmetic in plain PyTorch (see the module note);
    ``terms=1`` rounds p to bf16 once instead."""
    block_m = block_n = 64  # the kernel's query and key tiles
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5 if scale is None else scale
    scale_log2 = scale * math.log2(math.e)
    qf = q.float().reshape(b, sq, kh, g, d)
    kf, vf = k.float(), v.float()
    offset = sk - sq
    out = torch.zeros(b, kh, g, sq, d)
    for m0 in range(0, sq, block_m):
        rows = torch.arange(m0, min(m0 + block_m, sq))
        kend = min(sk, max(m0 + block_m + offset, 0)) if causal else sk
        m = torch.full((b, kh, g, len(rows), 1), common.NEG_INF)
        l = torch.zeros(b, kh, g, len(rows), 1)
        acc = torch.zeros(b, kh, g, len(rows), d)
        for k0 in range(0, kend, block_n):
            keys = torch.arange(k0, min(k0 + block_n, sk))
            s = torch.einsum("bqkgd,bskd->bkgqs", qf[:, rows], kf[:, keys])
            if causal:
                s = s.masked_fill(keys[None, :] > rows[:, None] + offset, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * scale_log2)
            p = torch.exp2(s * scale_log2 - m_new)
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            hi = p.bfloat16().float()
            pb = hi if terms == 1 else hi + (p - hi).bfloat16().float()
            acc = acc * alpha + torch.einsum("bkgqs,bskd->bkgqd", pb, vf[:, keys])
            m = m_new
        out[..., rows, :] = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).bfloat16()


def _inputs(seed, b, sq, sk, h, kh, d):
    rng = np.random.RandomState(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).bfloat16() for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -------------------------------------------------------- K5, bf16 design
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,sq,sk,h,kh,causal", [
    (1, 100, 100, 4, 4, True),     # g = 1, Sq not a multiple of 64
    (2, 100, 37, 8, 2, True),      # g = 4, Sq > Sk: 63 rows see no key
    (1, 70, 200, 8, 1, True),      # g = 8, a prefix (Sq < Sk), ragged both
    (2, 77, 150, 4, 2, False),     # non-causal, ragged both
])
def test_tiled_bf16_matches_pallas_ref_and_plain(b, sq, sk, h, kh, causal, d):
    (qj, kj, vj), (qt, kt, vt) = _inputs(sq + sk + d, b, sq, sk, h, kh, d)
    got = _tiled_bf16(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    ratio = SMOKE.row_scaled_ratio(got, flash_attention_plain(qt, kt, vt, causal=causal),
                                   ROW_TOL)
    assert ratio <= 1.0, ratio
    seen = slice(max(sq - sk, 0) if causal else 0, sq)  # rows that see a key
    if seen.start:
        assert torch.all(got[:, :seen.start].float() == 0)
    pallas = jax_flash_attention(qj, kj, vj, causal=causal, interpret=True)
    np.testing.assert_allclose(_np(got)[:, seen], _np(pallas)[:, seen], **BF16_TOL)
    np.testing.assert_allclose(_np(got)[:, seen],
                               _np(ref.ref_attention(qj, kj, vj, causal=causal))[:, seen],
                               **BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_premise_two_terms_of_p_fit_the_limit_and_bf16_accumulation_does_not(causal):
    """At S 512 the design's rounding of p (two bf16 terms into float32
    accumulators) stays inside the bf16 row-scaled limit; the control that
    accumulates P . V key by key in bf16 exceeds it, so the limit tells the
    two apart."""
    _, (q, k, v) = _inputs(16, 1, 512, 512, 8, 2, 64)
    want = flash_attention_plain(q, k, v, causal=causal)
    design = SMOKE.row_scaled_ratio(_tiled_bf16(q, k, v, causal=causal), want, ROW_TOL)
    control = SMOKE.row_scaled_ratio(SMOKE.attention_bf16_acc(q, k, v, causal=causal),
                                     want, ROW_TOL)
    assert design < 1.0 < control, (design, control)


def test_two_bf16_terms_of_p_leave_only_the_output_rounding():
    """At 2048 keys and D 128 one rounding of p costs a visible share of the
    limit; two terms leave about the error of the output's own rounding.
    (PERF.md gives both forms' errors at Jamba widths on the card.)"""
    _, (q, k, v) = _inputs(17, 1, 2048, 2048, 4, 1, 128)
    want = flash_attention_plain(q, k, v, causal=True)
    one, two = (SMOKE.row_scaled_ratio(_tiled_bf16(q, k, v, terms=t), want, ROW_TOL)
                for t in (1, 2))
    assert two < 0.75 and two < one, (one, two)


def test_designs_follow_the_dtype():
    assert DESIGNS == {torch.bfloat16: "wgmma", torch.float32: "3xtf32 mma.sync"}
    assert SMOKE.designs("flash_attention") == {"bfloat16": "wgmma",
                                                "float32": "3xtf32 mma.sync"}
    for name in _build.KERNELS:
        designs = SMOKE.designs(name)
        assert designs and set(designs) <= {"float32", "bfloat16", "float16", "int32",
                                            "uint32"}, name


def test_wrapper_on_cpu_tensors_runs_the_plain_version_in_bf16():
    _, (q, k, v) = _inputs(19, 1, 70, 90, 4, 2, 16)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=True))


def test_check_aligned_refuses_a_view_off_a_16_byte_boundary():
    base = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    common.check_aligned("flash_attention", q=base[:256], k=base[8:])  # 16 bytes in
    with pytest.raises(ValueError, match="16-byte boundary"):
        common.check_aligned("flash_attention", q=base[:256], k=base[1:257])


# ------------------------------------------------------ K1, the sandwich
def test_clock_sandwich_and_sm_clock_refuse_the_cpu():
    x = torch.ones(8, 128)
    with pytest.raises(RuntimeError, match="only on a CUDA card"):
        alu_chain_timed(x, x, n=4)
    with pytest.raises(RuntimeError, match="only on a CUDA card"):
        sm_clock_hz("cpu")
    with pytest.raises(RuntimeError, match="only on a CUDA card"):
        sm_clock_sample(torch.device("cpu"))
    with pytest.raises(ValueError, match="op must be one of"):
        alu_chain_timed(x, x, n=4, op="div")


def test_kernel_row_keeps_the_host_clock_on_the_cpu(tmp_path):
    session = Session(db=str(tmp_path / "db.json"), device="cpu",
                      timer=Timer(warmup=1, reps=3, device="cpu"))
    result = session.run(Plan.kernels(("fma",), lens=(8, 4096)))
    assert not result.failed, [r.failure for r in result.failed]
    (rec,) = result.records()
    assert rec.op == "kernel.alu_chain.fma.l8-4096" and rec.backend == "cpu"
    assert rec.notes.startswith("plain alu_chain") and rec.notes.endswith("clock=host")
    assert rec.latency_ns > 0
