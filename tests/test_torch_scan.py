"""K7's arithmetic (staged tiles, states spread over lanes, D folded in) and
its final state, on the CPU.

The kernel (``csrc/mamba_scan.cu``) cannot run here, so
:func:`_lane_split_scan` repeats its arithmetic in plain PyTorch: softplus
on the SFU's terms (:func:`_sfu_softplus`) and dt * x once per (t,
channel) as a staged tile of 32 steps arrives (the tail of the sequence
masked), A pre-scaled by log2 e so that each exp is
``exp2(dt * A')``, a channel's N states dealt over lanes (2 for N 4 and 8,
4 for N 16) whose partial sums of h . C meet in the butterfly order of the
kernel's shuffles, and ``y + x * D`` folded into the store. It is held, on
the same numpy inputs, against the JAX package's Pallas kernel in
interpret mode, ``ref_selective_scan`` (y and ``h_final``) and
``mamba_scan_plain``.

Tolerance: the JAX package's own for the scan, atol = rtol = 5e-5
(``tests/test_kernels.py``; a recurrence over up to 100 steps of float32
exp and multiply-adds, summed in another order), here over up to 133
steps. ``chunk`` does not change the wrapper's result at all (bit-exact).
The kernel's softplus is within 2^-17 of ``jax.nn.softplus``'s value (the
rounding of 1 + e, measured here with an exact log2; the card's lg2.approx
adds about 2^-22 absolute), far inside the float32 limit of 2^-13.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan
from repro_torch.inkernel import build_fused, fused_kwargs
from repro_torch.kernels.mamba_scan import (STATE_DIMS, mamba_scan, mamba_scan_plain,
                                            scan_vectorized, softplus)

SCAN_TOL = dict(atol=5e-5, rtol=5e-5)
STEPS = 32                    # the kernel's staged tile (kSteps)
LANES = {4: 2, 8: 2, 16: 4}   # lanes a channel (Layout<N>::kLanes)


def _sfu_softplus(x: torch.Tensor) -> torch.Tensor:
    """The kernel's softplus: max(x, 0) + log1p(e), e = 2^(-|x| log2 e),
    log1p(e) as log2(1 + e) ln 2, or for e < 2^-6 as e (1 - e/2 + e^2/3)."""
    e = torch.exp2(-x.abs() * math.log2(math.e))
    series = e * (1 + e * (-0.5 + e / 3))
    return x.clamp_min(0) + torch.where(e < 2.0 ** -6, series, torch.log2(1 + e) * math.log(2))


def _lane_split_scan(x, dt, A, B, C, D):
    """The kernel's arithmetic in plain PyTorch (see the module note);
    returns (y, h_final)."""
    bsz, s, dm = x.shape
    n = A.shape[1]
    lanes = LANES[n]
    a2 = A * math.log2(math.e)                  # pre-scaled once
    h = torch.zeros(bsz, dm, n)
    y = torch.empty(bsz, s, dm)
    for t0 in range(0, s, STEPS):
        steps = range(t0, min(t0 + STEPS, s))   # the tail is masked
        d = _sfu_softplus(dt[:, steps])         # once per (t, channel)
        dx = d * x[:, steps]
        for i, t in enumerate(steps):
            h = torch.exp2(d[:, i, :, None] * a2) * h + dx[:, i, :, None] * B[:, t, None, :]
            part = (h * C[:, t, None, :]).reshape(bsz, dm, lanes, n // lanes).sum(-1)
            while part.shape[-1] > 1:           # xor shuffles: W/2, then W/4, ...
                half = part.shape[-1] // 2
                part = part[..., :half] + part[..., half:]
            y[:, t] = torch.addcmul(part[..., 0], x[:, t], D)
    return y, h


def _inputs(b, s, dm, n, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.standard_normal((b, s, dm)) * 0.5, rng.standard_normal((b, s, dm)) * 0.1,
              -np.exp(rng.standard_normal((dm, n)) * 0.3), rng.standard_normal((b, s, n)) * 0.5,
              rng.standard_normal((b, s, n)) * 0.5, rng.standard_normal(dm) * 0.1]
    arrays = [a.astype(np.float32) for a in arrays]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) else x.numpy()


CASES = [  # (b, s, dm, n, chunk)
    (2, 64, 16, 4, 16),     # two whole tiles
    (1, 45, 24, 8, 1),      # S not a multiple of the tile; chunk 1
    (2, 100, 12, 16, 32),   # four tiles, the last one of 4 steps
    (1, 133, 8, 16, 7),     # a chunk that divides nothing: the TPU kernel cuts it to 7
]


@pytest.mark.parametrize("b,s,dm,n,chunk", CASES)
def test_lane_split_scan_matches_pallas_ref_and_plain(b, s, dm, n, chunk):
    js, ts = _inputs(b, s, dm, n, seed=s + dm + n)
    y, h = _lane_split_scan(*ts)
    assert y.shape == (b, s, dm) and h.shape == (b, dm, n)
    pallas = jax_mamba_scan(*js, chunk=chunk, interpret=True)
    want_y, want_h = ref.ref_selective_scan(*js)
    plain_y, plain_h = mamba_scan_plain(*ts, chunk=chunk, return_state=True)
    for other in (pallas, want_y, plain_y):
        np.testing.assert_allclose(y.numpy(), _np(other), **SCAN_TOL)
    for other in (want_h, plain_h):
        np.testing.assert_allclose(h.numpy(), _np(other), **SCAN_TOL)


@pytest.mark.parametrize("b,s,dm,n,chunk", CASES)
def test_return_state_matches_ref_selective_scan(b, s, dm, n, chunk):
    """The wrapper on CPU tensors (its plain version) gives
    ref_selective_scan's y and h_final; without the keyword it gives y
    alone, as the fused plan calls it."""
    js, ts = _inputs(b, s, dm, n, seed=3 * s + n)
    before = mamba_scan.launches
    y, h = mamba_scan(*ts, chunk=chunk, return_state=True)
    assert mamba_scan.launches == before
    assert h.dtype == torch.float32 and h.shape == (b, dm, n)
    want_y, want_h = ref.ref_selective_scan(*js)
    np.testing.assert_allclose(y.numpy(), _np(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), _np(want_h), **SCAN_TOL)
    assert torch.equal(mamba_scan(*ts, chunk=chunk), y)


def test_sfu_softplus_is_within_2_to_the_minus_17_of_jax():
    import jax

    x = np.linspace(-80, 80, 400_001, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)), dtype=np.float64)
    got = _sfu_softplus(torch.from_numpy(x)).double().numpy()
    assert np.max(np.abs(got - want) / want) < 2.0 ** -17
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(), want, rtol=1e-6)


def test_chunk_does_not_change_the_result():
    _, ts = _inputs(1, 70, 8, 8, seed=5)
    want = mamba_scan(*ts, chunk=128, return_state=True)
    for chunk in (1, 7, 32, 70):
        got = mamba_scan(*ts, chunk=chunk, return_state=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_no_steps_leave_the_state_at_zero():
    x = torch.zeros(2, 0, 8)
    y, h = mamba_scan(x, x, -torch.ones(8, 4), torch.zeros(2, 0, 4), torch.zeros(2, 0, 4),
                      torch.zeros(8), return_state=True)
    assert y.shape == (2, 0, 8) and torch.equal(h, torch.zeros(2, 8, 4))


def test_fused_unit_workload_runs_the_kernels_layout():
    """The fused plan's scan unit workload (Dm 8, N 4, S 8 n, chunk 8): one
    block, one tile of 32 steps or less at n 2, two at n 6."""
    for n in (2, 6):
        _, args = build_fused("mamba_scan", n, "cpu")
        got = mamba_scan(*args, **fused_kwargs("mamba_scan"))
        y, _ = _lane_split_scan(*args)
        assert args[2].shape == (8, 4) and got.shape == (1, 8 * n, 8)
        np.testing.assert_allclose(y.numpy(), got.numpy(), **SCAN_TOL)


def test_scan_copies_16_bytes_only_where_every_row_and_base_allows():
    assert STATE_DIMS == tuple(LANES)
    x = torch.zeros(1, 4, 1000)
    assert scan_vectorized(x, x)
    assert not scan_vectorized(torch.zeros(1, 4, 1001))
    odd = torch.zeros(4 * 1000 + 1)[1:].view(1, 4, 1000)
    assert not scan_vectorized(x, odd)


def test_bound_counts_the_exponentials_on_the_sfu():
    """chip_smoke.py's bound for K7 at Jamba (x, dt [1, 2048, 8192], N 16):
    the bytes (0.060 ms), above the float32 operations (0.030 ms). The
    2048 x 8192 x 16 ex2 at 16 a clock an SM on 132 SMs at 1980 MHz
    (0.064 ms on the SFU alone) are printed, not taken as a floor: an ex2
    can also run as a polynomial on the FMA pipes."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x = torch.empty(1, 2048, 8192, device="meta")
    args = (x, x, torch.empty(8192, 16, device="meta"), torch.empty(1, 2048, 16, device="meta"),
            torch.empty(1, 2048, 16, device="meta"), torch.empty(8192, device="meta"))
    nbytes, nops, ops_s, how = smoke.fused_work("mamba_scan", args, {"chunk": 64})
    assert ops_s == pytest.approx(nops / smoke.FP32_OPS_PER_S)
    assert nops == (7 * 16 + 6) * 2048 * 8192
    assert f"{2048 * 8192 * 16} ex2 on the SFU alone 0.0641" in how
    assert nbytes / smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0603, abs=1e-4)
    assert ops_s < nbytes / smoke.HBM_BYTES_PER_S
    with_state = smoke.fused_work("mamba_scan", args, {"return_state": True})[0]
    assert with_state == nbytes + 8192 * 16 * 4   # h [1, 8192, 16] written once


@pytest.mark.parametrize("b,s,dm,n", [(2, 130, 48, 16), (1, 64, 8, 4), (3, 5, 33, 8)])
def test_plain_scan_in_blocks_gives_the_step_loops_bits(b, s, dm, n):
    """The plain version takes its factors PLAIN_STEPS steps at a time; each
    step still multiplies and adds as a loop over single steps does, so the
    bits are the loop's (S 130: two whole blocks and a part)."""
    from repro_torch.kernels.mamba_scan import PLAIN_STEPS, softplus

    _, (x, dt, A, B, C, D) = _inputs(b, s, dm, n, seed=5)
    dtf = softplus(dt.float())
    h = torch.zeros(b, dm, n)
    ys = []
    for t in range(s):
        h = torch.exp(dtf[:, t, :, None] * A) * h + (dtf[:, t] * x[:, t])[:, :, None] * \
            B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(dim=-1))
    want = torch.stack(ys, dim=1) + x * D
    got, h_got = mamba_scan_plain(x, dt, A, B, C, D, return_state=True)
    assert PLAIN_STEPS == 64
    assert torch.equal(got, want) and torch.equal(h_got, h)
