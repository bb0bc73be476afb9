"""Mamba (S6 selective scan) block (the port of ``repro/models/ssm.py``):
a chunked associative-scan prefill, an O(1)-state decode step, and the
kernel path through K7 (``kernels.ops.mamba_scan``) under
``Runtime.use_pallas``.

The plain path computes ``exp(dt * A)`` and ``dt * x * B`` one chunk of
``rt.mamba_chunk`` steps at a time ([B, Lc, Di, N] float32 at a time, not
the whole sequence) and scans each chunk with a Hillis-Steele associative
scan, carrying the state from chunk to chunk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import softplus
from repro_torch.models import common
from repro_torch.models.blocks import dense_init_, param
from repro_torch.models.config import ModelConfig, Runtime


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via K shifted adds. x: [B,S,Di]; w: [Di,K]."""
    k = w.shape[1]
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + s] * w[:, j]
    return out + b


def _associative_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t * h_{t-1} + u_t along dim 1 (h_{-1} = 0),
    in log2(L) doubling steps (Hillis-Steele): position t absorbs the
    prefix that ends ``step`` places before it."""
    step = 1
    while step < a.shape[1]:
        u = torch.cat([u[:, :step], a[:, step:] * u[:, :-step] + u[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return u


def _chunk_scan(dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                x1: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked associative scan. Shapes: dt, x1 [B,S,Di]; a [Di,N]; b, c
    [B,S,N]. Returns (y [B,S,Di] float32, h_final [B,Di,N] float32)."""
    bsz, s, di = x1.shape
    n = a.shape[1]
    lc = common.fit_chunk(s, chunk)
    xf = x1.float()
    h = torch.zeros(bsz, di, n, dtype=torch.float32, device=x1.device)
    ys = []
    for c0 in range(0, s, lc):
        dt_k = dt[:, c0:c0 + lc]
        da = torch.exp(dt_k[..., None] * a)                              # [B,Lc,Di,N]
        u = (dt_k * xf[:, c0:c0 + lc])[..., None] * b_in[:, c0:c0 + lc, None, :]
        u[:, 0] += da[:, 0] * h
        acc_u = _associative_scan(da, u)
        ys.append(torch.einsum("bldn,bln->bld", acc_u, c_in[:, c0:c0 + lc]))
        h = acc_u[:, -1]
    return torch.cat(ys, dim=1), h


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, n, k, dtr, pd = (cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_conv,
                                cfg.dt_r, cfg.pdtype)
        self.cfg = cfg
        self.norm = param(d, dtype=pd, device=device)
        self.in_proj = param(d, 2 * di, dtype=pd, device=device)
        self.conv_w = param(di, k, dtype=pd, device=device)
        self.conv_b = param(di, dtype=pd, device=device)
        self.x_proj = param(di, dtr + 2 * n, dtype=pd, device=device)
        self.dt_w = param(dtr, di, dtype=pd, device=device)
        self.dt_b = param(di, dtype=pd, device=device)
        self.a_log = param(di, n, dtype=pd, device=device)
        self.d_skip = param(di, dtype=pd, device=device)
        self.out_proj = param(di, d, dtype=pd, device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        cfg = self.cfg
        d, di, n, k, dtr = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_conv, cfg.dt_r
        self.norm.fill_(1.0)
        dense_init_(self.in_proj, d, g)
        common.trunc_normal_(self.conv_w, (1.0 / k) ** 0.5, g)
        self.conv_b.zero_()
        dense_init_(self.x_proj, di, g)
        dense_init_(self.dt_w, dtr, g)
        self.dt_b.fill_(-4.6)                    # softplus(-4.6) ~= 0.01
        self.a_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                                device=self.a_log.device)).expand(di, n))
        self.d_skip.fill_(1.0)
        dense_init_(self.out_proj, di, g)

    def _ssm_inputs(self, h: torch.Tensor):
        xz = torch.einsum("bsd,de->bse", h, self.in_proj.to(self.cfg.cdtype))
        return xz.chunk(2, dim=-1)                                       # x1, z

    def _ssm_params(self, x1: torch.Tensor):
        """Input-dependent dt, B, C from the conv'd activations. Returns
        (dt before its softplus, A, B, C), float32; the plain paths apply the
        softplus, K7 applies it itself."""
        cfg = self.cfg
        cd, n, dtr = cfg.cdtype, cfg.ssm_state, cfg.dt_r
        dbc = torch.einsum("bsi,ie->bse", x1, self.x_proj.to(cd))
        dt_r, b_in, c_in = torch.split(dbc, [dtr, n, n], dim=-1)
        dt = torch.einsum("bsr,ri->bsi", dt_r, self.dt_w.to(cd))
        dt_pre = dt.float() + self.dt_b.float()
        a = -torch.exp(self.a_log.float())                               # [Di,N]
        return dt_pre, a, b_in.float(), c_in.float()

    def forward(self, x: torch.Tensor, rt: Runtime):
        """x: [B,S,D] -> (residual output, decode cache {h, conv})."""
        cfg = self.cfg
        cd = cfg.cdtype
        h = common.rmsnorm(x, self.norm)
        x1, z = self._ssm_inputs(h)
        # pre-conv inputs for decode, copied (a view would keep all of x1
        # alive); a prompt shorter than the conv's K - 1 steps of history is
        # preceded by the zeros the causal conv assumes (the JAX package keeps
        # fewer rows, and its decode step then fails: R6)
        conv_tail = F.pad(x1[:, -(cfg.ssm_conv - 1):],
                          (0, 0, max(cfg.ssm_conv - 1 - x1.shape[1], 0), 0)).to(cd, copy=True)
        x1 = F.silu(_causal_conv(x1, self.conv_w.to(cd), self.conv_b.to(cd)))
        dt_pre, a, b_in, c_in = self._ssm_params(x1)
        if rt.use_pallas:
            # K7 applies softplus itself, so it is given the pre-softplus
            # projection (the JAX package hands its kernel
            # log(expm1(softplus(dt))), a round trip). K7 adds x * D and
            # returns the real final state, which the decode cache needs
            # (the JAX package's kernel path caches zeros: R3).
            y, h_final = ops.mamba_scan(x1.float().contiguous(), dt_pre.contiguous(), a,
                                        b_in.contiguous(), c_in.contiguous(),
                                        self.d_skip.float().contiguous(),
                                        chunk=rt.mamba_chunk, return_state=True)
        else:
            y, h_final = _chunk_scan(softplus(dt_pre), a, b_in, c_in, x1, rt.mamba_chunk)
            y = y + x1.float() * self.d_skip.float()
        y = y.to(cd) * F.silu(z)
        out = torch.einsum("bsi,id->bsd", y, self.out_proj.to(cd))
        return x + out, {"h": h_final, "conv": conv_tail}

    def init_cache(self, batch: int, dtype: torch.dtype, device) -> dict:
        cfg = self.cfg
        return {"h": torch.zeros(batch, cfg.ssm_inner, cfg.ssm_state, dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros(batch, cfg.ssm_conv - 1, cfg.ssm_inner, dtype=dtype,
                                    device=device)}

    def decode(self, x: torch.Tensor, cache: dict):
        """One-token step. x: [B,1,D]. Returns (output, the new cache)."""
        cd = self.cfg.cdtype
        h = common.rmsnorm(x, self.norm)
        x1, z = self._ssm_inputs(h)                                       # [B,1,Di]
        hist = torch.cat([cache["conv"], x1.to(cache["conv"].dtype)], dim=1)
        conv = (torch.einsum("bki,ik->bi", hist.to(cd), self.conv_w.to(cd))
                + self.conv_b.to(cd))
        x1s = F.silu(conv)[:, None]                                       # [B,1,Di]
        dt_pre, a, b_in, c_in = self._ssm_params(x1s)
        dtq = softplus(dt_pre[:, 0])                                      # [B,Di]
        da = torch.exp(dtq[..., None] * a[None])                          # [B,Di,N]
        xs = x1s[:, 0].float()
        hn = da * cache["h"] + (dtq * xs)[..., None] * b_in[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", hn, c_in[:, 0]) + xs * self.d_skip.float()
        y = (y.to(cd) * F.silu(z[:, 0]))[:, None]
        out = torch.einsum("bsi,id->bsd", y, self.out_proj.to(cd))
        return x + out, {"h": hn, "conv": hist[:, 1:]}
