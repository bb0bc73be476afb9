"""xLSTM blocks (the port of ``repro/models/xlstm.py``): mLSTM (matrix
memory, a chunked-parallel prefill) and sLSTM (scalar memory, a sequential
recurrence with exponential-gate stabilization), as ``nn.Module``\\ s whose
parameters have the JAX package's names and shapes.

The mLSTM prefill is the chunkwise linear-attention form: intra-chunk
decayed attention plus an inter-chunk [dh, dh] state carried from chunk to
chunk, in float32. It folds in no stabilizer (float32 and the bounded
initial gates keep it finite) and hands decode ``m = 0``; the decode step
is the exact stabilized recurrence, which carries ``m``. The JAX package
has no kernel for these mixers, and neither has the port: both run in
plain PyTorch on either device.

A prompt shorter than the conv's 3 rows of history: the JAX package's
prefill caches fewer rows than its decode step reads, which then fails
(as R6 for Mamba); the port caches the causal conv's zeros before the
prompt (R8).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.blocks import dense_init_, param
from repro_torch.models.config import ModelConfig, Runtime
from repro_torch.models.ssm import _causal_conv

CONV = 4                         # the mLSTM's causal conv width


# ------------------------------------------------------------------- mLSTM
def _mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ig: torch.Tensor,
                   fg: torch.Tensor, chunk: int):
    """Chunkwise parallel mLSTM. q, k, v: [B,S,H,dh]; ig, fg: [B,S,H]
    (float32, fg before its log-sigmoid). Returns (h [B,S,H*dh] float32,
    (c [B,H,dh,dh], n [B,H,dh]))."""
    b, s, nh, dh = q.shape
    lc = common.fit_chunk(s, chunk)
    qf = q.float() * dh ** -0.5
    kf, vf = k.float(), v.float()
    logf = F.logsigmoid(fg)
    tri = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=q.device))[None, :, :, None]
    c_state = torch.zeros(b, nh, dh, dh, dtype=torch.float32, device=q.device)
    n_state = torch.zeros(b, nh, dh, dtype=torch.float32, device=q.device)
    hs = []
    for c0 in range(0, s, lc):
        qk, kk, vk = qf[:, c0:c0 + lc], kf[:, c0:c0 + lc], vf[:, c0:c0 + lc]
        ik, fk = ig[:, c0:c0 + lc], logf[:, c0:c0 + lc]
        fcum = torch.cumsum(fk, dim=1)                                   # [B,Lc,H]
        ftot = fcum[:, -1]                                               # [B,H]
        # intra-chunk decayed attention
        di_ = fcum[:, :, None] - fcum[:, None, :] + ik[:, None, :]       # [B,i,j,H]
        dmat = torch.where(tri, torch.exp(di_), 0.0)
        sc = torch.einsum("bihd,bjhd->bijh", qk, kk) * dmat
        h_intra = torch.einsum("bijh,bjhd->bihd", sc, vk)
        norm_intra = sc.sum(dim=2)                                       # [B,i,H]
        # inter-chunk contribution
        qd = qk * torch.exp(fcum)[..., None]
        h_inter = torch.einsum("bihd,bhde->bihe", qd, c_state)
        norm_inter = torch.einsum("bihd,bhd->bih", qd, n_state)
        norm = torch.clamp_min((norm_intra + norm_inter).abs(), 1.0)
        hs.append((h_intra + h_inter) / norm[..., None])
        # state update
        kd = kk * torch.exp(ftot[:, None] - fcum + ik)[..., None]
        decay = torch.exp(ftot)
        c_state = decay[..., None, None] * c_state + torch.einsum("bjhd,bjhe->bhde", kd, vk)
        n_state = decay[..., None] * n_state + kd.sum(dim=1)
    return torch.cat(hs, dim=1).reshape(b, s, nh * dh), (c_state, n_state)


class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, pd = cfg.d_model, cfg.n_heads, cfg.pdtype
        di = cfg.ssm_expand * d
        self.cfg = cfg
        self.norm = param(d, dtype=pd, device=device)
        self.up = param(d, 2 * di, dtype=pd, device=device)
        self.conv_w = param(di, CONV, dtype=pd, device=device)
        self.conv_b = param(di, dtype=pd, device=device)
        self.wq = param(di, di, dtype=pd, device=device)
        self.wk = param(di, di, dtype=pd, device=device)
        self.wv = param(di, di, dtype=pd, device=device)
        self.wi = param(di, h, dtype=pd, device=device)
        self.wf = param(di, h, dtype=pd, device=device)
        self.gn = param(di, dtype=pd, device=device)
        self.down = param(di, d, dtype=pd, device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        d, di = self.cfg.d_model, self.up.shape[1] // 2
        self.norm.fill_(1.0)
        dense_init_(self.up, d, g)
        common.trunc_normal_(self.conv_w, 0.5, g)
        self.conv_b.zero_()
        for w in (self.wq, self.wk, self.wv, self.wi, self.wf):
            dense_init_(w, di, g)
        self.gn.fill_(1.0)
        dense_init_(self.down, di, g)

    def _qkvif(self, x: torch.Tensor):
        cfg = self.cfg
        cd = cfg.cdtype
        h = common.rmsnorm(x, self.norm)
        xm, z = torch.einsum("bsd,de->bse", h, self.up.to(cd)).chunk(2, dim=-1)   # [B,S,Di]
        xc = F.silu(_causal_conv(xm, self.conv_w.to(cd), self.conv_b.to(cd)))
        b, s, di = xc.shape
        nh = cfg.n_heads
        dh = di // nh
        q = (xc @ self.wq.to(cd)).reshape(b, s, nh, dh)
        k = (xc @ self.wk.to(cd)).reshape(b, s, nh, dh)
        v = (xm @ self.wv.to(cd)).reshape(b, s, nh, dh)
        ig = xc.float() @ self.wi.float() - 4.0          # small init inputs
        fg = xc.float() @ self.wf.float() + 4.0          # long memory init
        return q, k, v, ig, fg, z, xm

    def forward(self, x: torch.Tensor, rt: Runtime):
        """x: [B,S,D] -> (residual output, decode cache {c, n, m, conv})."""
        cd = self.cfg.cdtype
        q, k, v, ig, fg, z, xm = self._qkvif(x)
        h, (cf, nf) = _mlstm_chunked(q, k, v, ig, fg, rt.mlstm_chunk)
        h = common.rmsnorm(h.to(cd), self.gn) * F.silu(z)
        out = h @ self.down.to(cd)
        # the chunked form is unstabilized: decode starts from m = 0; the
        # conv history in float32, the causal conv's zeros before a short
        # prompt (R8)
        conv = F.pad(xm[:, -(CONV - 1):].float(), (0, 0, max(CONV - 1 - xm.shape[1], 0), 0))
        return x + out, {"c": cf, "n": nf, "m": torch.zeros(cf.shape[:2], device=x.device),
                         "conv": conv}

    def init_cache(self, batch: int, dtype: torch.dtype, device) -> dict:
        """The empty cache (float32 whatever ``dtype``, as the JAX package's)."""
        nh, di = self.cfg.n_heads, self.gn.shape[0]
        dh = di // nh
        z = dict(dtype=torch.float32, device=device)
        return {"c": torch.zeros(batch, nh, dh, dh, **z), "n": torch.zeros(batch, nh, dh, **z),
                "m": torch.full((batch, nh), -1e30, **z),
                "conv": torch.zeros(batch, CONV - 1, di, **z)}

    def decode(self, x: torch.Tensor, cache: dict):
        """The exact stabilized recurrence, one step. x: [B,1,D]."""
        cfg = self.cfg
        cd, f32 = cfg.cdtype, torch.float32
        h = common.rmsnorm(x, self.norm)
        xm, z = torch.einsum("bsd,de->bse", h, self.up.to(cd)).chunk(2, dim=-1)
        hist = torch.cat([cache["conv"], xm[:, :1].float()], dim=1)
        conv = torch.einsum("bki,ik->bi", hist, self.conv_w.float()) + self.conv_b.float()
        xc = F.silu(conv)                                                # [B,Di]
        b, di = xc.shape
        nh = cfg.n_heads
        dh = di // nh
        q = (xc @ self.wq.to(f32)).reshape(b, nh, dh) * dh ** -0.5
        k = (xc @ self.wk.to(f32)).reshape(b, nh, dh)
        v = (xm[:, 0].float() @ self.wv.to(f32)).reshape(b, nh, dh)
        ig = xc @ self.wi.to(f32) - 4.0                                  # [B,H]
        fg = F.logsigmoid(xc @ self.wf.to(f32) + 4.0)
        m_new = torch.maximum(fg + cache["m"], ig)
        fs = torch.exp(fg + cache["m"] - m_new)[..., None]
        is_ = torch.exp(ig - m_new)[..., None]
        c_new = fs[..., None] * cache["c"] + is_[..., None] * k[..., None] * v[..., None, :]
        n_new = fs * cache["n"] + is_ * k
        num = torch.einsum("bhd,bhde->bhe", q, c_new)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n_new).abs(), torch.exp(-m_new))
        hh = (num / den[..., None]).reshape(b, di)
        hh = common.rmsnorm(hh.to(cd), self.gn) * F.silu(z[:, 0])
        out = (hh @ self.down.to(cd))[:, None]
        return x + out, {"c": c_new, "n": n_new, "m": m_new, "conv": hist[:, 1:]}


# ------------------------------------------------------------------- sLSTM
def _slstm_cell(wx_t: torch.Tensor, state: tuple, r: torch.Tensor, nh: int, dh: int):
    """wx_t: [B,4D] the precomputed input path; state: (c, n, h, m), each
    [B,D]."""
    c, n, h, m = state
    b = wx_t.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(b, nh, dh), r).reshape(b, 4 * nh * dh)
    zt, it, ft, ot = (wx_t + rec).chunk(4, dim=-1)                       # [B,D] each
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(logf + m - m_new)
    c_new = f_ * c + i_ * zt
    n_new = f_ * n + i_
    h_new = ot * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, h_new, m_new


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, nh, pd = cfg.d_model, cfg.n_heads, cfg.pdtype
        dh = d // nh
        self.cfg = cfg
        self.norm = param(d, dtype=pd, device=device)
        self.w = param(d, 4 * d, dtype=pd, device=device)
        self.r = param(nh, dh, 4 * dh, dtype=pd, device=device)
        self.b = param(4 * d, dtype=pd, device=device)
        self.gn = param(d, dtype=pd, device=device)
        self.out = param(d, d, dtype=pd, device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        d = self.cfg.d_model
        self.norm.fill_(1.0)
        dense_init_(self.w, d, g)
        common.trunc_normal_(self.r, self.r.shape[1] ** -0.5, g)
        self.b.zero_()
        self.gn.fill_(1.0)
        dense_init_(self.out, d, g)

    def _wx(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.cfg.cdtype
        h = common.rmsnorm(x, self.norm)
        return (torch.einsum("bsd,de->bse", h, self.w.to(cd)) + self.b.to(cd)).float()

    def _out(self, h: torch.Tensor) -> torch.Tensor:
        cd = self.cfg.cdtype
        return common.rmsnorm(h.to(cd), self.gn) @ self.out.to(cd)

    def forward(self, x: torch.Tensor, rt: Runtime):
        """x: [B,S,D] -> (residual output, decode cache {c, n, h, m}); one
        step a token, in float32."""
        b, s, d = x.shape
        nh = self.cfg.n_heads
        wx = self._wx(x)
        r = self.r.float()
        z = torch.zeros(b, d, dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.full((b, d), -1e30, device=x.device))
        hs = []
        for t in range(s):
            state = _slstm_cell(wx[:, t], state, r, nh, d // nh)
            hs.append(state[2])
        c, n, h, m = state
        return x + self._out(torch.stack(hs, dim=1)), {"c": c, "n": n, "h": h, "m": m}

    def init_cache(self, batch: int, dtype: torch.dtype, device) -> dict:
        d = self.cfg.d_model
        z = dict(dtype=torch.float32, device=device)
        return {"c": torch.zeros(batch, d, **z), "n": torch.zeros(batch, d, **z),
                "h": torch.zeros(batch, d, **z), "m": torch.full((batch, d), -1e30, **z)}

    def decode(self, x: torch.Tensor, cache: dict):
        nh = self.cfg.n_heads
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
        c, n, h, m = _slstm_cell(self._wx(x)[:, 0], state, self.r.float(), nh,
                                 self.cfg.d_model // nh)
        return x + self._out(h)[:, None], {"c": c, "n": n, "h": h, "m": m}
