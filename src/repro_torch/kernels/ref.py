"""Plain PyTorch oracles for every kernel (the port of ``repro/kernels/ref.py``).

Each ``ref_*`` function is the mathematical definition, written with plain
PyTorch ops at float32 precision with no tiling, as the JAX package's
``ref_*`` is in ``jnp``. Masked logits are ``-inf``, as there, so a query row
that sees no key (causal with Sq > Sk) and a decode row of ``kv_len`` 0
are NaN: the kernels and their ``*_plain`` versions give 0 there (the
port's stated divergences), the oracles keep the JAX package's NaN.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.mamba_scan import softplus


# ----------------------------------------------------------------- attention
def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  scale: float | None = None, logit_soft_cap: float | None = None
                  ) -> torch.Tensor:
    """Dense attention. q: [B,Sq,H,D]; k, v: [B,Sk,KH,D] (GQA: H % KH == 0)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if h % kh:
        raise ValueError(f"ref_attention: H {h} % KH {kh}")
    g = h // kh
    scale = (d ** -0.5) if scale is None else scale
    qf = (q.float() * scale).reshape(b, sq, kh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if logit_soft_cap is not None:
        logits = logit_soft_cap * torch.tanh(logits / logit_soft_cap)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = qpos >= torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~mask[None, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def ref_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor | int) -> torch.Tensor:
    """One-token decode vs a cache. q: [B,H,D]; k, v: [B,S,KH,D]; kv_len mask."""
    b, h, d = q.shape
    _, s, kh, _ = k.shape
    g = h // kh
    qf = q.float().reshape(b, kh, g, d) * (d ** -0.5)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < lens
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


# ------------------------------------------------------------------ rmsnorm
def ref_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """K4's RMSNorm: multiply by w in float32, then cast (not the model's
    order, ``models.common.rmsnorm``; R4)."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * w.float()).to(x.dtype)


# --------------------------------------------------------------- mamba scan
def ref_selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, D: torch.Tensor, h0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective state-space scan (Mamba S6), sequential reference.

    x, dt: [B,S,Dm]; A: [Dm,N]; B, C: [B,S,N]; D: [Dm]; dt before its
    softplus. Returns (y [B,S,Dm], h_final [B,Dm,N]).
    """
    bsz, s, dm = x.shape
    n = A.shape[1]
    xf, dtf = x.float(), softplus(dt.float())
    af, bf, cf = A.float(), B.float(), C.float()
    da = torch.exp(dtf[..., None] * af[None, None])               # [B,S,Dm,N]
    dbx = dtf[..., None] * bf[:, :, None, :] * xf[..., None]      # [B,S,Dm,N]
    h = (torch.zeros(bsz, dm, n, dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(s):
        h = da[:, t] * h + dbx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None]
    return y.to(x.dtype), h


# -------------------------------------------------------------- alu chain
def ref_alu_chain(x: torch.Tensor, a: torch.Tensor, n: int) -> torch.Tensor:
    """Dependent fma chain oracle: x <- x*a + a, n times (f32 accumulate)."""
    xf, af = x.float(), a.float()
    for _ in range(n):
        xf = xf * af + af
    return xf.to(x.dtype)


# ------------------------------------------------------------------- chase
def ref_chase(ring, start: int, steps: int) -> int:
    """Pointer-chase oracle: follow ring[p] ``steps`` times."""
    r = ring.cpu().numpy() if isinstance(ring, torch.Tensor) else np.asarray(ring)
    p = int(start)
    for _ in range(steps):
        p = int(r[p])
    return p


# ------------------------------------------------------------------ matmul
def ref_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)
