"""Shared model components: init, norms, rotary embeddings, attention, logits
(the port of ``repro/models/common.py``).

Attention comes in three implementations with one math:
  * ``plain``      — einsum + mask; short sequences / smoke tests.
  * ``blockwise``  — online softmax over KV blocks, a loop over the blocks;
                     O(Sq·block_k) live scores.
  * ``pallas``     — the name the JAX package gives its kernel path: here
                     K5, the port's hand-written CUDA flash attention
                     (``kernels.ops.flash_attention``; its plain version on
                     CPU tensors).
GQA is native (KV heads broadcast over groups of query heads).

``chunked_softmax_xent`` (training) is not ported yet: it comes with the
slice that ports training.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import ops

NEG_INF = -1e30
# elements a float32 scratch of trunc_normal holds at once (256 MiB)
_INIT_CHUNK = 1 << 26


def fit_chunk(s: int, preferred: int) -> int:
    """Largest divisor of ``s`` that is <= preferred (graceful chunking)."""
    c = max(min(preferred, s), 1)
    while s % c:
        c -= 1
    return c


# ---------------------------------------------------------------------- init
@torch.no_grad()
def trunc_normal_(out: torch.Tensor, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` in place with a standard normal truncated to [-2, 2],
    times ``scale``, drawn in float32 from ``generator`` and cast to
    ``out``'s dtype (the JAX package's ``trunc_normal``). The draw goes
    through a float32 scratch of at most 2^26 elements, so a bfloat16
    tensor never has a float32 copy of its own size."""
    flat = out.view(-1)
    for start in range(0, flat.numel(), _INIT_CHUNK):
        part = flat[start:start + _INIT_CHUNK]
        tmp = torch.empty(part.shape, dtype=torch.float32, device=out.device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
        part.copy_(tmp.mul_(scale))
    return out


def trunc_normal(shape: tuple[int, ...], scale: float, dtype: torch.dtype,
                 generator: torch.Generator) -> torch.Tensor:
    """A new tensor of ``shape`` filled by :func:`trunc_normal_` on the
    generator's device."""
    return trunc_normal_(torch.empty(shape, dtype=dtype, device=generator.device),
                         scale, generator)


# ---------------------------------------------------------------------- norm
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The model's RMSNorm: normalize in float32, cast to x's dtype, then
    multiply by w in x's dtype (this rounding order, not K4's; R4)."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * w.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


# ---------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.cache
def _device_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, made once: a copy from the host at
    every call would wait for the card's queue at every decode step."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


@functools.cache
def _section_ids(sections: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The M-RoPE stream (0, 1, 2) that drives each frequency, on ``device``."""
    return torch.from_numpy(np.repeat(np.arange(len(sections)), sections)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: [B,S,H,D]; positions: [B,S] (int). Pairwise (x0, x1) rotation of
    the two halves of D; the result is contiguous."""
    freqs = _device_freqs(x.shape[-1], theta, x.device)                # [D/2]
    return _rotate(x, positions[..., None].float() * freqs)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x0, x1) of the two halves of x's last axis by
    ``angles`` [B,S,D/2], in float32; the result in x's dtype."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple[int, ...],
                theta: float = 1e4) -> torch.Tensor:
    """Qwen2-VL M-RoPE. x: [B,S,H,D]; positions: [3,B,S] (the t, h and w
    streams). Each band of frequencies is driven by one stream, the bands'
    widths given by ``sections`` (summing to D/2)."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to D/2 = {d // 2}")
    freqs = _device_freqs(d, theta, x.device)                          # [D/2]
    sec_id = _section_ids(tuple(sections), x.device)                   # [D/2]
    return _rotate(x, positions.float()[sec_id].permute(1, 2, 0) * freqs)


# ----------------------------------------------------------------- attention
def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    q_offset: int = 0, kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k, v: [B,Sk,KH,D]. float32 softmax.

    ``kv_len``: optional [B] valid-cache lengths (ragged batches).
    """
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    qf = q.float().reshape(b, sq, kh, g, d) * (d ** -0.5)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = (qpos >= kpos) if causal else torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    mask = mask[None, None, None].expand(logits.shape)
    if kv_len is not None:
        valid = kpos[None] < torch.as_tensor(kv_len, device=q.device).reshape(b, 1, 1)
        mask = mask & valid[:, None, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        block_k: int = 1024, q_offset: int = 0,
                        p_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Online softmax over KV blocks: scores are never held beyond
    [*, Sq, block_k]."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    block_k = fit_chunk(sk, block_k)
    qf = q.float().reshape(b, sq, kh, g, d) * (d ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, kh, g, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, kh, g, sq, 1), device=q.device)
    acc = torch.zeros((b, kh, g, sq, d), device=q.device)
    for start in range(0, sk, block_k):
        kblk = k[:, start:start + block_k].float()
        vblk = v[:, start:start + block_k].float()
        logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kblk)
        if causal:
            kpos = start + torch.arange(block_k, device=q.device)[None, :]
            logits = logits.masked_fill(~(qpos >= kpos)[None, None, None], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgqs,bskd->bkgqd", p.to(p_dtype),
                                         vblk.to(p_dtype)).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor | int) -> torch.Tensor:
    """One-token attention against a cache. q: [B,H,D]; k, v: [B,S,KH,D];
    ``kv_len`` a scalar or [B] count of valid cache entries."""
    b, h, d = q.shape
    _, s, kh, _ = k.shape
    g = h // kh
    qf = q.float().reshape(b, kh, g, d) * (d ** -0.5)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < lens
    logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              impl: str = "auto", q_offset: int = 0, block_k: int = 1024,
              p_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The impl switch. ``"pallas"`` runs K5 (its causal mask aligns the
    last query with the last key, which is ``q_offset`` 0 for a prefill);
    the kernel takes contiguous tensors, so q, k and v are made so."""
    sk = k.shape[1]
    if impl == "auto":
        impl = "blockwise" if sk >= 4096 else "plain"
    if impl == "plain":
        return plain_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   block_k=min(block_k, sk), p_dtype=p_dtype)
    if impl == "pallas":
        return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal)
    raise ValueError(impl)


# -------------------------------------------------------------------- logits
def top1_logits(h_last: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Decode-step logits: h_last [B,D] x emb [V,D] -> [B,V], in float32."""
    return h_last.float() @ emb.float().T
