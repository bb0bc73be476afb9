"""Encoder-decoder backbone (the port of ``repro/models/encdec.py``: the
seamless-m4t text/speech transformer).

The speech frontend is a stub in the JAX package too: the encoder takes
precomputed frame embeddings [B, Se, D]. The encoder's self-attention is
not causal; the decoder is a causal transformer with a cross-attention to
the encoder memory in every layer, whose keys and values are computed once
at prefill. A decode cache is one dict per decoder layer, ``{"k", "v"}``
(self-attention, [B, S, KH, hd]) and ``{"ck", "cv"}`` (cross, [B, Se, KH,
hd]), where the JAX package stacks them over a leading layers axis.
Prefill attention runs through K5 under ``attn_impl="pallas"``: the
encoder's non-causal, the decoder's causal, and the cross-attention's,
whose queries and keys differ in length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.models import common
from repro_torch.models.blocks import MLP, Attention, param
from repro_torch.models.config import ModelConfig, Runtime

Cache = list[dict[str, torch.Tensor]]


class EncDec(nn.Module):
    """The encoder-decoder of one :class:`ModelConfig` (``n_encoder_layers``
    > 0). Parameters have the JAX package's names (``encoder.<i>.attn``,
    ``decoder.<i>.self``, ``decoder.<i>.cross``, ...) and are made empty on
    ``device`` in ``cfg.pdtype``; :func:`init_encdec` fills them."""

    STACKED = ("encoder", "decoder")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.n_encoder_layers < 1:
            raise ValueError(f"{cfg.name} has no encoder layers")
        d, pd = cfg.d_model, cfg.pdtype
        self.cfg = cfg
        self.embed = param(cfg.vocab_size, d, dtype=pd, device=device)
        self.encoder = nn.ModuleList(
            nn.ModuleDict({"attn": Attention(cfg, device), "ffn": MLP(cfg, device=device)})
            for _ in range(cfg.n_encoder_layers))
        self.enc_norm = param(d, dtype=pd, device=device)
        self.decoder = nn.ModuleList(
            nn.ModuleDict({"self": Attention(cfg, device), "cross": Attention(cfg, device),
                           "ffn": MLP(cfg, device=device)})
            for _ in range(cfg.n_layers))
        self.final_norm = param(d, dtype=pd, device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        common.trunc_normal_(self.embed, self.cfg.d_model ** -0.5, g)
        for layer in (*self.encoder, *self.decoder):
            for block in layer.values():
                block.init_weights(g)
        self.enc_norm.fill_(1.0)
        self.final_norm.fill_(1.0)


def init_encdec(cfg: ModelConfig, *, seed: int = 0, device=None) -> EncDec:
    """The encoder-decoder of ``cfg`` with random weights from ``seed``, made
    on ``device`` (``cuda:0`` unless the caller names another) in the
    parameter dtype."""
    dev = resolve_device(device)
    model = EncDec(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None].expand(b, s)


def encode(model: EncDec, rt: Runtime, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B,Se,D] precomputed frontend embeddings -> memory [B,Se,D]."""
    x = frames.to(model.embed.device, model.cfg.cdtype)
    pos = _positions(x)
    for layer in model.encoder:
        x, _ = layer["attn"](x, rt, pos, causal=False)
        x = layer["ffn"](x, rt)
    return common.rmsnorm(x, model.enc_norm)


def decode_train(model: EncDec, rt: Runtime, memory: torch.Tensor, tokens: torch.Tensor):
    """The teacher-forced decoder over ``tokens`` [B,S] against ``memory``.
    Returns (hidden [B,S,D], one cache a layer {k, v, ck, cv} in the
    compute dtype)."""
    cd = model.cfg.cdtype
    x = F.embedding(tokens.to(model.embed.device, torch.long), model.embed).to(cd)
    pos = _positions(x)
    caches: Cache = []
    for layer in model.decoder:
        x, (k, v) = layer["self"](x, rt, pos)
        x, (ck, cv) = layer["cross"](x, rt, None, kv=memory)
        x = layer["ffn"](x, rt)
        caches.append({"k": k.to(cd), "v": v.to(cd), "ck": ck.to(cd), "cv": cv.to(cd)})
    return common.rmsnorm(x, model.final_norm), caches


@torch.no_grad()
def prefill(model: EncDec, rt: Runtime, frames: torch.Tensor, tokens: torch.Tensor):
    """Encode and run the teacher-forced prompt; returns (the last token's
    logits [B,V] float32, caches)."""
    h, caches = decode_train(model, rt, encode(model, rt, frames), tokens)
    return common.top1_logits(h[:, -1], model.embed), caches


def init_cache(model: EncDec, batch: int, max_len: int, enc_len: int,
               dtype: torch.dtype) -> Cache:
    cfg = model.cfg
    dev = model.embed.device

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(batch, n, cfg.n_kv_heads, cfg.hd, dtype=dtype, device=dev)

    return [{"k": zeros(max_len), "v": zeros(max_len), "ck": zeros(enc_len),
             "cv": zeros(enc_len)} for _ in range(cfg.n_layers)]


def pad_cache(cache: Cache, new_len: int) -> Cache:
    """Grow the self-attention caches to ``new_len`` positions; the cross
    caches keep the encoder's length."""
    return [{name: (F.pad(a, (0, 0, 0, 0, 0, new_len - a.shape[1]))
                    if name in ("k", "v") and a.shape[1] < new_len else a)
             for name, a in c.items()} for c in cache]


@torch.no_grad()
def decode_step(model: EncDec, cache: Cache, tokens: torch.Tensor, pos, rt: Runtime):
    """One token for the whole batch. tokens: [B,1]; pos: a scalar or [B]
    per-row positions; the self-attention caches are written in place.
    Returns (logits [B,V] float32, the new cache)."""
    cd = model.cfg.cdtype
    x = F.embedding(tokens.to(model.embed.device, torch.long), model.embed).to(cd)
    new_cache: Cache = []
    for layer, c in zip(model.decoder, cache):
        x, kv = layer["self"].decode(x, {"k": c["k"], "v": c["v"]}, pos, rt)
        x = layer["cross"].cross_decode(x, (c["ck"], c["cv"]))
        x = layer["ffn"](x, rt)
        new_cache.append({**kv, "ck": c["ck"], "cv": c["cv"]})
    h = common.rmsnorm(x, model.final_norm)
    return common.top1_logits(h[:, 0], model.embed), new_cache
