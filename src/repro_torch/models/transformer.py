"""Decoder-only LM assembly: init / forward / prefill / decode step (the port
of ``repro/models/transformer.py``).

The model is an ``nn.Module`` (:class:`LM`) with one module per period in an
``nn.ModuleList`` (``periods[p]["l<i>"]`` is the period's i-th layer, with
``mixer`` and ``ffn`` submodules), run eagerly one period after another: the
JAX package's ``scan_layers`` and ``remat`` knobs change nothing here.
Caches are a list with one dict per period, ``{"l<i>": {...}}``, where the
JAX package stacks them over a leading periods axis.

Mixers: attention (rope, or M-RoPE under ``cfg.mrope_sections``), Mamba,
mLSTM and sLSTM; FFNs: dense, MoE and none. ``forward`` and ``prefill``
take token ids or embeddings (``embeds``: a vision or audio frontend's
output, which the JAX package also leaves to the caller). Encoder-decoder
configs are :mod:`repro_torch.models.encdec`'s.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.models import blocks, common, ssm, xlstm
from repro_torch.models.config import Layer, ModelConfig, Runtime

Cache = list[dict[str, dict[str, torch.Tensor]]]
MIXERS = {"attn": blocks.Attention, "mamba": ssm.Mamba, "mlstm": xlstm.MLSTM,
          "slstm": xlstm.SLSTM}


# ------------------------------------------------------------------- blocks
class Block(nn.Module):
    """One layer: a mixer (attention, Mamba, mLSTM or sLSTM) and an FFN
    (dense, MoE or none)."""

    def __init__(self, layer: Layer, cfg: ModelConfig, device=None):
        super().__init__()
        mixer, ffn = layer
        self.layer = layer
        self.cfg = cfg
        self.mixer = MIXERS[mixer](cfg, device)
        self.ffn = (blocks.MLP(cfg, device=device) if ffn == "dense"
                    else blocks.MoE(cfg, device) if ffn == "moe" else None)

    def init_weights(self, g: torch.Generator) -> None:
        self.mixer.init_weights(g)
        if self.ffn is not None:
            self.ffn.init_weights(g)

    def forward(self, x: torch.Tensor, rt: Runtime, positions: torch.Tensor):
        """Returns (x, aux_loss, prefill_cache)."""
        if self.layer[0] == "attn":
            x, (k, v) = self.mixer(x, rt, positions)
            cache = {"k": k.to(self.cfg.cdtype), "v": v.to(self.cfg.cdtype)}
        else:
            x, cache = self.mixer(x, rt)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.layer[1] == "dense":
            x = self.ffn(x, rt)
        elif self.layer[1] == "moe":
            x, aux = self.ffn(x, rt)
        return x, aux, cache

    def decode(self, x: torch.Tensor, cache: dict, pos, rt: Runtime, positions=None):
        if self.layer[0] == "attn":
            x, cache = self.mixer.decode(x, cache, pos, rt, positions)
        else:
            x, cache = self.mixer.decode(x, cache)
        if self.layer[1] == "dense":
            x = self.ffn(x, rt)
        elif self.layer[1] == "moe":
            x, _ = self.ffn(x, rt)
        return x, cache

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype, device) -> dict:
        if self.layer[0] == "attn":
            return self.mixer.init_cache(batch, max_len, dtype, device)
        return self.mixer.init_cache(batch, dtype, device)


# --------------------------------------------------------------------- LM
class LM(nn.Module):
    """The decoder-only LM of one :class:`ModelConfig`. Parameters are made
    empty on ``device`` in ``cfg.pdtype``; :func:`init_lm` fills them."""

    # the module lists whose layers the JAX package stacks on a leading axis
    STACKED = ("periods",)

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.n_encoder_layers:
            raise ValueError(f"{cfg.name} is an encoder-decoder config: models.encdec.EncDec "
                             "builds it")
        self.cfg = cfg
        d, v, pd = cfg.d_model, cfg.vocab_size, cfg.pdtype
        self.embed = blocks.param(v, d, dtype=pd, device=device)
        self.periods = nn.ModuleList(
            nn.ModuleDict({f"l{i}": Block(layer, cfg, device)
                           for i, layer in enumerate(cfg.period)})
            for _ in range(cfg.n_periods))
        self.final_norm = blocks.param(d, dtype=pd, device=device)
        self.lm_head = None if cfg.tie_embeddings else blocks.param(v, d, dtype=pd,
                                                                    device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        scale = self.cfg.d_model ** -0.5
        common.trunc_normal_(self.embed, scale, g)
        if self.lm_head is not None:
            common.trunc_normal_(self.lm_head, scale, g)
        for period in self.periods:
            for block in period.values():
                block.init_weights(g)
        self.final_norm.fill_(1.0)

    def out_embed(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """The LM of ``cfg`` with random weights from ``seed``, made on ``device``
    (``cuda:0`` unless the caller names another) in the parameter dtype:
    no float32 copy of a bfloat16 model is ever held."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model


def n_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _embed_in(model: LM, tokens: torch.Tensor | None, embeds=None) -> torch.Tensor:
    """The input activations: ``embeds`` [B,S,D] cast to the compute dtype
    where given (a frontend's patch or frame embeddings), else the token
    ids' embeddings."""
    if embeds is not None:
        return embeds.to(model.embed.device, model.cfg.cdtype)
    return F.embedding(tokens.to(model.embed.device, torch.long),
                       model.embed).to(model.cfg.cdtype)


def forward(model: LM, rt: Runtime, *, tokens=None, embeds=None, positions=None,
            want_cache: bool = False):
    """Full-sequence forward of ``tokens`` or ``embeds``. ``positions``
    default to 0..S-1 in every row ([B,S]); an M-RoPE config needs its own
    [3,B,S] (R7). Returns (hidden [B,S,D], aux, caches: one dict per
    period, empty dicts unless ``want_cache``)."""
    x = _embed_in(model, tokens, embeds)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Cache = []
    for period in model.periods:
        pc = {}
        for name, block in period.items():
            x, a, cache = block(x, rt, positions)
            aux = aux + a
            if want_cache:
                pc[name] = cache
        caches.append(pc)
    h = common.rmsnorm(x, model.final_norm)
    return h, aux, caches


# ------------------------------------------------------------------ serving
def pad_cache(cache: Cache, cfg: ModelConfig, new_len: int) -> Cache:
    """Grow attention KV caches ([B,S,KH,hd]) to ``new_len`` positions."""
    def grow(name: str, a: torch.Tensor) -> torch.Tensor:
        if name in ("k", "v") and a.shape[1] < new_len:
            return F.pad(a, (0, 0, 0, 0, 0, new_len - a.shape[1]))
        return a
    return [{layer: {name: grow(name, a) for name, a in c.items()} for layer, c in pc.items()}
            for pc in cache]


def init_cache(model: LM, batch: int, max_len: int, dtype: torch.dtype) -> Cache:
    dev = model.embed.device
    return [{name: block.init_cache(batch, max_len, dtype, dev)
             for name, block in period.items()} for period in model.periods]


@torch.no_grad()
def prefill(model: LM, rt: Runtime, *, tokens=None, embeds=None, positions=None,
            last_positions=None):
    """Process the prompt; returns (last-token logits [B,V] float32, caches).

    ``last_positions`` ([B] int) gathers each row's logits at its *own*
    final prompt token instead of the padded batch's last column: a
    right-padded row is sampled from its true last token (causality makes
    that gather exact: position ``len-1`` never attends to the padding).
    """
    h, _, caches = forward(model, rt, tokens=tokens, embeds=embeds, positions=positions,
                           want_cache=True)
    if last_positions is None:
        last = h[:, -1]
    else:
        rows = torch.arange(h.shape[0], device=h.device)
        last = h[rows, torch.as_tensor(last_positions, device=h.device).long()]
    return common.top1_logits(last, model.out_embed()), caches


@torch.no_grad()
def decode_step(model: LM, cache: Cache, tokens: torch.Tensor, pos, rt: Runtime,
                positions=None):
    """One token for the whole batch. tokens: [B,1]; pos: a scalar, or [B]
    per-row positions (the KV write index); ``positions`` the rope
    positions where they are not ``pos`` ([3,B,1] under M-RoPE). Attention
    caches are written in place; returns (logits [B,V] float32, the new
    cache)."""
    x = _embed_in(model, tokens)
    new_cache: Cache = []
    for period, pc in zip(model.periods, cache):
        nc = {}
        for name, block in period.items():
            x, nc[name] = block.decode(x, pc[name], pos, rt, positions)
        new_cache.append(nc)
    h = common.rmsnorm(x, model.final_norm)
    return common.top1_logits(h[:, 0], model.out_embed()), new_cache


# ----------------------------------------------------------- JAX weights in
def _flatten(tree: dict[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, f"{name}."))
        else:
            out[name] = np.asarray(val)
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: dict[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters from the JAX package's ``init_lm`` tree
    (or, for an :class:`encdec.EncDec`, its ``init_encdec`` tree), given as
    nested dicts of numpy arrays (each ``Param``'s value; the caller
    converts, since this package imports no JAX). The leading axis that the
    JAX package stacks onto every layer parameter is split, layer p of
    ``periods`` (``encoder``, ``decoder``: ``model.STACKED``) going to
    ``periods.<p>``; each array is cast to the parameter's dtype. Raises on
    any name or shape left over on either side."""
    flat = {}
    for name, arr in _flatten(tree).items():
        top, _, rest = name.partition(".")
        if top in model.STACKED:
            for p in range(arr.shape[0]):
                flat[f"{top}.{p}.{rest}"] = arr[p]
        else:
            flat[name] = arr
    params = dict(model.named_parameters())
    missing, extra = sorted(params.keys() - flat.keys()), sorted(flat.keys() - params.keys())
    bad = [f"{n}: {tuple(flat[n].shape)} against {tuple(params[n].shape)}"
           for n in sorted(params.keys() & flat.keys())
           if tuple(flat[n].shape) != tuple(params[n].shape)]
    if missing or extra or bad:
        raise ValueError(f"load_jax_params: parameters without a value {missing}, values "
                         f"without a parameter {extra}, shapes that differ {bad}")
    for name, p in params.items():
        p.copy_(torch.from_numpy(np.array(flat[name])).to(p.dtype))
    return model
