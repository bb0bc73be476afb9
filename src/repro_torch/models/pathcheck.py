"""Holding a model's kernel path against its plain path, layer by layer.

The kernel path (``attn_impl="pallas"``, ``use_pallas``: K5 and K7) and the
plain path (plain attention, the chunked scan) of one model differ by a
rounding here and there. End to end those differences grow through the
bfloat16 layers, and a router input one ulp apart moves a token to another
expert, so no fixed limit on the logits tells a sound kernel from an
unsound one. Layer by layer, each layer of both paths is given the plain
path's input and the same expert choices, and its output stays within a
fixed limit:

- :func:`prefill_layers`: every layer of one prefill, its cache (the Mamba
  state K7 returns, the KV and conv caches), and the logits of the last
  layer's output;
- :func:`decode_layers`: the first decode step after each path's prefill,
  each layer given the plain path's input and its own path's cache, and
  the cache each hands on.

Errors are counted by :func:`row_scaled_ratio`: the worst
|got - want| / (tol * (|want| + rms(want's row))); above 1 a check fails.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.models import blocks, common, encdec, transformer
from repro_torch.models.config import Runtime

# every layer output and the logits: 2^-5 * (|want| + rms(row)), four bf16
# ulps of an element of the residual stream; a Mamba state (float32) 2^-13
LAYER_TOL = 2.0 ** -5
STATE_TOL = 2.0 ** -13


def row_scaled_ratio(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """The largest |got - want| / (tol * (|want| + rms(want's row))), a row
    being the last dimension; an element whose limit is 0 (an all-zero
    row) must match exactly, and a non-finite ``got`` fails. Above 1 the
    comparison fails."""
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} against {tuple(want.shape)}")
    g, w = got.float(), want.float()
    limit = tol * (w.abs() + w.pow(2).mean(dim=-1, keepdim=True).sqrt())
    err = (g - w).abs()
    ratio = torch.where(limit > 0, err / limit.clamp_min(1e-38),
                        torch.where(err > 0, torch.inf, 0.0))
    ratio = torch.where(torch.isfinite(g), ratio, torch.inf)
    return float(ratio.max()) if ratio.numel() else 0.0


@dataclasses.dataclass
class RoutingLog:
    """The top-k expert choices of MoE blocks, one entry a router call, in
    call order (see :func:`pinned_routing`). ``moved`` counts the tokens
    whose own choice, while replaying, differed from the recorded one."""

    choices: list[torch.Tensor] = dataclasses.field(default_factory=list)
    replay: bool = False
    moved: int = 0
    tokens: int = 0

    def replayed(self) -> RoutingLog:
        """A log that replays this one's choices."""
        return RoutingLog(choices=list(self.choices), replay=True)


@contextlib.contextmanager
def pinned_routing(log: RoutingLog):
    """For the time of the block, record every MoE router call's expert
    choices into ``log`` or, with ``log.replay``, make each call take the
    next recorded choice (its weights from the block's own gates).

    Two paths held against each other need the same choices: a router
    input one bfloat16 ulp apart can move a token to another expert, and
    with it the tokens after it in that expert's capacity buffer. The
    model carries no hook for it: ``blocks.MoE._route`` is wrapped here."""
    real = blocks.MoE._route

    def route(self, hf: torch.Tensor, k: int):
        gates, top_w, top_e = real(self, hf, k)
        if not log.replay:
            log.choices.append(top_e)
            return gates, top_w, top_e
        own, top_e = top_e, log.choices.pop(0)
        log.moved += int((own != top_e).any(dim=-1).sum())
        log.tokens += own[..., 0].numel()
        top_w = torch.gather(gates, -1, top_e)
        return gates, top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9), top_e

    blocks.MoE._route = route
    try:
        yield log
    finally:
        blocks.MoE._route = real


def _cache_ratios(got: dict, want: dict) -> tuple[float, float | None]:
    """(the KV or conv cache's worst ratio at LAYER_TOL, the Mamba state's
    at STATE_TOL or None)."""
    other = max((row_scaled_ratio(got[n], want[n], LAYER_TOL) for n in got if n != "h"),
                default=0.0)
    state = row_scaled_ratio(got["h"], want["h"], STATE_TOL) if "h" in got else None
    return other, state


def _row(step: str, layer: str, kind, out: float, cache=(None, None)) -> dict:
    """``layer`` is "<period>.<name>" or "logits"; ``kind`` the layer's
    (mixer, ffn)."""
    worst = max(r for r in (out, cache[0], cache[1]) if r is not None)
    return {"step": step, "layer": layer, "kind": kind, "out": out, "cache": cache[0],
            "state": cache[1], "worst": worst}


@torch.no_grad()
def prefill_layers(model: transformer.LM, kern: Runtime, plain: Runtime,
                   tokens: torch.Tensor | None = None, *, embeds: torch.Tensor | None = None,
                   positions: torch.Tensor | None = None) -> tuple[list[dict], list, list]:
    """Each layer of a prefill of ``tokens`` (or ``embeds``, at
    ``positions``, [3,B,S] under M-RoPE) on both paths, given the plain
    path's input, the plain path taking the kernel path's expert choices.
    Returns (one row a layer and one for the last-token logits, the kernel
    path's caches, the plain path's caches); a row holds the output's ratio
    at LAYER_TOL, the KV or conv cache's at LAYER_TOL, the Mamba state's at
    STATE_TOL, and the worst of them."""
    x = transformer._embed_in(model, tokens, embeds)
    b, s = x.shape[:2]
    pos = (torch.arange(s, device=x.device)[None].expand(b, s) if positions is None
           else positions.to(x.device))
    rows, caches_k, caches_p = [], [], []
    for i, period in enumerate(model.periods):
        pc_k, pc_p = {}, {}
        for name, block in period.items():
            with pinned_routing(RoutingLog()) as log:
                y_k, _, pc_k[name] = block(x, kern, pos)
            with pinned_routing(log.replayed()):
                y_p, _, pc_p[name] = block(x, plain, pos)
            rows.append(_row("prefill", f"{i}.{name}", block.layer,
                             row_scaled_ratio(y_k, y_p, LAYER_TOL),
                             _cache_ratios(pc_k[name], pc_p[name])))
            x = y_p
        caches_k.append(pc_k)
        caches_p.append(pc_p)
    emb = model.out_embed()
    lg_k = common.top1_logits(common.rmsnorm(y_k, model.final_norm)[:, -1], emb)
    lg_p = common.top1_logits(common.rmsnorm(y_p, model.final_norm)[:, -1], emb)
    rows.append(_row("prefill", "logits", None, row_scaled_ratio(lg_k, lg_p, LAYER_TOL)))
    return rows, caches_k, caches_p


@torch.no_grad()
def decode_layers(model: transformer.LM, caches_k: list, caches_p: list, tokens: torch.Tensor,
                  pos: int, kern: Runtime, plain: Runtime,
                  positions: torch.Tensor | None = None) -> list[dict]:
    """The decode step of ``tokens`` ([B, 1]) at ``pos`` (rope ``positions``
    where they are not ``pos``) after a prefill of ``pos`` tokens, each
    layer given the plain path's input and run on each path's own prefill
    cache, the same expert choices on both. Returns a row a layer (as
    :func:`prefill_layers`', of the output and of the cache the step hands
    on) and one for the logits. The caches are not changed."""
    cfg = model.cfg
    ck, cp = (transformer.pad_cache(c, cfg, pos + 1) for c in (caches_k, caches_p))
    x = transformer._embed_in(model, tokens)
    rows = []
    for i, (period, pc_k, pc_p) in enumerate(zip(model.periods, ck, cp)):
        for name, block in period.items():
            with pinned_routing(RoutingLog()) as log:
                y_k, new_k = block.decode(x, pc_k[name], pos, kern, positions)
            with pinned_routing(log.replayed()):
                y_p, new_p = block.decode(x, pc_p[name], pos, plain, positions)
            rows.append(_row("decode", f"{i}.{name}", block.layer,
                             row_scaled_ratio(y_k, y_p, LAYER_TOL), _cache_ratios(new_k, new_p)))
            x = y_p
    emb = model.out_embed()
    lg_k = common.top1_logits(common.rmsnorm(y_k, model.final_norm)[:, 0], emb)
    lg_p = common.top1_logits(common.rmsnorm(y_p, model.final_norm)[:, 0], emb)
    rows.append(_row("decode", "logits", None, row_scaled_ratio(lg_k, lg_p, LAYER_TOL)))
    return rows


def _logits_row(step: str, emb: torch.Tensor, norm: torch.Tensor, h_k: torch.Tensor,
                h_p: torch.Tensor) -> dict:
    return _row(step, "logits", None, row_scaled_ratio(
        common.top1_logits(common.rmsnorm(h_k, norm), emb),
        common.top1_logits(common.rmsnorm(h_p, norm), emb), LAYER_TOL))


@torch.no_grad()
def encdec_prefill_layers(model: encdec.EncDec, kern: Runtime, plain: Runtime,
                          frames: torch.Tensor, tokens: torch.Tensor
                          ) -> tuple[list[dict], list, list]:
    """:func:`prefill_layers` for an encoder-decoder: each encoder layer
    (attention and FFN), the memory (the encoder's norm), and each decoder
    layer (self-attention, cross-attention to the plain path's memory and
    FFN) of both paths given the plain path's input; then the logits.
    Returns (the rows, the kernel path's caches, the plain path's)."""
    cd = model.cfg.cdtype
    x = frames.to(model.embed.device, cd)
    b, se = x.shape[:2]
    pos = torch.arange(se, device=x.device)[None].expand(b, se)
    rows = []
    for i, layer in enumerate(model.encoder):
        y_k = layer["ffn"](layer["attn"](x, kern, pos, causal=False)[0], kern)
        y_p = layer["ffn"](layer["attn"](x, plain, pos, causal=False)[0], plain)
        rows.append(_row("encode", f"enc.{i}", ("attn", "dense"),
                         row_scaled_ratio(y_k, y_p, LAYER_TOL)))
        x = y_p
    mem_k, mem = common.rmsnorm(y_k, model.enc_norm), common.rmsnorm(y_p, model.enc_norm)
    rows.append(_row("encode", "memory", None, row_scaled_ratio(mem_k, mem, LAYER_TOL)))
    x = torch.nn.functional.embedding(tokens.to(x.device, torch.long), model.embed).to(cd)
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    caches_k, caches_p = [], []
    for i, layer in enumerate(model.decoder):
        outs = []
        for rt, caches in ((kern, caches_k), (plain, caches_p)):
            y, (k, v) = layer["self"](x, rt, pos)
            y, (ck, cv) = layer["cross"](y, rt, None, kv=mem)
            outs.append(layer["ffn"](y, rt))
            caches.append({"k": k.to(cd), "v": v.to(cd), "ck": ck.to(cd), "cv": cv.to(cd)})
        rows.append(_row("prefill", f"dec.{i}", ("attn", "dense"),
                         row_scaled_ratio(outs[0], outs[1], LAYER_TOL),
                         _cache_ratios(caches_k[-1], caches_p[-1])))
        x = outs[1]
    rows.append(_logits_row("prefill", model.embed, model.final_norm, outs[0][:, -1],
                            outs[1][:, -1]))
    return rows, caches_k, caches_p


@torch.no_grad()
def encdec_decode_layers(model: encdec.EncDec, caches_k: list, caches_p: list,
                         tokens: torch.Tensor, pos: int, kern: Runtime,
                         plain: Runtime) -> list[dict]:
    """:func:`decode_layers` for an encoder-decoder: each decoder layer of
    the step at ``pos`` given the plain path's input and run on each path's
    own prefill cache; a row a layer and one for the logits. The caches are
    not changed."""
    cd = model.cfg.cdtype
    ck, cp = (encdec.pad_cache(c, pos + 1) for c in (caches_k, caches_p))
    x = torch.nn.functional.embedding(tokens.to(model.embed.device, torch.long),
                                      model.embed).to(cd)
    rows = []
    for i, (layer, c_k, c_p) in enumerate(zip(model.decoder, ck, cp)):
        outs, new = [], []
        for rt, c in ((kern, c_k), (plain, c_p)):
            y, kv = layer["self"].decode(x, {"k": c["k"].clone(), "v": c["v"].clone()}, pos, rt)
            y = layer["cross"].cross_decode(y, (c["ck"], c["cv"]))
            outs.append(layer["ffn"](y, rt))
            new.append(kv)
        rows.append(_row("decode", f"dec.{i}", ("attn", "dense"),
                         row_scaled_ratio(outs[0], outs[1], LAYER_TOL), _cache_ratios(*new)))
        x = outs[1]
    rows.append(_logits_row("decode", model.embed, model.final_norm, outs[0][:, 0],
                            outs[1][:, 0]))
    return rows


def zero_states(caches: list) -> list:
    """The caches with every Mamba state zeroed: what the JAX package's
    kernel path hands its decode step (R3)."""
    return [{layer: ({**c, "h": torch.zeros_like(c["h"])} if "h" in c else c)
             for layer, c in pc.items()} for pc in caches]
