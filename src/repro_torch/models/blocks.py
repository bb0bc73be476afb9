"""Attention / MLP / MoE blocks (the port of ``repro/models/blocks.py``).

Each block is an ``nn.Module`` whose parameters have the JAX package's names
and shapes (``wq`` [D,H,hd], ``wo`` [H,hd,D], expert ``wg`` [E,D,F], ...), so
a JAX parameter tree loads into it as it is (``transformer.load_jax_params``).
Parameters are made empty on the caller's device in the config's parameter
dtype and filled by ``init_weights`` from an explicit ``torch.Generator``.

The JAX package's ``annotate`` and ``gather_weight`` calls are sharding
hints that change no math; one card shards nothing, so they are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.config import ModelConfig, Runtime


def param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised parameter; ``init_weights`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def dense_init_(w: torch.Tensor, d_in: int, g: torch.Generator) -> None:
    """The JAX package's ``dense_param`` scale: (1 / d_in) ** 0.5."""
    common.trunc_normal_(w, (1.0 / max(d_in, 1)) ** 0.5, g)


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis, largest first, ties to the
    lower index: ``lax.top_k``'s order, which ``torch.topk`` does not
    promise. A stable descending sort keeps equal gates in index order."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# =========================================================== attention block
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, kh, hd, pd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.pdtype
        self.cfg = cfg
        self.norm = param(d, dtype=pd, device=device)
        self.wq = param(d, h, hd, dtype=pd, device=device)
        self.wk = param(d, kh, hd, dtype=pd, device=device)
        self.wv = param(d, kh, hd, dtype=pd, device=device)
        self.wo = param(h, hd, d, dtype=pd, device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        d, h, hd = self.cfg.d_model, self.cfg.n_heads, self.cfg.hd
        self.norm.fill_(1.0)
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, d, g)
        dense_init_(self.wo, h * hd, g)

    def _project(self, h: torch.Tensor, src: torch.Tensor | None = None):
        """q from ``h``; k and v from ``src`` (an encoder memory), else ``h``."""
        cd = self.cfg.cdtype
        src = h if src is None else src
        q = torch.einsum("bsd,dhk->bshk", h, self.wq.to(cd))
        k = torch.einsum("bsd,dhk->bshk", src, self.wk.to(cd))
        v = torch.einsum("bsd,dhk->bshk", src, self.wv.to(cd))
        return q, k, v

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return common.rmsnorm(x, self.norm) if self.cfg.norm == "rmsnorm" else x

    def _rope(self, q, k, positions):
        """Rotary embeddings at ``positions``: [B,S], or under M-RoPE
        (``cfg.mrope_sections``) [3,B,S], the t, h and w streams. M-RoPE
        given [B,S] positions raises: the JAX package's ``apply_mrope``
        indexes their batch axis as the three streams and fails with an
        IndexError (R7), so its default positions, which ``forward`` and
        the decode step build when none are given, cannot run."""
        if positions is None:
            return q, k
        cfg = self.cfg
        if cfg.mrope_sections is None:
            return (common.apply_rope(q, positions, cfg.rope_theta),
                    common.apply_rope(k, positions, cfg.rope_theta))
        if positions.dim() != 3 or positions.shape[0] != 3:
            raise ValueError(f"{cfg.name}: M-RoPE takes positions [3, B, S] (t, h, w); got "
                             f"{tuple(positions.shape)}: pass positions (R7)")
        return (common.apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta),
                common.apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta))

    def forward(self, x: torch.Tensor, rt: Runtime, positions: torch.Tensor | None,
                *, causal: bool = True, kv: torch.Tensor | None = None):
        """Full-sequence attention (train / prefill). x: [B,S,D]. Returns
        (x + attention, (k, v)) with k, v [B,S,KH,hd] after rope.

        ``kv``: an encoder memory [B,Se,D] for cross-attention: keys and
        values are projected from it, no rope, and every query sees every
        key (not causal)."""
        q, k, v = self._project(self._norm(x), kv)
        if kv is None:
            q, k = self._rope(q, k, positions)
        out = common.attention(q, k, v, causal=causal and kv is None, impl=rt.attn_impl,
                               block_k=rt.block_k, p_dtype=getattr(torch, rt.attn_p_dtype))
        y = torch.einsum("bshk,hkd->bsd", out, self.wo.to(self.cfg.cdtype))
        return x + y, (k, v)

    def cross_decode(self, x: torch.Tensor, mem_kv: tuple[torch.Tensor, torch.Tensor]):
        """Cross-attention decode step (the JAX package's ``attn_cross_decode``)
        against the encoder memory's precomputed keys and values [B,Se,KH,hd].
        x: [B,1,D]. Its norm is RMSNorm whatever ``cfg.norm`` says, as in
        the JAX package."""
        cd = self.cfg.cdtype
        q = torch.einsum("bsd,dhk->bshk", common.rmsnorm(x, self.norm), self.wq.to(cd))
        k, v = mem_kv
        out = common.decode_attention(q[:, 0], k, v, kv_len=k.shape[1])
        return x + torch.einsum("bhk,hkd->bd", out, self.wo.to(cd))[:, None]

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype, device) -> dict:
        shape = (batch, max_len, self.cfg.n_kv_heads, self.cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode(self, x: torch.Tensor, cache: dict, pos, rt: Runtime, positions=None):
        """One-token step. x: [B,1,D]; cache k/v: [B,Smax,KH,hd], written in
        place at ``pos`` and returned.

        ``pos`` is either a scalar (the whole batch decodes in lockstep at one
        position: the static-batch path) or a ``[B]`` integer tensor of
        *per-row* positions (the continuous-batching path: the KV write is a
        per-row scatter and the attention mask a per-row ``kv_len``).
        """
        b = x.shape[0]
        q, k, v = self._project(self._norm(x))
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        if positions is None:
            positions = (pos.to(x.device, torch.long)[:, None] if per_row
                         else torch.full((b, 1), int(pos), dtype=torch.long, device=x.device))
        q, k = self._rope(q, k, positions)
        ck, cv = cache["k"], cache["v"]
        if per_row:
            rows = torch.arange(b, device=x.device)
            idx = pos.to(x.device, torch.long)
            ck[rows, idx] = k[:, 0].to(ck.dtype)
            cv[rows, idx] = v[:, 0].to(cv.dtype)
            kv_len = idx + 1
        else:
            ck[:, int(pos)] = k[:, 0].to(ck.dtype)
            cv[:, int(pos)] = v[:, 0].to(cv.dtype)
            kv_len = int(pos) + 1
        out = common.decode_attention(q[:, 0], ck, cv, kv_len=kv_len)
        y = torch.einsum("bhk,hkd->bd", out, self.wo.to(self.cfg.cdtype))[:, None]
        return x + y, {"k": ck, "v": cv}


# ================================================================= MLP block
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: int | None = None, device=None):
        super().__init__()
        d, f, pd = cfg.d_model, d_ff or cfg.d_ff, cfg.pdtype
        self.cfg = cfg
        self.norm = param(d, dtype=pd, device=device)
        self.wg = param(d, f, dtype=pd, device=device)
        self.wu = param(d, f, dtype=pd, device=device)
        self.wd = param(f, d, dtype=pd, device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        d, f = self.wg.shape
        self.norm.fill_(1.0)
        dense_init_(self.wg, d, g)
        dense_init_(self.wu, d, g)
        dense_init_(self.wd, f, g)

    def forward(self, x: torch.Tensor, rt: Runtime | None = None) -> torch.Tensor:
        h = common.rmsnorm(x, self.norm)
        cd = self.cfg.cdtype
        gate = torch.einsum("bsd,df->bsf", h, self.wg.to(cd))
        up = torch.einsum("bsd,df->bsf", h, self.wu.to(cd))
        y = torch.einsum("bsf,fd->bsd", F.silu(gate) * up, self.wd.to(cd))
        return x + y


# ================================================================= MoE block
def _dispatch_indices(expert_idx: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """Sort-based dispatch within each group. expert_idx: [G, N] -> slot
    [G, N] in [0, E*C], E*C meaning dropped. Tokens of one expert take its
    slots in token order (a stable argsort, as the JAX package's)."""
    g, n = expert_idx.shape
    order = torch.argsort(expert_idx, dim=-1, stable=True)               # [G,N]
    sorted_e = torch.gather(expert_idx, -1, order)
    counts = torch.zeros(g, n_experts, dtype=torch.long, device=expert_idx.device)
    counts.scatter_add_(1, expert_idx, torch.ones_like(expert_idx))
    starts = torch.cumsum(counts, dim=-1) - counts                       # exclusive
    pos_in_e = (torch.arange(n, device=expert_idx.device)[None, :]
                - torch.gather(starts, -1, sorted_e))
    keep = pos_in_e < capacity
    slot_sorted = torch.where(keep, sorted_e * capacity + pos_in_e,
                              torch.full_like(pos_in_e, n_experts * capacity))
    # unsort the slot assignment back to token order
    return torch.zeros_like(slot_sorted).scatter_(1, order, slot_sorted)


def _load_balance_loss(gates: torch.Tensor, top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss."""
    me = gates.mean(dim=(0, 1))                                          # [E]
    g, n, k = top_e.shape
    counts = torch.zeros(g, n_experts, dtype=torch.float32, device=gates.device)
    counts.scatter_add_(1, top_e.reshape(g, n * k),
                        torch.ones(g, n * k, dtype=torch.float32, device=gates.device))
    ce = counts.mean(dim=0) / (n * k)                                    # [E]
    return n_experts * (me * ce).sum()


class MoE(nn.Module):
    """Token-choice top-k MoE with sort-based capacity dispatch.

    Tokens are regrouped as [G, N/G] (``rt.moe_groups``, the JAX package's
    data shards; on one card a grouping only changes the capacity of each
    group). Every expert runs on its capacity buffer densely, as in the JAX
    package: a token past its expert's capacity in a group is dropped.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, e, pd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.pdtype
        self.cfg = cfg
        self.norm = param(d, dtype=pd, device=device)
        self.router = param(d, e, dtype=pd, device=device)
        self.wg = param(e, d, f, dtype=pd, device=device)
        self.wu = param(e, d, f, dtype=pd, device=device)
        self.wd = param(e, f, d, dtype=pd, device=device)
        self.shared = MLP(cfg, device=device) if cfg.shared_expert else None

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_ff
        self.norm.fill_(1.0)
        dense_init_(self.router, d, g)
        dense_init_(self.wg, d, g)
        dense_init_(self.wu, d, g)
        dense_init_(self.wd, f, g)
        if self.shared is not None:
            self.shared.init_weights(g)

    def _route(self, hf: torch.Tensor, k: int):
        """Router gates [..., E] in float32 and the normalised top-k."""
        logits = hf.float() @ self.router.float()
        gates = torch.softmax(logits, dim=-1)
        top_w, top_e = top_k(gates, k)
        top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return gates, top_w, top_e

    def forward(self, x: torch.Tensor, rt: Runtime):
        """x: [B,S,D] -> (x + experts, load-balance aux loss)."""
        b, s, d = x.shape
        cfg = self.cfg
        e, k, cd = cfg.n_experts, cfg.top_k, cfg.cdtype
        h = common.rmsnorm(x, self.norm)
        n_tok = b * s
        if rt.moe_gather_decode and n_tok <= 256:
            return self._gather_few_tokens(x, h)
        g = rt.moe_groups if n_tok % max(rt.moe_groups, 1) == 0 else 1
        ng = n_tok // g
        xt = h.reshape(g, ng, d)
        gates, top_w, top_e = self._route(xt, k)                         # [G,N,k]
        cap = max(int(cfg.capacity_factor * ng / e) // 8 * 8, 8)
        out = torch.zeros(g, ng, d, dtype=cd, device=x.device)
        for slot_k in range(k):
            slot = _dispatch_indices(top_e[..., slot_k], e, cap)          # [G,N]
            index = slot[..., None].expand(g, ng, d)
            buf = torch.zeros(g, e * cap + 1, d, dtype=cd, device=x.device)
            buf.scatter_(1, index, xt.to(cd))   # dropped tokens all land in the last row
            ein = buf[:, :e * cap].reshape(g, e, cap, d)
            hg = torch.einsum("gecd,edf->gecf", ein, self.wg.to(cd))
            hu = torch.einsum("gecd,edf->gecf", ein, self.wu.to(cd))
            eout = torch.einsum("gecf,efd->gecd", F.silu(hg) * hu, self.wd.to(cd))
            flat = torch.cat([eout.reshape(g, e * cap, d),
                              torch.zeros(g, 1, d, dtype=cd, device=x.device)], dim=1)
            out = out + torch.gather(flat, 1, index) * top_w[..., slot_k, None].to(cd)
        y = out.reshape(b, s, d)
        if self.shared is not None:
            # the shared expert runs densely on all tokens; its MLP without residual
            y = y + (self.shared(x) - x)
        return x + y, _load_balance_loss(gates, top_e, e)

    def _gather_few_tokens(self, x: torch.Tensor, h: torch.Tensor):
        """Decode-path MoE: gather only the routed experts' weights (at a
        few tokens cheaper than running every expert's capacity buffer)."""
        b, s, d = x.shape
        k, cd = self.cfg.top_k, self.cfg.cdtype
        hf = h.reshape(b * s, d)
        _, top_w, top_e = self._route(hf, k)                              # [N,k]
        hg = torch.einsum("nd,nkdf->nkf", hf, self.wg[top_e].to(cd))
        hu = torch.einsum("nd,nkdf->nkf", hf, self.wu[top_e].to(cd))
        eo = torch.einsum("nkf,nkfd->nkd", F.silu(hg) * hu, self.wd[top_e].to(cd))
        y = torch.einsum("nk,nkd->nd", top_w.to(cd), eo).reshape(b, s, d)
        if self.shared is not None:
            y = y + (self.shared(x) - x)
        return x + y, torch.zeros((), dtype=torch.float32, device=x.device)
