"""Model & runtime configuration (the port of ``repro/models/config.py``).

``ModelConfig`` is the *paper config* of an architecture (exact dims from the
assignment); ``Runtime`` holds execution knobs (attention impl, chunk sizes,
MoE dispatch groups) that never change the math. Field names and defaults
are the JAX package's, so one registry entry reads the same in both.

Layer heterogeneity is expressed as a repeating **period**: a tuple of
``(mixer, ffn)`` pairs cycled over the depth. Examples: dense LM =
``(("attn","dense"),)``; Jamba = 1 attention + 7 mamba per 8 with MoE every
other layer; xLSTM[7:1] = 7 mLSTM + 1 sLSTM.
"""
from __future__ import annotations

import dataclasses

import torch

Layer = tuple[str, str]          # (mixer, ffn)

MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    period: tuple[Layer, ...] = (("attn", "dense"),)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False
    # --- SSM (mamba) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model/16)
    # --- positions ---
    rope_theta: float = 1e4
    mrope_sections: tuple[int, int, int] | None = None
    # --- enc-dec (audio/seq2seq backbones) ---
    n_encoder_layers: int = 0    # >0 -> encoder-decoder w/ cross attention
    # --- numerics ---
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- distribution policy (kept for parity; one card shards nothing) ---
    attn_parallelism: str = "heads"   # "heads" | "context"
    fsdp: bool = False
    # --- modality frontend stub ---
    input_kind: str = "tokens"        # tokens | patch_embeddings | frame_embeddings

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} % n_kv_heads "
                             f"{self.n_kv_heads}")
        if self.n_layers % len(self.period):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} % period "
                             f"{len(self.period)}")
        for mixer, ffn in self.period:
            if mixer not in MIXERS or ffn not in FFNS:
                raise ValueError(f"{self.name}: unknown layer {(mixer, ffn)}")

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def dt_r(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def layer_list(self) -> list[Layer]:
        return list(self.period) * self.n_periods

    # ------------------------------------------------------- param counting
    def param_count(self) -> tuple[int, int]:
        """(total params, active params per token), the JAX package's formula;
        equal to the port model's parameter count for every family but
        xLSTM, whose mLSTM's group-norm weight (``gn``, Di values a layer)
        the formula leaves out, as the JAX package's does."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        di, n, dtr = self.ssm_inner, self.ssm_state, self.dt_r
        dh = d // max(self.n_heads, 1)
        total = active = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
            active += self.vocab_size * d
        total += d  # final norm
        active += d
        attn = d + d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        dense_ffn = d + 3 * d * f
        expert_ffn = 3 * d * f
        mamba = (d + d * 2 * di + di * self.ssm_conv + di
                 + di * (dtr + 2 * n) + dtr * di + di
                 + di * n + di + di * d)
        mlstm = (d + d * 2 * di + 5 * di + 3 * di * di
                 + 2 * di * self.n_heads + di * d)
        slstm = d + 4 * d * d + 4 * d * dh + 4 * d + d + d * d
        for mixer, ffn in self.layer_list():
            m = {"attn": attn, "mamba": mamba, "mlstm": mlstm, "slstm": slstm}[mixer]
            total += m
            active += m
            if ffn == "dense":
                total += dense_ffn
                active += dense_ffn
            elif ffn == "moe":
                total += d + d * self.n_experts + self.n_experts * expert_ffn
                active += d + d * self.n_experts + self.top_k * expert_ffn
                if self.shared_expert:
                    total += dense_ffn
                    active += dense_ffn
        if self.n_encoder_layers:
            enc = attn + dense_ffn
            cross = attn
            total += self.n_encoder_layers * enc + self.n_layers * cross + d
            active += self.n_encoder_layers * enc + self.n_layers * cross + d
        return int(total), int(active)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs (never change the math).

    ``attn_impl="pallas"`` and ``use_pallas`` keep the JAX package's names and
    select the port's hand-written CUDA kernels: prefill attention through
    K5 (``kernels.ops.flash_attention``) and the Mamba prefill scan through
    K7 (``kernels.ops.mamba_scan``). On CPU tensors those wrappers run their
    plain PyTorch versions. ``remat`` and ``scan_layers`` change nothing in
    the port: it runs eagerly, one period module after another, and keeps
    no activations for a backward pass. ``cache_shard``,
    ``moe_combine_reshard``, ``infer_sharding`` and ``fsdp_gather_weights``
    are sharding knobs of the JAX package and change nothing on one card.
    """

    attn_impl: str = "auto"          # auto | plain | blockwise | pallas
    block_k: int = 1024
    remat: bool = True
    moe_groups: int = 1
    mamba_chunk: int = 64
    mlstm_chunk: int = 64
    xent_chunk: int = 512
    scan_layers: bool = True
    use_pallas: bool = False
    max_cache_len: int = 0
    attn_p_dtype: str = "float32"    # softmax-prob dtype for the PV matmul
    cache_shard: str = "seq"
    moe_combine_reshard: bool = False
    moe_gather_decode: bool = False  # few-token MoE: gather top-k expert
                                     # weights instead of dense-all-experts
    infer_sharding: bool = False
    fsdp_gather_weights: bool = False
