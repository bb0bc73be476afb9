"""Jamba-v0.1 52B: 32L d4096 32H(kv8) ff14336 v65536, Mamba+attention 1:7
interleave, MoE 16e top-2 every other layer [arXiv:2403.19887; hf].
Sub-quadratic -> runs long_500k (SSM state O(1); the 4 attention layers use
a sequence-sharded KV cache with flash-decode LSE combine)."""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.config import ModelConfig

_PERIOD = (("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"),
           ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
           ("mamba", "dense"), ("mamba", "moe"))


@register("jamba-v0.1-52b")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=65536, period=_PERIOD, n_experts=16, top_k=2,
        capacity_factor=1.25, ssm_state=16, ssm_conv=4, ssm_expand=2,
        tie_embeddings=False, param_dtype="bfloat16",
        attn_parallelism="heads", fsdp=True)
    smoke = ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=512, period=_PERIOD, n_experts=4, top_k=2, ssm_state=8,
        tie_embeddings=False)
    return ArchSpec(cfg, smoke, skips={})
