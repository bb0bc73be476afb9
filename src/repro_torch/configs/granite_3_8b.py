"""Granite-3 8B: 40L d4096 32H(kv8) ff12800 v49155, dense GQA
[hf:ibm-granite/granite-3.0-8b-base]. Note v49155 is not divisible by the
16-way model axis -> vocab replicates (sharding rules fall back); embedding
memory is FSDP-sharded over data instead."""
from repro_torch.configs.registry import ArchSpec, FULL_ATTENTION_SKIP, register
from repro_torch.models.config import ModelConfig


@register("granite-3-8b")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
        vocab_size=49155, rope_theta=1e4, tie_embeddings=True,
        attn_parallelism="heads", fsdp=True)
    smoke = ModelConfig(
        name="granite-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=515, tie_embeddings=True)
    return ArchSpec(cfg, smoke, skips=dict([FULL_ATTENTION_SKIP]))
