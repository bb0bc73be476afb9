"""Llama-4 Scout 17B-A16E: 48L d5120 40H(kv8) ff8192 v202048, MoE 16e top-1
every layer + shared expert [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
Context-parallel attention (40 heads vs 16-way TP)."""
from repro_torch.configs.registry import ArchSpec, FULL_ATTENTION_SKIP, register
from repro_torch.models.config import ModelConfig


@register("llama4-scout-17b-a16e")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab_size=202048, period=(("attn", "moe"),),
        n_experts=16, top_k=1, shared_expert=True, capacity_factor=1.25,
        rope_theta=5e5, tie_embeddings=False, param_dtype="bfloat16",
        attn_parallelism="context", fsdp=True)
    smoke = ModelConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=10, n_kv_heads=2, d_ff=96,
        vocab_size=512, period=(("attn", "moe"),), n_experts=4, top_k=1,
        shared_expert=True, tie_embeddings=False, attn_parallelism="context")
    return ArchSpec(cfg, smoke, skips=dict([FULL_ATTENTION_SKIP]))
