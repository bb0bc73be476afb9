"""Llama-4 Maverick 400B-A17B: 48L d5120 40H(kv8) ff8192 v202048, MoE 128e
top-1 interleaved every other layer + shared expert, early-fusion backbone
[hf:meta-llama/Llama-4 family; unverified]. 40 q-heads do not divide the
16-way model axis -> context-parallel attention (DESIGN.md section 5)."""
from repro_torch.configs.registry import ArchSpec, FULL_ATTENTION_SKIP, register
from repro_torch.models.config import ModelConfig


@register("llama4-maverick-400b-a17b")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab_size=202048, period=(("attn", "moe"), ("attn", "dense")),
        n_experts=128, top_k=1, shared_expert=True, capacity_factor=1.25,
        rope_theta=5e5, tie_embeddings=False, param_dtype="bfloat16",
        attn_parallelism="context", fsdp=True)
    smoke = ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        n_layers=4, d_model=64, n_heads=10, n_kv_heads=2, d_ff=96,
        vocab_size=512, period=(("attn", "moe"), ("attn", "dense")),
        n_experts=8, top_k=1, shared_expert=True, tie_embeddings=False,
        attn_parallelism="context")
    return ArchSpec(cfg, smoke, skips=dict([FULL_ATTENTION_SKIP]))
