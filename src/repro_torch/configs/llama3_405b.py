"""Llama-3.1 405B: 126L d16384 128H(kv8) ff53248 v128256 [arXiv:2407.21783].
Head-parallel TP (128/16=8); FSDP over pod+data; bf16 params + int8 AdamW
moments to fit 16 GiB/chip (see optim/adamw.py)."""
from repro_torch.configs.registry import ArchSpec, FULL_ATTENTION_SKIP, register
from repro_torch.models.config import ModelConfig


@register("llama3-405b")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
        vocab_size=128256, rope_theta=5e5, tie_embeddings=False,
        param_dtype="bfloat16", attn_parallelism="heads", fsdp=True)
    smoke = ModelConfig(
        name="llama3-405b-smoke", family="dense",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, d_ff=416,
        vocab_size=512, tie_embeddings=False)
    return ArchSpec(cfg, smoke, skips=dict([FULL_ATTENTION_SKIP]))
