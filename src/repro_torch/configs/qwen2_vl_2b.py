"""Qwen2-VL 2B backbone: 28L d1536 12H(kv2) ff8960 v151936, M-RoPE
(t/h/w sections 16/24/24), dynamic-resolution ViT frontend STUBBED: cells
feed precomputed patch embeddings + 3D positions [arXiv:2409.12191; hf].
12 heads vs 16-way TP -> context-parallel attention."""
from repro_torch.configs.registry import ArchSpec, FULL_ATTENTION_SKIP, register
from repro_torch.models.config import ModelConfig


@register("qwen2-vl-2b")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
        vocab_size=151936, mrope_sections=(16, 24, 24), rope_theta=1e6,
        tie_embeddings=True, attn_parallelism="context", fsdp=True,
        input_kind="patch_embeddings")
    smoke = ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab_size=512, mrope_sections=(2, 3, 3), tie_embeddings=True,
        input_kind="patch_embeddings")
    return ArchSpec(cfg, smoke, skips=dict([FULL_ATTENTION_SKIP]))
