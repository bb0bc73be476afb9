"""SeamlessM4T-large v2 text backbone: 24L enc + 24L dec, d1024 16H(kv16)
ff8192 v256206, enc-dec [arXiv:2308.11596; hf]. Speech frontend STUBBED:
cells feed precomputed frame embeddings (enc len = seq/4). Decoder has a KV
cache -> decode shapes run."""
from repro_torch.configs.registry import ArchSpec, FULL_ATTENTION_SKIP, register
from repro_torch.models.config import ModelConfig


@register("seamless-m4t-large-v2")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
        vocab_size=256206, n_encoder_layers=24, tie_embeddings=True,
        attn_parallelism="heads", fsdp=True, input_kind="frame_embeddings")
    smoke = ModelConfig(
        name="seamless-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, n_encoder_layers=2, tie_embeddings=True,
        input_kind="frame_embeddings")
    return ArchSpec(cfg, smoke, skips=dict([FULL_ATTENTION_SKIP]))
