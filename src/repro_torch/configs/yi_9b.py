"""Yi-9B: 48L d4096 32H(kv4) ff11008 v64000, llama-arch GQA
[arXiv:2403.04652; hf]. Head-parallel TP (32/16=2, kv duplicated 4x)."""
from repro_torch.configs.registry import ArchSpec, FULL_ATTENTION_SKIP, register
from repro_torch.models.config import ModelConfig


@register("yi-9b")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
        vocab_size=64000, rope_theta=1e4, tie_embeddings=False,
        attn_parallelism="heads", fsdp=True)
    smoke = ModelConfig(
        name="yi-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=172,
        vocab_size=500, tie_embeddings=False)
    return ArchSpec(cfg, smoke, skips=dict([FULL_ATTENTION_SKIP]))
