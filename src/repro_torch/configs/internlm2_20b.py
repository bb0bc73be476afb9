"""InternLM2-20B: 48L d6144 48H(kv8) ff16384 v92544, dense GQA
[arXiv:2403.17297; hf]. Head-parallel TP (48/16=3, kv duplicated 2x)."""
from repro_torch.configs.registry import ArchSpec, FULL_ATTENTION_SKIP, register
from repro_torch.models.config import ModelConfig


@register("internlm2-20b")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
        vocab_size=92544, rope_theta=1e6, tie_embeddings=False,
        attn_parallelism="heads", fsdp=True)
    smoke = ModelConfig(
        name="internlm2-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab_size=512, tie_embeddings=False)
    return ArchSpec(cfg, smoke, skips=dict([FULL_ATTENTION_SKIP]))
