"""xLSTM-350M: 24L d1024 4H(kv4) no-FFN v50304, sLSTM+mLSTM [7:1]
[arXiv:2405.04517; unverified]. Recurrent state O(1) -> runs long_500k."""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.config import ModelConfig

_PERIOD = tuple([("mlstm", "none")] * 7 + [("slstm", "none")])


@register("xlstm-350m")
def spec() -> ArchSpec:
    cfg = ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50304, period=_PERIOD, ssm_expand=2,
        tie_embeddings=True, attn_parallelism="context")
    smoke = ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=512, period=_PERIOD, ssm_expand=2, tie_embeddings=True)
    return ArchSpec(cfg, smoke, skips={})
