from repro_torch.data.synthetic import DataConfig, SyntheticLoader, batch_for_step

__all__ = ["DataConfig", "SyntheticLoader", "batch_for_step"]
