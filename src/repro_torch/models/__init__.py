"""The model side of the port: configs, blocks and the decoder-only LM."""
from repro_torch.models import blocks, common, ssm, transformer
from repro_torch.models.config import Layer, ModelConfig, Runtime

__all__ = ["blocks", "common", "ssm", "transformer", "Layer", "ModelConfig", "Runtime"]
