from repro_torch.serving.engine import Engine, GenerateResult, SlotPool

__all__ = ["Engine", "GenerateResult", "SlotPool"]
