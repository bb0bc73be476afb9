from repro_torch.configs import registry
from repro_torch.configs.registry import ARCH_IDS, SHAPES, ArchSpec, all_arch_ids, get

__all__ = ["registry", "ARCH_IDS", "SHAPES", "ArchSpec", "all_arch_ids", "get"]
