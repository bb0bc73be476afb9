"""Architecture registry: --arch <id> resolves here (the port of
``repro/configs/registry.py``; each architecture file is its JAX twin's,
field for field).

Every assigned architecture registers its exact ``ModelConfig``, a reduced
``smoke`` config of the same family, and its applicable input-shape cells
(the mandated 4: train_4k / prefill_32k / decode_32k / long_500k; long_500k
only for sub-quadratic archs, per the assignment rule — skips are recorded).
``paper_suite.py`` is not ported yet: it needs the performance model.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "llama4-maverick-400b-a17b",
    "llama4-scout-17b-a16e",
    "internlm2-20b",
    "granite-3-8b",
    "llama3-405b",
    "yi-9b",
    "jamba-v0.1-52b",
    "xlstm-350m",
    "qwen2-vl-2b",
    "seamless-m4t-large-v2",
)

# shape id -> (seq_len, global_batch, step kind)
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke: ModelConfig
    skips: dict[str, str]        # shape id -> reason

    def applicable_shapes(self) -> list[str]:
        return [s for s in SHAPES if s not in self.skips]


_REGISTRY: dict[str, Callable[[], ArchSpec]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ArchSpec]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        mod = arch_id.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[arch_id]()


def all_arch_ids() -> tuple[str, ...]:
    return ARCH_IDS


FULL_ATTENTION_SKIP = ("long_500k",
                       "full quadratic attention at 524k seq: skipped per "
                       "assignment rule (sub-quadratic archs only)")
