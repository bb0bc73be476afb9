"""Which registry rows run as in-kernel chains, and the chain of each.

The chain half of ``repro/inkernel/factory.py``: one :class:`OpSpec` as an
in-kernel chain through K2 (``kernels/opchain.py``). The carry and operand
scalars become tiles, every element of which runs the same dependent
chain: on the card one element per thread, as the paper's warp executes
one timed instruction.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable, Sequence

import torch

from repro_torch.core.chains import OpSpec, default_registry
from repro_torch.kernels.opchain import op_chain

# The JAX package keeps 64-bit carries, and rows whose step computes through
# a 64-bit value (its ``requires_x64``: mul64hi), on the dispatch path, as the
# TPU has no 64-bit lanes. The card has them, but the port keeps the same
# rule, so that both packages' in-kernel plans hold the same 58 rows; the
# 14 rows left out keep their Table II rows through the table2 plan.
_X64_DTYPES = ("int64", "uint64", "float64")
X64_ROWS = ("mul64hi",)


def supported(spec: OpSpec) -> bool:
    """True if ``spec`` runs as an in-kernel chain."""
    return spec.dtype not in _X64_DTYPES and spec.name not in X64_ROWS


def supported_specs(registry: Sequence[OpSpec] | None = None,
                    ops: Iterable[str] | None = None,
                    categories: Iterable[str] | None = None) -> list[OpSpec]:
    """The in-kernel-eligible rows of the registry, optionally filtered."""
    registry = list(registry if registry is not None else default_registry())
    keep_ops = set(ops) if ops is not None else None
    keep_cats = set(categories) if categories is not None else None
    return [s for s in registry if supported(s)
            and (keep_ops is None or s.name in keep_ops)
            and (keep_cats is None or s.category in keep_cats)]


def default_tile(dtype: str) -> tuple[int, int]:
    """The JAX package's tile for the dtype, kept so that both packages give
    the same outputs: (8, 128), one TPU vreg, and (16, 128) for a 16-bit
    dtype. On the card an element is a thread of a 128-thread block: 8
    blocks (32 warps) for (8, 128), 16 blocks for (16, 128)."""
    return (16, 128) if getattr(torch, dtype).itemsize == 2 else (8, 128)


def tile_layout(shape: tuple[int, int]) -> str:
    """The threads a tile runs on, for the rows' notes."""
    threads = shape[0] * shape[1]
    return f"threads={threads} blocks={-(-threads // 128)}x128"


def tiles(spec: OpSpec, shape: tuple[int, int] | None = None,
          device: str | torch.device = "cpu") -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Carry and operand tiles for ``spec`` on ``device``: its values,
    broadcast."""
    shape = tuple(shape or default_tile(spec.dtype))

    def tile(t: torch.Tensor) -> torch.Tensor:
        return t.expand(shape).contiguous()

    return tile(spec.carry(device)), tuple(map(tile, spec.operand_tensors(device)))


def build_chain(spec: OpSpec, n: int) -> Callable[..., torch.Tensor]:
    """``(carry_tile, *operand_tiles) -> out_tile``: an n-long chain of the
    row's step in one K2 launch (its loop form, the fori_loop's counterpart;
    the plain version for CPU tensors)."""
    if not supported(spec):
        raise ValueError(
            f"spec {spec.name!r} (dtype={spec.dtype}) cannot lower in-kernel; use "
            "the dispatch path (InstructionProbe)")
    return functools.partial(op_chain, step=spec.name, n=n)
