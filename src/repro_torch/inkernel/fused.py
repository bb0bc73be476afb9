"""Unit-workload builders for the fused-kernel probe rows.

Each fused kernel of the port (K4-K7 in ``repro_torch.kernels``) gets the
JAX package's parameterized *unit workload* (``repro/inkernel/fused.py``):
``build_fused(name, n, device)`` returns a callable plus its arguments,
sized so the kernel executes ``n`` workload units (KV blocks for attention,
sequence chunks for the SSM scan, row blocks for rmsnorm). Two sizes
measured with :meth:`Timer.slope` net the launch overhead as the chain
probes net theirs; the per-unit latency is the slope. The arguments are
those of the JAX package bit for bit, so both packages time the same work.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.rmsnorm import rmsnorm

FUSED_KERNELS = ("flash_attention", "flash_decode", "mamba_scan", "rmsnorm")

# two workload sizes for the slope (the JAX package's: it sized them for
# interpret mode on the CPU, so they are small)
FUSED_LENS = (2, 6)

_BLK = 16     # q/k block for the attention kernels
_HEADS = 2    # grouped heads per KV head
_CHUNK = 8    # mamba chunk (= sequence units)
_DM = 8       # mamba model dim
_DN = 4       # mamba state dim
_ROWS = 8     # rmsnorm block rows
_COLS = 64    # rmsnorm feature dim


# the keywords each unit workload passes its wrapper, fixed here alone
_KWARGS = {
    # causal=False: every KV block is visited, so work is exactly linear in
    # n (causal skips masked blocks and breaks the slope)
    "flash_attention": {"causal": False},
    "mamba_scan": {"chunk": _CHUNK},
}
_WRAPPERS = {"flash_attention": flash_attention, "flash_decode": flash_decode,
             "mamba_scan": mamba_scan, "rmsnorm": rmsnorm}


def fused_kwargs(name: str) -> dict:
    """The keywords with which ``build_fused(name, ...)``'s callable calls
    the kernel's wrapper; its plain version takes the same."""
    if name not in _WRAPPERS:
        raise ValueError(f"unknown fused kernel {name!r}; "
                         f"known: {', '.join(FUSED_KERNELS)}")
    return dict(_KWARGS.get(name, {}))


def _ramp(shape: tuple[int, ...], lo: float = 0.05, hi: float = 0.95) -> torch.Tensor:
    """Deterministic well-conditioned float32 values in [lo, hi], equal bit
    for bit to the JAX package's ``_ramp`` (same operations, same order)."""
    n = 1
    for d in shape:
        n *= d
    flat = lo + (hi - lo) * (torch.arange(n, dtype=torch.float32) % 17) / 16.0
    return flat.reshape(shape)


def build_fused(name: str, n: int, device: str | torch.device | None = None
                ) -> tuple[Callable, tuple]:
    """(fn, args) running fused kernel ``name`` over ``n`` workload units,
    with the arguments on ``device`` (default ``cuda:0``, see
    ``resolve_device``; made on the CPU, then copied)."""
    kw = fused_kwargs(name)   # raises for an unknown name
    fn = partial(_WRAPPERS[name], **kw)
    device = resolve_device(device)
    if name == "flash_attention":
        args = (_ramp((1, _BLK, _HEADS, _BLK)), _ramp((1, _BLK * n, 1, _BLK)),
                _ramp((1, _BLK * n, 1, _BLK)))
    elif name == "flash_decode":
        args = (_ramp((1, _HEADS, _BLK)), _ramp((1, _BLK * n, 1, _BLK)),
                _ramp((1, _BLK * n, 1, _BLK)),
                torch.full((1,), _BLK * n, dtype=torch.int32))
    elif name == "mamba_scan":
        s = _CHUNK * n
        args = (_ramp((1, s, _DM)), _ramp((1, s, _DM)),
                -_ramp((_DM, _DN), lo=0.1, hi=1.0),   # stable decay: A < 0
                _ramp((1, s, _DN)), _ramp((1, s, _DN)), _ramp((_DM,)))
    else:  # rmsnorm
        args = (_ramp((_ROWS * n, _COLS)), _ramp((_COLS,), lo=0.5, hi=1.5))
    return fn, tuple(a.to(device) for a in args)
