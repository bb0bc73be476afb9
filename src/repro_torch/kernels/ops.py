"""Public kernel surface: every kernel of the port, imported from one place.

Each wrapper launches its CUDA kernel for tensors on the card and runs its
plain PyTorch version (``*_plain``, in the same module) for tensors on the
CPU; ``<wrapper>.launches`` counts the kernel's launches.
"""
from __future__ import annotations

from collections.abc import Mapping

from repro_torch.kernels.alu_chain import alu_chain
from repro_torch.kernels.chase import chase, chase_timed
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.opchain import op_chain, op_chain_timed
from repro_torch.kernels.rmsnorm import rmsnorm

KERNELS = (alu_chain, op_chain, chase, rmsnorm, flash_attention, flash_decode,
           mamba_scan)

# every launch count: the seven kernels', and K2's and K3's timed forms' own
# beside K2's and K3's, which count both of their forms
COUNTED = KERNELS + (op_chain_timed, chase_timed)


def launch_counts() -> dict[str, int]:
    """Each wrapper's launch count in :data:`COUNTED`, by name, and K3's by
    form and path (``chase/timed/smem``, ...)."""
    out = {k.__name__: k.launches for k in COUNTED}
    out.update({f"chase/{path}": n for path, n in sorted(chase.launches_by_path.items()) if n})
    return out


def add_launches(delta: Mapping[str, int]) -> None:
    """Add ``delta`` (keyed as :func:`launch_counts` keys) to the counts: the
    launches of a CUDA graph's replay, which runs no wrapper, or, negated,
    launches that prepared a graph and were no path's."""
    for k in COUNTED:
        k.launches += delta.get(k.__name__, 0)
    for key, n in delta.items():
        if key.startswith("chase/"):
            chase.launches_by_path[key.removeprefix("chase/")] += n


def launches_since(before: Mapping[str, int]) -> dict[str, int]:
    """What each count went up by since :func:`launch_counts` gave ``before``
    (counts that did not move left out)."""
    now = launch_counts()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


__all__ = ["COUNTED", "KERNELS", "add_launches", "alu_chain", "chase", "flash_attention",
           "flash_decode", "launch_counts", "launches_since", "mamba_scan", "op_chain",
           "rmsnorm"]
