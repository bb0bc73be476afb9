"""K3: the dependent pointer chase (the memory-hierarchy probe) in one kernel.

Replaces ``repro/kernels/chase.py::chase``: ``p = ring[p]`` for ``steps``
steps over an int32 single-cycle ring, returning the last index as a [1]
int32 tensor. The kernel is ``csrc/chase.cu``: one thread, the same
``ld.global`` at every working-set size, so the size alone decides which
level of the card's hierarchy the loads hit. ``chase_plain`` beside it is
the same function in plain PyTorch, which the wrapper runs for tensors on
the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensors, stream_handle

# the design each dtype runs on the card
DESIGNS = {torch.int32: "one-thread pointer chase"}


def chase_plain(ring: torch.Tensor, start: torch.Tensor, *,
                steps: int) -> torch.Tensor:
    """Follow ``ring[p]`` ``steps`` times from ``start[0]``, on the host."""
    r = ring.tolist()
    p = int(start[0])
    for _ in range(steps):
        p = r[p]
    return torch.tensor([p], dtype=torch.int32, device=ring.device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("chase")
    lib.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_void_p]
    lib.chase_launch.restype = ctypes.c_int
    return lib


def chase(ring: torch.Tensor, start: torch.Tensor, *, steps: int) -> torch.Tensor:
    """ring: [N] int32 ring of indices into itself; start: [1] int32.

    On CUDA tensors this launches the kernel (counted in
    ``chase.launches``); on CPU tensors it runs :func:`chase_plain`. The
    ring's values are not checked: it must index itself, as
    ``core.membench.build_ring`` makes it.
    """
    if steps < 0:
        raise ValueError(f"chase: steps must be >= 0, got {steps}")
    if ring.dim() != 1 or ring.numel() == 0:
        raise ValueError(f"chase: ring must be a non-empty 1-D tensor, got shape "
                         f"{tuple(ring.shape)}")
    check_tensors("chase", torch.int32, None, ring=ring)
    device = check_tensors("chase", torch.int32, (1,), start=start)
    if device != ring.device:
        raise ValueError(f"chase: ring on {ring.device}, start on {device}")
    if device.type == "cpu":
        return chase_plain(ring, start, steps=steps)
    out = torch.empty(1, dtype=torch.int32, device=device)
    lib = _lib()
    err = lib.chase_launch(ring.data_ptr(), start.data_ptr(), out.data_ptr(),
                           steps, stream_handle(device))
    _build.check_launch(lib, "chase", err)
    chase.launches += 1
    return out


chase.launches = 0
