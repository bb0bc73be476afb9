"""K1: the in-kernel dependent ALU chain (the paper's timed PTX block).

Replaces ``repro/kernels/alu_chain.py::alu_chain``: an n-step dependent
chain of one op over an [R, C] float32 tile, ``x <- op(x, a)``. The kernel
is ``csrc/alu_chain.cu`` (one element per thread, the op a template
parameter); ``alu_chain_plain`` beside it is the same function in plain
PyTorch, which the wrapper runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensors, stream_handle

OPS = ("fma", "add", "mul", "rsqrt", "exp")  # index == the kernel's op id


def _step(x: torch.Tensor, a: torch.Tensor, op: str) -> torch.Tensor:
    if op == "fma":
        return x * a + a
    if op == "add":
        return x + a
    if op == "mul":
        return x * a
    if op == "rsqrt":
        return torch.rsqrt(x) + a
    return torch.exp(-x) + a


def alu_chain_plain(x: torch.Tensor, a: torch.Tensor, *, n: int,
                    op: str = "fma") -> torch.Tensor:
    """The chain in plain PyTorch, on any device: ``x <- op(x, a)``, n times."""
    if op not in OPS:
        raise ValueError(f"alu_chain: op must be one of {OPS}, got {op!r}")
    for _ in range(n):
        x = _step(x, a, op)
    return x


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("alu_chain")
    lib.alu_chain_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.alu_chain_launch.restype = ctypes.c_int
    return lib


def alu_chain(x: torch.Tensor, a: torch.Tensor, *, n: int,
              op: str = "fma") -> torch.Tensor:
    """``op`` applied ``n`` times to the float32 tile ``x`` with operand ``a``.

    ``x`` and ``a`` are contiguous float32 tensors of one shape (the probe
    uses (8, 128)). On CUDA tensors this launches the kernel (and counts the
    launch in ``alu_chain.launches``); on CPU tensors it runs
    :func:`alu_chain_plain`.
    """
    if op not in OPS:
        raise ValueError(f"alu_chain: op must be one of {OPS}, got {op!r}")
    if n < 0:
        raise ValueError(f"alu_chain: n must be >= 0, got {n}")
    device = check_tensors("alu_chain", torch.float32, tuple(x.shape), x=x, a=a)
    if device.type == "cpu":
        return alu_chain_plain(x, a, n=n, op=op)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.alu_chain_launch(x.data_ptr(), a.data_ptr(), out.data_ptr(),
                               x.numel(), n, OPS.index(op), stream_handle(device))
    _build.check_launch(lib, "alu_chain", err)
    alu_chain.launches += 1
    return out


alu_chain.launches = 0
