"""K1: the in-kernel dependent ALU chain (the paper's timed PTX block).

Replaces ``repro/kernels/alu_chain.py::alu_chain``: an n-step dependent
chain of one op over an [R, C] float32 tile, ``x <- op(x, a)``. The kernel
is ``csrc/alu_chain.cu`` (one element per thread, the op a template
parameter); ``alu_chain_plain`` beside it is the same function in plain
PyTorch, which the wrapper runs for tensors on the CPU.

``alu_chain_timed`` runs the same kernel in its timed form, the paper's
clock sandwich: each thread reads the SM's ``%clock64`` right before and
right after its chain and returns the difference in cycles. ``sm_clock_sample``
reads the SM clock against the card's nanosecond timer, from which
``core.timing.sm_clock_hz`` converts cycles to time. Both exist on a CUDA
card only: a cycle counter has no plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensors, stream_handle

OPS = ("fma", "add", "mul", "rsqrt", "exp")  # index == the kernel's op id
# the design each dtype runs on the card (a label for chip_smoke.py)
DESIGNS = {torch.float32: "thread per element, op a template, straight-line at n 8 and 64; "
                          "timed form: clock64 sandwich"}


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
    lib.alu_chain_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.alu_chain_launch.restype = ctypes.c_int
    lib.sm_clock_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.sm_clock_launch.restype = ctypes.c_int
    return lib


def _check_chain(name: str, x: torch.Tensor, a: torch.Tensor, n: int,
                 op: str) -> torch.device:
    if op not in OPS:
        raise ValueError(f"{name}: op must be one of {OPS}, got {op!r}")
    if n < 0:
        raise ValueError(f"{name}: n must be >= 0, got {n}")
    return check_tensors(name, torch.float32, tuple(x.shape), x=x, a=a)


def alu_chain(x: torch.Tensor, a: torch.Tensor, *, n: int,
              op: str = "fma") -> torch.Tensor:
    """``op`` applied ``n`` times to the float32 tile ``x`` with operand ``a``.

    ``x`` and ``a`` are contiguous float32 tensors of one shape (the probe
    uses (8, 128)). On CUDA tensors this launches the kernel (and counts the
    launch in ``alu_chain.launches``); on CPU tensors it runs
    :func:`alu_chain_plain`.
    """
    device = _check_chain("alu_chain", x, a, n, op)
    if device.type == "cpu":
        return alu_chain_plain(x, a, n=n, op=op)
    return _launch("alu_chain", x, a, None, n, op, device)


def _launch(name: str, x: torch.Tensor, a: torch.Tensor, cycles: torch.Tensor | None,
            n: int, op: str, device: torch.device) -> torch.Tensor:
    """One launch of the kernel, timed when ``cycles`` is given."""
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.alu_chain_launch(x.data_ptr(), a.data_ptr(), out.data_ptr(),
                               None if cycles is None else cycles.data_ptr(),
                               x.numel(), n, OPS.index(op), stream_handle(device))
    _build.check_launch(lib, name, err)
    alu_chain.launches += 1
    return out


alu_chain.launches = 0


def alu_chain_timed(x: torch.Tensor, a: torch.Tensor, *, n: int,
                    op: str = "fma") -> tuple[torch.Tensor, torch.Tensor]:
    """The timed form of :func:`alu_chain`: ``(out, cycles)``, ``out`` as
    ``alu_chain`` gives it and ``cycles`` (int64, x's shape) the SM cycles
    between each thread's two ``%clock64`` reads around its chain.

    CUDA tensors only (counted in ``alu_chain.launches``); raises for CPU
    tensors, since there is no plain version of a cycle counter.
    """
    device = _check_chain("alu_chain_timed", x, a, n, op)
    if device.type != "cuda":
        raise RuntimeError("alu_chain_timed: the SM cycle counter exists only on a "
                           f"CUDA card; got tensors on {device}")
    cycles = torch.empty(x.shape, dtype=torch.int64, device=device)
    return _launch("alu_chain_timed", x, a, cycles, n, op, device), cycles


def sm_clock_sample(device: torch.device) -> tuple[int, int]:
    """(SM cycles, ns of the card's global timer) over one spin of about
    1 ms on one thread of ``device``, a CUDA device."""
    if device.type != "cuda":
        raise RuntimeError(f"sm_clock_sample: the SM clock exists only on a CUDA card, "
                           f"not on {device}")
    out = torch.zeros(2, dtype=torch.int64, device=device)
    lib = _lib()
    err = lib.sm_clock_launch(out.data_ptr(), 1_000_000, stream_handle(device))
    _build.check_launch(lib, "sm_clock", err)
    cycles, ns = out.tolist()
    return cycles, ns
