"""K4: RMSNorm over the last dimension in one kernel.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm``: ``x * rsqrt(mean(x^2) +
eps) * w`` in float32, cast to the dtype of x. The kernel is
``csrc/rmsnorm.cu``: each row is read once, in 16-byte accesses, into the
registers of a warp (narrow rows) or a block (wide rows), and written once;
:func:`rmsnorm_plan` picks the instance a call runs. ``rmsnorm_plain``
beside it is the same function in plain PyTorch (``ref_rmsnorm``'s
arithmetic), which the wrapper runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import DTYPE_CODES, cdiv, check_tensors, stream_handle

VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes
WARP_ROW_ACCESSES = 4  # a row of at most 32 * 4 accesses takes a warp
NV_CHOICES = (2, 4, 8)  # accesses a thread holds in the block-per-row form
ROW_IN_REGISTERS = 8192  # elements of a row a block holds (csrc max_threads)
# the design each dtype runs on the card, by width and alignment
DESIGNS = {
    dtype: (f"16-byte vectors ({n} a lane), row in registers: a warp per row up to "
            f"D {32 * WARP_ROW_ACCESSES * n}, a block per row above; the same kernel "
            f"with scalar accesses when D % {n} or a base is off 16 bytes")
    for dtype, n in VEC.items()}


class Instance(NamedTuple):
    """The kernel instance for one call: elements an access (``vec``),
    accesses a thread holds (``nv``), threads a block, a warp or a block per
    row, and whether part of the row is read twice (longer than the
    registers of the largest block)."""
    vec: int
    nv: int
    threads: int
    warp_per_row: bool
    reread: bool

    @property
    def design(self) -> str:
        access = "16-byte vectors" if self.vec > 1 else "scalar"
        group = "warp" if self.warp_per_row else "block"
        tail = ", tail read twice" if self.reread else ""
        return f"{access}, {group} per row, nv {self.nv}, {self.threads} threads{tail}"


def rmsnorm_plan(d: int, dtype: torch.dtype, aligned: bool) -> Instance:
    """The instance of ``csrc/rmsnorm.cu`` a row of width ``d`` runs:
    16-byte accesses when ``d`` is a multiple of :data:`VEC` and every base
    is 16-byte aligned, else scalar ones; a warp per row (4 rows a block)
    for rows of at most 128 accesses, else a block per row with the fewest
    accesses a thread (2, 4 or 8) that fit one block (``max_threads`` in
    the source: the threads that hold 8192 elements, at most 1024)."""
    vec = VEC[dtype] if aligned and d % VEC[dtype] == 0 else 1
    nvec = d // vec
    if nvec <= 32 * WARP_ROW_ACCESSES:
        nv = 1
        while 32 * nv < nvec:
            nv *= 2
        return Instance(vec, nv, 128, True, False)
    for nv in NV_CHOICES:
        cap = min(1024, ROW_IN_REGISTERS // (nv * vec))
        threads = 32 * cdiv(cdiv(nvec, nv), 32)
        if threads <= cap:
            return Instance(vec, nv, threads, False, False)
    return Instance(vec, nv, cap, False, True)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in plain PyTorch: float32 throughout, w multiplied before the
    cast to the dtype of x."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * w.float()).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rmsnorm")
    lib.rmsnorm_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; w: [D]; both float32 or both bfloat16, contiguous.

    On CUDA tensors this launches the kernel (counted in
    ``rmsnorm.launches``; the instance is :func:`rmsnorm_plan`'s); on CPU
    tensors it runs :func:`rmsnorm_plain`.
    """
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: need x [..., D] and w [D], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    device = check_tensors("rmsnorm", x.dtype, None, x=x, w=w)
    if device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps)
    out = torch.empty_like(x)
    d = x.shape[-1]
    if out.numel() == 0:
        return out
    plan = rmsnorm_plan(d, x.dtype, all(t.data_ptr() % 16 == 0 for t in (x, w, out)))
    lib = _lib()
    err = lib.rmsnorm_launch(DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                             out.data_ptr(), x.numel() // d, d, eps, plan.vec, plan.nv,
                             plan.threads, int(plan.warp_per_row), stream_handle(device))
    _build.check_launch(lib, "rmsnorm", err)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
