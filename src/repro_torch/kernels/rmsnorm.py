"""K4: RMSNorm over the last dimension in one kernel.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm``: ``x * rsqrt(mean(x^2) +
eps) * w`` in float32, cast to the dtype of x. The kernel is
``csrc/rmsnorm.cu`` (one thread block per row); ``rmsnorm_plain`` beside it
is the same function in plain PyTorch (``ref_rmsnorm``'s arithmetic), which
the wrapper runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import DTYPE_CODES, check_tensors, stream_handle

# the design each dtype runs on the card: one for both
DESIGNS = {torch.bfloat16: "block per row", torch.float32: "block per row"}


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
                                   ctypes.c_float, ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; w: [D]; both float32 or both bfloat16, contiguous.

    On CUDA tensors this launches the kernel (counted in
    ``rmsnorm.launches``); on CPU tensors it runs :func:`rmsnorm_plain`.
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
    lib = _lib()
    err = lib.rmsnorm_launch(DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                             out.data_ptr(), x.numel() // d, d, eps,
                             stream_handle(device))
    _build.check_launch(lib, "rmsnorm", err)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
