"""K7: the selective scan of Mamba (S6) in one kernel.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan``: per batch row and
channel, ``dt = softplus(dt)``, ``h = exp(dt * A) * h + (dt * x) * B``,
``y = h . C`` over the sequence with a float32 [Dm, N] state from 0; then
``y + x * D`` in x's dtype, outside the kernel, as the TPU kernel's caller
does. The kernel is ``csrc/mamba_scan.cu`` (a thread per channel, the state
in registers); ``mamba_scan_plain`` beside it is the same function in plain
PyTorch, a loop over the time steps like ``ref_selective_scan``, which the
wrapper runs for tensors on the CPU. Like the TPU kernel it returns y only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensors, pick_block, stream_handle

STATE_DIMS = (4, 8, 16)  # the kernel's instances of N (mamba_scan.cu)
_SMEM_LIMIT = 48 * 1024  # staged B and C per block, without an opt-in
# the design each dtype runs on the card
DESIGNS = {torch.float32: "thread per channel, state in registers"}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s stable form: log1p(exp(-|x|)) + max(x, 0)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)


def mamba_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                     chunk: int = 128) -> torch.Tensor:
    """The scan in plain PyTorch, one time step at a time (a vectorised
    exp(dt * A) over the whole sequence would hold [Bz, S, Dm, N] floats:
    1 GiB at a model's widths). ``chunk`` does not change the result."""
    bsz, s, dm = x.shape
    dtf = softplus(dt.float())
    dx = dtf * x.float()
    af, bf, cf = A.float(), B.float(), C.float()
    h = torch.zeros(bsz, dm, A.shape[1], dtype=torch.float32, device=x.device)
    y = torch.empty(bsz, s, dm, dtype=torch.float32, device=x.device)
    for t in range(s):
        h = torch.exp(dtf[:, t, :, None] * af) * h + dx[:, t, :, None] * bf[:, t, None, :]
        y[:, t] = (h * cf[:, t, None, :]).sum(dim=-1)
    return y.to(x.dtype) + x * D.to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("mamba_scan")
    lib.mamba_scan_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.mamba_scan_launch.restype = ctypes.c_int
    return lib


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, D: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """x, dt: [Bz,S,Dm]; A: [Dm,N]; B, C: [Bz,S,N]; D: [Dm]; all float32 and
    contiguous, on one device. Returns y: [Bz,S,Dm].

    ``chunk`` is the number of time steps whose B and C the kernel stages at
    a time (the largest divisor of S up to ``chunk``, as the TPU kernel cuts
    its chunks); it does not change the result. On CUDA tensors this
    launches the kernel (counted in ``mamba_scan.launches``; N must be one
    of :data:`STATE_DIMS`); on CPU tensors it runs :func:`mamba_scan_plain`.
    """
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2:
        raise ValueError(f"mamba_scan: need x, dt [Bz,S,Dm] and A [Dm,N], got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}")
    bsz, s, dm = x.shape
    n = A.shape[1]
    if (A.shape[0] != dm or B.shape != (bsz, s, n) or C.shape != (bsz, s, n)
            or D.shape != (dm,)):
        raise ValueError(f"mamba_scan: A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, D {tuple(D.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"mamba_scan: chunk must be >= 1, got {chunk}")
    device = check_tensors("mamba_scan", torch.float32, None, x=x, dt=dt, A=A, B=B,
                           C=C, D=D)
    if device.type == "cpu":
        return mamba_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    if n not in STATE_DIMS:
        raise ValueError(f"mamba_scan: state dim N={n} has no kernel instance; "
                         f"supported: {STATE_DIMS}")
    ch = pick_block(s, chunk) if s else 1
    if 2 * ch * n * 4 > _SMEM_LIMIT:
        raise ValueError(f"mamba_scan: chunk {ch} x N {n} stages {2 * ch * n * 4} "
                         f"bytes of B and C, above {_SMEM_LIMIT}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _lib()
    err = lib.mamba_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                                C.data_ptr(), y.data_ptr(), bsz, s, dm, n, ch,
                                stream_handle(device))
    _build.check_launch(lib, "mamba_scan", err)
    mamba_scan.launches += 1
    return y + x * D


mamba_scan.launches = 0
