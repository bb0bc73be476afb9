"""K7: the selective scan of Mamba (S6) in one kernel.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan``: per batch row and
channel, ``dt = softplus(dt)``, ``h = exp(dt * A) * h + (dt * x) * B``,
``y = h . C + x * D`` over the sequence with a float32 [Dm, N] state from
0. The TPU kernel's caller adds ``x * D`` after the kernel; here the
kernel's store does. The kernel is ``csrc/mamba_scan.cu`` (staged tiles of
x, dt, B and C, a channel's states spread over lanes); ``mamba_scan_plain``
beside it is the same function in plain PyTorch, a loop over the time steps
like ``ref_selective_scan``, which the wrapper runs for tensors on the CPU.
With ``return_state=True`` both also return the final state h [Bz, Dm, N]
(``ref_selective_scan``'s ``h_final``, which the TPU kernel does not give).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensors, stream_handle

STATE_DIMS = (4, 8, 16)  # the kernel's instances of N (mamba_scan.cu)
# the plain version's steps a block: its factors for them at Jamba's widths
# (Dm 8192, N 16, batch 8) take 256 MiB
PLAIN_STEPS = 64
# the design each dtype runs on the card
DESIGNS = {torch.float32: "staged tiles, states spread over lanes, D folded in"}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s stable form: log1p(exp(-|x|)) + max(x, 0)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)


def mamba_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                     chunk: int = 128, return_state: bool = False
                     ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The scan in plain PyTorch, one time step at a time. The step's
    factors exp(dt * A) and (dt * x) * B, and y's h . C, are taken for
    PLAIN_STEPS steps at once (over the whole sequence they would hold [Bz,
    S, Dm, N] floats: 1 GiB at a model's widths), so that a step is one
    multiply and one add, each rounded as ``ref_selective_scan`` rounds it.
    ``chunk`` does not change the result."""
    bsz, s, dm = x.shape
    dtf = softplus(dt.float())
    dx = dtf * x.float()
    af, bf, cf = A.float(), B.float(), C.float()
    h = torch.zeros(bsz, dm, A.shape[1], dtype=torch.float32, device=x.device)
    y = torch.empty(bsz, s, dm, dtype=torch.float32, device=x.device)
    for t0 in range(0, s, PLAIN_STEPS):
        t1 = min(t0 + PLAIN_STEPS, s)
        decay = torch.exp(dtf[:, t0:t1, :, None] * af)
        inject = dx[:, t0:t1, :, None] * bf[:, t0:t1, None, :]
        hs = torch.empty_like(decay)
        for t in range(t1 - t0):
            h = torch.add(decay[:, t] * h, inject[:, t], out=hs[:, t])
        y[:, t0:t1] = (hs * cf[:, t0:t1, None, :]).sum(dim=-1)
    y = y.to(x.dtype) + x * D.to(x.dtype)
    return (y, h) if return_state else y


def scan_vectorized(x: torch.Tensor, *tensors: torch.Tensor) -> bool:
    """Whether the kernel copies in 16-byte pieces: Dm a multiple of 4 and
    every base on a 16-byte boundary; else it copies 4 bytes at a time."""
    return x.shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *tensors))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("mamba_scan")
    lib.mamba_scan_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.mamba_scan_launch.restype = ctypes.c_int
    return lib


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, D: torch.Tensor, *, chunk: int = 128,
               return_state: bool = False
               ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [Bz,S,Dm]; A: [Dm,N]; B, C: [Bz,S,N]; D: [Dm]; all float32 and
    contiguous, on one device. Returns y: [Bz,S,Dm], and with
    ``return_state`` also the final state h: [Bz,Dm,N] float32.

    ``chunk`` (>= 1) is the TPU kernel's: it cuts the sequence into chunks
    of the largest divisor of S up to ``chunk``. It does not change the
    result, and on the card it sets nothing: the kernel stages its own
    tiles of 32 steps and masks the tail. On CUDA tensors this launches the
    kernel (counted in ``mamba_scan.launches``; N must be one of
    :data:`STATE_DIMS`); on CPU tensors it runs :func:`mamba_scan_plain`.
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
        return mamba_scan_plain(x, dt, A, B, C, D, chunk=chunk, return_state=return_state)
    if n not in STATE_DIMS:
        raise ValueError(f"mamba_scan: state dim N={n} has no kernel instance; "
                         f"supported: {STATE_DIMS}")
    y = torch.empty_like(x)
    h = torch.zeros(bsz, dm, n, dtype=torch.float32, device=device) if return_state else None
    if y.numel() == 0:  # no step (h stays 0) or nothing to scan
        return (y, h) if return_state else y
    lib = _lib()
    err = lib.mamba_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                                C.data_ptr(), D.data_ptr(), y.data_ptr(),
                                None if h is None else h.data_ptr(), bsz, s, dm, n,
                                int(scan_vectorized(x, dt, B, C)),
                                stream_handle(device))
    _build.check_launch(lib, "mamba_scan", err)
    mamba_scan.launches += 1
    return (y, h) if return_state else y


mamba_scan.launches = 0
