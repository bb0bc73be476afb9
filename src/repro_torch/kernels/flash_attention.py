"""K5: blockwise (flash) GQA attention with an online softmax, in one kernel.

Replaces ``repro/kernels/flash_attention.py::flash_attention``: q
[B,Sq,H,D], k and v [B,Sk,KH,D] with H % KH == 0, query head h reading KV
head h // (H // KH); float32 logits ``(q * scale) . k``, with ``causal`` a
query at row i seeing the keys at or before i + (Sk - Sq); the output cast
to the inputs' dtype. The kernels are in ``csrc/flash_attention.cu``, one
design per dtype (:data:`DESIGNS`), both on the tensor cores: bfloat16
as wgmma, with Q, K and V copied by TMA; float32 as 3xTF32 mma.sync (each
operand split in two TF32 terms, since one TF32 product would fail the
float32 limit), with K and V copied by cp.async. ``flash_attention_plain``
beside them is the same function in plain PyTorch, which the wrapper runs
for tensors on the CPU.

One deliberate divergence from the JAX package: a query row that sees no
key (causal with Sq > Sk) is 0 here, in the kernel and the plain version
alike. The TPU kernel gives such a row a value that depends on its block
sizes, and ``ref_attention`` gives NaN.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, NEG_INF, check_aligned,
                                        check_tensors, stream_handle)

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instances (flash_attention.cu)
# the design each dtype runs on the card: a label (chip_smoke.py prints it);
# flash_attention_launch picks the kernel from the dtype code
DESIGNS = {torch.bfloat16: "wgmma", torch.float32: "3xtf32 mma.sync"}


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_dims: int) -> tuple[int, int]:
    """Raise unless q has ``q_dims`` dims, k and v are [B,S,KH,D] alike, and
    the heads group evenly; returns (D, g)."""
    if q.dim() != q_dims or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    d, h, kh = q.shape[-1], q.shape[-2], k.shape[2]
    if k.shape[0] != q.shape[0] or k.shape[3] != d or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)} "
                         "(same batch and head dim, H % KH == 0)")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: inputs must be float32 or bfloat16, got {q.dtype}")
    return d, h // kh


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Dense attention in float32 with the kernel's semantics: masked keys
    weigh exactly 0, the output is ``acc / max(l, 1e-30)`` (0 for a row that
    sees no key), cast to q's dtype."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = float(d ** -0.5) if scale is None else scale
    qf = q.float().reshape(b, sq, kh, g, d) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = qpos >= torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = p.masked_fill(~mask, 0.0)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k, v: [B,Sk,KH,D], H % KH == 0, one dtype (float32 or
    bfloat16), contiguous. Returns [B,Sq,H,D].

    On CUDA tensors this launches the kernel of the dtype's design
    (:data:`DESIGNS`; counted in ``flash_attention.launches``; D must be one
    of :data:`HEAD_DIMS`; the tensors must start on 16-byte boundaries, as
    TMA and cp.async need; bfloat16 takes scale > 0); on CPU tensors it runs
    :func:`flash_attention_plain`.
    """
    d, _ = _check_shapes("flash_attention", q, k, v, 4)
    device = check_tensors("flash_attention", q.dtype, None, q=q, k=k, v=v)
    scale = float(d ** -0.5) if scale is None else float(scale)
    if device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} has no kernel instance; "
                         f"supported: {HEAD_DIMS}")
    check_aligned("flash_attention", q=q, k=k, v=v)  # as TMA and cp.async need
    if q.dtype == torch.bfloat16 and scale <= 0:  # wgmma scales each row's max
        raise ValueError(f"flash_attention: bfloat16 needs scale > 0, got {scale}")
    out = torch.empty_like(q)
    b, sq, h, _ = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.flash_attention_launch(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), out.data_ptr(), b, sq, sk, h, kh,
                                     d, scale, int(causal), stream_handle(device))
    _build.check_launch(lib, "flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
