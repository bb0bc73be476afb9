"""K6: one-token (decode) GQA attention against a KV cache, split over the
sequence.

Replaces ``repro/kernels/flash_decode.py::flash_decode``: q [B,H,D], k and
v [B,S,KH,D], kv_len [B] int32; query head h attends to the keys below
kv_len[b] of KV head h // (H // KH), in float32, output cast to the inputs'
dtype. The kernel is ``csrc/flash_decode.cu``: a first pass over (KV head,
batch, split of :data:`KEYS_PER_SPLIT` keys) and, when the cache spans more
than one split, a second that merges the splits' partials by log-sum-exp.
``flash_decode_plain`` beside it is the same function in plain PyTorch,
which the wrapper runs for tensors on the CPU.

As in the TPU kernel, a row with ``kv_len = 0`` is 0 (``ref_decode_attention``
gives NaN there).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, NEG_INF, cdiv, check_aligned,
                                        check_tensors, stream_handle)
from repro_torch.kernels.flash_attention import HEAD_DIMS, _check_shapes

MAX_GROUP = 8  # query heads per KV head the kernel takes (flash_decode.cu)
# Keys a block of the first pass takes (a multiple of 64, flash_decode.cu's
# kSplitMultiple: no tile straddles two splits). The fused plan's unit workloads (at most 96 keys) fit one split,
# so their row times the walk over keys, not the width of the launch.
KEYS_PER_SPLIT = 512
# the design each dtype runs on the card: one for both
_DESIGN = (f"split-KV: a block per (KV head, batch, {KEYS_PER_SPLIT}-key split), 16-byte "
           f"cp.async into a 3-stage ring, fma; log-sum-exp combine pass when S > "
           f"{KEYS_PER_SPLIT}")
DESIGNS = {torch.bfloat16: _DESIGN, torch.float32: _DESIGN}


def split_count(s: int, keys_per_split: int = KEYS_PER_SPLIT) -> int:
    """Splits the first pass cuts a cache of ``s`` keys into (at least 1);
    with 1 the first pass writes the output and no combine runs."""
    return max(1, cdiv(s, keys_per_split))


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention in float32 with the kernel's semantics: keys at or
    past kv_len weigh exactly 0, the output is ``acc / max(l, 1e-30)``."""
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kh, h // kh, d) * float(d ** -0.5)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    valid = (torch.arange(s, device=q.device)[None, :]
             < kv_len.to(q.device).long().reshape(-1, 1))[:, None, None, :]
    logits = logits.masked_fill(~valid, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_decode")
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    return lib


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B,H,D]; k, v: [B,S,KH,D], one dtype (float32 or bfloat16);
    kv_len: [B] int32; all contiguous, on one device. Returns [B,H,D].

    On CUDA tensors this launches the kernel (counted once a call in
    ``flash_decode.launches``, whether it runs one pass or two; D must be
    one of :data:`HEAD_DIMS`, H // KH at most :data:`MAX_GROUP`, and every
    tensor must start on a 16-byte boundary); on CPU tensors it runs
    :func:`flash_decode_plain`.
    """
    d, g = _check_shapes("flash_decode", q, k, v, 3)
    device = check_tensors("flash_decode", q.dtype, None, q=q, k=k, v=v)
    if check_tensors("flash_decode", torch.int32, (q.shape[0],), kv_len=kv_len) != device:
        raise ValueError(f"flash_decode: kv_len on {kv_len.device}, q on {device}")
    if device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {d} has no kernel instance; "
                         f"supported: {HEAD_DIMS}")
    if g > MAX_GROUP:
        raise ValueError(f"flash_decode: {g} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    check_aligned("flash_decode", q=q, k=k, v=v)
    out = torch.empty_like(q)
    b, s, kh = k.shape[0], k.shape[1], k.shape[2]
    if out.numel() == 0:
        return out
    nsplit = split_count(s)
    part_acc = part_ml = None
    if nsplit > 1:  # the first pass's partials, merged by the second
        part_acc = torch.empty((b, kh, nsplit, g, d), dtype=torch.float32, device=device)
        part_ml = torch.empty((b, kh, nsplit, g, 2), dtype=torch.float32, device=device)
    lib = _lib()
    err = lib.flash_decode_launch(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, s, kh, g, d, KEYS_PER_SPLIT,
        float(d ** -0.5), stream_handle(device))
    _build.check_launch(lib, "flash_decode", err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
