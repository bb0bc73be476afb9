"""Device policy and the input checks every kernel wrapper shares.

There is no interpret mode: a kernel runs on the card, and its plain PyTorch
version runs only for tensors that lie on the CPU. Nothing here falls back
from the card to the CPU: asking for CUDA where there is none raises.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # finite mask value: -inf breaks max-subtraction on empty rows

# dtype -> the kernels' dtype code (csrc/common.cuh kFloat32, kBFloat16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pick_block(dim: int, preferred: int) -> int:
    """Largest divisor of ``dim`` that is <= preferred."""
    b = min(preferred, dim)
    while dim % b:
        b -= 1
    return b


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless the caller names
    another. Raises when CUDA is asked for and this process has none."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} was requested but no CUDA device is available "
                "(torch.cuda.is_available() is False); pass device='cpu' "
                "(CLI: --device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda[:N]' or 'cpu'")
    return dev


def check_tensors(kernel: str, dtype: torch.dtype, shape: tuple[int, ...] | None,
                  **tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor has ``dtype``, ``shape`` (when given), is
    contiguous and lies on one device; returns that device."""
    devices = set()
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {name} must be a tensor, got {type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"{kernel}: inputs must lie on one device, got {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {device}")
    return device


def check_aligned(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary, as TMA
    copies need (a fresh tensor does; a view at an odd offset may not). The
    kernel is not run on a copy: the caller decides whether to copy."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary "
                             f"(data_ptr {t.data_ptr():#x}); pass an aligned copy")


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
