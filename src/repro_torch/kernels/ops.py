"""Public kernel surface: every kernel of the port, imported from one place.

Each wrapper launches its CUDA kernel for tensors on the card and runs its
plain PyTorch version (``*_plain``, in the same module) for tensors on the
CPU; ``<wrapper>.launches`` counts the kernel's launches.
"""
from repro_torch.kernels.alu_chain import alu_chain
from repro_torch.kernels.chase import chase
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.opchain import op_chain
from repro_torch.kernels.rmsnorm import rmsnorm

KERNELS = (alu_chain, op_chain, chase, rmsnorm, flash_attention, flash_decode,
           mamba_scan)

__all__ = ["KERNELS", "alu_chain", "chase", "flash_attention", "flash_decode",
           "mamba_scan", "op_chain", "rmsnorm"]
