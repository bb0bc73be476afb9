"""Public kernel surface: every kernel of the port, imported from one place.

Each wrapper launches its CUDA kernel for tensors on the card and runs its
plain PyTorch version (``*_plain``, in the same module) for tensors on the
CPU; ``<wrapper>.launches`` counts the kernel's launches.
"""
from repro_torch.kernels.alu_chain import alu_chain
from repro_torch.kernels.chase import chase
from repro_torch.kernels.opchain import op_chain

KERNELS = (alu_chain, op_chain, chase)

__all__ = ["KERNELS", "alu_chain", "chase", "op_chain"]
