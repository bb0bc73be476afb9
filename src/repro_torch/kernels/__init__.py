"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel module holds a wrapper (checks its inputs, launches the kernel on
a CUDA tensor, counts its launches) and, beside it, a plain PyTorch version
of the same function that the wrapper runs for a tensor on the CPU.
"""
