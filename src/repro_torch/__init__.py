"""repro_torch: the latency characterization of ``repro``, ported to PyTorch
and CUDA for NVIDIA Hopper (H100).

The package mirrors ``src/repro/`` file for file where a counterpart exists
and imports nothing from it: ``repro`` stays the reference, and the tests
hold the two against each other on the CPU. Every entry point runs on
``cuda:0`` unless the caller asks for ``device="cpu"``; asking for the card
where there is none raises.

The front door is ``repro_torch.api`` (``Session`` / ``Plan`` / ``Probe``)::

    from repro_torch.api import Session, named_plan

CLI: ``python -m repro_torch characterize --plan quick|fused --db PATH [--table]``.
"""
__version__ = "0.1.0"
