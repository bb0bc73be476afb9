"""K3: the dependent pointer chase (the memory-hierarchy probe) in one kernel.

Replaces ``repro/kernels/chase.py::chase``: ``p = ring[p]`` for ``steps``
steps over an int32 single-cycle ring, returning the last index as a [1]
int32 tensor. The kernel is ``csrc/chase.cu``; like the TPU kernel it has
two residencies, picked by the ring's footprint
(:func:`select_memory_space`) unless forced:

* ``"smem"`` (the VMEM path's counterpart): the ring is copied into the
  block's shared memory and chased there, for rings up to
  :data:`SMEM_BUDGET_BYTES`;
* ``"global"`` (the ANY path's): one thread chases the ring in global memory
  with ``ld.global.ca``, so where the ring sits (L1, L2 or HBM) decides what
  a load costs.

Two forms share the kernel: :func:`chase`, and :func:`chase_timed`, the
clock sandwich, which also returns the SM cycles of its ``steps`` timed
loads. Both may walk ``warm`` untimed steps first and write ``p`` to
``out`` (the start's own tensor carries the start to the next call); see
``core.membench.level_rule`` for when the probes do either.
``chase_plain`` is the same function in plain PyTorch, which the wrappers
run for tensors on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensors, stream_handle

# the design each dtype runs on the card
DESIGNS = {torch.int32: "one-thread pointer chase, ld.shared (ring copied into shared "
                        "memory) or ld.global.ca"}

# The most dynamic shared memory one block may opt into on sm_90 (227 KB):
# rings up to this size run from shared memory.
SMEM_BUDGET_BYTES = 232448
MEMORY_SPACES = ("smem", "global")


def select_memory_space(ring_bytes: int, smem_budget: int | None = None) -> str:
    """Residency policy: ``"smem"`` when the ring fits the block's shared
    memory (``smem_budget``, default :data:`SMEM_BUDGET_BYTES`), ``"global"``
    above."""
    budget = SMEM_BUDGET_BYTES if smem_budget is None else int(smem_budget)
    return "smem" if int(ring_bytes) <= budget else "global"


def resolve_memory_space(ring: torch.Tensor, memory_space: str | None) -> str:
    """The path a chase of ``ring`` runs: ``memory_space``, or the footprint's
    when None. Raises for an unknown space, and for ``"smem"`` on a ring
    above the budget."""
    nbytes = ring.numel() * 4
    if memory_space is None:
        return select_memory_space(nbytes)
    if memory_space not in MEMORY_SPACES:
        raise ValueError(f"chase: memory_space must be one of {MEMORY_SPACES}, "
                         f"got {memory_space!r}")
    if memory_space == "smem" and nbytes > SMEM_BUDGET_BYTES:
        raise ValueError(f"chase: a ring of {nbytes} bytes does not fit the "
                         f"{SMEM_BUDGET_BYTES}-byte shared-memory budget of the smem path")
    return memory_space


def chase_plain(ring: torch.Tensor, start: torch.Tensor, *, steps: int, warm: int = 0,
                out: torch.Tensor | None = None, timed: bool = False):
    """Follow ``ring[p]`` ``warm + steps`` times from ``start[0]``, on the
    host; ``p`` goes to ``out`` (a new tensor on the ring's device if None).
    ``timed``: the timed form's plain version, ``(p, None)``: it has no
    cycles to give."""
    r = ring.detach().cpu().numpy()
    p = int(start[0])
    for _ in range(warm + steps):
        p = int(r[p])
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=ring.device)
    out.fill_(p)
    return (out, None) if timed else out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("chase")
    lib.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.chase_launch.restype = ctypes.c_int
    return lib


def _check(ring: torch.Tensor, start: torch.Tensor, out: torch.Tensor | None,
           steps: int, warm: int) -> torch.device:
    if steps < 0 or warm < 0:
        raise ValueError(f"chase: steps and warm must be >= 0, got {steps}, {warm}")
    if ring.dim() != 1 or ring.numel() == 0:
        raise ValueError(f"chase: ring must be a non-empty 1-D tensor, got shape "
                         f"{tuple(ring.shape)}")
    check_tensors("chase", torch.int32, None, ring=ring)
    outs = {} if out is None else {"out": out}
    device = check_tensors("chase", torch.int32, (1,), start=start, **outs)
    if device != ring.device:
        raise ValueError(f"chase: ring on {ring.device}, start on {device}")
    return device


def _launch(ring, start, out, cycles, steps, warm, space) -> None:
    lib = _lib()
    err = lib.chase_launch(ring.data_ptr(), ring.numel(), start.data_ptr(), out.data_ptr(),
                           cycles.data_ptr() if cycles is not None else None, warm, steps,
                           int(space == "smem"), stream_handle(ring.device))
    _build.check_launch(lib, "chase", err)
    chase.launches += 1
    chase.launches_by_path[f"{'timed' if cycles is not None else 'untimed'}/{space}"] += 1


def chase(ring: torch.Tensor, start: torch.Tensor, *, steps: int, warm: int = 0,
          memory_space: str | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """ring: [N] int32 ring of indices into itself; start: [1] int32.

    Returns ``p`` after ``warm + steps`` loads from ``start[0]`` (the JAX
    function's contract at ``warm=0``), in ``out`` if given (``out=start``
    carries the start to the next call). ``memory_space`` ``"smem"`` or
    ``"global"`` forces a path; None picks it by footprint. On CUDA tensors
    this launches the kernel (counted in ``chase.launches`` and, by form and
    path, ``chase.launches_by_path``); on CPU tensors it runs
    :func:`chase_plain`. The ring's values are not checked: it must index
    itself, as ``core.membench.build_ring`` makes it.
    """
    device = _check(ring, start, out, steps, warm)
    space = resolve_memory_space(ring, memory_space)
    if device.type == "cpu":
        return chase_plain(ring, start, steps=steps, warm=warm, out=out)
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=device)
    _launch(ring, start, out, None, steps, warm, space)
    return out


def chase_timed(ring: torch.Tensor, start: torch.Tensor, *, steps: int, warm: int = 0,
                memory_space: str | None = None, out: torch.Tensor | None = None):
    """:func:`chase`'s timed form: ``(p, cycles)``, cycles a [1] int64 tensor
    of the SM cycles between a ``%clock64`` read once the start (the copy on
    the smem path) and the ``warm`` steps have landed and one once the last
    of the ``steps`` timed loads has returned. Straight-line at 64 and 192
    steps. On CPU tensors ``(chase_plain(...), None)``."""
    device = _check(ring, start, out, steps, warm)
    space = resolve_memory_space(ring, memory_space)
    if device.type == "cpu":
        return chase_plain(ring, start, steps=steps, warm=warm, out=out, timed=True)
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=device)
    cycles = torch.empty(1, dtype=torch.int64, device=device)
    _launch(ring, start, out, cycles, steps, warm, space)
    chase_timed.launches += 1
    return out, cycles


chase.launches = 0            # every launch of K3, both forms
chase_timed.launches = 0      # the timed form's alone
chase.launches_by_path = collections.Counter()  # "timed/smem", "untimed/global", ...
