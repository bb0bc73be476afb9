"""Compiler-optimization levels: the paper's -O0/-O3 axis, for PyTorch.

* ``O0`` — eager, op by op: no fusion or simplification across ops, every
  op pays a full dispatch (and, on the card, a kernel launch).
* ``O3`` — ``torch.compile`` with Inductor, the full graph compiled into
  fused kernels; the counterpart of ``jax.jit`` on XLA (simplification and
  strength reduction, e.g. a division by a constant power of two becoming a
  shift, happen here).

``O1`` (a reduced level) is not ported yet. For rows whose step is the
``op_chain`` kernel the same axis is dispatch granularity: O0 launches the
kernel once per step, O3 once for the whole chain (``core.measure``).
"""
from __future__ import annotations

import copyreg
import pydoc
import types
from typing import Any, Callable

import torch

OPT_LEVELS = ("O0", "O3")


def _own_code(fn: Callable[..., Any], name: str) -> Callable[..., Any]:
    """``fn`` with a code object of its own, named ``name``.

    Dynamo keeps its compiled graphs on the code object, and every chain
    ``chains.chain_fn`` builds shares one; past ``recompile_limit`` entries
    Dynamo would run further chains eagerly. The name is deterministic, so a
    chain compiled in a worker process hashes like the same chain compiled
    here and Inductor's on-disk cache serves it.
    """
    code = fn.__code__.replace(co_name=name, co_qualname=name)
    return types.FunctionType(code, fn.__globals__, name, fn.__defaults__,
                              fn.__closure__)


def _reduce_memory_format(fmt: torch.memory_format) -> tuple:
    return pydoc.locate, (str(fmt),)  # str: "torch.contiguous_format"


def stable_cache_keys() -> None:
    """Make Inductor's on-disk cache keys the same in every process.

    The key pickles each input's metadata, memory format included. A
    ``torch.memory_format`` has no ``__module__``, so pickle names it after
    the first loaded module through which ``torch.contiguous_format`` is
    reachable — ``__mp_main__`` in a process whose main script imports
    torch, another module elsewhere — and a chain compiled in a compile
    worker missed the cache in the session. Pickled by its dotted name
    through ``pydoc.locate`` (as ``torch.serialization`` registers layouts)
    it is the same bytes everywhere and unpickles to the same object.
    """
    copyreg.pickle(torch.memory_format, _reduce_memory_format)


def compile_at_level(fn: Callable[..., Any], level: str, name: str = "chain",
                     options: dict[str, Any] | None = None) -> Callable[..., Any]:
    """Return ``fn`` at the requested optimization level. O3 compiles lazily,
    at the first call; ``options`` adds Inductor options to it."""
    if level == "O0":
        return fn  # eager dispatch
    if level == "O3":
        stable_cache_keys()
        # compile_threads=1: Triton kernels compile in the calling process.
        # By default Inductor starts a pool of compile subprocesses, one per
        # core, in every process that compiles: on the host the O0 rows time,
        # and once more in each compile worker of the session. It is part of
        # Inductor's cache key, so every compile of a chain passes the same.
        return torch.compile(_own_code(fn, name), backend="inductor",
                             fullgraph=True, dynamic=False,
                             options={"compile_threads": 1, **(options or {})})
    if level == "O1":
        raise NotImplementedError("opt level O1 is not ported yet (see ROADMAP)")
    raise ValueError(f"unknown opt level {level!r}; choose from {OPT_LEVELS}")
