"""Compiler-optimization levels: the paper's -O0/-O1/-O3 axis, for PyTorch.

* ``O0`` — eager, op by op: no fusion or simplification across ops, every
  op pays a full dispatch (and, on the card, a kernel launch).
* ``O1`` — ``torch.compile`` with the ``aot_eager`` backend: Dynamo
  captures the whole chain and AOTAutograd traces it into one graph of ATen
  ops, which then run one kernel each, with no fusion and no code
  generation. The graph is kept but the backend's optimizations are off,
  as the JAX package's O1 keeps the jit but turns XLA's backend
  optimizations down; the Python dispatch of each op is gone. It compiles
  in the calling process, in seconds, with no Inductor lowering.
* ``O3`` — ``torch.compile`` with Inductor, the full graph compiled into
  fused kernels; the counterpart of ``jax.jit`` on XLA (simplification and
  strength reduction, e.g. a division by a constant power of two becoming a
  shift, happen here).

For rows whose step is the ``op_chain`` kernel the same axis is dispatch
granularity: O0 launches the kernel once per step, O1 once per step from
the captured graph, O3 once for the whole chain (``core.measure``).
"""
from __future__ import annotations

import collections
import copyreg
import functools
import pydoc
import types
from typing import Any, Callable

import torch

OPT_LEVELS = ("O0", "O1", "O3")

# what O1 passes to torch.compile: o1_option_string() states it in the notes
O1_OPTIONS = {"backend": "aot_eager", "fullgraph": True, "dynamic": False}

# the ATen ops of each graph an O1 compile traced in this process, by the
# compiled function's name (see compile_at_level): the audit reads a chain's
# graph here instead of tracing it again
O1_GRAPHS: dict[str, collections.Counter] = {}


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


def incremental_opcount() -> None:
    """Make Inductor's lowering of a long pointwise chain linear in its
    length, with the same decisions and the same code.

    After each node it lowers, Inductor counts the ops of the node's
    expression (``Loops.inner_fn_opcount``: the node's ``inner_fn`` traced
    under an ``OpCounterCSE``) to decide whether to store it as a buffer;
    the expression inlines every input not yet stored, up to 100 ops, so a
    512-step chain traces ~50 ops a node again and again: 58 % of the
    lowering of ``mad.cc``'s chain on an H100's host (``tools/
    compile_study.py``). Here each node keeps its count's final state and
    output; when a later count, from a fresh counter, reaches that node's
    expression first with the same index, it takes that state and output
    instead of tracing the node again. The trace it skips would have left
    the counter in exactly that state, so every count, and with it every
    decision and the generated code, is what it was. Anywhere else (code
    generation, a counter that has seen other ops first, another index)
    the node's expression runs as before. Installing it twice is a no-op;
    each installed method keeps Inductor's own as ``inductor_own``."""
    from torch._inductor import ir
    from torch._inductor.ops_handler import OpCounterCSE
    from torch._inductor.virtualized import V

    if hasattr(ir.Loops.inner_fn_opcount, "inductor_own"):
        return
    count, make_loader = ir.Loops.inner_fn_opcount, ir.Pointwise.make_loader

    def fresh(handler) -> bool:
        return (isinstance(handler, OpCounterCSE) and handler.op_count == 0
                and not handler.var_names)

    def snapshot(handler) -> dict:
        return {k: (v.copy() if hasattr(v, "copy") else v)
                for k, v in vars(handler).items() if k != "parent_handler"}

    def inner_fn_opcount(self):
        if not isinstance(self, ir.Pointwise) or "_opcount_state" in vars(self):
            return count(self)
        inner = self.inner_fn

        def recording(*args):
            handler = V.ops
            start = fresh(handler)
            out = inner(*args)
            if start:
                object.__setattr__(self, "_opcount_state", (
                    args, type(handler.parent_handler), snapshot(handler), out))
            return out

        object.__setattr__(self, "inner_fn", recording)
        try:
            return count(self)
        finally:
            object.__setattr__(self, "inner_fn", inner)

    def pointwise_make_loader(self):
        loader = make_loader(self)
        if loader is not self.inner_fn:
            return loader
        node = self

        def load(*args):
            saved = vars(node).get("_opcount_state")
            handler = V.ops
            if (saved is not None and fresh(handler) and saved[0] == args
                    and type(handler.parent_handler) is saved[1]):
                vars(handler).update(snapshot(types.SimpleNamespace(**saved[2])))
                return saved[3]
            return loader(*args)

        return load

    inner_fn_opcount.inductor_own = count
    pointwise_make_loader.inductor_own = make_loader
    ir.Loops.inner_fn_opcount = inner_fn_opcount
    ir.Pointwise.make_loader = pointwise_make_loader


def o1_option_string() -> str:
    """O1's settings, as the rows measured at O1 state them (``o1=``)."""
    return ",".join(f"{k}:{v}" for k, v in O1_OPTIONS.items())


def graph_ops(gm: torch.fx.GraphModule) -> collections.Counter:
    """The ATen ops of a traced graph, by overload name
    (``aten.add.Tensor``), each with its count."""
    return collections.Counter(str(node.target) for node in gm.graph.nodes
                               if node.op == "call_function")


def _o1_backend(name: str) -> Callable[..., Any]:
    """``aot_eager`` whose forward compiler, the nop that runs the graph op
    by op, also keeps the graph's ATen ops in :data:`O1_GRAPHS`."""
    from torch._dynamo.backends.debugging import aot_eager, boxed_nop

    def forward(gm: torch.fx.GraphModule, example_inputs: list) -> Callable[..., Any]:
        O1_GRAPHS[name] = graph_ops(gm)
        return boxed_nop(gm, example_inputs)

    return functools.partial(aot_eager, fw_compiler=forward)


def compile_at_level(fn: Callable[..., Any], level: str, name: str = "chain",
                     options: dict[str, Any] | None = None) -> Callable[..., Any]:
    """Return ``fn`` at the requested optimization level. O1 and O3 compile
    lazily, at the first call; ``options`` adds Inductor options to O3.
    ``name`` names the compiled code (and O1's graph in
    :data:`O1_GRAPHS`)."""
    if level == "O0":
        return fn  # eager dispatch
    if level == "O3":
        stable_cache_keys()
        incremental_opcount()
        # compile_threads=1: Triton kernels compile in the calling process.
        # By default Inductor starts a pool of compile subprocesses, one per
        # core, in every process that compiles: on the host the O0 rows time,
        # and once more in each compile worker of the session. It is part of
        # Inductor's cache key, so every compile of a chain passes the same.
        return torch.compile(_own_code(fn, name), backend="inductor",
                             fullgraph=True, dynamic=False,
                             options={"compile_threads": 1, **(options or {})})
    if level == "O1":
        return torch.compile(_own_code(fn, name), backend=_o1_backend(name),
                             fullgraph=True, dynamic=False)
    raise ValueError(f"unknown opt level {level!r}; choose from {OPT_LEVELS}")
