"""The port's "instruction counter": an op record of one eager step, in the
place of the JAX package's analysis of compiled HLO text
(``repro/core/hlo_analysis.py``).

The JAX package prices the optimized HLO of a jit-lowered step. The port
serves eagerly and has no HLO, so it prices what the step runs:
:func:`record_ops` runs the step once, untimed, under a
``TorchDispatchMode`` and records every ATen op it issues, its result
elements and the bytes of its tensor inputs and outputs. How the record
maps onto the JAX package's counts:

* **histogram** ``{(op, result elements): count}`` ↔
  ``ModuleCost.dynamic_histogram()``. No trip counts: an eager Python loop
  over the layers issues every op of every layer, so the record is dynamic
  by construction (the JAX rollup multiplies a ``while`` body by its
  ``known_trip_count``; here the body simply ran that many times). Op
  names are ATen's, an in-place variant under its functional name
  (``add_`` counts as ``add``).
* **HLO-level granularity.** ATen's compound ops (``silu``, ``_softmax``,
  ``softplus``, ``native_layer_norm``, ``addcmul``, ``mean``…) are one op
  in eager and several opcodes in the JAX module. Each op that the table
  does not map (:data:`ATEN_TO_TABLE`), that is not structural or a matmul
  and not one of :data:`RECORDED_AS_IS`, is counted through its
  ``torch._decomp`` decomposition, run on meta tensors of the same shapes,
  so the histogram holds the ops it expands to (a decomposition that
  cannot run on meta tensors leaves the op as it is). The real op still
  computes the step's values.
* **matmul FLOPs** ↔ ``dynamic_flops()["dot"]``: ``mm``, ``bmm``,
  ``addmm`` and ``baddbmm`` count 2·M·N·K (XLA's dot convention).
* **kernel sites** ↔ ``dynamic_custom_calls()``: while one of the port's
  fused-kernel wrappers (:data:`KERNEL_SITES`) runs, the record keeps one
  site named after the kernel, with the bytes of the call's tensor inputs
  and outputs, and none of the ops inside. The site is recorded whether the
  wrapper launches its kernel (on the card) or runs its plain version (on
  the CPU), so one model gives one record on both.
* **bytes** ↔ ``ModuleCost.total().bytes``, but *eager* bytes: every
  dispatched op reads its tensor inputs and writes its outputs (views and
  allocations move nothing; a tensor an op writes in place counts once, as
  its write; a scatter writes what it reads, as the JAX package's
  dynamic-update-slice rule). XLA counts only fusion boundaries; eager
  writes every intermediate, and the port prices what it runs.

The pure pieces later slices need (``COLLECTIVE_KINDS``, ``ring_factor``,
the ladder <-> collective maps) are copied from the JAX module.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


def ring_factor(kind: str, group: int) -> float:
    """Ring-algorithm wire bytes per result byte for one collective kind
    (the JAX package's convention, shared with its measured ladder and the
    estimator's pricing ratio)."""
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (group - 1) / group
    if kind == "all-gather":
        return (group - 1) / group
    if kind == "reduce-scatter":
        return float(group - 1)
    if kind == "all-to-all":
        return (group - 1) / group
    if kind == "collective-permute":
        return 1.0
    raise ValueError(kind)


# measured-ladder row kind (``coll.<kind>.*``) <-> collective kind
LADDER_TO_COLLECTIVE = {
    "psum": "all-reduce",
    "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "ppermute": "collective-permute",
}
COLLECTIVE_TO_LADDER = {v: k for k, v in LADDER_TO_COLLECTIVE.items()}


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    wire_bytes: float
    executions: float = 1.0
    line: str = ""


# The counterpart of ``HLO_TO_TABLE``: ATen op -> the registry row that
# prices it, onto the JAX table's rows (add -> add.float32, exp -> ex2,
# sigmoid -> tanh as XLA's logistic, neg -> sub as negate, ...).
ATEN_TO_TABLE = {
    "add": "add.float32", "sub": "sub.float32", "rsub": "sub.float32",
    "mul": "mul.float32", "div": "div.runtime.float32",
    "reciprocal": "div.runtime.float32",
    "maximum": "max.float32", "minimum": "min.float32",
    "exp": "ex2", "exp2": "ex2", "expm1": "ex2", "pow": "ex2",
    "log": "lg2", "log2": "lg2", "log1p": "lg2",
    "tanh": "tanh", "sigmoid": "tanh", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "sin": "sin", "cos": "cos", "abs": "abs", "neg": "sub",
    "bitwise_and": "and", "logical_and": "and", "bitwise_or": "or",
    "logical_or": "or", "bitwise_xor": "xor", "logical_xor": "xor",
    "bitwise_not": "not", "logical_not": "not",
    "bitwise_left_shift": "shl", "bitwise_right_shift": "shr",
    "remainder": "rem.s", "fmod": "rem.s",
}

# The matmul ops the estimator prices from their FLOPs (XLA's ``dot``).
MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm"})

# The counterpart of ``CUSTOM_CALL_TARGETS``: the wrappers in
# ``repro_torch.kernels.ops`` a record keeps as opaque sites -> the stem of
# the ``inkernel.fused.<name>`` row that prices one workload unit of them.
KERNEL_SITES = {
    "flash_attention": "flash_attention",
    "flash_decode": "flash_decode",
    "mamba_scan": "mamba_scan",
    "rmsnorm": "rmsnorm",
}

# Views and allocations: no bytes moved, no arithmetic.
_VIEWS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute",
    "transpose", "t", "slice", "select", "squeeze", "unsqueeze", "as_strided",
    "alias", "detach", "unbind", "split", "split_with_sizes", "chunk", "narrow",
    "diagonal", "unfold", "view_as_real", "view_as_complex", "lift_fresh",
    "broadcast_in_dim", "collapse_view", "split_dim", "_local_scalar_dense",
}
_ALLOCATIONS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full",
    "full_like", "new_full", "fill", "zero", "arange", "scalar_tensor", "iota",
    "lift_fresh_copy",
}
ZERO_BYTE_OPS = frozenset(_VIEWS | _ALLOCATIONS)

# Bookkeeping and data movement, not issued arithmetic: out of the
# estimator's coverage denominator (the counterpart of the JAX
# ``STRUCTURAL_OPS``); the bytes they move are in the record's bytes.
STRUCTURAL_OPS = frozenset(ZERO_BYTE_OPS | {
    "clone", "copy", "contiguous", "cat", "stack", "constant_pad_nd", "pad",
    "repeat", "flip", "roll", "_to_dense",
})

# ATen ops a record keeps as they are although no table row prices them:
# comparisons and selects, dtype casts, reductions, sorts and scans, and
# data-dependent gathers and scatters (the HLO module's compare, select,
# convert, reduce, sort, gather and scatter). Decomposing them would only
# rename them.
RECORDED_AS_IS = frozenset({
    "_to_copy", "eq", "ne", "lt", "le", "gt", "ge", "where", "sum", "amax", "amin",
    "max", "min", "argmax", "argmin", "prod", "any", "all", "topk", "sort", "argsort",
    "cumsum", "cumprod", "index", "index_select", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index_put", "index_add", "index_copy", "masked_scatter",
    "embedding", "floor", "ceil", "round", "trunc", "sign", "isnan", "isinf",
    "isfinite", "erf", "atan2", "clamp", "var",
})

# Ops that write part of their first argument with the values of their
# last tensor argument: they move what they read, not the whole buffer.
_SCATTERS = frozenset({"index_put", "index_copy", "index_add", "scatter", "scatter_add",
                       "scatter_reduce", "masked_scatter"})


@dataclasses.dataclass(frozen=True)
class KernelSite:
    """One call of a fused-kernel wrapper: the kernel's name, the bytes of
    its tensor inputs and outputs (the footprint the fused row's unit bytes
    scale) and how many times it ran."""

    name: str
    bytes: float
    executions: float = 1.0


@dataclasses.dataclass
class OpRecord:
    """What one eager step issued (see the module docstring)."""

    histogram: Counter = dataclasses.field(default_factory=Counter)
    matmul_flops: float = 0.0
    sites: list[KernelSite] = dataclasses.field(default_factory=list)
    bytes: float = 0.0
    collectives: list[CollectiveOp] = dataclasses.field(default_factory=list)

    def dynamic_histogram(self) -> dict[tuple[str, int], float]:
        return dict(self.histogram)

    @property
    def flops(self) -> float:
        """Matmul FLOPs plus one a result element of every other op that is
        not structural (XLA's elementwise convention)."""
        return self.matmul_flops + float(sum(
            e * c for (op, e), c in self.histogram.items()
            if op not in MATMUL_OPS and op not in STRUCTURAL_OPS))

    def site_counts(self) -> Counter:
        """Executions of each kernel site, by name."""
        out: Counter = Counter()
        for s in self.sites:
            out[s.name] += s.executions
        return out


def op_histogram(record: OpRecord) -> Counter:
    """Counts of (op, result elements) of a record (the flat and the dynamic
    histogram are one thing in eager: see the module docstring)."""
    return Counter(record.histogram)


# ------------------------------------------------------------------ record
def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _elements(out: Any) -> int:
    return sum(t.numel() for t in _tensors(out))


def _written(func, args: tuple, kwargs: dict) -> list[torch.Tensor]:
    """The tensor arguments the op's schema writes (in place or ``out=``)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += list(_tensors(v))
    return out


def _op_bytes(func, name: str, args: tuple, kwargs: dict, out: Any) -> float:
    if name in ZERO_BYTE_OPS:
        return 0.0
    written = {id(t) for t in _written(func, args, kwargs)}
    inputs = [t for t in _tensors((args, kwargs)) if id(t) not in written]
    read = sum(_nbytes(t) for t in inputs)
    if name in _SCATTERS and inputs:
        return float(read + _nbytes(inputs[-1]))
    return float(read + sum(_nbytes(t) for t in _tensors(out)))


def _matmul_flops(name: str, args: tuple, out: Any) -> float:
    lhs = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * float(_elements(out)) * float(lhs.shape[-1])


_DECOMPOSITIONS: dict | None = None


def _decomposition(func, name: str) -> Callable | None:
    if (name in ATEN_TO_TABLE or name in STRUCTURAL_OPS or name in MATMUL_OPS
            or name in RECORDED_AS_IS):
        return None
    global _DECOMPOSITIONS
    if _DECOMPOSITIONS is None:
        from torch._decomp import core_aten_decompositions, decomposition_table

        _DECOMPOSITIONS = {**decomposition_table, **core_aten_decompositions()}
    return _DECOMPOSITIONS.get(func)


def _meta(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device="meta")
    if isinstance(v, (list, tuple)):
        return type(v)(_meta(x) for x in v)
    if isinstance(v, dict):
        return {k: _meta(x) for k, x in v.items()}
    if isinstance(v, torch.device):
        return torch.device("meta")
    return v


def _signature(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return ("T", tuple(v.shape), tuple(v.stride()), v.dtype)
    if isinstance(v, (list, tuple)):
        return tuple(_signature(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _signature(x)) for k, x in v.items()))
    if isinstance(v, torch.device):
        return "device"
    return repr(v)


class _Recorder(TorchDispatchMode):
    """Counts what reaches the dispatcher. ``top`` records bytes (the ops
    eager really ran); a decomposition's recorder counts only. Compound ops
    are left in ``pending`` with meta copies of their arguments, since a
    mode cannot dispatch into itself while it handles an op; ``expansions``
    (shared by one record's recorders) keeps what each (op, arguments'
    shapes) expanded to."""

    def __init__(self, top: bool, expansions: dict):
        super().__init__()
        self.top = top
        self.expansions = expansions
        self.hist: Counter = Counter()
        self.flops = 0.0
        self.bytes = 0.0
        self.pending: list[tuple] = []
        self.site_depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.site_depth:
            return out
        name = _op_name(func)
        if self.top:
            self.bytes += _op_bytes(func, name, args, kwargs, out)
        decomp = _decomposition(func, name)
        if decomp is not None:
            sig = _signature((args, kwargs))
            if (func, sig) in self.expansions:
                hist, flops = self.expansions[(func, sig)]
                self.hist.update(hist)
                self.flops += flops
            else:
                self.pending.append((func, decomp, _meta(args), _meta(kwargs),
                                     (name, _elements(out)), sig))
            return out
        self.hist[(name, _elements(out))] += 1
        if name in MATMUL_OPS:
            self.flops += _matmul_flops(name, args, out)
        return out


def _expand(expansions: dict, func, decomp, margs, mkwargs, own: tuple[str, int], sig,
            depth: int = 0) -> tuple[Counter, float]:
    """The histogram and matmul FLOPs one compound op expands to, its
    decomposition run on meta tensors (nested compound ops expanded in
    turn); the op as it is where the decomposition cannot run there."""
    key = (func, sig)
    if key in expansions:
        return expansions[key]
    sub = _Recorder(top=False, expansions=expansions)
    try:
        if depth > 8:
            raise RecursionError(f"{func} expands more than 8 levels deep")
        with sub:
            decomp(*margs, **mkwargs)
    except Exception:  # noqa: BLE001 - not expandable on meta: count the op itself
        result = (Counter({own: 1}), 0.0)
    else:
        hist, flops = Counter(sub.hist), sub.flops
        for f, d, a, k, o, s in sub.pending:
            h, fl = _expand(expansions, f, d, a, k, o, s, depth + 1)
            hist.update(h)
            flops += fl
        result = (hist, flops)
    expansions[key] = result
    return result


@contextlib.contextmanager
def _kernel_sites(rec: _Recorder, sites: list[KernelSite]):
    """Route the fused-kernel wrappers of ``kernels.ops`` (looked up there
    at call time by the models) through a hook that keeps one site a call
    and hides the ops inside it from the record."""
    from repro_torch.kernels import ops

    real = {name: getattr(ops, name) for name in KERNEL_SITES}

    def hook(name: str, fn: Callable) -> Callable:
        def call(*args, **kw):
            rec.site_depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                rec.site_depth -= 1
            nbytes = sum(_nbytes(t) for t in _tensors((args, kw)))
            sites.append(KernelSite(name, float(nbytes + sum(_nbytes(t) for t in _tensors(out)))))
            return out
        return call

    try:
        for name, fn in real.items():
            setattr(ops, name, hook(name, fn))
        yield
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def record_ops(fn: Callable, *args, **kwargs) -> OpRecord:
    """Run ``fn(*args, **kwargs)`` once under the recorder and return its
    :class:`OpRecord` (the output is discarded). Not timed: the hooks and
    the dispatch mode cost host time on every op."""
    rec = _Recorder(top=True, expansions={})
    sites: list[KernelSite] = []
    with _kernel_sites(rec, sites), rec, torch.no_grad():
        fn(*args, **kwargs)
    hist, flops = Counter(rec.hist), rec.flops
    for func, decomp, margs, mkwargs, own, sig in rec.pending:
        h, fl = _expand(rec.expansions, func, decomp, margs, mkwargs, own, sig)
        hist.update(h)
        flops += fl
    return OpRecord(histogram=hist, matmul_flops=flops, sites=sites, bytes=rec.bytes)
