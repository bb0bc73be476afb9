"""Dependent-op chains: the paper's instruction table, as PyTorch steps.

Each :class:`OpSpec` row maps the chain carry ``x`` to the next carry through
the measured operation, ``step(x, *operands)``; latency is the slope between
two chain lengths (:meth:`Timer.slope`), which cancels the fixed cost of the
timed region. The rows, their inits, operands, guards and notes are those of
``repro.core.chains`` (the anti-optimization discipline is described there):
every operand is a runtime tensor, except the deliberate constant divisors of
the ``div.*.regular/irregular`` rows; idempotent or reassociable steps carry
``guard`` extra trivial ops, netted out at report time.

The registry holds all 72 rows. Seven have no PyTorch op: ``popc`` and
``clz``, the four uint32 divides and remainders (``div.u.*``, ``rem.u``;
PyTorch has no uint32 division) and ``mul64hi`` (nor a uint64 multiply).
Their step is one launch of the ``op_chain`` kernel (``OpSpec.kernel``
names its step), so they time the instruction itself and not an emulation
built from other ops. The 64-bit rows need no switch: PyTorch computes
int64 and float64 as such.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels.opchain import op_chain, op_chain_step

# steps to an iteration of op_chain's loop in the O3 rows (kernel_chain_fn)
KERNEL_CHAIN_UNROLL = 32

@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One row of the latency table."""

    name: str
    category: str
    dtype: str                     # dtype of the chain carry (a torch dtype name)
    step: Callable[..., torch.Tensor]  # (x, *operands) -> next x (dependent!)
    init: float | int              # initial carry value
    operands: tuple[float | int, ...] = ()   # runtime operand values
    guard: int = 0                 # number of extra trivial ALU ops inside step
    notes: str = ""
    max_chain: int | None = None   # cap chain length
    kernel: str | None = None      # op_chain step this row runs through, if any

    def _tensor(self, value: float | int, device: str | torch.device) -> torch.Tensor:
        # numpy makes the value exactly as the JAX package does (bfloat16,
        # which numpy lacks, is rounded by torch)
        if self.dtype == "bfloat16":
            return torch.tensor(value, dtype=torch.bfloat16, device=device)
        return torch.from_numpy(np.asarray(value, dtype=self.dtype)).to(device)

    def carry(self, device: str | torch.device) -> torch.Tensor:
        return self._tensor(self.init, device)

    def operand_tensors(self, device: str | torch.device) -> tuple[torch.Tensor, ...]:
        return tuple(self._tensor(v, device) for v in self.operands)


def chain_fn(spec: OpSpec, n: int) -> Callable[..., Any]:
    """Straight-line chain of length n (loop-free, like the paper's PTX
    bodies): ``torch.compile`` unrolls the Python loop into n dependent ops."""
    step = spec.step

    def chain(x, *ops):
        for _ in range(n):
            x = step(x, *ops)
        return x

    return chain


def kernel_chain_fn(spec: OpSpec, n: int) -> Callable[..., Any]:
    """The whole chain of an ``op_chain`` row as one kernel launch, 32
    straight-line steps to an iteration of the kernel's loop, so that the
    row times the steps and not the loop (as every other O3 row times a
    straight-line chain)."""
    if spec.kernel is None:
        raise ValueError(f"row {spec.name!r} has no op_chain step")
    return lambda x, *ops: op_chain(x, *ops, step=spec.kernel, n=n,
                                    unroll=KERNEL_CHAIN_UNROLL)


def _kernel_step(name: str) -> Callable[..., torch.Tensor]:
    """One step of an ``op_chain`` row: one kernel launch of length 1."""
    return lambda x, *ops: op_chain(x, *ops, step=name, n=1)


def operator_form(spec: OpSpec) -> OpSpec:
    """``spec`` with its step as one PyTorch operator where it runs through
    ``op_chain`` (``kernels.opchain.op_chain_step``, the same launch), so
    that Dynamo and AOTAutograd capture the step as one node (its O1 chain)
    and a trace of its ops sees the launch as one op (the audit); any other
    row is returned as it is."""
    if spec.kernel is None:
        return spec
    name = spec.kernel
    return dataclasses.replace(spec, step=lambda x, *ops: op_chain_step(x, list(ops), name))


def _trunc_div(x: torch.Tensor, d) -> torch.Tensor:
    # PTX div.s truncates like C; lax.div in the reference does the same
    return torch.div(x, d, rounding_mode="trunc")


def _f(name: str, cat: str, dt: str, step: Callable[..., Any], init: float,
       operands: tuple[float, ...] = (), guard: int = 0, notes: str = "",
       max_chain: int | None = None, kernel: str | None = None) -> OpSpec:
    return OpSpec(name, cat, dt, step, init, operands, guard, notes, max_chain, kernel)


def _int_ops() -> list[OpSpec]:
    i = functools.partial(_f, cat="int_arith", dt="int32")
    u = functools.partial(_f, cat="int_arith", dt="uint32")
    return [
        i("add", step=lambda x, a, b: (x + a) ^ b, init=1, operands=(3, 0x55),
          guard=1, notes="xor-guarded: int add chains reassociate"),
        i("sub", step=lambda x, a, b: (x - a) ^ b, init=1, operands=(3, 0x55),
          guard=1, notes="xor-guarded"),
        i("mul", step=lambda x, a, b: (x * a) ^ b, init=3, operands=(5, 0x55),
          guard=1, notes="xor-guarded"),
        i("mad", step=lambda x, a, b: (x * a + b) ^ a, init=3, operands=(5, 1),
          guard=1, notes="xor-guarded"),
        i("min", step=lambda x, a, b: torch.minimum(x, a) + b, init=1,
          operands=(7, 1), guard=1, notes="guarded: min is idempotent"),
        i("max", step=lambda x, a, b: torch.maximum(x, a) - b, init=1,
          operands=(7, 1), guard=1, notes="guarded: max is idempotent"),
        i("abs", step=lambda x, a: torch.abs(x - a), init=0, operands=(1,),
          guard=1, notes="guarded: abs is idempotent"),
        i("div.s.regular", step=lambda x, a: _trunc_div(x, 4) + a,
          init=9, operands=(7,), guard=1,
          notes="const pow-2 divisor -> strength-reduced to shift"),
        i("div.s.irregular", step=lambda x, a: _trunc_div(x, 5) + a,
          init=9, operands=(7,), guard=1, notes="const non-pow-2 divisor -> magic-number mul"),
        i("div.s.runtime", step=lambda x, a, b: _trunc_div(x, a) + b, init=9,
          operands=(5, 7), guard=1, notes="runtime divisor -> true divide"),
        # C's remainder (sign of the dividend), as lax.rem
        i("rem.s", step=lambda x, a, b: torch.fmod(x, a) + b, init=9, operands=(5, 7),
          guard=1),
        # PyTorch has no uint32 division: these four run through op_chain
        u("div.u.regular", step=_kernel_step("div.u.regular"), init=9, operands=(7,),
          guard=1, kernel="div.u.regular"),
        u("div.u.irregular", step=_kernel_step("div.u.irregular"), init=9,
          operands=(7,), guard=1, kernel="div.u.irregular"),
        u("div.u.runtime", step=_kernel_step("div.u.runtime"), init=9, operands=(5, 7),
          guard=1, kernel="div.u.runtime"),
        u("rem.u", step=_kernel_step("rem.u"), init=9, operands=(5, 7), guard=1,
          kernel="rem.u"),
    ]


def _logic_ops() -> list[OpSpec]:
    l = functools.partial(_f, cat="logic_shift", dt="int32")  # noqa: E741
    return [
        l("and", step=lambda x, a, b: (x & a) + b, init=0x55AA, operands=(0x0F0F, 3),
          guard=1, notes="add-guarded: and is idempotent/absorbing"),
        l("or", step=lambda x, a, b: (x | a) + b, init=0x55AA, operands=(0x0F0F, 3),
          guard=1, notes="add-guarded: or is idempotent/absorbing"),
        l("xor", step=lambda x, a, b: (x ^ a) + b, init=0x55AA, operands=(0x0F0F, 3),
          guard=1, notes="add-guarded: xor chains cancel pairwise"),
        l("not", step=lambda x, a: ~x + a, init=0x55AA, operands=(3,),
          guard=1, notes="add-guarded: not is involutive"),
        l("cnot", step=lambda x, a: (x == 0).to(torch.int32) + a, init=0, operands=(0,),
          guard=1, notes="PTX cnot: x==0 ? 1 : 0"),
        l("shl", step=lambda x, a, b: (x << a) | b, init=1, operands=(1, 1),
          guard=1, notes="or-guarded: shift-by-const chains merge"),
        l("shr", step=lambda x, a: (x >> a) | a, init=1 << 30, operands=(1,), guard=1),
    ]


def _float_ops(dt: str, cat: str) -> list[OpSpec]:
    f = functools.partial(_f, cat=cat, dt=dt)
    ops = [
        f(f"add.{dt}", step=lambda x, a: x + a, init=1.0, operands=(1e-3,)),
        f(f"sub.{dt}", step=lambda x, a: x - a, init=1.0, operands=(1e-3,)),
        f(f"mul.{dt}", step=lambda x, a: x * a, init=1.0, operands=(0.999,)),
        f(f"fma.{dt}", step=lambda x, a, b: x * a + b, init=1.0, operands=(0.5, 0.5)),
        f(f"min.{dt}", step=lambda x, a, b: torch.minimum(x, a) + b, init=0.0,
          operands=(2.0, 0.125), guard=1),
        f(f"max.{dt}", step=lambda x, a, b: torch.maximum(x, a) - b, init=4.0,
          operands=(2.0, 0.125), guard=1),
    ]
    if cat in ("fp32", "fp64"):
        ops += [
            f(f"div.regular.{dt}", step=lambda x, a: x / 4.0 + a, init=1.0, operands=(0.75,),
              guard=1, notes="const pow-2 divisor -> reciprocal multiply"),
            f(f"div.irregular.{dt}", step=lambda x, a: x / 3.0 + a, init=1.0, operands=(0.75,),
              guard=1, notes="const non-pow-2 divisor"),
            f(f"div.runtime.{dt}", step=lambda x, a, b: x / a + b, init=1.0,
              operands=(3.0, 0.75), guard=1, notes="runtime divisor -> true fdiv"),
        ]
    return ops


def _multi_precision_ops() -> list[OpSpec]:
    m = functools.partial(_f, cat="multi_precision", dt="int64")
    return [
        m("add.cc", step=lambda x, a, b: (x + a) ^ b, init=1, operands=(3, 0x55), guard=1,
          notes="64-bit add == add-with-carry chain on 32-bit lanes; xor-guarded"),
        m("sub.cc", step=lambda x, a, b: (x - a) ^ b, init=1, operands=(3, 0x55), guard=1),
        m("mad.cc", step=lambda x, a, b: (x * a + b) ^ a, init=3, operands=(5, 1), guard=1),
        m("mul.wide", step=lambda x, a, b: (x * a) ^ b, init=3, operands=(5, 0x55), guard=1),
        # no uint64 arithmetic in PyTorch: the widening multiply runs in op_chain
        _f("mul64hi", "multi_precision", "uint32", step=_kernel_step("mul64hi"),
           init=0xDEADBEEF, operands=(0x9E3779B9,), guard=2,
           notes="widening u32*u32->u64 high half; convert+shift guards",
           kernel="mul64hi"),
    ]


def _special_math_ops() -> list[OpSpec]:
    s = functools.partial(_f, cat="special_math", dt="float32")
    return [
        s("rcp", step=lambda x, a: 1.0 / x + a, init=2.0, operands=(0.5,), guard=1,
          notes="guarded: rcp is involutive"),
        s("sqrt", step=lambda x, a: torch.sqrt(x) + a, init=1.0, operands=(0.25,), guard=1),
        s("rsqrt", step=lambda x, a: torch.rsqrt(x) + a, init=1.0, operands=(0.25,), guard=1),
        s("sin", step=lambda x, a: torch.sin(x) + a, init=0.5, operands=(0.125,), guard=1),
        s("cos", step=lambda x: torch.cos(x), init=0.5, notes="cos has a stable fixed point"),
        s("lg2", step=lambda x, a: torch.log2(x + a), init=1.0, operands=(2.0,), guard=1),
        s("ex2", step=lambda x, a: torch.exp2(x) - a, init=0.0, operands=(1.0,), guard=1,
          notes="fixed point 0; |f'(0)| = ln2 < 1"),
        s("tanh", step=lambda x, a: torch.tanh(x) + a, init=0.0, operands=(0.125,), guard=1),
        s("copysign", step=lambda x, a, b: torch.copysign(x, a) + b, init=1.0,
          operands=(1.0, 1e-3), guard=1, notes="guarded: copysign is idempotent"),
    ]


def _int_intrinsic_ops() -> list[OpSpec]:
    t = functools.partial(_f, cat="int_intrinsic", dt="int32")
    tu = functools.partial(_f, cat="int_intrinsic", dt="uint32")
    return [
        t("sad", step=lambda x, a, b: torch.abs(x - a) + b, init=0, operands=(3, 1), guard=1,
          notes="PTX sad: |x-a|+b"),
        tu("popc", step=_kernel_step("popc"), init=0xF0F0F0F0,
           operands=(0xA5A5A5A5,), guard=1, kernel="popc"),
        tu("clz", step=_kernel_step("clz"), init=1, operands=(3,), guard=1, kernel="clz"),
        t("bfe", step=lambda x, a, b: ((x >> a) & 0xFFFF) + b, init=0x7FFF00, operands=(3, 9),
          guard=2, notes="bitfield extract: shift+mask"),
        t("bfi", step=lambda x, a, b: (x & ~0xFF) | (a & 0xFF) | b, init=0x55AA55,
          operands=(0xC3, 0), guard=2,
          notes="bitfield insert emulation; (a & 0xFF) is loop-invariant and "
                "CSE'd out of the chain, so only 2 guard ops execute per step"),
        t("mul24", step=lambda x, a: ((x & 0xFFFFFF) * (a & 0xFFFFFF)) & 0x7FFFFFFF,
          init=3, operands=(5,), guard=2,
          notes="24-bit multiply emulation; (a & 0xFFFFFF) is loop-invariant "
                "and CSE'd out of the chain, so only 2 guard ops execute"),
    ]


@functools.cache
def default_registry() -> tuple[OpSpec, ...]:
    """All 72 rows (paper Table II), in the reference registry's order."""
    ops = [*_int_ops(), *_logic_ops(), *_float_ops("float32", "fp32"),
           *_float_ops("float64", "fp64"), *_float_ops("bfloat16", "fp16"),
           *_float_ops("float16", "fp16"), *_multi_precision_ops(),
           *_special_math_ops(), *_int_intrinsic_ops()]
    names = [o.name for o in ops]
    assert len(names) == len(set(names)), "duplicate op names in registry"
    return tuple(ops)


def spec_by_name(name: str, registry: Sequence[OpSpec] | None = None) -> OpSpec:
    for spec in registry or default_registry():
        if spec.name == name:
            return spec
    raise KeyError(f"no registry row named {name!r}")


def kernel_baseline_spec() -> OpSpec:
    """The ``add`` row run through ``op_chain``'s ``add`` step: the in-kernel
    1-cycle-class baseline that nets the guard op of ``op_chain`` rows (their
    guard runs inside the kernel, so a dispatch-level baseline would net out
    a whole eager dispatch)."""
    add = spec_by_name("add")
    return dataclasses.replace(add, step=_kernel_step("add"), kernel="add")
