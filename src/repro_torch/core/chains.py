"""Dependent-op chains: the paper's instruction table, as PyTorch steps.

Each :class:`OpSpec` row maps the chain carry ``x`` to the next carry through
the measured operation, ``step(x, *operands)``; latency is the slope between
two chain lengths (:meth:`Timer.slope`), which cancels the fixed cost of the
timed region. The rows, their inits, operands, guards and notes are those of
``repro.core.chains`` (the anti-optimization discipline is described there):
every operand is a runtime tensor, except the deliberate constant divisors of
the ``div.*.regular/irregular`` rows; idempotent or reassociable steps carry
``guard`` extra trivial ops, netted out at report time.

This slice holds the 15 rows of the quick plan. Two of them, ``popc`` and
``clz``, have no PyTorch op: their step is one launch of the ``op_chain``
kernel (``OpSpec.kernel`` names its step), so they time the instruction
itself and not an emulation built from other ops.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels.opchain import op_chain

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


def _trunc_div(x: torch.Tensor, d) -> torch.Tensor:
    # PTX div.s truncates like C; lax.div in the reference does the same
    return torch.div(x, d, rounding_mode="trunc")


def _f(name: str, cat: str, dt: str, step: Callable[..., Any], init: float,
       operands: tuple[float, ...] = (), guard: int = 0, notes: str = "",
       max_chain: int | None = None, kernel: str | None = None) -> OpSpec:
    return OpSpec(name, cat, dt, step, init, operands, guard, notes, max_chain, kernel)


@functools.cache
def default_registry() -> tuple[OpSpec, ...]:
    """The rows ported so far, in the reference registry's order."""
    i = functools.partial(_f, cat="int_arith", dt="int32")
    f = functools.partial(_f, cat="fp32", dt="float32")
    s = functools.partial(_f, cat="special_math", dt="float32")
    t = functools.partial(_f, cat="int_intrinsic", dt="uint32")
    ops = [
        i("add", step=lambda x, a, b: (x + a) ^ b, init=1, operands=(3, 0x55),
          guard=1, notes="xor-guarded: int add chains reassociate"),
        i("mul", step=lambda x, a, b: (x * a) ^ b, init=3, operands=(5, 0x55),
          guard=1, notes="xor-guarded"),
        i("mad", step=lambda x, a, b: (x * a + b) ^ a, init=3, operands=(5, 1),
          guard=1, notes="xor-guarded"),
        i("div.s.regular", step=lambda x, a: _trunc_div(x, 4) + a,
          init=9, operands=(7,), guard=1,
          notes="const pow-2 divisor -> strength-reduced to shift"),
        i("div.s.irregular", step=lambda x, a: _trunc_div(x, 5) + a,
          init=9, operands=(7,), guard=1, notes="const non-pow-2 divisor -> magic-number mul"),
        i("div.s.runtime", step=lambda x, a, b: _trunc_div(x, a) + b, init=9,
          operands=(5, 7), guard=1, notes="runtime divisor -> true divide"),
        f("fma.float32", step=lambda x, a, b: x * a + b, init=1.0, operands=(0.5, 0.5)),
        f("div.runtime.float32", step=lambda x, a, b: x / a + b, init=1.0,
          operands=(3.0, 0.75), guard=1, notes="runtime divisor -> true fdiv"),
        _f("add.bfloat16", "fp16", "bfloat16", step=lambda x, a: x + a, init=1.0,
           operands=(1e-3,)),
        s("sqrt", step=lambda x, a: torch.sqrt(x) + a, init=1.0, operands=(0.25,), guard=1),
        s("rsqrt", step=lambda x, a: torch.rsqrt(x) + a, init=1.0, operands=(0.25,), guard=1),
        s("sin", step=lambda x, a: torch.sin(x) + a, init=0.5, operands=(0.125,), guard=1),
        s("ex2", step=lambda x, a: torch.exp2(x) - a, init=0.0, operands=(1.0,), guard=1,
          notes="fixed point 0; |f'(0)| = ln2 < 1"),
        t("popc", step=_kernel_step("popc"), init=0xF0F0F0F0,
          operands=(0xA5A5A5A5,), guard=1, kernel="popc"),
        t("clz", step=_kernel_step("clz"), init=1, operands=(3,), guard=1, kernel="clz"),
    ]
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
