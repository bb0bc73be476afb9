"""Per-op measurement (the paper's Section IV): the two-length slope.

The measurement is split in two, as in the JAX package:

* :func:`prepare_op` does everything compile-bound: builds the chain
  callables at both lengths and runs each once, which is when
  ``torch.compile`` compiles (and when the CUDA kernels are built and
  loaded); no timing;
* :func:`run_prepared_op` does everything device-bound: the two-length
  :meth:`Timer.slope` over the prepared callables.

The split lets the session's compile-ahead thread prepare probe N+1 while
probe N times. :func:`warm_chain` is the same compile run in a worker
process, which fills Inductor's on-disk cache so the in-process compile of
the same chain is a cache load.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.core import chains
from repro_torch.core.chains import OpSpec, chain_fn, kernel_chain_fn
from repro_torch.core.optlevels import compile_at_level
from repro_torch.core.timing import Measurement, Timer
from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device
from repro_torch.utils import block, logger

# Chain lengths per opt level: eager dispatch costs microseconds per op, so
# O0 uses short chains; long O3 chains push the per-op signal well above the
# clock's noise. The slope uses min statistics (noise floor).
_CHAIN_LENS = {"O0": (2, 10), "O1": (64, 512), "O3": (64, 512)}
_REPS = {"O0": 5, "O1": 30, "O3": 30}

# Widened-spread retry factor when a slope comes out non-positive: the new
# upper length is n1 + _RETRY_WIDEN * (n2 - n1), capped at the spec's
# max_chain (see Timer.slope).
_RETRY_WIDEN = 4


def retry_lens_for(spec: OpSpec, n1: int, n2: int) -> tuple[int, int]:
    """Capped widened chain spread for the noisy-slope retry; returns the
    original ``(n1, n2)`` (which disables the retry) when ``max_chain``
    leaves no room to widen."""
    widened = n1 + _RETRY_WIDEN * (n2 - n1)
    if spec.max_chain is not None:
        widened = min(widened, spec.max_chain)
    return (n1, widened) if widened > n2 else (n1, n2)


# Inductor options of the O3 chains of half-precision rows. By default
# Inductor computes a fused chain of bfloat16 or float16 ops in float32 and
# rounds once, at the store: ``x <- x + 1e-3`` from 1.0 gives 1.0625 after
# 64 steps in bfloat16, where eager and jax.jit round every step and stay at
# 1.0. Two options keep a rounding after every op. On the card,
# ``triton.codegen_upcast_to_fp32=False`` has Triton compute in the row's
# dtype: one correctly rounded half op equals eager's float32 op rounded to
# the half type (float32 holds more than 2p + 2 bits of either's p). A
# multiply-add step is the exception: LLVM contracts it into one HFMA2,
# which rounds once where eager rounds the product too, so the fma rows
# take ``emulate_precision_casts``, which keeps a cast after every op (and
# doubles the compile of a 512-op chain, PERF.md section 5). The CPU's code
# generator ignores the first option, so on the CPU every half row takes
# the second. No other row's kernel changes.
HALF_DTYPES = ("bfloat16", "float16")
HALF_O3_OPTIONS = {"triton.codegen_upcast_to_fp32": False}
CAST_O3_OPTIONS = {"emulate_precision_casts": True}
# What one step of each half row's O3 chain runs on an H100 (sm_90a, PyTorch
# 2.11), in the SASS of its Triton kernel; chip_smoke.py checks every
# mnemonic named here. Without the options a bfloat16 add step ran FADD.
HALF_O3_STEP_SASS = {
    "add.bfloat16": "HADD2.BF16_V2", "sub.bfloat16": "HADD2.BF16_V2",
    "mul.bfloat16": "HMUL2.BF16_V2", "fma.bfloat16": "HMUL2.BF16_V2+HADD2.BF16_V2",
    "min.bfloat16": "HSETP2.BF16_V2+SEL+HADD2.BF16_V2",
    "max.bfloat16": "HSETP2.BF16_V2+SEL+HADD2.BF16_V2",
    "add.float16": "HADD2", "sub.float16": "HADD2", "mul.float16": "HMUL2",
    "fma.float16": "HMUL2+HADD2", "min.float16": "HSETP2+SEL+HADD2",
    "max.float16": "HSETP2+SEL+HADD2",
}


def inductor_options(spec: OpSpec, device: str | torch.device) -> dict[str, Any] | None:
    """The Inductor options of ``spec``'s O3 chain on ``device`` beyond the
    defaults (the session and the compile workers both compile through
    :func:`compile_chain`, so they share one cache key)."""
    if spec.dtype not in HALF_DTYPES:
        return None
    if torch.device(device).type == "cuda" and not spec.name.startswith("fma."):
        return HALF_O3_OPTIONS
    return CAST_O3_OPTIONS


def compile_chain(spec: OpSpec, n: int, opt_level: str,
                  device: str | torch.device = "cuda") -> Callable[..., Any]:
    """One chain callable of length ``n`` at ``opt_level`` for tensors on
    ``device``.

    Rows with an ``op_chain`` step launch the kernel once per step at O0 and
    O1 and once for the whole chain at O3; every other row is eager at O0
    and ``torch.compile``\\ d at O1 and O3 (compiled at its first call, with
    :func:`inductor_options` at O3). An O1 chain compiles in this process
    and is kept for it (:func:`chain_name` keys it): a second call returns
    the same callable, compiled once.
    """
    if spec.kernel is not None and opt_level == "O0":
        return chain_fn(spec, n)
    if spec.kernel is not None and opt_level == "O3":
        return kernel_chain_fn(spec, n)
    name = chain_name(spec.name, n)
    if opt_level == "O1":
        key = (name, torch.device(device).type)
        if key not in _O1_CHAINS:
            fn = compile_at_level(chain_fn(chains.operator_form(spec), n), "O1", name=name)
            _O1_CHAINS[key] = GraphedChain(fn) if torch.device(device).type == "cuda" else fn
        return _O1_CHAINS[key]
    return compile_at_level(chain_fn(spec, n), opt_level, name=name,
                            options=inductor_options(spec, device))


# the O1 chains compiled in this process, by chain_name and device type
_O1_CHAINS: dict[tuple[str, str], Callable[..., Any]] = {}


class GraphedChain:
    """An O1 chain on the card, its graph's kernels replayed from one CUDA
    graph. The graph AOTAutograd traced runs one kernel an op (512 steps of
    two ops are 1024 launches): more than a stream holds while the timer's
    lead kernel runs, so launched one by one the host would pace the card
    and the events would time the host. Captured once (:meth:`capture`, at
    the first call if not before), the same kernels replay back to back
    from one launch. Each call copies its arguments into the captured
    inputs and returns the captured output (overwritten by the next call).

    A replay runs no kernel wrapper, so it adds to the launch counts
    (``kernels.ops.launch_counts``) what the capture recorded; the warm-up
    and the capture themselves leave the counts as they were."""

    def __init__(self, fn: Callable[..., Any]):
        self.fn = fn
        self.graph = None
        self.inputs: tuple = ()
        self.output = None
        self.replay_launches: dict[str, int] = {}

    def capture(self, *args: torch.Tensor) -> None:
        """Compile (if not yet), warm up and capture the chain on ``args``."""
        before = ops.launch_counts()
        self.inputs = tuple(a.clone() for a in args)
        stream = torch.cuda.Stream(args[0].device)
        stream.wait_stream(torch.cuda.current_stream(args[0].device))
        with torch.cuda.stream(stream):
            self.fn(*self.inputs)  # compile (if not yet) and warm up
        torch.cuda.current_stream(args[0].device).wait_stream(stream)
        warmed = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.output = self.fn(*self.inputs)
        self.replay_launches = ops.launches_since(warmed)
        ops.add_launches({k: -n for k, n in ops.launches_since(before).items()})

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            self.capture(*args)
        for mine, a in zip(self.inputs, args):
            if mine is not a:
                mine.copy_(a)
        self.graph.replay()
        ops.add_launches(self.replay_launches)
        return self.output


def chain_name(row: str, n: int) -> str:
    """The name of row ``row``'s compiled chain of length ``n`` (its code
    object's, its Inductor kernel's prefix, its O1 graph's key)."""
    return "chain_" + "".join(c if c.isalnum() else "_" for c in row) + f"_{n}"


def prepare_o1_chain(name: str, n: int, device: str) -> None:
    """Compile row ``name``'s O1 chain of length ``n`` in this process for
    ``device`` (on the card, capture its graph too; nothing is replayed), so
    that a session's ``prepare`` of the row at O1 finds it ready; a task a
    session runs while it waits on its compile workers
    (``CompilePool.local``)."""
    spec = chains.spec_by_name(name)
    fn = compile_chain(spec, n, "O1", device)
    args = (spec.carry(device), *spec.operand_tensors(device))
    if isinstance(fn, GraphedChain):
        fn.capture(*args)
    else:
        _first_call(fn, *args)


def _first_call(fn: Callable[..., Any], *args: Any) -> None:
    """Run ``fn`` once, so that it compiles or builds now, and wait for it."""
    block(fn(*args))


@dataclasses.dataclass
class PreparedOp:
    """Everything :func:`run_prepared_op` needs; produced off the timing
    thread by :func:`prepare_op`."""

    spec: OpSpec
    opt_level: str
    lens: tuple[int, int]
    retry_lens: tuple[int, int]
    reps: int
    carry: torch.Tensor
    operands: tuple
    device: torch.device
    _fns: dict[int, Callable]

    def fn_by_len(self, n: int) -> Callable:
        """Memoized chain callable, compiled at first use (the widened retry
        length compiles lazily)."""
        if n not in self._fns:
            t0 = time.perf_counter()
            fn = compile_chain(self.spec, n, self.opt_level, self.device)
            _first_call(fn, self.carry, *self.operands)
            logger.debug("compiled %s@%s n=%d in %.2f s", self.spec.name,
                         self.opt_level, n, time.perf_counter() - t0)
            self._fns[n] = fn
        return self._fns[n]


def prepare_op(spec: OpSpec, opt_level: str = "O3",
               device: str | torch.device | None = None) -> PreparedOp:
    """Build and compile the two chain callables for ``spec`` on ``device``
    (default ``cuda:0``, see ``resolve_device``); no timing."""
    device = resolve_device(device)
    n1, n2 = _CHAIN_LENS[opt_level]
    if spec.max_chain is not None:
        n1, n2 = min(n1, spec.max_chain // 3), min(n2, spec.max_chain)
    # No widened retry for an Inductor chain at O3 on the card: events
    # behind the lead resolve every chain that holds its n steps there, so a
    # non-positive slope means the compiler folded the chain, which a 4x
    # longer chain cannot change; and compiling that chain (1856 ops) takes
    # minutes (88 s for `not` on an H100's host).
    retry = ((n1, n2) if device.type == "cuda" and opt_level == "O3" and spec.kernel is None
             else retry_lens_for(spec, n1, n2))
    prepared = PreparedOp(spec=spec, opt_level=opt_level, lens=(n1, n2),
                          retry_lens=retry,
                          reps=_REPS[opt_level], carry=spec.carry(device),
                          operands=spec.operand_tensors(device), device=device,
                          _fns={})
    prepared.fn_by_len(n1)
    prepared.fn_by_len(n2)
    return prepared


def run_prepared_op(prepared: PreparedOp, timer: Timer) -> Measurement:
    """Time a :class:`PreparedOp`: the device-serial half of the split."""
    return timer.slope(prepared.fn_by_len, *prepared.lens,
                       prepared.carry, *prepared.operands,
                       reps=prepared.reps, retry_lens=prepared.retry_lens)


def measure_op(spec: OpSpec, opt_level: str, timer: Timer) -> float:
    """Per-op latency in ns at ``opt_level`` on the timer's device: the serial
    form of the split, ``run_prepared_op(prepare_op(...))``."""
    m = run_prepared_op(prepare_op(spec, opt_level, timer.device), timer)
    return max(m.median_ns, 0.0)


def compile_phases() -> dict[str, float]:
    """Seconds this process has spent so far in each compile phase that
    Dynamo and Inductor time (``torch._dynamo.utils.compilation_time_metrics``:
    the Dynamo trace, the backend, Inductor's lowering, code generation,
    the Triton compiles...), summed per phase name."""
    from torch._dynamo.utils import compilation_time_metrics
    return {k: float(sum(v)) for k, v in compilation_time_metrics.items()}


def warm_chain(name: str, opt_level: str, n: int, device: str) -> dict[str, Any]:
    """Compile the chain of registry row ``name`` at length ``n`` in this
    process and run it once. A worker process runs this to fill Inductor's
    on-disk cache ahead of the session. Returns the chain's name
    (``"chain"``, :func:`chain_name`), the seconds it took (``"s"``), the
    seconds of each compile phase that moved (``"phases"``, from
    :func:`compile_phases`) and the chain's result (``"out"``, a Python
    number)."""
    before = compile_phases()
    t0 = time.perf_counter()
    spec = chains.spec_by_name(name)
    fn = compile_chain(spec, n, opt_level, device)
    out = fn(spec.carry(device), *spec.operand_tensors(device))
    block(out)
    seconds = time.perf_counter() - t0
    phases = {k: v - before.get(k, 0.0) for k, v in compile_phases().items()}
    return {"chain": chain_name(name, n), "s": seconds,
            "phases": {k: v for k, v in phases.items() if v > 0.0}, "out": out.item()}
