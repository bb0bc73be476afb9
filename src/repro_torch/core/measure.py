"""Per-op measurement (the paper's Section IV): the two-length slope.

The measurement is split in two, as in the JAX package:

* :func:`prepare_op` does everything compile-bound: builds the chain
  callables at both lengths and runs each once, which is when
  ``torch.compile`` compiles (and when the CUDA kernels are built and
  loaded); no timing;
* :func:`run_prepared_op` does everything device-bound: the two-length
  :meth:`Timer.slope` over the prepared callables.

The split lets the session time probe N while its compile workers build
the chains of the probes after it. :func:`warm_chain` is the same compile
run in a worker process, which fills Inductor's on-disk cache so the
in-process compile of the same chain is a cache load; the session then
runs the chain from the module the worker compiled (:func:`load_chain`,
:func:`compiled_module`). With a
:class:`~repro_torch.core.compile_cache.CompileCache` an O3 Inductor chain
goes through the cache, keyed by :func:`chain_cache_key`, and its entry
keeps what the audit reads of it and the module it runs from.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import chains
from repro_torch.core.chains import OpSpec, chain_fn, kernel_chain_fn
from repro_torch.core.compile_cache import ROOT_ENV, CompileCache, fidelity_key
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


def _first_call(fn: Callable[..., Any], *args: Any) -> Any:
    """Run ``fn`` once, so that it compiles or builds now, wait for it and
    return its result."""
    out = fn(*args)
    block(out)
    return out


def cacheable(spec: OpSpec, opt_level: str) -> bool:
    """Whether ``spec``'s chain at ``opt_level`` goes through a compile
    cache: the Inductor chains of O3 (O0 compiles nothing, O1 compiles in
    seconds and keeps no device code, and K2's chains are nvcc's build)."""
    return opt_level == "O3" and spec.kernel is None


def chain_cache_key(spec: OpSpec, n: int, opt_level: str, env: Mapping[str, str]) -> tuple:
    """The :class:`CompileCache` key of one chain compile, shared with the
    audit (``audit --compile-cache`` reads the chain's device code under
    it)."""
    return fidelity_key(env, spec.name, opt_level, spec.dtype, f"chain{n}")


def _device_code(device: torch.device, before: set[int]) -> dict[str, Any]:
    """What the audit and a later load read of the Inductor modules loaded
    since ``before`` (ids of ``artifacts.loaded_inductor_modules``): their
    Triton kernels' device code on the card (nothing on the CPU), and the
    compiled wrapper module (``"module"``, :func:`compiled_module`)."""
    from repro_torch.audit import artifacts

    new = [m for m in artifacts.loaded_inductor_modules() if id(m) not in before]
    code = (artifacts.read_modules(new) if device.type == "cuda"
            else {"ptx": [], "carry": {}, "sass": {}, "cubins": 0})
    module = _wrapper_module(new)
    if module is not None:
        code["module"] = module
    return code


def _wrapper_module(modules: list) -> dict[str, str] | None:
    """The compiled wrapper module among Inductor's ``modules`` (the one
    whose ``call`` runs the chain): its key and its path under Inductor's
    cache directory (:func:`compiled_module`'s ``info``)."""
    from torch._inductor.runtime.cache_dir_utils import cache_dir

    wrapper = next((m for m in modules if callable(getattr(m, "call", None))
                    and getattr(m, "__file__", None)), None)
    if wrapper is None:
        return None
    path = os.path.relpath(wrapper.__file__, cache_dir())
    return {"key": getattr(wrapper, "key", None)
            or os.path.splitext(os.path.basename(wrapper.__file__))[0],
            "path": wrapper.__file__ if path.startswith("..") else path}


def compiled_module(info: Mapping[str, str]) -> Callable[..., Any] | None:
    """The chain that Inductor compiled into the wrapper module ``info``
    names (``{"key", "path"}``, the path under Inductor's cache directory),
    loaded from Inductor's code cache with no trace and no compile: what a
    chain's ``torch.compile`` serves on a cache hit, without Dynamo's and
    AOTAutograd's tracing of the chain again (1-5 s a 512-op chain beside
    the compile workers). The callable takes the chain's arguments and
    returns its result; None when the module is not there."""
    from torch._inductor import config
    from torch._inductor.codecache import PyCodeCache
    from torch._inductor.runtime.cache_dir_utils import cache_dir

    path = os.path.join(cache_dir(), info["path"])  # an absolute path stays itself
    if not os.path.exists(path):
        return None
    try:
        with config.patch(compile_threads=1):  # its Triton kernels load here
            call = PyCodeCache.load_by_key_path(info["key"], path).call
    except Exception as e:  # noqa: BLE001 - the chain compiles instead
        logger.debug("compiled module %s did not load: %s: %s", path, type(e).__name__, e)
        return None

    def chain(*args: torch.Tensor) -> torch.Tensor:
        return call(list(args))[0]
    return chain


def _same(out: Any, want: Any) -> bool:
    """Whether a chain's result equals ``want`` (a Python number; NaN
    equals NaN)."""
    got = out.item()
    return got == want or (got != got and want != want)


def load_chain(spec: OpSpec, n: int, opt_level: str, device: torch.device, args: tuple,
               cache: CompileCache | None = None, env: Mapping[str, str] | None = None,
               count: bool = True) -> tuple[Callable[..., Any], Any, bool | None]:
    """Chain ``spec`` of length ``n`` at ``opt_level`` on ``device``, run once
    on ``args``: ``(its callable, its result, whether it was a compile cache
    hit)`` (None without a cache or for a chain no cache keeps).

    An O3 Inductor chain that a compile worker of this run built (its
    result filed by ``artifacts.remember``), or that ``cache`` keeps, runs
    from the wrapper module Inductor compiled (:func:`compiled_module`),
    once its result equals the one recorded beside it; any other chain
    compiles here (``torch.compile``, through ``cache``: its entry keeps the
    chain's device code and its module). A chain served from the cache's
    entry is a hit; one compiled is a miss; one a worker built counts as
    the worker's lookup (``CompileCache.note``). With ``count`` False the
    cache is only read: nothing is counted or stored (a session's guard
    baseline, which is no probe of the plan)."""
    from repro_torch.audit import artifacts

    name = chain_name(spec.name, n)
    key = (chain_cache_key(spec, n, opt_level, env)
           if cache is not None and env is not None and cacheable(spec, opt_level) else None)
    if cacheable(spec, opt_level):
        worker = artifacts.compiled_chain(name)
        entry = cache.peek_extra(key) if key is not None else None
        for found in (entry, worker):
            fn = compiled_module(found["module"]) if found and found.get("module") else None
            if fn is None:
                continue
            out = _first_call(fn, *args)
            if not _same(out, found.get("out")):
                logger.warning("%s: its compiled module gave %r, its compile %r; compiling it "
                               "here", name, out.item(), found.get("out"))
                if found is entry and count:
                    cache.discard(key)  # stale: the compile below stores it anew
                continue
            hit = None
            if key is not None and count:
                hit = cache.served(key, entry_read=found is entry)
                if found is worker and entry is None:
                    cache.store(key, dict(worker))
            if found is entry and device.type == "cuda":
                artifacts.remember(name, entry)
            return fn, out, hit
    fn = compile_chain(spec, n, opt_level, device)
    if key is None or not count:
        return fn, _first_call(fn, *args), None
    before = {id(m) for m in artifacts.loaded_inductor_modules()}
    out, code, hit = cache.load_or_compile(
        key, lambda: _first_call(fn, *args),
        extra=lambda out: {**_device_code(device, before), "out": out.item()})
    if code is not None and device.type == "cuda":
        artifacts.remember(name, code)
    return fn, out, hit


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
    _cache: CompileCache | None = None
    _env: Mapping[str, str] | None = None
    _count: bool = True

    def fn_by_len(self, n: int) -> Callable:
        """Memoized chain callable, compiled at first use (the widened retry
        length compiles lazily), through the compile cache if there is one."""
        if n not in self._fns:
            t0, before = time.perf_counter(), compile_phases()
            fn, _, _ = load_chain(self.spec, n, self.opt_level, self.device,
                                  (self.carry, *self.operands), self._cache, self._env,
                                  self._count)
            moved = sorted(((v - before.get(k, 0.0), k) for k, v in compile_phases().items()
                            if v - before.get(k, 0.0) > 0.05), reverse=True)
            logger.debug("compiled %s@%s n=%d in %.2f s (%s)", self.spec.name,
                         self.opt_level, n, time.perf_counter() - t0,
                         ", ".join(f"{k} {v:.2f}" for v, k in moved[:6]))
            self._fns[n] = fn
        return self._fns[n]


def prepare_op(spec: OpSpec, opt_level: str = "O3",
               device: str | torch.device | None = None,
               cache: CompileCache | None = None,
               env: Mapping[str, str] | None = None, count: bool = True) -> PreparedOp:
    """Build and compile the two chain callables for ``spec`` on ``device``
    (default ``cuda:0``, see ``resolve_device``), through ``cache`` (keyed
    by ``env``; ``count`` as :func:`load_chain` takes it) where given; no
    timing."""
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
                          _fns={}, _cache=cache, _env=env, _count=count)
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
    number) and, for an O3 Inductor chain, the wrapper module Inductor
    compiled (``"module"``, which the session loads the chain from). In a
    worker of a compile cache's pool (``compile_cache.ROOT_ENV`` set) the
    compile goes through that cache (:func:`load_chain`): the result also
    holds the entry's key (``"cache_key"``), whether it was a hit
    (``"cache_hit"``) and the entry (the chain's device code,
    ``audit.artifacts.read_modules``' fields, and its module)."""
    from repro_torch.audit import artifacts
    from repro_torch.core.latency_db import current_environment

    before = compile_phases()
    t0 = time.perf_counter()
    spec = chains.spec_by_name(name)
    args = (spec.carry(device), *spec.operand_tensors(device))
    root = os.environ.get(ROOT_ENV)
    cache = CompileCache(root) if root else None
    env = current_environment(device) if cache is not None else None
    loaded = {id(m) for m in artifacts.loaded_inductor_modules()}
    fn, out, hit = load_chain(spec, n, opt_level, torch.device(device), args, cache, env)
    seconds = time.perf_counter() - t0
    phases = {k: v - before.get(k, 0.0) for k, v in compile_phases().items()}
    result = {"chain": chain_name(name, n), "s": seconds,
              "phases": {k: v for k, v in phases.items() if v > 0.0}, "out": out.item()}
    if hit is not None:
        entry = cache.peek_extra(chain_cache_key(spec, n, opt_level, env)) or {}
        result.update(entry, cache_key=list(chain_cache_key(spec, n, opt_level, env)),
                      cache_hit=hit)
    elif cacheable(spec, opt_level):
        module = _wrapper_module([m for m in artifacts.loaded_inductor_modules()
                                  if id(m) not in loaded])
        if module is not None:
            result["module"] = module
    return result
