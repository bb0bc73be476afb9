"""The code the card runs, as the audit reads it: PTX and SASS.

The port's counterpart of the part of ``repro.core.hlo_analysis`` that the
JAX package's audit uses (``parse_module``, ``op_histogram``,
``dynamic_op_histogram``): where that package reads XLA's optimized HLO,
this module reads what the card runs.

* An O3 chain is a Triton kernel that Inductor generated. Its cubin sits in
  Triton's cache under the launcher's cache hash, with the PTX Triton kept
  beside it (:func:`triton_cubins`, :func:`triton_ptx`). The compile
  worker that built the chain reads both and hands them back with the
  chain's name (:func:`warm_and_read`, the compile pool's runner); the
  session files them under that name (:func:`remember`), where
  :func:`chain_artifacts` finds them; a compile cache keeps them beside
  Inductor's (``core.compile_cache``), where a later process finds them.
* K1-K3 are libraries that nvcc built (``kernels/_build.py``), with their
  PTX embedded beside the SASS: ``cuobjdump -ptx`` and ``-sass`` read them
  (:func:`library_ptx`, :func:`library_sass`).

PTX is SSA over virtual registers, so :func:`parse_ptx` turns a kernel into
instructions with the registers each defines and reads, which the
dependent-path walk follows. SASS is read by mnemonic
(:func:`sass_functions`, :func:`sass_mnemonics`) and, for the clock
sandwiches of K1-K3, with its registers (:func:`parse_sass`).
Nothing here runs at import; ``cuobjdump`` sits beside ``nvcc``, and where
it is missing :class:`ToolchainMissing` is raised.
"""
from __future__ import annotations

import dataclasses
import functools
import re
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Any

# ----------------------------------------------------------------- toolchain


class ToolchainMissing(RuntimeError):
    """No ``cuobjdump`` (or no built library) to read device code with."""


def cuobjdump() -> Path:
    """``cuobjdump`` beside ``nvcc`` (``kernels._build._nvcc``)."""
    from repro_torch.kernels import _build

    try:
        path = Path(_build._nvcc()).parent / "cuobjdump"
    except RuntimeError as e:
        raise ToolchainMissing(str(e)) from None
    if not path.exists():
        raise ToolchainMissing(f"no cuobjdump beside nvcc ({path})")
    return path


def _dump(flag: str, binary: Path) -> str:
    return subprocess.run([str(cuobjdump()), flag, str(binary)], capture_output=True,
                          text=True, check=True).stdout


# ---------------------------------------------------------------------- SASS
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/")
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_functions(binary: Path) -> dict[str, list[str]]:
    """Each function's SASS instruction lines in a shared library or cubin
    (``cuobjdump -sass``), by mangled name."""
    return sass_functions_of(_dump("-sass", binary))


def sass_functions_of(text: str) -> dict[str, list[str]]:
    """:func:`sass_functions` of ``cuobjdump -sass``'s text."""
    funcs = {}
    for block in text.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        funcs[name.strip()] = [ln for ln in body.splitlines() if _SASS_LINE.search(ln)]
    return funcs


def sass_mnemonics(body: list[str]) -> list[str]:
    """Each instruction's full mnemonic (HMMA.1688.F32.TF32, MUFU.EX2, ...)."""
    found = (_SASS_OP.search(ln) for ln in body)
    return [m.group(1) for m in found if m]


@dataclasses.dataclass(frozen=True)
class SassInstr:
    """One SASS instruction: its mnemonic and the registers it writes and
    reads (a ``.64`` operand names a register pair)."""

    mnemonic: str
    dests: tuple[str, ...]
    srcs: tuple[str, ...]


_SASS_REG = re.compile(r"\b(U?R\d+|U?P\d)(\.64)?\b")
# instructions that write no register named first (stores, branches, ...)
_SASS_NO_DEST = ("ST", "RED", "ATOM", "BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT",
                 "BAR", "BSYNC", "BSSY", "WARPSYNC", "MEMBAR", "NOP", "YIELD", "DEPBAR")


def _regs(operand: str) -> list[str]:
    out = []
    for name, wide in _SASS_REG.findall(operand):
        out.append(name)
        if wide and name[-1].isdigit():
            prefix = name.rstrip("0123456789")
            out.append(f"{prefix}{int(name[len(prefix):]) + 1}")
    return out


def parse_sass(body: list[str]) -> list[SassInstr]:
    """Each instruction of a function's SASS lines with its registers: the
    first operand (two predicates for a SETP, a pair for a WIDE or ``.64``
    result) is written, the rest read; a guard predicate is read."""
    out = []
    for ln in body:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?(U?P\w+)\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", ln)
        if not m:
            continue
        guard, mnemonic, rest = m.group(2), m.group(3), m.group(4)
        operands = [o.strip() for o in rest.split(",")] if rest.strip() else []
        srcs = [guard] if guard else []
        dests: list[str] = []
        if operands and not mnemonic.startswith(_SASS_NO_DEST):
            n_dest = 2 if "SETP" in mnemonic else 1
            for o in operands[:n_dest]:
                dests += _regs(o)
            wide = ".WIDE" in mnemonic
            if wide and dests and dests[0].startswith("R"):
                dests = _regs(operands[0] + ".64")
            operands = operands[n_dest:]
            if wide and operands and re.fullmatch(r"R\d+", operands[-1]):
                operands[-1] += ".64"  # the addend of a wide multiply-add is a pair
        for o in operands:
            srcs += _regs(o)
        drop = {"RZ", "PT", "URZ", "UPT"}
        out.append(SassInstr(mnemonic, tuple(d for d in dests if d not in drop),
                             tuple(s for s in srcs if s not in drop)))
    return out


# ----------------------------------------------------------------------- PTX
@dataclasses.dataclass(frozen=True)
class PtxInstr:
    """One PTX instruction: its opcode (``add.s32``, ``fma.rn.f32``), the
    virtual registers it defines and reads, the ``.param`` it loads
    (``ld.param``; a label's name for a ``label``) and its operands' text."""

    opcode: str
    dests: tuple[str, ...]
    srcs: tuple[str, ...]
    param: str = ""
    operands: str = ""


_PTX_REG = re.compile(r"%[A-Za-z_][\w]*")
_PTX_PARAM = re.compile(r"\[\s*([A-Za-z_$][\w$]*)\s*\]")
# opcodes with no destination operand
_PTX_NO_DEST = ("st.", "bra", "ret", "exit", "bar", "membar", "fence", "red.", "prefetch",
                "trap", "call", "@")


def ptx_functions(text: str) -> dict[str, str]:
    """The body of each ``.entry`` and ``.func`` in a PTX module, by name."""
    out = {}
    for m in re.finditer(r"\.(?:entry|func)\s+(?:\([^)]*\)\s*)?([\w$]+)", text):
        start = text.find("{", m.end())
        depth, i = 0, start
        while i < len(text):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        out[m.group(1)] = text[start + 1:i]
    return out


def _split_operands(rest: str) -> list[str]:
    """Top-level comma split (not inside ``{}`` or ``[]``)."""
    parts, depth, cur = [], 0, ""
    for ch in rest:
        if ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    return [p.strip() for p in parts]


def parse_ptx(body: str) -> list[PtxInstr]:
    """The instructions of one PTX function body, in program order:
    declarations, directives and comments dropped; a label becomes a
    ``label`` pseudo-instruction (its name in ``param``); a guard predicate
    (``@%p1``) is read; a ``setp``'s ``%p|%q`` are both defined."""
    lines = []
    for ln in re.sub(r"//[^\n]*", "", body).splitlines():
        ln = ln.strip()
        if ln and not ln.startswith((".loc", ".file", ".pragma")):
            lines.append(ln)
    out = []
    for stmt in " ".join(lines).split(";"):
        stmt = stmt.strip()
        while m := re.match(r"^(\{|\}|([\w$]+):)\s*", stmt):  # scopes and labels
            if m.group(2):
                out.append(PtxInstr("label", (), (), m.group(2)))
            stmt = stmt[m.end():]
        if not stmt or stmt.startswith("."):
            continue
        guard = re.match(r"^@!?(%\w+)\s+", stmt)
        srcs = [guard.group(1)] if guard else []
        if guard:
            stmt = stmt[guard.end():]
        opcode, _, rest = stmt.partition(" ")
        opcode = opcode.strip()
        if not re.match(r"^[a-z]", opcode):
            continue
        operands = _split_operands(rest.replace("\t", " "))
        dests: list[str] = []
        if operands and not opcode.startswith(_PTX_NO_DEST):
            dests = _PTX_REG.findall(operands[0])
            operands = operands[1:]
        for o in operands:
            srcs += _PTX_REG.findall(o)
        param = ""
        if opcode.startswith("ld.param"):
            m = _PTX_PARAM.search(rest)
            param = m.group(1) if m else ""
        out.append(PtxInstr(opcode, tuple(dests), tuple(srcs), param, rest.strip()))
    return out


# what a PTX opcode is counted as: its root and the modifiers that change
# the operation (not the rounding mode or flush-to-zero), with its type
_PTX_KEEP = {"lo", "hi", "wide", "approx", "full", "NaN", "sat", "cc", "rni", "rzi", "rmi",
             "rpi", "ftz_no"}


def ptx_op(opcode: str) -> str:
    """The opcode the audit counts: ``fma.rn.f32`` -> ``fma.f32``,
    ``mul.lo.s32`` -> ``mul.lo.s32``, ``setp.lt.s32`` -> ``setp.s32``,
    ``ld.global.b32`` -> ``ld.global``, ``cvt.rn.bf16.f32`` ->
    ``cvt.bf16.f32``."""
    parts = opcode.split(".")
    root = parts[0]
    if root in ("ld", "st"):
        return ".".join(parts[:2])
    if root == "cvt":
        types = [p for p in parts[1:] if re.match(r"^[usbf]\d+$|^bf16|^f16", p)]
        return ".".join(["cvt", *types])
    if root in ("setp", "set"):
        return f"{root}.{parts[-1]}"
    kept = [p for p in parts[1:-1] if p in _PTX_KEEP]
    return ".".join([root, *kept, parts[-1]]) if len(parts) > 1 else root


# never counted: data movement, addressing, control flow, declarations
PTX_STRUCTURAL = frozenset({"label", "ld", "st", "mov", "cvta", "ret", "bra", "bar", "exit",
                            "membar", "fence", "prefetch", "trap", "call", "activemask"})
# conversions: dtype plumbing, required to scale linearly, never matched
PTX_PLUMBING = frozenset({"cvt"})


def ptx_root(op: str) -> str:
    return op.split(".")[0]


def ptx_histogram(text: str) -> tuple[Counter, Counter]:
    """``(countable, plumbing)`` opcode histograms of every function of a
    PTX module (counted by :func:`ptx_op`)."""
    countable, plumbing = Counter(), Counter()
    for body in ptx_functions(text).values():
        for ins in parse_ptx(body):
            op = ptx_op(ins.opcode)
            root = ptx_root(op)
            if root in PTX_PLUMBING:
                plumbing[op] += 1
            elif root not in PTX_STRUCTURAL:
                countable[op] += 1
    return countable, plumbing


def ptx_branches(text: str) -> int:
    """Branches in a PTX module: a step that grows them takes a slow path."""
    return sum(ptx_root(ptx_op(i.opcode)) == "bra" for body in ptx_functions(text).values()
               for i in parse_ptx(body))


def dependent_path(instrs: list[PtxInstr], source: int) -> Counter:
    """Countable opcodes on the dependent path from instruction ``source``
    to the module's stores: each instruction that both depends on
    ``source`` (transitively, through the registers it reads) and feeds a
    ``st`` (transitively); the last definition of a register before a read
    is the one read."""
    last_def: dict[str, int] = {}
    deps: list[list[int]] = []
    for i, ins in enumerate(instrs):
        deps.append([last_def[r] for r in ins.srcs if r in last_def])
        for r in ins.dests:
            last_def[r] = i
    reach = [False] * len(instrs)
    reach[source] = True
    for i in range(source + 1, len(instrs)):
        reach[i] = any(reach[d] for d in deps[i])
    needed = [ins.opcode.startswith("st.") for ins in instrs]
    for i in range(len(instrs) - 1, -1, -1):
        if needed[i]:
            for d in deps[i]:
                needed[d] = True
    counts = Counter()
    for i, ins in enumerate(instrs):
        op = ptx_op(ins.opcode)
        root = ptx_root(op)
        if reach[i] and needed[i] and root not in PTX_STRUCTURAL and root not in PTX_PLUMBING:
            counts[op] += 1
    return counts


_PTX_ADDRESS = re.compile(r"\[([^\]]*)\]")


def carry_load(instrs: list[PtxInstr], param: str) -> int | None:
    """The load of a chain's carry: the one global load whose address
    derives from kernel parameter ``param``, the carry's pointer (through
    the ``ld.param`` that reads it and the address arithmetic after it).
    None when no global load, or more than one, reads through it."""
    derived: set[str] = set()
    loads = []
    for i, ins in enumerate(instrs):
        if ins.opcode.startswith("ld.param"):
            if ins.param == param:
                derived.update(ins.dests)
        elif ins.opcode.startswith("ld.global"):
            address = _PTX_ADDRESS.search(ins.operands)
            if address and derived & set(_PTX_REG.findall(address.group(1))):
                loads.append(i)
        elif not ins.opcode.startswith(("ld.", "st.", "setp")) and derived & set(ins.srcs):
            derived.update(ins.dests)
    return loads[0] if len(loads) == 1 else None


def carry_params(modules: list) -> dict[str, str]:
    """The PTX parameter of each Triton kernel in ``modules`` that holds its
    chain's carry, by kernel name (:func:`carry_params_of` over the
    generated wrappers' text and the kernels' signatures)."""
    from torch._inductor.runtime.triton_heuristics import CachingAutotuner

    signatures, wrappers = {}, []
    for mod in modules:
        for obj in vars(mod).values():
            if isinstance(obj, CachingAutotuner):
                name = obj.inductor_meta.get("kernel_name") or obj.fn.__name__
                signatures[name] = obj.triton_meta["signature"]
        path = getattr(mod, "__file__", None)
        if path and "def call(" in (text := Path(path).read_text()):
            wrappers.append(text)
    out = {}
    for text in wrappers:
        out.update(carry_params_of(text, signatures))
    return out


def carry_params_of(wrapper: str, signatures: dict[str, dict[str, str]]) -> dict[str, str]:
    """For each kernel that Inductor's wrapper (its source, ``wrapper``)
    launches with the compiled chain's first input (``arg0_1``, the carry:
    a chain's first argument), the PTX parameter it passes it in, by kernel
    name. Triton names a kernel's parameters ``<kernel>_param_<i>``, ``i``
    counting its arguments (``signatures[kernel]``, in order) less the
    compile-time constants. A kernel the carry does not reach as an
    argument (one after the first of a chain that was split) has none."""
    out = {}
    for m in re.finditer(r"\b(\w+)\.run\(([^)]*)\)", wrapper):
        kernel, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
        sig = signatures.get(kernel)
        if sig is None or "arg0_1" not in args:
            continue
        carry = list(sig)[args.index("arg0_1")]
        out[kernel] = f"{kernel}_param_{[a for a in sig if sig[a] != 'constexpr'].index(carry)}"
    return out


def root_is_constant(text: str) -> bool:
    """True when no store of the module depends on any parameter's data:
    the chain folded to a compile-time constant."""
    for body in ptx_functions(text).values():
        instrs = parse_ptx(body)
        loads = [i for i, ins in enumerate(instrs) if ins.opcode.startswith("ld.global")]
        for i in loads:
            if dependent_path_any(instrs, i):
                return False
    return True


def dependent_path_any(instrs: list[PtxInstr], source: int) -> bool:
    """Whether some store's value depends on instruction ``source``
    (address operands of the store excluded)."""
    last_def: dict[str, int] = {}
    reach = [False] * len(instrs)
    reach[source] = True
    for i, ins in enumerate(instrs):
        srcs = ins.srcs
        if ins.opcode.startswith("st."):
            srcs = srcs[-1:]  # the value stored, not the address
            if any(reach[last_def[r]] for r in srcs if r in last_def):
                return True
            continue
        if i > source and any(reach[last_def[r]] for r in srcs if r in last_def):
            reach[i] = True
        for r in ins.dests:
            last_def[r] = i
    return False


# ------------------------------------------------------- Triton chain code
def loaded_inductor_modules() -> list:
    """Every module Inductor's code cache has loaded in this process (the
    generated wrappers and their Triton kernels)."""
    from torch._inductor.codecache import PyCodeCache
    return [*PyCodeCache.modules, *PyCodeCache.modules_no_attr.values()]


def triton_cubins(modules: list) -> list[Path]:
    """The cubins of the Triton kernels that ``modules`` hold, found by each
    launcher's cache hash under Triton's cache directories."""
    from torch._inductor.runtime.triton_heuristics import CachingAutotuner
    try:
        from torch._inductor.runtime.cache_dir_utils import cache_dir, triton_cache_dir
    except ImportError:  # an older layout of the same helpers
        from torch._inductor.runtime.runtime_utils import cache_dir, triton_cache_dir
    roots = [Path(triton_cache_dir(0)), Path(cache_dir())]
    hashes = {launcher.cache_hash for mod in modules for obj in vars(mod).values()
              if isinstance(obj, CachingAutotuner) for launcher in obj.launchers}
    cubins = set()
    for h in hashes:
        found = sorted((roots[0] / h).glob("*.cubin")) or sorted(roots[1].rglob(f"{h}/*.cubin"))
        cubins.update(found)
    return sorted(cubins)


def triton_ptx(cubins: list[Path]) -> list[str]:
    """The PTX Triton keeps beside each cubin."""
    return [p.read_text() for c in cubins for p in sorted(c.parent.glob("*.ptx"))]


def read_modules(modules: list) -> dict[str, Any]:
    """What the audit reads of a chain: its Triton kernels' PTX texts
    (``"ptx"``), the parameter of each that holds the carry (``"carry"``,
    :func:`carry_params`), each SASS mnemonic's count over their cubins
    (``"sass"``) and the number of cubins (``"cubins"``)."""
    cubins = triton_cubins(modules)
    sass = Counter()
    for cubin in cubins:
        for body in sass_functions(cubin).values():
            sass.update(sass_mnemonics(body))
    return {"ptx": triton_ptx(cubins), "carry": carry_params(modules), "sass": dict(sass),
            "cubins": len(cubins)}


def warm_and_read(fn, *args) -> dict:
    """The compile pool's runner: a warm task (``measure.warm_chain``), then
    what the audit reads of the Triton kernels that task loaded
    (:func:`read_modules`), so that it is read once, in the worker (a task
    that went through a compile cache brings it already)."""
    started = time.time()
    before = {id(m) for m in loaded_inductor_modules()}
    result = fn(*args)
    if "ptx" not in result:
        result = {**result, **read_modules([m for m in loaded_inductor_modules()
                                            if id(m) not in before])}
    return {**result, "started_at": started, "done_at": time.time()}


# the device code of each chain a compile worker built, by its chain name
# (``measure.chain_name``), as read_modules gives it
_CHAINS: dict[str, dict[str, Any]] = {}


def remember(name: str, found: dict[str, Any]) -> None:
    """File what a compile worker handed back for a chain (its device code,
    :func:`read_modules`' fields, where it read it; its module) under the
    chain's name."""
    _CHAINS[name] = found


def compiled_chain(name: str) -> dict[str, Any] | None:
    """What a compile worker handed this process for chain ``name`` (its
    result: the module it compiled, ``"module"``, and the chain's result,
    ``"out"``, and its device code where it read it), or None."""
    return _CHAINS.get(name)


def chain_artifacts(name: str, cache: Any = None, key: tuple | None = None
                    ) -> dict[str, Any] | None:
    """The device code of chain ``name``: what a compile worker handed this
    process or this process compiled, else what compile cache ``cache``
    keeps under ``key`` (``measure.chain_cache_key``); None when neither
    has any."""
    found = _CHAINS.get(name)
    if found is not None and "ptx" not in found:
        found = None
    if found is None and cache is not None and key is not None:
        found = cache.peek_extra(key) or None
        if found is not None and "ptx" not in found:
            found = None
    return found


# ------------------------------------------------------------ K1-K3 libraries
@functools.cache
def library_ptx(lib: str) -> dict[str, str]:
    """Each function's PTX in kernel library ``lib`` (``cuobjdump -ptx``),
    by mangled name; built first if this build does not exist."""
    return ptx_functions(_dump("-ptx", _library_path(lib)))


@functools.cache
def library_sass(lib: str) -> dict[str, list[str]]:
    """Each function's SASS lines in kernel library ``lib``."""
    return sass_functions(_library_path(lib))


def _library_path(lib: str) -> Path:
    from repro_torch.kernels import _build

    cuobjdump()  # no toolchain: say so before trying to build
    return _build.build() / f"lib{lib}.so"
