"""Dataflow certificates for K1-K3's timed forms: look inside the kernel.

The port's counterpart of the K1-K3 half of ``repro.audit.dataflow``. The
JAX package opens each Pallas kernel's jaxpr; here the artifact is the
SASS the card runs, read from the built libraries (``cuobjdump -sass``).
Each timed form is the paper's clock sandwich: every thread reads
``%clock64`` right before and right after its chain, and the slope
between two straight-line instances (one a length) is the row's number.
From the SASS between the two clock reads at both lengths this module
certifies the three properties that slope rests on:

**serialization**
    The chain is one dependent path: the longest def-use path between the
    reads grows by at least one instruction a step (a chain split into
    independent parts, or folded, does not), no loop lies between the
    reads (the branches there are a step's own: as many a step at both
    lengths), and for the chase every step's load takes its address from
    the load before it (the loads on that path equal the steps).

**residency**
    The chase's ring is in the space the row names: ``space=smem`` loads by
    LDS, ``space=global`` by LDG and never LDS.

**signature**
    What one step runs, the instructions between the reads at the longer
    length less those at the shorter over the steps between, is at least
    one instruction (a chain ptxas folded holds none), and for K1 it is the
    op's own instruction once a step.

Success is ``audited`` (the compiled kernel was opened, not just matched),
as in the JAX package. ``audit_fused`` and the fused-kernel signature
registry are not ported yet (the ``inkernel.fused.*`` rows come back
``unaudited:fused-signature-not-ported``).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from collections import Counter
from typing import Sequence

from repro_torch.audit import artifacts
from repro_torch.audit.chain_check import ChainVerdict, k2_struct

BRANCHES = ("BRA", "BRX", "JMP", "JMX", "CALL")
# what a step of K1's chain runs: its op's instruction, once a step
KERNEL_STEP_SASS = {"fma": "FFMA", "add": "FADD", "mul": "FMUL"}
ALU_OPS = ("fma", "add", "mul", "rsqrt", "exp")  # kernels.alu_chain.OPS
CHASE_LOADS = {"smem": "LDS", "global": "LDG"}


@dataclasses.dataclass(frozen=True)
class RegionCert:
    """What lies between a timed instance's two clock reads."""

    mnemonics: Counter   # each instruction's count
    depth: int           # instructions on the longest def-use path
    loads: int           # loads on the longest chain of dependent loads
    branches: int        # branch instructions
    reads: tuple[int, ...]  # where the clock reads are (instruction index)


def _is_load(mnemonic: str) -> bool:
    """A load from memory (not from the constant bank: LDC, ULDC)."""
    return mnemonic.split(".")[0] in ("LD", "LDG", "LDS", "LDL")


def region_cert(body: list[str], load_prefix: str = "LD") -> RegionCert | None:
    """Certify the SASS between the middle pair of clock reads of one timed
    instance, or None when the reads are missing or unpaired."""
    reads = [i for i, ln in enumerate(body) if "SR_CLOCK" in ln]
    if not reads or len(reads) % 2:
        return None
    lo, hi = reads[len(reads) // 2 - 1], reads[len(reads) // 2]
    instrs = artifacts.parse_sass(body[lo + 1:hi])
    last: dict[str, int] = {}
    depth: list[int] = []
    loads: list[int] = []
    for i, ins in enumerate(instrs):
        prev = [last[r] for r in ins.srcs if r in last]
        is_load = _is_load(ins.mnemonic) and ins.mnemonic.startswith(load_prefix)
        depth.append(1 + max((depth[p] for p in prev), default=0))
        loads.append(int(is_load) + max((loads[p] for p in prev), default=0))
        for r in ins.dests:
            last[r] = i
    mn = Counter(ins.mnemonic for ins in instrs)
    return RegionCert(mnemonics=mn, depth=max(depth, default=0), loads=max(loads, default=0),
                      branches=sum(c for m, c in mn.items() if m.split(".")[0] in BRANCHES),
                      reads=tuple(reads))


def per_step(certs: Sequence[RegionCert], lens: Sequence[int]) -> dict[str, float]:
    """What one step runs: each mnemonic's count at the longer length less
    that at the shorter, over the steps between (positive counts only)."""
    (c1, c2), (n1, n2) = certs, lens
    delta = {m: (c2.mnemonics[m] - c1.mnemonics[m]) / (n2 - n1)
             for m in c1.mnemonics | c2.mnemonics}
    return {m: d for m, d in sorted(delta.items(), key=lambda kv: -kv[1]) if d > 0}


def _audited(op: str, opt_level: str, detail: str) -> ChainVerdict:
    return ChainVerdict(op, opt_level, "audited", detail=detail)


def _transformed(op: str, opt_level: str, cause: str, detail: str = "") -> ChainVerdict:
    return ChainVerdict(op, opt_level, "transformed", cause=cause, detail=detail)


def _fmt(step: dict[str, float]) -> str:
    return "+".join(f"{m}x{c:g}" for m, c in step.items()) or "(none)"


def _chain_pair_verdict(op: str, opt_level: str, certs: Sequence[RegionCert],
                        lens: Sequence[int], *, space: str | None = None,
                        step_op: str | None = None) -> ChainVerdict:
    """The uniform two-length chain certificate: both instances serialized,
    residency-clean, and the length delta exactly the slope's steps.

    ``space`` (chase rows): every step one load from that space, on one
    chain of dependent loads. ``step_op`` (K1): a step is that instruction
    once, the chain of them one path."""
    (n1, n2), (c1, c2) = tuple(lens), tuple(certs)
    step = per_step(certs, lens)
    total = sum(step.values())
    if total < 1.0:  # the kernel still stores what it loaded: its steps were removed
        return _transformed(op, opt_level, "dead-code-eliminated",
                            f"{total:g} SASS instructions a step (lens {n1}, {n2})")
    if c2.branches * n1 != c1.branches * n2:
        return _transformed(op, opt_level, "not-serial",
                            f"branches between the reads {c1.branches}, {c2.branches} at "
                            f"lens {n1}, {n2}: a loop between the reads")
    if c2.depth - c1.depth < n2 - n1:
        return _transformed(op, opt_level, "not-serial",
                            f"the longest dependent path grows {c2.depth - c1.depth} over "
                            f"{n2 - n1} steps")
    if space is not None:
        load = CHASE_LOADS[space]
        for n, c in ((n1, c1), (n2, c2)):
            n_loads = sum(k for m, k in c.mnemonics.items() if _is_load(m))
            mine = sum(k for m, k in c.mnemonics.items() if m.startswith(load))
            if mine != n or n_loads != n:
                return _transformed(op, opt_level, "residency",
                                    f"len={n}: {mine} {load} of {n_loads} loads")
            if c.loads != n:
                return _transformed(op, opt_level, "missing-dependent-load",
                                    f"len={n}: {c.loads} loads on the dependent path")
    if step_op is not None:
        for n, c in ((n1, c1), (n2, c2)):
            if c.mnemonics[step_op] != n or c.depth < n:
                return _transformed(op, opt_level, "length-mismatch",
                                    f"len={n}: {c.mnemonics[step_op]} {step_op}, depth {c.depth}")
    return _audited(op, opt_level,
                    f"depths={c1.depth},{c2.depth} lens={n1},{n2} step={_fmt(step)}"
                    + (f" space={space}" if space else ""))


@functools.cache
def timed_certs(lib: str, pattern: str, lens: tuple[int, ...], load_prefix: str = "LD"
                ) -> tuple[RegionCert, ...] | None:
    """The region certificates of ``lib``'s timed instances whose name
    matches ``pattern`` (a regex with the length as its group), one per
    length of ``lens``; None when an instance is missing or its clock
    reads are unpaired. Read once a process."""
    found = _instances(lib, pattern)
    certs = tuple(region_cert(found[n], load_prefix) if n in found else None for n in lens)
    return None if None in certs else certs


def inkernel_op_pattern(step: str) -> str:
    """The name pattern of K2's timed instances of ``step``."""
    return r"op_chain_timed_kernelI.*" + re.escape(k2_struct(step)) + r"Li(\d+)E"


def _instances(lib: str, pattern: str) -> dict[int, list[str]]:
    """The timed instances of ``lib`` whose name matches ``pattern`` (a
    regex with the length as its group), by length."""
    out = {}
    for name, body in artifacts.library_sass(lib).items():
        m = re.search(pattern, name)
        if m:
            out[int(m.group(1))] = body
    return out


def _pair(op: str, opt_level: str, lib: str, pattern: str, lens: Sequence[int],
          load_prefix: str = "LD") -> tuple[tuple[RegionCert, ...], ChainVerdict | None]:
    certs = timed_certs(lib, pattern, tuple(lens), load_prefix)
    if certs is None:
        return (), ChainVerdict(op, opt_level, "unaudited", cause="artifact-missing",
                                detail=f"no timed instance of {lib} at n {tuple(lens)} with "
                                       "paired clock reads")
    return certs, None


# ------------------------------------------------------- chain-family audits
def audit_inkernel_op(spec, opt_level: str, *, op: str | None = None,
                      lens: Sequence[int] | None = None) -> ChainVerdict:
    """Certify an ``inkernel.<spec>`` chain from K2's timed form at its two
    straight-line lengths."""
    from repro_torch import inkernel
    from repro_torch.kernels.opchain import TIMED_LENS

    op = op or f"inkernel.{spec.name}"
    if not inkernel.supported(spec):
        return ChainVerdict(op, opt_level, "unaudited", cause="x64-dispatch")
    lens = tuple(lens or TIMED_LENS)
    certs, missing = _pair(op, opt_level, "op_chain_timed", inkernel_op_pattern(spec.name),
                           lens)
    return missing or _chain_pair_verdict(op, opt_level, certs, lens)


def audit_inkernel_mem(ws_bytes: int, opt_level: str, *, op: str | None = None,
                       space: str | None = None, line_bytes: int = 64,
                       lens: Sequence[int] | None = None) -> ChainVerdict:
    """Certify an ``inkernel.mem.<bytes>`` pointer chase from K3's timed
    form: a serialized dependent load a step, the ring read from the space
    its size selects (shared memory up to K3's budget, global above)."""
    from repro_torch.inkernel import CHASE_LENS
    from repro_torch.kernels.chase import select_memory_space

    op = op or f"inkernel.mem.{ws_bytes}"
    space = space or select_memory_space(ws_bytes)
    lens = tuple(lens or CHASE_LENS)
    smem = int(space == "smem")
    certs, missing = _pair(op, opt_level, "chase", rf"chase_kernelILb{smem}ELb1ELi(\d+)E", lens,
                           load_prefix=CHASE_LOADS[space])
    return missing or _chain_pair_verdict(op, opt_level, certs, lens, space=space)


def audit_alu_kernel(alu_op: str, opt_level: str, *, op: str | None = None,
                     lens: Sequence[int] = (8, 64)) -> ChainVerdict:
    """Certify a ``kernel.alu_chain.<op>`` chain from K1's timed form: the
    straight-line chain between the clock reads is one dependent path of
    ``n`` of the op's instructions."""
    op = op or f"kernel.alu_chain.{alu_op}"
    if alu_op not in ALU_OPS:
        return ChainVerdict(op, opt_level, "unaudited", cause="unknown-kernel-op")
    idx = ALU_OPS.index(alu_op)
    certs, missing = _pair(op, opt_level, "alu_chain",
                           rf"alu_chain_kernelILi{idx}ELi(\d+)ELb1E", lens)
    return missing or _chain_pair_verdict(op, opt_level, certs, lens,
                                          step_op=KERNEL_STEP_SASS.get(alu_op))
