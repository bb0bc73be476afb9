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
as in the JAX package.

**The fused kernels** (K4-K7, the ``inkernel.fused.*`` rows) are timed as a
two-size workload slope (``inkernel.fused``: n workload units, a KV block of
16 keys, a chunk of 8 steps, a block of 8 rows), so what must hold is that
their work is *linear* in n. :func:`fused_unit` gives a kernel's unit
signature, as the JAX package's does:

* its **ops per unit**, in the JAX package's primitive names, from the op
  record (``core.hlo_analysis.record_ops``) of a *blocked plain form*: the
  kernel's arithmetic as the reference kernel writes it, one grid step at a
  time (:data:`BLOCKED`: the online softmax a KV block, the recurrence a
  step of a chunk, the norm a row block), fully masked KV blocks skipped as
  the kernels skip them. The plain versions compute each call in whole-array
  ops, whose count does not grow with n, and the SASS of a CUDA kernel has
  loops whose trip counts the card decides; a record of the blocked form is
  exact, runs on the CPU and is held against the plain versions' outputs.
  A delta that is negative or does not divide by the sizes' difference is
  ``nonlinear-signature``, as in the JAX package; so is a delta that
  differs between (n1, n2) and (n2, 2 n2 - n1), which two points alone
  cannot see (a polynomial's delta always divides);
* its **bytes per unit** by the port's rule, each input read once and the
  output written once (``inkernel.measure.unit_bytes``, what the rows'
  notes say); a delta that is zero or below or does not divide is
  ``nonlinear-traffic``. The JAX package's byte count reads every block
  dimension as 1 on jax 0.9.0 (ROADMAP R5).

:func:`audit_fused` then reads **residency** from the SASS of the K4-K7
instance the unit workload launches: no local-memory load or store (LDL,
STL) and no spill in ptxas's report. On the CPU there is no SASS, and the
verdict is what the K1-K3 half gives there (``unaudited:no-device-code``).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from collections import Counter
from typing import Sequence

import torch

from repro_torch.audit import artifacts
from repro_torch.audit.chain_check import ChainVerdict, _no_device_code, k2_struct
from repro_torch.kernels.common import NEG_INF

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


# ------------------------------------------------------------ fused kernels
# ATen ops of the blocked forms' records by the JAX package's primitive
# names (``repro.audit.dataflow``'s vocabulary); ops not named here and not
# plumbing are kept as ``aten:<op>`` so that nothing vanishes
ATEN_TO_PRIM: dict[str, tuple[str, ...]] = {
    "add": ("add",), "sub": ("subtract",), "rsub": ("subtract",), "mul": ("multiply",),
    "div": ("divide",), "neg": ("negate",), "abs": ("abs",), "exp": ("exponential",),
    "log1p": ("log-plus-one",), "rsqrt": ("rsqrt",), "maximum": ("maximum",),
    "clamp_min": ("maximum",), "clamp": ("maximum",),  # the forms clamp one side only
    "minimum": ("minimum",), "mm": ("dot",), "bmm": ("dot",),
    "mv": ("dot",), "amax": ("reduce",), "sum": ("reduce",), "mean": ("reduce", "divide"),
    "where": ("select",), "eq": ("compare",), "ne": ("compare",), "lt": ("compare",),
    "le": ("compare",), "gt": ("compare",), "ge": ("compare",),
}
# what the blocked forms run that is data movement or set-up, not arithmetic
PLUMBING = frozenset({"zeros", "zero", "full", "fill", "empty", "arange", "_to_copy",
                      "new_zeros", "new_full", "new_empty", "lift_fresh"})


class NonlinearSignature(Exception):
    """A fused kernel's signature does not grow linearly with its workload."""

    def __init__(self, cause: str, detail: str):
        super().__init__(f"{cause}: {detail}")
        self.cause, self.detail = cause, detail


def _blocked_flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                             block: int = 16):
    """Flash attention a (batch, head, q block, KV block) grid step at a
    time, as ``repro/kernels/flash_attention.py``'s kernel writes it: the
    online softmax over each KV block, a block whose keys are all masked
    skipped, the causal mask bottom-right aligned (``q_start = qi + sk -
    sq``)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = float(d ** -0.5) if scale is None else scale
    out = torch.empty(b, sq, h, d, dtype=q.dtype)
    for bi in range(b):
        for hi in range(h):
            for qi in range(0, sq, block):
                bq = min(block, sq - qi)
                q_start = qi + (sk - sq)
                qb = q[bi, qi:qi + bq, hi].float() * scale
                acc = torch.zeros(bq, d)
                m = torch.full((bq, 1), NEG_INF)
                el = torch.zeros(bq, 1)
                for ki in range(0, sk, block):
                    if causal and ki > q_start + bq - 1:
                        continue  # every key of the block is masked
                    kb = k[bi, ki:ki + block, hi // g].float()
                    s = qb @ kb.T
                    if causal:
                        qpos = q_start + torch.arange(bq)[:, None]
                        kpos = ki + torch.arange(kb.shape[0])[None, :]
                        s = torch.where(qpos >= kpos, s, NEG_INF)
                    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                    p = torch.exp(s - m_new)
                    alpha = torch.exp(m - m_new)
                    el = el * alpha + p.sum(dim=-1, keepdim=True)
                    acc = acc * alpha + p @ v[bi, ki:ki + block, hi // g].float()
                    m = m_new
                out[bi, qi:qi + bq, hi] = (acc / el.clamp_min(1e-30)).to(q.dtype)
    return out


def _blocked_flash_decode(q, k, v, kv_len, *, block: int = 16):
    """Decode attention a (batch, KV head, KV block) grid step at a time, as
    ``repro/kernels/flash_decode.py``'s kernel writes it: the query heads of
    a KV head together, blocks at or past ``kv_len`` skipped."""
    b, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = float(d ** -0.5)
    out = torch.empty(b, h, d, dtype=q.dtype)
    for bi in range(b):
        n = int(kv_len[bi])
        for hi in range(kh):
            qg = q[bi, hi * g:(hi + 1) * g].float() * scale
            acc = torch.zeros(g, d)
            m = torch.full((g, 1), NEG_INF)
            el = torch.zeros(g, 1)
            for ki in range(0, s_len, block):
                if ki >= n:
                    continue
                s = qg @ k[bi, ki:ki + block, hi].float().T
                kpos = ki + torch.arange(s.shape[1])[None, :]
                s = torch.where(kpos < n, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
                el = el * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + p @ v[bi, ki:ki + block, hi].float()
                m = m_new
            out[bi, hi * g:(hi + 1) * g] = (acc / el.clamp_min(1e-30)).to(q.dtype)
    return out


def _blocked_mamba_scan(x, dt, A, B, C, D, *, chunk: int = 128):
    """The selective scan a (batch, chunk) grid step at a time and a time
    step at a time inside it, as ``repro/kernels/mamba_scan.py``'s kernel
    writes it (softplus as the port's K7 and its plain version take it),
    then ``y + x * D``."""
    from repro_torch.kernels.mamba_scan import softplus

    bsz, s_len, dm = x.shape
    a = A.float()
    y = torch.empty(bsz, s_len, dm, dtype=x.dtype)
    for bi in range(bsz):
        h = torch.zeros(dm, A.shape[1])
        for c0 in range(0, s_len, chunk):
            for t in range(c0, min(c0 + chunk, s_len)):
                d_t = softplus(dt[bi, t].float())
                da = torch.exp(d_t[:, None] * a)
                h = da * h + (d_t * x[bi, t].float())[:, None] * B[bi, t].float()[None, :]
                y[bi, t] = (h @ C[bi, t].float()[:, None])[:, 0].to(x.dtype)
    return y + x * D[None, None].to(x.dtype)


def _blocked_rmsnorm(x, w, *, eps: float = 1e-6, block: int = 8):
    """RMSNorm a row block (grid step) at a time, as
    ``repro/kernels/rmsnorm.py``'s kernel writes it."""
    out = torch.empty_like(x)
    for r in range(0, x.shape[0], block):
        xb = x[r:r + block].float()
        rms = torch.rsqrt((xb * xb).mean(dim=-1, keepdim=True) + eps)
        out[r:r + block] = (xb * rms * w.float()).to(x.dtype)
    return out


# each fused kernel's blocked plain form (see the module docstring)
BLOCKED = {"flash_attention": _blocked_flash_attention, "flash_decode": _blocked_flash_decode,
           "mamba_scan": _blocked_mamba_scan, "rmsnorm": _blocked_rmsnorm}


def prim_ops(record) -> Counter:
    """The arithmetic of an op record, each op once a call, by the JAX
    package's primitive names (:data:`ATEN_TO_PRIM`; plumbing dropped)."""
    from repro_torch.core.hlo_analysis import STRUCTURAL_OPS

    out: Counter = Counter()
    for (op, _elems), count in record.histogram.items():
        if op in STRUCTURAL_OPS or op in PLUMBING:
            continue
        for prim in ATEN_TO_PRIM.get(op, (f"aten:{op}",)):
            out[prim] += count
    return out


def fused_workload(name: str, n: int, overrides: dict | None = None) -> tuple:
    """``(fn, args, kwargs)``: fused kernel ``name``'s unit workload of
    ``n`` units on the CPU (``inkernel.fused.build_fused``), its wrapper's
    keywords with ``overrides`` over them."""
    from repro_torch.inkernel.fused import build_fused, fused_kwargs

    kw = {**fused_kwargs(name), **(overrides or {})}
    fn, args = build_fused(name, n, "cpu")
    return fn.func, args, kw


def _signature(name: str, n: int, overrides: dict | None, query_grows: bool
               ) -> tuple[Counter, int]:
    """(ops, bytes) of ``name``'s blocked form over ``n`` units."""
    from repro_torch.core.hlo_analysis import record_ops

    fn, args, kw = fused_workload(name, n, overrides)
    if query_grows:  # the query as long as the keys: causal self-attention
        q, k, v = args
        args = (q.repeat(1, n, 1, 1), k, v)
    blocked, outs = functools.partial(BLOCKED[name], **kw), []
    rec = record_ops(lambda *a: outs.append(blocked(*a)), *args)
    return prim_ops(rec), sum(t.nbytes for t in (*args, *outs))


@functools.lru_cache(maxsize=None)
def fused_unit(name: str, lens: tuple[int, int], overrides: tuple = (),
               query_grows: bool = False) -> dict:
    """Unit signature of fused kernel ``name`` between workload sizes
    ``lens``: ``{"ops": per unit, "bytes": per unit, "total_bytes": {n:
    bytes}}`` (see the module docstring), checked at ``2 lens[1] -
    lens[0]`` too. ``overrides`` (``(key, value)`` pairs) changes the
    wrapper's keywords, ``query_grows`` makes the attention's query as long
    as its keys (controls). Raises :class:`NonlinearSignature`, and
    ``ValueError`` for an unknown kernel."""
    from repro_torch.inkernel.fused import fused_kwargs

    fused_kwargs(name)  # raises for an unknown name
    n1, n2 = lens
    n3 = 2 * n2 - n1
    sig = {n: _signature(name, n, dict(overrides), query_grows) for n in (n1, n2, n3)}
    dn = n2 - n1
    units = []
    for a, b in ((n1, n2), (n2, n3)):
        delta = Counter(sig[b][0])
        delta.subtract(sig[a][0])
        unit = {}
        for k, v in sorted(delta.items()):
            if v < 0 or v % dn:
                raise NonlinearSignature("nonlinear-signature",
                                         f"{k}: delta={v} over dn={dn} (n {a} -> {b})")
            if v:
                unit[k] = v // dn
        dbytes = sig[b][1] - sig[a][1]
        if dbytes <= 0 or dbytes % dn:
            raise NonlinearSignature("nonlinear-traffic",
                                     f"bytes delta={dbytes} over dn={dn} (n {a} -> {b})")
        units.append((unit, dbytes // dn))
    if units[0] != units[1]:
        raise NonlinearSignature("nonlinear-signature",
                                 f"per unit {units[0]} at n {n1}->{n2}, {units[1]} at "
                                 f"n {n2}->{n3}")
    return {"ops": units[0][0], "bytes": units[0][1],
            "total_bytes": {n: sig[n][1] for n in (n1, n2, n3)}}


def fused_registry(lens: tuple[int, int] | None = None) -> dict[str, dict]:
    """name -> unit signature (:func:`fused_unit`) of every fused kernel
    (``inkernel.FUSED_KERNELS``)."""
    from repro_torch.inkernel.fused import FUSED_KERNELS, FUSED_LENS

    lens = tuple(lens or FUSED_LENS)
    return {name: fused_unit(name, lens) for name in FUSED_KERNELS}


def fused_instances(name: str) -> list[str]:
    """The mangled names of the K4-K7 instances that ``name``'s unit
    workload launches (its float32 tensors pick them), from the built
    library's SASS."""
    from repro_torch.inkernel.fused import build_fused
    from repro_torch.kernels.mamba_scan import scan_vectorized
    from repro_torch.kernels.rmsnorm import rmsnorm_plan

    _, args = build_fused(name, 2, "cpu")
    if name == "rmsnorm":
        inst = rmsnorm_plan(args[0].shape[-1], torch.float32, True)
        pattern = (rf"rmsnorm_kernelIfLi{inst.vec}ELi{inst.nv}"
                   rf"ELb{int(inst.warp_per_row)}E")
    elif name == "flash_attention":
        pattern = rf"flash_attention_tf32_kernelILi{args[0].shape[-1]}E"
    elif name == "flash_decode":
        g = args[0].shape[1] // args[1].shape[2]
        pattern = rf"decode_split_kernelIfLi{args[0].shape[-1]}ELi{g}E|decode_combine_kernelIfE"
    else:
        pattern = (rf"mamba_scan_kernelILi{args[2].shape[1]}"
                   rf"ELb{int(scan_vectorized(*args[:2], *args[3:5]))}E")
    return sorted(f for f in artifacts.library_sass(name) if re.search(pattern, f))


def _spills(name: str) -> dict[str, tuple[int, int]]:
    """ptxas's spill stores and loads of each function of library ``name``
    (``build.log`` keeps ptxas -v's lines)."""
    from repro_torch.kernels import _build

    log = (_build.build() / "build.log").read_text()
    found = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                       r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    return {f: (int(st), int(ld)) for f, st, ld in found}


def fused_residency(name: str) -> str:
    """'' when every instance the unit workload launches keeps its data out
    of local memory (no LDL or STL in its SASS, 0 spill bytes in ptxas's
    report), else the cause; ``artifact-missing`` with no such instance."""
    found = fused_instances(name)
    if not found:
        return "artifact-missing"
    sass, spills = artifacts.library_sass(name), _spills(name)
    for f in found:
        local = [m for m in artifacts.sass_mnemonics(sass[f]) if m.split(".")[0] in ("LDL", "STL")]
        if local:
            return f"residency-mismatch({f}: {len(local)} local-memory accesses)"
        if any(spills.get(f, (0, 0))):
            return f"residency-mismatch({f}: spills {spills[f]})"
    return ""


def audit_fused(name: str, opt_level: str = "O3", *, op: str | None = None,
                lens=None, env=None, overrides: dict | None = None,
                query_grows: bool = False) -> ChainVerdict:
    """Certify an ``inkernel.fused.<name>`` row: its signature linear in the
    workload (:func:`fused_unit`), then residency in the SASS of the
    instances its unit workload launches (on the card; on the CPU the
    verdict is ``unaudited:no-device-code``). ``env``: the environment the
    row was measured in (default this process's card, else the CPU).
    ``overrides`` and ``query_grows`` build the controls."""
    from repro_torch.inkernel.fused import FUSED_LENS

    op = op or f"inkernel.fused.{name}"
    lens = tuple(lens or FUSED_LENS)
    try:
        unit = fused_unit(name, lens, tuple(sorted((overrides or {}).items())), query_grows)
    except ValueError:
        return ChainVerdict(op, opt_level, "unaudited", cause="unknown-kernel-op")
    except NonlinearSignature as e:
        return _transformed(op, opt_level, e.cause, e.detail)
    ops = " ".join(f"{k}={v}" for k, v in sorted(unit["ops"].items()))
    detail = f"unit_bytes={unit['bytes']} unit_ops=[{ops}]"
    if env is None:
        from repro_torch.core.latency_db import current_environment
        env = current_environment("cuda:0" if torch.cuda.is_available() else "cpu")
    missing = _no_device_code(op, opt_level, env)
    if missing is not None:
        return dataclasses.replace(missing, detail=f"{missing.detail}; {detail}")
    cause = fused_residency(name)
    if cause == "artifact-missing":
        return ChainVerdict(op, opt_level, "unaudited", cause=cause,
                            detail=f"no instance of {name} for the unit workload in the SASS")
    if cause:
        return _transformed(op, opt_level, cause, detail)
    return _audited(op, opt_level, detail)
