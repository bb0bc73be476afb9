#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Before anything else it starts one pool of compile worker processes, with
the run's compile cache (``core.compile_cache``, under the run's directory
in ``build/``), and hands it every O3 chain of the quick plan and then
those the table2 plan adds, in the order that lands the probes one after
another (``session.warm_tasks``); they compile while the kernels build and
are checked, each plan's session loads a chain from the module its worker
compiled; each plan's session (``--serial``) times its probes once all of
its chains have landed: no timing runs beside a compile of its own. Every
record made on the card must count ``cycles`` on the SM clock its notes
name (``cycles_at=sm_clock64@<MHz>``).

Phases, each of which must pass, in this order but for these: 10-12
(fused, then dataflow, serve and archs) and 6-7 (memory, memory-inkernel,
on a DB of their own, merged into the run's after table2) need no compiled
chain and run right after phase 2, while the compile workers build the
plans' chains (their host-side times, prefill and decode ms, are taken
beside those compiles; the card's are its own); phase o1 runs in table2's
wait, once its O1 chains have compiled in this process there. Phase
cache's two fresh processes import in the pool's wait and run once the
pool has stopped, before inkernel: this process times nothing while the
first (which times three rows) runs. Phases 13 and 14, serving and slo, run after the pool has stopped, on the
rows the plans recorded; phase 15 times the kernels after them, and K1-K3's
launches on the plans are counted in after that:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (into ``build/``),
   one nvcc per source, all at once, print ptxas's register and spill
   lines, and check that the SASS of the built libraries shows what each
   design promises: HGMMA (or HMMA) and UTMALDG (or LDGSTS) in K5's four
   bf16 instances; TF32 HMMAs and cp.async copies (LDGSTS) in K5's four
   float32 instances; cp.async copies and MUFU.EX2 in each of K7's six
   instances; 128-bit cp.async copies (LDGSTS .128) in each of K6's
   split-KV instances and 128-bit loads and stores (LDG.E.128, STG.E.128)
   in each of K4's vector instances; and in K1's timed fma chain at n 64 a
   clock read before the first of its 64 FFMAs and one after the last,
   with no branch between them (counts printed); K2's uint32 divides and
   high multiply show their divisor classes (a step of div.u.regular runs
   no MUFU.RCP, IMAD.HI or IMAD.WIDE; of div.u.irregular a wide or high
   multiply and no MUFU.RCP; div.u.runtime and rem.u hold the divide
   sequence's MUFU.RCP; a step of mul64hi a wide or high multiply), and a
   step of each holds what its row's notes name; K2's timed form, for each
   of the 58 in-kernel rows at n 8 and 64: the clock reads bracket the
   chain (nothing that grows with n before the first read, no branch
   between the reads but a step's own), and what a step runs, the SASS
   between the reads at n 64 less that at n 8 over 56, printed, the rows
   under one instruction a step named as folded; K3's timed form, each
   straight-line instance (smem and global, 64 and 192 steps): the clock
   reads bracket the chase with no branch between them, and a step ((192 -
   64) / 128) is one LDS or LDG and at most one address instruction,
   printed; and ptxas must report 0 spill bytes for each instance of K5
   float32 and of K7;
2. hold each kernel against its plain PyTorch version on the card: K1-K3 at
   the quick plan's shapes and one larger shape (alu_chain within rtol
   1e-5, in both its forms, the timed one's cycles all positive; op_chain
   and chase bit-exact, op_chain in every integer step, the table2 rows'
   uint32 divides and high multiply included, at unroll 1 and 32 and in
   the timed form, on random inputs and on each registry row's own inputs;
   and each of the 58 in-kernel rows on its tile and inputs in the timed
   form at n 8 and 64 (every thread's cycles positive) and in the loop
   form at n 37, bit-exact but for the transcendental and reciprocal rows,
   within 2 ulps; chase in both forms on both paths, on rings of 4 KiB,
   64 KiB, 227 KiB (the smem budget) and 2 MiB at 64, 192 and 37 steps,
   with and without a warm lap, bit-exact, every timed launch's cycles
   positive, a carried start continuing, and a forced smem ring above the
   budget raising); K4-K7 at the fused plan's unit
   workloads and at the widths of Jamba-v0.1 52B (d_model 4096, 32 heads,
   8 KV heads, head dim 128, Mamba Dm 8192, N 16, chunk 64), every element
   within ``tol * (|want| + rms(want's row))``, tol 2^-7 in bfloat16 (one
   rounding of the output) and 2^-13 in float32; a control that
   accumulates p . v in bfloat16 must fail that limit for K5 and K6, and
   one that takes each of K5's float32 products once in TF32 must fail the
   float32 limit. K5's cases, in bf16: Jamba causal, a prefix (Sq 512 <
   Sk 2048), Sq 100 > Sk 37 (whose 63 rows that see no key must be exactly
   0), D 64 non-causal, and Sq 1000, Sk 1937 (not multiples of 64); in
   float32: Jamba causal, Sq 100 > Sk 37, D 64 non-causal and Sq 1000,
   Sk 1937; SDPA's own error on the Jamba bf16 case is printed beside them,
   as a datum. K7's: Jamba, and Dm 1000 at batch 2 with chunk 7, whose
   final state h is held too. K6's cases: the ragged batch
   of 8, a batch-1 cache of 32768 keys, kv_len at a split's edges (511,
   512, 513, ...) and a float32 ragged batch, each row of kv_len 0 exactly
   0; K4's: D 4096, 1000 and 4100 (not a multiple of 8: the scalar
   instance), and x 2 bytes off a 16-byte boundary; the design each case
   runs is printed;
3. run ``characterize --plan quick`` through the port's CLI, with every
   kernel's launch count set to 0 just before and read just after; the run
   must measure every row of the plan, with no failure, and launch K1-K3;
   its kernel.alu_chain.fma row must be timed by the SM clock sandwich
   (notes ``clock=sm_clock64@<MHz>``), every other row by CUDA events;
4. run ``characterize --plan table2`` through the CLI on the quick plan's
   DB (the 32 probes the two share are cache hits), the launch counts set
   to 0 just before and read just after: every probe of the plan must end
   with a record timed by CUDA events, and K2 must be launched; a probe
   may fail only where the SASS of its O3 chain shows under one
   instruction a step (the compiler folded the chain), which is printed
   as the evidence. Each half-precision row's O3 chain must equal its
   eager chain bit for bit at n 64 and 512 (the chains' results come from
   the compile workers), and a step of it must run what its notes name.
   It prints each O3 chain's compile seconds by phase, and a line per row:
   ns a step at O0 and O3, MAD, net, what an O3 step runs, and its notes;
5. run ``characterize --plan inkernel --table`` through the CLI on
   table2's DB, the launch counts set to 0 just before and read just after:
   every inkernel.<row> probe must end with a record timed by K2's SM clock
   sandwich (notes ``clock=sm_clock64@<MHz>``), but a row whose timed SASS
   is folded may end as a NoisySlopeError; every dispatch twin that table2
   recorded must be a cache hit; K2 must be launched and the pairing
   table printed. It prints the in-kernel Table II: each row's ns and SM
   cycles a step beside its dispatch twin, and what a step runs;
6. run ``characterize --plan memory --table`` through the CLI on the same
   DB, the launch counts set to 0 just before and read just after: all 14
   rungs recorded on events, each stating the level rule its size asks
   for (``warm=`` a lap inside each launch below the L1's 256 KB,
   ``carry=1`` above), and K3 launched; it prints the ladder (ns and SM
   cycles a load, cold_ns, warm, carry), ``detect_levels``' levels and
   ``bandwidth_probe``'s GB/s;
7. run ``characterize --plan memory-inkernel --table`` on that DB, the
   counts set to 0 just before and read just after: the 7
   ``inkernel.mem.<N>`` rungs recorded on K3's SM clock sandwich, from
   shared memory at 64 KiB and global memory above; the 6 host twins the
   memory plan recorded cache hits, the 64 MiB twin measured; K3 launched
   in its timed form on both paths; the pairing table printed. It prints
   the in-kernel ladder beside its host twins, and its levels;
   every characterize run passes ``--audit``, so each record
   is judged as it is measured;
8. ``o1``: clock_overhead and the 15 ``QUICK_OPS`` at O1 (torch.compile's
   aot_eager backend) through ``Session(audit=True)`` on that DB, the
   counts set to 0 just before and read just after: every record timed by
   events, on the SM clock, with ``o1=`` and ``audit=`` in its notes (and
   an instruction row's ``launch=`` naming the CUDA graph it replays
   from), and each O1 chain bit for bit its eager chain at n 64 and 512;
   the O1 chains compiled and captured in this process while quick and
   table2 waited on the compile workers (``CompilePool.local``), counting
   no launch there: a graph's replay counts the launches it makes;
9. ``audit``: ``audit --db <that DB> --lint --lowering --attribution
   <file> --strict`` in this process: every record carries ``audit=``;
   not, bfi and mul24 at O3 and inkernel.bfi are ``transformed`` (their
   failures' messages carry the verdicts of the probes that failed); every
   ``transformed`` verdict is in ``KNOWN_TRANSFORMED``; no row outside
   special math is ``unaudited``; ``--strict`` exits 1.
   It prints every verdict, the counts by status and by family and the
   attribution rows of the ``QUICK_OPS``, and then that the compile pool
   ran only the 130 O3 chains of quick and table2 and the seconds the O1
   chains took beside them; the lowering lint's 72 short O1 chains (on the
   CPU) compiled in this process while the sessions waited on the pool;
10. the same for ``characterize --plan fused``: it must launch K4-K7 and
   measure the flash_attention, flash_decode and mamba_scan rows; the
   rmsnorm row may end as a NoisySlopeError failure (its row blocks run in
   parallel, so its slope is near the clock's resolution), and the script
   prints which;
11. ``serve``: ``python -m repro_torch.launch.serve``'s ``main`` with
   ``--arch jamba-v0.1-52b --full --periods 1 --kernels`` (Jamba-v0.1 at
   full width, one period: 1 attention and 7 Mamba layers, 4 MoE and 4
   dense FFNs, 13.30 B parameters in bfloat16, random from a seed; its 8
   requests, 32 new tokens, greedy), then 8 ragged prompts of 256-2048
   tokens through the same Engine, the launch counts set to 0 just before
   and read just after: K5 launched once and K7 seven times a prefill, no
   other kernel; each K5 and K7 call of that run against its plain version
   on that call's inputs (the row-scaled limits above; K7's final state
   too); then, on the same weights at batch 2 x 512, the kernel path
   against the plain path (plain attention, the chunked scan) layer by
   layer (``models.pathcheck``: each layer of a prefill and of the first
   decode step given the plain path's input and the same expert choices),
   outputs within 2^-5 * (|want| + rms(row)) and Mamba states within
   2^-13, with three controls that must fail it (K7 without its D skip, its
   state one step short, the decode step from zero Mamba states: R3). It
   prints prefill ms, decode ms a token, tokens/s, the peak memory
   allocated, the parameters and their bytes, and the card's name and
   power limit; nothing in it compiles through torch.compile (Dynamo's
   frame count must not move). Then K7 at 4096 and 8192 steps on the
   served model's own inputs (a prefill of 8192 tokens at batch 1, its
   first Mamba layer's scan inputs, x and dt [1, S, 8192], N 16): K7 and
   its plain version each against a float64 scan, y and the final state
   within 2^-13 * (|want| + rms(row)) for K7. The model is freed before
   the next phase;
12. ``archs``: xlstm-350m through ``launch.serve --arch xlstm-350m
   --full`` and its Engine (8 ragged prompts of 256-2048 tokens, 32 greedy
   tokens; no kernel on its path), qwen2-vl-2b (8 x 2048 patch embeddings
   at a 32 x 64 grid's M-RoPE positions, then 32 greedy text tokens) and
   seamless-m4t-large-v2 (frames [8, 512, 1024], a teacher-forced prompt
   of 8 x 2048 tokens, 32 greedy tokens with the cross cache), each at
   full width and depth from a seed, the counts set to 0 just before each
   and read just after (K5 28 times for qwen2-vl, 72 for seamless: its
   encoder not causal, its cross-attention of 2048 queries to 512 keys,
   head dim 64; qwen2-vl's 6 query heads a KV head); every K5 call held
   against its plain version; a layer check of each at 2 x 512 (the
   kernel path against the plain path, and for xlstm each layer's prefill
   of 512 tokens against its prefill of 511 and one decode step) within
   2^-5 * (|want| + rms(row)), with a control each that must fail (K5
   without its causal mask, K5 made causal on the encoder, the decode step
   from a zero mLSTM state); prefill ms, decode ms a token, peak memory;
   no Dynamo frame. Each model is freed before the next;
13. ``serving``: ``characterize --plan serving --table --audit`` through
   the CLI on a copy of the run's DB with the fused plan's rows merged in:
   its 18 deps (the QUICK_OPS at O3, the chase rungs of 8 KiB, 128 KiB and
   2 MiB) cache hits, its 4 serving-tiny cells (prefill and decode at 1 x
   16 and 2 x 64, the JAX package's tiny dense model, no kernel on their
   path) measured with ``exec=eager``, a positive prediction and a
   coverage in (0, 1], no kernel launched; then the full-width cells
   through ``Session.run``: Jamba-v0.1 cut to one period with phase
   serve's kernels runtime and seed (one model build for both), a prefill
   of 8 x 2048 tokens and a decode step at position 2048 on a cache of
   2080, each recorded once (``core.hlo_analysis.record_ops``), priced by
   ``RecordLatencyEstimator`` from the run's rows and timed on events. The
   prefill's record must hold one K5 site and seven K7 sites, priced from
   the ``inkernel.fused.*`` rows (no ``kernel:`` in ``unpriced_opcodes``),
   the decode step's none; only K5 and K7 launched, seven K7 a K5; no
   Dynamo frame. It prints each cell's predicted and measured ns, their
   ratio, coverage, bound, unpriced ops and the record's size;
14. ``slo``: ``serve-slo`` through the CLI on a copy of the run's DB with
   the fused plan's rows merged in: serving-tiny at 20, 50 and 100 req/s,
   12 requests of a seeded Poisson trace each through a pool of 4 slots,
   its 18 deps cache hits, each point measured (the slot pool on the
   host's wall clock, ``exec=eager clock=wall``) and predicted (the
   scheduler over the steps' records priced from the DB), both sides'
   p50 and p99 TTFT and p50 TPOT positive, a coverage in (0, 1], no
   kernel launched; a second run all cache hits. Then Jamba-v0.1's pool
   at full width (one period, phase serve's model, runtime and seed)
   through ``Session.run`` over ``SloProbe``s at 1 and 16 req/s: 12
   requests of 256-2048 prompt tokens and 8-32 new tokens, 4 slots on a
   cache of 2080, eos off. Every request must produce its whole budget on
   both sides; only K5 and K7 may launch, seven K7 a K5, K5 once an
   admission (each point's records of its prompt lengths, its warm-ups and
   its 12 measured admissions); every K5 and K7 call of the measured
   admissions is held against its plain version on its own inputs, right
   after the admission's clock is read; no Dynamo frame; the model is
   freed at the end. It prints each point's predicted and measured TTFT
   p50/p99, TPOT p50/p99, e2e p50 and goodput, their ratios and coverage,
   the phase's wall time against its bound, the peak memory and the
   card's name and power limit;
15. time each kernel, its plain version, its bound (the larger of bytes
   and operations; K5 float32's operations at the least of float32 FMAs,
   3xTF32 and 3xBF16 on the tensor cores, the choice printed; K7's at its
   float32 operations, its exponentials on the SFU alone printed beside
   them; K7 also in 4-byte copies, on its inputs and on inputs 4 bytes
   off a 16-byte boundary) and,
   where one PyTorch call computes the same function, that call, at the
   shapes the main
   paths give it (K5 also at each of phase archs' cases; K1 in its timed
   form, as the quick plan runs it on the card; K3 in both forms, the timed one at the memory-inkernel plan's
   64 MiB rung, its launches also by form and path; K4-K7 also at the
   Jamba shapes, K5 in both dtypes, K6 also at the
   batch-1 cache of 32768 keys, and there at g = 1, 2, 4 and 8 query heads
   a KV head, a datum on the share of its arithmetic; and the device time
   of K6's split and combine passes from torch.profiler); count
   non-positive slopes of the host clock, of CUDA events and of the SM clock sandwich
   over repeated trials (the sandwich, which times the quick plan's
   kernel.alu_chain.fma row and the inkernel plan's rows, must have none,
   for K1's fma chain and for K2's inkernel.add, and for K3's chase at the
   memory-inkernel plan's 64 KiB (smem) and 64 MiB rungs, beside the slope
   from the medians), the 64 MiB rung's loads against the same loads after
   256 MiB of other data went through L2 before each launch, print the
   calibrated SM clock, and time op_chain's loop: each step's time with 1
   and with 32 steps to an iteration;
16. ``dataflow`` (after fused): ``audit --lint --dataflow`` through the CLI
   (clean: the fused kernels' signatures linear in their workload, the
   SASS of the instances their unit workloads launch free of local memory,
   K1's five ALU chains, K2's add.float32 and K3 in both spaces), then the
   fused plan's four rows audited from its DB, each ``audited`` with the
   ``unit_bytes`` of its notes, and a control that must be rejected
   (causal self-attention: ``transformed`` with a ``nonlinear-*`` cause),
   within 15 s;
17. ``cache``: two fresh processes, started after phase kernels, import
   torch, Inductor and Triton in the pool's wait (no CUDA call) and wait
   for a start signal each. Once the pool has stopped, the first runs
   ``characterize --plan quick --opt-levels O3 --ops add,mul,fma.float32
   --force`` with the run's compile cache (6 hits, 0 compiled; no
   Inductor miss, no lowering, no Triton compile that missed its cache),
   while this process times nothing; then the second runs ``audit --db
   <its DB> --compile-cache <the run's>``, which times nothing, beside
   inkernel and phase audit, and must give those rows the verdicts of
   quick's run and of phase audit; the two processes' seconds from their
   signals together are held to 30 s (their imports printed beside);
18. print F4's reckoning (the compile pool's start, first chain, end, span,
   worker-seconds and the tail after it), the ``{"kernels": [...]}`` line
   (each kernel with the design each dtype runs; K4-K7's launches summed
   over the fused run and phases serve, archs, serving and slo), the card's
   name and power limit, and, last, ``{"ok": true, "device": {...}}``; a
   wall-time bound missed (phases dataflow and cache) fails the run here.

It exits non-zero, printing no result, when no CUDA card is visible or the
repository's sources are missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12     # non-tensor float32; also used for int32 ops
BF16_OPS_PER_S = 989e12    # dense bf16 on the tensor cores
TF32_OPS_PER_S = 495e12    # dense TF32 on the tensor cores
# MUFU (ex2, lg2, ...): 16 results a clock an SM (CUDA C++ programming
# guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x 1980 MHz, the H100 SXM's boost clock
MUFU_OPS_PER_S = 16 * 132 * 1.98e9
ALU_RTOL = 1e-5
# Row-scaled limits for K4-K7 on the card: |got - want| <= tol * (|want| +
# rms(want's row)). bf16: one rounding of the output (half an ulp is 2^-9
# of the value, two roundings of nearby values differ by up to 2^-7).
# float32: 2^-13, below TF32's 2^-11, so a product taken in TF32 fails it.
ROW_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -13}
QUICK_KERNELS = ("alu_chain", "op_chain", "chase")
# K2's in-kernel rows against their plain versions: bit-exact, but for the
# rows whose step is a transcendental or reciprocal function, within ULPS
# units in the last place (neither side rounds those correctly; each step
# contracts an error, so it does not grow with n)
ULPS = 2
ULP_ROWS = ("sin", "cos", "lg2", "ex2", "tanh", "rsqrt", "rcp")


def ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance between got and want in units in the last place
    (0 for equal integers; any difference of integers counts)."""
    if not want.dtype.is_floating_point:
        return 0 if torch.equal(got, want) else 2 ** 31
    ints = {2: torch.int16, 4: torch.int32}[want.element_size()]
    sign = {2: 0x7FFF, 4: 0x7FFFFFFF}[want.element_size()]

    def ordered(t):  # the float's place on the number line, as an integer
        i = t.contiguous().view(ints).long()
        return torch.where(i < 0, -(i & sign), i)

    return int((ordered(got) - ordered(want)).abs().max())


def same_bits_or_both_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit (the sign of a zero counts); a NaN matches any NaN."""
    ints = {2: torch.int16, 4: torch.int32}[want.element_size()]
    both_nan = got.isnan() & want.isnan()
    return bool((both_nan | (got.view(ints) == want.view(ints))).all())


def check_float_specials(dev: torch.device, rng: np.random.RandomState) -> None:
    """K2's float rows that are held bit for bit (all but ``ULP_ROWS``), on
    random inputs with NaN, +-0 and +-inf in a quarter of the elements, in
    both forms at n 1, 8, 37, 64, against op_chain_plain on the card: a NaN
    goes through every step, min and max too (as jnp.minimum does; fminf
    would drop it). fma.float32's a is a power of two or a special: the
    kernel rounds x*a + b once (FFMA), the registry's step twice, and the
    two agree where the product is exact. Then one step of each min and max
    row where fminf-style instructions part from jnp.minimum and
    jnp.maximum: NaN for a NaN operand, and -0 below +0 in either order."""
    from repro_torch import inkernel
    from repro_torch.kernels.opchain import (STEPS, UNROLLS, op_chain, op_chain_plain,
                                             op_chain_timed)

    specials = (float("nan"), 0.0, -0.0, float("inf"), float("-inf"))
    rows = [s for s, (dtype, _, _) in STEPS.items()
            if dtype.is_floating_point and s not in ULP_ROWS]
    for step in rows:
        dtype, n_ops, _ = STEPS[step]
        shape = inkernel.default_tile(str(dtype).removeprefix("torch."))

        def draw():
            vals = rng.standard_normal(shape) * 4.0
            special = rng.random_sample(shape) < 0.25
            vals[special] = rng.choice(specials, int(special.sum()))
            return torch.from_numpy(vals.astype(np.float32)).to(dtype).to(dev)

        x, *ops = (draw() for _ in range(1 + n_ops))
        if step == "fma.float32":
            ops[0] = torch.from_numpy(rng.choice((0.5, 2.0, -0.5, -2.0) + specials, shape)
                                      .astype(np.float32)).to(dev)
        for n in (1, 8, 37, 64):
            want = op_chain_plain(x, *ops, step=step, n=n)
            got = {f"unroll={u}": op_chain(x, *ops, step=step, n=n, unroll=u) for u in UNROLLS}
            got["timed"] = op_chain_timed(x, *ops, step=step, n=n)[0]
            for form, g in got.items():
                if not same_bits_or_both_nan(g, want):
                    fail(f"op_chain {step} {form} n={n}: differs from the plain version on "
                         "inputs with NaN, +-0 and +-inf")
    for dt in ("float32", "bfloat16", "float16"):
        t = lambda *v: torch.tensor(v, dtype=getattr(torch, dt), device=dev)  # noqa: E731
        nan = float("nan")
        x, a = t(nan, 1.0, nan, -0.0, 0.0, 2.0), t(1.0, nan, nan, 0.0, -0.0, 3.0)
        # b is -0 for min and +0 for max, so the step's add keeps a zero's sign
        for op, b, want in (("min", -0.0, t(nan, nan, nan, -0.0, -0.0, 2.0)),
                            ("max", 0.0, t(nan, nan, nan, 0.0, 0.0, 3.0))):
            b = torch.full_like(x, b)
            got = {f"unroll={u}": op_chain(x, a, b, step=f"{op}.{dt}", n=1, unroll=u)
                   for u in UNROLLS}
            got["timed n=8"] = op_chain_timed(x, a, b, step=f"{op}.{dt}", n=8)[0]
            for form, g in got.items():
                if not same_bits_or_both_nan(g, want):
                    fail(f"op_chain {op}.{dt} {form}: {g.tolist()} where jnp.{op}imum "
                         f"gives {want.tolist()}")
    print(f"K2 op_chain: the {len(rows)} float rows held bit for bit, on inputs with NaN, "
          "+-0 and +-inf, both forms, n (1, 8, 37, 64), equal the plain version (NaN for "
          "NaN); min and max carry NaN and order -0 below +0, as jnp.minimum/maximum")


def designs(name: str) -> dict[str, str]:
    """The design each dtype of kernel ``name`` (a library of
    ``_build.KERNELS``) runs, from its wrapper module's DESIGNS."""
    module = {"op_chain": "opchain", "op_chain_timed": "opchain",
              "chase_timed": "chase"}.get(name, name)
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    return {str(k).removeprefix("torch."): v for k, v in mod.DESIGNS.items()}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# wall-time bounds missed: the run goes on to its end, so that every phase's
# figures are printed, and then fails (main)
MISSED: list[str] = []


def bound(label: str, wall: float, limit: float) -> None:
    """Print a phase's wall time against its bound; a miss fails the run at
    its end."""
    print(f"{label}: wall {wall:.2f} s against the bound {limit:.0f} s")
    if wall > limit:
        MISSED.append(f"{label}: {wall:.2f} s over its bound of {limit:.0f} s")


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def wall_ms(fn, reps: int = 5) -> float:
    """Median wall time of one call of ``fn`` to completion on the card."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def check_kernels(dev: torch.device) -> dict[str, float]:
    """Phase 2: every kernel against its plain version on the card; returns
    the largest absolute error seen per kernel."""
    from repro_torch.core.membench import build_ring
    from repro_torch.kernels.alu_chain import OPS, alu_chain, alu_chain_plain, alu_chain_timed
    from repro_torch.kernels.chase import chase, chase_plain
    from repro_torch.core.chains import default_registry, spec_by_name
    from repro_torch import inkernel
    from repro_torch.kernels.opchain import (DIVIDES, STEPS, TIMED_LENS, UNROLLS, op_chain,
                                             op_chain_plain, op_chain_timed)

    chain_names = {s.name for s in default_registry()}

    def timed(x, a, n, op):  # the form the quick plan launches on the card
        out, cycles = alu_chain_timed(x, a, n=n, op=op)
        if not bool((cycles > 0).all()):
            fail(f"alu_chain_timed {op} n={n} {tuple(x.shape)}: a thread's cycles "
                 f"are not positive (min {int(cycles.min())})")
        return out

    rng = np.random.RandomState(0)
    err = {"alu_chain": 0.0, "op_chain": 0.0, "chase": 0.0}
    for shape in ((8, 128), (1024, 1024)):
        x = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32)).to(dev)
        a = torch.from_numpy(rng.uniform(0.5, 1.0, shape).astype(np.float32)).to(dev)
        for op in OPS:
            for n in (8, 64, 45):  # straight-line at 8 and 64, a loop at 45
                want = alu_chain_plain(x, a, n=n, op=op)
                for form, fn in (("alu_chain", alu_chain), ("alu_chain_timed", timed)):
                    got = fn(x, a, n=n, op=op)
                    torch.cuda.synchronize()
                    if not torch.isfinite(got).all():
                        fail(f"{form} {op} n={n} {shape}: non-finite output")
                    torch.testing.assert_close(got, want, rtol=ALU_RTOL, atol=0)
                    err["alu_chain"] = max(err["alu_chain"], float((got - want).abs().max()))
    print(f"K1 alu_chain and its timed form: {len(OPS)} ops x n in (8, 64, 45) x (8, 128), "
          f"(1024, 1024) agree, max abs err {err['alu_chain']:.3g} (rtol {ALU_RTOL}); "
          "every thread's cycles positive")

    int_steps = [step for step, (dtype, _, _) in STEPS.items() if not dtype.is_floating_point]
    for step in int_steps:
        dtype, n_ops, _ = STEPS[step]
        np_dtype = np.int32 if dtype == torch.int32 else np.uint32
        for shape in ((), (8, 128), (256, 1024)):
            draw = lambda low=0, high=2 ** 32: torch.from_numpy(np.asarray(  # noqa: E731
                rng.randint(low, high, shape, dtype=np.uint64).astype(np_dtype))).to(dev)
            # a divide's divisor is nonzero (x / 0 has no defined result), and
            # positive where signed (nor has INT_MIN / -1)
            divisor = (1, 2 ** 31 if dtype == torch.int32 else 2 ** 32)
            x = draw()
            ops = tuple(draw(*divisor) if i == 0 and step in DIVIDES else draw()
                        for i in range(n_ops))
            for n in (1, 45, 64, 512):
                want = op_chain_plain(x, *ops, step=step, n=n).cpu()
                for unroll in UNROLLS:
                    got = op_chain(x, *ops, step=step, n=n, unroll=unroll).cpu()
                    if not torch.equal(got, want):
                        fail(f"op_chain {step} n={n} unroll={unroll} {shape}: "
                             "differs from the plain version")
                # and the timed form: straight-line at 8 and 64, else a loop
                got, cycles = op_chain_timed(x, *ops, step=step, n=n)
                if not (torch.equal(got.cpu(), want) and bool((cycles > 0).all())):
                    fail(f"op_chain_timed {step} n={n} {shape}: differs from the plain "
                         "version, or a thread's cycles are not positive")
        if step in chain_names:  # and the registry row's own carry and operands
            spec = spec_by_name(step)
            x, ops = spec.carry(dev), spec.operand_tensors(dev)
            want = op_chain_plain(x, *ops, step=step, n=512).cpu()
            for unroll in UNROLLS:
                if not torch.equal(op_chain(x, *ops, step=step, n=512, unroll=unroll).cpu(), want):
                    fail(f"op_chain {step} on the row's inputs, n=512 unroll={unroll}: "
                         "differs from the plain version")
    print(f"K2 op_chain: the {len(int_steps)} integer steps x n in (1, 45, 64, 512) x "
          f"unroll {UNROLLS} and the timed form x (), (8, 128), (256, 1024) on random "
          "inputs, and each registry row's own inputs at n 512, bit-exact")

    # every in-kernel row on its own tile and inputs, as the inkernel plan runs
    # it: the timed form at its straight-line lengths, the loop form at an odd n
    ulps_seen = {}
    for spec in inkernel.supported_specs():
        carry, ops = inkernel.tiles(spec, device=dev)
        limit = ULPS if spec.name in ULP_ROWS else 0
        runs = [(f"timed n={n}", n, lambda n: op_chain_timed(carry, *ops, step=spec.name, n=n))
                for n in TIMED_LENS]
        runs += [(f"loop n=37 unroll={u}", 37,
                  lambda n, u=u: (op_chain(carry, *ops, step=spec.name, n=n, unroll=u), None))
                 for u in UNROLLS]
        for label, n, run in runs:
            got, cycles = run(n)
            want = op_chain_plain(carry, *ops, step=spec.name, n=n)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or got.shape != want.shape:
                fail(f"op_chain {spec.name} {label}: {got.dtype} {tuple(got.shape)}, plain "
                     f"{want.dtype} {tuple(want.shape)}")
            off = ulps(got, want)
            if off > limit:
                fail(f"op_chain {spec.name} {label}: {off} ulps from the plain version "
                     f"(limit {limit})")
            if cycles is not None and not bool((cycles > 0).all()):
                fail(f"op_chain_timed {spec.name} n={n}: a thread's cycles are not positive "
                     f"(min {int(cycles.min())})")
            ulps_seen[spec.name] = max(ulps_seen.get(spec.name, 0), off)
            err["op_chain"] = max(err["op_chain"],
                                  float((got.double() - want.double()).abs().max()))
    print(f"K2 op_chain: the {len(ulps_seen)} in-kernel rows on their tiles and inputs, the "
          f"timed form at n {TIMED_LENS} (every thread's cycles positive) and the loop form at "
          f"n 37: bit-exact but for {ULP_ROWS} (limit {ULPS} ulps); ulps off: "
          + ", ".join(f"{k} {v}" for k, v in ulps_seen.items() if v))

    check_float_specials(dev, rng)

    for ws in (1 << 13, 1 << 17, 1 << 21, 1 << 25):
        ring, start = build_ring(ws, device=dev)
        for steps in (512, 1536):
            got = chase(ring, start, steps=steps).cpu()
            if not torch.equal(got, chase_plain(ring, start, steps=steps).cpu()):
                fail(f"chase ws={ws} steps={steps}: differs from the plain version")
    print("K3 chase: ws 8 KiB, 128 KiB, 2 MiB, 32 MiB x steps (512, 1536) bit-exact "
          "(the path by footprint)")
    check_chase(dev)
    return err


def check_chase(dev: torch.device) -> None:
    """K3 against chase_plain, bit for bit: both paths (where the ring fits
    the smem budget) and both forms, on rings of 4 KiB, 64 KiB, 227 KiB (the
    budget) and 2 MiB, at 64, 192 and 37 steps, with and without a warm lap;
    the timed form's cycles positive; a start carried through ``out``
    continues where the last launch stopped; a forced smem ring above the
    budget and an unknown path raise."""
    from repro_torch.core.membench import build_ring
    from repro_torch.kernels.chase import (SMEM_BUDGET_BYTES, chase, chase_plain,
                                           chase_timed)

    checked = 0
    for ws in (4096, 1 << 16, SMEM_BUDGET_BYTES, 1 << 21):
        ring, start = build_ring(ws, device=dev)
        lap = ring.numel() // 16
        spaces = ("smem", "global") if ring.numel() * 4 <= SMEM_BUDGET_BYTES else ("global",)
        for space in spaces:
            for steps in (64, 192, 37):
                for warm in (0, lap):
                    want = chase_plain(ring, start, steps=steps, warm=warm).cpu()
                    got = chase(ring, start, steps=steps, warm=warm, memory_space=space)
                    p, cycles = chase_timed(ring, start, steps=steps, warm=warm,
                                            memory_space=space)
                    if not (torch.equal(got.cpu(), want) and torch.equal(p.cpu(), want)):
                        fail(f"chase ws={ws} {space} steps={steps} warm={warm}: "
                             f"{int(got[0])} / timed {int(p[0])}, plain {int(want[0])}")
                    if not int(cycles[0]) > 0:
                        fail(f"chase_timed ws={ws} {space} steps={steps} warm={warm}: "
                             f"{int(cycles[0])} cycles")
                    checked += 1
            pos = start.clone()  # carried: three launches of 37 are one of 111
            for form in (chase, lambda *a, **k: chase_timed(*a, **k)[0]):
                for _ in range(3):
                    form(ring, pos, steps=37, memory_space=space, out=pos)
            if not torch.equal(pos.cpu(), chase_plain(ring, start, steps=6 * 37).cpu()):
                fail(f"chase ws={ws} {space}: a carried start does not continue")
    big, big_start = build_ring(1 << 21, device=dev)
    for bad, match in (("smem", "does not fit"), ("vmem", "must be one of")):
        try:
            chase_timed(big, big_start, steps=64, memory_space=bad)
        except ValueError as e:
            if match not in str(e):
                raise
        else:
            fail(f"chase_timed memory_space={bad!r} on a 2 MiB ring did not raise")
    print(f"K3 chase: {checked} cases (ws 4 KiB, 64 KiB, 227 KiB, 2 MiB x smem where it fits "
          "and global x steps 64, 192, 37 x warm 0 and a lap), both forms bit-exact, every "
          "timed launch's cycles positive; a carried start continues; smem above the "
          "budget and an unknown path raise")

def row_scaled_ratio(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """``models.pathcheck.row_scaled_ratio``: the largest |got - want| /
    (tol * (|want| + rms(want's row))). Above 1 the comparison fails."""
    from repro_torch.models.pathcheck import row_scaled_ratio as ratio
    return ratio(got, want, tol)


def hold(label: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """Hold a kernel's output against its plain version under the
    row-scaled limit of its dtype; returns (max abs err, worst err/limit)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: got {got.dtype} {tuple(got.shape)}, plain version gives "
             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    tol = ROW_TOL[want.dtype]
    ratio = row_scaled_ratio(got, want, tol)
    err = float((got.float() - want.float()).abs().max())
    print(f"  {label}: max abs err {err:.3g}, limit {tol:.3g} * (|want| + rms(row)), "
          f"worst err/limit {ratio:.3f}")
    if ratio > 1.0:
        fail(f"{label}: disagrees with the plain version ({ratio:.3f} x the limit)")
    return err, ratio


def attention_bf16_acc(q, k, v, *, causal: bool):
    """Control: flash_attention_plain with p . v accumulated key by key in
    bfloat16 (each product and each running sum rounded), l in float32."""
    from repro_torch.kernels.common import NEG_INF

    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float().reshape(b, sq, kh, h // kh, d)
                     * d ** -0.5, k.float())
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pb, vb = p.bfloat16(), v.bfloat16()
    acc = torch.zeros(*p.shape[:-1], d, dtype=torch.bfloat16, device=q.device)
    for j in range(sk):
        acc = acc + pb[..., j, None] * vb[:, j, :, None, None, :]
    out = acc.float() / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared: what mma reads of a raw
    float32 register (TF32, truncated)."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def attention_1xtf32(q, k, v, *, causal: bool):
    """Control: flash_attention_plain with one TF32 product each in
    S = (q scale) . K^T and P . V: q scale, k, p and v truncated to TF32 by
    bit masking (the float32 einsums then multiply them exactly), l summed
    from float32 p."""
    from repro_torch.kernels.common import NEG_INF

    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qs = tf32_truncate(q.float().reshape(b, sq, kh, h // kh, d) * d ** -0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, tf32_truncate(k))
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = p.masked_fill(~mask, 0.0)
    out = torch.einsum("bkgqs,bskd->bkgqd", tf32_truncate(p), tf32_truncate(v))
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def decode_bf16_acc(q, k, v, kv_len):
    """Control: flash_decode_plain with p . v accumulated key by key in
    bfloat16, l in float32."""
    from repro_torch.kernels.common import NEG_INF

    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    logits = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(b, kh, h // kh, d)
                          * d ** -0.5, k.float())
    valid = (torch.arange(s, device=q.device)[None, :]
             < kv_len.long()[:, None])[:, None, None, :]
    logits = logits.masked_fill(~valid, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pb, vb = p.bfloat16(), v.bfloat16()
    acc = torch.zeros(b, kh, h // kh, d, dtype=torch.bfloat16, device=q.device)
    for j in range(s):
        acc = acc + pb[..., j, None] * vb[:, j, :, None, :]
    return (acc.float() / l.clamp_min(1e-30)).reshape(b, h, d).to(q.dtype)


def jamba_inputs(dev: torch.device) -> dict[str, tuple]:
    """Seeded inputs at the widths of Jamba-v0.1 52B
    (src/repro/configs/jamba_v0_1_52b.py): the args of each case, as the
    wrapper takes them, plus its keywords."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def lens(*n):
        return torch.tensor(n, dtype=torch.int32, device=dev)

    bf16 = torch.bfloat16
    kv_len = lens(8192, 8191, 4097, 4096, 1000, 129, 1, 0)
    x_off = randn(2048 * 4096 + 8, dtype=bf16)[1:1 + 2048 * 4096].view(2048, 4096)
    return {
        "rmsnorm bf16 x[2048,4096]": (
            "rmsnorm", (randn(2048, 4096, dtype=bf16),
                        (1.0 + randn(4096, scale=0.1)).to(bf16)), {}),
        "rmsnorm bf16 x[2048,1000]": (
            "rmsnorm", (randn(2048, 1000, dtype=bf16),
                        (1.0 + randn(1000, scale=0.1)).to(bf16)), {}),
        "rmsnorm bf16 x[2048,4100]": (
            "rmsnorm", (randn(2048, 4100, dtype=bf16),
                        (1.0 + randn(4100, scale=0.1)).to(bf16)), {}),
        "rmsnorm bf16 x[2048,4096] 2 bytes off a 16-byte boundary": (
            "rmsnorm", (x_off, (1.0 + randn(4096, scale=0.1)).to(bf16)), {}),
        "flash_attention bf16 causal q[1,2048,32,128] kv[1,2048,8,128]": (
            "flash_attention", (randn(1, 2048, 32, 128, dtype=bf16),
                                randn(1, 2048, 8, 128, dtype=bf16),
                                randn(1, 2048, 8, 128, dtype=bf16)), {"causal": True}),
        "flash_attention f32 causal q[1,2048,32,128] kv[1,2048,8,128]": (
            "flash_attention", (randn(1, 2048, 32, 128), randn(1, 2048, 8, 128),
                                randn(1, 2048, 8, 128)), {"causal": True}),
        "flash_attention bf16 causal prefix q[1,512,32,128] kv[1,2048,8,128]": (
            "flash_attention", (randn(1, 512, 32, 128, dtype=bf16),
                                randn(1, 2048, 8, 128, dtype=bf16),
                                randn(1, 2048, 8, 128, dtype=bf16)), {"causal": True}),
        SEES_NO_KEY: (
            "flash_attention", (randn(1, 100, 32, 128, dtype=bf16),
                                randn(1, 37, 8, 128, dtype=bf16),
                                randn(1, 37, 8, 128, dtype=bf16)), {"causal": True}),
        "flash_attention bf16 non-causal q[1,2048,32,64] kv[1,2048,8,64]": (
            "flash_attention", (randn(1, 2048, 32, 64, dtype=bf16),
                                randn(1, 2048, 8, 64, dtype=bf16),
                                randn(1, 2048, 8, 64, dtype=bf16)), {"causal": False}),
        "flash_attention bf16 causal ragged q[1,1000,32,128] kv[1,1937,8,128]": (
            "flash_attention", (randn(1, 1000, 32, 128, dtype=bf16),
                                randn(1, 1937, 8, 128, dtype=bf16),
                                randn(1, 1937, 8, 128, dtype=bf16)), {"causal": True}),
        SEES_NO_KEY_F32: (
            "flash_attention", (randn(1, 100, 32, 128), randn(1, 37, 8, 128),
                                randn(1, 37, 8, 128)), {"causal": True}),
        "flash_attention f32 non-causal q[1,2048,32,64] kv[1,2048,8,64]": (
            "flash_attention", (randn(1, 2048, 32, 64), randn(1, 2048, 8, 64),
                                randn(1, 2048, 8, 64)), {"causal": False}),
        "flash_attention f32 causal ragged q[1,1000,32,128] kv[1,1937,8,128]": (
            "flash_attention", (randn(1, 1000, 32, 128), randn(1, 1937, 8, 128),
                                randn(1, 1937, 8, 128)), {"causal": True}),
        "flash_decode bf16 q[8,32,128] kv[8,8192,8,128] kv_len "
        "(8192,8191,4097,4096,1000,129,1,0)": (
            "flash_decode", (randn(8, 32, 128, dtype=bf16),
                             randn(8, 8192, 8, 128, dtype=bf16),
                             randn(8, 8192, 8, 128, dtype=bf16), kv_len), {}),
        DECODE_LONG: (
            "flash_decode", (randn(1, 32, 128, dtype=bf16),
                             randn(1, 32768, 8, 128, dtype=bf16),
                             randn(1, 32768, 8, 128, dtype=bf16), lens(32768)), {}),
        "flash_decode bf16 q[7,32,128] kv[7,1536,8,128] kv_len "
        "(511,512,513,1023,1024,1025,0)": (
            "flash_decode", (randn(7, 32, 128, dtype=bf16),
                             randn(7, 1536, 8, 128, dtype=bf16),
                             randn(7, 1536, 8, 128, dtype=bf16),
                             lens(511, 512, 513, 1023, 1024, 1025, 0)), {}),
        "flash_decode f32 q[8,32,128] kv[8,8192,8,128] kv_len "
        "(8192,8191,4097,4096,1000,129,1,0)": (
            "flash_decode", (randn(8, 32, 128), randn(8, 8192, 8, 128),
                             randn(8, 8192, 8, 128), kv_len), {}),
        "mamba_scan f32 x,dt[1,2048,8192] N 16 chunk 64": (
            "mamba_scan", (randn(1, 2048, 8192, scale=0.5), randn(1, 2048, 8192, scale=0.1),
                           -torch.exp(randn(8192, 16, scale=0.3)),
                           randn(1, 2048, 16, scale=0.5), randn(1, 2048, 16, scale=0.5),
                           randn(8192, scale=0.1)), {"chunk": 64}),
        SCAN_STATE: (
            "mamba_scan", (randn(2, 2048, 1000, scale=0.5), randn(2, 2048, 1000, scale=0.1),
                           -torch.exp(randn(1000, 16, scale=0.3)),
                           randn(2, 2048, 16, scale=0.5), randn(2, 2048, 16, scale=0.5),
                           randn(1000, scale=0.1)), {"chunk": 7, "return_state": True}),
    }


# K6's batch-1 cache of 32768 keys, where the split over the sequence
# matters most (64 splits for each of the 8 KV heads).
DECODE_LONG = "flash_decode bf16 q[1,32,128] kv[1,32768,8,128] kv_len 32768"

# A second case timed beside the Jamba one, under its key in the kernels
# line: K5 in float32 (each dtype runs its own design: wgmma for bf16,
# 3xTF32 mma.sync for float32); K6 at the batch-1 cache.
JAMBA_TIMED_MORE = {
    "flash_attention": ("jamba_f32",
                        "flash_attention f32 causal q[1,2048,32,128] kv[1,2048,8,128]"),
    "flash_decode": ("jamba_long", DECODE_LONG),
}

# K5's cases whose first Sq - Sk = 63 query rows see no key: they must be 0.
SEES_NO_KEY = "flash_attention bf16 causal q[1,100,32,128] kv[1,37,8,128]"
SEES_NO_KEY_F32 = "flash_attention f32 causal q[1,100,32,128] kv[1,37,8,128]"

# K7 at Dm 1000 (not a multiple of a block's 64 channels), batch 2, also
# returning its final state h [2, 1000, 16].
SCAN_STATE = "mamba_scan f32 x,dt[2,2048,1000] N 16 chunk 7 return_state"

# The case of each fused kernel that chip_smoke times at Jamba widths.
JAMBA_TIMED = {
    "rmsnorm": "rmsnorm bf16 x[2048,4096]",
    "flash_attention": "flash_attention bf16 causal q[1,2048,32,128] kv[1,2048,8,128]",
    "flash_decode": "flash_decode bf16 q[8,32,128] kv[8,8192,8,128] kv_len "
                    "(8192,8191,4097,4096,1000,129,1,0)",
    "mamba_scan": "mamba_scan f32 x,dt[1,2048,8192] N 16 chunk 64",
}


def case_design(name: str, args: tuple) -> str:
    """The instance K4 or K6 runs for these inputs (empty for the others)."""
    if name == "rmsnorm":
        from repro_torch.kernels.rmsnorm import rmsnorm_plan

        x, w = args
        aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
        return rmsnorm_plan(x.shape[-1], x.dtype, aligned).design
    if name == "flash_decode":
        from repro_torch.kernels.flash_decode import KEYS_PER_SPLIT, split_count

        q, k, _, kv_len = args
        n, kh = split_count(k.shape[1]), k.shape[2]
        live = sum(split_count(t) for t in kv_len.clamp(0, k.shape[1]).tolist() if t > 0)
        return (f"split-KV, {n} split(s) of {KEYS_PER_SPLIT} keys a row, {live * kh} "
                f"live blocks of {n * kh * q.shape[0]}, "
                + ("a combine pass" if n > 1 else "no combine pass"))
    if name == "mamba_scan":
        from repro_torch.kernels.mamba_scan import scan_vectorized

        x, dt, _, b, c, _ = args
        return ("16-byte" if scan_vectorized(x, dt, b, c) else "4-byte") + " copies"
    return ""


def fused_modules() -> dict:
    from repro_torch.kernels import flash_attention, flash_decode, mamba_scan, rmsnorm

    return {m.__name__.rsplit(".", 1)[1]: m
            for m in (rmsnorm, flash_attention, flash_decode, mamba_scan)}


def check_fused_kernels(dev: torch.device, cases: dict) -> tuple[dict, dict]:
    """Phase 2, K4-K7: each kernel against its plain version at the fused
    plan's unit workloads (n = 2 and 6) and at the Jamba cases, under the
    row-scaled limits; and the bf16-accumulating control, which must fail
    them. Returns (max abs err per kernel at the unit workloads, Jamba
    results per case)."""
    from repro_torch.inkernel import FUSED_KERNELS, FUSED_LENS, build_fused, fused_kwargs

    # The plain versions' einsums must run in full float32. TF32 is off by
    # default; assigning the flag anyway turns matmul.fp32_precision from
    # "none" to "ieee", which is part of Inductor's cache key, and every
    # chain the compile workers build for the quick run would then miss.
    if torch.backends.cuda.matmul.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
    mods = fused_modules()
    err = {}
    for name in FUSED_KERNELS:
        err[name] = 0.0
        for n in FUSED_LENS:
            fn, args = build_fused(name, n, dev)
            plain = getattr(mods[name], f"{name}_plain")
            e, _ = hold(f"{name} unit workload n={n}", fn(*args),
                        plain(*args, **fused_kwargs(name)))
            err[name] = max(err[name], e)
    jamba = {}
    for label, (name, args, kw) in cases.items():
        wrapper = getattr(mods[name], name)
        plain = getattr(mods[name], f"{name}_plain")
        got, want = wrapper(*args, **kw), plain(*args, **kw)
        if kw.get("return_state"):  # (y, h): the final state is held too
            (got, h), (want, want_h) = got, want
            e_h, ratio_h = hold(f"{name} Jamba {label}, final state h", h, want_h)
        e, ratio = hold(f"{name} Jamba {label}", got, want)
        jamba[label] = {"max_abs_err": e, "err_over_limit": ratio}
        if kw.get("return_state"):
            jamba[label].update(state_max_abs_err=e_h, state_err_over_limit=ratio_h)
        design = case_design(name, args)
        if design:
            print(f"  {label}: design {design}")
            jamba[label]["design"] = design
        if name == "flash_decode":
            empty = (args[3] <= 0).nonzero().flatten().tolist()
            if not bool((got[empty] == 0).all()):
                fail(f"{label}: a row of kv_len 0 is not exactly 0")
            if empty:
                print(f"  {label}: the rows of kv_len 0 ({empty}) are exactly 0")
        if label in (SEES_NO_KEY, SEES_NO_KEY_F32):
            blind = args[0].shape[1] - args[1].shape[1]
            if not bool((got[:, :blind] == 0).all()):
                fail(f"{label}: a query row that sees no key is not exactly 0")
            print(f"  {label}: the {blind} rows that see no key are exactly 0")
    controls = {  # label: (kernel, what the control does, the control)
        JAMBA_TIMED["flash_attention"]: (
            "flash_attention", "p.v accumulated in bf16",
            lambda a, kw: attention_bf16_acc(*a, **kw)),
        JAMBA_TIMED["flash_decode"]: (
            "flash_decode", "p.v accumulated in bf16", lambda a, kw: decode_bf16_acc(*a)),
        JAMBA_TIMED_MORE["flash_attention"][1]: (
            "flash_attention", "one TF32 product (1xTF32, bit-masked)",
            lambda a, kw: attention_1xtf32(*a, **kw)),
    }
    for label, (name, what, control) in controls.items():
        _, args, kw = cases[label]
        want = getattr(mods[name], f"{name}_plain")(*args, **kw)
        ratio = row_scaled_ratio(control(args, kw), want, ROW_TOL[want.dtype])
        print(f"  control {name} with {what}, Jamba {label}: "
              f"worst err/limit {ratio:.3f} -> {'REJECTED' if ratio > 1 else 'passed'}")
        if ratio <= 1.0:
            fail(f"the control of {name} with {what} passes the limit: the "
                 "limit cannot tell a sound kernel from an unsound one")
        jamba[label]["control_err_over_limit"] = ratio
    # a datum, not a gate: SDPA's own error on K5's Jamba case
    label = JAMBA_TIMED["flash_attention"]
    _, args, kw = cases[label]
    sdpa = library_call("flash_attention", args, kw)().transpose(1, 2)
    ratio = row_scaled_ratio(sdpa, mods["flash_attention"].flash_attention_plain(*args, **kw),
                             ROW_TOL[torch.bfloat16])
    print(f"  SDPA (a yardstick, not the port) on Jamba {label}: worst err/limit {ratio:.3f}")
    jamba[label]["sdpa_err_over_limit"] = ratio
    print(f"K4-K7: unit workloads n in {FUSED_LENS} and {len(cases)} Jamba cases agree")
    return err, jamba


def run_quick(dev: torch.device, db_path: str, cache_dir: Path) -> dict[str, int]:
    """Phase 3: the quick plan through the CLI into ``db_path``, with the
    run's compile cache and ``--serial`` (its probes are timed once all of
    its chains have landed); returns each kernel's launches during that
    run."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment

    zero_counts()
    rc = cli_main(["characterize", "--plan", "quick", "--db", db_path, "--table",
                   "--audit", "--compile-cache", str(cache_dir), "--serial"])
    launches = read_counts()
    if rc != 0:
        fail(f"characterize --plan quick exited {rc}")
    db = LatencyDB(db_path)
    env = current_environment(dev)
    if db.failures():
        fail(f"ProbeFailures in the quick DB: {[f.op for f in db.failures()]}")
    for probe in named_plan("quick"):
        rec = db.get(probe.key(env))
        if rec is None:
            fail(f"no record for {probe.op}@{probe.opt_level}")
        # the in-kernel chain on the SM clock sandwich, every other row on events
        clock = "clock=sm_clock64@" if probe.op.startswith("kernel.") else "clock=events"
        if not (math.isfinite(rec.latency_ns) and rec.latency_ns >= 0
                and rec.n_samples > 0 and clock in rec.notes):
            fail(f"bad record {rec}")
        check_cycles(rec)
        if probe.op.startswith("kernel."):
            print(f"quick: {probe.op} {rec.latency_ns:.3f} ns, {rec.cycles:.2f} cycles "
                  f"(MAD {rec.mad_ns:.3f} ns; notes {rec.notes})")
    print(f"quick: {len(db)} records for the {len(named_plan('quick'))} probes of "
          f"the plan, no failures; launches {launches}")
    for name in QUICK_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched by the quick run")
    return launches


# ------------------------------------------------------------ table2
# compile phases (Dynamo's and Inductor's timers, measure.compile_phases) by
# the name printed for them; each a sum of timers, nested ones not repeated
COMPILE_PHASES = {
    "dynamo": ("bytecode_tracing",),
    "backend": ("OutputGraph.call_user_compiler",),
    "lower": ("GraphLowering.run",),
    "sched": ("Scheduler.__init__",),
    "codegen": ("Scheduler.codegen",),
    "load": ("PyCodeCache.load_by_key_path",),
    "triton": ("async_compile.precompile", "CachingAutotuner.precompile",
               "CachingAutotuner.benchmark_all_configs"),
}


def compile_table(pool, rows: list[str]) -> dict[tuple[str, int], dict]:
    """Each O3 chain the pool warmed for ``rows``: print its compile seconds
    by phase (COMPILE_PHASES) and its SASS size, then the sums by chain
    length; returns the results by (row, n)."""
    results = {}
    for (_, _, name, level, n, _), fut in pool.futures.items():
        if name in rows and fut.done() and not fut.cancelled() and fut.exception() is None:
            results[(name, n)] = fut.result()

    def cols(phases: dict) -> str:
        return " ".join(f"{k} {sum(phases.get(t, 0.0) for t in ts):.1f}"
                        for k, ts in COMPILE_PHASES.items())

    for (name, n), r in sorted(results.items(), key=lambda kv: -kv[1]["s"]):
        print(f"compile: {name}@O3 n {n}: {r['s']:.1f} s ({cols(r['phases'])}); "
              f"{sum(r['sass'].values())} SASS instructions in {r['cubins']} cubin(s)")
    if results:
        first = min(r["started_at"] for r in results.values()) - pool.started_at
        last = max(r["done_at"] for r in results.values()) - pool.started_at
        busy = sum(r["done_at"] - r["started_at"] for r in results.values())
        print(f"compile pool: these {len(results)} chains ran from {first:.1f} s to {last:.1f} "
              f"s after the pool started, {busy:.1f} worker-seconds in all ({pool.workers} "
              "workers)")
    for n in sorted({n for _, n in results}):
        mine = [r for (_, m), r in results.items() if m == n]
        total = {}
        for r in mine:
            for k, v in r["phases"].items():
                total[k] = total.get(k, 0.0) + v
        print(f"compile: {len(mine)} chains of n {n}: {sum(r['s'] for r in mine):.1f} s "
              f"({cols(total)})")
    return results


def per_step_sass(results: dict, name: str, lens: tuple[int, int]) -> tuple[float, dict]:
    """What one step of row ``name``'s O3 chain runs: the SASS of its chain
    at the longer length less that at the shorter, over the steps between
    (instructions a step, and each mnemonic's count a step)."""
    a, b = results[(name, lens[0])]["sass"], results[(name, lens[1])]["sass"]
    steps = lens[1] - lens[0]
    delta = {m: (b.get(m, 0) - a.get(m, 0)) / steps for m in set(a) | set(b)}
    per = {m: d for m, d in sorted(delta.items(), key=lambda kv: -kv[1]) if abs(d) >= 0.05}
    return sum(b.values()) / steps - sum(a.values()) / steps, per


def run_table2(dev: torch.device, db_path: str, pool, cache_dir: Path) -> dict[str, int]:
    """Phase 4: the table2 plan through the CLI on the quick plan's DB, with
    the run's compile cache and ``--serial`` (its 32 probes shared with
    quick are cache hits; each probe is prepared as soon as its chains have
    landed and timed once they all have, after the pool; this process's own
    tasks run in its waits: phase o1 among them, which counts its own
    launches from 0 and puts table2's back after); returns each kernel's
    launches during that run. Every probe of the plan must end with a
    record timed by CUDA events, K2 must be launched, and each half
    precision row's O3 chain must equal its eager chain bit for bit at both
    lengths. A probe may fail only where the SASS of its O3 chain shows
    fewer than one instruction a step (the compiler folded the chain)."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core import chains, measure
    from repro_torch.core.latency_db import LatencyDB, current_environment

    zero_counts()
    # --serial: its rows are timed once every chain has landed, after the
    # pool (tools/wait_study.py missed its bound in the pool's wait, PERF.md)
    rc = cli_main(["characterize", "--plan", "table2", "--db", db_path, "--table",
                   "--audit", "--compile-cache", str(cache_dir), "--serial"])
    launches = read_counts()
    db = LatencyDB(db_path)
    env = current_environment(dev)
    plan = named_plan("table2")
    registry = chains.default_registry()
    lens = measure._CHAIN_LENS["O3"]
    results = compile_table(pool, [s.name for s in registry])

    folded = {}
    for spec in registry:
        if spec.kernel is not None:
            continue
        if any((spec.name, n) not in results for n in lens):
            if spec.dtype in measure.HALF_DTYPES:
                fail(f"{spec.name}@O3: no compile worker result at n {lens}")
            continue
        per, hist = per_step_sass(results, spec.name, lens)
        if per < 1.0:
            folded[spec.name] = (per, hist)
        if spec.dtype in measure.HALF_DTYPES:  # F3: every step rounds
            for n in lens:
                eager = chains.chain_fn(spec, n)(spec.carry(dev), *spec.operand_tensors(dev))
                got = results[(spec.name, n)]["out"]
                if got != eager.item():
                    fail(f"{spec.name}@O3 n {n}: {got!r}, its eager chain {eager.item()!r}")
            claimed = measure.HALF_O3_STEP_SASS[spec.name].split("+")
            if not all(sum(c for m, c in hist.items() if m.startswith(p)) >= 0.99
                       for p in claimed):
                fail(f"{spec.name}@O3: a step does not run each of {claimed} (its notes): "
                     f"{hist}")
            print(f"table2: {spec.name}@O3 equals its eager chain at n {lens}; "
                  f"a step runs {per:.2f} instructions: {hist}")

    for name, (per, hist) in folded.items():
        counts = [sum(results[(name, n)]["sass"].values()) for n in lens]
        print(f"table2: {name}@O3 is folded by the compiler: its kernel holds {counts[0]} "
              f"SASS instructions at n {lens[0]} and {counts[1]} at n {lens[1]}, "
              f"{per:.3f} a step ({hist}); its O3 row times no chain of steps")
    failures = {(f.op, f.opt_level): f for f in db.failures()}
    for probe in plan:
        rec = db.get(probe.key(env))
        if rec is None:
            f = failures.get((probe.op, probe.opt_level))
            if probe.opt_level == "O3" and probe.op in folded:
                print(f"table2: {probe.op}@O3 failed ({f.error_type}: {f.message}); its "
                      "O3 chain is folded (above)")
                continue
            fail(f"no record for {probe.op}@{probe.opt_level}: {f}")
        if not (math.isfinite(rec.latency_ns) and rec.latency_ns >= 0 and rec.n_samples > 0
                and "clock=events" in rec.notes):
            fail(f"bad record {rec}")
        check_cycles(rec)
    for spec in registry:
        cells = []
        for level in ("O0", "O3"):
            rec = db.get((env["device_kind"], env["backend"], env["jax_version"], level,
                          spec.name, spec.dtype))
            cells.append(f"{level} " + ("failed" if rec is None else
                                        f"{rec.latency_ns:.1f} ns (MAD {rec.mad_ns:.1f}, "
                                        f"net {rec.net_latency_ns:.1f})"))
        sass = ""
        if spec.kernel is None and all((spec.name, n) in results for n in lens):
            per, hist = per_step_sass(results, spec.name, lens)
            same = ["=" if results[(spec.name, n)]["out"] == chains.chain_fn(spec, n)(
                spec.carry(dev), *spec.operand_tensors(dev)).item() else "!=" for n in lens]
            sass = (f"; O3 result {'/'.join(same)} eager at n {lens[0]}/{lens[1]}"
                    f"; O3 step {per:.2f} SASS: "
                    + ", ".join(f"{m} {c:g}" for m, c in list(hist.items())[:4]))
        print(f"table2: {spec.category} {spec.name} {spec.dtype}: {'; '.join(cells)}{sass}; "
              f"notes: {(rec.notes if rec is not None else spec.notes)}")
    if rc != (1 if failures else 0):
        fail(f"characterize --plan table2 exited {rc} with {len(failures)} failures")
    print(f"table2: {len(plan) - len(failures)} of the {len(plan)} probes recorded, "
          f"{len(failures)} failed ({', '.join(f'{o}@{l}' for o, l in failures)}); "
          f"launches {launches}")
    if launches["op_chain"] == 0:
        fail("kernel op_chain was not launched by the table2 run")
    return launches


def zero_counts() -> None:
    """Set every launch count to 0 (``kernels.ops.COUNTED``), K3's by form
    and path too."""
    from repro_torch.kernels.chase import chase
    from repro_torch.kernels.ops import COUNTED
    for k in COUNTED:
        k.launches = 0
    chase.launches_by_path.clear()


def read_counts() -> dict[str, int]:
    """Each wrapper's launches since :func:`zero_counts`, and K3's by form
    and path (``chase/timed/smem``, ...)."""
    from repro_torch.kernels.ops import launch_counts
    return launch_counts()


def check_cycles(rec) -> None:
    """A record made on the card counts ``cycles`` on the SM clock its notes
    name (``cycles_at=sm_clock64@<MHz>``): cycles == ns x that clock."""
    m = re.search(r"cycles_at=sm_clock64@(\d+)", rec.notes)
    if not m:
        fail(f"{rec.op}@{rec.opt_level}: its notes name no SM clock for cycles: {rec.notes}")
    want = rec.latency_ns * int(m[1]) * 1e6 / 1e9
    if not math.isclose(rec.cycles, want, rel_tol=1e-3, abs_tol=1e-6):
        fail(f"{rec.op}@{rec.opt_level}: {rec.cycles} cycles, but {rec.latency_ns} ns at "
             f"{m[1]} MHz is {want}")


def run_inkernel(dev: torch.device, db_path: str,
                 timed_sass: dict[str, tuple[float, dict]]) -> dict[str, int]:
    """Phase 5: the inkernel plan through the CLI on table2's DB, with its
    ``--table``; returns each kernel's launches during that run. Every
    ``inkernel.<row>`` probe must end with a record timed by K2's SM clock
    sandwich, except a row whose timed SASS shows it folded (under one
    instruction a step), which may end as a NoisySlopeError; every
    dispatch twin that table2 recorded must be a cache hit (a twin table2
    could not record, a folded O3 chain, runs again and may fail again);
    K2 must be launched; the pairing table must be printed. Prints the
    in-kernel Table II: each row's ns and SM cycles a step beside its
    dispatch twin."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment

    env = current_environment(dev)
    plan = named_plan("inkernel")
    twins = [p for p in plan if not p.op.startswith("inkernel.")]
    before = LatencyDB(db_path)
    recorded = {p.op: before.get(p.key(env)).measured_at for p in twins
                if p.key(env) in before}
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["characterize", "--plan", "inkernel", "--db", db_path, "--table",
                       "--audit"])
    launches = read_counts()
    out = buf.getvalue()
    print(out, end="")
    db = LatencyDB(db_path)
    failures = {(f.op, f.opt_level): f for f in db.failures()}
    failed = []
    for probe in plan:
        rec = db.get(probe.key(env))
        if rec is None:
            f = failures.get((probe.op, probe.opt_level))
            failed.append(probe.op)
            row = probe.op.removeprefix("inkernel.")
            if probe.op.startswith("inkernel.") and timed_sass[row][0] < 1.0 \
                    and f is not None and f.error_type == "NoisySlopeError":
                print(f"inkernel: {probe.op} failed ({f.error_type}: {f.message}); its timed "
                      f"chain is folded: {timed_sass[row][0]:.3f} SASS instructions a step")
                continue
            if probe in twins and probe.op not in recorded:
                print(f"inkernel: its twin {probe.op}@O3 failed again "
                      f"({f.error_type if f else None}); table2 could not record it either")
                continue
            fail(f"no record for {probe.op}@{probe.opt_level}: {f}")
        check_cycles(rec)
        if probe in twins:
            if probe.op in recorded and rec.measured_at != recorded[probe.op]:
                fail(f"{probe.op}@O3: measured again, not a cache hit of table2's record")
            continue
        if not (math.isfinite(rec.latency_ns) and rec.latency_ns >= 0 and rec.n_samples > 0
                and "clock=sm_clock64@" in rec.notes):
            fail(f"bad record {rec}")
    m = re.search(r"(\d+) measured, (\d+) cached, (\d+) failed", out)
    if not m or int(m[2]) != len(recorded) or int(m[3]) != len(failed):
        fail(f"inkernel: expected {len(recorded)} cached and {len(failed)} failed, got "
             f"{m[0] if m else out[-300:]}")
    if rc != (1 if failed else 0):
        fail(f"characterize --plan inkernel exited {rc} with {len(failed)} failures")
    if "== host vs in-kernel" not in out:
        fail("characterize --plan inkernel --table printed no pairing table")
    for spec in [p.spec for p in plan if p.op.startswith("inkernel.")]:
        ik = db.get((env["device_kind"], env["backend"], env["jax_version"], "O3",
                     f"inkernel.{spec.name}", spec.dtype))
        d = db.get((env["device_kind"], env["backend"], env["jax_version"], "O3",
                    spec.name, spec.dtype))
        per, hist = timed_sass[spec.name]
        cells = ("failed" if ik is None else
                 f"{ik.latency_ns:.3f} ns = {ik.cycles:.2f} cycles a step (MAD "
                 f"{ik.mad_ns:.3f} ns, net {ik.net_latency_ns:.3f} ns)")
        twin = "failed" if d is None else f"{d.latency_ns:.2f} ns ({d.cycles:.1f} cycles)"
        ratio = (f"{ik.latency_ns / d.latency_ns:.3f}" if ik is not None and d is not None
                 and d.latency_ns > 0 else "-")
        print(f"inkernel: {spec.category} {spec.name} {spec.dtype}: in-kernel {cells}; "
              f"dispatch O3 {twin}; in-kernel/dispatch {ratio}; a step runs {per:.2f} SASS: "
              + ", ".join(f"{k} {c:g}" for k, c in list(hist.items())[:4]))
    print(f"inkernel: {len(plan) - len(failed)} of the {len(plan)} probes recorded, "
          f"{len(recorded)} dispatch twins cached from table2, {len(failed)} failed "
          f"({', '.join(failed) or 'none'}); launches {launches}")
    if launches["op_chain"] == 0:
        fail("kernel op_chain was not launched by the inkernel run")
    return launches


def rung_fields(rec) -> dict[str, str]:
    """A memory row's ``key=value`` notes."""
    from repro_torch.utils import parse_kv_notes
    return parse_kv_notes(rec.notes)


def run_memory(dev: torch.device, db_path: str) -> dict[str, int]:
    """Phase 6: the memory plan through the CLI with its ``--table``, on the
    DB of the phases before, the launch counts set to 0 just before and read
    just after: every one of its 14 rungs must end with a record timed by
    events that states the level rule (``warm=``, ``carry=``), and K3 must
    be launched. Prints the ladder (ns and SM cycles a load, cold_ns, warm,
    carry), ``detect_levels``' levels and the streaming bandwidth."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment
    from repro_torch.core.membench import (L1_BYTES, bandwidth_probe, detect_levels,
                                           mempoint_from_record)
    from repro_torch.core.timing import Timer

    env = current_environment(dev)
    plan = named_plan("memory")
    zero_counts()
    rc = cli_main(["characterize", "--plan", "memory", "--db", db_path, "--table",
                       "--audit"])
    launches = read_counts()
    if rc != 0:
        fail(f"characterize --plan memory exited {rc}")
    db = LatencyDB(db_path)
    points = []
    for probe in plan:
        rec = db.get(probe.key(env))
        if rec is None:
            fail(f"no record for {probe.op}")
        f = rung_fields(rec)
        if not (math.isfinite(rec.latency_ns) and rec.latency_ns > 0 and "clock=events" in
                rec.notes and {"warm", "carry", "cold_ns"} <= set(f)):
            fail(f"bad record {rec}")
        check_cycles(rec)
        fits = probe.working_set_bytes < L1_BYTES
        if (f["carry"] == "1") == fits or (int(f["warm"]) > 0) != fits:
            fail(f"{probe.op}: warm={f['warm']} carry={f['carry']} is not the level rule")
        pt = mempoint_from_record(rec)
        points.append(pt)
        print(f"memory: {probe.op}: {rec.latency_ns:.3f} ns = {rec.cycles:.1f} SM cycles a "
              f"load, cold {pt.cold_latency_ns:.3f} ns, warm={f['warm']} carry={f['carry']}")
    for lv in detect_levels(points):
        print(f"memory: level {lv['level']}: up to {lv['capacity_bytes_lower_bound']} B, "
              f"{lv['hit_latency_ns']:.3f} ns (detect_levels, jump 1.6x)")
    gbs = bandwidth_probe(1 << 28, timer=Timer(warmup=2, reps=10, device=dev))
    print(f"memory: bandwidth_probe {gbs:.1f} GB/s (one elementwise pass over 256 MiB "
          "float32, read + write, PyTorch's kernel)")
    print(f"memory: {len(plan)} rungs recorded; launches {launches}")
    if launches["chase"] == 0:
        fail("kernel chase was not launched by the memory run")
    return launches


def run_memory_inkernel(dev: torch.device, db_path: str) -> dict[str, int]:
    """Phase 7: the memory-inkernel plan through the CLI with its ``--table``
    on the memory plan's DB, the launch counts set to 0 just before and read
    just after: its 7 ``inkernel.mem.<N>`` rungs must end with records timed
    by K3's SM clock sandwich, from shared memory at 64 KiB and global
    memory above; the 6 host twins the memory plan recorded must be cache
    hits and the 64 MiB twin measured; K3 must be launched in its timed
    form on both paths; the pairing table must be printed. Prints the
    in-kernel ladder beside its host twins, and its levels."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment
    from repro_torch.core.membench import chasepoint_from_record, detect_levels
    from repro_torch.kernels.chase import SMEM_BUDGET_BYTES

    env = current_environment(dev)
    plan = named_plan("memory-inkernel")
    rungs = [p for p in plan if p.op.startswith("inkernel.")]
    twins = [p for p in plan if not p.op.startswith("inkernel.")]
    before = LatencyDB(db_path)
    recorded = {p.op: before.get(p.key(env)).measured_at for p in twins if p.key(env) in before}
    if len(recorded) != 6:
        fail(f"memory-inkernel: {len(recorded)} host twins in the memory plan's DB, not 6")
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["characterize", "--plan", "memory-inkernel", "--db", db_path, "--table",
                       "--audit"])
    launches = read_counts()
    out = buf.getvalue()
    print(out, end="")
    if rc != 0:
        fail(f"characterize --plan memory-inkernel exited {rc}")
    m = re.search(r"(\d+) measured, (\d+) cached, (\d+) failed", out)
    if not m or (int(m[1]), int(m[2]), int(m[3])) != (8, 6, 0):
        fail(f"memory-inkernel: expected 8 measured, 6 cached, 0 failed, got "
             f"{m[0] if m else out[-300:]}")
    if "== host vs in-kernel" not in out:
        fail("characterize --plan memory-inkernel --table printed no pairing table")
    db = LatencyDB(db_path)
    points = []
    for probe in rungs:
        rec, twin = db.get(probe.key(env)), db.get(probe_twin(probe, twins).key(env))
        if rec is None or twin is None:
            fail(f"no record for {probe.op} or its twin")
        space = "smem" if probe.working_set_bytes <= SMEM_BUDGET_BYTES else "global"
        f = rung_fields(rec)
        if not (math.isfinite(rec.latency_ns) and rec.latency_ns > 0
                and rec.notes.startswith("cuda chase ") and f.get("space") == space
                and "clock=sm_clock64@" in rec.notes and {"warm", "carry"} <= set(f)):
            fail(f"bad record {rec}")
        check_cycles(rec)
        t = probe_twin(probe, twins)
        if t.op in recorded and twin.measured_at != recorded[t.op]:
            fail(f"{t.op}: measured again, not a cache hit of the memory plan's record")
        points.append(chasepoint_from_record(rec))
        tf = rung_fields(twin)
        print(f"memory-inkernel: {probe.op} ({space}): {rec.latency_ns:.3f} ns = "
              f"{rec.cycles:.1f} SM cycles a load (MAD {rec.mad_ns:.3f} ns), warm={f['warm']} "
              f"carry={f['carry']}; host twin {twin.latency_ns:.3f} ns = {twin.cycles:.1f} "
              f"cycles (warm={tf['warm']} carry={tf['carry']}"
              f"{', cached' if t.op in recorded else ', measured'})")
    for lv in detect_levels(points):
        print(f"memory-inkernel: level {lv['level']}: up to {lv['capacity_bytes_lower_bound']}"
              f" B, {lv['hit_latency_ns']:.3f} ns (detect_levels, jump 1.6x)")
    ns = {p.working_set_bytes: p.latency_ns for p in points}
    l2 = [ns[w] for w in (1 << 20, 4 << 20, 16 << 20)]
    print(f"memory-inkernel: the smem rung below every L2 rung (1-16 MiB): "
          f"{ns[64 << 10] < min(l2)}; the 64 MiB rung above the 16 MiB one: "
          f"{ns[64 << 20] > ns[16 << 20]}")
    print(f"memory-inkernel: {len(plan)} probes, {len(recorded)} host twins cached from the "
          f"memory plan; launches {launches}")
    for path in ("chase/timed/smem", "chase/timed/global"):
        if launches.get(path, 0) == 0:
            fail(f"K3 ({path}) was not launched by the memory-inkernel run")
    return launches


# ------------------------------------------------------------ o1, audit
def run_o1(dev: torch.device, db_path: str) -> dict[str, int]:
    """Phase o1: clock_overhead and the 15 ``QUICK_OPS`` at O1 through
    ``Session(audit=True)`` on the run's DB, the launch counts set to 0 just
    before and read just after. Their chains compiled in this process while
    quick's and table2's sessions waited on the compile workers
    (``CompilePool.local``), so here they are found compiled and captured.
    Every record must be timed by events, count ``cycles`` on the SM clock,
    state O1's settings (``o1=``) and, but clock_overhead's, the CUDA graph
    it replays from (``launch=``), and carry a verdict; each O1 chain's
    result must equal its eager chain at n 64 and 512. Prints each row's ns a step at
    O0, O1 and O3."""
    from repro_torch.api.plan import QUICK_OPS, Plan
    from repro_torch.api.session import Session
    from repro_torch.core import chains, measure
    from repro_torch.core.latency_db import LatencyDB
    from repro_torch.core.timing import Timer

    plan = Plan.clock_overhead(("O1",)) + Plan.instructions(ops=QUICK_OPS, opt_levels=("O1",))
    db = LatencyDB(db_path)
    zero_counts()
    result = Session(db=db, device=dev, timer=Timer(device=dev), audit=True).run(plan)
    launches = read_counts()
    if result.failed or len(result.measured) != len(plan):
        fail(f"o1: {result.summary()}: {[r.failure for r in result.failed]}")
    for r in result.results:
        rec = r.record
        graphed = rec.op == "clock_overhead" or re.search(r"\blaunch=\S*cuda_graph", rec.notes)
        if not (math.isfinite(rec.latency_ns) and rec.latency_ns >= 0 and rec.n_samples > 0
                and "clock=events" in rec.notes and " o1=" in f" {rec.notes}"
                and "audit=" in rec.notes and graphed):
            fail(f"bad O1 record {rec}")
        check_cycles(rec)
        cells = []
        for level in ("O0", "O1", "O3"):
            other = db.get(rec.key()[:3] + (level,) + rec.key()[4:])
            cells.append(f"{level} {other.latency_ns:.2f} ns" if other else f"{level} -")
        print(f"o1: {rec.op} {rec.dtype}: {'; '.join(cells)} (net {rec.net_latency_ns:.2f}, "
              f"MAD {rec.mad_ns:.2f}); notes {rec.notes}")
    for name in QUICK_OPS:
        spec = chains.spec_by_name(name)
        for n in measure._CHAIN_LENS["O1"]:
            args = (spec.carry(dev), *spec.operand_tensors(dev))
            got = measure.compile_chain(spec, n, "O1", dev)(*args)
            want = chains.chain_fn(spec, n)(*args)
            if not torch.equal(got.reshape(1).view(torch.uint8), want.reshape(1).view(torch.uint8)):
                fail(f"{name}@O1 n {n}: {got.item()!r}, its eager chain {want.item()!r}")
    print(f"o1: {len(result.measured)} records; each O1 chain of the {len(QUICK_OPS)} quick "
          f"rows equals its eager chain at n {measure._CHAIN_LENS['O1']}; launches {launches}")
    return launches


def run_o1_in_wait(dev: torch.device, db_path: str, box: dict) -> None:
    """Phase o1 as a task of this process in table2's wait (``CompilePool.
    local``): table2's launch counts so far are put aside, :func:`run_o1`
    counts its own from 0 (into ``box``), and table2's are put back. A
    failed check stops the run (``SystemExit`` passes through the pool's
    task loop)."""
    from repro_torch.kernels.ops import add_launches

    t0 = time.perf_counter()
    table2 = read_counts()
    box["launches"] = run_o1(dev, db_path)
    zero_counts()
    add_launches(table2)
    phase("o1", t0)


# transformed verdicts the audit expects on the card, each explained in
# PERF.md with its PTX and SASS evidence
KNOWN_TRANSFORMED = {
    ("not", "O3"): "LLVM: ~(~x + a) + a is x - 1 + ...: two steps fold, no step is left",
    ("bfi", "O3"): "LLVM: (x & ~0xFF) | c is idempotent: one step is left",
    ("mul24", "O3"): "LLVM: the masks drop out and x*A*A... becomes x*A^n by squaring",
    ("cnot", "O3"): "LLVM: the + a folds into the select's arms (a and a + 1, hoisted)",
    ("sad", "O3"): "LLVM: the next step's - a merges with + b (b - a hoisted)",
    ("inkernel.bfi", "O3"): "ptxas: K2's timed bfi chain is idempotent: no step is left",
}
MUST_TRANSFORM = (("not", "O3"), ("bfi", "O3"), ("mul24", "O3"), ("inkernel.bfi", "O3"))


def run_audit(dev: torch.device, db_path: str, attribution: str) -> dict[tuple[str, str], str]:
    """Phase audit: ``audit --db <the run's DB> --lint --lowering
    --attribution <file> --strict`` in this process (the O3 chains' PTX and
    SASS are those the compile workers handed back). Prints each verdict,
    the counts by status and by family and the attribution rows of the
    ``QUICK_OPS``; the verdicts of the probes that failed (folded chains)
    are read from their failures' messages. Fails when a record lacks
    ``audit=``, when not, bfi, mul24 at O3 or inkernel.bfi is not
    ``transformed`` with a cause from ``transforms.CAUSES``, when a
    ``transformed`` verdict is not in ``KNOWN_TRANSFORMED``, when a row
    outside special math is ``unaudited``, or when the strict exit code is
    not 1 while transformed rows exist. Returns each verdict's note by
    ``(op, opt_level)`` (phase cache holds its rows to them)."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.audit.chain_check import ChainVerdict, _verdict_from_note
    from repro_torch.audit.transforms import CAUSES
    from repro_torch.core.chains import spec_by_name
    from repro_torch.core.latency_db import LatencyDB

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["audit", "--db", db_path, "--lint", "--lowering", "--attribution",
                       attribution, "--strict"])
    out = buf.getvalue()
    print("".join(f"audit: {ln}\n" for ln in out.splitlines()), end="")
    db = LatencyDB(db_path)
    verdicts = {}
    for rec in db.records():
        v = _verdict_from_note(rec.op, rec.opt_level, rec.notes)
        if v is None:
            fail(f"{rec.op}@{rec.opt_level}: no audit= in its notes: {rec.notes}")
        verdicts[(rec.op, rec.opt_level)] = (v, rec.category)
    for f in db.failures():
        m = re.search(r"\[audit=([\w.:-]+)(?: audit_transform=[\w-]+)?\]", f.message)
        if not m:
            fail(f"{f.op}@{f.opt_level} failed with no verdict: {f.message}")
        status, _, cause = m[1].partition(":")
        verdicts[(f.op, f.opt_level)] = (ChainVerdict(f.op, f.opt_level, status, cause), None)
    by_status, by_family = {}, {}
    for (op, level), (v, category) in sorted(verdicts.items()):
        family = category or op.split(".")[0]
        by_status[v.status] = by_status.get(v.status, 0) + 1
        by_family.setdefault(family, {}).setdefault(v.status, 0)
        by_family[family][v.status] += 1
        print(f"audit: verdict {op}@{level}: {v.note()}")
        if v.status == "transformed":
            if v.cause not in CAUSES and (op, level) in MUST_TRANSFORM:
                fail(f"{op}@{level}: cause {v.cause!r} is not in transforms.CAUSES")
            if (op, level) not in KNOWN_TRANSFORMED:
                fail(f"{op}@{level} is transformed ({v.cause}) and not in KNOWN_TRANSFORMED")
        if v.status == "unaudited":
            row = op.removeprefix("inkernel.")
            try:
                special = spec_by_name(row).category == "special_math"
            except KeyError:
                special = False
            if not special:
                fail(f"{op}@{level} is unaudited ({v.cause}) outside special math")
    for key in MUST_TRANSFORM:
        v = verdicts.get(key, (None,))[0]
        if v is None or v.status != "transformed":
            fail(f"{key[0]}@{key[1]}: {v}: its chain is folded, the audit must say so")
    transformed = by_status.get("transformed", 0)
    if rc != (1 if transformed else 0):
        fail(f"audit --strict exited {rc} with {transformed} transformed verdicts")
    print(f"audit: {len(verdicts)} verdicts (records and failures): "
          + ", ".join(f"{k}={n}" for k, n in sorted(by_status.items())))
    for family, counts in sorted(by_family.items()):
        print(f"audit: family {family}: "
              + ", ".join(f"{k}={n}" for k, n in sorted(counts.items())))
    print(f"audit: --strict exited {rc}")
    for ln in Path(attribution).read_text().splitlines():
        if ln.startswith("| `"):
            print(f"attribution: {ln}")
    return {key: v.note() for key, (v, _) in verdicts.items()}

# ------------------------------------------------------------ dataflow, cache
DATAFLOW_BOUND_S = 15.0   # PERF.md section 2, written before its first run
# PERF.md section 2: the two fresh processes of phase cache, together, from
# their start signals
CACHE_BOUND_S = 30.0
CACHE_OPS = ("add", "mul", "fma.float32")


def run_dataflow(dev: torch.device, fused_db) -> None:
    """Phase dataflow, in the pool's wait: ``audit --lint --dataflow``
    through the CLI (the four fused kernels' signatures and the SASS of the
    instances their unit workloads launch, K1's five ALU chains, K2's
    ``add.float32`` and K3 in both spaces: clean), then the fused plan's
    four rows audited again from that run's DB: each ``audited`` with the
    ``unit_bytes`` of its notes (a failed rmsnorm row with the rule's,
    ``inkernel.measure.unit_bytes``). Controls: flash_attention's unit
    workload made causal stays linear (its one query block sees every key,
    as in the JAX package), so the control that must be ``transformed``
    with a ``nonlinear-*`` cause is the causal one whose query grows with
    its keys (causal self-attention: the blocks it skips grow faster than
    the units)."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.audit import audit_target, dataflow
    from repro_torch.core.latency_db import current_environment
    from repro_torch.inkernel import FUSED_KERNELS
    from repro_torch.inkernel.measure import unit_bytes
    from repro_torch.utils import parse_kv_notes

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["audit", "--lint", "--dataflow"])
    out = buf.getvalue()
    print("".join(f"dataflow: {ln}\n" for ln in out.splitlines()), end="")
    if rc != 0 or "lints clean (mapping+guards+dataflow)" not in out:
        fail(f"audit --lint --dataflow exited {rc}: {out[-500:]}")
    env = current_environment(dev)
    for name in FUSED_KERNELS:
        op = f"inkernel.fused.{name}"
        rec = next((r for r in fused_db.records() if r.op == op), None)
        v = audit_target(op, "O3", env=env)
        want = (int(parse_kv_notes(rec.notes)["unit_bytes"]) if rec is not None
                else unit_bytes(name))
        got = parse_kv_notes(v.detail).get("unit_bytes")
        print(f"dataflow: {op}@O3 {v.note()} ({v.detail}); its notes' unit_bytes {want}; "
              f"instances {dataflow.fused_instances(name)}")
        if v.status != "audited" or got is None or int(got) != want:
            fail(f"dataflow: {op}: {v} (unit_bytes {got}, its notes {want})")
    same = dataflow.audit_fused("flash_attention", overrides={"causal": True}, env=env)
    print(f"dataflow: flash_attention's unit workload made causal: {same.note()} "
          f"({same.detail}): one query block at the end of the keys sees every block")
    control = dataflow.audit_fused("flash_attention", overrides={"causal": True},
                                   query_grows=True, env=env)
    print(f"dataflow: control, causal self-attention (queries as long as the keys): "
          f"{control.note()} ({control.detail})")
    if control.status != "transformed" or not control.cause.startswith("nonlinear-"):
        fail(f"dataflow: the causal self-attention control was not rejected: {control}")
    bound("dataflow", time.perf_counter() - t0, DATAFLOW_BOUND_S)


# one fresh process of phase cache: it imports what the port's CLI and a
# compiled chain's load import (torch, Inductor, Triton; no CUDA call) and
# hashes torch's sources once (Inductor's ``torch_key``, no cache's), then
# waits for a line on its standard input: at that start signal it runs the
# CLI (``repro_torch.api.cli.main``, what ``python -m repro_torch`` runs) on
# its arguments; at the end of its input without one it exits. It writes its
# import seconds, its seconds from the signal and the CLI's exit code
CACHE_PROCESS = """
import json, sys, time
t0 = time.perf_counter()
import torch
import torch._inductor.async_compile, torch._inductor.codecache
import torch._inductor.runtime.triton_heuristics
from repro_torch.api import cli
import repro_torch.audit  # noqa: F401
try:
    import triton  # noqa: F401
except ImportError:
    pass
getattr(torch._inductor.codecache, "torch_key", lambda: None)()
imports = time.perf_counter() - t0
if not sys.stdin.readline():
    sys.exit(0)
t1 = time.perf_counter()
rc = cli.main(sys.argv[2:])
sys.stdout.flush()
sys.stderr.flush()
open(sys.argv[1], "w").write(json.dumps({"args": sys.argv[2:], "rc": rc, "imports": imports,
                                         "s": time.perf_counter() - t1,
                                         "life": time.perf_counter() - t0}))
"""


def start_fresh(args: list[str], scratch: Path, name: str) -> dict:
    """One fresh process of phase cache (``CACHE_PROCESS``), started now at
    the compile workers' priority: it imports, then waits for
    :func:`signal_fresh`; its output and report go under ``scratch``."""
    import os

    from repro_torch.api.session import WORKER_NICE

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with open(scratch / f"{name}.out", "w") as out, open(scratch / f"{name}.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", CACHE_PROCESS,
                                 str(scratch / f"{name}.json"), *args],
                                stdin=subprocess.PIPE, stdout=out, stderr=err, text=True,
                                env=env, cwd=ROOT, preexec_fn=lambda: os.nice(WORKER_NICE))
    return {"proc": proc, "path": scratch / name, "args": args}


def signal_fresh(job: dict) -> None:
    """Start a process of :func:`start_fresh` on its CLI run (one that has
    exited already is reported by :func:`wait_fresh`)."""
    try:
        job["proc"].stdin.write("go\n")
        job["proc"].stdin.flush()
    except BrokenPipeError:
        pass


def wait_fresh(job: dict) -> dict:
    """Wait for a process of :func:`start_fresh`; its report, with what it
    printed. Fails if it or its CLI run exited other than 0."""
    proc, path = job["proc"], job["path"]
    proc.stdin.close()
    rc = proc.wait(timeout=600)
    report = path.with_suffix(".json")
    stdout, stderr = path.with_suffix(".out").read_text(), path.with_suffix(".err").read_text()
    if rc != 0 or not report.exists():
        fail(f"cache: the fresh process for {job['args'][0]} exited {rc}: {stderr[-1500:]}")
    r = {**json.loads(report.read_text()), "stdout": stdout, "stderr": stderr}
    print(f"cache: python -m repro_torch {r['args'][0]}: {r['s']:.2f} s from its start "
          f"signal (exit {r['rc']}); the process's imports {r['imports']:.2f} s before it, in "
          f"the pool's wait; its whole life {r['life']:.2f} s")
    for ln in stderr.splitlines():
        if re.search(r"\] (compiled|prepared|timed) ", ln):
            print(f"cache:   {ln}")
    if r["rc"]:
        fail(f"cache: python -m repro_torch {' '.join(r['args'])} exited {r['rc']}: "
             f"{stdout[-800:]} {stderr[-1500:]}")
    return r


def start_cache(cache_dir: Path, scratch: Path) -> dict:
    """Phase cache's two fresh processes, started in the pool's wait to
    import there: ``characterize --plan quick --opt-levels O3 --ops
    add,mul,fma.float32 --force`` with the run's compile cache, into a DB of
    its own, and ``audit --db <that DB> --compile-cache <dir>``. Neither
    touches the card before its start signal."""
    warm_db = scratch / "cache_db.json"
    return {"warm_db": warm_db, "characterize": start_fresh(
        ["characterize", "--plan", "quick", "--opt-levels", "O3", "--ops", ",".join(CACHE_OPS),
         "--force", "--db", str(warm_db), "--compile-cache", str(cache_dir)],
        scratch, "cache_characterize"), "audit": start_fresh(
        ["audit", "--db", str(warm_db), "--compile-cache", str(cache_dir)],
        scratch, "cache_audit")}


def cache_characterize(job: dict) -> None:
    """Phase cache's first run, once the pool has stopped and table2 is
    timed: the characterize process gets its start signal. It times three
    rows on the card, so this process times nothing until
    :func:`cache_audit` has waited for it."""
    signal_fresh(job["characterize"])


def cache_audit(job: dict) -> None:
    """Wait for phase cache's characterize, then signal its audit, which
    times nothing and runs while this process goes on."""
    job["characterize"] = wait_fresh(job["characterize"])
    signal_fresh(job["audit"])


def finish_cache(dev: torch.device, db_path: str, job: dict, pool,
                 verdicts: dict[tuple[str, str], str]) -> None:
    """Phase cache's checks, once its second process is done. The first ran
    ``characterize --plan quick --opt-levels O3 --ops add,mul,fma.float32
    --force`` with the run's compile cache, into a DB of its own. Its
    summary must read ``0 compiled`` and a hit for each of the rows' six
    chains; Inductor's counters in it no graph or AOTAutograd miss and no
    lowering, and Triton's compiles (its compilation listener,
    ``compile_cache.count_triton_compiles``) hits of its cache only. The
    second ran ``audit --db <that DB> --compile-cache <dir>``: it must give
    those rows the verdicts quick's run and phase audit (``verdicts``) gave
    them, read from the cache's entries. Prints each process's seconds, the
    warm process's prepare seconds beside the cold compile seconds of the
    same chains in the workers, and the two processes' seconds from their
    start signals against their bound."""
    from repro_torch.audit.chain_check import _verdict_from_note
    from repro_torch.core.chains import spec_by_name
    from repro_torch.core.latency_db import LatencyDB, current_environment

    runs = [job["characterize"], wait_fresh(job["audit"])]
    out = runs[0]["stdout"]
    print("".join(f"cache: {ln}\n" for ln in out.splitlines()
                  if "compile cache" in ln or "measured" in ln), end="")
    chains_n = 2 * len(CACHE_OPS)
    m = re.search(r"compile cache: (\d+) hits, (\d+) compiled", out)
    if not m or (int(m[1]), int(m[2])) != (chains_n, 0):
        fail(f"cache: the warm process did not load its {chains_n} chains from the cache: "
             f"{m[0] if m else out[-400:]}")
    line = re.search(r"inductor (\{.*?\}); lowering ([\d.]+) s; prepare ([\d.]+) s", out)
    counts = json.loads(line[1]) if line else None
    if (counts is None or counts.get("inductor.fxgraph_cache_miss", 0)
            or counts.get("aot_autograd.autograd_cache_miss", 0) or float(line[2]) > 0.0
            or counts.get("triton.compile_cache_miss", 1)):
        fail(f"cache: the warm process compiled: {line[0] if line else out[-400:]}")
    cold = sum(fut.result()["s"] for (_, _, name, level, n, _), fut in pool.futures.items()
               if name in CACHE_OPS and fut.done() and fut.exception() is None)
    print(f"cache: warm process: {m[1]} hits, 0 compiled, prepare {float(line[3]):.3f} s for "
          f"the {chains_n} chains (no lowering; Triton's compiles: "
          f"{counts.get('triton.compile_cache_hit')} hits of its cache, 0 misses); their "
          f"cold compiles in the workers {cold:.1f} s")
    print("".join(f"cache: audit: {ln}\n" for ln in runs[1]["stdout"].splitlines()), end="")
    env = current_environment(dev)
    run, warm = LatencyDB(db_path), LatencyDB(str(job["warm_db"]))
    for name in CACHE_OPS:
        key = (env["device_kind"], env["backend"], env["jax_version"], "O3", name,
               spec_by_name(name).dtype)
        want = _verdict_from_note(name, "O3", run.get(key).notes)
        got = _verdict_from_note(name, "O3", warm.get(key).notes)
        print(f"cache: {name}@O3: {got.note() if got else None} from the cache's entries; "
              f"quick's run {want.note() if want else None}; phase audit "
              f"{verdicts.get((name, 'O3'))}")
        if (got is None or want is None or got.note() != want.note()
                or verdicts.get((name, "O3")) != got.note()):
            fail(f"cache: {name}@O3: the cache-backed audit gave {got}, the run {want}, "
                 f"phase audit {verdicts.get((name, 'O3'))}")
    bound("cache: the two fresh processes from their start signals", sum(r["s"] for r in runs),
          CACHE_BOUND_S)


def probe_twin(probe, twins):
    """The host chase at an in-kernel rung's working set."""
    return next(t for t in twins if t.working_set_bytes == probe.working_set_bytes)


def run_fused(dev: torch.device):
    """Phase 8: the fused plan through the CLI; returns each kernel's
    launches during that run, and its DB (the ``inkernel.fused.*`` rows
    that phase serving prices the kernels' sites from)."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        db_path = str(Path(tmp) / "fused_db.json")
        zero_counts()
        rc = cli_main(["characterize", "--plan", "fused", "--db", db_path, "--table",
                       "--audit"])
        launches = read_counts()
        db = LatencyDB(db_path)
    env = current_environment(dev)
    failures = {f.op: f for f in db.failures()}
    for probe in named_plan("fused"):
        rec = db.get(probe.key(env))
        if rec is None:
            f = failures.get(probe.op)
            if probe.name != "rmsnorm" or f is None or f.error_type != "NoisySlopeError":
                fail(f"no record for {probe.op}: {f}")
            print(f"fused: {probe.op} ended as a ProbeFailure: {f.error_type}: {f.message}")
            continue
        if not (math.isfinite(rec.latency_ns) and rec.latency_ns > 0 and rec.n_samples > 0
                and rec.notes.startswith("cuda fused kernel lens=2-6 unit_bytes=")
                and "clock=events" in rec.notes):
            fail(f"bad record {rec}")
        check_cycles(rec)
        print(f"fused: {probe.op} measured {rec.latency_ns:.3f} ns per unit "
              f"(MAD {rec.mad_ns:.3f}; notes {rec.notes})")
    if rc != (1 if failures else 0):
        fail(f"characterize --plan fused exited {rc} with {len(failures)} failures")
    print(f"fused: {len(db)} records, {len(failures)} failures; launches "
          f"{ {k: launches[k] for k in JAMBA_TIMED} }")
    for name in JAMBA_TIMED:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched by the fused run")
    return launches, db


# Phase serve: the launcher's command line (Jamba-v0.1 at full width, one
# period of its 8 layers, prefill through K5 and K7; the launcher's own 8
# requests of 4-15 tokens, 32 new tokens each, greedy), then 8 ragged prompts
# of 256-2048 tokens through the same Engine, every K5 and K7 call of both
# held against its plain version; then the kernel path against the plain
# path layer by layer at batch 2 x 512 tokens (models.pathcheck: every layer
# output and the logits within LAYER_TOL = 2^-5 * (|want| + rms(row)), each
# Mamba state within STATE_TOL = 2^-13; PERF.md section 2).
SERVE_ARGV = ["--arch", "jamba-v0.1-52b", "--full", "--periods", "1", "--kernels",
              "--device", "cuda:0"]
SERVE_LONG = dict(requests=8, min_len=256, max_len=2048, max_new=32)
SERVE_CHECK = (2, 512)
# one prefill launches K5 once (the attention layer) and K7 once a Mamba layer
SERVE_PER_PREFILL = {"flash_attention": 1, "mamba_scan": 7}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return smi.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def recording_kernels(calls: list):
    """Route the models' K5 and K7 calls (``kernels.ops.flash_attention`` and
    ``kernels.ops.mamba_scan``, looked up at call time) through a recorder
    that launches the kernel and keeps (name, args, kwargs, result)."""
    from repro_torch.kernels import ops

    real = {"flash_attention": ops.flash_attention, "mamba_scan": ops.mamba_scan}

    def recorder(name):
        def call(*args, **kw):
            out = real[name](*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return call

    try:
        for name in real:
            setattr(ops, name, recorder(name))
        yield calls
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def run_serve(dev: torch.device) -> dict[str, int]:
    """Phase serve: ``launch.serve`` through its ``main`` (SERVE_ARGV) and the
    long ragged prompts through its Engine, the launch counts set to 0 just
    before and read just after (K5 and K7 must have run once and seven times
    a prefill, no other kernel), every K5 and K7 call of that run recorded
    (:func:`recording_kernels`) and then held against its plain version on
    its own inputs (:func:`hold_serve_calls`); then the two paths against
    each other (:func:`check_serve_paths`). No Inductor compile may run
    (Dynamo's frame count is read before and after). Frees the model.
    Returns the main path's launches."""
    import gc

    from repro_torch.launch import serve
    from repro_torch.models import transformer

    frames = torch._dynamo.utils.counters["frames"]["total"]
    calls = []
    zero_counts()
    with recording_kernels(calls):
        eng = serve.main(SERVE_ARGV)
        n_launcher = len(calls)
        model, cfg = eng.model, eng.cfg
        rng = np.random.RandomState(0)
        lo, hi = SERVE_LONG["min_len"], SERVE_LONG["max_len"]
        prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist() for n in
                   [lo, hi] + list(rng.randint(lo, hi + 1, SERVE_LONG["requests"] - 2))]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=SERVE_LONG["max_new"])
        wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = transformer.n_params(model)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    want = {k: 2 * n for k, n in SERVE_PER_PREFILL.items()}  # the launcher's and this one
    ran = {k: v for k, v in launches.items() if v and not k.startswith("chase/")}
    if ran != want:
        fail(f"serve: kernels launched {ran}, want {want} (K5 once and K7 seven times a "
             "prefill, nothing else)")
    if out.tokens.shape != (len(prompts), SERVE_LONG["max_new"]) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        fail(f"serve: bad tokens {out.tokens.shape}")
    kept = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for _, args, _, got in calls[n_launcher:]
            for t in (*args, *(got if isinstance(got, tuple) else (got,)))}
    lens = [len(p) for p in prompts]
    print(f"serve: long prompts: {len(prompts)} requests of {lens} tokens (padded to "
          f"{max(lens)}), {SERVE_LONG['max_new']} new tokens each, greedy: prefill "
          f"{out.prefill_s * 1e3:.2f} ms, decode {out.decode_s * 1e3 / (out.steps - 1):.3f} ms "
          f"a token, {out.tokens.size / wall:.1f} tokens/s, peak memory allocated {peak} B "
          f"(with the {sum(kept.values())} B of its K5 and K7 calls' inputs and outputs kept "
          f"for the check); {cfg.name} at {cfg.n_layers} layers: {n_params} parameters, "
          f"{nbytes} B ({cfg.param_dtype}); launches {ran}; card {card()}")
    print(f"serve: req0 of the long prompts: {out.tokens[0].tolist()}")

    with torch.no_grad():
        hold_serve_calls(calls, n_launcher)
        del calls
        check_serve_paths(eng, rng, dev)
    check_k7_long(eng, rng)
    compiled = torch._dynamo.utils.counters["frames"]["total"] - frames
    print(f"serve: Dynamo frames compiled in this phase: {compiled}")
    if compiled:
        fail(f"serve: {compiled} frames went through torch.compile; the phase runs eagerly")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Phase serving: characterize --plan serving through the CLI on the run's
# DB (its 18 deps, QUICK_OPS at O3 and three chase rungs, cache hits; the 4
# serving-tiny cells measured, no kernel on their path), then the
# full-width cells: Jamba-v0.1 cut to one period (phase serve's model and
# its launcher's --kernels runtime, weights from seed 0), a prefill of 8 x
# 2048 tokens through K5 and K7 and a decode step at position 2048 on a
# cache of 2080, priced from the run's own rows (the QUICK_OPS, table2's
# rows, the chase ladders, the fused plan's inkernel.fused.* rows with
# their unit_bytes) after the pool has stopped (PERF.md section 2).
SERVING_FULL = dict(batch=8, prompt=2048, max_len=2080)
# one record of the prefill: K5 at its attention layer, K7 at each Mamba layer
SERVING_SITES = {"flash_attention": 1, "mamba_scan": 7}


def serving_line(label: str, rec, report=None, record=None) -> None:
    """One cell: predicted, measured, their ratio, coverage and bound, and
    where the probe's report and record are given, what the estimator could
    not price and what the record holds."""
    from repro_torch.core.perfmodel import servingpoint_from_record
    from repro_torch.utils import parse_kv_notes

    pt = servingpoint_from_record(rec)
    if report is None:
        print(f"serving: {label} {rec.op}: predicted_ns {pt.predicted_ns:.1f}, measured_ns "
              f"{pt.measured_ns:.1f} (MAD {rec.mad_ns:.1f}), ratio {pt.ratio:.6g}, coverage "
              f"{pt.coverage:.4f}, bound {parse_kv_notes(rec.notes)['bound']}; notes {rec.notes}")
        return
    unpriced = ", ".join(f"{op} x{n:g}" for op, n in report.unpriced_opcodes) or "none"
    classes = ", ".join(f"{k} {v.ns / 1e6:.6g} ms" for k, v in sorted(
        report.by_class.items(), key=lambda kv: -kv[1].ns)[:6])
    print(f"serving: {label} {rec.op}: predicted_ns {pt.predicted_ns:.1f}, measured_ns "
          f"{pt.measured_ns:.1f} (MAD {rec.mad_ns:.1f}), ratio {pt.ratio:.6g}, coverage "
          f"{pt.coverage:.4f}, bound {report.bound} (compute {report.compute_ns:.1f} ns, "
          f"memory {report.memory_ns:.1f} ns over {report.bytes_accessed:.0f} B); "
          f"unpriced_opcodes {unpriced}; by class {classes}; record: "
          f"{sum(record.histogram.values())} ops, {record.matmul_flops:.6g} matmul FLOPs, "
          f"sites {dict(record.site_counts())}; notes {rec.notes}")


def served_jamba():
    """Phase serve's model and runtime: Jamba-v0.1 cut to one period, and
    ``launch.serve``'s runtime under ``--kernels`` (K5 and K7 at prefill)."""
    from repro_torch.configs.registry import get
    from repro_torch.models.config import Runtime

    spec = get("jamba-v0.1-52b").config
    cfg = dataclasses.replace(spec, n_layers=len(spec.period))
    rt = Runtime(remat=False, moe_groups=1, mamba_chunk=16, mlstm_chunk=16,
                 attn_impl="pallas", use_pallas=True)
    return cfg, rt


def run_serving_tiny(dev: torch.device, db_path: str) -> dict[str, int]:
    """``characterize --plan serving --table --audit`` on the DB at
    ``db_path``, the counts set to 0 just before and read just after: every
    dep a cache hit, the four serving-tiny cells measured with
    ``exec=eager``, a positive prediction and a coverage in (0, 1], and no
    kernel launched (serving-tiny runs ``attn_impl="auto"``)."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment
    from repro_torch.utils import parse_kv_notes

    env = current_environment(dev)
    plan = named_plan("serving")
    before = LatencyDB(db_path)
    missing = [p.op for p in plan if p.category != "serving" and p.key(env) not in before]
    if missing:
        fail(f"serving: the plan's deps {missing} are not in the run's DB")
    zero_counts()
    rc = cli_main(["characterize", "--plan", "serving", "--db", db_path, "--table", "--audit"])
    launches = {k: n for k, n in read_counts().items() if n}
    db = LatencyDB(db_path)
    ops = {p.op for p in plan}
    failed = [f for f in db.failures() if f.op in ops]
    if rc != 0 or failed:
        fail(f"serving: characterize --plan serving exited {rc}: {failed}")
    if launches:
        fail(f"serving: the serving-tiny cells launched {launches}; their path runs no kernel")
    for probe in plan:
        if probe.category != "serving":
            continue
        rec = db.get(probe.key(env))
        kv = parse_kv_notes(rec.notes) if rec else {}
        if rec is None or not (kv.get("exec") == "eager" and float(kv["predicted_ns"]) > 0
                               and 0 < float(kv["coverage"]) <= 1 and rec.latency_ns > 0
                               and "clock=events" in rec.notes):
            fail(f"serving: bad record for {probe.op}: {rec}")
        check_cycles(rec)
        serving_line("serving-tiny", rec)
    return launches


def run_serving_full(dev: torch.device, db_path: str) -> dict[str, int]:
    """The full-width cells through ``Session.run`` on the DB at
    ``db_path``, the counts set to 0 just before and read just after: both
    cells measured; the prefill's record holds one K5 site and seven K7
    sites, the decode step's none, and neither K5 nor K7 is unpriced;
    only K5 and K7 launched, seven K7 a K5. Frees the model. Returns the
    launches."""
    import gc

    from repro_torch.api import Plan, ServingCostProbe, Session
    from repro_torch.core.timing import Timer

    cfg, rt = served_jamba()
    b, p = SERVING_FULL["batch"], SERVING_FULL["prompt"]
    cells = (ServingCostProbe("prefill", b, p, cfg=cfg, rt=rt),
             ServingCostProbe("decode", b, p, cfg=cfg, rt=rt, max_len=SERVING_FULL["max_len"]))
    session = Session(db=db_path, device=dev, timer=Timer(warmup=2, reps=10, device=dev))
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    result = session.run(Plan(cells, name="serving-full"))
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(dev)
    for r in result.results:
        if r.record is None:
            fail(f"serving: {r.probe.op} failed: {r.failure}")
        check_cycles(r.record)
        serving_line("full width", r.record, r.probe.last_report, r.probe.last_record)
    prefill, decode = cells
    sites = dict(prefill.last_record.site_counts())
    if sites != SERVING_SITES or decode.last_record.sites:
        fail(f"serving: the prefill's record holds the sites {sites}, want {SERVING_SITES}; "
             f"the decode step's {dict(decode.last_record.site_counts())}, want none")
    for cell in cells:
        kernels_unpriced = [op for op, _ in cell.last_report.unpriced_opcodes
                            if op.startswith("kernel:")]
        if kernels_unpriced:
            fail(f"serving: {cell.op} left {kernels_unpriced} unpriced")
    n5 = launches.get("flash_attention", 0)
    if not n5 or set(launches) != set(SERVING_SITES) or launches["mamba_scan"] != 7 * n5:
        fail(f"serving: the full-width cells launched {launches}, want K5 and seven K7 a K5, "
             "nothing else")
    print(f"serving: full width {cfg.name} at {cfg.n_layers} layers, batch {b}, prompt {p}, "
          f"cache {SERVING_FULL['max_len']}: {wall:.2f} s for both cells (the model built "
          f"once, each step recorded once and timed), launches {launches}, peak memory "
          f"allocated {peak} B; card {card()}")
    del result, cells, prefill, decode, session
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_serving(dev: torch.device, run_db, fused_db) -> dict[str, int]:
    """Phase serving: the named plan, then the full-width cells, on a copy
    of the run's DB with the fused plan's rows merged in. No Dynamo frame
    may compile. Returns the full-width cells' launches (the named plan's
    are none)."""
    from repro_torch.core.latency_db import LatencyDB

    frames = torch._dynamo.utils.counters["frames"]["total"]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        db_path = str(Path(tmp) / "serving_db.json")
        db = LatencyDB()
        db.merge(run_db, fused_db)
        db.save(db_path)
        run_serving_tiny(dev, db_path)
        launches = run_serving_full(dev, db_path)
    compiled = torch._dynamo.utils.counters["frames"]["total"] - frames
    print(f"serving: Dynamo frames compiled in this phase: {compiled}")
    if compiled:
        fail(f"serving: {compiled} frames went through torch.compile; the phase runs eagerly")
    return launches


# Phase slo: serve-slo through the CLI on serving-tiny, then Jamba-v0.1's
# continuous-batching pool at full width (phase serve's model, runtime and
# seed) through Session.run over SloProbes, on a copy of the run's DB with
# the fused plan's rows merged in, after phase serving: the eager engine is
# host-bound and cannot share the host with the compile workers.
SLO_FULL = dict(n_requests=12, n_slots=4, seed=0, max_len=2080, prompt_len=(256, 2048),
                max_new=(8, 32))
# below and above the pool's capacity: a request holds its slot for about
# 20 decode steps of about 25 ms, so 4 slots serve about 4-5 req/s. The
# point near it (4 req/s, about 8 s of the phase) was cut when a run took
# 600.41 s of its 600 s bound on one H100 (PERF.md section 6)
SLO_FULL_RATES = (1.0, 16.0)
SLO_BOUND_S = 40.0                   # PERF.md section 2, written before its first run
SLO_METRICS = (("TTFT p50", "ttft_p50_ns"), ("TTFT p99", "ttft_p99_ns"),
               ("TPOT p50", "tpot_p50_ns"), ("TPOT p99", "tpot_p99_ns"),
               ("e2e p50", "e2e_p50_ns"), ("goodput", "goodput_tok_s"))


def slo_line(label: str, rec) -> dict:
    """One SLO point: each metric predicted and measured, their ratio, and
    the coverage; returns the point's figures."""
    from repro_torch.core.perfmodel import slopoint_from_record

    pt = slopoint_from_record(rec)
    parts, figs = [], {"rate": pt.rate_rps, "coverage": pt.coverage}
    for name, key in SLO_METRICS:
        pred, meas = pt.predicted[key], pt.measured[key]
        unit = "tok/s" if key.endswith("tok_s") else "ms"
        scale = 1.0 if unit == "tok/s" else 1e-6
        parts.append(f"{name} {pred * scale:.6g} / {meas * scale:.6g} {unit} "
                     f"(ratio {pred / meas:.6g})")
        figs[key] = {"predicted": pred, "measured": meas}
    print(f"slo: {label} {rec.op} at {pt.rate_rps:g} req/s, predicted / measured: "
          f"{'; '.join(parts)}; coverage {pt.coverage:.4f}; notes {rec.notes}")
    return figs


def run_slo_tiny(dev: torch.device, db_path: str) -> None:
    """``serve-slo`` as users run it, on the DB at ``db_path``, the counts
    set to 0 just before and read just after: every dep a cache hit, each
    of the three points measured with both sides' p50 and p99 TTFT and p50
    TPOT positive and a coverage in (0, 1], no kernel launched; a second
    run all cache hits."""
    from repro_torch.api.cli import main as cli_main
    from repro_torch.api.plan import named_plan
    from repro_torch.core.latency_db import LatencyDB, current_environment
    from repro_torch.core.perfmodel import slopoint_from_record
    from repro_torch.utils import parse_kv_notes

    env = current_environment(dev)
    plan = named_plan("slo")
    before = LatencyDB(db_path)
    missing = [p.op for p in plan if p.category != "slo" and p.key(env) not in before]
    if missing:
        fail(f"slo: the plan's deps {missing} are not in the run's DB")
    zero_counts()
    rc = cli_main(["serve-slo", "--db", db_path])
    launches = {k: n for k, n in read_counts().items() if n}
    db = LatencyDB(db_path)
    ops = {p.op for p in plan}
    failed = [f for f in db.failures() if f.op in ops]
    if rc != 0 or failed:
        fail(f"slo: serve-slo exited {rc}: {failed}")
    if launches:
        fail(f"slo: the serving-tiny points launched {launches}; their path runs no kernel")
    for probe in plan:
        if probe.category != "slo":
            continue
        rec = db.get(probe.key(env))
        if rec is None:
            fail(f"slo: no record for {probe.op}")
        kv, pt = parse_kv_notes(rec.notes), slopoint_from_record(rec)
        sides_ok = all(side.get(k, 0) > 0 for side in (pt.predicted, pt.measured)
                       for k in ("ttft_p50_ns", "ttft_p99_ns", "tpot_p50_ns"))
        if not (sides_ok and 0 < pt.coverage <= 1 and kv.get("exec") == "eager"
                and kv.get("clock") == "wall"):
            fail(f"slo: bad record for {probe.op}: {rec}")
        check_cycles(rec)
        slo_line("serving-tiny", rec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["serve-slo", "--db", db_path])
    again = next((line for line in out.getvalue().splitlines() if " measured, " in line), "")
    if rc != 0 or f"0 measured, {len(plan)} cached, 0 failed" not in again:
        fail(f"slo: serve-slo's second run exited {rc}: {again}")
    print(f"slo: serve-slo again on the same DB: {again}")


@contextlib.contextmanager
def capturing_schedules(results: list):
    """Keep each schedule ``run_slo_point`` summarizes (the predicted one,
    then the measured one, a point), through ``traffic.metrics.summarize``,
    which it looks up at call time."""
    from repro_torch.traffic import metrics

    real = metrics.summarize

    def summarize(result, *args, **kw):
        results.append(result)
        return real(result, *args, **kw)

    metrics.summarize = summarize
    try:
        yield results
    finally:
        metrics.summarize = real


@contextlib.contextmanager
def holding_measured_admissions(worst: dict):
    """Hold every K5 and K7 call of the slot pool's measured admissions
    (``traffic.scheduler.EngineExecutor.admit``; the warm-ups call the pool
    itself) against its plain version on that call's inputs, under
    ROW_TOL (K7's final state too), right after the admission has read its
    clock, and drop the call. ``worst`` gathers each kernel's calls and
    worst err/limit, and the admissions."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.mamba_scan import mamba_scan_plain
    from repro_torch.traffic import scheduler

    real = scheduler.EngineExecutor.admit
    per = ["flash_attention"] + ["mamba_scan"] * 7

    def ratio(label, got, want):
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{label}: got {got.dtype} {tuple(got.shape)}, plain version gives "
                 f"{want.dtype} {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{label}: non-finite output")
        r = row_scaled_ratio(got, want, ROW_TOL[want.dtype])
        if r > 1.0:
            fail(f"{label}: disagrees with the plain version ({r:.3f} x the limit)")
        return r

    def admit(self, slot, req):
        calls = []
        with recording_kernels(calls):
            out = real(self, slot, req)
        if [c[0] for c in calls] != per:
            fail(f"slo: admission of request {req.uid} made the calls "
                 f"{[c[0] for c in calls]}, want {per}")
        with torch.no_grad():
            for i, (name, args, kw, got) in enumerate(calls):
                label = f"slo request {req.uid} ({req.prompt_len} tokens) call {i} {name}"
                if name == "flash_attention":
                    rs = [ratio(label, got, flash_attention_plain(*args, **kw))]
                else:
                    y_want, h_want = mamba_scan_plain(*args, **kw)
                    rs = [ratio(label, got[0], y_want), ratio(f"{label} h", got[1], h_want)]
                n, w = worst.get(name, (0, 0.0))
                worst[name] = (n + 1, max(w, *rs))
        worst["admissions"] = worst.get("admissions", 0) + 1
        return out

    scheduler.EngineExecutor.admit = admit
    try:
        yield worst
    finally:
        scheduler.EngineExecutor.admit = real


def run_slo_full(dev: torch.device, db_path: str) -> tuple[dict[str, int], dict]:
    """Jamba-v0.1's pool at full width through ``Session.run`` over
    ``SloProbe``s at SLO_FULL_RATES on the DB at ``db_path``, the counts
    set to 0 just before and read just after: each point measured; every
    request its whole budget on both sides; only K5 and K7 launched, seven
    K7 a K5 and K5 once an admission (a point's records of its distinct
    prompt lengths, its warm-ups of those lengths and of the one-token
    prompt before the decode step, its measured admissions); every K5 and
    K7 call of the measured admissions held against its plain version
    (:func:`holding_measured_admissions`). Frees the model. Returns the
    launches and the points' figures."""
    import gc

    from repro_torch.api import Plan, Session, SloProbe
    from repro_torch.api import probes as torch_probes
    from repro_torch.core.timing import Timer
    from repro_torch.traffic import generate_trace

    cfg, rt = served_jamba()
    probes = tuple(SloProbe(r, cfg=cfg, rt=rt, **SLO_FULL) for r in SLO_FULL_RATES)
    traces = [generate_trace(p.trace_config()) for p in probes]
    session = Session(db=db_path, device=dev, timer=Timer(warmup=2, reps=10, device=dev))
    schedules, worst = [], {}
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    with capturing_schedules(schedules), holding_measured_admissions(worst):
        result = session.run(Plan(probes, name="slo-full"))
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(dev)
    figs = {}
    for r in result.results:
        if r.record is None:
            fail(f"slo: {r.probe.op} failed: {r.failure}")
        check_cycles(r.record)
        figs[r.probe.op] = slo_line("full width", r.record)
    if len(schedules) != 2 * len(probes):
        fail(f"slo: {len(schedules)} schedules summarized, want {2 * len(probes)}")
    admissions = 0
    for i, trace in enumerate(traces):
        budget = [r.max_new for r in sorted(trace, key=lambda r: r.uid)]
        for side, res in (("predicted", schedules[2 * i]), ("measured", schedules[2 * i + 1])):
            got = [rr.n_tokens for rr in res.requests]
            if got != budget or {rr.finish_reason for rr in res.requests} != {"max_new"}:
                fail(f"slo: {probes[i].op} {side}: tokens {got}, want the budgets {budget}")
        n_lens = len({r.prompt_len for r in trace})
        admissions += n_lens + (n_lens + 1) + len(trace)
        print(f"slo: {probes[i].op}: prompts of {sorted(r.prompt_len for r in trace)} tokens, "
              f"budgets {budget}; measured: makespan {schedules[2 * i + 1].makespan_ns / 1e6:.3f} "
              f"ms, {schedules[2 * i + 1].decode_steps} decode steps; predicted makespan "
              f"{schedules[2 * i].makespan_ns / 1e6:.6g} ms")
    want = {"flash_attention": admissions, "mamba_scan": 7 * admissions}
    if launches != want:
        fail(f"slo: the full-width points launched {launches}, want {want} (K5 once and K7 "
             "seven times an admission: records, warm-ups and measured, nothing else)")
    held = worst.pop("admissions", 0)
    if held != len(probes) * SLO_FULL["n_requests"]:
        fail(f"slo: {held} measured admissions held, want "
             f"{len(probes) * SLO_FULL['n_requests']}")
    print(f"slo: full width {cfg.name} at {cfg.n_layers} layers, {SLO_FULL['n_slots']} slots on "
          f"a cache of {SLO_FULL['max_len']}: {len(probes)} points in {wall:.2f} s (the model "
          f"built once), launches {launches}; the K5 and K7 calls of the {held} measured "
          f"admissions held against their plain versions: "
          + ", ".join(f"{k} {n} calls, worst err/limit {w:.3f}" for k, (n, w) in worst.items())
          + f"; peak memory allocated {peak} B; card {card()}")
    del result, probes, session, schedules
    gc.collect()
    torch.cuda.empty_cache()
    if torch_probes._SERVED_MODELS:
        fail(f"slo: the served model outlived the phase: {list(torch_probes._SERVED_MODELS)}")
    print(f"slo: after the phase the model is freed: {torch.cuda.memory_allocated(dev)} B "
          "allocated")
    return launches, figs


def run_slo(dev: torch.device, run_db, fused_db) -> dict[str, int]:
    """Phase slo: ``serve-slo`` on serving-tiny, then Jamba-v0.1's pool at
    full width, on a copy of the run's DB with the fused plan's rows merged
    in. No Dynamo frame may compile. Returns the full-width points'
    launches (serving-tiny's are none)."""
    from repro_torch.core.latency_db import LatencyDB

    frames = torch._dynamo.utils.counters["frames"]["total"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        db_path = str(Path(tmp) / "slo_db.json")
        db = LatencyDB()
        db.merge(run_db, fused_db)
        db.save(db_path)
        run_slo_tiny(dev, db_path)
        launches, figs = run_slo_full(dev, db_path)
    compiled = torch._dynamo.utils.counters["frames"]["total"] - frames
    print(f"slo: Dynamo frames compiled in this phase: {compiled}")
    if compiled:
        fail(f"slo: {compiled} frames went through torch.compile; the phase runs eagerly")
    print(f"slo: phase wall {time.perf_counter() - t0:.2f} s against the bound "
          f"{SLO_BOUND_S:.0f} s; figures {json.dumps(figs)}; card {card()}")
    return launches


def hold_serve_calls(calls: list, n_launcher: int) -> None:
    """Hold each recorded K5 and K7 call of the main path against its plain
    version on that call's inputs, under ROW_TOL (K7's final state too):
    the launcher's prefill (``calls[:n_launcher]``), then the long
    prompts'. K5's plain version runs a batch row at a time (its float32
    scores at 8 x 2048 tokens would take 4 GiB)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.mamba_scan import mamba_scan_plain

    names = [c[0] for c in calls]
    per = ["flash_attention"] + ["mamba_scan"] * 7
    if names != per * 2 or n_launcher != len(per):
        fail(f"serve: the main path made the calls {names}, want {per} twice")
    for i, (name, args, kw, got) in enumerate(calls):
        run = "launcher" if i < n_launcher else "long prompts"
        if name == "flash_attention":
            want = torch.cat([flash_attention_plain(*(a[r:r + 1] for a in args), **kw)
                              for r in range(args[0].shape[0])])
            hold(f"serve {run} K5 call q{list(args[0].shape)} {args[0].dtype}", got, want)
        else:
            y_want, h_want = mamba_scan_plain(*args, **kw)
            hold(f"serve {run} K7 call {i % len(per)} x{list(args[0].shape)} chunk "
                 f"{kw.get('chunk')}", got[0], y_want)
            hold(f"serve {run} K7 call {i % len(per)}, final state h", got[1], h_want)
    print(f"serve: {len(calls)} K5 and K7 calls of the main path held against their plain "
          "versions on their own inputs")


def check_serve_paths(eng, rng: np.random.RandomState, dev: torch.device) -> None:
    """Phase serve's path-vs-path check at SERVE_CHECK, layer by layer
    (``models.pathcheck``): every layer of a prefill and of the first decode
    step after it, on the kernel path and on the plain path (plain
    attention, the chunked scan), each given the plain path's input and the
    same expert choices; each output and the logits within LAYER_TOL, each
    Mamba state within STATE_TOL. Three controls must fail it: K7 without
    its D skip, K7 handing back the state one step short, and the decode
    step from zero Mamba states (R3)."""
    from repro_torch.kernels import ops
    from repro_torch.models import pathcheck

    model, cfg = eng.model, eng.cfg
    b, s = SERVE_CHECK
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (b, s + 1))).to(dev)
    kern = eng.rt
    plain = dataclasses.replace(kern, attn_impl="plain", use_pallas=False)
    rows, ck, cp = pathcheck.prefill_layers(model, kern, plain, toks[:, :s])
    rows += pathcheck.decode_layers(model, ck, cp, toks[:, s:], s, kern, plain)
    for r in rows:
        cells = [f"output {r['out']:.3f}"]
        if r["cache"] is not None:
            cells.append(f"KV/conv cache {r['cache']:.3f}")
        if r["state"] is not None:
            cells.append(f"Mamba state {r['state']:.3f} (of 2^-13)")
        print(f"serve: layer check {r['step']} {r['layer']} {r['kind'] or ''}: "
              f"{', '.join(cells)} of the limit 2^-5 * (|want| + rms(row))")
    worst = max(rows, key=lambda r: r["worst"])
    print(f"serve: layer check at {b} x {s}: {len(rows)} rows, worst {worst['worst']:.3f} of "
          f"its limit ({worst['step']} {worst['layer']})")
    if worst["worst"] > 1.0:
        fail(f"serve: the kernel path's {worst['step']} {worst['layer']} is off the plain "
             f"path's by {worst['worst']:.3f} of its limit")

    real = ops.mamba_scan

    def no_skip(x, dt, A, B, C, D, **kw):
        return real(x, dt, A, B, C, torch.zeros_like(D), **kw)

    def short_state(x, dt, A, B, C, D, **kw):
        y, _ = real(x, dt, A, B, C, D, **kw)
        cut = [t[:, :-1].contiguous() for t in (x, dt, B, C)]
        return y, real(cut[0], cut[1], A, cut[2], cut[3], D, **kw)[1]

    controls = {}
    for label, fault in (("K7 without its D skip", no_skip),
                         ("K7's final state one step short", short_state)):
        ops.mamba_scan = fault
        try:
            controls[label] = pathcheck.prefill_layers(model, kern, plain, toks[:, :s])[0]
        finally:
            ops.mamba_scan = real
    controls["the decode step from zero Mamba states (R3)"] = pathcheck.decode_layers(
        model, pathcheck.zero_states(ck), cp, toks[:, s:], s, kern, plain)
    for label, rs in controls.items():
        bad = max(rs, key=lambda r: r["worst"])
        print(f"serve: control, {label}: worst {bad['worst']:.3f} of its limit ({bad['step']} "
              f"{bad['layer']}) -> {'REJECTED' if bad['worst'] > 1 else 'passed'}")
        if bad["worst"] <= 1.0:
            fail(f"serve: the control '{label}' passes the layer check: it cannot tell a "
                 "sound K7 from an unsound one")


# ------------------------------------------------------------ K7 at length
# K7 held at these sequence lengths on the served model's own scan inputs
K7_LONG = (4096, 8192)


@torch.no_grad()
def scan_f64(x, dt, A, B, C, D, marks: tuple[int, ...]):
    """The selective scan in float64, a step at a time: the yardstick K7
    and its float32 plain version are both held to. Returns y [Bz,S,Dm]
    and the state h [Bz,Dm,N] after each of ``marks`` steps."""
    from repro_torch.kernels.mamba_scan import softplus

    bsz, s, dm = x.shape
    xd, dtd = x.double(), softplus(dt.double())
    ad, bd, cd = A.double(), B.double(), C.double()
    h = torch.zeros(bsz, dm, A.shape[1], dtype=torch.float64, device=x.device)
    y = torch.empty(bsz, s, dm, dtype=torch.float64, device=x.device)
    states = {}
    for t in range(s):
        h = torch.exp(dtd[:, t, :, None] * ad) * h + (dtd[:, t] * xd[:, t])[..., None] * bd[:, t, None, :]
        y[:, t] = (h * cd[:, t, None, :]).sum(dim=-1)
        if t + 1 in marks:
            states[t + 1] = h.clone()
    return y + xd * D.double(), states


@torch.no_grad()
def check_k7_long(eng, rng: np.random.RandomState) -> dict:
    """K7 at K7_LONG steps at Jamba width, on the served model's own scan
    inputs: one prefill of max(K7_LONG) tokens at batch 1 records each K7
    call's inputs (x, dt [1, S, 8192], N 16, float32); the first Mamba
    layer's are scanned, cut to each length, by K7, by its plain version
    (float32, a step at a time) and in float64. y and the final state of
    both are held to the float64 scan within 2^-13 * (|want| + rms(row));
    K7 past that limit fails. (The last Mamba layer's inputs read the same,
    0.154-0.170 of the limit on K7's state, in PR 26's first card run.)
    Returns the ratios by length."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba_scan import mamba_scan_plain
    from repro_torch.models import transformer

    tol = ROW_TOL[torch.float32]
    s = max(K7_LONG)
    toks = torch.from_numpy(rng.randint(1, eng.cfg.vocab_size, (1, s))).to(eng.device)
    calls = []
    with recording_kernels(calls):
        transformer.forward(eng.model, eng.rt, tokens=toks)
    _, args, kw, _ = next(c for c in calls if c[0] == "mamba_scan")
    del calls
    y64, h64 = scan_f64(*args, marks=K7_LONG)
    out = {}
    for n in K7_LONG:
        cut = [a[:, :n].contiguous() if a.dim() == 3 else a for a in args]
        y_k, h_k = ops.mamba_scan(*cut, chunk=kw.get("chunk", 128), return_state=True)
        y_p, h_p = mamba_scan_plain(*cut, return_state=True)
        r = {"K7 y": row_scaled_ratio(y_k, y64[:, :n], tol),
             "K7 h": row_scaled_ratio(h_k, h64[n], tol),
             "plain y": row_scaled_ratio(y_p, y64[:, :n], tol),
             "plain h": row_scaled_ratio(h_p, h64[n], tol),
             "K7 h against plain h": row_scaled_ratio(h_k, h_p, tol)}
        out[n] = r
        print(f"serve: K7 at {n} steps, the first Mamba layer of the served model, x "
              f"{list(cut[0].shape)}, against the float64 scan (units of 2^-13 * "
              f"(|want| + rms(row))): " + ", ".join(f"{k} {v:.3f}" for k, v in r.items()))
        if max(r["K7 y"], r["K7 h"]) > 1.0:
            fail(f"K7 at {n} steps is off the float64 scan: {r}")
    return out


# ----------------------------------------------------------------- archs
# the three architectures served at full width and depth, weights from a
# seed on the card: xlstm-350m through the launcher and its Engine;
# qwen2-vl-2b and seamless-m4t-large-v2 through prefill and decode_step (the
# JAX package serves them that way only)
ARCHS_XLSTM_ARGV = ["--arch", "xlstm-350m", "--full", "--device", "cuda:0"]
ARCHS_BATCH = (8, 2048)          # qwen2-vl's patches, seamless's decoder prompt
ARCHS_NEW = 32                   # greedy tokens after each prompt
QWEN_GRID = (32, 64)             # the patches' grid: M-RoPE t 0, h the row, w the column
SEAMLESS_FRAMES = 512            # the encoder's length, S / 4
ARCHS_CHECK = (2, 512)           # the layer checks' batch and length
ARCHS_K5_PER_PREFILL = {"qwen2-vl-2b": 28, "seamless-m4t-large-v2": 72}
ARCHS_BOUND_S = 45.0


def _k5_case(q, k, causal: bool) -> str:
    return (f"flash_attention bf16 {'causal' if causal else 'non-causal'} q{list(q.shape)} "
            f"kv{list(k.shape)}")


def hold_k5_calls(model: str, calls: list, cases: dict) -> None:
    """Each recorded K5 call of ``model``'s main path against its plain
    version (a batch row at a time) under ROW_TOL; prints the worst of each
    case (queries, keys, causal) and keeps its first call's inputs in
    ``cases`` for the timing phase."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    worst = {}
    for name, args, kw, got in calls:
        if name != "flash_attention":
            fail(f"archs: {model} called {name}")
        want = torch.cat([flash_attention_plain(*(a[r:r + 1] for a in args), **kw)
                          for r in range(args[0].shape[0])])
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"archs: {model} K5 call q{list(args[0].shape)}: non-finite output")
        ratio = row_scaled_ratio(got, want, ROW_TOL[want.dtype])
        label = _k5_case(args[0], args[1], kw.get("causal", True))
        n, w = worst.get(label, (0, 0.0))
        worst[label] = (n + 1, max(w, ratio))
        if label not in cases:
            cases[label] = {"model": model, "args": args, "kw": kw, "calls": 0,
                            "err_over_limit": 0.0}
        cases[label]["calls"] += 1
        cases[label]["err_over_limit"] = max(cases[label]["err_over_limit"], ratio)
        if ratio > 1.0:
            fail(f"archs: {model} K5 call {label} disagrees with the plain version "
                 f"({ratio:.3f} x the limit)")
    for label, (n, w) in worst.items():
        print(f"archs: {model} {n} K5 calls {label}: worst err/limit {w:.3f} "
              f"(limit 2^-7 * (|want| + rms(row)))")


def print_layer_rows(model: str, rows: list[dict]) -> dict:
    """Print a layer check's rows (``models.pathcheck``'s) and its worst;
    fails above 1. Returns the worst row."""
    for r in rows:
        cells = [f"output {r['out']:.3f}"]
        if r["cache"] is not None:
            cells.append(f"cache {r['cache']:.3f}")
        if r["state"] is not None:
            cells.append(f"state {r['state']:.3f}")
        print(f"archs: {model} layer check {r['step']} {r['layer']}: {', '.join(cells)} of "
              "the limit 2^-5 * (|want| + rms(row))")
    worst = max(rows, key=lambda r: r["worst"])
    print(f"archs: {model} layer check at {ARCHS_CHECK[0]} x {ARCHS_CHECK[1]}: {len(rows)} "
          f"rows, worst {worst['worst']:.3f} of its limit ({worst['step']} {worst['layer']})")
    if worst["worst"] > 1.0:
        fail(f"archs: {model}'s kernel path is off its plain path at {worst['step']} "
             f"{worst['layer']} by {worst['worst']:.3f} of the limit")
    return worst


def control(model: str, label: str, rows: list[dict]) -> float:
    """A control's worst output ratio; it must fail the check (above 1)."""
    bad = max(r["out"] for r in rows)
    print(f"archs: {model} control, {label}: worst {bad:.3f} of its limit -> "
          f"{'REJECTED' if bad > 1 else 'passed'}")
    if bad <= 1.0:
        fail(f"archs: the control '{label}' passes {model}'s check")
    return bad


def greedy(step, logits: torch.Tensor, n: int) -> tuple[np.ndarray, float]:
    """``n`` greedy tokens: the prefill's, then n - 1 decode steps
    (``step(tokens, i)`` returns the next logits); returns them and the ms
    a decode step took (host clock, synchronised)."""
    toks = [torch.argmax(logits, dim=-1)[:, None]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n - 1):
        logits = step(toks[-1], i)
        toks.append(torch.argmax(logits, dim=-1)[:, None])
    out = torch.cat(toks, dim=1).cpu().numpy()
    return out, (time.perf_counter() - t0) * 1e3 / max(n - 1, 1)


def archs_xlstm(dev: torch.device, rng: np.random.RandomState) -> dict:
    """xlstm-350m: the launcher's 8 requests, then 8 ragged prompts of
    256-2048 tokens, 32 greedy tokens each, through its Engine (no kernel:
    the JAX package has none for the xLSTM mixers); then, at ARCHS_CHECK,
    each layer's chunked prefill of S tokens against its prefill of S - 1
    tokens and one decode step, given the same input: the last position's
    output and the state it hands on (the mLSTM's without its stabilizer,
    c e^m and n e^m) within LAYER_TOL. Control: the decode step from a zero
    mLSTM state."""
    from repro_torch.launch import serve
    from repro_torch.models import pathcheck, transformer

    zero_counts()
    eng = serve.main(ARCHS_XLSTM_ARGV)
    model, cfg = eng.model, eng.cfg
    lo, hi = SERVE_LONG["min_len"], SERVE_LONG["max_len"]
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist() for n in
               [lo, hi] + list(rng.randint(lo, hi + 1, SERVE_LONG["requests"] - 2))]
    torch.cuda.reset_peak_memory_stats(dev)
    out = eng.generate(prompts, max_new=ARCHS_NEW)
    launches = {k: v for k, v in read_counts().items() if v}
    if launches:
        fail(f"archs: xlstm-350m launched {launches}; its path runs no kernel")
    if not ((out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        fail("archs: xlstm-350m: tokens outside the vocabulary")
    fig = {"params": transformer.n_params(model),
           "bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "prefill_ms": out.prefill_s * 1e3,
           "decode_ms": out.decode_s * 1e3 / (out.steps - 1),
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    print(f"archs: xlstm-350m long prompts: {len(prompts)} requests of "
          f"{[len(p) for p in prompts]} tokens, {ARCHS_NEW} greedy tokens each: prefill "
          f"{fig['prefill_ms']:.2f} ms, decode {fig['decode_ms']:.3f} ms a token, peak memory "
          f"{fig['peak_bytes']} B; {cfg.n_layers} layers, {fig['params']} parameters, "
          f"{fig['bytes']} B ({cfg.param_dtype}); req0 {out.tokens[0].tolist()[:8]}...")

    b, s = ARCHS_CHECK
    rt = eng.rt
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (b, s))).to(dev)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    tol = pathcheck.LAYER_TOL
    rows, zero_rows = [], []
    with torch.no_grad():
        x = transformer._embed_in(model, toks)
        for i, period in enumerate(model.periods):
            for name, block in period.items():
                y_full, c_full = block.mixer(x, rt)
                _, c_prev = block.mixer(x[:, :-1], rt)
                y_dec, c_dec = block.mixer.decode(x[:, -1:], c_prev)
                if "m" in c_dec and "h" not in c_dec:      # mLSTM: take out the stabilizer
                    scale = torch.exp(c_dec["m"])
                    got = {"c": c_dec["c"] * scale[..., None, None],
                           "n": c_dec["n"] * scale[..., None], "conv": c_dec["conv"]}
                    zero = {**c_prev, "c": torch.zeros_like(c_prev["c"]),
                            "n": torch.zeros_like(c_prev["n"])}
                    y_zero, _ = block.mixer.decode(x[:, -1:], zero)
                    zero_rows.append({"out": pathcheck.row_scaled_ratio(
                        y_zero[:, 0], y_full[:, -1], tol)})
                else:
                    got = {k: c_dec[k] for k in ("c", "n", "h")}
                state = max(pathcheck.row_scaled_ratio(got[k], c_full[k], tol) for k in got)
                r = pathcheck.row_scaled_ratio(y_dec[:, 0], y_full[:, -1], tol)
                rows.append({"step": "decode", "layer": f"{i}.{name}", "out": r,
                             "cache": None, "state": state, "worst": max(r, state)})
                x = y_full
    worst = print_layer_rows("xlstm-350m", rows)
    control("xlstm-350m", "the decode step from a zero mLSTM state", zero_rows)
    fig["layer_check_worst"] = worst["worst"]
    del eng, model
    return fig


def archs_qwen(dev: torch.device, rng: np.random.RandomState, cases: dict) -> tuple[dict, int]:
    """qwen2-vl-2b: a prefill of ARCHS_BATCH patch embeddings (bfloat16,
    from a seed, scaled as its token embeddings) at the M-RoPE positions of
    a QWEN_GRID patch grid, K5 on every attention layer (12 query heads to 2
    KV heads, D 128), then ARCHS_NEW greedy text tokens at positions whose
    three streams all continue from the grid's largest position plus one;
    every K5 call held against its plain version; the layer check at
    ARCHS_CHECK (a 16 x 32 grid), K5 without its causal mask the control."""
    from repro_torch.configs.registry import get
    from repro_torch.kernels import ops
    from repro_torch.models import pathcheck, transformer
    from repro_torch.models.config import Runtime

    cfg = get("qwen2-vl-2b").config
    rt = Runtime(remat=False, attn_impl="pallas", use_pallas=True)
    plain = dataclasses.replace(rt, attn_impl="plain", use_pallas=False)
    model = transformer.init_lm(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)

    def grid(b, rows, cols):
        h, w = torch.meshgrid(torch.arange(rows, device=dev), torch.arange(cols, device=dev),
                              indexing="ij")
        pos = torch.stack([torch.zeros_like(h).flatten(), h.flatten(), w.flatten()])
        return pos[:, None].expand(3, b, rows * cols)

    def patches(b, s):
        return (torch.randn(b, s, cfg.d_model, generator=g, device=dev)
                * cfg.d_model ** -0.5).to(torch.bfloat16)

    b, s = ARCHS_BATCH
    emb, pos = patches(b, s), grid(b, *QWEN_GRID)
    nxt = int(pos.max()) + 1
    calls = []
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    with recording_kernels(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(model, rt, embeds=emb, positions=pos)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        cache = transformer.pad_cache(cache, cfg, s + ARCHS_NEW)
        state = {"cache": cache}

        def step(tok, i):
            lg, state["cache"] = transformer.decode_step(
                model, state["cache"], tok, s + i, rt,
                positions=torch.full((3, b, 1), nxt + i, device=dev))
            return lg
        toks, decode_ms = greedy(step, logits, ARCHS_NEW)
    launches = {k: v for k, v in read_counts().items() if v}
    fig = {"params": transformer.n_params(model),
           "bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    want = {"flash_attention": ARCHS_K5_PER_PREFILL["qwen2-vl-2b"]}
    if launches != want:
        fail(f"archs: qwen2-vl-2b launched {launches}, want {want}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("archs: qwen2-vl-2b: tokens outside the vocabulary")
    print(f"archs: qwen2-vl-2b: {b} x {s} patch embeddings at a {QWEN_GRID[0]} x "
          f"{QWEN_GRID[1]} grid's M-RoPE positions, {ARCHS_NEW} greedy text tokens from "
          f"position {nxt}: prefill {prefill_ms:.2f} ms, decode {decode_ms:.3f} ms a token, "
          f"peak memory {fig['peak_bytes']} B; {cfg.n_layers} layers, {fig['params']} "
          f"parameters, {fig['bytes']} B ({cfg.param_dtype}); launches {launches}; req0 "
          f"{toks[0].tolist()[:8]}...")
    with torch.no_grad():
        hold_k5_calls("qwen2-vl-2b", calls, cases)
    del calls, state, cache

    cb, cs = ARCHS_CHECK
    emb, pos = patches(cb, cs), grid(cb, 16, cs // 16)
    tok = torch.from_numpy(rng.randint(1, cfg.vocab_size, (cb, 1))).to(dev)
    nxt = torch.full((3, cb, 1), int(pos.max()) + 1, device=dev)
    rows, ck, cp = pathcheck.prefill_layers(model, rt, plain, embeds=emb, positions=pos)
    rows += pathcheck.decode_layers(model, ck, cp, tok, cs, rt, plain, positions=nxt)
    fig["layer_check_worst"] = print_layer_rows("qwen2-vl-2b", rows)["worst"]
    real = ops.flash_attention
    ops.flash_attention = lambda q, k, v, causal=True, **kw: real(q, k, v, causal=False, **kw)
    try:
        bad = pathcheck.prefill_layers(model, rt, plain, embeds=emb, positions=pos)[0]
    finally:
        ops.flash_attention = real
    control("qwen2-vl-2b", "K5 without its causal mask", bad)
    del model, ck, cp
    return fig, launches["flash_attention"]


def archs_seamless(dev: torch.device, rng: np.random.RandomState,
                   cases: dict) -> tuple[dict, int]:
    """seamless-m4t-large-v2: frames [8, SEAMLESS_FRAMES, 1024] (bfloat16,
    from a seed) through the encoder (K5 not causal), a teacher-forced
    decoder prompt of ARCHS_BATCH tokens (K5 causal, and K5 across to the
    memory, queries and keys of different lengths), then ARCHS_NEW greedy
    tokens through decode_step with the cross cache; every K5 call held
    against its plain version; the layer check at ARCHS_CHECK (frames S /
    4), K5 made causal on the encoder the control."""
    from repro_torch.configs.registry import get
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, pathcheck, transformer
    from repro_torch.models.config import Runtime

    cfg = get("seamless-m4t-large-v2").config
    rt = Runtime(remat=False, attn_impl="pallas", use_pallas=True)
    plain = dataclasses.replace(rt, attn_impl="plain", use_pallas=False)
    model = encdec.init_encdec(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)

    def frames(b, n):
        return torch.randn(b, n, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)

    b, s = ARCHS_BATCH
    fr = frames(b, SEAMLESS_FRAMES)
    prompt = torch.from_numpy(rng.randint(1, cfg.vocab_size, (b, s))).to(dev)
    calls = []
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    with recording_kernels(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = encdec.prefill(model, rt, fr, prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        state = {"cache": encdec.pad_cache(cache, s + ARCHS_NEW)}

        def step(tok, i):
            lg, state["cache"] = encdec.decode_step(model, state["cache"], tok, s + i, rt)
            return lg
        toks, decode_ms = greedy(step, logits, ARCHS_NEW)
    launches = {k: v for k, v in read_counts().items() if v}
    fig = {"params": transformer.n_params(model),
           "bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    want = {"flash_attention": ARCHS_K5_PER_PREFILL["seamless-m4t-large-v2"]}
    if launches != want:
        fail(f"archs: seamless-m4t-large-v2 launched {launches}, want {want}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("archs: seamless-m4t-large-v2: tokens outside the vocabulary")
    print(f"archs: seamless-m4t-large-v2: frames [{b}, {SEAMLESS_FRAMES}, {cfg.d_model}], a "
          f"decoder prompt of {b} x {s} tokens, {ARCHS_NEW} greedy tokens with the cross "
          f"cache: prefill {prefill_ms:.2f} ms, decode {decode_ms:.3f} ms a token, peak "
          f"memory {fig['peak_bytes']} B; {cfg.n_encoder_layers} + {cfg.n_layers} layers, "
          f"{fig['params']} parameters, {fig['bytes']} B ({cfg.param_dtype}); launches "
          f"{launches}; req0 {toks[0].tolist()[:8]}...")
    with torch.no_grad():
        hold_k5_calls("seamless-m4t-large-v2", calls, cases)
    del calls, state, cache

    cb, cs = ARCHS_CHECK
    fr = frames(cb, cs // 4)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (cb, cs + 1))).to(dev)
    rows, ck, cp = pathcheck.encdec_prefill_layers(model, rt, plain, fr, toks[:, :cs])
    rows += pathcheck.encdec_decode_layers(model, ck, cp, toks[:, cs:], cs, rt, plain)
    fig["layer_check_worst"] = print_layer_rows("seamless-m4t-large-v2", rows)["worst"]
    real = ops.flash_attention

    def causal_encoder(q, k, v, causal=True, **kw):
        return real(q, k, v, causal=causal or q.shape[1] == k.shape[1], **kw)

    ops.flash_attention = causal_encoder
    try:
        bad = pathcheck.encdec_prefill_layers(model, rt, plain, fr, toks[:, :cs])[0]
    finally:
        ops.flash_attention = real
    control("seamless-m4t-large-v2", "K5 made causal on the encoder",
            [r for r in bad if r["step"] == "encode"])
    del model, ck, cp
    return fig, launches["flash_attention"]


def run_archs(dev: torch.device) -> tuple[dict, dict]:
    """Phase archs: xlstm-350m, qwen2-vl-2b and seamless-m4t-large-v2 at
    full width and depth (:func:`archs_xlstm`, :func:`archs_qwen`,
    :func:`archs_seamless`), each model freed before the next; the launch
    counts set to 0 just before each model's main path and read just
    after (K5 only, and only in qwen2-vl and seamless); no Dynamo frame
    compiled. Returns K5's launches by model and the K5 cases (the first
    call of each shape, kept for the timing phase)."""
    import gc

    frames = torch._dynamo.utils.counters["frames"]["total"]
    rng = np.random.RandomState(3)
    cases, launches, figs = {}, {}, {}
    t0 = time.perf_counter()
    figs["xlstm-350m"] = archs_xlstm(dev, rng)
    gc.collect()
    torch.cuda.empty_cache()
    figs["qwen2-vl-2b"], launches["qwen2-vl-2b"] = archs_qwen(dev, rng, cases)
    gc.collect()
    torch.cuda.empty_cache()
    figs["seamless-m4t-large-v2"], launches["seamless-m4t-large-v2"] = archs_seamless(
        dev, rng, cases)
    gc.collect()
    torch.cuda.empty_cache()
    compiled = torch._dynamo.utils.counters["frames"]["total"] - frames
    wall = time.perf_counter() - t0
    print(f"archs: Dynamo frames compiled in this phase: {compiled}; K5 launches by model "
          f"{launches}; wall {wall:.2f} s against the bound {ARCHS_BOUND_S:.0f} s; card {card()}")
    print(f"archs: figures {json.dumps(figs)}")
    if compiled:
        fail(f"archs: {compiled} frames went through torch.compile; the phase runs eagerly")
    return launches, cases


def fused_work(name: str, args: tuple, kw: dict) -> tuple[int, int, float, str]:
    """(bytes, operations, the operations' least time in s, how it was
    taken) of one call: each input read once and each output written once;
    operations counted for what these inputs need (causal and kv_len masks
    cut the visible pairs), at the peak of the inputs' type. K5 in float32
    takes the least of float32 FMAs, three TF32 products and three bf16
    products on the tensor cores (x split as hi = bf16(x), lo = bf16(x -
    hi) keeps about 2^-16 of each product, inside the float32 limit: see
    tests/test_torch_tf32.py). K7 takes its float32 operations; its
    exponentials on the SFU (MUFU) alone are printed as a datum, not a
    floor, since an ex2 can also run as a polynomial on the FMA pipes."""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    x = args[0]
    rate = BF16_OPS_PER_S if x.dtype == torch.bfloat16 else FP32_OPS_PER_S
    if name == "rmsnorm":   # x, w in; out; square-add, scale, weight: 4 per element
        return nbytes(*args, x), 4 * x.numel(), 4 * x.numel() / rate, "the dtype's peak"
    if name == "flash_attention":  # q, k, v in; o out; 4 D per visible pair and head
        b, sq, h, d = x.shape
        sk = args[1].shape[1]
        if kw.get("causal", True):
            pairs = sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq))
        else:
            pairs = sq * sk
        nops = 4 * d * b * h * pairs
        if x.dtype == torch.bfloat16:
            return nbytes(*args, x), nops, nops / rate, "the dtype's peak"
        ways = {"FMAs": nops / FP32_OPS_PER_S, "3xTF32": 3 * nops / TF32_OPS_PER_S,
                "3xBF16": 3 * nops / BF16_OPS_PER_S}
        least = min(ways, key=ways.get)
        how = ("least of float32 " + ", ".join(f"{k} {v * 1e3:.6f} ms" for k, v in ways.items())
               + f" (3xTF32 and 3xBF16 on the tensor cores): {least}")
        return nbytes(*args, x), nops, ways[least], how
    if name == "flash_decode":  # the keys below kv_len only
        q, k, _, kv_len = args
        b, h, d = q.shape
        s, kh = k.shape[1], k.shape[2]
        keys = int(kv_len.clamp(0, s).sum())
        kv = 2 * keys * kh * d * k.element_size()
        return nbytes(q, kv_len, q) + kv, 4 * d * h * keys, 4 * d * h * keys / rate, "the dtype's peak"
    # mamba_scan: x, dt, A, B, C, D in; y (and h) out; per (t, channel)
    # softplus and dt*x (~6), per state dim a multiply, exp, two fmas (~7),
    # one ex2 of them, which the kernel takes on the SFU
    bsz, s, dm = x.shape
    n = args[2].shape[1]
    outs = (x, args[2].new_empty(bsz, dm, n)) if kw.get("return_state") else (x,)
    nops, mufu = (7 * n + 6) * bsz * s * dm, n * bsz * s * dm
    fp32, sfu = nops / FP32_OPS_PER_S, mufu / MUFU_OPS_PER_S
    how = (f"float32 ops {fp32 * 1e3:.6f} ms; datum, not a floor: {mufu} ex2 on the SFU "
           f"alone {sfu * 1e3:.6f} ms")
    return nbytes(*args, *outs), nops, fp32, how


def library_call(name: str, args: tuple, kw: dict):
    """One PyTorch call computing the same function on the same inputs, or
    None: F.rms_norm; SDPA with enable_gqa (non-causal, or causal at Sq =
    Sk, where SDPA's top-left causal mask is the kernel's); SDPA with a
    kv_len mask for decode. A yardstick only: nothing in the port calls it."""
    import torch.nn.functional as F

    if name == "rmsnorm":
        x, w = args
        return lambda: F.rms_norm(x, (x.shape[-1],), w, eps=1e-6)
    if name == "flash_attention":
        q, k, v = (t.transpose(1, 2) for t in args)
        causal = kw.get("causal", True)
        if causal and q.shape[2] != k.shape[2]:
            return None
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      enable_gqa=True)
    if name == "flash_decode":
        q, k, v, kv_len = args
        s = k.shape[1]
        mask = (torch.arange(s, device=q.device)[None, :]
                < kv_len.long()[:, None])[:, None, None, :]
        q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                      enable_gqa=True)
    return None


def time_fused(dev: torch.device, err: dict, jamba: dict, cases: dict,
               launches: dict, serve_launches: dict, archs_launches: dict,
               archs_cases: dict, serving_launches: dict,
               slo_launches: dict) -> list[dict]:
    """Phase 5, K4-K7: the kernel (CUDA events behind a lead), its plain
    version (wall time to completion), its bound and the library call, at
    the fused plan's larger unit workload (n = 6) and at the Jamba case
    (and at the second case of JAMBA_TIMED_MORE); K5 also at each case of
    phase archs, on the inputs of its first call there; its launches summed
    over the fused run and phases serve, archs, serving and slo (also by
    phase)."""
    from repro_torch.core.timing import Timer
    from repro_torch.inkernel import (FUSED_KERNELS, FUSED_LENS, build_fused, fused_kwargs,
                                      unit_bytes)

    mods = fused_modules()
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:20",
                "flash_attention": "src/repro/kernels/flash_attention.py:76",
                "flash_decode": "src/repro/kernels/flash_decode.py:60",
                "mamba_scan": "src/repro/kernels/mamba_scan.py:46"}
    timer = Timer(warmup=3, reps=20, device=dev)

    def measure(name, args, kw, label):
        wrapper = getattr(mods[name], name)
        plain = getattr(mods[name], f"{name}_plain")
        ms = timer.time_callable(lambda: wrapper(*args, **kw)).median_ns / 1e6
        plain_ms = wall_ms(lambda: plain(*args, **kw), reps=3)
        lib = library_call(name, args, kw)
        library_ms = None if lib is None else timer.time_callable(lib).median_ns / 1e6
        nbytes, nops, ops_s, how = fused_work(name, args, kw)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_s * 1e3, "operations"))
        lib_txt = "null" if library_ms is None else f"{library_ms:.6f} ms"
        print(f"{name} [{label}]: {ms:.6f} ms/launch on the card, plain {plain_ms:.6f} ms "
              f"wall, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B = {bytes_ms:.6f} ms, "
              f"{nops} ops = {ops_s * 1e3:.6f} ms, {how}), library {lib_txt}, "
              f"{ms / bound_ms:.1f} x the bound")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_how": how, "library_ms": library_ms}

    out = []
    n = FUSED_LENS[1]
    for name in FUSED_KERNELS:
        _, args = build_fused(name, n, dev)
        unit = measure(name, args, fused_kwargs(name), f"unit workload n={n}, "
                                       f"unit_bytes={unit_bytes(name)}")
        label = JAMBA_TIMED[name]
        _, jargs, jkw = cases[label]
        big = measure(name, jargs, jkw, f"Jamba {label}")
        big.update(jamba[label], shape=label)
        extra = {}
        if name == "flash_decode":
            extra["g_sweep_ms"] = decode_group_sweep(timer, cases)
            extra["pass_us"] = decode_passes(cases)
        if name == "mamba_scan":
            extra["copy_ms"] = scan_copy_widths(timer, jargs, jkw)
        if name in JAMBA_TIMED_MORE:
            key, mlabel = JAMBA_TIMED_MORE[name]
            _, margs, mkw = cases[mlabel]
            extra[key] = measure(name, margs, mkw, f"Jamba {mlabel}")
            extra[key].update(jamba[mlabel], shape=mlabel)
        by_phase = {"fused": launches[name], "serve": serve_launches.get(name, 0),
                    "serving": serving_launches.get(name, 0),
                    "slo": slo_launches.get(name, 0)}
        if name == "flash_attention":
            by_phase["archs"] = sum(archs_launches.values())
            extra["archs"] = {}
            for label, case in archs_cases.items():
                extra["archs"][label] = {
                    **measure(name, case["args"], case["kw"], f"archs {case['model']} {label}"),
                    "model": case["model"], "launches": case["calls"],
                    "err_over_limit": case["err_over_limit"]}
        print(f"{name}: {sum(by_phase.values())} launches on the main path {by_phase}")
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/csrc/{name}.cu",
                    "replaces": replaces[name], "design": designs(name),
                    "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
                    "max_abs_err": err[name], **unit, "jamba": big, **extra})
    return out


def scan_copy_widths(timer, args: tuple, kw: dict,
                     rounds: int = 3) -> dict[str, list[float]]:
    """K7 at the Jamba case in its two copy widths, alternated, a median of
    20 each round: 16-byte copies (the wrapper, aligned inputs), 4-byte
    copies of the same inputs (the kernel's C entry asked for them), and
    the wrapper on copies of the inputs placed 4 bytes off a 16-byte
    boundary (4-byte copies, the rows off their sectors too). All three
    must give the same y, bit for bit. A datum on what the 16-byte path buys."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import stream_handle
    from repro_torch.kernels.mamba_scan import _lib, mamba_scan, scan_vectorized

    def off(t):
        v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
        return v.copy_(t)

    moved = tuple(off(t) for t in args)
    if not (scan_vectorized(*args[:2], *args[3:5])
            and not scan_vectorized(*moved[:2], *moved[3:5])):
        fail("mamba_scan copy widths: the inputs do not take both widths")
    x, dt, a, b, c, d = args
    (bz, s, dm), n = x.shape, a.shape[1]
    y4 = torch.empty_like(x)
    lib, stream = _lib(), stream_handle(x.device)

    def four_byte():
        err = lib.mamba_scan_launch(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                                    c.data_ptr(), d.data_ptr(), y4.data_ptr(), None, bz, s,
                                    dm, n, 0, stream)
        _build.check_launch(lib, "mamba_scan", err)

    runs = {"16-byte": lambda: mamba_scan(*args, **kw), "4-byte": four_byte,
            "4-byte, 4 bytes off": lambda: mamba_scan(*moved, **kw)}
    y16 = runs["16-byte"]()
    four_byte()
    if not (torch.equal(y16, y4) and torch.equal(y16, runs["4-byte, 4 bytes off"]())):
        fail("mamba_scan: y differs between the copy widths")
    out = {k: [] for k in runs}
    for _ in range(rounds):
        for key, fn in runs.items():
            out[key].append(timer.time_callable(fn).median_ns / 1e6)
    print("mamba_scan [Jamba] copies, ms a launch by round: "
          + "; ".join(f"{k} " + " ".join(f"{t:.6f}" for t in v) for k, v in out.items()))
    return out


def decode_group_sweep(timer, cases: dict) -> dict[int, float]:
    """A datum: K6 on DECODE_LONG's cache with g = 1, 2, 4 and 8 query
    heads a KV head, the same K and V bytes under g times the arithmetic,
    so how much of the time the FMAs take shows against g = 1."""
    from repro_torch.kernels.flash_decode import flash_decode

    _, (q, k, v, kv_len), _ = cases[DECODE_LONG]
    gen = torch.Generator(device=q.device).manual_seed(1)
    out = {}
    for g in (1, 2, 4, 8):
        qg = torch.randn(q.shape[0], k.shape[2] * g, q.shape[2], generator=gen,
                         device=q.device).to(q.dtype)
        out[g] = timer.time_callable(lambda: flash_decode(qg, k, v, kv_len)).median_ns / 1e6
    print(f"flash_decode g sweep [{DECODE_LONG}]: "
          + ", ".join(f"g {g} {ms:.6f} ms" for g, ms in out.items()))
    return out


def decode_passes(cases: dict, reps: int = 20) -> dict[str, dict[str, float]]:
    """A datum: the device time of K6's two passes (the split-KV pass and
    the combine) at its two timed cases, from torch.profiler's trace of
    ``reps`` calls, in us a call; "not measured" when the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_decode import flash_decode

    out = {}
    for label in (JAMBA_TIMED["flash_decode"], DECODE_LONG):
        args = cases[label][1]
        flash_decode(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flash_decode(*args)
            torch.cuda.synchronize()
        us = {}
        for e in prof.key_averages():
            for kernel in ("decode_split_kernel", "decode_combine_kernel"):
                if kernel in e.key:
                    us[kernel] = getattr(e, "device_time_total", 0) / reps
        out[label] = us
        print(f"flash_decode passes [{label}]: "
              + (", ".join(f"{k} {v:.3f} us" for k, v in us.items()) if any(us.values())
                 else "not measured (no device time in the trace)"))
    return out


def time_kernels(dev: torch.device, err: dict, *, big) -> list[dict]:
    """Phase 9: each kernel at the largest call the quick plan makes of it:
    the kernel's time on the card (CUDA events behind a lead, as the probes
    time), the plain version's wall time to completion (it may wait for the
    card inside, as the chase's host loop does), and the bound. K2's entry
    also holds its timed form's (``timed_form``), at the inkernel plan's
    call: the add row's (8, 128) tile at n 64. Their launches on the plans'
    runs are filled in afterwards (:func:`count_plan_launches`)."""
    from repro_torch.core.chains import KERNEL_CHAIN_UNROLL
    from repro_torch.core.membench import build_ring
    from repro_torch.core.timing import Timer
    from repro_torch.kernels.alu_chain import alu_chain_plain, alu_chain_timed
    from repro_torch.kernels.chase import chase, chase_plain, chase_timed
    from repro_torch import inkernel
    from repro_torch.core.chains import spec_by_name
    from repro_torch.kernels.opchain import op_chain, op_chain_plain, op_chain_timed

    x = torch.full((8, 128), 1.0, device=dev)
    tc, tops = inkernel.tiles(spec_by_name("add"), device=dev)
    a = torch.full((8, 128), 0.5, device=dev)
    c = torch.tensor(0xF0F0F0F0, dtype=torch.uint32, device=dev)
    p = torch.tensor(0xA5A5A5A5, dtype=torch.uint32, device=dev)
    ring, start = build_ring(1 << 21, device=dev)
    pos = start.clone()
    ring64, pos64 = big.args
    rows = [
        # name, source, replaces, kernel call, plain call, bytes, ops
        ("alu_chain", "src/repro_torch/csrc/alu_chain.cu",
         "src/repro/kernels/alu_chain.py:43",
         lambda: alu_chain_timed(x, a, n=64, op="fma"),
         lambda: alu_chain_plain(x, a, n=64, op="fma"),
         (3 * 4 + 8) * x.numel(), 2 * 64 * x.numel(),  # x, a, out; int64 cycles
         "fma, tile (8, 128), n=64, timed form"),
        ("op_chain", "src/repro_torch/csrc/op_chain.cu",
         "src/repro/kernels/opchain.py:39",
         lambda: op_chain(c, p, step="popc", n=512, unroll=KERNEL_CHAIN_UNROLL),
         lambda: op_chain_plain(c, p, step="popc", n=512),
         3 * 4, 2 * 512,
         f"popc, 0-dim uint32 carry, n=512, unroll={KERNEL_CHAIN_UNROLL}"),
        ("op_chain_timed", "src/repro_torch/csrc/op_chain_timed.cu",
         "src/repro/kernels/opchain.py:39",
         lambda: op_chain_timed(tc, *tops, step="add", n=64),
         lambda: op_chain_plain(tc, *tops, step="add", n=64),
         (4 * 4 + 8) * tc.numel(), 2 * 64 * tc.numel(),  # x, a, b, out; int64 cycles
         "add, tile (8, 128) int32, n=64, timed form"),
        ("chase", "src/repro_torch/csrc/chase.cu",
         "src/repro/kernels/chase.py:119",
         lambda: chase(ring, pos, steps=1536, memory_space="global", out=pos),
         lambda: chase_plain(ring, pos, steps=1536),
         # one 4-byte word per step, all on distinct lines (the 2 MiB ring has
         # 32768 live slots), plus start and the result
         1536 * 4 + 4 + 4, 0, "ring 2 MiB (32768 lines), steps=1536, global, start carried"),
        ("chase_timed", "src/repro_torch/csrc/chase.cu",
         "src/repro/kernels/chase.py:119",
         lambda: chase_timed(ring64, pos64, steps=192, memory_space="global", out=pos64),
         lambda: chase_plain(ring64, pos64, steps=192, timed=True),
         192 * 4 + 4 + 4 + 8, 0,  # + int64 cycles
         "ring 64 MiB (1048576 lines), steps=192, global, start carried, timed form"),
    ]
    out = []
    timer = Timer(warmup=3, reps=50, device=dev)
    for name, source, replaces, kernel, plain, nbytes, nops, shape in rows:
        ms = timer.time_callable(kernel).median_ns / 1e6
        plain_ms = wall_ms(plain)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_OPS_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        print(f"{name}: {ms:.6f} ms/launch on the card, plain {plain_ms:.6f} ms wall, bound "
              f"{bound_ms:.3g} ms ({bound_by}: {nbytes} B, {nops} ops) [{shape}]")
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "design": designs(name), "launches": None,
                    "max_abs_err": err.get(name), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    (timed,) = [k for k in out if k["name"] == "op_chain_timed"]
    out.remove(timed)  # K2's timed form goes inside K2's entry
    del timed["replaces"], timed["max_abs_err"]  # K2's, for both forms
    next(k for k in out if k["name"] == "op_chain")["timed_form"] = timed
    (timed,) = [k for k in out if k["name"] == "chase_timed"]
    out.remove(timed)  # and K3's inside K3's
    del timed["replaces"], timed["max_abs_err"]
    next(k for k in out if k["name"] == "chase")["timed_form"] = timed
    return out


def count_plan_launches(kernels: list[dict], *plan_launches: dict) -> None:
    """Fill K1-K3's launches (:func:`time_kernels`' entries, and their timed
    forms') with their sums over the plans' runs (quick's, table2's,
    inkernel's, the memory plans' and o1's); K3's also by form and path."""
    launches = {k: sum(p.get(k, 0) for p in plan_launches)
                for k in sorted(set().union(*plan_launches))}
    for k in kernels:
        if k["launches"] is not None:  # K4-K7: counted in the phases that ran them
            continue
        k["launches"] = launches[k["name"]]
        line = f"{k['name']}: {k['launches']} launches on the main path"
        if "timed_form" in k:
            timed = k["timed_form"]
            timed["launches"] = launches[timed["name"]]
            line += f"; {timed['name']}: {timed['launches']}"
        print(line)
    k3 = next(k for k in kernels if k["name"] == "chase")
    k3["launches_by_path"] = {k.removeprefix("chase/"): n for k, n in launches.items()
                              if k.startswith("chase/")}
    print(f"chase launches by form and path on the main path: {k3['launches_by_path']}")


def clock_study(dev: torch.device, trials: int = 20, reps: int = 5, *, rungs: dict) -> None:
    """How often a two-length slope comes out non-positive, min over ``reps``
    per length as core.timing's slope takes it, with three clocks: the host
    clock (perf_counter_ns around the call plus a synchronize), bare CUDA
    events around the call, and the port's clock (the events behind a lead,
    ``Timer.time_once``); and, for K1's fma chain, a fourth: the SM clock
    sandwich inside the kernel (median cycles over the tile's threads, as
    the quick plan's kernel.alu_chain.fma row takes it), which must have
    no non-positive slope; and the same for K2's timed add chain, as the
    inkernel plan's inkernel.add row (and its guard baseline) takes it."""
    from repro_torch import inkernel
    from repro_torch.core.chains import KERNEL_CHAIN_UNROLL, spec_by_name
    from repro_torch.core.timing import Timer, sm_clock_hz
    from repro_torch.kernels.alu_chain import alu_chain, alu_chain_timed
    from repro_torch.kernels.opchain import op_chain, op_chain_timed

    x = torch.full((8, 128), 1.0, device=dev)
    a = torch.full((8, 128), 0.5, device=dev)
    c = torch.tensor(0xF0F0F0F0, dtype=torch.uint32, device=dev)
    p = torch.tensor(0xA5A5A5A5, dtype=torch.uint32, device=dev)
    chains = {"kernel.alu_chain.fma (8, 64)": (lambda n: alu_chain(x, a, n=n), (8, 64)),
              f"op_chain.popc unroll {KERNEL_CHAIN_UNROLL} (64, 512)": (
                  lambda n: op_chain(c, p, step="popc", n=n, unroll=KERNEL_CHAIN_UNROLL),
                  (64, 512))}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    timer = Timer(device=dev)

    def host(fn):
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter_ns() - t0

    def bare_events(fn):
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e6

    for label, (fn, (n1, n2)) in chains.items():
        for clock, sample in (("host", host), ("events", bare_events),
                              ("events+lead", timer.time_once)):
            slopes = []
            for _ in range(trials):
                t1 = min(sample(lambda: fn(n1)) for _ in range(reps))
                t2 = min(sample(lambda: fn(n2)) for _ in range(reps))
                slopes.append((t2 - t1) / (n2 - n1))
            q1, med, q3 = np.percentile(slopes, (25, 50, 75))
            print(f"clock {clock:11s} {label}: {sum(s <= 0 for s in slopes)} of "
                  f"{trials} slopes non-positive; ns/step q1 {q1:.3f} "
                  f"median {med:.3f} q3 {q3:.3f}")

    hz = sm_clock_hz(dev)
    print(f"SM clock: {hz / 1e6:.1f} MHz (%clock64 against %globaltimer over 1 ms spins)")
    add = spec_by_name("add")
    carry, ops = inkernel.tiles(add, device=dev)
    sandwiches = {  # the rows the quick and inkernel plans time by the sandwich
        "kernel.alu_chain.fma": lambda n: alu_chain_timed(x, a, n=n)[1],
        "inkernel.add": lambda n: op_chain_timed(carry, *ops, step="add", n=n)[1]}
    n1, n2 = inkernel.INKERNEL_LENS
    for label, timed in sandwiches.items():
        cycles = lambda n: float(timed(n).median())  # noqa: E731
        cycles(n1), cycles(n2)  # warm
        slopes = []
        for _ in range(trials):
            c1 = min(cycles(n1) for _ in range(reps))
            c2 = min(cycles(n2) for _ in range(reps))
            slopes.append((c2 - c1) / (n2 - n1))
        q1, med, q3 = np.percentile(slopes, (25, 50, 75))
        bad = sum(c <= 0 for c in slopes)
        print(f"clock sm_clock64 {label} ({n1}, {n2}): {bad} of {trials} slopes "
              f"non-positive; cycles/step q1 {q1:.3f} median {med:.3f} q3 {q3:.3f}; "
              f"ns/step median {med / hz * 1e9:.3f}")
        if bad:
            fail(f"the SM clock sandwich gave {bad} of {trials} non-positive slopes for {label}")
    chase_sandwiches(hz, trials, reps, rungs)


def chase_sandwiches(hz: float, trials: int, reps: int, rungs: dict) -> None:
    """K3's clock sandwich at the memory-inkernel plan's lengths for each of
    ``rungs`` (label -> its prepared rung, as the plan runs it: a lap inside
    each launch, or a lapped ring whose start is carried): non-positive
    slopes in ``trials`` trials (must be 0), each trial's slope from the
    minimum over ``reps`` launches a length, as ``sandwich_slope`` takes
    it, beside the slope from their medians (the minimum favours a launch
    whose loads hit). Then the 64 MiB rung's loads as the plan times them
    against the same loads after 256 MiB of other data has gone through L2
    before each launch: what of the 64 MiB ring L2 still holds."""
    for label, prepared in rungs.items():
        n1, n2 = prepared.lens
        cycles = lambda n: float(prepared.fn_by_len(n)(*prepared.args)[0])  # noqa: E731
        cycles(n1), cycles(n2)  # warm
        by_min, by_median = [], []
        for _ in range(trials):
            c1 = [cycles(n1) for _ in range(reps)]
            c2 = [cycles(n2) for _ in range(reps)]
            by_min.append((min(c2) - min(c1)) / (n2 - n1))
            by_median.append((np.median(c2) - np.median(c1)) / (n2 - n1))
        bad = sum(c <= 0 for c in by_min)
        q1, med, q3 = np.percentile(by_min, (25, 50, 75))
        print(f"clock sm_clock64 {label} ({n1}, {n2}): {bad} of {trials} slopes non-positive; "
              f"cycles/load q1 {q1:.3f} median {med:.3f} q3 {q3:.3f} (from the medians: "
              f"{np.median(by_median):.3f}); ns/load median {med / hz * 1e9:.3f}")
        if bad:
            fail(f"the SM clock sandwich gave {bad} of {trials} non-positive slopes for {label}")
    big = rungs["inkernel.mem.67108864"]
    evict = torch.empty(256 << 20, dtype=torch.uint8, device=big.args[0].device)
    for flush in (False, True):
        per = {}
        for n in big.lens:
            xs = []
            for _ in range(30):
                if flush:
                    evict.add_(1)  # reads and writes 256 MiB through L2
                xs.append(float(big.fn_by_len(n)(*big.args)[0]))
            per[n] = np.array(xs)
        n1, n2 = big.lens
        slope_min = (per[n2].min() - per[n1].min()) / (n2 - n1)
        slope_med = (np.median(per[n2]) - np.median(per[n1])) / (n2 - n1)
        each = per[n2] / n2
        how = "256 MiB through L2 before each launch" if flush else "as the plan runs it"
        print(f"L2 residency, 64 MiB ring, {how}: "
              f"{slope_med:.1f} cycles a load from medians, {slope_min:.1f} from minima "
              f"({slope_med / hz * 1e9:.1f} / {slope_min / hz * 1e9:.1f} ns); a launch of "
              f"{n2}: {each.min():.1f} / {np.median(each):.1f} / {each.max():.1f} cycles a load "
              "(min / median / max of 30)")


def sass_checks(build: Path) -> dict[str, tuple[float, dict]]:
    """What each design promises, in the SASS of the built libraries (counts
    printed; a missing one fails): K5's bf16 instances run HGMMA (wgmma; or
    HMMA, mma.sync) fed by UTMALDG (TMA; or LDGSTS, cp.async); each of K6's
    32 split-KV instances copies K and V by 128-bit cp.async (LDGSTS with
    .128); each of K4's 16 vector instances (float32 E 4, bfloat16 E 8)
    loads by LDG.E.128 and stores by STG.E.128; K1's timed fma chain at
    n 64 reads the clock before the first of its 64 FFMAs and after the
    last, with no branch between the reads; K2's uint32 divides and
    high multiply show their divisor classes (:func:`k2_sass_checks`); and
    K2's timed form brackets each in-kernel row's chain with its clock
    reads (:func:`k2_timed_sass`, whose per-row result it returns)."""
    from repro_torch.audit import artifacts, dataflow

    def functions(lib: str) -> dict[str, list[str]]:  # read once a process
        return artifacts.library_sass(lib)

    def op(line: str) -> str:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        return m.group(1) if m else ""

    wgmma = {n: body for n, body in functions("flash_attention").items()
             if "flash_attention_wgmma_kernel" in n}
    if len(wgmma) != 4:
        fail(f"expected 4 bf16 wgmma instances of K5 in the SASS, found {len(wgmma)}")
    for name, body in wgmma.items():
        ops = [op(ln) for ln in body]
        counts = {o: ops.count(o) for o in ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")}
        if not ((counts["HGMMA"] or counts["HMMA"]) and (counts["UTMALDG"] or counts["LDGSTS"])):
            fail(f"K5 bf16 instance {name}: {counts} in its SASS")
        print(f"sass: K5 {name.split('wgmma_kernel')[-1][:12]}: "
              + ", ".join(f"{n} {o}" for o, n in counts.items()) + f", {len(body)} instructions")

    mnemonics = artifacts.sass_mnemonics

    tf32 = {n: body for n, body in functions("flash_attention").items()
            if "flash_attention_tf32_kernel" in n}
    if len(tf32) != 4:
        fail(f"expected 4 float32 3xTF32 instances of K5 in the SASS, found {len(tf32)}")
    for name, body in sorted(tf32.items()):
        ops = mnemonics(body)
        counts = {"HMMA.TF32": sum(o.startswith("HMMA") and "TF32" in o.split(".") for o in ops),
                  "LDGSTS": sum(o.startswith("LDGSTS") for o in ops)}
        if not (counts["HMMA.TF32"] and counts["LDGSTS"]):
            fail(f"K5 float32 instance {name}: {counts} in its SASS")
        inst = re.search(r"tf32_kernelILi(\d+)E", name).group(1)
        print(f"sass: K5 f32 D {inst}: " + ", ".join(f"{n} {o}" for o, n in counts.items())
              + f", {len(body)} instructions")
    scan = {n: b for n, b in functions("mamba_scan").items() if "mamba_scan_kernel" in n}
    if len(scan) != 6:
        fail(f"expected 6 instances of K7 (N 4, 8, 16 x 16- or 4-byte copies) in the SASS, "
             f"found {len(scan)}")
    for name, body in sorted(scan.items()):
        ops = mnemonics(body)
        counts = {"LDGSTS": sum(o.startswith("LDGSTS") for o in ops),
                  "MUFU.EX2": ops.count("MUFU.EX2")}
        if not (counts["LDGSTS"] and counts["MUFU.EX2"]):
            fail(f"K7 instance {name}: {counts} in its SASS")
        inst = re.search(r"mamba_scan_kernelI(.*?)EEv", name).group(1)
        print(f"sass: K7 {inst}: " + ", ".join(f"{n} {o}" for o, n in counts.items())
              + f", {len(body)} instructions")

    def wide(body: list[str], prefix: str) -> int:
        """Instructions of ``body`` whose mnemonic starts with ``prefix`` and
        has a .128 modifier (LDGSTS.E.BYPASS.LTC128B.128, LDG.E.128, ...)."""
        return sum(m.startswith(prefix) and "128" in m.split(".")[1:] for m in mnemonics(body))

    split = {n: b for n, b in functions("flash_decode").items() if "decode_split_kernelI" in n}
    if len(split) != 32:
        fail(f"expected 32 split-KV instances of K6 in the SASS, found {len(split)}")
    for name, body in sorted(split.items()):
        counts = {"LDGSTS.128": wide(body, "LDGSTS"), "LDG.E.128": wide(body, "LDG.E"),
                  "LDS.128": wide(body, "LDS")}
        if not counts["LDGSTS.128"]:
            fail(f"K6 split-KV instance {name}: no 128-bit cp.async in its SASS ({counts})")
        inst = re.search(r"decode_split_kernelI(.*?)EEv", name).group(1)
        print(f"sass: K6 {inst}: " + ", ".join(f"{n} {o}" for o, n in counts.items())
              + f", {len(body)} instructions")
    vector = {n: b for n, b in functions("rmsnorm").items()
              if re.search(r"rmsnorm_kernelI(fLi4E|13__nv_bfloat16Li8E)", n)}
    if len(vector) != 16:
        fail(f"expected 16 vector instances of K4 in the SASS, found {len(vector)}")
    for name, body in sorted(vector.items()):
        counts = {"LDG.E.128": wide(body, "LDG.E"), "STG.E.128": wide(body, "STG.E")}
        if not (counts["LDG.E.128"] and counts["STG.E.128"]):
            fail(f"K4 vector instance {name}: {counts} in its SASS")
        inst = re.search(r"rmsnorm_kernelI(.*?)EEv", name).group(1)
        print(f"sass: K4 {inst}: " + ", ".join(f"{n} {o}" for o, n in counts.items())
              + f", {len(body)} instructions")
    # K1's timed fma chain at n 8 and 64 (alu_chain_kernel<op 0, N, timed>):
    # between the clock reads one dependent path of n FFMAs, no branch
    v = dataflow.audit_alu_kernel("fma", "O3")
    if v.status != "audited":
        fail(f"K1 timed fma: {v}")
    (timed,) = [body for n, body in functions("alu_chain").items()
                if "alu_chain_kernelILi0ELi64ELb1E" in n]
    cert = dataflow.region_cert(timed)
    if cert.mnemonics["FFMA"] != 64 or cert.branches:
        fail(f"K1 timed fma n 64: {cert}")
    text = [ln.split(";")[0].split("*/")[-1].strip() for ln in timed]
    print(f"sass: K1 timed fma chain, n 64: clock reads at instructions {list(cert.reads)}, "
          f"{cert.mnemonics['FFMA']} FFMAs between, no branch ({v.detail}); each read and "
          "the instruction before it: "
          + "; ".join(f"{i}: {text[i - 1]} | {text[i]}" for i in cert.reads))
    k2_sass_checks(functions, mnemonics)
    k3_timed_sass(functions, mnemonics)
    return k2_timed_sass(functions, mnemonics)


# K2's table2 rows (the uint32 divides, high multiply, popc and clz) and
# what a step of each runs, from the SASS: (a step must run one of, a step
# must run none of, the instance must hold). A step's counts are the loop form's unroll-32 instance's less
# its unroll-1 instance's, over the 31 steps between, so the address
# arithmetic cancels. A mnemonic matches by prefix (IMAD.HI matches
# IMAD.HI.U32). A runtime divisor's reciprocal (MUFU.RCP) depends on the
# divisor alone and may be taken once, out of the loop.
K2_SASS = {
    "div.u.regular": ((), ("MUFU.RCP", "IMAD.HI", "IMAD.WIDE"), ()),  # a shift
    "div.u.irregular": (("IMAD.HI", "IMAD.WIDE"), ("MUFU.RCP",), ()),  # magic multiply
    "div.u.runtime": ((), (), ("MUFU.RCP",)),  # the divide sequence
    "rem.u": ((), (), ("MUFU.RCP",)),
    "mul64hi": (("IMAD.WIDE", "IMAD.HI"), (), ()),  # the high word
    "popc": ((), (), ()),  # and the other two table2 rows K2 runs
    "clz": ((), (), ()),
}


def k2_step_sass(functions, mnemonics) -> dict[str, tuple[dict, dict]]:
    """Each K2 step of ``K2_SASS``: (what one step of the loop form runs, as
    each mnemonic's count a step; each unroll instance's count of each
    mnemonic)."""
    from collections import Counter

    from repro_torch.audit.chain_check import k2_struct

    out = {}
    for step in K2_SASS:
        found = {int(re.search(r"Li(\d+)EEEv", n).group(1)): Counter(mnemonics(b))
                 for n, b in functions("op_chain").items()
                 if "op_chain_kernelI" in n and k2_struct(step) in n}
        if sorted(found) != [1, 32]:
            fail(f"expected K2's {step} at unroll 1 and 32 in the SASS, found {sorted(found)}")
        per = {m: (found[32][m] - found[1][m]) / 31 for m in found[32] | found[1]}
        out[step] = ({m: c for m, c in sorted(per.items(), key=lambda kv: -kv[1]) if c > 0},
                     found)
    return out


def k2_sass_checks(functions, mnemonics) -> None:
    """The divisor class of each of K2's uint32 rows, and mul64hi's high
    word, in the SASS: ``K2_SASS``; what one step runs is printed, and it
    holds each mnemonic the row's notes name (``opchain.STEP_SASS``, the
    table both forms share)."""
    from repro_torch.kernels.opchain import STEP_SASS
    for step, (per, found) in k2_step_sass(functions, mnemonics).items():
        one_of, none_of, holds = K2_SASS[step]
        has = lambda p: sum(c for m, c in per.items() if m.startswith(p))  # noqa: E731
        held = {p: [sum(c for m, c in found[u].items() if m.startswith(p)) for u in (1, 32)]
                for p in holds}
        print(f"sass: K2 {step}: a step runs {sum(per.values()):.2f} instructions: "
              + ", ".join(f"{m} {c:.2f}" for m, c in per.items())
              + "".join(f"; {p} in the unroll 1 / 32 instances: {n[0]} / {n[1]}"
                        for p, n in held.items()))
        if one_of and not any(has(p) for p in one_of):
            fail(f"K2 {step}: a step runs none of {one_of} ({per})")
        if any(has(p) for p in none_of):
            fail(f"K2 {step}: a step runs one of {none_of} ({per})")
        if any(0 in n for n in held.values()):
            fail(f"K2 {step}: an instance lacks one of {holds} ({held})")
        claimed = STEP_SASS[step].split("+")  # what the row's notes say a step runs
        if not all(has(m) >= 0.99 for m in claimed):
            fail(f"K2 {step}: a step does not run each of {claimed} (its notes): {per}")


def k2_timed_sass(functions, mnemonics) -> dict[str, tuple[float, dict]]:
    """K2's timed form for each of the 58 in-kernel rows, in the SASS of its
    straight-line instances at n 8 and 64, certified by
    ``audit.dataflow.audit_inkernel_op`` (serialization: the longest
    dependent path between the clock reads grows a step at a time, no loop
    between the reads, a step's branches as many at both lengths;
    signature: a step runs at least one instruction): every row ``audited``
    but those ptxas folds (under one instruction a step), which come back
    ``transformed``. Besides: nothing that grows with n lies before the
    first read, and each row's mnemonics named in ``opchain.STEP_SASS``
    are in a step. Returns each row's (instructions a step, their
    mnemonics)."""
    from repro_torch import inkernel
    from repro_torch.audit import dataflow
    from repro_torch.kernels.opchain import STEP_SASS, TIMED_LENS

    n1, n2 = TIMED_LENS
    out, folded = {}, []
    for spec in inkernel.supported_specs():
        certs = dataflow.timed_certs("op_chain_timed", dataflow.inkernel_op_pattern(spec.name),
                                     tuple(TIMED_LENS))
        if certs is None:
            fail(f"K2 timed {spec.name}: an instance at n {TIMED_LENS} is missing or its clock "
                 "reads are unpaired")
        per = dataflow.per_step(certs, TIMED_LENS)
        total = sum(per.values())
        verdict = dataflow.audit_inkernel_op(spec, "O3")
        (c1, c2) = certs
        if c2.reads[0] - c1.reads[0] >= max(total, 1.0):
            fail(f"K2 timed {spec.name}: {c2.reads[0]} instructions before the first clock read "
                 f"at n {n2}, {c1.reads[0]} at n {n1}: the chain is not between the reads")
        if verdict.status != ("audited" if total >= 1.0 else "transformed"):
            fail(f"K2 timed {spec.name}: {verdict}")
        print(f"sass: K2 timed {spec.name}: reads at {list(c1.reads)} / {list(c2.reads)} "
              f"(n {n1} / {n2}), branches between {c1.branches} / {c2.branches}; a step runs "
              f"{total:.2f} instructions: " + ", ".join(f"{m} {c:.2f}" for m, c in per.items())
              + f"; {verdict.status}{':' + verdict.cause if verdict.cause else ''}")
        claimed = STEP_SASS.get(spec.name)
        if claimed and not all(sum(c for m, c in per.items() if m.startswith(p)) >= 0.99
                               for p in claimed.split("+")):
            fail(f"K2 timed {spec.name}: a step does not run each of {claimed} (its notes)")
        if total < 1.0:
            folded.append(spec.name)
        out[spec.name] = (total, per)
    print(f"sass: K2 timed form: {len(out)} rows, the clock reads bracket each chain; "
          f"folded (under one instruction a step): {folded or 'none'}")
    return out


def k3_timed_sass(functions, mnemonics) -> None:
    """K3's timed form, each straight-line instance (smem and global, 64 and
    192 steps), certified by ``audit.dataflow.audit_inkernel_mem``: between
    the clock reads as many loads as steps, each from the path's space (LDS
    or LDG) and each taking its address from the one before, no branch.
    Besides: nothing that grows with the steps lies before the first read,
    and a step is one load and at most one address instruction."""
    from repro_torch.audit import dataflow

    for ws, space in ((64 << 10, "smem"), (64 << 20, "global")):
        verdict = dataflow.audit_inkernel_mem(ws, "O3")
        if verdict.status != "audited" or f"space={space}" not in verdict.detail:
            fail(f"K3 timed {space}: {verdict}")
        certs = dataflow.timed_certs("chase", rf"chase_kernelILb{int(space == 'smem')}ELb1ELi(\d+)E",
                                     (64, 192), dataflow.CHASE_LOADS[space])
        per = dataflow.per_step(certs, (64, 192))
        load = sum(c for m, c in per.items() if m.startswith(dataflow.CHASE_LOADS[space]))
        other = sum(c for m, c in per.items() if not m.startswith(dataflow.CHASE_LOADS[space]))
        print(f"sass: K3 timed {space}: reads at {list(certs[0].reads)} / {list(certs[1].reads)} "
              f"(n 64 / 192), no branch between; a step runs {sum(per.values()):.2f} "
              "instructions: " + ", ".join(f"{m} {c:.2f}" for m, c in per.items())
              + f"; {verdict.status}: {verdict.detail}")
        if certs[1].reads[0] - certs[0].reads[0] >= 1 or load != 1.0 or other > 1.0:
            fail(f"K3 timed {space}: a step runs {per} (first read at {certs[0].reads[0]} / "
                 f"{certs[1].reads[0]}); it should be one load and at most one address "
                 "instruction")


def spill_checks(build: Path) -> None:
    """ptxas must report 0 spill bytes for every instance of K5's float32
    design and of K7 (build.log keeps ptxas -v's lines)."""
    log = (build / "build.log").read_text()
    found = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                       r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    checked = {f: (int(st), int(ld)) for f, st, ld in found
               if "flash_attention_tf32_kernel" in f or "mamba_scan_kernel" in f}
    if len(checked) != 10:
        fail(f"ptxas: expected spill lines for 4 K5 float32 and 6 K7 instances, found "
             f"{len(checked)}")
    spilled = {f: v for f, v in checked.items() if any(v)}
    if spilled:
        fail(f"ptxas: spills (stores, loads) in {spilled}")
    print(f"ptxas: 0 spill bytes in each of the {len(checked)} K5 float32 and K7 instances")


def loop_study(dev: torch.device, lens: tuple[int, int] = (64, 512),
               reps: int = 30) -> None:
    """op_chain's loop on the card, for the steps the table2 plan's rows
    launch: each step's time per step (the slope at ``lens``, events behind
    the lead) with 1 step to an iteration of the kernel's loop, as the
    fori_loop runs, and with 32, as the O3 rows run.
    With s the step and L the loop's cost per iteration, the two are s + L
    and s + L/32, so L = (t1 - t32) * 32/31."""
    from repro_torch.core.chains import spec_by_name
    from repro_torch.core.timing import Timer
    from repro_torch.kernels.opchain import STEPS, UNROLLS, op_chain

    timer = Timer(warmup=3, reps=reps, device=dev)
    for step in list(STEPS)[:8]:  # the table2 plan's kernel rows and add
        spec = spec_by_name(step)
        carry, ops = spec.carry(dev), spec.operand_tensors(dev)
        per_step = {}
        for unroll in UNROLLS:
            m = timer.slope(lambda n, u=unroll: (
                lambda: op_chain(carry, *ops, step=step, n=n, unroll=u)), *lens)
            per_step[unroll] = m.median_ns
        lo, hi = min(UNROLLS), max(UNROLLS)
        loop_ns = (per_step[lo] - per_step[hi]) * hi / (hi - lo)
        print(f"loop op_chain.{step} {lens}: ns/step "
              + ", ".join(f"unroll {u} {t:.3f}" for u, t in per_step.items())
              + f"; loop {loop_ns:.3f} ns per iteration")


def run_plans(dev: torch.device, tmp: Path, cache_dir: Path, pool, tasks: list) -> dict:
    """Phases 1-12 and dataflow, cache, o1 and audit, with the compile pool
    open: the build and the kernels' checks, then the phases that need no
    compiled chain (fused, dataflow, serve, archs, memory, memory-inkernel)
    while the workers compile, then quick and table2 (each probe prepared
    as its chains land, timed once all of the plan's have; table2's after
    the pool), with phase o1 run in table2's wait, after its O1 chains
    compiled there; then phase cache's fresh processes, the first alone on
    the card, the second beside inkernel and the audit. Returns what the later phases need: each
    phase's launches by its name, the run's DB path (``db_path``), the
    fused plan's DB and the kernels' checks."""
    from repro_torch.core import measure
    from repro_torch.core.latency_db import LatencyDB
    from repro_torch.kernels import _build

    out = {}
    t0 = time.perf_counter()
    build = _build.build()
    print(f"library: {build} ({', '.join(f'lib{k}.so' for k in _build.KERNELS)})")
    for line in (build / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry function" in line:
            print(f"  ptxas: {line.strip()}")
        elif line.startswith("== "):  # a source and its nvcc's return code
            print(f"  nvcc: {line[3:]}")
    timed_sass = sass_checks(build)
    spill_checks(build)
    phase("build", t0)

    t0 = time.perf_counter()
    out["err"] = check_kernels(dev)
    out["cases"] = jamba_inputs(dev)
    out["fused_err"], out["jamba"] = check_fused_kernels(dev, out["cases"])
    phase("kernels", t0)

    # phase cache's two fresh processes import now, in the pool's wait, and
    # wait for their start signals (after table2)
    cache_job = start_cache(cache_dir, tmp)

    # the phases that need no compiled chain run while the workers compile:
    # the card is idle there, and after the pool only the plans' own work is
    # left. Their host-side times (prefill and decode ms) are taken beside
    # the workers; the kernels' times are not
    t0 = time.perf_counter()
    out["fused"], out["fused_db"] = run_fused(dev)
    phase("fused", t0)

    t0 = time.perf_counter()
    run_dataflow(dev, out["fused_db"])
    phase("dataflow", t0)

    t0 = time.perf_counter()
    out["serve"] = run_serve(dev)
    phase("serve", t0)

    t0 = time.perf_counter()
    out["archs"], out["archs_cases"] = run_archs(dev)
    phase("archs", t0)

    # the memory plans need K3 alone: on a DB of their own, merged into the
    # run's once table2 is done
    mem_db = str(tmp / "memory_db.json")
    t0 = time.perf_counter()
    out["memory"] = run_memory(dev, mem_db)
    phase("memory", t0)

    t0 = time.perf_counter()
    out["memory-inkernel"] = run_memory_inkernel(dev, mem_db)
    phase("memory-inkernel", t0)

    db_path = str(tmp / "db.json")  # table2 runs on quick's DB
    t0 = time.perf_counter()
    out["quick"] = run_quick(dev, db_path, cache_dir)
    phase("quick", t0)

    # phase o1 runs as this process's task in table2's wait, once its O1
    # chains have compiled there (quick's wait may have compiled some)
    o1 = {}
    first_lint = sum(t[0] is measure.prepare_o1_chain for t in pool.local)
    pool.local.insert(first_lint, (run_o1_in_wait, (dev, db_path, o1)))
    t0 = time.perf_counter()
    out["table2"] = run_table2(dev, db_path, pool, cache_dir)
    phase("table2", t0)
    while "launches" not in o1:  # table2's waits were too short for it
        if not any(fn is run_o1_in_wait for fn, _ in pool.local):
            fail("phase o1 did not run (its task failed: see the log)")
        pool.run_local()
    out["o1"] = o1["launches"]

    # phase cache, now that the pool has stopped: its first fresh process
    # times rows on the card, so this process only runs what the sessions'
    # waits left of its own tasks (CPU chains) until it is done; its second
    # (the audit, which times nothing) runs beside inkernel and phase audit.
    # Both imported in the pool's wait
    t_cache = time.perf_counter()
    cache_characterize(cache_job)
    LatencyDB(db_path).merge(LatencyDB(mem_db)).save()
    while pool.local:  # what the sessions' waits left of this process's tasks
        pool.run_local()
    cache_audit(cache_job)
    print(f"cache: this process waited {time.perf_counter() - t_cache:.2f} s for the "
          "warm characterize (its own leftover tasks run meanwhile)")

    t0 = time.perf_counter()
    out["inkernel"] = run_inkernel(dev, db_path, timed_sass)
    phase("inkernel", t0)

    t0 = time.perf_counter()
    verdicts = run_audit(dev, db_path, str(tmp / "attribution.md"))
    phase("audit", t0)

    t0 = time.perf_counter()
    finish_cache(dev, db_path, cache_job, pool, verdicts)
    phase("cache", t0)
    chains_o3 = {(fn.__module__, fn.__qualname__, *args) for fn, args in tasks}
    if set(pool.futures) != chains_o3 or pool.local:
        fail(f"compile pool: {len(pool.futures)} tasks against the {len(chains_o3)} O3 chains "
             f"of quick and table2; {len(pool.local)} local tasks never ran")
    print(f"compile pool: {len(pool.futures)} tasks, the O3 chains of quick and table2 "
          f"(none for O1 or the audit); this process's own tasks (the O1 chains, phase o1, "
          f"the lint's short chains) took {pool.local_s:.2f} s while the workers compiled")
    out["db_path"] = db_path
    return out


def reckoning(pool, t_wall: float, t_end: float) -> None:
    """F4's line: when the compile pool started and ended (its last chain
    done) in the run, its span and worker-seconds, and the tail: the
    script's end less the pool's end."""
    done = [f.result() for f in pool.futures.values()
            if f.done() and not f.cancelled() and f.exception() is None]
    first = min(r["started_at"] for r in done)
    end = max(r["done_at"] for r in done)
    busy = sum(r["done_at"] - r["started_at"] for r in done)
    span = end - pool.started_at
    print(f"compile pool: started {pool.started_at - t_wall:.1f} s into the run, first chain "
          f"at {first - t_wall:.1f} s, ended {end - t_wall:.1f} s; span {span:.1f} s, "
          f"{busy:.1f} worker-seconds ({pool.workers} workers), span / worker-seconds "
          f"{span / busy:.4f}; tail {t_end - end:.1f} s (the script's end less the pool's "
          f"end); start + tail {pool.started_at - t_wall + t_end - end:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from repro_torch import inkernel
    from repro_torch.api.plan import QUICK_OPS, named_plan
    from repro_torch.api.session import CompilePool, compile_workers_for, warm_tasks
    from repro_torch.audit import artifacts, chain_check, lint
    from repro_torch.core import chains, measure
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.latency_db import LatencyDB
    from repro_torch.kernels.common import resolve_device

    t_all, t_wall = time.perf_counter(), time.time()
    dev = resolve_device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(dev)}")

    # one compile pool for the script, started before the build, with the
    # run's compile cache: the O3 chains of quick, then those table2 adds,
    # in the order that lands the probes one after another (warm_tasks)
    quick, table2 = named_plan("quick"), named_plan("table2")
    probes = list(quick) + list(table2)
    workers = compile_workers_for(dev, len(warm_tasks(probes, dev)))
    tasks = warm_tasks(probes, dev, workers)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cache_dir = Path(tmp) / "compile_cache"
        cache = CompileCache(str(cache_dir))
        cache.use()
        with CompilePool(workers, runner=artifacts.warm_and_read, cache=cache) as pool:
            pool.submit(tasks)
            # the o1 phase's chains compile here while quick waits, and then
            # the short CPU chains of the audit's lowering lint, whose graphs
            # it reads (chain_check.o1_graph_ops keeps them)
            pool.local += [(measure.prepare_o1_chain, (name, n, str(dev)))
                           for name in QUICK_OPS for n in reversed(measure._CHAIN_LENS["O1"])]
            pool.local += [(chain_check.o1_graph_ops,
                            (spec, min(lint.LINT_LEN, spec.max_chain or lint.LINT_LEN)))
                           for spec in chains.default_registry()]
            results = run_plans(dev, Path(tmp), cache_dir, pool, tasks)
        run_db = LatencyDB(results.pop("db_path"))

    # priced from the rows the plans recorded, so after them, and timed
    # after the pool has stopped
    fused_db = results.pop("fused_db")
    t0 = time.perf_counter()
    serving_launches = run_serving(dev, run_db, fused_db)
    phase("serving", t0)

    t0 = time.perf_counter()
    slo_launches = run_slo(dev, run_db, fused_db)
    del run_db, fused_db
    phase("slo", t0)

    # timed after the pool has stopped, so that no compile worker shares the
    # host with the plain versions' launches; the plans' launches of K1-K3
    # are counted in after
    t0 = time.perf_counter()
    rungs = {"inkernel.mem.65536 (smem)": inkernel.prepare_chase(64 << 10, device=dev),
             "inkernel.mem.67108864": inkernel.prepare_chase(64 << 20, device=dev)}
    rungs["inkernel.mem.67108864"].lap()
    r = results
    kernels = time_kernels(dev, r["err"], big=rungs["inkernel.mem.67108864"])
    kernels += time_fused(dev, r["fused_err"], r["jamba"], r["cases"], r["fused"], r["serve"],
                          r["archs"], r["archs_cases"], serving_launches, slo_launches)
    clock_study(dev, rungs=rungs)
    loop_study(dev)
    del rungs, r["archs_cases"]
    phase("timing", t0)
    count_plan_launches(kernels, r["quick"], r["table2"], r["inkernel"], r["memory"],
                        r["memory-inkernel"], r["o1"])
    phase("total", t_all)
    reckoning(pool, t_wall, time.time())
    if MISSED:
        fail("; ".join(MISSED))

    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
