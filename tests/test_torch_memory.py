"""The memory slice on the CPU: K3's plain chase in both forms, its paths and
the level rule, ``MemoryChaseProbe``, ``Plan.memory`` and
``Plan.memory_inkernel``, the rest of ``core.membench`` and
``characterize --plan memory-inkernel``, held against the JAX package on the
same inputs.

The rings come from ``build_ring`` (numpy's seeded ``RandomState``, the same
bytes in both packages). The chase is an integer function, so the port's
plain chase is held bit for bit against ``repro.kernels.ref.ref_chase`` and
the JAX kernel's ``any`` path in interpret mode (its ``vmem`` path calls
``pl.load``, which the installed jax no longer has). K3 itself is held
against this plain version on the card (``test_torch_cuda.py``).
"""
import dataclasses
import functools
import re
import time

import numpy as np
import pytest
import torch

from repro.api import plan as jax_plan
from repro.api import probes as jax_probes
from repro.core import latency_db as jax_latency_db
from repro.core import membench as jax_membench
from repro.kernels import ref
from repro.kernels.chase import chase as jax_chase
from repro_torch import inkernel
from repro_torch.api import MemoryChaseProbe, MemoryProbe, Plan, Session, cli, named_plan
from repro_torch.api import plan as torch_plan
from repro_torch.core import membench
from repro_torch.core.latency_db import LatencyDB, LatencyRecord
from repro_torch.core.timing import Timer
from repro_torch.inkernel import measure as ik_measure
from repro_torch.kernels.chase import (MEMORY_SPACES, SMEM_BUDGET_BYTES, chase, chase_plain,
                                       chase_timed, select_memory_space)

CPU_ENV = dict(device_kind="cpu", backend="cpu", jax_version="torch-2.13.0+cpu")


@functools.cache
def _jax_ring(ws: int):
    return jax_membench.build_ring(ws)


@functools.cache
def _jax_any(ws: int, steps: int) -> int:
    ring, start = _jax_ring(ws)
    return int(jax_chase(ring, start, steps=steps, interpret=True, memory_space="any")[0])


# -------------------------------------------------------------- the chase
@pytest.mark.parametrize("form", ["chase", "chase_timed"])
@pytest.mark.parametrize("warmed", [False, True], ids=["warm0", "warm_lap"])
@pytest.mark.parametrize("steps", [64, 192, 37])
@pytest.mark.parametrize("ws", [4096, 1 << 16])
def test_plain_chase_matches_ref_and_pallas_any_path(ws, steps, warmed, form):
    """Both forms, with and without a warm lap: ``p`` after ``warm + steps``
    loads, bit for bit the oracle's and the JAX kernel's."""
    ring, start = membench.build_ring(ws, device="cpu")
    warm = ws // 64 if warmed else 0
    if form == "chase":
        got = chase(ring, start, steps=steps, warm=warm)
    else:
        got, cycles = chase_timed(ring, start, steps=steps, warm=warm)
        assert cycles is None  # no SM clock on the host
    assert got.dtype == torch.int32 and tuple(got.shape) == (1,)
    ring_j, _ = _jax_ring(ws)
    assert int(got[0]) == ref.ref_chase(np.asarray(ring_j), 0, warm + steps)
    assert int(got[0]) == _jax_any(ws, warm + steps)
    assert int(start[0]) == 0  # the start is left alone without out=


def test_carried_start_continues_where_the_last_call_stopped():
    ring, start = membench.build_ring(1 << 14, device="cpu")
    pos = start.clone()
    for form in (chase, lambda *a, **k: chase_timed(*a, **k)[0]):
        for _ in range(3):
            assert form(ring, pos, steps=37, out=pos) is pos
    want = chase_plain(ring, start, steps=6 * 37)
    assert torch.equal(pos, want)
    assert int(pos[0]) == ref.ref_chase(ring.numpy(), 0, 6 * 37)
    lap = ring.numel() // 16
    assert int(chase(ring, start, steps=lap)[0]) == 0  # a lap returns to the start
    assert chase_plain(ring, start, steps=5, timed=True)[1] is None


@pytest.mark.parametrize("space", [None, "smem", "global"])
def test_a_path_changes_no_result(space):
    ring, start = membench.build_ring(SMEM_BUDGET_BYTES, device="cpu")
    assert ring.numel() * 4 == SMEM_BUDGET_BYTES  # the largest smem ring
    got = chase(ring, start, steps=192, warm=7, memory_space=space)
    assert int(got[0]) == ref.ref_chase(ring.numpy(), 0, 199)


def test_select_memory_space_by_footprint():
    assert MEMORY_SPACES == ("smem", "global")
    assert SMEM_BUDGET_BYTES == 232448 == 227 * 1024
    assert select_memory_space(SMEM_BUDGET_BYTES) == "smem"
    assert select_memory_space(SMEM_BUDGET_BYTES + 64) == "global"  # one line above
    assert select_memory_space(64) == "smem"
    assert select_memory_space(8192, smem_budget=4096) == "global"
    assert select_memory_space(4096, smem_budget=4096) == "smem"


@pytest.mark.parametrize("form", [chase, chase_timed])
def test_forced_paths_and_bad_spaces(form):
    small, start = membench.build_ring(4096, device="cpu")
    big, big_start = membench.build_ring(SMEM_BUDGET_BYTES + 64, device="cpu")
    for space in MEMORY_SPACES:  # either path may be forced on a ring that fits
        form(small, start, steps=3, memory_space=space)
    form(big, big_start, steps=3, memory_space="global")
    with pytest.raises(ValueError, match="does not fit"):
        form(big, big_start, steps=3, memory_space="smem")
    for space in ("vmem", "any", "l2"):
        with pytest.raises(ValueError, match="memory_space must be one of"):
            form(small, start, steps=3, memory_space=space)
    with pytest.raises(ValueError, match=">= 0"):
        form(small, start, steps=3, warm=-1)
    with pytest.raises(ValueError, match="shape"):
        form(small, start, steps=3, out=torch.zeros(2, dtype=torch.int32))


# -------------------------------------------------------------- level rule
def test_level_rule_warms_l1_rings_and_carries_the_rest():
    assert membench.L1_BYTES == 256 * 1024
    assert membench.level_rule(4096) == (64, False)
    assert membench.level_rule(128 << 10) == (2048, False)
    assert membench.level_rule(membench.L1_BYTES - 64) == (4095, False)
    assert membench.level_rule(membench.L1_BYTES) == (0, True)
    assert membench.level_rule(64 << 20) == (0, True)
    assert membench.level_rule(8192, line_bytes=128) == (64, False)


def test_host_chase_carries_its_start_past_a_lap():
    """A ring above L1: the cold pass leaves the start alone, an untimed lap
    comes back to it, and every timed call continues from the last."""
    prepared = membench.prepare_chase(1 << 19, steps=(4, 8), device="cpu")
    assert (prepared.warm, prepared.carry) == (0, True)
    timer = Timer(warmup=1, reps=2, device="cpu")
    pt = membench.run_prepared_chase(prepared, timer)
    assert isinstance(pt, membench.MemPoint) and pt.cold_latency_ns > 0
    # 1 warmup + 2 reps of each length, after a lap (which ends where it began)
    want = ref.ref_chase(prepared.ring.numpy(), 0, 3 * 4 + 3 * 8)
    assert int(prepared.pos[0]) == want and int(prepared.start[0]) == 0


def test_inkernel_chase_follows_the_level_rule():
    small = inkernel.prepare_chase(1 << 16, device="cpu")
    assert (small.memory_space, small.warm, small.carry, small.lap) == ("smem", 1024, False,
                                                                       None)
    big = inkernel.prepare_chase(1 << 19, device="cpu", reps=2)
    assert (big.memory_space, big.warm, big.carry) == ("global", 0, True)
    ring, pos = big.args
    before = int(pos[0])
    big.lap()
    assert int(pos[0]) == before  # a whole lap
    big.fn_by_len(64)(ring, pos)
    assert int(pos[0]) == ref.ref_chase(ring.numpy(), before, 64)
    forced = inkernel.prepare_chase(1 << 12, memory_space="global", device="cpu")
    assert forced.memory_space == "global" and forced.lens == inkernel.CHASE_LENS


def test_cpu_chase_walks_the_warm_lap_before_timing_and_alternates_lengths(monkeypatch):
    """On the CPU the plain chase walks the level rule's warm lap once, when
    it is prepared, and the timed calls chase on from where it ended: the
    same p as a call that walks the lap itself; the two lengths' samples
    alternate."""
    small = inkernel.prepare_chase(1 << 16, device="cpu")
    ring, start = small.args
    walked = chase(ring, torch.zeros(1, dtype=torch.int32), steps=64, warm=small.warm)
    assert small.warm == 1024 and int(small.fn_by_len(64)(ring, start)[0]) == int(walked[0])
    order = []
    real = ik_measure.chase
    monkeypatch.setattr(ik_measure, "chase",
                        lambda *a, steps, **kw: order.append((steps, kw.get("warm", 0))) or
                        real(*a, steps=steps, **kw))
    again = inkernel.prepare_chase(1 << 16, device="cpu", reps=3)
    order.clear()
    inkernel.run_prepared_chase(again, Timer(warmup=1, reps=3, device="cpu"))
    assert order == [(64, 0), (192, 0)] * 4


def test_measure_chase_full_slope_exact_on_virtual_clock(monkeypatch):
    """A chase costing intercept + slope x (warm + steps) on a virtual host
    clock gives exactly the per-load slope (the warm lap cancels), and the
    path it ran."""
    import repro_torch.core.timing as timing

    now = [0]
    monkeypatch.setattr(timing.time, "perf_counter_ns", lambda: now[0])
    SLOPE, INTERCEPT = 900, 70_000

    def fake_chase(ring, start, *, steps, warm=0, memory_space=None, out=None):
        now[0] += INTERCEPT + SLOPE * (warm + steps)
        return start

    monkeypatch.setattr(ik_measure, "chase", fake_chase)
    for space, want in ((None, "smem"), ("global", "global")):
        m, got = inkernel.measure_chase_full(8192, lens=(16, 48), memory_space=space,
                                             timer=Timer(warmup=1, reps=3, device="cpu"))
        assert m.median_ns == pytest.approx(SLOPE) and m.mad_ns == 0.0
        assert got == want
    assert inkernel.CHASE_LENS == (64, 192)


# ------------------------------------------------------------ probes, plans
def test_memory_chase_probe_identity_matches_jax():
    for kw in ({}, {"lens": (8, 24)}, {"line_bytes": 128}, {"lens": (8, 24), "line_bytes": 128}):
        ours, theirs = MemoryChaseProbe(65536, **kw), jax_probes.MemoryChaseProbe(65536, **kw)
        assert ours.op == theirs.op and ours.match_names() == theirs.match_names()
        assert ours.logical_key() == theirs.logical_key()
        assert (ours.opt_level, ours.dtype, ours.category, ours.reps) == (
            "O3", "int32", "memory", 5) == (theirs.opt_level, theirs.dtype, theirs.category,
                                            theirs.reps)
    assert MemoryChaseProbe(65536).op == "inkernel.mem.65536"
    assert MemoryChaseProbe(65536, lens=(8, 24)).op == "inkernel.mem.65536.l8-24"
    assert MemoryChaseProbe(65536, line_bytes=128).op == "inkernel.mem.65536.line128"
    # a forced path carries the port's name where the JAX package's has its own
    for ours, theirs in (("smem", "vmem"), ("global", "any")):
        p, j = (MemoryChaseProbe(65536, memory_space=ours),
                jax_probes.MemoryChaseProbe(65536, memory_space=theirs))
        assert p.op == "inkernel.mem.65536." + ours == j.op.replace(theirs, ours)
        assert p.match_names() == {n.replace(theirs, ours) for n in j.match_names()}
    assert MemoryChaseProbe(8192).match_names() == {
        "inkernel.mem.8192", "mem.chase.ws8192", "mem"}


@pytest.mark.parametrize("name,count", [("memory", 14), ("memory-inkernel", 14)])
def test_named_memory_plans_match_jax_in_order(name, count):
    ours, theirs = named_plan(name), jax_plan.named_plan(name)
    assert [p.logical_key() for p in ours] == [p.logical_key() for p in theirs]
    assert [p.match_names() for p in ours] == [p.match_names() for p in theirs]
    assert len(ours) == count and ours.name == name
    assert name in torch_plan.PORTED_PLANS


def test_memory_inkernel_ladder_spans_both_paths():
    plan = Plan.memory_inkernel()
    rungs = [p.working_set_bytes for p in plan if isinstance(p, MemoryChaseProbe)]
    assert rungs == list(torch_plan.MEMORY_INKERNEL_LADDER)
    assert [select_memory_space(ws) for ws in rungs] == ["smem"] + ["global"] * 6
    hosts = [p for p in plan if isinstance(p, MemoryProbe)]
    assert [p.working_set_bytes for p in hosts] == rungs
    assert {p.steps for p in hosts} == {(2048, 6144)}
    # six host twins are rungs of the memory plan, so cache hits after it
    memory_ops = {p.op for p in named_plan("memory")}
    assert [p.op in memory_ops for p in hosts] == [True] * 6 + [False]
    solo = Plan.memory_inkernel(working_sets=(4096,), host_pair=False, lens=(8, 24))
    assert [p.op for p in solo] == ["inkernel.mem.4096.l8-24"]
    rung = named_plan("memory-inkernel").filter(ops=["mem.chase.ws65536"])
    assert {p.op for p in rung} == {"inkernel.mem.65536", "mem.chase.ws65536"}


# ------------------------------------------------------- records read back
def _session(tmp_path):
    return Session(db=str(tmp_path / "db.json"), device="cpu",
                   timer=Timer(warmup=1, reps=3, device="cpu"))


def test_cpu_rungs_state_the_level_rule_and_round_trip(tmp_path):
    plan = Plan((MemoryProbe(4096, steps=(64, 192)), MemoryProbe(1 << 19, steps=(64, 192)),
                 MemoryChaseProbe(1 << 16), MemoryChaseProbe(1 << 19)))
    result = _session(tmp_path).run(plan)
    assert not result.failed, [r.failure for r in result.failed]
    recs = {r.op: r for r in result.records()}
    fits, above = recs["mem.chase.ws4096.s64-192"], recs["mem.chase.ws524288.s64-192"]
    assert re.fullmatch(r"cold_ns=[\d.]+ stride=64 warm=64 carry=0 clock=host", fits.notes)
    assert re.fullmatch(r"cold_ns=[\d.]+ stride=64 warm=0 carry=1 clock=host", above.notes)
    for rec in (fits, above):
        ours, theirs = membench.mempoint_from_record(rec), jax_membench.mempoint_from_record(rec)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.latency_ns == rec.latency_ns and ours.stride_bytes == 64
    assert membench.mempoint_from_record(above).working_set_bytes == 1 << 19
    assert recs["inkernel.mem.65536"].notes == (
        "plain chase ws=65536 line=64 space=smem lens=64-192 warm=1024 carry=0 clock=host")
    assert recs["inkernel.mem.524288"].notes == (
        "plain chase ws=524288 line=64 space=global lens=64-192 warm=0 carry=1 clock=host")
    for op, space in (("inkernel.mem.65536", "smem"), ("inkernel.mem.524288", "global")):
        pt = membench.chasepoint_from_record(recs[op])
        assert pt == membench.ChasePoint(int(op.split(".")[-1]), recs[op].latency_ns, space, 64)
    again = _session(tmp_path).run(plan)
    assert again.summary().startswith("0 measured, 4 cached")


@pytest.mark.parametrize("theirs,ours", [("vmem", "smem"), ("any", "global")])
def test_chasepoint_reads_the_jax_packages_spaces(theirs, ours):
    rec = LatencyRecord(op="inkernel.mem.8192", category="memory", dtype="int32",
                        opt_level="O3", latency_ns=12.5, mad_ns=0.1, cycles=25.0, guard=0,
                        net_latency_ns=12.5, n_samples=5,
                        notes=f"pallas chase ws=8192 line=128 space={theirs} lens=64-192",
                        **CPU_ENV)
    assert membench.chasepoint_from_record(rec) == membench.ChasePoint(8192, 12.5, ours, 128)
    assert jax_membench.chasepoint_from_record(rec).memory_space == theirs


def _ladder(mp, pairs):
    return [mp(working_set_bytes=ws, latency_ns=ns, cold_latency_ns=2 * ns, stride_bytes=64)
            for ws, ns in pairs]


@pytest.mark.parametrize("jump", [1.6, 3.0])
@pytest.mark.parametrize("pairs", [
    [(4096, 20.0), (65536, 20.5), (131072, 21.0), (262144, 60.0), (524288, 150.0),
     (1 << 22, 152.0), (1 << 25, 240.0), (1 << 26, 520.0)],
    [(4096, 0.0), (8192, 10.0), (16384, 10.0)],
    [(4096, 5.0)],
], ids=["h100-like", "zero-first", "one-rung"])
def test_detect_levels_matches_jax(pairs, jump):
    ours = membench.detect_levels(_ladder(membench.MemPoint, pairs), jump=jump)
    theirs = jax_membench.detect_levels(_ladder(jax_membench.MemPoint, pairs), jump=jump)
    assert ours == theirs


def test_sweep_is_deprecated_and_returns_mempoints_on_cpu():
    with pytest.warns(DeprecationWarning, match="Plan.memory"):
        pts = membench.sweep((4096, 1 << 19), timer=Timer(warmup=1, reps=3, device="cpu"),
                             device="cpu")
    assert [p.working_set_bytes for p in pts] == [4096, 1 << 19]
    assert all(isinstance(p, membench.MemPoint) and p.stride_bytes == 64 for p in pts)


def test_bandwidth_probe_on_cpu():
    gbs = membench.bandwidth_probe(1 << 16, timer=Timer(warmup=1, reps=3, device="cpu"))
    assert np.isfinite(gbs) and gbs > 0


# ----------------------------------------------------------------- pairing
def test_compare_markdown_pairs_the_ladder_like_the_jax_package():
    """``inkernel.mem.<N>`` pairs with ``mem.chase.ws<N>``, rows in numeric
    order; a fidelity-suffixed rung does not pair; the table is the JAX
    package's, character for character."""
    ours, theirs = LatencyDB(), jax_latency_db.LatencyDB()
    rows = []
    for ws in (1 << 20, 4096, 65536):
        rows += [(f"inkernel.mem.{ws}", ws / 1e4), (f"mem.chase.ws{ws}", ws / 1e3)]
    rows += [("inkernel.mem.4096.l8-24", 3.0), ("mem.chase.ws8192", 9.0)]
    for op, ns in rows:
        raw = dict(op=op, category="memory", dtype="int32", opt_level="O3", latency_ns=ns,
                   mad_ns=ns / 10, cycles=2 * ns, guard=0, net_latency_ns=ns, n_samples=5,
                   **CPU_ENV)
        ours.add(LatencyRecord(**raw))
        theirs.add(jax_latency_db.LatencyRecord(**raw))
    table = ours.compare_markdown()
    assert table == theirs.compare_markdown()
    paired = [line.split(" | ")[1] for line in table.splitlines()[2:]]
    assert paired == ["mem.chase.ws4096", "mem.chase.ws65536", "mem.chase.ws1048576"]


# --------------------------------------------------------------------- CLI
def test_memory_inkernel_cli_on_cpu_prints_the_pairing(tmp_path, capsys):
    """``characterize --plan memory-inkernel --table`` on the CPU, cut to the
    64 KiB rung and its host twin: both measured on the plain chase, the
    pairing table printed, and a second run all cache hits."""
    db_path = tmp_path / "mem.json"
    args = ["characterize", "--plan", "memory-inkernel", "--db", str(db_path), "--device",
            "cpu", "--reps", "5", "--warmup", "1", "--ops",
            "inkernel.mem.65536,mem.chase.ws65536", "--table"]
    t0 = time.perf_counter()
    rc = cli.main(args)
    out = capsys.readouterr().out
    assert rc == 0, out
    rows = {r.op: r for r in LatencyDB(str(db_path)).records()}
    assert set(rows) == {"inkernel.mem.65536", "mem.chase.ws65536"}
    assert rows["inkernel.mem.65536"].notes.startswith(
        "plain chase ws=65536 line=64 space=smem lens=64-192 warm=1024 carry=0")
    assert "warm=1024 carry=0" in rows["mem.chase.ws65536"].notes
    assert "== host vs in-kernel (paper's in-pipeline method) ==" in out
    pairing = out.split("== host vs in-kernel")[1]
    assert "| memory | mem.chase.ws65536 | int32 |" in pairing
    assert time.perf_counter() - t0 < 60
    cli.main(args)
    assert "0 measured, 2 cached, 0 failed (2 probes)" in capsys.readouterr().out


def test_memory_plan_cli_on_cpu_records_its_rungs(tmp_path, capsys):
    db_path = tmp_path / "mem.json"
    rc = cli.main(["characterize", "--plan", "memory", "--db", str(db_path), "--device",
                   "cpu", "--reps", "3", "--warmup", "1", "--ops",
                   "mem.chase.ws4096,mem.chase.ws524288"])
    assert rc == 0, capsys.readouterr()
    recs = sorted(LatencyDB(str(db_path)).records(), key=lambda r: len(r.op))
    assert [r.op for r in recs] == ["mem.chase.ws4096", "mem.chase.ws524288"]
    assert ["carry=0" in recs[0].notes, "carry=1" in recs[1].notes] == [True, True]
