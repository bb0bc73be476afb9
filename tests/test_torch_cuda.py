"""The port on a CUDA card: each kernel against its plain PyTorch version on
the same inputs, the event clock, and a small plan end to end.

Every test here is marked ``cuda`` and skips where no card is visible. The
file imports neither jax nor the JAX package, so on a machine without jax it
runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: op_chain and chase bit-exact; alu_chain rtol 1e-5 (its fma step
rounds once in the kernel, twice in the plain version; its rsqrt and exp
steps differ by an ulp or two; every step contracts an error).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.api import Plan, Session
from repro_torch.api.cli import main as cli_main
from repro_torch.core import membench
from repro_torch.core.timing import Timer
from repro_torch.kernels import opchain
from repro_torch.kernels.alu_chain import OPS, alu_chain, alu_chain_plain
from repro_torch.kernels.chase import chase, chase_plain
from repro_torch.kernels.opchain import op_chain, op_chain_plain

pytestmark = pytest.mark.cuda
ALU_RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def _draw(rng, dtype, shape):
    np_dtype = np.int32 if dtype == torch.int32 else np.uint32
    return np.asarray(rng.randint(0, 2 ** 32, shape, dtype=np.uint64).astype(np_dtype))


@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("op", OPS)
def test_alu_chain_kernel_matches_plain(dev, op, n):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, (8, 128)).astype(np.float32)).to(dev)
    a = torch.from_numpy(rng.uniform(0.75, 1.25, (8, 128)).astype(np.float32)).to(dev)
    before = alu_chain.launches
    got = alu_chain(x, a, n=n, op=op)
    torch.cuda.synchronize()
    assert alu_chain.launches == before + 1
    torch.testing.assert_close(got.cpu(), alu_chain_plain(x.cpu(), a.cpu(), n=n, op=op),
                               rtol=ALU_RTOL, atol=0)


@pytest.mark.parametrize("shape", [(), (8, 128), (3, 1000)])
@pytest.mark.parametrize("step", list(opchain.STEPS))
def test_op_chain_kernel_bit_exact(dev, step, shape):
    dtype, n_ops, _ = opchain.STEPS[step]
    rng = np.random.RandomState(1)
    x, *ops = (torch.from_numpy(_draw(rng, dtype, shape)) for _ in range(1 + n_ops))
    before = op_chain.launches
    lens = (0, 1, 45, 64, 512)  # 45: 32 steps in the loop, 13 in the remainder
    for unroll in opchain.UNROLLS:
        for n in lens:
            got = op_chain(x.to(dev), *(o.to(dev) for o in ops), step=step, n=n,
                           unroll=unroll)
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(got.cpu(), op_chain_plain(x, *ops, step=step, n=n)), \
                (n, unroll)
    assert op_chain.launches == before + len(lens) * len(opchain.UNROLLS)


@pytest.mark.parametrize("ws", [1 << 13, 1 << 17, 1 << 21])
def test_chase_kernel_bit_exact(dev, ws):
    ring, start = membench.build_ring(ws, device=dev)
    for steps in (0, 1, 512, 1536):
        got = chase(ring, start, steps=steps)
        assert got.device == ring.device
        assert torch.equal(got.cpu(), chase_plain(ring.cpu(), start.cpu(), steps=steps))


def test_wrapper_refuses_mixed_devices(dev):
    x = torch.ones(8, 128, device=dev)
    with pytest.raises(ValueError, match="one device"):
        alu_chain(x, torch.ones(8, 128), n=1)


def test_event_clock_times_the_card(dev):
    timer = Timer(warmup=1, reps=5, device=dev)
    assert timer.clock == "events"
    ring, start = membench.build_ring(1 << 21, device=dev)
    short = timer.time_callable(lambda: chase(ring, start, steps=64))
    long = timer.time_callable(lambda: chase(ring, start, steps=4096))
    assert 0 < short.min_ns < long.min_ns


def test_session_runs_kernel_and_memory_probes_on_card(dev, tmp_path):
    plan = (Plan.memory((1 << 13,), steps=(512, 1536)) + Plan.kernels(("fma",))
            + Plan.instructions(ops=("popc",), opt_levels=("O0", "O3")))
    session = Session(db=str(tmp_path / "db.json"), device=dev,
                      timer=Timer(warmup=1, reps=5, device=dev))
    result = session.run(plan)
    assert not result.failed, [r.failure for r in result.failed]
    for rec in result.records():
        assert rec.backend == "cuda" and "clock=events" in rec.notes
        assert rec.jax_version.startswith("torch-") and "+cu" in rec.jax_version
    assert session.run(plan).summary().startswith("0 measured, 4 cached")


def test_cli_defaults_to_the_card(dev, tmp_path, capsys):
    db = tmp_path / "db.json"
    rc = cli_main(["characterize", "--db", str(db), "--ops", "clock_overhead,fma",
                   "--reps", "3"])
    assert rc == 0, capsys.readouterr()
    blob = json.loads(db.read_text())
    assert {r["backend"] for r in blob["records"]} == {"cuda"}
