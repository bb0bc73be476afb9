"""Port parity for the kernel modules: each wrapper's plain version (what it
runs for CPU tensors) against the JAX package's Pallas kernel in interpret
mode and its jnp oracle, on the same numpy inputs. The kernels themselves
are held against these plain versions on the card in test_torch_cuda.py.

Tolerances: the integer chains (op_chain, chase) are bit-exact; alu_chain is
held to rtol 1e-5 — its fma and rsqrt steps round differently across
implementations by an ulp or two a step, and every step contracts an error
(|d step/dx| < 1 for the inputs below), so it never grows past that.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import chains as jax_chains
from repro.core import membench as jax_membench
from repro.kernels import ref
from repro.kernels.alu_chain import alu_chain as jax_alu_chain
from repro.kernels.chase import chase as jax_chase
from repro.kernels.opchain import op_chain as jax_op_chain
from repro_torch.core import membench
from repro_torch.kernels import opchain
from repro_torch.kernels.alu_chain import OPS, alu_chain
from repro_torch.kernels.chase import chase
from repro_torch.kernels.opchain import op_chain
from repro_torch.utils import from_numpy

ALU_RTOL = 1e-5


def _alu_inputs(shape=(8, 128), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.5, 1.5, shape).astype(np.float32),
            rng.uniform(0.75, 1.25, shape).astype(np.float32))


def _op_inputs(step, shape=(8, 128), seed=1):
    dtype = np.int32 if step == "add" else np.uint32
    n_ops = opchain.STEPS[step][1]
    rng = np.random.RandomState(seed)
    draw = lambda: rng.randint(0, 2 ** 32, shape, dtype=np.uint64).astype(dtype)  # noqa: E731
    return draw(), tuple(draw() for _ in range(n_ops))


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("op", OPS)
def test_alu_chain_plain_matches_pallas_interpret(op, n):
    x, a = _alu_inputs()
    want = np.asarray(jax_alu_chain(jnp.asarray(x), jnp.asarray(a), n=n, op=op,
                                    interpret=True))
    got = alu_chain(*from_numpy((x, a), "cpu"), n=n, op=op)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=ALU_RTOL, atol=0)


def test_alu_chain_fma_matches_ref_oracle():
    x, a = _alu_inputs(seed=2)
    want = np.asarray(ref.ref_alu_chain(jnp.asarray(x), jnp.asarray(a), 64))
    got = alu_chain(*from_numpy((x, a), "cpu"), n=64, op="fma")
    np.testing.assert_allclose(got.numpy(), want, rtol=ALU_RTOL, atol=0)


def test_alu_chain_rejects_bad_inputs():
    x, a = from_numpy(_alu_inputs(), "cpu")
    with pytest.raises(ValueError, match="op must be one of"):
        alu_chain(x, a, n=4, op="div")
    with pytest.raises(TypeError, match="float32"):
        alu_chain(x.double(), a.double(), n=4)
    with pytest.raises(ValueError, match="shape"):
        alu_chain(x, a[:4], n=4)
    with pytest.raises(ValueError, match="contiguous"):
        alu_chain(x.t(), a.t(), n=4)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("n", [1, 7, 64, 256])
@pytest.mark.parametrize("step", ["popc", "clz", "add"])
def test_op_chain_bit_exact_vs_pallas_and_chain_fn(step, n):
    spec = next(s for s in jax_chains.default_registry() if s.name == step)
    x, ops = _op_inputs(step)
    want = np.asarray(jax_op_chain(jnp.asarray(x), *map(jnp.asarray, ops),
                                   step=spec.step, n=n, interpret=True))
    want_chain = np.asarray(jax_chains.chain_fn(spec, n)(
        jnp.asarray(x), *map(jnp.asarray, ops)))
    got = op_chain(*from_numpy((x, *ops), "cpu"), step=step, n=n)
    assert got.dtype == opchain.STEPS[step][0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_chain)


@pytest.mark.parametrize("step", ["popc", "clz"])
def test_op_chain_scalar_carry_like_the_registry(step):
    """The quick plan's rows run 0-dim carries; edge values included."""
    spec = next(s for s in jax_chains.default_registry() if s.name == step)
    for init in (0, 1, 0x80000000, 0xFFFFFFFF, spec.init):
        x = np.asarray(init, np.uint32)
        a = np.asarray(spec.operands[0], np.uint32)
        want = np.asarray(jax_chains.chain_fn(spec, 33)(jnp.asarray(x), jnp.asarray(a)))
        got = op_chain(*from_numpy((x, a), "cpu"), step=step, n=33)
        assert got.shape == () and int(got) == int(want), init


def test_op_chain_rejects_bad_inputs():
    x, (a,) = from_numpy(_op_inputs("popc"), "cpu")
    with pytest.raises(ValueError, match="step must be one of"):
        op_chain(x, a, step="mul128hi", n=1)
    with pytest.raises(ValueError, match="operand"):
        op_chain(x, a, a, step="popc", n=1)
    with pytest.raises(TypeError, match="uint32"):
        op_chain(x.to(torch.int32), a.to(torch.int32), step="popc", n=1)
    with pytest.raises(ValueError, match="unroll must be one of"):
        op_chain(x, a, step="popc", n=1, unroll=4)


@pytest.mark.parametrize("unroll", opchain.UNROLLS)
def test_op_chain_unroll_keeps_the_chain(unroll):
    """The steps to an iteration of the kernel's loop change no result:
    the O3 rows' 32-step body (with a remainder at n=45) against JAX."""
    spec = next(s for s in jax_chains.default_registry() if s.name == "popc")
    x, ops = _op_inputs("popc")
    want = np.asarray(jax_chains.chain_fn(spec, 45)(jnp.asarray(x), *map(jnp.asarray, ops)))
    got = op_chain(*from_numpy((x, *ops), "cpu"), step="popc", n=45, unroll=unroll)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ K3
@pytest.mark.parametrize("ws,steps", [(4096, 64), (8192, 301), (65536, 1536)])
def test_chase_matches_ref_and_pallas_any_path(ws, steps):
    ring_j, start_j = jax_membench.build_ring(ws)
    ring, start = membench.build_ring(ws, device="cpu")
    np.testing.assert_array_equal(ring.numpy(), np.asarray(ring_j))
    got = chase(ring, start, steps=steps)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1,)
    assert int(got[0]) == ref.ref_chase(np.asarray(ring_j), 0, steps)
    # the VMEM path is broken under this jax (R1 in ROADMAP); "any" runs
    want = jax_chase(ring_j, start_j, steps=steps, interpret=True, memory_space="any")
    assert int(got[0]) == int(want[0])


def test_chase_rejects_bad_inputs():
    ring, start = membench.build_ring(4096, device="cpu")
    with pytest.raises(TypeError, match="int32"):
        chase(ring.long(), start, steps=4)
    with pytest.raises(ValueError, match="shape"):
        chase(ring, start.reshape(()), steps=4)
    with pytest.raises(ValueError, match="1-D"):
        chase(ring.reshape(2, -1), start, steps=4)
