"""``repro_torch.data`` against the JAX package's ``repro.data``: the same
Philox streams and the same synthetic batches, bit for bit, on the CPU
(both are numpy; the port keeps its own copy)."""
import dataclasses

import numpy as np
import pytest

from repro.data import synthetic as jax_synthetic
from repro_torch.data import DataConfig, SyntheticLoader, batch_for_step
from repro_torch.data import synthetic


@pytest.mark.parametrize("seed,counters", [(0, ()), (0, (0,)), (7, (3, 1)), (12345, (1, 2, 3, 4)),
                                           (2**40, (2**33, 5))])
def test_philox_streams_are_the_jax_packages(seed, counters):
    ours, theirs = synthetic.philox_rng(seed, *counters), jax_synthetic.philox_rng(seed, *counters)
    np.testing.assert_array_equal(ours.integers(0, 2**31, 64), theirs.integers(0, 2**31, 64))
    np.testing.assert_array_equal(ours.random(32), theirs.random(32))
    np.testing.assert_array_equal(ours.exponential(0.5, 16), theirs.exponential(0.5, 16))
    np.testing.assert_array_equal(ours.gamma(0.25, 2.0, 16), theirs.gamma(0.25, 2.0, 16))


def test_philox_refuses_five_counter_words():
    with pytest.raises(ValueError, match="4-word counter"):
        synthetic.philox_rng(0, 1, 2, 3, 4, 5)


CONFIGS = [dict(vocab_size=128, seq_len=16, global_batch=4),
           dict(vocab_size=50_000, seq_len=33, global_batch=6, seed=9, n_hosts=3, host_id=2),
           dict(vocab_size=7, seq_len=5, global_batch=2, structure=3)]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("step", [0, 1, 1000])
def test_batch_for_step_is_the_jax_packages(kw, step):
    ours = batch_for_step(DataConfig(**kw), step)
    theirs = jax_synthetic.batch_for_step(jax_synthetic.DataConfig(**kw), step)
    assert set(ours) == set(theirs) == {"tokens", "labels"}
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], theirs[k])
    per_host = kw["global_batch"] // kw.get("n_hosts", 1)
    assert ours["tokens"].shape == (per_host, kw["seq_len"])
    np.testing.assert_array_equal(ours["tokens"][:, 1:], ours["labels"][:, :-1])


def test_config_fields_are_the_jax_packages():
    ours = [(f.name, f.default) for f in dataclasses.fields(DataConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jax_synthetic.DataConfig)]
    assert ours == theirs


def test_hosts_shard_without_overlap():
    base = dict(vocab_size=1000, seq_len=8, global_batch=4, seed=3, n_hosts=2)
    a = batch_for_step(DataConfig(**base, host_id=0), 5)["tokens"]
    b = batch_for_step(DataConfig(**base, host_id=1), 5)["tokens"]
    assert not np.array_equal(a, b)


def test_loader_streams_the_jax_batches_and_resumes():
    cfg = DataConfig(vocab_size=300, seq_len=12, global_batch=2, seed=4)
    jcfg = jax_synthetic.DataConfig(vocab_size=300, seq_len=12, global_batch=2, seed=4)
    loader = SyntheticLoader(cfg)
    try:
        got = [next(loader) for _ in range(3)]
    finally:
        loader.close()
    assert loader.step == 3
    for s, batch in enumerate(got):
        np.testing.assert_array_equal(batch["tokens"],
                                      jax_synthetic.batch_for_step(jcfg, s)["tokens"])
    resumed = SyntheticLoader(cfg, start_step=2)
    try:
        np.testing.assert_array_equal(next(resumed)["labels"], got[2]["labels"])
    finally:
        resumed.close()
