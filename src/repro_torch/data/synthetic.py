"""Deterministic synthetic LM data pipeline (the port of
``repro/data/synthetic.py``, numpy only, so the same streams bit for bit).

Per-host sharding discipline matches a real multi-host loader: every host
computes only its shard of the global batch from a (seed, step, host) triple,
so restarts resume mid-stream exactly (tested), and no two hosts overlap.
A background prefetch thread keeps ``depth`` batches in flight.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    structure: int = 97   # markov-ish period so loss is learnable, not pure noise


def philox_rng(seed: int, *counters: int) -> np.random.Generator:
    """Counter-based deterministic RNG: one stream per ``(seed, *counters)``.

    The sharding discipline of this module, exposed for reuse: a Philox
    generator keyed on ``seed`` with up to four counter words, so any
    consumer (the data loader's ``(step, host)`` streams, ``repro_torch.traffic``'s
    replayable arrival traces) derives independent, restart-exact streams
    from pure coordinates — no sequential state to checkpoint.
    """
    if len(counters) > 4:
        raise ValueError(f"Philox has a 4-word counter, got {len(counters)}")
    counter = np.zeros(4, np.uint64)
    counter[:len(counters)] = counters
    return np.random.Generator(np.random.Philox(key=seed, counter=counter))


def _host_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    assert cfg.global_batch % cfg.n_hosts == 0
    per_host = cfg.global_batch // cfg.n_hosts
    rng = philox_rng(cfg.seed, step, cfg.host_id)
    base = rng.integers(0, cfg.vocab_size, size=(per_host, cfg.seq_len + 1),
                        dtype=np.int64)
    # inject learnable structure: token[t] depends on token[t-1] mod `structure`
    ar = np.cumsum(base % cfg.structure, axis=1) % cfg.vocab_size
    tokens = ((base + ar) % cfg.vocab_size).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class SyntheticLoader:
    """Iterator of host-local batches with prefetch and exact resume."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        s = self.step
        while not self._stop.is_set():
            batch = _host_batch(self.cfg, s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        s, batch = self._q.get()
        self.step = s + 1
        return batch

    def close(self) -> None:
        self._stop.set()


def batch_for_step(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Pure function used by tests and the trainer's resume check."""
    return _host_batch(cfg, step)
