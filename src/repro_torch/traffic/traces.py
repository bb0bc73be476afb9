"""Seeded, replayable arrival traces for the serving simulator (the port of
``repro/traffic/traces.py``: numpy only, so a config gives the reference's
trace to the last float and token, and a trace file either package wrote
loads in the other).

A trace is the workload half of an SLO point: *when* requests arrive and
*what* they ask for. Everything is derived from a :class:`TraceConfig`
through the counter-based Philox discipline of ``data/synthetic.py``
(:func:`repro_torch.data.synthetic.philox_rng`), so the same config replays the
identical request stream on any host — which is what lets the predicted
timeline (``traffic.simulate``) and the measured one (``traffic.scheduler``
driving the real engine) consume *the same* trace, and what makes the CI
determinism check meaningful.

Two arrival processes:

* ``poisson`` — exponential inter-arrivals at ``rate_rps`` (CV = 1), the
  open-loop "millions of independent users" model;
* ``gamma`` — Gamma inter-arrivals with coefficient of variation
  ``burstiness_cv`` at the same mean rate. ``cv > 1`` clusters arrivals into
  bursts (shape ``1/cv²`` < 1), the tail-latency stressor; ``cv < 1``
  smooths them toward a paced load generator.

Traces serialize to JSON (``save_trace`` / ``load_trace``) for the
``python -m repro_torch serve-slo --trace`` replay path.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

from repro_torch.data.synthetic import philox_rng
from repro_torch.utils import dump_json


@dataclasses.dataclass(frozen=True)
class Request:
    """One replayable request record of a trace."""

    uid: int
    arrival_ns: float
    prompt: tuple[int, ...]
    max_new: int

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Deterministic recipe for one arrival trace (the trace IS this config).

    ``prompt_len`` / ``max_new`` are inclusive ``(lo, hi)`` ranges sampled
    uniformly; keep the prompt range narrow where compile time matters (every
    distinct prompt length is one prefill compilation).
    """

    n_requests: int
    rate_rps: float
    seed: int = 0
    process: str = "poisson"          # "poisson" | "gamma"
    burstiness_cv: float = 1.0        # gamma only: CV of inter-arrivals
    prompt_len: tuple[int, int] = (4, 8)
    max_new: tuple[int, int] = (4, 8)
    vocab_size: int = 128

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.process not in ("poisson", "gamma"):
            raise ValueError(f"process must be poisson|gamma, got {self.process!r}")
        if self.burstiness_cv <= 0:
            raise ValueError(f"burstiness_cv must be > 0, got {self.burstiness_cv}")
        for name in ("prompt_len", "max_new"):
            lo, hi = getattr(self, name)
            if not 1 <= lo <= hi:
                raise ValueError(f"{name} range must satisfy 1 <= lo <= hi, "
                                 f"got ({lo}, {hi})")


def generate_trace(cfg: TraceConfig) -> list[Request]:
    """The trace for ``cfg``: same config -> identical request list, always."""
    rng = philox_rng(cfg.seed, 0)
    mean_gap_s = 1.0 / cfg.rate_rps
    if cfg.process == "poisson":
        gaps = rng.exponential(mean_gap_s, size=cfg.n_requests)
    else:
        # Gamma with mean = mean_gap_s and CV = burstiness_cv:
        # shape k = 1/cv^2, scale = mean/k. cv=1 degenerates to exponential.
        k = 1.0 / (cfg.burstiness_cv ** 2)
        gaps = rng.gamma(k, mean_gap_s / k, size=cfg.n_requests)
    arrivals_ns = np.cumsum(gaps) * 1e9
    plo, phi = cfg.prompt_len
    nlo, nhi = cfg.max_new
    plens = rng.integers(plo, phi + 1, size=cfg.n_requests)
    max_news = rng.integers(nlo, nhi + 1, size=cfg.n_requests)
    out: list[Request] = []
    for i in range(cfg.n_requests):
        # token ids start at 1: 0 is the engines' pad token
        prompt = rng.integers(1, max(cfg.vocab_size, 2), size=int(plens[i]))
        out.append(Request(uid=i, arrival_ns=float(arrivals_ns[i]),
                           prompt=tuple(int(t) for t in prompt),
                           max_new=int(max_news[i])))
    return out


# -------------------------------------------------------------- persistence
def save_trace(path: str, trace: Sequence[Request],
               cfg: TraceConfig | None = None) -> str:
    """Write a trace (and optionally its generating config) as JSON."""
    payload = {
        "requests": [dataclasses.asdict(r) for r in trace],
        "config": dataclasses.asdict(cfg) if cfg is not None else None,
    }
    dump_json(payload, path)
    return path


def load_trace(path: str) -> list[Request]:
    """Load a trace written by :func:`save_trace` (arrival-sorted)."""
    with open(path) as f:
        payload = json.load(f)
    reqs = [Request(uid=int(r["uid"]), arrival_ns=float(r["arrival_ns"]),
                    prompt=tuple(int(t) for t in r["prompt"]),
                    max_new=int(r["max_new"]))
            for r in payload["requests"]]
    return sorted(reqs, key=lambda r: (r.arrival_ns, r.uid))
