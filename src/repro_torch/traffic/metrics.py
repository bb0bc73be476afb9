"""Serving SLO metrics: TTFT / TPOT / e2e percentiles + goodput (the port of
``repro/traffic/metrics.py``).

Turns a :class:`~repro_torch.traffic.scheduler.ScheduleResult` into the numbers a
serving SLO is written against, with the standard definitions:

* **TTFT** — time to first token, ``first_token_ns - arrival_ns``. Includes
  queueing delay (a request that waits for a slot has a large TTFT even if
  its prefill is fast); that is deliberate — it is the user-visible number.
* **TPOT** — time per output token after the first,
  ``(finish - first_token) / (n_tokens - 1)``; ``nan`` for single-token
  requests (no inter-token gap exists) and excluded from aggregation.
* **e2e** — ``finish_ns - arrival_ns``.
* **goodput** — completed output tokens per second of makespan: the
  throughput the pool actually sustained for this trace.

Aggregation uses :func:`repro_torch.utils.percentiles` (exact-rank), so every
reported p50/p90/p99 is an actual request's latency, never an interpolated
midpoint — at the n~10 of a smoke trace that distinction matters.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.traffic.scheduler import RequestResult, ScheduleResult
from repro_torch.utils import percentiles

PCTS = (50.0, 90.0, 99.0)


@dataclasses.dataclass(frozen=True)
class RequestMetrics:
    """SLO view of one finished request (ns, virtual clock)."""

    uid: int
    ttft_ns: float
    tpot_ns: float                    # nan when n_tokens == 1
    e2e_ns: float
    n_tokens: int
    queue_ns: float                   # admission wait: admitted - arrival


def request_metrics(rr: RequestResult) -> RequestMetrics:
    req = rr.request
    ttft = rr.first_token_ns - req.arrival_ns
    tpot = ((rr.finish_ns - rr.first_token_ns) / (rr.n_tokens - 1)
            if rr.n_tokens > 1 else math.nan)
    return RequestMetrics(uid=req.uid, ttft_ns=ttft, tpot_ns=tpot,
                          e2e_ns=rr.finish_ns - req.arrival_ns,
                          n_tokens=rr.n_tokens,
                          queue_ns=rr.admitted_ns - req.arrival_ns)


@dataclasses.dataclass(frozen=True)
class SloSummary:
    """Percentile aggregation of one scheduler run at one arrival rate."""

    n_requests: int
    n_tokens: int
    makespan_ns: float
    goodput_tok_s: float
    ttft_ns: dict[float, float]       # percentile -> ns
    tpot_ns: dict[float, float]
    e2e_ns: dict[float, float]

    def as_record(self) -> dict:
        """Flat JSON-friendly dict (``ttft_p50_ns`` style keys)."""
        out = {"n_requests": self.n_requests, "n_tokens": self.n_tokens,
               "makespan_ns": self.makespan_ns,
               "goodput_tok_s": self.goodput_tok_s}
        for name, d in (("ttft", self.ttft_ns), ("tpot", self.tpot_ns),
                        ("e2e", self.e2e_ns)):
            for p, v in d.items():
                out[f"{name}_p{p:g}_ns"] = v
        return out


def summarize(result: ScheduleResult, pcts=PCTS) -> SloSummary:
    """Aggregate a finished run into exact-rank percentile SLOs."""
    if not result.requests:
        raise ValueError("cannot summarize an empty schedule result")
    ms = [request_metrics(rr) for rr in result.requests]
    n_tokens = sum(m.n_tokens for m in ms)
    tpots = [m.tpot_ns for m in ms if not math.isnan(m.tpot_ns)]
    return SloSummary(
        n_requests=len(ms),
        n_tokens=n_tokens,
        makespan_ns=result.makespan_ns,
        goodput_tok_s=n_tokens / (result.makespan_ns * 1e-9),
        ttft_ns=percentiles([m.ttft_ns for m in ms], pcts),
        tpot_ns=percentiles(tpots, pcts) if tpots
        else {float(p): math.nan for p in pcts},
        e2e_ns=percentiles([m.e2e_ns for m in ms], pcts),
    )


# ---------------------------------------------------------------- rendering
def _ms(ns: float) -> str:
    return "nan" if math.isnan(ns) else f"{ns / 1e6:.3f}"


def slo_table(rows: list[dict]) -> str:
    """Markdown throughput-vs-latency table, one row per arrival rate.

    Each row dict carries ``rate_rps`` plus ``predicted``/``measured``
    :class:`SloSummary` objects (either may be ``None`` when that side was
    not run). All latencies in ms.
    """
    hdr = ("| rate (req/s) | side | TTFT p50 | TTFT p99 | TPOT p50 "
           "| TPOT p99 | e2e p50 | goodput (tok/s) |")
    sep = "|---" * 8 + "|"
    lines = [hdr, sep]
    for row in rows:
        for side in ("predicted", "measured"):
            s = row.get(side)
            if s is None:
                continue
            lines.append(
                f"| {row['rate_rps']:g} | {side} | {_ms(s.ttft_ns[50.0])} "
                f"| {_ms(s.ttft_ns[99.0])} | {_ms(s.tpot_ns[50.0])} "
                f"| {_ms(s.tpot_ns[99.0])} | {_ms(s.e2e_ns[50.0])} "
                f"| {s.goodput_tok_s:.1f} |")
    return "\n".join(lines)
