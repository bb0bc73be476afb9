"""The paper's timing model, for PyTorch on a CUDA card (or the CPU).

The paper samples the SM's ``%clock`` around one PTX instruction and
subtracts a calibrated clock overhead. This module keeps the JAX package's
algebra over whole timed regions:

* ``Timer.time_callable`` — robust statistics (median, MAD, min) of one
  callable's time over repetitions;
* ``Timer.slope`` — latency from two dependent-chain lengths,
  ``(T(n2) - T(n1)) / (n2 - n1)``, which cancels the fixed cost of the
  region (launch, dispatch, clock reads) exactly.

The clock follows the device. On CUDA it is a pair of CUDA events recorded
on the current stream around the region (``clock="events"``), behind a
lead: before the start event the stream is held by a short spin kernel
(``torch.cuda._sleep``) that outlasts the host's enqueueing of the region,
so that the card runs the start event, the region's kernels and the end
event back to back. Without the lead the events would time the host: the
card waits for each launch, and a compiled chain's kernel (about a
microsecond) hides under tens of microseconds of host dispatch and its
jitter. So every time here is device time: at O0 the card's time for the
eager kernels one after another, at O3 the fused kernel's. On the CPU the
clock is ``time.perf_counter_ns`` around the region (``clock="host"``).
Every probe records which one in its notes. A region no lead can cover (a
served step: more launches than the card's queue holds, or a copy from
host memory that waits for the stream) is timed with ``lead=False``: the
events around it on an idle stream, so its time is the step's as served,
the host's gaps between launches included.

On the card a third clock reaches inside a kernel: the paper's own
sandwich, the SM's ``%clock64`` read by each thread right before and right
after its dependent chain (``alu_chain_timed``, ``op_chain_timed``).
``sandwich_slope`` takes the two-length slope in SM cycles, and
``sm_clock_hz`` (the cycle counter against the card's nanosecond timer)
converts it to time. The in-kernel rows are timed so; on the card every
row's ``cycles`` column counts SM cycles at the session's ``sm_clock_hz``,
and on the CPU the pseudo-clock of ``Timer.calibrate_clock_hz``. The TPU
had no such counter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.utils import block

# Spin cycles per nanosecond of lead: no less than the SM clock in GHz, so a
# lead lasts at least as long as asked for (a longer one only costs time).
_LEAD_CYCLES_PER_NS = 2.0
_MIN_LEAD_NS = 50_000
_MAX_LEAD_NS = 100_000_000
# enqueues in a row longer than the longest lead covers, before a region is
# declared untimeable on the card's clock
_SLOW_ENQUEUES = 3


class NoisySlopeError(RuntimeError):
    """A two-length slope came out non-positive: noise exceeded the per-op
    signal at the given chain spread. Raised (after one widened-spread retry)
    instead of returning a bogus ``<= 0`` latency, so the session records a
    structured ``ProbeFailure`` rather than persisting a wrong row."""


@dataclasses.dataclass(frozen=True)
class AdaptiveFidelity:
    """Adaptive repetition policy: stop repeating once ``MAD <= rel_mad *
    median`` with at least ``min_reps`` samples, bank the unspent reps, and
    let a still-noisy measurement draw up to ``(max_extra_factor - 1) *
    reps`` banked ones."""

    rel_mad: float = 0.05
    min_reps: int = 4
    max_extra_factor: float = 2.0

    def converged(self, samples_ns: Sequence[float]) -> bool:
        if len(samples_ns) < max(self.min_reps, 2):
            return False
        med = statistics.median(samples_ns)
        if med <= 0:
            return False
        mad = statistics.median([abs(s - med) for s in samples_ns])
        return mad <= self.rel_mad * med


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Robust summary of repeated timings (nanoseconds). ``retry_lens`` is
    set on a slope that came from the widened-spread retry."""

    median_ns: float
    mad_ns: float
    min_ns: float
    n: int
    retry_lens: tuple[int, int] | None = None

    def __sub__(self, other: "Measurement") -> "Measurement":
        return Measurement(
            median_ns=self.median_ns - other.median_ns,
            mad_ns=(self.mad_ns ** 2 + other.mad_ns ** 2) ** 0.5,
            min_ns=self.min_ns - other.min_ns,
            n=min(self.n, other.n),
        )

    def scaled(self, k: float) -> "Measurement":
        return Measurement(self.median_ns * k, self.mad_ns * k, self.min_ns * k, self.n)


def sm_clock_hz(device: str | torch.device | None = None) -> float:
    """The SM clock of a CUDA ``device`` (default ``cuda:0``) in Hz: the
    median over three spins of about 1 ms of SM cycles / global-timer
    seconds. Raises on the CPU, which has no SM clock."""
    from repro_torch.kernels.alu_chain import sm_clock_sample

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"sm_clock_hz: the SM clock exists only on a CUDA card, "
                           f"not on {dev}")
    with torch.cuda.device(dev):
        rates = [c / ns * 1e9 for c, ns in (sm_clock_sample(dev) for _ in range(3))]
    return statistics.median(rates)


def sandwich_slope(cycles_by_len: Callable[[int], Callable[[], torch.Tensor]],
                   n1: int, n2: int, *, clock_hz: float, reps: int = 5,
                   warmup: int = 1) -> Measurement:
    """Per-op latency of an in-kernel chain on the SM clock.

    ``cycles_by_len(n)()`` launches the chain of length ``n`` and returns
    each thread's cycles between its two clock reads. A launch counts the
    median over its threads, a length the minimum over ``reps`` launches
    (noise only adds), and the slope is ``(c(n2) - c(n1)) / (n2 - n1)``
    cycles, converted to ns at ``clock_hz``; ``mad_ns`` is the MAD of the
    per-launch slopes. A non-positive slope raises :class:`NoisySlopeError`.
    """
    if not n2 > n1 >= 0:
        raise ValueError(f"slope needs n2 > n1 >= 0, got ({n1}, {n2})")
    per_len = []
    for n in (n1, n2):
        fn = cycles_by_len(n)
        for _ in range(warmup):
            fn()
        per_len.append([float(fn().median()) for _ in range(reps)])
    ns_per_cycle = 1e9 / clock_hz
    slope = (min(per_len[1]) - min(per_len[0])) / (n2 - n1) * ns_per_cycle
    if slope <= 0:
        raise NoisySlopeError(f"non-positive slope ({slope:.3f} ns/op) on the SM clock "
                              f"at chain lens ({n1}, {n2})")
    each = [(c2 - c1) / (n2 - n1) * ns_per_cycle for c1, c2 in zip(*per_len)]
    mad = _summarize(each).mad_ns
    return Measurement(median_ns=slope, mad_ns=mad, min_ns=slope, n=reps)


def _summarize(samples_ns: Sequence[float]) -> Measurement:
    med = statistics.median(samples_ns)
    mad = statistics.median([abs(s - med) for s in samples_ns]) if len(samples_ns) > 1 else 0.0
    return Measurement(median_ns=med, mad_ns=mad, min_ns=min(samples_ns), n=len(samples_ns))


class Timer:
    """Timer for device-complete executions.

    Parameters
    ----------
    warmup: executions before timing (the paper's first-sample discard).
    reps: timed repetitions per measurement.
    clock_hz: nominal clock used to convert ns -> cycles for the tables.
        Defaults to a calibrated estimate of the host clock, as in the JAX
        package (see ``calibrate_clock_hz``).
    device: the torch device every timed execution runs on; its type picks
        the clock (CUDA events for ``cuda``, the host clock for ``cpu``).
        Defaults to ``cuda:0``; raises when CUDA is asked for and absent.
    adaptive: an :class:`AdaptiveFidelity` policy, or None for fixed reps.
    """

    def __init__(self, warmup: int = 3, reps: int = 30, clock_hz: float | None = None,
                 device: str | torch.device | None = None,
                 adaptive: AdaptiveFidelity | None = None):
        self.warmup = int(warmup)
        self.reps = int(reps)
        self.clock_hz = clock_hz
        self.device = resolve_device(device)
        self.adaptive = adaptive
        self._rep_bank = 0
        self._lead_ns = _MIN_LEAD_NS  # grows to fit a slow region, then decays

    @property
    def clock(self) -> str:
        """``"events"`` on a CUDA device, ``"host"`` on the CPU."""
        return "events" if self.device.type == "cuda" else "host"

    def device_ctx(self):
        """Make the timed device current (no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ------------------------------------------------------------------ raw
    def _sampler(self, lead: bool = True) -> Callable[..., float]:
        """One timed execution -> ns, on this timer's clock (on the card
        behind a lead, or with ``lead=False`` on an idle stream)."""
        if self.clock == "events" and not lead:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)

            def sample(fn: Callable[..., Any], *args: Any) -> float:
                torch.cuda.current_stream().synchronize()
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                return start.elapsed_time(end) * 1e6  # ms -> ns
            return sample
        if self.clock == "events":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)

            def sample(fn: Callable[..., Any], *args: Any) -> float:
                too_slow = 0
                while True:
                    torch.cuda._sleep(int(self._lead_ns * _LEAD_CYCLES_PER_NS))
                    t0 = time.perf_counter_ns()
                    start.record()
                    fn(*args)
                    end.record()
                    queued_ns = time.perf_counter_ns() - t0
                    end.synchronize()
                    if 2 * queued_ns < self._lead_ns:
                        # a lead grown for one slow enqueue (the host busy
                        # elsewhere) halves back toward what this region needs
                        self._lead_ns = max(_MIN_LEAD_NS, 4 * queued_ns, self._lead_ns // 2)
                        return start.elapsed_time(end) * 1e6  # ms -> ns
                    # the card may have run dry before the region was queued
                    # (then the sample timed the host): take it again behind
                    # a longer lead
                    if 4 * queued_ns > _MAX_LEAD_NS:
                        # once may be the host's scheduler (this process
                        # descheduled mid-enqueue); three times is the region
                        too_slow += 1
                        if too_slow == _SLOW_ENQUEUES:
                            raise RuntimeError(
                                f"the timed region took {queued_ns / 1e6:.1f} ms to "
                                "enqueue (or waits for the card inside): it cannot "
                                "be timed on the card's clock")
                        self._lead_ns = _MAX_LEAD_NS
                        continue
                    self._lead_ns = 4 * queued_ns
            return sample

        def sample(fn: Callable[..., Any], *args: Any) -> float:
            t0 = time.perf_counter_ns()
            block(fn(*args))
            return time.perf_counter_ns() - t0
        return sample

    def time_once(self, fn: Callable[..., Any], *args: Any) -> float:
        """ns of one execution of ``fn(*args)``, with no warmup."""
        with self.device_ctx():
            return self._sampler()(fn, *args)

    def time_callable(self, fn: Callable[..., Any], *args: Any,
                      warmup: int | None = None, reps: int | None = None,
                      lead: bool = True) -> Measurement:
        """Median time of ``fn(*args)`` with device completion (on the card
        behind a lead, or with ``lead=False`` around the region on an idle
        stream; the module docstring says when).

        With an :class:`AdaptiveFidelity` policy set, ``reps`` is the nominal
        budget: the loop stops once the running MAD/median converges (banking
        the unspent reps) and a still-noisy measurement may draw banked reps.
        ``Measurement.n`` reports the repetitions actually taken.
        """
        warmup = self.warmup if warmup is None else warmup
        reps = self.reps if reps is None else reps
        adaptive = self.adaptive if (self.adaptive is not None
                                     and reps > self.adaptive.min_reps) else None
        max_total = reps
        if adaptive is not None:
            max_total = reps + min(
                int(reps * (adaptive.max_extra_factor - 1.0)), self._rep_bank)
        with self.device_ctx():
            sample = self._sampler(lead)
            for _ in range(warmup):
                block(fn(*args))
            samples: list[float] = []
            while len(samples) < max_total:
                samples.append(sample(fn, *args))
                if adaptive is not None and adaptive.converged(samples):
                    break
        if adaptive is not None:
            self._rep_bank += reps - len(samples)  # bank savings / repay draws
        return _summarize(samples)

    # --------------------------------------------------------------- methods
    def slope(self, fn_by_len: Callable[[int], Callable[..., Any]],
              n1: int, n2: int, *args: Any,
              warmup: int | None = None, reps: int | None = None,
              use_min: bool = True,
              retry_lens: tuple[int, int] | None = None,
              interleave: bool = False) -> Measurement:
        """Per-op latency from two chain lengths (overhead cancels exactly).

        With ``use_min`` (default) the difference of the per-length minimum
        times is used: noise on a timed region only ever adds, so the minimum
        is its floor. A non-positive estimate is retried **once** with a
        widened spread (``retry_lens``; default ``(n1, n2 + 3*(n2 - n1))``),
        and if still non-positive a :class:`NoisySlopeError` is raised.
        Passing ``retry_lens == (n1, n2)`` disables the retry.

        ``interleave`` alternates one sample of each length per repetition
        instead of taking all of ``n1``'s first: a slow stretch of the host
        (a neighbour on its cores) that outlasts one length's samples then
        slows both lengths, not one (adaptive fidelity is not applied).
        """
        if not n2 > n1 >= 0:
            raise ValueError(f"slope needs n2 > n1 >= 0, got ({n1}, {n2})")
        kw = dict(warmup=warmup, reps=reps, use_min=use_min, interleave=interleave)
        diff = self._slope_once(fn_by_len, n1, n2, *args, **kw)
        if diff.median_ns > 0:
            return diff
        widened = retry_lens if retry_lens is not None else (n1, n2 + 3 * (n2 - n1))
        if tuple(widened) != (n1, n2) and widened[1] > widened[0] >= 0:
            retry = self._slope_once(fn_by_len, widened[0], widened[1], *args, **kw)
            if retry.median_ns > 0:
                return dataclasses.replace(retry, retry_lens=tuple(widened))
        raise NoisySlopeError(
            f"non-positive slope ({diff.median_ns:.3f} ns/op) at chain lens "
            f"({n1}, {n2}): noise exceeded the per-op signal"
            + ("" if tuple(widened) == (n1, n2) else
               f"; widened retry at {tuple(widened)} was also non-positive"))

    def _slope_once(self, fn_by_len: Callable[[int], Callable[..., Any]],
                    n1: int, n2: int, *args: Any,
                    warmup: int | None = None, reps: int | None = None,
                    use_min: bool = True, interleave: bool = False) -> Measurement:
        if interleave:
            t1, t2 = self._time_interleaved(fn_by_len(n1), fn_by_len(n2), *args,
                                            warmup=warmup, reps=reps)
        else:
            t1 = self.time_callable(fn_by_len(n1), *args, warmup=warmup, reps=reps)
            t2 = self.time_callable(fn_by_len(n2), *args, warmup=warmup, reps=reps)
        diff = (t2 - t1).scaled(1.0 / (n2 - n1))
        if use_min:
            est = (t2.min_ns - t1.min_ns) / (n2 - n1)
            diff = Measurement(median_ns=est, mad_ns=diff.mad_ns,
                               min_ns=est, n=diff.n)
        return diff

    def _time_interleaved(self, f1: Callable[..., Any], f2: Callable[..., Any], *args: Any,
                          warmup: int | None = None,
                          reps: int | None = None) -> tuple[Measurement, Measurement]:
        """:meth:`time_callable` of two callables, their samples alternated."""
        warmup = self.warmup if warmup is None else warmup
        reps = self.reps if reps is None else reps
        with self.device_ctx():
            sample = self._sampler()
            for _ in range(warmup):
                block(f1(*args))
                block(f2(*args))
            s1: list[float] = []
            s2: list[float] = []
            for _ in range(reps):
                s1.append(sample(f1, *args))
                s2.append(sample(f2, *args))
        return _summarize(s1), _summarize(s2)

    # ----------------------------------------------------------------- units
    def calibrate_clock_hz(self) -> float:
        """Effective clock for ns -> cycle conversion.

        The JAX package's pseudo-clock, kept for parity of the ``cycles``
        column on the CPU: a spin loop of known iteration count on the host,
        clamped to [0.1, 5] GHz. On the card a session counts ``cycles`` on
        the SM clock instead (``sm_clock_hz``, ``Session.clock_hz``).
        """
        if self.clock_hz:
            return self.clock_hz
        n = 200_000
        t0 = time.perf_counter_ns()
        x = 0
        for i in range(n):
            x += i
        dt = time.perf_counter_ns() - t0
        per_iter_ns = dt / n
        hz = 1e9 / max(min(per_iter_ns, 1000.0), 1.0)
        self.clock_hz = max(min(hz, 5e9), 1e8)
        return self.clock_hz
