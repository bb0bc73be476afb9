"""Analytical performance model fed by the characterization results (the
port of ``repro/core/perfmodel.py``).

The paper's purpose (Section I): measured per-instruction latencies make
performance models such as PPT-GPU accurate. Two models:

* :class:`Roofline` — the three-term roofline over FLOPs, bytes and
  collective wire bytes, the JAX package's arithmetic: from a cost dict
  and, where given, an op record (:class:`hlo_analysis.OpRecord`) in the
  place of the HLO text.
* :class:`RecordLatencyEstimator` — the counterpart of
  ``HloLatencyEstimator``: it prices the op record of one eager step
  (:func:`hlo_analysis.record_ops`) with *measured* rows of the LatencyDB,
  a two-term ``max(compute, memory)`` estimate whose memory term comes from
  the measured pointer-chase ladder, plus a collective term, in a
  :class:`PricedReport` with an explicit coverage. The pricing itself is
  one function over a neutral input (:meth:`RecordLatencyEstimator.price`:
  a histogram, matmul FLOPs, kernel sites, bytes and collectives), so that
  the JAX estimator's inputs price to the JAX estimator's report.
  :class:`ServingPoint` parses the ``serving.<phase>.<cell>`` rows the
  ``ServingCostProbe`` writes (predicted against measured), and
  :class:`SloPoint` the ``slo.r<rate>`` rows of the ``SloProbe``.

The algebra is the JAX package's, set for a TPU and kept as it is: 8
lanes, ``THROUGHPUT_FACTOR`` 0.25, ``default_ns`` 5, 8 memory streams, a
dot's FLOPs / 2 priced as ``fma.float32`` issues.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Iterable

from repro_torch.core import hlo_analysis
from repro_torch.core.latency_db import LatencyDB, LatencyRecord
from repro_torch.utils import human_bytes, human_flops, parse_kv_notes


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link
    hbm_bytes: float           # capacity per chip
    clock_hz: float = 0.0

    @property
    def arithmetic_intensity_knee(self) -> float:
        return self.peak_flops / self.hbm_bw


# The JAX package's targets, as they are there.
TPU_V5E = HardwareSpec(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       ici_bw=50e9, hbm_bytes=16 * 2**30, clock_hz=1.7e9)
CPU_HOST = HardwareSpec(name="cpu-host", peak_flops=1e11, hbm_bw=2e10,
                        ici_bw=1e10, hbm_bytes=64 * 2**30, clock_hz=3e9)
# NVIDIA H100 SXM5 80 GB, the data sheet's figures: 989 TFLOP/s dense bf16
# on the tensor cores, 3.35 TB/s of HBM3, 80 GB; ici_bw NVLink 4's 450 GB/s
# each way (the sheet's 900 GB/s counts both); clock_hz the SM clock sampled
# on such a card (1980 MHz, its boost clock).
H100 = HardwareSpec(name="h100-sxm5", peak_flops=989e12, hbm_bw=3.35e12,
                    ici_bw=450e9, hbm_bytes=80e9, clock_hz=1.98e9)


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    collective_wire_bytes_per_dev: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float           # 6ND (train) / 2ND (decode), active params
    useful_ratio: float          # model_flops / (flops_per_dev * chips)
    peak_memory_per_dev: float
    roofline_fraction: float
    collectives: dict[str, dict[str, float]]
    notes: str = ""

    def bound_summary(self) -> str:
        return (f"{self.arch}/{self.shape}@{self.mesh}: comp={self.t_compute*1e3:.2f}ms "
                f"mem={self.t_memory*1e3:.2f}ms coll={self.t_collective*1e3:.2f}ms "
                f"-> {self.dominant}-bound, useful={self.useful_ratio:.2%}, "
                f"roofline={self.roofline_fraction:.2%}")


def _summary(collectives) -> dict[str, dict[str, float]]:
    summ: dict[str, dict[str, float]] = {}
    for c in collectives:
        d = summ.setdefault(c.kind, {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0})
        d["count"] += c.executions
        d["result_bytes"] += c.result_bytes * c.executions
        d["wire_bytes"] += c.wire_bytes * c.executions
    return summ


class Roofline:
    def __init__(self, hw: HardwareSpec = TPU_V5E):
        self.hw = hw

    def analyze(self, *, arch: str, shape: str, mesh: str, chips: int,
                cost: dict[str, Any], record: hlo_analysis.OpRecord | None = None,
                model_flops: float, peak_memory_per_dev: float = 0.0,
                notes: str = "") -> RooflineReport:
        """The JAX package's terms, with an op record where it reads HLO
        text: FLOPs the larger of the cost dict's and the record's, bytes
        the record's where it has any, wire bytes its collectives'."""
        flops_rec = record.flops if record is not None else 0.0
        bytes_rec = record.bytes if record is not None else 0.0
        colls = record.collectives if record is not None else []
        flops_dev = max(float(cost.get("flops", 0.0)), flops_rec)
        bytes_dev = bytes_rec if bytes_rec > 0 else float(cost.get("bytes accessed", 0.0))
        wire_dev = float(sum(c.wire_bytes * c.executions for c in colls))
        t_comp = flops_dev / self.hw.peak_flops
        t_mem = bytes_dev / self.hw.hbm_bw
        t_coll = wire_dev / self.hw.ici_bw
        terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
        dominant = max(terms, key=terms.get)  # type: ignore[arg-type]
        total_flops = flops_dev * max(chips, 1)
        useful = model_flops / total_flops if total_flops else 0.0
        t_ideal = (model_flops / max(chips, 1)) / self.hw.peak_flops
        frac = t_ideal / max(max(terms.values()), 1e-30)
        return RooflineReport(
            arch=arch, shape=shape, mesh=mesh, chips=chips,
            flops_per_dev=flops_dev, bytes_per_dev=bytes_dev,
            collective_wire_bytes_per_dev=wire_dev,
            t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
            dominant=dominant, model_flops=model_flops, useful_ratio=useful,
            peak_memory_per_dev=peak_memory_per_dev,
            roofline_fraction=min(frac, 1.0),
            collectives=_summary(colls), notes=notes)

    @staticmethod
    def markdown_row(r: RooflineReport) -> list[str]:
        return [r.arch, r.shape, r.mesh, str(r.chips),
                human_flops(r.flops_per_dev), human_bytes(r.bytes_per_dev),
                human_bytes(r.collective_wire_bytes_per_dev),
                f"{r.t_compute*1e3:.3f}", f"{r.t_memory*1e3:.3f}",
                f"{r.t_collective*1e3:.3f}", r.dominant,
                f"{r.useful_ratio:.2%}", f"{r.roofline_fraction:.2%}",
                human_bytes(r.peak_memory_per_dev)]

    MD_HEADERS = ["arch", "shape", "mesh", "chips", "flops/dev", "bytes/dev",
                  "coll-wire/dev", "T_comp(ms)", "T_mem(ms)", "T_coll(ms)",
                  "bound", "useful", "roofline", "peak-mem/dev"]


@dataclasses.dataclass(frozen=True)
class ClassCost:
    """One op-class row of a :class:`PricedReport` breakdown."""

    ns: float = 0.0
    instances: float = 0.0       # dynamic op instances
    elements: float = 0.0        # dynamic result elements across instances

    def _plus(self, ns: float, instances: float, elements: float) -> "ClassCost":
        return ClassCost(self.ns + ns, self.instances + instances,
                         self.elements + elements)


@dataclasses.dataclass(frozen=True)
class PricedReport:
    """Full diagnosis of one estimate, the JAX package's report.

    ``total_ns = max(compute_ns, memory_ns) + collective_ns``. ``coverage`` is
    the fraction of countable dynamic op instances priced from a measured
    DB row: instances priced at ``default_ns`` (no mapping, or a mapping with
    no measured row) count against it, structural ops in neither direction.
    """

    total_ns: float
    compute_ns: float
    memory_ns: float
    coverage: float
    priced_instances: float
    unpriced_instances: float
    by_class: dict[str, ClassCost]
    unpriced_opcodes: tuple[tuple[str, float], ...]   # (op, dynamic count)
    bytes_accessed: float
    opt_level: str
    collective_ns: float = 0.0

    @property
    def bound(self) -> str:
        if self.collective_ns > max(self.compute_ns, self.memory_ns):
            return "collective"
        return "compute" if self.compute_ns >= self.memory_ns else "memory"

    def summary(self) -> str:
        miss = ", ".join(f"{op}x{c:g}" for op, c in self.unpriced_opcodes[:4])
        coll = (f" coll={self.collective_ns:.1f}"
                if self.collective_ns else "")
        return (f"{self.total_ns:.1f}ns ({self.bound}-bound: "
                f"comp={self.compute_ns:.1f} mem={self.memory_ns:.1f}"
                f"{coll}), coverage={self.coverage:.1%}"
                + (f", unpriced: {miss}" if miss else ""))


@dataclasses.dataclass(frozen=True)
class MemoryRung:
    """One measured rung of the DB's pointer-chase ladder."""

    working_set_bytes: int
    ns_per_line: float
    line_bytes: int
    source: str                  # "inkernel" | "host"


@dataclasses.dataclass(frozen=True)
class CollectiveRung:
    """One measured rung of the DB's collective ladder, keyed by kind."""

    kind: str                    # collective kind ("all-reduce", ...)
    devices: int
    wire_bytes: float
    ns: float


@dataclasses.dataclass(frozen=True)
class Site:
    """One opaque call the pricing core prices per call: the fused-kernel
    row stem it resolves to (None: none), its bytes, its executions, and the
    label it is reported under while unpriced (``kernel:<name>`` here,
    ``custom-call:<target>`` in the JAX package)."""

    fused: str | None
    bytes: float
    executions: float
    label: str


class _EstimatedNs(float):
    """A float that carries its :class:`PricedReport` (see ``estimate_ns``)."""

    report: PricedReport


_MEM_ROW_RE = re.compile(r"^(?:mem\.chase\.ws|inkernel\.mem\.)(\d+)$")
_COLL_ROW_RE = re.compile(
    r"^coll\.(psum|all_gather|reduce_scatter|ppermute)\.d(\d+)\.(\d+)$")


class RecordLatencyEstimator:
    """Price an op record from measured per-op latencies (the counterpart of
    ``HloLatencyEstimator``; the JAX package's algebra throughout).

    * **compute**: Σ over dynamic op instances of ``issue latency +
      (elements-1)/lanes × THROUGHPUT_FACTOR × latency``. Matmuls price
      their FLOPs / 2 as ``fma.float32`` issues through the same formula.
      An op with no mapped or measured row is priced at ``default_ns`` and
      listed in ``unpriced_opcodes``. A kernel site whose
      ``inkernel.fused.<name>`` row is measured costs ``executions ×
      site_bytes / unit_bytes × row_ns`` (``unit_bytes`` from the row's
      notes); one without is ``kernel:<name>`` in ``unpriced_opcodes``.
    * **memory**: the record's bytes off the measured chase ladder
      (``inkernel.mem.<N>`` preferred over ``mem.chase.ws<N>``): the rung
      covering the footprint gives ns a line, over ``mem_streams`` streams.
    * **collective**: each collective from the covering rung of its kind's
      ladder (``coll.<kind>.d<N>.<bytes>``); a kind with no rung is never
      default-priced (``collective:<kind>``). No record of the port holds a
      collective yet; the branch is kept for the sharded slice.

    ``total = max(compute, memory) + collective``.
    """

    THROUGHPUT_FACTOR = 0.25     # per-element cost fraction once issued

    def __init__(self, db: LatencyDB, opt_level: str = "O3",
                 lanes: int = 8, default_ns: float = 5.0,
                 mem_streams: int = 8, filters: dict[str, str] | None = None):
        self.db = db
        self.opt_level = opt_level
        self.lanes = lanes
        self.default_ns = default_ns
        self.mem_streams = mem_streams
        # env filters (device_kind/backend/jax_version): rows of another
        # device never price this one's step
        self.filters = dict(filters) if filters else {}

    # ------------------------------------------------------------- lookups
    def _table_latency(self, table_op: str) -> tuple[float, bool]:
        """(latency ns, was a measured row found), falling back from the row
        to its base row (``sub.float32`` -> ``sub``) before ``default_ns``."""
        lat = self.db.lookup_ns(table_op, self.opt_level, **self.filters)
        if lat is not None:
            return lat, True
        base = table_op.split(".")[0]
        if base != table_op:
            lat = self.db.lookup_ns(base, self.opt_level, **self.filters)
            if lat is not None:
                return lat, True
        return self.default_ns, False

    def _fused_row(self, name: str) -> tuple[float, float] | None:
        """``(ns_per_unit, unit_bytes)`` of the newest measured
        ``inkernel.fused.<name>`` row. ``unit_bytes`` comes from its notes
        (``FusedKernelProbe`` writes it), else from the port's own count
        (``inkernel.unit_bytes``); a row with neither prices nothing."""
        recs = self.db.query(op=f"inkernel.fused.{name}",
                             opt_level=self.opt_level, **self.filters)
        if not recs:
            return None
        rec = sorted(recs, key=lambda r: r.measured_at)[-1]
        unit_bytes = float(parse_kv_notes(rec.notes).get("unit_bytes", 0.0) or 0.0)
        if unit_bytes <= 0:
            try:
                from repro_torch import inkernel

                unit_bytes = float(inkernel.unit_bytes(name))
            except Exception:  # noqa: BLE001 - no unit: no pricing
                return None
        if unit_bytes <= 0:
            return None
        return rec.latency_ns, unit_bytes

    def memory_ladder(self) -> list[MemoryRung]:
        """Measured chase rungs, ascending by working set: unsuffixed rows
        only, the in-kernel row winning over its host twin at one size."""
        rungs: dict[int, MemoryRung] = {}
        for r in self.db.query(category="memory", **self.filters):
            m = _MEM_ROW_RE.match(r.op)
            if not m or r.opt_level != self.opt_level:
                continue
            ws = int(m.group(1))
            source = "inkernel" if r.op.startswith("inkernel.") else "host"
            if ws in rungs and rungs[ws].source == "inkernel" and source == "host":
                continue
            lm = re.search(r"(?:line|stride)=(\d+)", r.notes)
            line = int(lm.group(1)) if lm else 64
            rungs[ws] = MemoryRung(working_set_bytes=ws, ns_per_line=r.latency_ns,
                                   line_bytes=line, source=source)
        return sorted(rungs.values(), key=lambda g: g.working_set_bytes)

    def collective_ladder(self) -> dict[str, list[CollectiveRung]]:
        """Measured collective rungs grouped by kind, ascending by wire
        bytes (unsuffixed ``coll.<kind>.d<N>.<bytes>`` rows; their wire
        bytes from the notes, else re-derived from the payload)."""
        rungs: dict[str, list[CollectiveRung]] = {}
        for r in self.db.query(category="collective", **self.filters):
            m = _COLL_ROW_RE.match(r.op)
            if not m or r.opt_level != self.opt_level:
                continue
            kind = hlo_analysis.LADDER_TO_COLLECTIVE[m.group(1)]
            devices = int(m.group(2))
            kv = parse_kv_notes(r.notes)
            wire = float(kv.get("wire_bytes", 0.0) or 0.0)
            if wire <= 0:
                payload = float(kv.get("payload_bytes", m.group(3)) or 0.0)
                if m.group(1) == "all_gather":
                    result = payload * devices
                elif m.group(1) == "reduce_scatter":
                    result = payload / max(devices, 1)
                else:
                    result = payload
                wire = hlo_analysis.ring_factor(kind, devices) * result
            if wire <= 0:
                continue
            rungs.setdefault(kind, []).append(
                CollectiveRung(kind=kind, devices=devices, wire_bytes=wire, ns=r.latency_ns))
        for kind in rungs:
            rungs[kind].sort(key=lambda g: g.wire_bytes)
        return rungs

    def _memory_ns(self, bytes_accessed: float) -> float:
        if bytes_accessed <= 0:
            return 0.0
        ladder = self.memory_ladder()
        if not ladder:
            return 0.0
        rung = next((g for g in ladder if g.working_set_bytes >= bytes_accessed),
                    ladder[-1])
        ns_per_byte = rung.ns_per_line / rung.line_bytes
        return bytes_accessed * ns_per_byte / max(self.mem_streams, 1)

    # ------------------------------------------------------------- pricing
    def _instance_ns(self, latency: float, elements: float,
                     instances: float = 1.0) -> float:
        """Issue latency per instance + lane-amortized per-element throughput."""
        extra = max(elements - instances, 0.0)
        return instances * latency + (extra / self.lanes) * self.THROUGHPUT_FACTOR * latency

    def price(self, hist: dict[tuple[str, int], float], matmul_flops: float,
              sites: Iterable[Site] = (), bytes_accessed: float = 0.0,
              collectives: Iterable[Any] = (), *,
              table: dict[str, str] = hlo_analysis.ATEN_TO_TABLE,
              structural: frozenset[str] = hlo_analysis.STRUCTURAL_OPS,
              matmul_ops: frozenset[str] = hlo_analysis.MATMUL_OPS,
              matmul_label: str = "matmul") -> PricedReport:
        """The pricing core, over a neutral input: ``hist`` ``{(op,
        elements): count}`` (sites not in it), the matmuls' FLOPs, the sites
        priced per call, the bytes and the collectives (each with ``kind``,
        ``group_size``, ``wire_bytes`` and ``executions``). ``table``,
        ``structural`` and ``matmul_ops`` name the ops (the port's by
        default, ``HLO_TO_TABLE`` and friends for the JAX package's); an
        unmeasured matmul is reported as ``matmul_label`` (the JAX package's
        ``dot``)."""
        by_class: dict[str, ClassCost] = {}
        unpriced_ops: dict[str, float] = {}
        compute = priced = unpriced = 0.0
        matmul_instances = 0.0

        def account(cls: str, ns: float, count: float, elems: float) -> None:
            by_class[cls] = by_class.get(cls, ClassCost())._plus(ns, count, elems)

        for (op, elems), count in sorted(hist.items()):
            if count <= 0 or op in structural:
                continue
            if op in matmul_ops:
                matmul_instances += count
                continue            # priced below from the FLOPs
            table_op = table.get(op)
            if table_op is None:
                ns = count * self._instance_ns(self.default_ns, elems)
                compute += ns
                unpriced += count
                unpriced_ops[op] = unpriced_ops.get(op, 0.0) + count
                account("unpriced", ns, count, count * elems)
                continue
            lat, covered = self._table_latency(table_op)
            ns = count * self._instance_ns(lat, elems)
            compute += ns
            if covered:
                priced += count
                account(_table_category(table_op), ns, count, count * elems)
            else:
                unpriced += count
                unpriced_ops[op] = unpriced_ops.get(op, 0.0) + count
                account("unpriced", ns, count, count * elems)

        # sites, per call: a measured fused row prices a call by its bytes
        # against the row's unit bytes (the two-size slope netted launch
        # and transfer out of row_ns, so this is the probe's own algebra)
        for s in sites:
            if s.executions <= 0:
                continue
            row = self._fused_row(s.fused) if s.fused else None
            if row is not None:
                row_ns, unit_bytes = row
                ns = s.executions * (s.bytes / unit_bytes) * row_ns
                compute += ns
                priced += s.executions
                account(f"fused:{s.fused}", ns, s.executions, 0.0)
            else:
                ns = s.executions * self.default_ns
                compute += ns
                unpriced += s.executions
                unpriced_ops[s.label] = unpriced_ops.get(s.label, 0.0) + s.executions
                account("unpriced", ns, s.executions, 0.0)

        if matmul_instances:
            fmas = matmul_flops / 2.0
            lat, covered = self._table_latency("fma.float32")
            ns = self._instance_ns(lat, fmas, instances=matmul_instances)
            compute += ns
            account("matmul", ns, matmul_instances, fmas)
            if covered:
                priced += matmul_instances
            else:
                unpriced += matmul_instances
                unpriced_ops[matmul_label] = (unpriced_ops.get(matmul_label, 0.0)
                                              + matmul_instances)

        # collectives from the covering rung of their kind, rungs of their
        # own group size first; a kind with no rung is never default-priced
        collective_ns = 0.0
        coll_ladder: dict[str, list[CollectiveRung]] | None = None
        for c in collectives:
            if c.executions <= 0 or c.group_size <= 1 or c.wire_bytes <= 0:
                continue
            if coll_ladder is None:
                coll_ladder = self.collective_ladder()
            rungs = coll_ladder.get(c.kind, [])
            sized = [g for g in rungs if g.devices == c.group_size] or rungs
            rung = next((g for g in sized if g.wire_bytes >= c.wire_bytes),
                        sized[-1] if sized else None)
            if rung is not None:
                ns = c.executions * (c.wire_bytes / rung.wire_bytes) * rung.ns
                collective_ns += ns
                priced += c.executions
                account("collective", ns, c.executions, 0.0)
            else:
                unpriced += c.executions
                label = f"collective:{c.kind}"
                unpriced_ops[label] = unpriced_ops.get(label, 0.0) + c.executions
                account("unpriced", 0.0, c.executions, 0.0)

        memory_ns = self._memory_ns(bytes_accessed)
        if memory_ns:
            account("memory", memory_ns, 0.0, 0.0)
        countable = priced + unpriced
        return PricedReport(
            total_ns=max(compute, memory_ns) + collective_ns,
            compute_ns=compute, memory_ns=memory_ns,
            collective_ns=collective_ns,
            coverage=priced / countable if countable else 1.0,
            priced_instances=priced, unpriced_instances=unpriced,
            by_class=by_class,
            unpriced_opcodes=tuple(sorted(unpriced_ops.items(),
                                          key=lambda kv: (-kv[1], kv[0]))),
            bytes_accessed=bytes_accessed, opt_level=self.opt_level)

    def estimate(self, record: hlo_analysis.OpRecord) -> PricedReport:
        """Price an op record; returns the full :class:`PricedReport`."""
        sites = [Site(fused=hlo_analysis.KERNEL_SITES.get(s.name), bytes=s.bytes,
                      executions=s.executions, label=f"kernel:{s.name}")
                 for s in record.sites]
        return self.price(record.dynamic_histogram(), record.matmul_flops, sites,
                          record.bytes, record.collectives)

    def estimate_ns(self, record: hlo_analysis.OpRecord) -> float:
        """Total estimate as a float, with the :class:`PricedReport` attached
        as ``.report``."""
        report = self.estimate(record)
        out = _EstimatedNs(report.total_ns)
        out.report = report
        return out


# ------------------------------------------------------------------ serving
@dataclasses.dataclass(frozen=True)
class ServingPoint:
    """One ``serving.<phase>.<cell>`` row, parsed back from its record: the
    record's ``latency_ns`` is the *measured* time of the step; the
    prediction and its diagnosis ride in the notes."""

    phase: str                   # "prefill" | "decode"
    batch: int
    prompt_len: int
    measured_ns: float
    predicted_ns: float
    compute_ns: float
    memory_ns: float
    coverage: float
    model: str = ""
    tp: int = 1
    collective_ns: float = 0.0
    coll_unpriced: float = 0.0

    @property
    def ratio(self) -> float:
        """predicted / measured (1.0 = perfect model)."""
        return self.predicted_ns / self.measured_ns if self.measured_ns else 0.0

    @property
    def abs_log10_error(self) -> float:
        """|log10(predicted/measured)|, symmetric in over- and
        under-prediction."""
        if self.measured_ns <= 0 or self.predicted_ns <= 0:
            return float("inf")
        return abs(math.log10(self.predicted_ns / self.measured_ns))


def servingpoint_from_record(rec: LatencyRecord) -> ServingPoint:
    """Parse a ``serving.*`` :class:`LatencyRecord` back into its point."""
    kv = parse_kv_notes(rec.notes)
    parts = rec.op.split(".")
    assert parts[0] == "serving" and len(parts) >= 3, rec.op
    return ServingPoint(
        phase=kv.get("phase", parts[1]),
        batch=int(kv["batch"]), prompt_len=int(kv["prompt"]),
        measured_ns=rec.latency_ns,
        predicted_ns=float(kv["predicted_ns"]),
        compute_ns=float(kv.get("compute_ns", 0.0)),
        memory_ns=float(kv.get("memory_ns", 0.0)),
        coverage=float(kv.get("coverage", 0.0)),
        model=kv.get("model", ""),
        tp=int(kv.get("tp", 1)),
        collective_ns=float(kv.get("collective_ns", 0.0)),
        coll_unpriced=float(kv.get("coll_unpriced", 0.0)))


@dataclasses.dataclass(frozen=True)
class SloPoint:
    """One ``slo.r<rate>`` row: predicted-vs-measured serving SLOs at one
    arrival rate, parsed back from the record an
    :class:`~repro_torch.api.SloProbe` persisted. The record's
    ``latency_ns`` is the measured p50 TTFT; the notes carry the full
    percentile set for both sides (ns), goodput (tok/s) and the estimator
    coverage of the priced prefill/decode steps.
    """

    rate_rps: float
    n_requests: int
    n_slots: int
    predicted: dict               # metric name -> value (pred_* keys, no prefix)
    measured: dict                # same metric names, measured side
    coverage: float
    model: str = ""

    METRICS = ("ttft_p50_ns", "ttft_p99_ns", "tpot_p50_ns", "tpot_p99_ns",
               "e2e_p50_ns", "goodput_tok_s")

    def abs_log10_error(self, metric: str) -> float:
        """|log10(pred/meas)| for one metric — the semantics of
        :attr:`ServingPoint.abs_log10_error`."""
        p, m = self.predicted.get(metric, 0.0), self.measured.get(metric, 0.0)
        if p is None or m is None or p <= 0 or m <= 0 or math.isnan(p) or math.isnan(m):
            return float("inf")
        return abs(math.log10(p / m))


def slopoint_from_record(rec: LatencyRecord) -> SloPoint:
    """Parse an ``slo.*`` :class:`LatencyRecord` back into its point."""
    kv = parse_kv_notes(rec.notes)
    assert rec.op.split(".")[0] == "slo", rec.op

    def side(prefix: str) -> dict:
        return {m: float(kv[f"{prefix}_{m}"]) for m in SloPoint.METRICS
                if f"{prefix}_{m}" in kv}

    return SloPoint(
        rate_rps=float(kv["rate"]), n_requests=int(kv.get("n", 0)),
        n_slots=int(kv.get("slots", 0)),
        predicted=side("pred"), measured=side("meas"),
        coverage=float(kv.get("coverage", 0.0)),
        model=kv.get("model", ""))


def slo_markdown(points: "list[SloPoint]") -> str:
    """Markdown throughput-vs-latency table over :class:`SloPoint` rows —
    the ``serve-slo`` CLI's output. Latencies in ms, goodput in tok/s."""
    def ms(d: dict, key: str) -> str:
        v = d.get(key)
        return f"{v / 1e6:.3f}" if v is not None else "-"

    lines = ["| rate (req/s) | side | TTFT p50 | TTFT p99 | TPOT p50 "
             "| TPOT p99 | goodput (tok/s) | coverage |",
             "|---" * 8 + "|"]
    for pt in points:
        for side_name, d in (("predicted", pt.predicted), ("measured", pt.measured)):
            good = d.get("goodput_tok_s")
            lines.append(
                f"| {pt.rate_rps:g} | {side_name} "
                f"| {ms(d, 'ttft_p50_ns')} | {ms(d, 'ttft_p99_ns')} "
                f"| {ms(d, 'tpot_p50_ns')} | {ms(d, 'tpot_p99_ns')} "
                f"| {good:.1f} | {pt.coverage:.1%} |"
                if good is not None else
                f"| {pt.rate_rps:g} | {side_name} | - | - | - | - | - "
                f"| {pt.coverage:.1%} |")
    return "\n".join(lines)


@functools.cache
def _table_category(table_op: str) -> str:
    """Registry category of a table row (``sub.float32`` -> ``fp32``);
    unknown names are ``uncategorized``."""
    from repro_torch.core import chains

    names = {o.name: o.category for o in chains.default_registry()}
    if table_op in names:
        return names[table_op]
    base = table_op.split(".")[0]
    return names.get(base, "uncategorized")
