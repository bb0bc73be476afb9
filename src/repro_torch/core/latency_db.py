"""Persistent database of measured latencies (the paper's published tables).

The port of ``repro.core.latency_db``, with the same record schema and the
same JSON and journal format, so either package reads the other's DB and
one DB can hold TPU rows and H100 rows side by side. Records are keyed by
(device_kind, backend, jax_version, opt_level, op, dtype). In this package
the ``jax_version`` field keeps its name, for that compatibility, and holds
the PyTorch build instead: ``torch-<version>+cu<CUDA version>`` on the card,
``torch-<version>+cpu`` on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
from typing import Iterable

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX host
    fcntl = None

import torch

from repro_torch.utils import (dump_json, load_json, logger, markdown_table,
                               parse_kv_notes, timestamp)


@dataclasses.dataclass(frozen=True)
class LatencyRecord:
    op: str
    category: str
    dtype: str
    opt_level: str
    latency_ns: float
    mad_ns: float
    cycles: float            # ns * calibrated clock (comparability with paper tables)
    guard: int               # extra trivial ops included in the step
    net_latency_ns: float    # latency minus guard * add-latency
    device_kind: str
    backend: str
    jax_version: str
    n_samples: int
    measured_at: str = ""
    notes: str = ""

    def key(self) -> tuple:
        return (self.device_kind, self.backend, self.jax_version,
                self.opt_level, self.op, self.dtype)


@dataclasses.dataclass(frozen=True)
class ProbeFailure:
    """Structured record of a probe that raised instead of measuring.

    Keyed identically to :class:`LatencyRecord` so a later successful
    measurement of the same probe supersedes the failure.
    """

    op: str
    dtype: str
    opt_level: str
    device_kind: str
    backend: str
    jax_version: str
    error_type: str
    message: str
    failed_at: str = ""

    def key(self) -> tuple:
        return (self.device_kind, self.backend, self.jax_version,
                self.opt_level, self.op, self.dtype)


def current_environment(device: str | torch.device) -> dict[str, str]:
    """Environment fingerprint of ``device``: what every record key starts
    with. ``device_kind`` is the card's name on CUDA (``cpu`` on the CPU),
    ``backend`` is ``cuda`` or ``cpu``."""
    dev = torch.device(device)
    version = "torch-" + torch.__version__.split("+")[0]
    if dev.type == "cuda":
        return {"device_kind": torch.cuda.get_device_name(dev),
                "backend": "cuda",
                "jax_version": f"{version}+cu{torch.version.cuda}"}
    return {"device_kind": "cpu", "backend": "cpu", "jax_version": f"{version}+cpu"}


@contextlib.contextmanager
def _flush_lock(path: str):
    """Inter-process lock serializing read-merge-write cycles on one DB path.

    Uses ``flock`` on a sidecar ``<path>.lock`` file so two sessions flushing
    to the same DB never interleave their read-merge-write critical sections
    (the rename itself is atomic, but without the lock both could read the
    same stale state and the second rename would drop the first's records).
    No-op where ``fcntl`` is unavailable.
    """
    if fcntl is None:  # non-POSIX: atomic rename still holds, merge races don't
        yield
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path + ".lock", "a") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _journal_path(path: str) -> str:
    return path + ".journal"


class LatencyDB:
    def __init__(self, path: str | None = None):
        self.path = path
        self._records: dict[tuple, LatencyRecord] = {}
        self._failures: dict[tuple, ProbeFailure] = {}
        self._disk_state: tuple | None = None
        self._dirty_records: set[tuple] = set()
        self._dirty_failures: set[tuple] = set()
        if path and os.path.exists(path):
            self.load(path)
        elif path and os.path.exists(_journal_path(path)):
            # Crashed before the first compaction: the journal is all there is.
            self._replay_journal(path)

    # ----------------------------------------------------------------- CRUD
    def add(self, rec: LatencyRecord) -> None:
        self._records[rec.key()] = rec
        self._failures.pop(rec.key(), None)  # a success supersedes a failure
        self._dirty_records.add(rec.key())
        self._dirty_failures.discard(rec.key())

    def extend(self, recs: Iterable[LatencyRecord]) -> None:
        for r in recs:
            self.add(r)

    def annotate(self, key: tuple, **kv: str | None) -> LatencyRecord | None:
        """Merge ``key=value`` tokens into a record's notes, in place.

        Existing tokens with the same key are replaced; a value of ``None``
        deletes the token. ``measured_at`` is untouched, so on a concurrent
        ``save`` the annotated copy wins merge ties against the un-annotated
        on-disk copy of itself (ties keep the in-memory value). Used by
        ``repro_torch.audit`` to persist ``audit=...`` verdicts. Returns the
        updated record, or None when the key is absent.
        """
        rec = self._records.get(tuple(key))
        if rec is None:
            return None
        drop = set(kv)
        kept = [tok for tok in rec.notes.split()
                if tok.partition("=")[0] not in drop]
        added = [f"{k}={v}" for k, v in kv.items() if v is not None]
        rec = dataclasses.replace(rec, notes=" ".join(kept + added))
        self.add(rec)
        return rec

    def records(self) -> list[LatencyRecord]:
        return list(self._records.values())

    def get(self, key: tuple) -> LatencyRecord | None:
        return self._records.get(tuple(key))

    def __contains__(self, key: tuple) -> bool:
        return tuple(key) in self._records

    def __len__(self) -> int:
        return len(self._records)

    # ------------------------------------------------------------- failures
    def add_failure(self, failure: ProbeFailure) -> None:
        self._failures[failure.key()] = failure
        self._dirty_failures.add(failure.key())

    def failures(self) -> list[ProbeFailure]:
        return list(self._failures.values())

    def query(self, **filters: str) -> list[LatencyRecord]:
        out = []
        for r in self._records.values():
            if all(getattr(r, k) == v for k, v in filters.items()):
                out.append(r)
        return out

    def lookup_ns(self, op: str, opt_level: str = "O3", default: float | None = None,
                  **filters: str) -> float | None:
        recs = self.query(op=op, opt_level=opt_level, **filters)
        if not recs:
            return default
        return sorted(recs, key=lambda r: r.measured_at)[-1].latency_ns

    # ---------------------------------------------------------------- merge
    def merge(self, *others: "LatencyDB") -> "LatencyDB":
        """Merge other DBs into this one (in place); returns self.

        Conflict rules, applied per key:

        * record vs record — newest ``measured_at`` wins; ties keep the
          current value (so a just-measured in-memory record is never
          replaced by an equally-timestamped on-disk copy of itself);
        * failure vs failure — newest ``failed_at`` wins, same tie rule;
        * record vs failure — the success supersedes the failure regardless
          of timestamps: one shard measuring an op beats another shard's
          crash on it.
        """
        for other in others:
            for key, rec in other._records.items():
                mine = self._records.get(key)
                if mine is None or rec.measured_at > mine.measured_at:
                    self._records[key] = rec
                    self._dirty_records.add(key)
            for key, fail in other._failures.items():
                mine = self._failures.get(key)
                if mine is None or fail.failed_at > mine.failed_at:
                    self._failures[key] = fail
                    self._dirty_failures.add(key)
        for key in list(self._failures):
            if key in self._records:
                del self._failures[key]
                self._dirty_failures.discard(key)
        return self

    # ------------------------------------------------------------------- IO
    def flush(self, path: str | None = None) -> str:
        """Append only the dirty (not-yet-persisted) entries to the journal.

        This is the cheap per-probe durability point: an N-probe sweep used
        to rewrite the whole DB after every probe — O(N²) JSON serialization
        plus N flock read-merge-write cycles. ``flush`` instead appends each
        new record/failure once to a ``<path>.journal`` JSONL sidecar
        (fsync'd, under the same inter-process lock) and nothing when there
        is nothing new. Crash-resume is preserved: :meth:`load` and the
        constructor replay the journal on top of the main file. ``save``
        compacts journal + main file back into one atomic write.
        """
        path = path or self.path
        assert path, "no path for LatencyDB.flush"
        if not self._dirty_records and not self._dirty_failures:
            return path
        lines = []
        for key in sorted(self._dirty_records):
            rec = self._records.get(key)
            if rec is not None:
                lines.append(json.dumps({"r": dataclasses.asdict(rec)}))
        for key in sorted(self._dirty_failures):
            fail = self._failures.get(key)
            if fail is not None:
                lines.append(json.dumps({"f": dataclasses.asdict(fail)}))
        with _flush_lock(path):
            with open(_journal_path(path), "a") as f:
                f.write("".join(line + "\n" for line in lines))
                f.flush()
                os.fsync(f.fileno())
        self._dirty_records.clear()
        self._dirty_failures.clear()
        return path

    def _replay_journal(self, path: str) -> None:
        """Apply journal lines in append order; damaged tails are dropped."""
        jpath = _journal_path(path)
        try:
            text = open(jpath).read()
        except OSError:
            return
        replayed_recs, replayed_fails = set(), set()
        for line in text.splitlines():
            if not line.strip():
                continue
            try:  # a crash mid-append leaves at most one torn final line
                obj = json.loads(line)
                if "r" in obj:
                    rec = LatencyRecord(**obj["r"])
                    self.add(rec)
                    replayed_recs.add(rec.key())
                elif "f" in obj:
                    fail = ProbeFailure(**obj["f"])
                    self.add_failure(fail)
                    replayed_fails.add(fail.key())
            except Exception:  # noqa: BLE001 - torn/foreign line: skip
                continue
        if replayed_recs or replayed_fails:
            logger.debug("replayed %d journal entries from %s",
                         len(replayed_recs) + len(replayed_fails), jpath)
        # Replayed entries live on disk already — they are not dirty.
        self._dirty_records -= replayed_recs
        self._dirty_failures -= replayed_fails

    def save(self, path: str | None = None, merge_on_disk: bool = True) -> str:
        """Compact to ``path``: read-merge the on-disk state (main file plus
        any journal), write atomically, then drop the journal.

        Concurrent writers (sharded sessions flushing to one DB) are safe:
        the read-merge-write cycle runs under an inter-process lock, the
        merge keeps every other writer's records (:meth:`merge` rules), and
        the write is a unique-temp-file + rename, so an interrupted save
        leaves the previous file intact rather than a truncated one.
        ``merge_on_disk=False`` restores plain overwrite semantics (still
        atomic) for callers that want the file to mirror memory exactly.
        """
        path = path or self.path
        assert path, "no path for LatencyDB.save"
        with _flush_lock(path):
            on_disk = os.path.exists(path) or os.path.exists(_journal_path(path))
            if merge_on_disk and on_disk and not self._disk_unchanged(path):
                try:
                    disk = LatencyDB(path)
                except Exception:  # noqa: BLE001 - salvage, never clobber, a corrupt file
                    disk = LatencyDB.recover(path)
                self.merge(disk)
            dump_json({"saved_at": timestamp(),
                       "records": [dataclasses.asdict(r) for r in self._records.values()],
                       "failures": [dataclasses.asdict(f) for f in self._failures.values()]},
                      path)
            try:
                os.unlink(_journal_path(path))
            except OSError:
                pass
            self._remember_disk_state(path)
        self._dirty_records.clear()
        self._dirty_failures.clear()
        return path

    def _disk_unchanged(self, path: str) -> bool:
        """True when ``path`` still holds exactly what we last wrote/read —
        lets repeated compactions of long sweeps skip re-parsing their own
        output. A pending journal always counts as changed. Checked under
        the flush lock."""
        if os.path.exists(_journal_path(path)):
            return False
        try:
            st = os.stat(path)
        except OSError:
            return False
        return self._disk_state == (path, st.st_mtime_ns, st.st_size)

    def _remember_disk_state(self, path: str) -> None:
        try:
            st = os.stat(path)
            self._disk_state = (path, st.st_mtime_ns, st.st_size)
        except OSError:
            self._disk_state = None

    def load(self, path: str) -> None:
        blob = load_json(path)
        loaded_recs, loaded_fails = set(), set()
        for raw in blob["records"]:
            rec = LatencyRecord(**raw)
            self.add(rec)
            loaded_recs.add(rec.key())
        for raw in blob.get("failures", ()):  # absent in pre-1.1 DB files
            fail = ProbeFailure(**raw)
            self.add_failure(fail)
            loaded_fails.add(fail.key())
        # What came off disk is by definition already persisted.
        self._dirty_records -= loaded_recs
        self._dirty_failures -= loaded_fails
        self._remember_disk_state(path)
        if os.path.exists(_journal_path(path)):
            self._replay_journal(path)

    @classmethod
    def recover(cls, path: str) -> "LatencyDB":
        """Salvage a truncated/corrupt DB file instead of raising.

        A sweep killed mid-``save`` (or a partial copy) leaves a file that
        strict :meth:`load` rejects wholesale. Measurements are expensive, so
        this decodes every complete record object individually and drops only
        the damaged tail. Returns a DB bound to ``path`` (a subsequent
        ``save`` rewrites it whole); on an intact file it is identical to the
        normal constructor.
        """
        db = cls()
        db.path = path
        if not os.path.exists(path):
            db._replay_journal(path)
            return db
        try:
            db.load(path)
            return db
        except Exception:  # noqa: BLE001 - fall through to per-record salvage
            pass
        text = open(path).read()
        decoder = json.JSONDecoder()
        rec_fields = {f.name for f in dataclasses.fields(LatencyRecord)}
        rec_required = rec_fields - {"measured_at", "notes"}
        fail_fields = {f.name for f in dataclasses.fields(ProbeFailure)}
        fail_required = fail_fields - {"failed_at"}
        pos = text.find("{", text.find("{") + 1)  # skip the top-level object
        while pos >= 0:
            try:
                obj, end = decoder.raw_decode(text, pos)
            except json.JSONDecodeError:
                pos = text.find("{", pos + 1)
                continue
            if isinstance(obj, dict):
                keys = set(obj)
                try:  # recovery must never raise on damaged objects
                    if rec_required <= keys <= rec_fields:
                        db.add(LatencyRecord(**obj))
                    elif fail_required <= keys <= fail_fields:
                        db.add_failure(ProbeFailure(**obj))
                except Exception:  # noqa: BLE001 - e.g. wrong value types
                    pass
            pos = text.find("{", max(end, pos + 1))
        db._replay_journal(path)  # journal entries survive main-file damage
        logger.warning("recovered %d records + %d failures from corrupt DB %s",
                       len(db), len(db.failures()), path)
        return db

    # -------------------------------------------------------------- reports
    def table_markdown(self, opt_levels: tuple[str, ...] = ("O3", "O0")) -> str:
        """Table II analog: rows = ops, columns = Optimized / Non-Optimized."""
        by_op: dict[tuple[str, str, str], dict[str, LatencyRecord]] = {}
        for r in self._records.values():
            by_op.setdefault((r.category, r.op, r.dtype), {})[r.opt_level] = r
        rows = []
        for (cat, op, dt), levels in sorted(
                by_op.items(),
                key=lambda kv: (kv[0][0], self._natural(kv[0][1]), kv[0][2])):
            row = [cat, op, dt]
            for lv in opt_levels:
                rec = levels.get(lv)
                if rec is None:
                    row.append("—")
                else:
                    disp = f"±{rec.mad_ns:.1f}" if rec.mad_ns else ""
                    row.append(f"{rec.latency_ns:.1f}{disp}ns ({rec.cycles:.0f}cy)")
            rows.append(row)
        headers = ["category", "op", "dtype"] + [
            {"O3": "Optimized", "O0": "Non-Optimized"}.get(lv, lv) for lv in opt_levels]
        return markdown_table(headers, rows)

    def audit_status(self) -> dict[str, list[LatencyRecord]]:
        """Records grouped by audit verdict status (from the ``audit=``
        notes token; records never audited group under ``unaudited``)."""
        groups: dict[str, list[LatencyRecord]] = {}
        for r in sorted(self._records.values(),
                        key=lambda r: (self._natural(r.op), r.opt_level)):
            tok = parse_kv_notes(r.notes).get("audit", "unaudited")
            groups.setdefault(tok.partition(":")[0], []).append(r)
        return groups

    def audit_markdown(self) -> str:
        """Audit-verdict table surfacing failed and unaudited rows first."""
        order = {"transformed": 0, "opaque": 1, "unaudited": 2, "ok": 3}
        rows = []
        for status, recs in sorted(self.audit_status().items(),
                                   key=lambda kv: order.get(kv[0], 9)):
            for r in recs:
                kv = parse_kv_notes(r.notes)
                tok = kv.get("audit", "unaudited")
                cause = (tok.partition(":")[2] or
                         kv.get("audit_transform", "") or "—")
                rows.append([r.op, r.opt_level, r.dtype, status, cause,
                             f"{r.net_latency_ns:.1f}"])
        return markdown_table(
            ["op", "opt", "dtype", "audit", "cause/transform", "net ns"],
            rows)

    @staticmethod
    def _host_twin(base: str) -> str:
        """The dispatch-level row an in-kernel row pairs with.

        Chain rows pair by name (``inkernel.add`` <-> ``add``); the memory
        rows follow their own naming on each side, so ``inkernel.mem.<N>``
        pairs with the host chase at the same working set,
        ``mem.chase.ws<N>``. Fidelity-suffixed variants fall through
        unchanged, and so stay unpaired: another experiment.
        """
        if base.startswith("mem.") and base[4:].isdigit():
            return f"mem.chase.ws{base[4:]}"
        return base

    def _serving_markdown(self, opt_level: str) -> str:
        """Predicted against measured over the ``serving.*`` rows. Each row
        pairs with itself: the ``ServingCostProbe`` keeps the estimator's
        prediction and coverage in the notes beside the measured time. Rows
        sort by environment, then cell, numerically (b2p64 after b2p16)."""
        rows = []
        recs = sorted(
            (r for r in self._records.values()
             if r.op.startswith("serving.") and r.opt_level == opt_level),
            key=lambda r: (r.device_kind, r.backend, r.jax_version, self._natural(r.op)))
        for r in recs:
            kv = parse_kv_notes(r.notes)
            pred = float(kv.get("predicted_ns", 0.0))
            meas = r.latency_ns
            ratio = f"{pred / meas:.3f}" if meas > 0 else "—"
            rows.append([r.op, kv.get("phase", "—"), kv.get("batch", "—"),
                         kv.get("prompt", "—"), kv.get("model", "—"),
                         f"{pred:.0f}", f"{meas:.0f}", ratio, kv.get("coverage", "—"),
                         kv.get("bound", "—")])
        return markdown_table(
            ["cell", "phase", "batch", "prompt", "model", "predicted (ns)",
             "measured (ns)", "pred/meas", "coverage", "bound"], rows)

    def compare_markdown(self, prefix: str = "inkernel.",
                         opt_level: str = "O3") -> str:
        """Dispatch vs in-kernel: rows measured both ways, side by side.

        Pairs every dispatch-level record with its ``<prefix>``-named twin
        (:meth:`_host_twin`) at the same dtype, opt level **and
        environment**: a DB may hold runs of several devices or builds, and
        a ratio across them would mean nothing. Fidelity-suffixed variants
        (``inkernel.add.l4-32``) are another experiment and are not paired.
        The ratio column is the in-pipeline share of the dispatch-level
        number: the launch and dispatch blur that the paper's in-pipeline
        sampling removes. ``prefix="serving."`` renders the serving cells'
        predicted against measured table instead (:meth:`_serving_markdown`);
        the JAX package's ``coll.`` rendering is not ported yet (its plan is
        not) and raises.
        """
        if prefix == "serving.":
            return self._serving_markdown(opt_level)
        if prefix == "coll.":
            raise NotImplementedError(
                f"compare_markdown(prefix={prefix!r}): the {prefix[:-1]} rows' table is not "
                "ported yet; their plan comes with a later slice (ROADMAP.md)")
        plain: dict[tuple, LatencyRecord] = {}
        inker: dict[tuple, LatencyRecord] = {}
        for r in self._records.values():
            if r.opt_level != opt_level:
                continue
            env = (r.device_kind, r.backend, r.jax_version)
            if r.op.startswith(prefix):
                inker[env + (self._host_twin(r.op[len(prefix):]), r.dtype)] = r
            else:
                plain[env + (r.op, r.dtype)] = r
        rows = []
        for k in sorted(set(plain) & set(inker), key=lambda k: (
                plain[k].category,) + k[:3] + (self._natural(k[3]), k[4])):
            d, ik = plain[k], inker[k]
            ratio = (f"{ik.latency_ns / d.latency_ns:.3f}"
                     if d.latency_ns > 0 else "—")
            rows.append([d.category, k[3], k[4],
                         f"{d.latency_ns:.2f}±{d.mad_ns:.2f}",
                         f"{ik.latency_ns:.2f}±{ik.mad_ns:.2f}", ratio])
        return markdown_table(
            ["category", "op", "dtype", f"dispatch {opt_level} (ns)",
             "in-kernel (ns)", "in-kernel/dispatch"], rows)

    def diff_markdown(self, key_a: str, key_b: str, field: str = "jax_version",
                      opt_level: str = "O3", rel_threshold: float = 0.10) -> str:
        """Table III analog: ops whose latency changed between two versions
        (by default two PyTorch builds, which ``jax_version`` holds here)."""
        a = {(r.op, r.dtype): r for r in self.query(opt_level=opt_level)
             if getattr(r, field) == key_a}
        b = {(r.op, r.dtype): r for r in self.query(opt_level=opt_level)
             if getattr(r, field) == key_b}
        rows = []
        for k in sorted(set(a) & set(b)):
            ra, rb = a[k], b[k]
            if ra.latency_ns <= 0:
                continue
            rel = (rb.latency_ns - ra.latency_ns) / max(ra.latency_ns, 1e-9)
            if abs(rel) >= rel_threshold:
                rows.append([k[0], k[1], f"{ra.latency_ns:.1f}", f"{rb.latency_ns:.1f}",
                             f"{100*rel:+.1f}%"])
        return markdown_table(["op", "dtype", key_a, key_b, "delta"], rows)

    @staticmethod
    def _natural(op: str) -> tuple:
        """Sort key ordering embedded integers numerically, so the memory
        ladder reads ws4096 < ws65536 < ws1048576 instead of lexically."""
        return tuple(int(p) if p.isdigit() else p
                     for p in re.split(r"(\d+)", op))
