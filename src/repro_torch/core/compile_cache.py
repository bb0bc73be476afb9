"""Persistent compile cache for the port's O3 chains.

The counterpart of ``repro.core.compile_cache``. There an entry holds a
serialized XLA executable; here the executable of an O3 chain is what
Inductor generated, and Inductor persists it itself: its FX graph cache,
its AOTAutograd cache and Triton's kernels live on disk and are keyed by
the graph, the options and the versions. So a :class:`CompileCache` is a
directory that holds two things:

* ``<root>/inductor/``: Inductor's own cache directory
  (``TORCHINDUCTOR_CACHE_DIR``), with Triton's kernels under
  ``inductor/triton`` (``TRITON_CACHE_DIR``).
  :meth:`CompileCache.use` points this process there, and
  :func:`use_dirs` a spawned compile worker before it compiles (the
  session hands the pool :meth:`CompileCache.environ`, which also names
  the root, ``ROOT_ENV``, so that the worker's compiles go through the
  cache and store their entries). Inductor's key
  must come out equal in every process that shares the directory
  (``optlevels.stable_cache_keys``; TF32 by masking, never through
  ``allow_tf32``).
* one entry file per key (``<sha256>.xc``, JSON), holding what the audit
  reads of that chain (``audit.artifacts.read_modules``' fields: its Triton
  kernels' PTX, the carry's parameter, the SASS mnemonic counts, the
  cubins), the wrapper module Inductor compiled it into (its key and its
  path under ``inductor/``) and the chain's result on its own inputs. It
  plays the part of the JAX package's ``hlo_extra`` sidecar (``audit
  --compile-cache DIR`` reads a chain's device code from it without
  compiling) and of its serialized executable: ``measure.load_chain`` runs
  the chain from that module (``measure.compiled_module``), with no trace
  and no compile, once the module's result on the chain's inputs equals
  the one kept. Loading the chain through ``torch.compile`` instead
  (Inductor's own cache hit) traces it through Dynamo and AOTAutograd again,
  1-5 s a 512-op chain on a loaded host (PERF.md section 5).

Keys are the JAX package's: ``(device_kind, backend, jax_version, op,
opt_level, dtype, fidelity)`` (:func:`fidelity_key`); the port's
``jax_version`` field holds the torch build (``torch-2.11.0+cu12.8``),
``fidelity`` the chain length (``chain512``).

A lookup is a **hit** when its entry file reads back *and* nothing is
compiled for it, in this process or in the compile worker that did it:
the chain runs from the module the entry names (:meth:`served`), or,
where it has none, its ``torch.compile`` was an Inductor cache hit by
Inductor's own counters (``fxgraph_cache_hit`` or ``autograd_cache_hit``,
and no ``fxgraph_cache_miss``). Anything else compiled, counts as a miss
and stores the entry anew. A corrupt or foreign
entry counts as a miss and one error. Entries are written atomically (a
temp file, then ``os.replace``). Eviction keeps at most ``max_entries``
entry files, oldest mtime first (a read touches the file: LRU-ish); it
removes entry files only. Inductor's directories are Inductor's, kept as
they are: a chain whose entry was evicted compiles again on its next
lookup (most likely an Inductor hit, still counted as a miss) and gets its
entry back. K1-K7 are not cached here: their nvcc build under
``build/repro_torch_kernels/<hash>/`` is content-keyed already.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from typing import Any, Callable, Mapping

from repro_torch.utils import logger

# Bump when the entry layout changes: old-format files then miss instead of
# being read into the new shape.
_FORMAT = 1
_SUFFIX = ".xc"
# the cache's root, in a compile worker of a pool that serves it
ROOT_ENV = "REPRO_TORCH_COMPILE_CACHE"


@dataclasses.dataclass
class CacheStats:
    """Counters surfaced in ``ResultSet.summary()``."""

    hits: int = 0
    misses: int = 0   # lookups that had to compile (and stored their entry)
    stores: int = 0
    evictions: int = 0
    errors: int = 0   # entries that failed to read (treated as a miss)


# Triton's compiles in this process, by whether its cache served them, once
# count_triton_compiles has installed its listener (None before)
_TRITON: dict[str, int] | None = None


def count_triton_compiles() -> None:
    """Count Triton's own compiles in this process from now on, each a hit or
    a miss of Triton's cache, through its compilation listener
    (``triton.knobs.compilation.listener``, which Triton calls with
    ``cache_hit``); a listener already there still runs. A no-op without
    Triton or without the listener."""
    global _TRITON
    try:
        from triton import knobs
    except Exception:  # noqa: BLE001 - no Triton here (the CPU)
        return
    comp = getattr(knobs, "compilation", None)
    if comp is None or not hasattr(comp, "listener") or _TRITON is not None:
        return
    previous = comp.listener
    _TRITON = {"compile_cache_hit": 0, "compile_cache_miss": 0}

    def listener(**kw):
        _TRITON["compile_cache_hit" if kw.get("cache_hit") else "compile_cache_miss"] += 1
        if previous is not None:
            previous(**kw)

    comp.listener = listener


def inductor_counts() -> dict[str, int]:
    """Inductor's and AOTAutograd's cache counters in this process, and
    Triton's compiles where :func:`count_triton_compiles` counts them."""
    from torch._dynamo.utils import counters
    out = {**{f"inductor.{k}": int(v) for k, v in counters["inductor"].items()},
           **{f"aot_autograd.{k}": int(v) for k, v in counters["aot_autograd"].items()}}
    if _TRITON is not None:
        out.update({f"triton.{k}": v for k, v in _TRITON.items()})
    return out


def inductor_hit(before: Mapping[str, int], after: Mapping[str, int]) -> bool:
    """Whether what ran between two :func:`inductor_counts` was served from
    Inductor's cache: a graph or AOTAutograd cache hit, and no graph miss."""
    def moved(k: str) -> int:
        return after.get(k, 0) - before.get(k, 0)
    return (moved("inductor.fxgraph_cache_miss") == 0
            and (moved("inductor.fxgraph_cache_hit") > 0
                 or moved("aot_autograd.autograd_cache_hit") > 0))


def use_dirs(environ: Mapping[str, str]) -> None:
    """Point this process's Inductor and Triton caches at ``environ``'s
    directories (:meth:`CompileCache.environ`) and count Triton's compiles;
    a spawned compile worker's initializer."""
    os.environ.update(environ)
    count_triton_compiles()


class CompileCache:
    """Inductor's cache directories plus one audit entry per key; see the
    module docstring. Counters and eviction run under a lock; entry files
    are written atomically."""

    def __init__(self, root: str, max_entries: int = 1024):
        self.root = os.path.abspath(root)
        self.max_entries = int(max_entries)
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._noted: set[tuple] = set()
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------- Inductor
    def environ(self) -> dict[str, str]:
        """The environment variables that put Inductor's and Triton's caches
        under :attr:`root` (one Triton directory for every card: Triton's
        key holds the target)."""
        inductor = os.path.join(self.root, "inductor")
        return {ROOT_ENV: self.root, "TORCHINDUCTOR_CACHE_DIR": inductor,
                "TRITON_CACHE_DIR": os.path.join(inductor, "triton")}

    def use(self) -> None:
        """Point this process's Inductor and Triton caches here (and count
        Triton's compiles)."""
        use_dirs(self.environ())

    # ------------------------------------------------------------------ keys
    def entry_path(self, key: tuple) -> str:
        digest = hashlib.sha256(repr((_FORMAT,) + tuple(key)).encode()).hexdigest()
        return os.path.join(self.root, digest + _SUFFIX)

    # ------------------------------------------------------------------- api
    def load(self, key: tuple) -> dict | None:
        """The entry stored under ``key`` (its ``extra``, the audit's
        fields), or None on a miss; an unreadable or foreign entry is None
        and one error. A read touches the file (eviction order)."""
        path = self.entry_path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                entry = json.load(f)
            if entry.get("format") != _FORMAT or tuple(entry.get("key", ())) != tuple(key):
                raise ValueError("foreign entry")
            os.utime(path)
        except Exception as e:  # noqa: BLE001 - stale/foreign entry: recompile
            with self._lock:
                self.stats.errors += 1
            logger.debug("compile cache entry %s unreadable (%s); recompiling",
                         path, type(e).__name__)
            return None
        return entry["extra"]

    def peek_extra(self, key: tuple) -> Any:
        """The ``extra`` stored under ``key``, or None; counts no hit (what
        ``audit --compile-cache`` reads)."""
        return self.load(key)

    def store(self, key: tuple, extra: Any) -> bool:
        """Write ``extra`` (JSON) under ``key`` atomically; False when it
        cannot be serialized."""
        try:
            payload = json.dumps({"format": _FORMAT, "key": list(key),
                                  "extra": {} if extra is None else extra})
        except (TypeError, ValueError) as e:
            with self._lock:
                self.stats.errors += 1
            logger.debug("compile cache cannot serialize %s: %s", key, e)
            return False
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self.entry_path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self.stats.stores += 1
        self._evict()
        return True

    def discard(self, key: tuple) -> None:
        """Remove the entry under ``key`` (one found stale)."""
        try:
            os.unlink(self.entry_path(key))
        except OSError:
            pass

    def note(self, key: tuple, hit: bool) -> None:
        """Count a lookup made for this cache in another process (a compile
        worker): the next :meth:`load_or_compile` of ``key`` here only
        builds (a load of what that worker left) and counts nothing."""
        with self._lock:
            if hit:
                self.stats.hits += 1
            else:
                self.stats.misses += 1
            self._noted.add(tuple(key))

    def served(self, key: tuple, entry_read: bool) -> bool:
        """Count a lookup whose chain ran from the compiled module that its
        entry (``entry_read``) or a compile worker of this run named, with
        nothing compiled here: a hit where the entry was read, else a miss
        (the caller stores the entry); nothing where the worker counted it
        (:meth:`note`). Returns whether it was a hit."""
        with self._lock:
            if tuple(key) in self._noted:
                self._noted.discard(tuple(key))
                return entry_read
            if entry_read:
                self.stats.hits += 1
            else:
                self.stats.misses += 1
            return entry_read

    def load_or_compile(self, key: tuple, build: Callable[[], Any],
                        extra: Callable[[Any], Any] | None = None
                        ) -> tuple[Any, Any, bool]:
        """``(built, extra, was_hit)``: read the entry, run ``build()`` (the
        chain's compile and first call), and count a hit when the entry read
        back and Inductor served the compile from its cache; else count a
        miss and store ``extra(built)``."""
        with self._lock:
            noted = tuple(key) in self._noted
            self._noted.discard(tuple(key))
        entry = self.load(key)
        before = inductor_counts()
        built = build()
        hit = entry is not None and inductor_hit(before, inductor_counts())
        if noted:
            return built, entry, hit
        if hit:
            with self._lock:
                self.stats.hits += 1
            return built, entry, True
        with self._lock:
            self.stats.misses += 1
        side = extra(built) if extra is not None else None
        self.store(key, side)
        return built, side, False

    # ------------------------------------------------------------- lifecycle
    def entries(self) -> list[str]:
        try:
            return [os.path.join(self.root, n) for n in os.listdir(self.root)
                    if n.endswith(_SUFFIX)]
        except OSError:
            return []

    def _evict(self) -> None:
        with self._lock:
            paths = self.entries()
            if len(paths) <= self.max_entries:
                return

            def mtime(p: str) -> float:
                try:
                    return os.stat(p).st_mtime
                except OSError:
                    return 0.0
            paths.sort(key=mtime)
            for p in paths[: len(paths) - self.max_entries]:
                try:
                    os.unlink(p)
                    self.stats.evictions += 1
                except OSError:
                    pass

    def clear(self) -> None:
        """Remove every entry file (Inductor's directories stay)."""
        for p in self.entries():
            try:
                os.unlink(p)
            except OSError:
                pass

    def __len__(self) -> int:
        return len(self.entries())

    def __repr__(self) -> str:
        return (f"CompileCache({self.root!r}, entries={len(self)}, "
                f"hits={self.stats.hits}, misses={self.stats.misses})")


def fidelity_key(env: Mapping[str, str], op: str, opt_level: str, dtype: str,
                 fidelity: str) -> tuple:
    """Cache key layout: the DB record key plus a fidelity tail."""
    return (env["device_kind"], env["backend"], env["jax_version"],
            op, opt_level, dtype, fidelity)
