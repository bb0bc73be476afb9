"""Small shared utilities (the port's own copies of ``repro.utils``' helpers).

``repro.utils`` imports jax when it loads, so nothing is imported from it:
the pure-Python helpers are written out again here, and ``block`` waits for
the CUDA device instead of a jax array.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import tempfile
import time
from typing import Any, Iterable

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[repro_torch %(levelname)s %(asctime)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("REPRO_LOGLEVEL", "INFO"))


def _leaves(tree: Any) -> Iterable[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def block(tree: Any) -> Any:
    """Wait until the work producing every tensor in ``tree`` is done.

    PyTorch returns from a CUDA call before the card finishes, so each CUDA
    device holding a tensor of ``tree`` is synchronized; CPU tensors are
    complete on return. Returns ``tree``.
    """
    devices = {t.device for t in _leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


def from_numpy(tree: Any, device: str | torch.device) -> Any:
    """Copy every numpy array (or numpy scalar) in ``tree`` to a tensor on
    ``device``, keeping dtype and values bit for bit. The tests hand the same
    numpy inputs to the JAX package and to the port through this."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


class _JsonEncoder(json.JSONEncoder):
    def default(self, o: Any) -> Any:  # noqa: D102
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return dataclasses.asdict(o)
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


def dump_json(obj: Any, path: str) -> None:
    """Atomically serialize ``obj`` to ``path``.

    The temp file is uniquely named and renamed over the target only after a
    successful write + fsync, so a crash mid-write leaves the previous file
    intact and no truncated JSON is ever observable at ``path``.
    """
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2, cls=_JsonEncoder)
            f.flush()
            os.fsync(f.fileno())
        # mkstemp creates 0600; restore the mode a plain open() would give
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}EiB"


def human_flops(n: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P", "E"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}FLOP"
        n /= 1000.0
    return f"{n:.2f}ZFLOP"


def timestamp() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S")


def parse_kv_notes(notes: str) -> dict[str, str]:
    """Parse the space-separated ``key=value`` convention of record notes.
    Free-text fragments without ``=`` are ignored."""
    out: dict[str, str] = {}
    for tok in notes.split():
        if "=" in tok:
            k, _, v = tok.partition("=")
            if k:
                out[k] = v
    return out


def percentiles(samples: Iterable[float],
                ps: Iterable[float] = (50, 90, 99)) -> dict[float, float]:
    """Exact-rank (nearest-rank) percentiles of ``samples``: the value for
    ``p`` is ``sorted(xs)[ceil(p/100 * n) - 1]`` (``p == 0`` gives the
    minimum), always an actual sample."""
    xs = sorted(float(s) for s in samples)
    if not xs:
        raise ValueError("percentiles() of empty sample set")
    out: dict[float, float] = {}
    for p in ps:
        p = float(p)
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        rank = math.ceil(p / 100.0 * len(xs))
        out[p] = xs[max(rank, 1) - 1]
    return out


def markdown_table(headers: Iterable[str], rows: Iterable[Iterable[Any]]) -> str:
    headers = list(headers)
    lines = ["| " + " | ".join(str(h) for h in headers) + " |",
             "|" + "|".join("---" for _ in headers) + "|"]
    for row in rows:
        lines.append("| " + " | ".join(str(c) for c in row) + " |")
    return "\n".join(lines)
