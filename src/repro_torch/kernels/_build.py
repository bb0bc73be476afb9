"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library of its
own with a plain C interface (no PyTorch headers, so a build takes seconds),
under ``build/repro_torch_kernels/<hash of the sources and flags>/`` at the
root of the checkout. All sources are compiled together, one ``nvcc`` each,
the first time any kernel is asked for; a build directory appears only
complete (it is built under a temporary name and renamed), so concurrent
processes never load half a build. Each library keeps its PTX beside the
SASS (``code=compute_90a``), which the audit reads with ``cuobjdump -ptx``.
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("alu_chain", "op_chain", "op_chain_timed", "chase", "rmsnorm",
           "flash_attention", "flash_decode", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a",
              "-gencode", "arch=compute_90a,code=compute_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin "
                       "(default /usr/local/cuda); the CUDA kernels cannot be built")


def build_dir() -> Path:
    """Where the current sources build: keyed by their content and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every kernel library (in parallel) unless this build exists;
    returns the build directory. ``build.log`` there keeps each nvcc's
    output, ptxas's register and spill report included, and the seconds
    from the start of the build until that nvcc ended."""
    final = build_dir()
    if all((final / f"lib{k}.so").exists() for k in KERNELS):
        return final
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=final.name + ".tmp-", dir=final.parent))
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp / f"lib{k}.so"), str(CSRC / f"{k}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in KERNELS}
    ended: dict[str, tuple[str, float]] = {}

    def wait(k: str) -> None:  # a thread per nvcc drains its pipe and notes its end
        out, _ = procs[k].communicate()
        ended[k] = (out, time.perf_counter() - t0)

    threads = [threading.Thread(target=wait, args=(k,)) for k in KERNELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    log, failed = [], []
    for k, p in procs.items():
        out, seconds = ended[k]
        log.append(f"== {k}.cu (rc {p.returncode}, {seconds:.1f} s)\n{out}")
        if p.returncode:
            failed.append(k)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}; log in "
                           f"{tmp / 'build.log'}:\n" + "\n".join(log))
    try:
        os.rename(tmp, final)
    except OSError:  # another process finished the same build first
        if not all((final / f"lib{k}.so").exists() for k in KERNELS):
            raise
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first if
    this build does not exist yet."""
    with _lock:
        if name not in _libs:
            if name not in KERNELS:
                raise ValueError(f"unknown kernel {name!r}; have {KERNELS}")
            lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check_launch(lib: ctypes.CDLL, kernel: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{kernel}: kernel launch failed: CUDA error {err} ({msg})")
