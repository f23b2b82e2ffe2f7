"""Build and load the package's CUDA sources at first use.

Each ``.cu`` file under ``raytpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``.  The library lands in ``raytpu_torch/build/`` (listed
in ``.gitignore``) under a name keyed by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source, header or flag
rebuilds and an unchanged one is reused.  :func:`load_all` builds several
sources at once, one ``nvcc`` each.  Nothing here runs at import time:
importing the package needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# -fmad=false: no multiply-add contraction, so the kernel rounds every f32
# operation as the plain PyTorch version does (the ground sphere's
# discriminant is a catastrophic cancellation).  No --use_fast_math: the
# root test needs sqrtf(negative) = NaN and IEEE division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}  # one per source: builds run in parallel
_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}  # source name -> {"seconds", "ptxas", "path"}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _headers_bytes() -> bytes:
    """Every header under ``csrc/``, in name order: a source that includes
    one must rebuild when it changes, so the build key hashes them all."""
    return b"".join(h.name.encode() + h.read_bytes()
                    for h in sorted(CSRC.glob("*.cuh")))


def load(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``, building it first
    if no library for this exact source and these flags exists."""
    with _lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _loaded:
            return _loaded[source]
        src = CSRC / source
        digest = hashlib.sha256(src.read_bytes() + _headers_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        lib_path = BUILD_DIR / f"{src.stem}_{digest[:16]}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
            build_log[source] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": [ln.strip() for ln in proc.stderr.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "entry function" in ln],
                "path": str(lib_path)}
        else:
            build_log.setdefault(source, {"seconds": 0.0, "ptxas": [],
                                          "path": str(lib_path)})
        lib = ctypes.CDLL(str(lib_path))
        _loaded[source] = lib
        return lib


def load_all(sources) -> None:
    """Build (or find) every source in ``sources`` at once: one ``nvcc`` per
    source, all started together, so a cold start waits for the slowest."""
    errors = []

    def one(src):
        try:
            load(src)
        except Exception as e:  # reported below, after every build ended
            errors.append(e)

    threads = [threading.Thread(target=one, args=(s,)) for s in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
