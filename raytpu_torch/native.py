"""ctypes loader of the repo's host BVH builder (``native/rt_native.cpp``).

Counterpart of ``raytpu/native.py``, with its own build: the source is
compiled at first use by ``g++ -O3 -shared -fPIC -std=c++17`` into
``raytpu_torch/build/`` (listed in ``.gitignore``) under a name keyed by a
hash of the source, so an edited source rebuilds.  The JAX package's
``native/_rt_native.so`` is never loaded.

:func:`build_bvh_native` returns None when the library cannot be had (no
``g++``, a failed build, another ABI version); :func:`raytpu_torch.bvh.build_bvh`
then falls back to its numpy median builder, which gives the same arrays
bit for bit, and records which builder ran (``BVH.built_by``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "rt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ABI_VERSION = 2
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
build_error = ""  # why the library could not be had, when it could not


def _build(lib_path: Path) -> bool:
    global build_error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"g++ did not run: {e}"
        return False
    if proc.returncode != 0:
        build_error = f"g++ failed on {SOURCE.name}: {proc.stderr[-2000:]}"
        return False
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    return True


def get_lib():
    """The loaded builder library (building it first if needed), or None."""
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            build_error = f"{SOURCE} is missing"
            return None
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(GXX_FLAGS).encode()).hexdigest()
        lib_path = BUILD_DIR / f"rt_native_{digest[:16]}.so"
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            build_error = f"cannot load {lib_path}: {e}"
            return None
        if lib.rt_native_abi_version() != ABI_VERSION:
            build_error = (f"{lib_path} has ABI {lib.rt_native_abi_version()}"
                           f", want {ABI_VERSION}")
            return None
        argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        for fn in (lib.rt_build_bvh, lib.rt_build_bvh_sah):
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def build_bvh_native(centers: np.ndarray, radii: np.ndarray,
                     leaf_size: int, pad: float, sah: bool = False):
    """Native BVH build -> (nodes (m, 9) f32, perm (n,) f32), or None when
    the library cannot be had.  ``sah=True`` takes the binned
    surface-area-heuristic builder; the default median builder is the one
    the numpy fallback mirrors bit for bit."""
    lib = get_lib()
    if lib is None:
        return None
    centers = np.ascontiguousarray(centers, np.float64)
    radii = np.ascontiguousarray(radii, np.float64)
    n = len(radii)
    nodes = np.empty((max(2 * n - 1, 1), 9), np.float32)
    perm = np.empty((n,), np.float32)
    fn = lib.rt_build_bvh_sah if sah else lib.rt_build_bvh
    m = fn(centers, radii, n, int(leaf_size), float(pad), nodes.reshape(-1),
           perm)
    if m <= 0:
        return None
    return nodes[:m].copy(), perm
