"""The in-tree dense registration engine (C++, bound with ctypes); port of
``dvd_tpu/native``.

LD and AD, the reference's distortion metrics, register the rectified
page to its scan with the external SIFTflow toolbox inside MATLAB
(``matlab_code/run_benchmark.m:20-44``).  ``src/siftflow.cpp``, a copy of
``dvd_tpu``'s byte for byte, is a dense-descriptor coarse-to-fine engine
in its place, built at first use with the system ``g++`` (OpenMP) into
``dvd_tpu_torch/_build/`` (git-ignored) under a name that hashes the
source and the flags.  The build runs under a file lock and writes a
temporary file that is renamed into place, so concurrent processes never
load a half-written library.  A failed build leaves :func:`available`
false and keeps the compiler's error (:func:`build_error`).

- :func:`available` -- True if the library could be built and loaded;
- :func:`sift_flow` -- dense flow im1 -> im2, (H, W, 2) float32;
- :func:`build_info` -- the library's path and the seconds its build took
  in this process (0 when it was already built).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "siftflow.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# -ffp-contract=off pins FMA contraction so the flow field is reproducible
# across hosts and compilers (its LD/AD feed the calibrated error bounds)
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
         "-fopenmp", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_info = {"path": None, "build_seconds": 0.0}


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"siftflow-{h.hexdigest()[:16]}" / "_siftflow.so"


def _build(path: Path) -> Optional[str]:
    """Compile ``path`` unless it exists, under a lock shared by every
    process; returns an error string on failure."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():            # another process built it meanwhile
            return None
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        cmd = ["g++", *FLAGS, str(SRC), "-o", tmp]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:   # no g++, etc.
            os.unlink(tmp)
            return f"{type(e).__name__}: {e}"
        if proc.returncode != 0:
            os.unlink(tmp)
            return proc.stderr[-2000:]
        os.replace(tmp, path)
        _info["build_seconds"] = time.perf_counter() - t0
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build_error = _build(path)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = str(e)
            return None
        lib.sift_flow.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ]
        lib.sift_flow.restype = None
        _info["path"] = str(path)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def build_info() -> dict:
    """{"path": the loaded library, "build_seconds": this process's build
    time, 0.0 if the library was there}; builds it if needed."""
    _load()
    return dict(_info)


def sift_flow(im1: np.ndarray, im2: np.ndarray, *, coarse_radius: int = 8,
              alpha: float = 0.02, n_threads: int = 0) -> np.ndarray:
    """Dense registration flow im1 -> im2.

    im1/im2: (H, W) grayscale, any float/uint dtype, value range [0, 255].
    Returns (H, W, 2) float32 with ``flow[..., 0] = dx``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native siftflow unavailable: {_build_error}")
    if im1.shape != im2.shape or im1.ndim != 2:
        raise ValueError(f"bad shapes {im1.shape} vs {im2.shape}")
    h, w = im1.shape
    a = np.ascontiguousarray(im1, np.float32)
    b = np.ascontiguousarray(im2, np.float32)
    out = np.empty((h, w, 2), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.sift_flow(
        a.ctypes.data_as(fp), b.ctypes.data_as(fp), h, w,
        out.ctypes.data_as(fp), coarse_radius, alpha, n_threads,
    )
    return out
