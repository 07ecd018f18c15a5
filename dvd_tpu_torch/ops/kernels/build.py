"""Build and load the hand-written Hopper kernels (``dvd_tpu_torch/csrc``).

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``: a few seconds
to build, against minutes for an extension that includes PyTorch's
headers.  The library is built at first use into ``dvd_tpu_torch/_build/``
(listed in ``.gitignore``), in a directory named by a hash of the sources
and the command, so a checkout builds everything it needs from its own
sources and a changed source is never served a stale library.

Nothing here runs at import time: the CPU tests import every module on
machines that have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("attention.cu", "conv3x3.cu", "grid_sample.cu", "gather_probe.cu")
HEADERS = ("common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
LIB_NAME = "libdvd_kernels.so"

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "dvd_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                          _F, _I, _P],
    "dvd_conv3x3": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dvd_gather_bilinear": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _P],
    "dvd_gather_bilinear_grad": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _L, _L, _I, _P],
    "dvd_gather2d": [_P, _P, _P, _P, _I, _I, _L, _P],
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_log: str        # nvcc's output, including -Xptxas -v
    build_seconds: float  # 0.0 when an earlier build was reused


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def nvcc_command(out: Path, nvcc: str = "nvcc",
                 sources: Sequence[str] = SOURCES) -> List[str]:
    """The full nvcc command line for the kernel library."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC_DIR),
            "-o", str(out), *(str(CSRC_DIR / s) for s in sources)]


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(nvcc_command(Path(LIB_NAME))[1:]).encode())
    return h.hexdigest()[:16]


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dvd_error_string.argtypes = [_I]
    lib.dvd_error_string.restype = ctypes.c_char_p
    lib.dvd_attention_smem_bytes.argtypes = [_I]
    lib.dvd_conv3x3_smem_bytes.argtypes = [_I, _I]
    for fn in (lib.dvd_attention_smem_bytes, lib.dvd_conv3x3_smem_bytes):
        fn.restype = _L
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    out_dir = BUILD_DIR / source_hash()
    path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return KernelLibrary(_bind(path), path, log, 0.0)
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = nvcc_command(Path(tmp), nvcc=find_nvcc())
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, path)
    return KernelLibrary(_bind(path), path, log, seconds)


def check_launch(kl: KernelLibrary, err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = kl.lib.dvd_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream, as a raw pointer.  The kernels launch on
    the current device, so ``t`` must lie on it."""
    if t.get_device() != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream
