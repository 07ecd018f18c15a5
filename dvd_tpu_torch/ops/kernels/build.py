"""Build and load the hand-written Hopper kernels (``dvd_tpu_torch/csrc``).

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``: seconds to
build, against minutes for an extension that includes PyTorch's headers.
Each source compiles in its own ``nvcc`` process, all started together,
and one more links the objects.  The library is built at first use into
``dvd_tpu_torch/_build/``
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("attention_f32x6.cu", "attention_wgmma.cu", "conv3x3_f32x6.cu",
           "conv3x3_wgmma.cu", "grid_sample.cu", "unwarp.cu", "gather_probe.cu",
           "adaln.cu")
HEADERS = ("common.cuh", "hopper.cuh", "attention.cuh", "conv3x3.cuh",
           "bilinear.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LIB_NAME = "libdvd_kernels.so"

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# K1's two entries (f32 through the split products, bf16 through wgmma)
# share one argument list: pointers, B, H, Tq, Tk, Dh, (b, h, t) strides of
# q, k, v and o, scale, dtype code, stream
_ATTENTION = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
              _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P]
# K2's two entries (f32, bf16): x, wk, scale, bias, out, B, Cin, Cout, H, W,
# dilation, relu, stream; and their planners: B, Cin, Cout, H, W, dilation,
# the plan's output array
_CONV3X3 = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_CONV3X3_PLAN = [_I, _I, _I, _I, _I, _I, _P]
# C entry points: name -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "dvd_attention_fwd_f32x6": _ATTENTION,
    "dvd_attention_fwd_wgmma": _ATTENTION,
    "dvd_conv3x3_f32x6": _CONV3X3,
    "dvd_conv3x3_f32x6_plan": _CONV3X3_PLAN,
    "dvd_conv3x3_wgmma": _CONV3X3,
    "dvd_conv3x3_wgmma_plan": _CONV3X3_PLAN,
    "dvd_gather_bilinear": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I,
                            _I, _P],
    "dvd_gather_bilinear_plan": [_I, _I, _L, _P],
    "dvd_gather_bilinear_grad": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I,
                                 _I, _P],
    "dvd_unwarp": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                   _P],
    "dvd_gather2d": [_P, _P, _P, _P, _I, _I, _L, _P],
    # x, shift, scale, out, rows, tokens, D, shift and scale row strides,
    # eps, dtype code, stream
    "dvd_ln_modulate": [_P, _P, _P, _P, _L, _I, _I, _L, _L, _F, _I, _P],
    # x, gate, y, out, N, tokens, D, gate row stride, dtype code, stream
    "dvd_gate_residual": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _P],
    "dvd_last_error": [],
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_log: str        # nvcc's output, including -Xptxas -v
    build_seconds: float  # 0.0 when an earlier build was reused
    source_seconds: Dict[str, float]  # each source's nvcc; empty if reused


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


def compile_command(source: str, obj: Path, nvcc: str = "nvcc") -> List[str]:
    """nvcc for one source of ``csrc`` into a position-independent object."""
    return [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC_DIR), "-o", str(obj),
            str(CSRC_DIR / source)]


def link_command(out: Path, objects: Sequence[Path],
                 nvcc: str = "nvcc") -> List[str]:
    """nvcc linking the objects into the shared library ``out``."""
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
            *(str(o) for o in objects)]


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + ("-shared",)).encode())
    return h.hexdigest()[:16]


def _run(cmd: List[str]):
    """(return code, output, seconds) of one nvcc command."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dvd_error_string.argtypes = [_I]
    lib.dvd_error_string.restype = ctypes.c_char_p
    for fn in (lib.dvd_attention_f32x6_smem_bytes,
               lib.dvd_attention_wgmma_smem_bytes):
        fn.argtypes = [_I]
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
        return KernelLibrary(_bind(path), path, log, 0.0, {})
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    # build in a temporary directory, then rename the library into place:
    # concurrent builds never load a half-written one
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objects = [Path(tmp) / f"{Path(s).stem}.o" for s in SOURCES]
        cmds = [compile_command(s, o, nvcc) for s, o in zip(SOURCES, objects)]
        cmds.append(link_command(Path(tmp) / LIB_NAME, objects, nvcc))
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            runs = list(pool.map(_run, cmds[:-1]))
        if all(rc == 0 for rc, _, _ in runs):
            runs.append(_run(cmds[-1]))
        for cmd, (rc, out, _) in zip(cmds, runs):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
        log = "".join(out for _, out, _ in runs)
        log_path.write_text(log)
        os.replace(Path(tmp) / LIB_NAME, path)
    return KernelLibrary(_bind(path), path, log, time.perf_counter() - t0,
                         {s: r[2] for s, r in zip(SOURCES, runs)})


def check_launch(kl: KernelLibrary, err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = kl.lib.dvd_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream, as a raw pointer (read without building a
    ``torch.cuda.Stream`` object: this is on every launch's host path).
    The kernels launch on the current device, so ``t`` must lie on it."""
    dev = t.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch._C._cuda_getCurrentRawStream(dev)
