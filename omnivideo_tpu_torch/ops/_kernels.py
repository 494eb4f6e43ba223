"""Build and load the port's CUDA kernels (csrc/*.cu → one shared library).

The sources have a plain C interface, so they compile in seconds with nvcc
and load with ctypes — no PyTorch headers, no torch.utils.cpp_extension.
Each source compiles to its own object in parallel (one nvcc per file,
started together), then one nvcc links the shared library. The library sits
under `build/kernels/<hash of the sources and flags>/` in the checkout and
is rebuilt only when a source changes.

Nothing here runs at import time: the first kernel launch builds and loads.
Every C entry point returns its cudaGetLastError() code; `check` raises on a
non-zero code, so a launch refused for its shared memory or grid is never
silent. A kernel's output has no autograd history: `check_no_grad` makes a
wrapper without a backward raise rather than drop a gradient.
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
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("qk_prep.cu", "flash_fwd.cu", "flash_train.cu", "adaln.cu")
HEADERS = ("flash_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libomnivideo_kernels.so"

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float

# argtypes of every C entry point (pointers and the stream as c_void_p so
# ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "qk_prep_tiles": [_c_int],
    "qk_prep_launch": [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                       _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
                       _c_int, _c_float, _c_void_p],
    "flash_fwd_launch": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                         _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
                         _c_int, _c_int, _c_int, _c_int, _c_float, _c_void_p],
    "flash_fwd_lse_launch": [_c_void_p] * 6 + [_c_int] * 5 + [_c_float, _c_void_p],
    "flash_bwd_dq_launch": [_c_void_p] * 8 + [_c_int] * 5 + [_c_float, _c_void_p],
    "flash_bwd_dkv_launch": [_c_void_p] * 9 + [_c_int] * 5 + [_c_float, _c_void_p],
    "adaln_max_dim": [],
    "adaln_launch": [_c_void_p] * 9 + [_c_int] * 5 + [_c_float, _c_void_p],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
build_log: str = ""  # nvcc's output (-Xptxas -v: registers, smem, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    global build_seconds, build_log
    nvcc = _nvcc()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = tmp / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib = tmp / LIB_NAME
    cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
           *(str(o) for _, o, _ in procs), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    try:
        tmp.rename(out_dir)  # atomic publish: a half-built dir is never loaded
    except OSError:  # another process published the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return out_dir / LIB_NAME


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _digest()
            path = out_dir / LIB_NAME
            if not path.exists():
                path = _build(out_dir)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def check_no_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would cut the autograd graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward, and an input requires "
                           "grad; train through ops.flash_attention.flash_attention_train")
