"""Builds the CUDA sources under ``gpx_torch/csrc`` at first use.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. All
sources build in parallel, one ``nvcc`` each. The libraries go under
``build/gpx_torch_kernels/<hash>/`` at the root of the checkout, where the
hash covers every file in ``csrc``, so an edited source builds anew.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gpx_torch_kernels"
SOURCES = ("gram", "trmm", "chol_inv_tile", "logml_grad", "logml_probe_grad",
           "matvec")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
LOGS: dict[str, str] = {}  # nvcc's output per source built by this process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all(verbose: bool = False) -> float:
    """Compile every source that is not built yet; returns the seconds it
    took. Raises ``RuntimeError`` with the compiler's output on failure."""
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        target = out_dir / f"lib{name}.so"
        if target.exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
            continue
        if verbose:
            print(f"--- {name}.cu ---\n{log}", flush=True)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(BUILD_ROOT / _source_hash() / f"lib{name}.so"))
        _libs[name] = lib
    return lib


P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_fns: dict[tuple[str, str], object] = {}


def function(lib_name: str, fn_name: str, argtypes: list):
    """A C entry point of ``csrc/<lib_name>.cu`` with its argument types
    declared (every pointer and the stream as ``c_void_p``); it returns
    ``cudaGetLastError()`` as an int."""
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t, name: str, *, ndim: int, device) -> None:
    """Raise unless ``t`` is a float32 tensor on ``device`` with ``ndim``
    dimensions and unit stride along its last one where that has more than
    one entry (a row-major matrix, or a view of one, with a leading
    dimension; numpy's ``x[:, None]`` has stride 0 there)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.numel() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride in its last dimension")
    if ndim == 2 and t.shape[0] > 1 and t.stride(0) < t.shape[1]:
        raise ValueError(f"{name}: leading dimension below its width")
