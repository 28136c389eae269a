"""Builds ``fastcsv.cpp`` with g++ at first use and binds it with ctypes.

The shared object goes under ``build/gpx_torch_native/<hash>/`` at the
root of the checkout (git-ignored), where the hash covers the source and
the flags, as :mod:`gpx_torch.ops._build` does for the CUDA sources;
nothing is written beside the source. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "fastcsv.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gpx_torch_native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_CACHE: dict = {}


def library_path() -> Path:
    """Where the built library lives for this source and these flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libfastcsv.so"


def _build(so: Path) -> bool:
    """Compile into ``so``; False where there is no g++ or it fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"libfastcsv.{os.getpid()}.tmp.so")
    proc = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    return True


def load_fastcsv():
    """The fastcsv ctypes library, built if needed; None where it cannot
    be built (no g++), and callers then take the pure-Python path."""
    with _LOCK:
        if "fastcsv" in _CACHE:
            return _CACHE["fastcsv"]
        so = library_path()
        lib = None
        if so.exists() or _build(so):
            lib = ctypes.CDLL(str(so))
            lib.gpx_write_csv.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64,
            ]
            lib.gpx_write_csv.restype = ctypes.c_int
            lib.gpx_csv_shape.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            lib.gpx_csv_shape.restype = ctypes.c_int
            lib.gpx_read_csv.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64,
            ]
            lib.gpx_read_csv.restype = ctypes.c_int
        _CACHE["fastcsv"] = lib
        return lib
