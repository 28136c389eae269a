"""Chain IO and checkpoints — the port of ``gpx/io.py``.

The reference checkpoints implicitly by streaming parameter CSVs per chain
(``Streaming.writeParallelChain`` -> ``<name>_<i>.csv``,
SimulatedGp.scala:163-165), and downstream stages resume by re-reading them
with burn-in and thinning applied at read time (Temperature.scala:137-141).
The CSV is the format the two packages share: for the same float64 values
the port writes the bytes ``gpx.io.write_chain_csv`` writes, and reads what
it wrote. A checkpoint is the full sampler state (parameters, generator
states, adaptation statistics) saved and restored losslessly; a gpx
checkpoint (a JAX treedef in a pickle) is not readable without JAX.
"""

from __future__ import annotations

import ctypes
import importlib
import math
from pathlib import Path

import numpy as np
import torch

from gpx_torch._device import resolve_device
from gpx_torch._module import FieldModule
from gpx_torch.native import load_fastcsv

_FMT = "%.17g"  # fastcsv.cpp's format: every float64 round-trips


def _host_f64(flat) -> np.ndarray:
    """``flat`` (a tensor on any device, or an array) as a C-contiguous
    float64 host array; a vector becomes one column."""
    if isinstance(flat, torch.Tensor):
        flat = flat.detach().to(device="cpu", dtype=torch.float64).numpy()
    flat = np.ascontiguousarray(np.asarray(flat, dtype=np.float64))
    return flat[:, None] if flat.ndim == 1 else flat


def _format(v: float) -> str:
    """C's ``%.17g`` of one double: glibc prints a NaN whose sign bit is
    set (x86's default NaN) as ``-nan``, Python as ``nan``."""
    s = _FMT % v
    return "-nan" if s == "nan" and math.copysign(1.0, v) < 0 else s


def _write_csv_py(path, flat: np.ndarray, names) -> None:
    """The pure-Python writer: the native writer's bytes."""
    fmt = _format if np.isnan(flat).any() else _FMT.__mod__
    with open(path, "w", newline="") as f:
        f.write(",".join(names) + "\n")
        for row in flat.tolist():
            f.write(",".join(map(fmt, row)) + "\n")


def _read_csv_py(path) -> np.ndarray:
    """The pure-Python reader: every data line that is not empty."""
    with open(path, newline="") as f:
        next(f)
        rows = [[float(v) for v in line.split(",")] for line in f
                if line.strip()]
    return np.asarray(rows, dtype=np.float64)


def write_chain_csv(path, flat, names):
    """One chain -> CSV with a header row. ``flat``: ``(n_draws, dim)``, a
    tensor on any device or an array, written as float64 with ``%.17g``.

    The native C++ writer (``gpx_torch/native/fastcsv.cpp``) where it
    builds, else :func:`_write_csv_py`: the same bytes."""
    flat = _host_f64(flat)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lib = load_fastcsv()
    if lib is None:
        _write_csv_py(path, flat, names)
        return path
    rc = lib.gpx_write_csv(
        str(path).encode(), ",".join(names).encode(),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        flat.shape[0], flat.shape[1])
    if rc != 0:
        raise OSError(f"fastcsv could not write {path} (code {rc})")
    return path


def write_chains_csv(base_path, flat, names):
    """Per-chain files ``<base>_<i>.csv`` — the writeParallelChain layout
    (SimulatedGp.scala:163-165). ``flat``: ``(n_chains, n_draws, dim)``."""
    flat = _host_f64(flat)
    base = Path(base_path)
    return [write_chain_csv(base.with_name(f"{base.stem}_{i}.csv"), chain,
                            names) for i, chain in enumerate(flat)]


def read_chain_csv(path, burn_in: int = 0, thin: int = 1):
    """Read a chain CSV, dropping ``burn_in`` rows and keeping every
    ``thin``-th after them (Temperature.scala:137-141). Returns ``(flat,
    names)``, ``flat`` a float64 host array. Native parser, else
    :func:`_read_csv_py`: bitwise the same values."""
    with open(path, newline="") as f:
        names = f.readline().strip().split(",")
    lib = load_fastcsv()
    if lib is None:
        return _read_csv_py(path)[burn_in::thin], names
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.gpx_csv_shape(str(path).encode(), ctypes.byref(rows),
                           ctypes.byref(cols))
    out = np.empty((max(rows.value, 0), max(cols.value, 0)), np.float64)
    if rc == 0:
        rc = lib.gpx_read_csv(str(path).encode(),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                              rows.value, cols.value)
    if rc != 0:
        raise OSError(f"fastcsv could not read {path} (code {rc})")
    return out[burn_in::thin], names


# -- checkpoints -------------------------------------------------------------
#
# A state is encoded into tensors, Python scalars, strings, lists and dicts
# only, so that torch.load(weights_only=True) reads it back without
# unpickling arbitrary objects. Classes are rebuilt from their import path,
# and only FieldModule subclasses (kernels, means, Parameters,
# distributions) and NamedTuples are.

_TAG = "__gpx_torch__"


def _class_path(cls) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _class(path: str, kind: str):
    module, _, qualname = path.partition(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    ok = isinstance(obj, type) and (
        issubclass(obj, FieldModule) if kind == "module" else
        issubclass(obj, tuple) and hasattr(obj, "_fields"))
    if not ok:
        raise TypeError(f"checkpoint names {path}, not a {kind}")
    return obj


def _encode(node):
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, torch.Generator):
        return {_TAG: "generator", "device": node.device.type,
                "state": node.get_state()}
    if isinstance(node, FieldModule):
        fields = {}
        for name in node._fields:
            value = getattr(node, name)
            if isinstance(value, torch.nn.ModuleList):
                value = tuple(value)
            fields[name] = _encode(value)
        return {_TAG: "module", "class": _class_path(type(node)),
                "fields": fields, "meta": _encode(node._meta())}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {_TAG: "namedtuple", "class": _class_path(type(node)),
                "fields": [_encode(v) for v in node]}
    if isinstance(node, tuple):
        return {_TAG: "tuple", "items": [_encode(v) for v in node]}
    if isinstance(node, list):
        return [_encode(v) for v in node]
    if isinstance(node, dict):
        return {_TAG: "dict", "items": [[_encode(k), _encode(v)]
                                        for k, v in node.items()]}
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _decode(node, device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, list):
        return [_decode(v, device) for v in node]
    if not isinstance(node, dict):
        return node
    kind = node[_TAG]
    if kind == "generator":
        if node["device"] != device.type:
            raise ValueError(f"a {node['device']} generator's state cannot "
                             f"be restored on {device}")
        gen = torch.Generator(device=device)
        gen.set_state(node["state"])
        return gen
    if kind == "module":
        fields = {k: _decode(v, device) for k, v in node["fields"].items()}
        return _class(node["class"], kind)(**fields,
                                           **_decode(node["meta"], device))
    if kind == "namedtuple":
        return _class(node["class"], kind)(*(_decode(v, device)
                                             for v in node["fields"]))
    if kind == "tuple":
        return tuple(_decode(v, device) for v in node["items"])
    if kind == "dict":
        return {_decode(k, device): _decode(v, device)
                for k, v in node["items"]}
    raise ValueError(f"unknown checkpoint entry {kind!r}")


def save_checkpoint(path, state) -> Path:
    """Save a sampler state: nested dicts, lists, tuples and NamedTuples of
    tensors (on any device), ``FieldModule``s (kernels, means,
    ``Parameters``), ``torch.Generator``s and Python scalars."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_encode(state), path)
    return path


def load_checkpoint(path, *, device=None):
    """Restore a state saved by :func:`save_checkpoint`, bitwise, with its
    tensors on ``device`` (default: the card) and its generators rebuilt
    there (a generator only on the kind of device it was saved from).

    ``torch.load`` runs with ``weights_only=True``: the file is read as
    tensors and plain containers, so loading it executes no pickled code;
    classes are rebuilt only if they are ``FieldModule`` subclasses or
    NamedTuples."""
    dev = resolve_device(device)
    blob = torch.load(Path(path), map_location="cpu", weights_only=True)
    return _decode(blob, dev)
