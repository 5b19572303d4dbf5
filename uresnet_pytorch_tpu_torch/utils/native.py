"""ctypes binding for the port's native host data backend
(`uresnet_native.cpp` beside this file, a copy of the reference's
`csrc/uresnet_native.cpp`): collation of CSR events into padded blobs,
voxel dedup and key encoding.

Port of `uresnet_pytorch_tpu/utils/native.py`. The library builds with g++
on first use into `build/torch_native/lib<sha>.so`, named by the hash of
the source and the flags, so an edited source rebuilds; the build writes a
temporary file and renames it, so concurrent first uses do not race. This
is host code: where g++ or the build fails, `available()` is false and the
loader takes its NumPy collate (`iotools/io_base.py`), with identical
results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("uresnet_native.cpp")
_LIB_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _LIB_DIR / f"lib{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = library_path()
        if not path.exists() and not _build(path):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.upt_encode_keys.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                        ctypes.c_int32, i32p, i64p]
        lib.upt_collate.restype = ctypes.c_int32
        lib.upt_collate.argtypes = [
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
            i32p, f32p, f32p, f32p, i64p,
            i32p, f32p, i32p, f32p, i32p]
        lib.upt_dedup.restype = ctypes.c_int64
        lib.upt_dedup.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_int32, ctypes.c_int32,
                                  i32p, f32p, i32p, f32p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def collate(coords: np.ndarray, values: np.ndarray, labels, weights,
            splits: np.ndarray, batch: int, capacity: int, dim: int):
    """CSR event arrays -> padded blob arrays. Returns (blob dict pieces,
    truncated count)."""
    lib = _load()
    out_coords = np.empty((batch, capacity, dim), np.int32)
    out_values = np.empty((batch, capacity), np.float32)
    out_label = np.empty((batch, capacity), np.int32)
    out_weight = np.empty((batch, capacity), np.float32)
    out_n = np.empty((batch,), np.int32)
    coords = np.ascontiguousarray(coords, np.int32)
    values = np.ascontiguousarray(values, np.float32)
    splits = np.ascontiguousarray(splits, np.int64)
    lab = (np.ascontiguousarray(labels, np.float32)
           if labels is not None else None)
    wgt = (np.ascontiguousarray(weights, np.float32)
           if weights is not None else None)
    null_f = ctypes.POINTER(ctypes.c_float)()
    truncated = lib.upt_collate(
        batch, capacity, dim,
        _ptr(coords, ctypes.c_int32), _ptr(values, ctypes.c_float),
        _ptr(lab, ctypes.c_float) if lab is not None else null_f,
        _ptr(wgt, ctypes.c_float) if wgt is not None else null_f,
        _ptr(splits, ctypes.c_int64),
        _ptr(out_coords, ctypes.c_int32), _ptr(out_values, ctypes.c_float),
        _ptr(out_label, ctypes.c_int32), _ptr(out_weight, ctypes.c_float),
        _ptr(out_n, ctypes.c_int32))
    return (out_coords, out_values,
            out_label if lab is not None else None,
            out_weight if wgt is not None else None,
            out_n, int(truncated))


def dedup(coords: np.ndarray, values: np.ndarray, spatial_size: int,
          merge_mode: str = "sum"):
    """Host-side sort+dedupe of voxel sets (file converters / raw loaders)."""
    lib = _load()
    mode = {"sum": 0, "mean": 1, "max": 2, "last": 3}[merge_mode]
    n, dim = coords.shape
    bits = max(1, int(np.ceil(np.log2(spatial_size))))
    coords = np.ascontiguousarray(coords, np.int32)
    values = np.ascontiguousarray(values, np.float32)
    out_c = np.empty_like(coords)
    out_v = np.empty_like(values)
    m = lib.upt_dedup(n, dim, bits, mode,
                      _ptr(coords, ctypes.c_int32),
                      _ptr(values, ctypes.c_float),
                      _ptr(out_c, ctypes.c_int32),
                      _ptr(out_v, ctypes.c_float))
    return out_c[:m], out_v[:m]


def encode_keys(coords: np.ndarray, spatial_size: int) -> np.ndarray:
    lib = _load()
    n, dim = coords.shape
    bits = max(1, int(np.ceil(np.log2(spatial_size))))
    coords = np.ascontiguousarray(coords, np.int32)
    out = np.empty((n,), np.int64)
    lib.upt_encode_keys(n, dim, bits, _ptr(coords, ctypes.c_int32),
                        _ptr(out, ctypes.c_int64))
    return out
