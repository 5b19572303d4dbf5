"""Build-at-first-use loader for the port's CUDA kernels.

All sources under `uresnet_pytorch_tpu_torch/csrc/*.cu` compile with nvcc,
one process per source, all started together, and link into ONE shared
library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -I csrc -c -o <tmp>/<name>.o csrc/<name>.cu   (each)
    nvcc -shared -o build/torch_kernels/lib<sha>.so <tmp>/*.o

`<sha>` hashes the flags and every file under `csrc/`, the shared headers
included, so an edited kernel or header rebuilds and an unchanged tree
loads from the cache. Nothing is built or loaded at import:
`library()` does both on the first kernel launch, so the package imports
on a machine without nvcc. Every C entry point returns a `cudaError_t`
(0 = success) that `check()` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, so ctypes never
# truncates a 64-bit address to an int
_SIGNATURES = {
    "halo_conv_raw": [_P] * 6 + [_I] * 11 + [_P],
    "halo_conv_bn_act": [_P] * 8 + [ctypes.c_float, _P] + [_I] * 11 + [_P],
    "halo_conv_dw": [_P] * 6 + [_I] * 10 + [_P],
    "link_assemble": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "link_parent": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "halo_extend": [_P, _P, _P, _P, _P] + [_I] * 11 + [_P],
    "halo_transpose": [_P, _P, _P, _P, _P] + [_I] * 12 + [_P],
    "norm_act_vector": [_I, _I, _I],
    "norm_act_launch": [_I] + [_P] * 8 + [_I, _I, ctypes.c_longlong]
    + [_P] * 9 + [_I, ctypes.c_float, ctypes.c_float] + [_I] * 4 + [_P],
}

_lib = None


def sources() -> list:
    """The translation units; headers under csrc/ reach them by -I."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(src.relative_to(CSRC)).encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or put the CUDA toolkit on PATH)")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{out.stem}.", dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sources():
            obj = tmp / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                   str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for cmd, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{' '.join(cmd)}\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = tmp / out.name
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
               *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        # atomic: a concurrent loader never sees half a file
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
