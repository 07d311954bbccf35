"""Native (C++) host components, built at first use and loaded with ctypes.

Counterpart of gpumd_tpu/native/__init__.py.  The reference keeps its host
runtime (readers, orchestration) in C++ (ref: src/model/read_xyz.cu,
src/main_gpumd/run.cu); so does the port for the host's hot loops.  A
source here is compiled with g++ at first use into `build/` at the
checkout root, keyed on a hash of the source and flags (as
engine/cuda_build.py keys the kernels), and loaded once a process.  A
build that fails raises: nothing falls back to Python unasked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_ROOT = SRC_DIR.parent.parent / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_libs: dict = {}


def build(name: str) -> Path:
    """The shared object of `<name>.cpp`, compiled if not built yet (into a
    temporary file renamed into place, so that processes building at once
    do not read a partial library)."""
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_ROOT / f"native-{digest}" / f"lib{name}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"tmp-{os.getpid()}-lib{name}.so"
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"g++ failed on {src.name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load(name: str):
    """The ctypes handle of the named component, built first if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    return _libs[name]


def xyz_native():
    """The extended-XYZ row parser (xyz_native.cpp), typed."""
    lib = load("xyz_native")
    if not getattr(lib, "_typed", False):
        lib.xyz_parse_mem.restype = ctypes.c_long
        lib.xyz_parse_mem.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p]
        lib._typed = True
    return lib
