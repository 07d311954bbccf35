"""Build, load and count the hand-written Hopper kernels.

The CUDA sources in `gpumd_tpu_torch/csrc/*.cu` have a plain C interface.
At first use they are compiled with nvcc for sm_90a into one shared
library under `build/` at the checkout root, keyed on a hash of the
sources and flags, and loaded with ctypes.  Nothing here runs at import:
a CPU-only machine imports this module and never calls `library()`.

Every kernel wrapper adds one to `launches[name]` where it launches its
kernel and nowhere else, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {"k1": 0, "k2": 0, "scatter": 0, "fold": 0}
build_info = {}  # seconds, path, ptxas report of the last build

_lib = None

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures: every pointer and the stream as c_void_p
_SIGNATURES = {
    "k1_launch": [P] * 12 + [I] * 13 + [F] * 3 + [P],
    "k2_launch": [P] * 14 + [I] * 15 + [F] * 3 + [P],
    "scatter_launch": [P] * 3 + [I] * 8 + [P],
    "fold_launch": [P] * 2 + [I] * 10 + [P],
    "gk_error_string": [I],
}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (CUDA_HOME unset)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for f in sources + headers:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}"
    so = out_dir / "libgpumd_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"tmp-{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in sources)]
        t0 = time.time()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_info["seconds"] = time.time() - t0
        build_info["ptxas"] = res.stderr
        (out_dir / "ptxas.txt").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                "nvcc failed:\n" + res.stdout[-4000:] + res.stderr[-8000:])
        os.replace(tmp, so)
    else:
        build_info.setdefault("seconds", 0.0)
    build_info["path"] = str(so)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_char_p if name == "gk_error_string" else I
    _lib = lib
    return lib


def check(rc: int, name: str):
    """Raise on a non-zero cudaGetLastError() returned by a launcher."""
    if rc != 0:
        msg = library().gk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream():
    return P(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor):
    return P(t.data_ptr())


def require(t: torch.Tensor, name: str, dtype, shape=None,
            device=None):
    """Wrapper-side argument checks: CUDA, dtype, contiguity, shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
