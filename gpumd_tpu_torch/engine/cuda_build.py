"""Build, load and count the hand-written Hopper kernels.

The CUDA sources in `gpumd_tpu_torch/csrc/*.cu` have a plain C interface.
At first use each is compiled with its own nvcc process for sm_90a, all
started together, and the objects are linked into one shared library under
`build/` at the checkout root, keyed on a hash of the sources and flags,
and loaded with ctypes.  Nothing here runs at import: a CPU-only machine
imports this module and never calls `library()`.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Sources whose template instances the build splits over several nvcc
# processes: each is compiled once a part with -DGK_PART=<part>, and each
# part holds a share of the instances (the source says which).  Compiled
# whole, nep_dense.cu took 173 s and nep_k2.cu 152 s of a 173 s build on
# the H100's 8-core host, the other sources 6-67 s.
PARTS = {"nep_dense.cu": 3, "nep_k1.cu": 2, "nep_k2.cu": 3}

launches = {"k1": 0, "k2": 0, "scatter": 0, "fold": 0, "fold_halo": 0,
            "compact_rows": 0,
            "compact_windows": 0, "tersoff": 0, "tersoff_scatter": 0,
            "k1b": 0, "k2b": 0, "dense_k1": 0, "dense_k2": 0,
            "probe_gather": 0,
            "probe_transcendentals": 0, "probe_onehot_dot": 0,
            "probe_feature_matmul": 0, "probe_pair_reduce": 0,
            "probe_bgather": 0}
build_info = {}  # seconds, path, ptxas report of the last build

_lib = None

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures: every pointer and the stream as c_void_p (given as ints)
_SIGNATURES = {
    "k1_launch": [P] * 12 + [I] * 18 + [F] * 4 + [P],
    "k2_launch": [P] * 14 + [I] * 22 + [F] * 4 + [P],
    "k1_occupancy": [I] * 3 + [P],
    "k2_occupancy": [I] * 3 + [P],
    "scatter_launch": [P] * 4 + [I] * 11 + [P],
    "scatter_occupancy": [I] * 3 + [P],
    "fold_launch": [P] * 2 + [I] * 12 + [P],
    "fold_halo_launch": [P] * 2 + [I] * 11 + [P],
    "fold_occupancy": [I] * 2 + [P],
    "compact_rows_launch": [P] * 3 + [I] * 9 + [P],
    "compact_windows_launch": [P] * 3 + [I] * 4 + [P],
    "tersoff_launch": [P] * 6 + [I] * 7 + [P],
    "tersoff_scatter_launch": [P] * 6 + [I] * 8 + [P],
    "tersoff_occupancy": [I] * 4 + [P] * 2,
    "tersoff_live_cap": [],
    "dense_k1b_launch": [P] * 8 + [I] * 16 + [F] * 2 + [P],
    "dense_k2b_launch": [P] * 10 + [I] * 16 + [F] * 2 + [P],
    "dense_k1_launch": [P] * 7 + [I] * 15 + [F] * 2 + [P],
    "dense_k2_launch": [P] * 8 + [I] * 15 + [F] * 2 + [P],
    "dense_occupancy": [I] * 12 + [P],
    "probe_gather_launch": [P] * 3 + [I] * 4 + [P],
    "probe_trans_launch": [P] * 4 + [I] + [P],
    "probe_onehot_ffma_launch": [P] * 2 + [I] * 5 + [P],
    "probe_onehot_tf32_launch": [P] * 2 + [I] * 7 + [P],
    "probe_onehot_f32_launch": [P] * 2 + [I] * 8 + [P],
    "probe_feature_launch": [P] * 2 + [I] * 8 + [P],
    "probe_wgmma_occupancy": [I] * 5 + [P] * 2,
    "probe_reduce_launch": [P] * 3 + [I] * 6 + [P],
    "probe_reduce_occupancy": [I] * 3 + [P] * 5,
    "probe_bgather_launch": [P] * 3 + [I] * 10 + [P],
    "probe_bgather_occupancy": [I] * 4 + [P],
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
    digest.update(repr(sorted(PARTS.items())).encode())
    out_dir = BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}"
    so = out_dir / "libgpumd_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        units = [(s, [f"-DGK_PART={p}"] if s.name in PARTS else [],
                  out_dir / f"{s.stem}-{p}-{tag}.o")
                 for s in sources for p in range(PARTS.get(s.name, 1))]
        t0 = time.time()
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, *part, "-c", "-o",
                                   str(o), str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, part, o in units]
        outs = [p.communicate() for p in procs]
        report = "".join(out + err for out, err in outs)
        failed = [s.name for (s, _, _), p in zip(units, procs)
                  if p.returncode]
        objs = [o for _, _, o in units]
        tmp = out_dir / f"tmp-{tag}.so"
        if not failed:
            res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                  *(str(o) for o in objs)],
                                 capture_output=True, text=True)
            report += res.stdout + res.stderr
            if res.returncode:
                failed = ["link"]
        build_info["seconds"] = time.time() - t0
        build_info["ptxas"] = report
        (out_dir / "ptxas.txt").write_text(report)
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               + report[-12000:])
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
    if rc:
        msg = library().gk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream() -> int:
    """The raw handle of the current device's current stream, read anew at
    every call, so that a launch follows graph capture and a caller's own
    stream; torch.cuda.current_stream() would build a Stream object a
    call."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def ptr(t: torch.Tensor) -> int:
    """The tensor's data pointer: ctypes takes the int for a c_void_p."""
    return t.data_ptr()


def require(t: torch.Tensor, name: str, dtype, shape=None,
            device=None, align: int = 0):
    """Wrapper-side argument checks: CUDA, dtype, contiguity, shape and,
    given `align`, a base address on an `align`-byte boundary (for a kernel
    that reads it in 16-byte pieces).  One test of all of them first; the
    message of the one that fails after."""
    if (t.is_cuda and t.dtype == dtype and t.is_contiguous()
            and (shape is None or t.shape == tuple(shape))
            and (device is None or t.device == device)
            and not (align and t.data_ptr() % align)):
        return
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
    if align and t.data_ptr() % align:
        raise ValueError(f"{name}: base address not on a {align}-byte "
                         "boundary")
