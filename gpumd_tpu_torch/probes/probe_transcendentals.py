"""Accuracy of the kernels' rsqrt/cos/sin against f64.

Counterpart of scripts/probe_transcendentals.py.  The port's kernels
compute rsqrt, cos and sin in CUDA (rsqrtf, cosf, sinf, built without
--use_fast_math) and K2 differentiates through them by hand; were they fast
approximations (relative error far above f32's epsilon), the force would
not be the gradient of the energy and NVE would drift.  `main` prints, for
two argument ranges (pair distances squared 1-120, angles 0-3.2; 8x1024
f32 each), every op's max and rms relative error of the kernel against f64
numpy and the max error of torch's own op on the same device.

Run on the card:  python -m gpumd_tpu_torch.probes.probe_transcendentals
On the CPU:       ... --device cpu  (the kernel's plain version: torch)
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.probes import device_name, probe_device

RANGES = (("pair_d2", 1.0, 120.0), ("angle", 0.0, 3.2))
OPS = ("rsqrt", "cos", "sin")


def run_plain(x):
    return torch.rsqrt(x), torch.cos(x), torch.sin(x)


def _run_cuda(x):
    cuda_build.require(x, "x", torch.float32)
    out = torch.empty((len(OPS),) + x.shape, dtype=x.dtype, device=x.device)
    r, c, s = out.unbind(0)
    rc = cuda_build.library().probe_trans_launch(
        cuda_build.ptr(x), cuda_build.ptr(r), cuda_build.ptr(c),
        cuda_build.ptr(s), x.numel(), cuda_build.stream())
    cuda_build.check(rc, "probe_trans_launch")
    cuda_build.launches["probe_transcendentals"] += 1
    return r, c, s


def run(x):
    """(rsqrt(x), cos(x), sin(x)) elementwise."""
    if x.is_cuda:
        return _run_cuda(x)
    return run_plain(x)


def rel_error(got, ref):
    """|got - ref| / max(|ref|, 1e-3), the script's scale, in f64.  A point
    where the two agree exactly counts 0: rsqrt(0) is inf in both, which
    the script's subtraction turned into NaN."""
    got = np.asarray(got, np.float64)
    with np.errstate(invalid="ignore"):
        diff = np.where(got == ref, 0.0, np.abs(got - ref))
    return diff / np.maximum(np.abs(ref), 1e-3)


def measure(device=None) -> dict:
    """{"<range>.<op>": {"kernel_max_rel", "kernel_rms_rel",
    "torch_max_rel"}} on `device` (the card by default)."""
    dev = probe_device(device)
    out = {}
    for name, lo, hi in RANGES:
        xs = np.linspace(lo, hi, 8 * 1024, dtype=np.float32).reshape(8, -1)
        x = torch.from_numpy(xs).to(dev)
        kern = [v.cpu().numpy() for v in run(x)]
        plain = [v.cpu().numpy() for v in run_plain(x)]
        xd = xs.astype(np.float64)
        with np.errstate(divide="ignore"):
            ref = (1.0 / np.sqrt(xd), np.cos(xd), np.sin(xd))
        for op, kv, tv, rv in zip(OPS, kern, plain, ref):
            ek = rel_error(kv, rv)
            out[f"{name}.{op}"] = {
                "kernel_max_rel": float(np.max(ek)),
                "kernel_rms_rel": float(np.sqrt(np.mean(ek ** 2))),
                "torch_max_rel": float(np.max(rel_error(tv, rv))),
            }
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = probe_device(args.device)
    print(f"device: {device_name(dev)}")
    out = measure(dev)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
