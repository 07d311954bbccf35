"""The one-hot dot's f32 launcher from two kernel libraries, timed in turns
in one process on the same inputs.

Two builds of csrc/probes.cu timed in two processes also see two card
states (clocks, memory placement, what ran before); in one process, in
turns A, B, B, A, they see the same.  Each library is given as
PATH:SYMBOL[:EXTRA,...], SYMBOL its f32 launcher, called as
SYMBOL(vals, out, nb, m, k, n, ksplit, *EXTRA, stream) (EXTRA: ints):

  python -m gpumd_tpu_torch.probes.ab_onehot_f32 \\
      old/libgpumd_kernels.so:probe_onehot_ffma_launch \\
      build/kernels-<hash>/libgpumd_kernels.so:probe_onehot_f32_launch:128,4,132

(the three-pass launcher's EXTRA is its plan: wgmma N, ring stages,
persistent blocks; bench_mxu_probes.onehot_f32_plan at this shape) prints
each round's ms (3 rounds of A, B, B, A, 5 calls a reading), the best of
each, max |A - B| of the outputs and each one's max |error| against the
product in f64, on random normal inputs from a seed, at the probes' timed
shape (nb 1,734, 144 x 4096 x 128, ksplit 1).
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from gpumd_tpu_torch.probes import probe_device
from gpumd_tpu_torch.probes.bench_mxu_probes import onehot_dot_plain

SHAPE = (1734, 144, 4096, 128)  # nb, m, k, n: chip_smoke's timed case
ROUNDS, REPS = 3, 5


def _launcher(spec):
    path, symbol, *rest = spec.split(":")
    extra = [int(x) for x in rest[0].split(",")] if rest else []
    fn = getattr(ctypes.CDLL(path), symbol)
    fn.restype = ctypes.c_int
    return fn, extra


def _call(launcher, vals, out):
    fn, extra = launcher
    nb, m, k, n = SHAPE
    args = [ctypes.c_void_p(vals.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            *(ctypes.c_int(x) for x in (nb, m, k, n, 1, *extra)),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
    rc = fn(*args)
    if rc:
        raise RuntimeError(f"launcher returned CUDA error {rc}")


def _time_ms(launcher, vals, out):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _call(launcher, vals, out)
    start.record()
    for _ in range(REPS):
        _call(launcher, vals, out)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", help="PATH:SYMBOL[:EXTRA,...] of library A")
    ap.add_argument("b", help="PATH:SYMBOL[:EXTRA,...] of library B")
    args = ap.parse_args(argv)
    dev = probe_device()
    nb, m, k, n = SHAPE
    gen = torch.Generator(dev).manual_seed(5)
    vals = torch.randn((nb, m, k), device=dev, generator=gen)
    outs = {key: torch.empty((nb, m, n), device=dev) for key in "ab"}
    lib = {"a": _launcher(args.a), "b": _launcher(args.b)}
    times = {"a": [], "b": []}
    for r in range(ROUNDS):
        for key in "abba":
            ms = _time_ms(lib[key], vals, outs[key])
            times[key].append(ms)
            print(f"round {r} {key.upper()} {ms:.4f} ms")
    res = {f"best_{key}_ms": min(t) for key, t in times.items()}
    res["max_abs_diff"] = float((outs["a"] - outs["b"]).abs().max())
    exact = onehot_dot_plain(vals.double(), n)
    for key in "ab":
        res[f"f64_error_{key}"] = float(
            (outs[key].double() - exact).abs().max())
    print(f"best A {res['best_a_ms']:.4f} ms, best B {res['best_b_ms']:.4f} "
          f"ms (B/A {res['best_b_ms'] / res['best_a_ms']:.4f}); max |A - B| "
          f"{res['max_abs_diff']:.3e}; max |error| against f64: A "
          f"{res['f64_error_a']:.3e}, B {res['f64_error_b']:.3e}")
    return res


if __name__ == "__main__":
    main()
