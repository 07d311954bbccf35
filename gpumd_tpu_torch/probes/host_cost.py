"""Host time of the kernel wrappers, part by part, and the launch floor.

Every kernel wrapper of the port launches through the same path
(engine/cuda_build.py and ctypes), and its host time is spent in:

  require  cuda_build.require, the argument checks
  alloc    the outputs: torch.empty, empty_like, zeros, zeros_like
  ptr      cuda_build.ptr, each pointer
  stream   cuda_build.stream(), the current stream's handle
  call     the ctypes call: argument conversion and the launch
  check    cuda_build.check of the launcher's return code
  rest     the wrapper's own Python: the whole call less the parts

`measure` times each wrapper call `calls` times with every part wrapped in
a time.perf_counter_ns timer, and as many times without, with a
torch.cuda.synchronize() before each call so that no launch waits on a
full queue; it reports the median microseconds a call of each part, of
the whole call (untimed parts) and the rest.  `launch_floor` captures 200
calls of the transcendental probe's wrapper (row 13) in a CUDA graph and
times the graph's replay with CUDA events: the device's own time a launch,
which no wrapper beats.  `back_to_back` times 200 calls of that wrapper,
and of its plain version, with CUDA events around them, as chip_smoke's
row 13 does.  `helpers_ab` times each wrapper in one process with the
launch helpers as they were before they returned raw ints (a c_void_p
object a pointer, a torch.cuda.Stream object a call, the checks one at a
time; three allocations in row 13's wrapper) and as they are, in turns:
two processes differ by more than the change.

  python gpumd_tpu_torch/probes/host_cost.py [--root CHECKOUT] [--calls N]

pinned to one core, measures the wrappers of the package in CHECKOUT (by default this file's
own checkout), on the kernel library built from this file's checkout (two
checkouts whose C signatures agree then run the same kernels): row 13's
wrapper on (8, 1024); the NEP default rung's K1, K2, scatter, fold and
compact_rows on one pass of PbTe 32,768 atoms on its lattice plan; and the
Tersoff step's tersoff_scatter and fold on one pass of Si 32,768, the
systems and passes as CHECKOUT's chip_smoke.py builds them, with the Si
set of CHECKOUT's gpumd_tpu_torch/potentials/tersoff.py (SI_TERSOFF; an
older checkout without it cannot be measured).  It prints a
[host] line a wrapper, the floor, for this checkout the in-process A/B
and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

TREE = Path(__file__).resolve().parents[2]
PARTS = ("require", "alloc", "ptr", "stream", "call", "check")
ALLOC = ("empty", "empty_like", "zeros", "zeros_like")
FLOOR_CALLS = 200


class _Timed:
    """Puts a perf_counter_ns timer around the parts of a wrapper call,
    less the timer's own cost inside its window (`overhead`, ns a timed
    call of a function that does nothing)."""

    def __init__(self, cb):
        self.cb, self.saved = cb, []
        self.acc, self.n = dict.fromkeys(PARTS, 0), dict.fromkeys(PARTS, 0)
        self.overhead = 0.0

    def _wrap(self, part, fn):
        acc, n, clock = self.acc, self.n, time.perf_counter_ns

        def timed(*args, **kwargs):
            t0 = clock()
            out = fn(*args, **kwargs)
            acc[part] += clock() - t0
            n[part] += 1
            return out
        return timed

    def calibrate(self, reps: int = 20000):
        noop = self._wrap("check", lambda: None)
        samples = []
        for _ in range(reps):
            self.acc["check"] = 0
            noop()
            samples.append(self.acc["check"])
        self.overhead = statistics.median(samples)
        self.reset()

    def reset(self):
        for p in PARTS:
            self.acc[p] = self.n[p] = 0

    def parts(self) -> dict:
        return {p: self.acc[p] - self.n[p] * self.overhead for p in PARTS}

    def __enter__(self):
        cb, lib = self.cb, self.cb.library()
        wrap = self._wrap

        class Lib:
            def __getattr__(self, name):
                return wrap("call", getattr(lib, name))

        proxy = Lib()
        patches = [(cb, "library", lambda: proxy)]
        patches += [(cb, part, wrap(part, getattr(cb, part)))
                    for part in ("require", "ptr", "stream", "check")]
        patches += [(torch, name, wrap("alloc", getattr(torch, name)))
                    for name in ALLOC]
        for obj, name, new in patches:
            self.saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, new)
        return self

    def __exit__(self, *exc):
        for obj, name, old in reversed(self.saved):
            setattr(obj, name, old)
        self.saved = []


def _whole(fn, calls, sync) -> float:
    """Median microseconds a call of `fn`, a sync before each."""
    clock, whole = time.perf_counter_ns, []
    for _ in range(calls):
        sync()
        t0 = clock()
        fn()
        whole.append(clock() - t0)
    return statistics.median(whole) / 1e3


def measure(fn, cb, calls: int = 2000, sync=None) -> dict:
    """Median microseconds a call of `fn` (a wrapper call on fixed inputs)
    spends in each part of cuda_build module `cb`'s launch path, the whole
    call and the rest."""
    sync = sync or torch.cuda.synchronize
    fn()
    whole = _whole(fn, calls, sync)
    parts = {p: [] for p in PARTS}
    timed = _Timed(cb)
    timed.calibrate()
    with timed:
        for _ in range(calls):
            sync()
            timed.reset()
            fn()
            for p, v in timed.parts().items():
                parts[p].append(v)
    sync()
    out = {p: statistics.median(v) / 1e3 for p, v in parts.items()}
    out["whole"] = whole
    out["rest"] = out["whole"] - sum(out[p] for p in PARTS)
    return out


# The launch helpers as they were before they returned raw ints: a
# c_void_p object a pointer, a torch.cuda.Stream object a call, the checks
# one at a time; and the transcendental wrapper with three allocations.
def _before_stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _before_ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _before_require(t, name, dtype, shape=None, device=None, align=0):
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


def _before_transcendentals(cb, x):
    cb.require(x, "x", torch.float32)
    outs = tuple(torch.empty_like(x) for _ in range(3))
    rc = cb.library().probe_trans_launch(
        cb.ptr(x), *(cb.ptr(o) for o in outs), x.numel(), cb.stream())
    cb.check(rc, "probe_trans_launch")
    cb.launches["probe_transcendentals"] += 1
    return outs


def helpers_ab(calls: dict, cb, calls_n: int = 2000, rounds: int = 2,
               sync=None) -> dict:
    """name -> {"before", "now"}: median microseconds a call of each
    wrapper with cuda_build's launch helpers (and, for row 13, the
    wrapper) as they were and as they are, in one process, in turns
    (before, now, now, before) `rounds` times; the smaller reading of
    each."""
    sync = sync or torch.cuda.synchronize
    now = {k: getattr(cb, k) for k in ("stream", "ptr", "require")}
    before = {"stream": _before_stream, "ptr": _before_ptr,
              "require": _before_require}
    res = {name: {"before": float("inf"), "now": float("inf")}
           for name in calls}
    try:
        for _ in range(rounds):
            for label in ("before", "now", "now", "before"):
                for k, fn in (before if label == "before" else now).items():
                    setattr(cb, k, fn)
                for name, (fn_now, fn_before) in calls.items():
                    fn = fn_before if label == "before" else fn_now
                    fn()
                    res[name][label] = min(res[name][label],
                                           _whole(fn, calls_n, sync))
    finally:
        for k, fn in now.items():
            setattr(cb, k, fn)
    return res


def launch_floor(run, x, calls: int = FLOOR_CALLS) -> float:
    """ms a launch of `run(x)` from a CUDA graph of `calls` of them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            run(x)
    graph.replay()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def back_to_back(fn, calls: int = FLOOR_CALLS) -> float:
    """ms a call of `calls` back-to-back calls under CUDA events, best of
    3."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def wrapper_calls(cs, pot_path) -> dict:
    """name -> a wrapper call on one pass's tensors, from chip_smoke module
    `cs`: the NEP default rung's (PbTe 32,768, lattice plan) and the
    Tersoff step's (Si 32,768)."""
    calls = {}
    nep = cs.System(16, plan_on_lattice=True)
    keep = nep.pipeline(nep.md.init_carry(nep.state), False)
    for name, kern, _ in cs.kernel_pairs(nep.md, keep):
        calls.setdefault(f"nep/{name}", kern)
    ters = cs.TersoffSystem(16, pot_path)
    keep_t = ters.pipeline(ters.md.init_carry(ters.state), False)
    for name, kern, _ in cs.tersoff_pairs(ters.md, keep_t):
        if name in ("tersoff_scatter", "fold"):
            calls[f"tersoff/{name}"] = kern
    return calls


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(TREE),
                    help="the checkout whose wrappers are measured")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: host_cost measures launches on "
                           "the card")
    root = str(Path(args.root).resolve())
    # one core: the process does not move between cores while it times
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    sys.path.insert(0, root)
    import chip_smoke as cs
    from gpumd_tpu_torch.engine import cuda_build as cb
    from gpumd_tpu_torch.engine.nep_compact import pin_fp32_matmul
    from gpumd_tpu_torch.potentials.tersoff import SI_TERSOFF
    from gpumd_tpu_torch.probes import probe_transcendentals as PT

    if not cb.__file__.startswith(root):
        raise RuntimeError(f"imported {cb.__file__}, not {root}'s package")
    # the kernels of this file's checkout, built by its cuda_build
    cb.CSRC, cb.BUILD_ROOT = TREE / "gpumd_tpu_torch" / "csrc", TREE / "build"
    cb.library()
    pin_fp32_matmul()
    dev = torch.device("cuda")
    x = torch.linspace(1.0, 120.0, 8192, device=dev).reshape(8, 1024)
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        pot = Path(tmp) / "Si_Tersoff_1989.txt"
        pot.write_text(SI_TERSOFF)
        calls = {"probe/transcendentals": lambda: PT.run(x),
                 **wrapper_calls(cs, str(pot))}
        res = {"root": root, "calls": args.calls, "wrappers": {}}
        for name, fn in calls.items():
            r = measure(fn, cb, args.calls)
            res["wrappers"][name] = r
            print(f"[host] {root} {name}: whole {r['whole']:.2f} us = "
                  + ", ".join(f"{p} {r[p]:.2f}" for p in PARTS + ("rest",))
                  + f" (median of {args.calls} calls)")
        res["launch_floor_ms"] = launch_floor(PT.run, x)
        res["row13_ms"] = back_to_back(lambda: PT.run(x))
        res["row13_plain_ms"] = back_to_back(lambda: PT.run_plain(x))
        if root == str(TREE):
            pairs = {name: (fn, fn) for name, fn in calls.items()}
            pairs["probe/transcendentals"] = (
                calls["probe/transcendentals"],
                lambda: _before_transcendentals(cb, x))
            res["ab"] = helpers_ab(pairs, cb, args.calls)
            for name, r in res["ab"].items():
                print(f"[host] in one process, in turns: {name}: "
                      f"{r['before']:.2f} us a call with the launch helpers "
                      f"as they were, {r['now']:.2f} as they are "
                      f"({r['now'] - r['before']:+.2f})")
    print(f"[host] {root} row 13: {res['row13_ms']:.4f} ms a call back to "
          f"back, plain {res['row13_plain_ms']:.4f} ms; launch floor "
          f"{res['launch_floor_ms']:.5f} ms a launch from a CUDA graph of "
          f"{FLOOR_CALLS}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
