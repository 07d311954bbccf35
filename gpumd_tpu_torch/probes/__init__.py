"""Probe kernels: the port's counterparts of the three probe scripts.

The scripts of scripts/ that measured kernel designs on the TPU each have
a module here of the same name, with hand-written Hopper kernels in
csrc/probes.cu:

  probe_transcendentals  accuracy of the kernels' rsqrtf/cosf/sinf vs f64
  bench_gather           gather from a per-step window vs torch's gathers
  bench_mxu_probes       one-hot dot and feature matmul on the tensor cores
                         (TF32), the pair reduce in two loop orders, and the
                         blocked gather from a shared-memory window

Every wrapper launches its kernel on a CUDA tensor (and raises if it cannot)
and runs its plain torch version on a CPU tensor.  The entry points (each
module's `main`, and the functions that make inputs) run on the card unless
they are given device="cpu" (--device cpu); without a card they raise.
"""

from __future__ import annotations

import time

import torch


def probe_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless `device` names
    another; raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to run the plain versions on the CPU")
    return dev


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu (plain torch versions)"


def best_ms(fn, dev: torch.device, reps: int = 3) -> float:
    """Best of `reps` calls after one warm-up, in ms: CUDA events around each
    call on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best
