"""Gather from a per-step window: the kernel vs torch's gathers.

Counterpart of scripts/bench_gather.py.  `gather_call(table, idx)` gives
out[g, s, l] = table[g, idx[g, s, l], l] for a table (G, W, 128) of
per-step windows and indices (G, S, 128) in [0, W): the primitive of a hot
path that gathers neighbour data from a window of atoms sorted by cell
instead of from all of device memory.  `main` times it beside
torch.take_along_dim on the same arrays and beside a flat random gather
from a table of G*W entries, each in ms and G elements/s; the shape
mirrors the assembly step at 256k atoms (~29M lookups from windows of ~11k
rows).

Run on the card:  python -m gpumd_tpu_torch.probes.bench_gather
                  [--w 11200 --s 1024 --g 256]
On the CPU:       ... --device cpu  (the kernel's plain version)
"""

from __future__ import annotations

import argparse

import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.probes import best_ms, device_name, probe_device

W, S, G = 11200, 1024, 256  # window rows, gathered rows and steps
LANES = 128


def gather_plain(table, idx):
    return torch.take_along_dim(table, idx.long(), dim=1)


def _gather_cuda(table, idx):
    g, w, lanes = table.shape
    s = idx.shape[1]
    cuda_build.require(table, "table", torch.float32)
    cuda_build.require(idx, "idx", torch.int32, (g, s, lanes),
                       device=table.device)
    out = torch.empty((g, s, lanes), dtype=table.dtype, device=table.device)
    lib = cuda_build.library()
    rc = lib.probe_gather_launch(cuda_build.ptr(table), cuda_build.ptr(idx),
                                 cuda_build.ptr(out), g, w, s, lanes,
                                 cuda_build.stream())
    cuda_build.check(rc, "probe_gather_launch")
    cuda_build.launches["probe_gather"] += 1
    return out


def gather_call(table, idx):
    """table (G, W, L) f32, idx (G, S, L) int32 in [0, W) -> (G, S, L)."""
    if table.is_cuda:
        return _gather_cuda(table, idx)
    return gather_plain(table, idx)


def make_inputs(w=W, s=S, g=G, device=None, seed=0):
    """A normal table (g, w, 128) and uniform int32 indices (g, s, 128)."""
    dev = probe_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    table = torch.randn((g, w, LANES), generator=gen, device=dev)
    idx = torch.randint(0, w, (g, s, LANES), generator=gen, device=dev,
                        dtype=torch.int32)
    return table, idx


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--w", type=int, default=W, help="window rows")
    ap.add_argument("--s", type=int, default=S, help="gathered rows a step")
    ap.add_argument("--g", type=int, default=G, help="steps")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = probe_device(args.device)
    print(f"device: {device_name(dev)}")
    table, idx = make_inputs(args.w, args.s, args.g, dev)
    idx_l = idx.long()
    total = args.g * args.s * LANES
    gen = torch.Generator(dev).manual_seed(1)
    flat_tab = torch.randn((args.g * args.w,), generator=gen, device=dev)
    flat_idx = torch.randint(0, args.g * args.w, (total,), generator=gen,
                             device=dev)
    res = {}
    for key, label, fn in (
            ("kernel", "kernel banded",
             lambda: gather_call(table, idx)),
            ("take_along_dim", "torch take_along_dim",
             lambda: torch.take_along_dim(table, idx_l, dim=1)),
            ("flat_gather", "torch flat gather",
             lambda: flat_tab[flat_idx])):
        ms = best_ms(fn, dev, reps=5)
        res[key] = ms
        print(f"{label}: {ms:.2f} ms -> {total / ms / 1e6:.2f} G elem/s")
    return res


if __name__ == "__main__":
    main()
