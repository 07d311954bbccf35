"""The blocked gather (csrc/probes.cu, probe_bgather_kernel) of two or more
versions of the source, timed in turns in one process on the same inputs.

Each source is built on its own into a shared library under
build/ab_bgather/ (one nvcc each, all at once).  A source whose library
exports probe_bgather_occupancy launches with a plan
(bench_mxu_probes.bgather_plan: lanes a thread, the window's chunks,
threads); the one before it, which stages each b's whole window, with
(src, idx, out, nb, nch, nq, width, lanes, stream).  Inputs are those of
chip_smoke's timed row, nb 1,734 (bench_mxu_probes at its scale 8), 17
channels, nblk 18 (width 2,304), 14 chunks (112 index rows), 128 lanes,
with two index patterns: the script's zeros, and uniform random indices in
[-64, width + 64), as chip_smoke's check draws them.

  python -m gpumd_tpu_torch.probes.ab_bgather \\
      parent=OLD/gpumd_tpu_torch/csrc/probes.cu \\
      tree=gpumd_tpu_torch/csrc/probes.cu [--plans 3,4 1,4,512 ...]

prints ptxas's registers, stack frame and spill of each build's kernels,
then for each pattern each version's ms (best of 3 rounds; a round runs
every version in turn, then in reverse, 10 launches a reading after one to
warm up), its max |error| against the plain version and its share of the
bound (bytes: the indices, the output and the 32-byte sectors of src the
valid indices touch, over 3.35 TB/s), and, last, one JSON object.
`--plans BPS,LV[,CHUNK] ...` also times each source that takes a plan
with the plan for BPS blocks an SM, LV lanes a thread and, given, chunks
of CHUNK columns (0: no staging, indices and terms read from device
memory through the read-only path), beside the default plan.  `--stages` also builds each
source that takes a plan cut after a stage (text put in at CUTS' anchors)
and times the cuts beside the whole kernel:

  1  b's indices in shared memory and the touched sectors marked
  2  and the chunks' touched sectors copied, no sums
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
from pathlib import Path

import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.probes import bench_mxu_probes as MX
from gpumd_tpu_torch.probes import device_name, probe_device
from gpumd_tpu_torch.probes.ab_dense import _time_ms, ptxas_entry

OUT_DIR = cuda_build.BUILD_ROOT / "ab_bgather"
ROUNDS = 3  # each reading 10 launches after one (ab_dense._time_ms)
HBM_BYTES_PER_S = 3.35e12
SHAPE = dict(nb=MX.NB_FULL // 8, nch=17, nblk=18, chunks=14)
PATTERNS = ("zeros", "random")
# stage -> (anchor, replacement), in a source that takes a plan
CUTS = {
    1: [("    for (int c0 = 0; STAGE && c0 < width; c0 += chunk) {",
         "    for (int c0 = 0; false && c0 < width; c0 += chunk) {")],
    2: [("      for (int q0 = 0; mine && q0 < nq; q0 += kBgU) {\n"
         "        int j[kBgU][LV];\n#pragma unroll\n"
         "        for (int u = 0; u < kBgU; ++u)\n          bg_row",
         "      for (int q0 = 0; false && q0 < nq; q0 += kBgU) {\n"
         "        int j[kBgU][LV];\n#pragma unroll\n"
         "        for (int u = 0; u < kBgU; ++u)\n          bg_row")],
}


def cut(text: str, stage: int) -> str:
    """`text` cut after `stage` (CUTS)."""
    for anchor, new in CUTS[stage]:
        if text.count(anchor) != 1:
            raise ValueError(f"stage {stage}: anchor {anchor!r} found "
                             f"{text.count(anchor)} times, expected 1")
        text = text.replace(anchor, new)
    return text


def build(sources: dict, stages=()) -> dict:
    """name -> (CDLL, ptxas report) of each source built on its own and,
    for each of `stages`, of each source that takes a plan cut after it
    (named NAME/sSTAGE)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path in sources.items():
        path = Path(path).resolve()
        text = path.read_text()
        variants = {name: path}
        if "probe_bgather_occupancy" in text:
            for stage in stages:
                cu = OUT_DIR / f"{name}-s{stage}.cu"
                cu.write_text(cut(text, stage))
                variants[f"{name}/s{stage}"] = cu
        for key, cu in variants.items():
            so = OUT_DIR / f"{key.replace('/', '-')}.so"
            procs.append((key, so, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
                 "-I", str(path.parent), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = {}
    for name, so, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{stderr[-6000:]}")
        out[name] = (ctypes.CDLL(str(so)), stdout + stderr)
    return out


def inputs(pattern: str, dev, seed: int = 5, **shape):
    """src (nb, nch, 128 nblk) random normal and idx (nb, 8 chunks, 128)
    int32: all zero, or uniform in [-64, width + 64)."""
    p = {**SHAPE, **shape}
    width = 128 * p["nblk"]
    gen = torch.Generator(dev).manual_seed(seed)
    src = torch.randn((p["nb"], p["nch"], width), generator=gen, device=dev)
    ishape = (p["nb"], 8 * p["chunks"], MX.A)
    if pattern == "zeros":
        idx = torch.zeros(ishape, dtype=torch.int32, device=dev)
    else:
        idx = torch.randint(-64, width + 64, ishape, generator=gen,
                            device=dev, dtype=torch.int32)
    return src, idx


def sector_bytes(src, idx) -> int:
    """The bound's bytes: idx read once, out written once, and nch times
    the (b, column) 32-byte sectors of src the valid indices touch."""
    nb, nch, width = src.shape
    valid = (idx >= 0) & (idx < width)
    keys = (torch.arange(nb, device=idx.device).view(nb, 1, 1) * width
            + idx.long())[valid]
    sectors = int(torch.unique(keys // 8).numel())
    return (idx.numel() * 4 + 4 * nb * nch * idx.shape[2]
            + 32 * nch * sectors)


def launcher(lib, src, idx, out, plan=None):
    """A call of `lib`'s probe_bgather_launch on the tensors: with `plan`
    (or the default one) where the library takes one."""
    nb, nch, width = src.shape
    nq, a = idx.shape[1:]
    fn = lib.probe_bgather_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    ptrs = [P(t.data_ptr()) for t in (src, idx, out)]
    geo = [I(v) for v in (nb, nch, nq, width, a)]
    if hasattr(lib, "probe_bgather_occupancy"):
        plan = plan or MX.bgather_plan(nb, nch, nq, width, a)
        geo += [I(v) for v in (plan.lv, int(plan.stage), plan.chunk,
                               plan.threads, plan.smem)]
    elif plan is not None:
        raise ValueError("this library takes no plan")
    argv = ptrs + geo + [P(torch.cuda.current_stream().cuda_stream)]

    def call():
        rc = fn(*argv)
        if rc:
            raise RuntimeError(f"probe_bgather_launch: CUDA error {rc}")
    return call


def compare(libs: dict, dev, plans=(), shape=None) -> dict:
    """{pattern: {version: {"ms", "max_abs_err", "plan"}, "bound_ms"}} for
    libs {name: CDLL}, each with its default plan and, where it takes one,
    each of `plans` ((bps, lv) or (bps, lv, chunk)), timed in turns."""
    res = {}
    for pattern in PATTERNS:
        src, idx = inputs(pattern, dev, **(shape or {}))
        nb, nch, width = src.shape
        ref = MX.bgather_plain(src, idx)
        variants, outs = {}, {}
        for name, lib in libs.items():
            with_plan = hasattr(lib, "probe_bgather_occupancy")
            for p in (None,) + (tuple(plans) if with_plan else ()):
                plan = None
                if p is not None:
                    nq, a = idx.shape[1:]
                    plan = MX.bgather_plan(nb, nch, nq, width, a, bps=p[0],
                                           lv=p[1])
                    if len(p) > 2 and p[2] == 0:  # src read directly
                        plan = dataclasses.replace(
                            plan, stage=False, chunk=0, chunks=0, smem=0)
                    elif len(p) > 2:
                        plan = dataclasses.replace(
                            plan, chunk=p[2], chunks=-(-width // p[2]),
                            smem=MX.bgather_smem(nq, a, nch, width, p[2]))
                key = name if p is None else f"{name}{list(p)}"
                outs[key] = torch.empty_like(ref)
                variants[key] = (launcher(lib, src, idx, outs[key], plan),
                                 plan)
        for fn, _ in variants.values():
            fn()
        torch.cuda.synchronize()
        times = {k: [] for k in variants}
        order = list(variants)
        for _ in range(ROUNDS):
            for key in order + order[::-1]:
                times[key].append(_time_ms(variants[key][0]))
        bound = sector_bytes(src, idx) / HBM_BYTES_PER_S * 1e3
        res[pattern] = {"bound_ms": bound}
        for key, (_, plan) in variants.items():
            res[pattern][key] = {
                "ms": min(times[key]),
                "max_abs_err": float((outs[key] - ref).abs().max()),
                "plan": None if plan is None else dataclasses.asdict(plan)}
        del src, idx, ref, outs
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="NAME=PATH of a probes.cu (default: this tree's)")
    ap.add_argument("--plans", nargs="*", default=[],
                    help="BPS,LV[,CHUNK] plans to time beside the default")
    ap.add_argument("--stages", action="store_true",
                    help="also time each source cut after stages 1 and 2")
    args = ap.parse_args(argv)
    dev = probe_device()
    sources = dict(s.split("=", 1) for s in args.sources) or {
        "tree": str(cuda_build.CSRC / "probes.cu")}
    plans = [tuple(int(v) for v in p.split(",")) for p in args.plans]
    built = build(sources, tuple(CUTS) if args.stages else ())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab_bgather] {device_name(dev)} ({smi}); nb {SHAPE['nb']}, "
          f"{SHAPE['nch']} channels, nblk {SHAPE['nblk']}, "
          f"{SHAPE['chunks']} chunks, 128 lanes")
    report = {"card": smi}
    for name, (_, rep) in built.items():
        for stem in ("probe_bgather_kernelILi4ELb1E",
                     "probe_bgather_kernelILi1ELb1E",
                     "probe_bgather_kernelILi4ELb0E",
                     "probe_bgather_kernelPK"):
            px = ptxas_entry(rep, stem)
            if px["entry"] is None:
                continue
            report[f"{name}/ptxas/{stem}"] = px
            print(f"[ab_bgather] {name} {px['entry']}: {px['regs']} "
                  f"registers, {px['stack']} B stack, {px['spill_stores']} "
                  f"B spill stores, {px['spill_loads']} B spill loads")
    res = compare({k: v[0] for k, v in built.items()}, dev, plans)
    for pattern, rows in res.items():
        bound = rows["bound_ms"]
        for key, r in rows.items():
            if key == "bound_ms":
                continue
            print(f"[ab_bgather] {pattern} {key}: {r['ms']:.4f} ms, "
                  f"{100 * bound / r['ms']:.1f}% of the {bound:.4f} ms "
                  f"bound; max |error| {r['max_abs_err']:.3e}"
                  + ("" if r["plan"] is None else f"; plan {r['plan']}"))
    report.update(res)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
