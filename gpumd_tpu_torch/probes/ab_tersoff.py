"""Stage profile of the Tersoff kernel (csrc/tersoff.cu) at Si 1M, for one
or more versions of the source, timed in turns in one process.

Each source is built three times, cut after a stage, into its own shared
library under build/ab_tersoff/ (one nvcc each, all at once):

  1  the window staged in shared memory and every slot gathered (the live
     bonds kept; what they hold is summed into outf row 12)
  2  and the two passes (each p_j summed into row 12, not stored)
  3  the whole kernel: outf, and pvals (contract mode) or the window
     cotangents (fused mode, where the source has it)

Each cut is text put into a copy of the source at its anchors: the sink
before the next stage, and, cut after stage 1 or 2, the contract mode's
zeroing of pvals and the fused mode's write-out of the accumulator taken
out.  A source with the fused mode is cut at TREE_CUTS' anchors; the
tersoff.cu before it (one thread a centre, live bonds in 32-entry arrays)
at PARENT_CUTS'.  The scatter (csrc/scatter.cu, the same in both) is
built beside them and timed on the first source's pvals, so that the
parent's tersoff + scatter and the fused kernel are read in one process.

  python -m gpumd_tpu_torch.probes.ab_tersoff \\
      parent=OLD/gpumd_tpu_torch/csrc/tersoff.cu \\
      tree=gpumd_tpu_torch/csrc/tersoff.cu

prints ptxas's registers, stack frame and spill for each build's
instance at the plan's mn, each variant's ms (best of 3 rounds; a round
runs every variant, forward then backward, 10 launches a reading after one
to warm up) beside
the full kernel's byte bound, and, last, one JSON object.  The inputs are
bench.py's run_tersoff system: diamond Si of 50^3 cells (1,000,000 atoms)
at a0 5.431 A, skin 1.0, the published Si parameters (Phys. Rev. B 39,
5566 (1989)), f32, through CompactTersoffMD's own plan and neighbour build;
--pav times the per-atom-virial mode (pch 12), --a0 4.1 a compressed
lattice whose centres all take the general path (16 live bonds).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine.nep_compact import scatter_plan
from gpumd_tpu_torch.engine.tersoff_compact import tersoff_entry
from gpumd_tpu_torch.probes import device_name, probe_device

OUT_DIR = cuda_build.BUILD_ROOT / "ab_tersoff"
ROUNDS, REPS = 3, 10
HBM_BYTES_PER_S = 3.35e12
STAGES = (1, 2, 3)
# the tersoff.cu before the fused mode: (anchor, its replacement) per cut
PARENT_CUTS = {
    1: [("  // pass 1:",
         "  {\n    float s_ = e_i;\n    for (int q_ = 0; q_ < L; ++q_)\n"
         "      s_ += ux[q_] + uy[q_] + uz[q_] + dd[q_] + fc[q_] + fcp[q_] +\n"
         "            fa[q_] + rr[q_] + qq[q_] + (float)slot[q_];\n"
         "    of[12 * a_pad] = s_;\n    return;\n  }\n  // pass 1:")],
    2: [("  for (int c = 0; c < 3; ++c) of[c * a_pad] = -sp[c];",
         "  {\n    float s_ = e_i + sp[0] + sp[1] + sp[2];\n"
         "    for (int c_ = 0; c_ < 9; ++c_) s_ += vir[c_];\n"
         "    for (int q_ = 0; q_ < L; ++q_)\n"
         "      s_ += qq[q_] + rr[q_] + fcp[q_];\n"
         "    of[12 * a_pad] = s_;\n    return;\n  }\n"
         "  for (int c = 0; c < 3; ++c) of[c * a_pad] = -sp[c];")],
}
# the tersoff.cu with the fused mode: no pvals zeroing and no write-out of
# the accumulator before stage 3, and each stage's sink
_NO_OUTPUT = [
    ("  if (!FUSED) {  // every slot zero first",
     "  if (false) {  // every slot zero first"),
    ("  if (FUSED) {\n    __syncthreads();",
     "  if (false) {\n    __syncthreads();"),
]
TREE_CUTS = {
    1: _NO_OUTPUT + [
        ("  if (L > kLiveCap) {\n",
         "  {\n    float s_ = e_i;\n#pragma unroll\n"
         "    for (int q_ = 0; q_ < kLiveCap; ++q_)\n      if (q_ < L)\n"
         "        s_ += bd[q_].ux + bd[q_].uy + bd[q_].uz + bd[q_].d +\n"
         "              bd[q_].fc + bd[q_].fcp + bd[q_].fa + bd[q_].rr +\n"
         "              bd[q_].qq + (float)bd[q_].tag;\n"
         "    of[12 * a_pad] = s_;\n    return;\n  }\n"
         "  if (L > kLiveCap) {\n")],
    2: _NO_OUTPUT + [
        ("      sink.emit(p, r, bd[j].tag);\n",
         "#pragma unroll\n"
         "      for (int c_ = 0; c_ < 3; ++c_)\n"
         "        sink.sp[c_] += p[c_] + r[c_];\n"),
        ("  for (int c = 0; c < 3; ++c) of[c * a_pad] = -sink.sp[c];",
         "  {\n    of[12 * a_pad] = e_i + sink.sp[0] + sink.sp[1] + "
         "sink.sp[2];\n    return;\n  }\n"
         "  for (int c = 0; c < 3; ++c) of[c * a_pad] = -sink.sp[c];")],
}


def _variant_source(text: str, stage: int) -> str:
    """`text` cut after `stage` (3: whole)."""
    cuts = TREE_CUTS if "tersoff_scatter_launch" in text else PARENT_CUTS
    for anchor, new in cuts.get(stage, []):
        if text.count(anchor) != 1:
            raise ValueError(f"stage {stage}: anchor {anchor!r} not found "
                             "once in the source")
        text = text.replace(anchor, new)
    return text


def build(sources: dict, stages=STAGES) -> dict:
    """name -> {stage: (CDLL, ptxas report)}, plus "scatter" -> its CDLL
    (csrc/scatter.cu of this tree)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, path in sources.items():
        text = Path(path).read_text()
        for stage in stages:
            cu = OUT_DIR / f"{name}-s{stage}.cu"
            cu.write_text(_variant_source(text, stage))
            jobs.append(((name, stage), cu))
    jobs.append((("scatter", 0), cuda_build.CSRC / "scatter.cu"))
    procs = []
    for key, cu in jobs:
        so = OUT_DIR / f"{key[0]}-s{key[1]}.so"
        procs.append((key, so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    out = {}
    for key, so, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{stderr[-6000:]}")
        out.setdefault(key[0], {})[key[1]] = (ctypes.CDLL(str(so)),
                                              stdout + stderr)
    return out


def ptxas_entry(report: str, stem: str) -> dict:
    """registers, stack frame, spill stores and loads of the first entry
    whose mangled name contains `stem`."""
    entries = re.split(r"(?=ptxas info\s*: Compiling entry function)", report)
    for e in entries:
        head = re.search(r"Compiling entry function '([^']*)'", e)
        if head and stem in head.group(1):
            def num(pat):
                m = re.search(pat, e)
                return int(m.group(1)) if m else None
            return {"entry": head.group(1),
                    "regs": num(r"Used (\d+) registers"),
                    "stack": num(r"(\d+) bytes stack frame"),
                    "spill_stores": num(r"(\d+) bytes spill stores"),
                    "spill_loads": num(r"(\d+) bytes spill loads")}
    return {"entry": None}


def si_inputs(nc: int, dev, a0: float = 5.431):
    """centers, cand, idx, plan and spec of diamond Si at nc^3 cells."""
    from gpumd_tpu_torch.bench import build_diamond
    from gpumd_tpu_torch.engine.grid import pack_block_windows, pack_ghost
    from gpumd_tpu_torch.engine.nep_compact import block_centers
    from gpumd_tpu_torch.engine.tersoff_compact import CompactTersoffMD
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.potentials.tersoff import SI_TERSOFF, Tersoff1989

    pos, lengths = build_diamond(nc, a0)
    pot = Tersoff1989.from_text(SI_TERSOFF, device=dev)
    box = Box.orthogonal(lengths, dtype=torch.float32, device=dev)
    n = len(pos)
    md = CompactTersoffMD(pot, box, n, position=pos, skin=1.0)
    carry = md.init_carry(make_state(pos, np.full(n, 28.085),
                                     np.zeros(n, int), box))
    if bool(carry.overflow):
        raise RuntimeError("Si inputs: overflow at the neighbour build")
    s, cp = carry.state, md.cplan
    garr = pack_ghost(s.position, s.type, s.mask, s.box, cp.base)
    return (block_centers(garr, cp),
            pack_block_windows(garr, cp.base, cp.bx, cp.wl), carry.idx, cp,
            md.spec)


def _time_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="NAME=PATH of a tersoff.cu (default: this tree's)")
    ap.add_argument("--nc", type=int, default=50,
                    help="diamond cells a side (50: 1,000,000 atoms)")
    ap.add_argument("--a0", type=float, default=5.431,
                    help="lattice constant, A (4.1: every centre past the "
                    "live cap)")
    ap.add_argument("--pav", action="store_true",
                    help="the per-atom-virial mode (pch 12)")
    ap.add_argument("--stages", default="1,2,3",
                    help="the cuts to build and time (3: the whole kernel)")
    args = ap.parse_args(argv)
    stages = tuple(int(x) for x in args.stages.split(","))
    if 3 not in stages:
        raise ValueError("--stages must include 3, the whole kernel")
    dev = probe_device()
    sources = dict(s.split("=", 1) for s in args.sources) or {
        "tree": str(cuda_build.CSRC / "tersoff.cu")}
    libs = build(sources, stages)
    centers, cand, idx, cp, spec = si_inputs(args.nc, dev, args.a0)
    nz, ny, nxb = cp.base.grid[2], cp.base.grid[1], cp.nxb
    nb, a_pad, wl, mn = cp.nb, cp.a_pad, cp.wl, cp.mn_r
    pch = 12 if args.pav else 4
    outf = torch.empty((nb, 16, a_pad), device=dev)
    pvals = torch.zeros((nb, pch, mn, a_pad), device=dev)
    dcand = torch.empty((nz, ny, pch, nxb, wl), device=dev)
    consts = spec.kernel_consts()
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = P(torch.cuda.current_stream().cuda_stream)
    head = [P(t.data_ptr()) for t in (centers, cand, idx, outf)]
    ints = [I(x) for x in (nb, a_pad, wl, mn, pch, int(args.pav),
                           spec.num_types)]

    def launcher(lib, mode):
        if mode == "contract":
            fn, rest = lib.tersoff_launch, [P(pvals.data_ptr()), consts,
                                            *ints, stream]
        else:
            fn, rest = lib.tersoff_scatter_launch, [
                P(dcand.data_ptr()), consts, *ints, I(nxb), stream]
        fn.restype = I

        def call():
            rc = fn(*head, *rest)
            if rc:
                raise RuntimeError(f"launcher returned CUDA error {rc}")
        return call

    variants = {}
    for name in sources:
        for stage in stages:
            lib, _ = libs[name][stage]
            for mode in ("contract", "fused"):
                fused_in = hasattr(lib, "tersoff_scatter_launch")
                if mode == "contract" or fused_in:
                    variants[(name, mode, stage)] = launcher(lib, mode)
    # the scatter on the first source's whole-kernel pvals
    first = next(iter(sources))
    variants[(first, "contract", 3)]()
    sc = libs["scatter"][0][0].scatter_launch
    sc.restype = I
    sp = scatter_plan(nb, pch, wl, a_pad)
    sc_args = [P(pvals.data_ptr()), P(idx.data_ptr()), P(None),
               P(dcand.data_ptr()), *(I(x) for x in (
                   nb, pch, mn, a_pad, wl, nxb, mn * a_pad, a_pad, 0, sp.vec,
                   sp.group)),
               stream]
    variants[("scatter", "scatter", 3)] = lambda: sc(*sc_args)
    torch.cuda.synchronize()

    times = {k: [] for k in variants}
    order = list(variants)
    for r in range(ROUNDS):
        for key in order + order[::-1]:
            times[key].append(_time_ms(variants[key]))
    best = {k: min(v) for k, v in times.items()}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    inputs = nbytes(centers, cand, idx, outf)
    bound = {"contract": (inputs + nbytes(pvals)) / HBM_BYTES_PER_S * 1e3,
             "fused": (inputs + nbytes(dcand)) / HBM_BYTES_PER_S * 1e3,
             "scatter": (nbytes(pvals, idx, dcand)) / HBM_BYTES_PER_S * 1e3}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab_tersoff] {device_name(dev)} ({smi}); Si {8 * args.nc ** 3} "
          f"atoms at a0 {args.a0} A: {nb} blocks, a_pad {a_pad}, mn {mn}, "
          f"wl {wl}, pch {pch}")
    report = {}
    for name in sources:
        for mode in ("contract", "fused"):
            if (name, mode, 3) not in variants:
                continue
            stem = tersoff_entry(mode == "fused", cp, args.pav)
            for stage in stages:
                rep = libs[name][stage][1]
                px = ptxas_entry(rep, stem)
                if px["entry"] is None:  # the tersoff.cu before the fused
                    # mode: no per-atom-virial template argument
                    px = ptxas_entry(rep, stem.replace(
                        f"Lb{int(args.pav)}E", "E"))
                ms = best[(name, mode, stage)]
                report[f"{name}/{mode}/s{stage}"] = {"ms": ms, **px}
                print(f"[ab_tersoff] {name} {mode} stage {stage}: "
                      f"{ms:.4f} ms; ptxas {px.get('regs')} registers, "
                      f"{px.get('stack')} B stack, {px.get('spill_stores')} "
                      f"B spill stores, {px.get('spill_loads')} B spill "
                      f"loads ({px.get('entry')})")
            ms = best[(name, mode, 3)]
            print(f"[ab_tersoff] {name} {mode}: whole kernel {ms:.4f} ms, "
                  f"bound {bound[mode]:.4f} ms by bytes "
                  f"({100 * bound[mode] / ms:.1f}%)")
    ms_sc = best[("scatter", "scatter", 3)]
    report["scatter"] = {"ms": ms_sc, "bound_ms": bound["scatter"]}
    print(f"[ab_tersoff] scatter on {first}'s pvals: {ms_sc:.4f} ms, bound "
          f"{bound['scatter']:.4f} ms ({100 * bound['scatter'] / ms_sc:.1f}%)")
    for name in sources:
        pair = best[(name, "contract", 3)] + ms_sc
        line = f"[ab_tersoff] {name}: tersoff + scatter {pair:.4f} ms"
        if (name, "fused", 3) in best:
            line += f"; fused {best[(name, 'fused', 3)]:.4f} ms"
        print(line)
    report["bound_ms"] = bound
    report["card"] = smi
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
