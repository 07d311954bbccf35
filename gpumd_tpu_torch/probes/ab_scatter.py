"""The pair-cotangent scatter (csrc/scatter.cu) for one or more versions of
the source, timed in turns in one process on the PbTe plans' own inputs.

Each source is built once for each cut, into its own shared library under
build/ab_scatter/ (one nvcc each, all at once):

  frame  the accumulator zeroed and written out; no pair read
  loads  and every pair's values and lanes loaded (cidx too), no atomic
         (a compare that never holds keeps the loads alive)
  whole  the kernel as it is
  occ    (a source with one CTA a block and all channels in it) the whole
         kernel asking for pch 12's shared memory at any pch: at pch 4 it
         shows what the occupancy of 12 channels alone costs

Each cut is text put into a copy of the source at its anchors: TREE_CUTS
for a source that exports scatter_occupancy (channels cut over CTAs),
PARENT_CUTS for the one before it.  A source of the earlier kind also gets
an occupancy query of its own appended (ab_occupancy).

  python -m gpumd_tpu_torch.probes.ab_scatter \\
      parent=OLD/gpumd_tpu_torch/csrc/scatter.cu \\
      tree=gpumd_tpu_torch/csrc/scatter.cu

The inputs are one compact_pipeline pass of rocksalt PbTe (a0 6.57 A),
planned on the lattice and evaluated 0.1 A off it (seed 3), with the
trained NEP4 model (artifacts/trainer_parity_r5_nep.txt), skin 1.5, f32:
262,144 atoms on the default rung at 4 and 12 channels, 1,000,000 atoms
at 12 and the full-window rung (no cidx) at 262,144 and 12 channels.  For
each it prints the plan, each build's shared memory a CTA, resident CTAs
an SM (occupancy query), channels a CTA, grid, and each variant's ms (best
of 3 rounds; a round runs every variant in turn, then in reverse, 10
launches a reading after one to warm up), TB/s and share of the byte
bound; for a source that takes its cut as launch arguments, the whole
kernel also at 4-byte units and at the other channels a CTA (2 or 1).  Every whole
kernel is held against scatter_plain (1e-4 of max |plain|).  Per build:
ptxas's registers, stack frame and spill, and the shared-memory atomics
in the SASS (cuobjdump), if the toolkit has cuobjdump.

With --steps MODE:N,... it then times MD steps of the twin of bench.py
(gpumd_tpu_torch/bench.py: its NEP4 architecture with random weights,
seed 1; MODE nep, npt or hnemd at ~N atoms) with every scatter launch of
the step sent to each source's whole build in turn: the step's other
kernels are this tree's, the host path of a launch is the same for every
source, and each block starts from the same warmed carry (3 steps to warm the
source's path, then 20 timed), in turns (forward, then backward, 4
rounds): each source's median ms/step and atom-step/s.  Last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine import nep_compact as nc
from gpumd_tpu_torch.probes import device_name, probe_device
from gpumd_tpu_torch.probes.ab_tersoff import ptxas_entry

OUT_DIR = cuda_build.BUILD_ROOT / "ab_scatter"
MODEL = Path(__file__).resolve().parents[2] / "artifacts" / \
    "trainer_parity_r5_nep.txt"
ROUNDS, REPS = 3, 10
HBM_BYTES_PER_S = 3.35e12
TOL = 1e-4
# the scatter.cu with the channels cut over CTAs
TREE_CUTS = {
    "frame": [("for (int q = threadIdx.x; q < nq; q += kThreads) {",
               "for (int q = threadIdx.x; q < 0; q += kThreads) {")],
    "loads": [("if (v[c][k] != 0.0f) atomicAdd(&acc[c * wl + l], v[c][k]);",
               "if (v[c][k] == 1.2345678e-30f || l < 0) "
               "acc[c * wl + l] = v[c][k];")],
}
# the scatter.cu before it: one CTA a block, every channel in it
PARENT_CUTS = {
    "frame": [("for (int p = threadIdx.x; p < mnp * a_pad; "
               "p += blockDim.x) {",
               "for (int p = threadIdx.x; p < 0; p += blockDim.x) {")],
    "loads": [("if (v != 0.0f) atomicAdd(&acc[c * wl + j], v);",
               "if (v == 1.2345678e-30f || j < 0) acc[c * wl + j] = v;")],
    "occ": [("const size_t smem = sizeof(float) * (size_t)pch * wl;",
             "const size_t smem = sizeof(float) * (size_t)12 * wl;")],
}
PARENT_OCCUPANCY = """
extern "C" int ab_occupancy(int smem, int* blocks) {
  cudaFuncSetAttribute(scatter_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, scatter_kernel, 256, smem);
}
"""


def _is_tree(text: str) -> bool:
    return "scatter_occupancy" in text


def variant_source(text: str, stage: str) -> str:
    """`text` cut at `stage` ("whole": as it is, with the parent's
    occupancy query appended)."""
    tree = _is_tree(text)
    cuts = TREE_CUTS if tree else PARENT_CUTS
    if stage != "whole" and stage not in cuts:
        raise ValueError(f"no cut {stage!r} for this source")
    for anchor, new in cuts.get(stage, []):
        if text.count(anchor) != 1:
            raise ValueError(f"{stage}: anchor {anchor!r} not found once in "
                             "the source")
        text = text.replace(anchor, new)
    return text if tree else text + PARENT_OCCUPANCY


def build(sources: dict, stages) -> dict:
    """name -> {stage: (CDLL, ptxas report, .so path)}; the "occ" cut only
    for a source of the parent's kind."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path in sources.items():
        text = Path(path).read_text()
        for stage in stages:
            if stage == "occ" and _is_tree(text):
                continue
            cu = OUT_DIR / f"{name}-{stage}.cu"
            cu.write_text(variant_source(text, stage))
            so = OUT_DIR / f"{name}-{stage}.so"
            procs.append(((name, stage), so, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
                 "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    out = {}
    for key, so, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{stderr[-6000:]}")
        out.setdefault(key[0], {})[key[1]] = (ctypes.CDLL(str(so)),
                                              stdout + stderr, so)
    return out


def sass_atomics(so: Path) -> dict:
    """{kernel: {opcode: count}} of the atomics and reductions in the
    library's SASS, or {"cuobjdump": "not found"}."""
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {"cuobjdump": "not found"}
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True)
    out, fn = {}, None
    for line in res.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            continue
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9]+)*)",
                             line):
            counts = out.setdefault(fn, {})
            counts[op] = counts.get(op, 0) + 1
    return out


# (cells a side, compact lists, channels) of the inputs
CASES = ((32, True, (4, 12)), (50, True, (12,)), (32, False, (12,)))


def pbte_cases(dev, sizes=CASES) -> list:
    """(label, pvals, idx_a, cidx, cplan) of each input."""
    from gpumd_tpu_torch.bench import build_pbte, pbte_mass
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.engine.grid import pack_ghost
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.potentials.nep.model import NEP

    nep = NEP.from_file(str(MODEL), dtype=torch.float32, device=dev)
    cases = []
    for ncell, lists, channels in sizes:
        lattice, types, lengths = build_pbte(ncell, ncell, ncell)
        pos = lattice + np.random.default_rng(3).normal(0, 0.1,
                                                        lattice.shape)
        box = Box.orthogonal(lengths, dtype=torch.float32, device=dev)
        md = DenseNEPMD(nep, box, len(pos), position=lattice, skin=1.5,
                        compact_lists=lists)
        carry = md.init_carry(make_state(pos, pbte_mass(types), types, box))
        if bool(carry.overflow):
            raise RuntimeError(f"PbTe {len(pos)}: overflow at the build")
        s, cp = carry.state, md.cplan
        garr = pack_ghost(s.position, s.type, s.mask, s.box, md.plan)
        for pch in channels:
            keep = {}
            nc.compact_pipeline(garr, s.type, s.mask, cp, carry.idx,
                                nep.model, nep.params, pch == 12,
                                spec=md.spec, keep=keep)
            label = (f"PbTe {len(pos):,} "
                     f"{'default rung' if lists else 'full windows'}, "
                     f"{pch} channels")
            cases.append((label, keep["pvals"], keep["idx_a"],
                          keep.get("cidx"), cp))
            del keep
        del md, carry, garr, s
    return cases


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


def launcher(lib, tree, pvals, idx_a, cidx, cp, out, vec=None, group=None):
    """A call of `lib`'s scatter_launch on these tensors (the tree's takes
    vec and group: the wrapper's scatter_plan unless given)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    pch, mnp, a_pad = pvals.shape[3], pvals.shape[4], pvals.shape[5]
    args = [P(pvals.data_ptr()), P(idx_a.data_ptr()),
            P(None if cidx is None else cidx.data_ptr()), P(out.data_ptr()),
            *(I(x) for x in (cp.nb, pch, mnp, a_pad, cp.wl, cp.nxb,
                             idx_a.stride(2), idx_a.stride(3), cp.cl))]
    if tree:
        sp = nc.scatter_plan(cp.nb, pch, cp.wl, a_pad)
        args += [I(sp.vec if vec is None else vec),
                 I(sp.group if group is None else group)]
    args.append(P(torch.cuda.current_stream().cuda_stream))
    fn = lib.scatter_launch
    fn.restype = I

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"scatter_launch returned CUDA error {rc}")
    return call


def steps_in_turns(libs, tree_of, specs, rounds=4, n_steps=20) -> dict:
    """{"MODE:N": {source: [ms/step of each block]}} of the twin's steps
    with the scatter launched from each source's whole build."""
    from gpumd_tpu_torch import bench
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    own = nc._scatter_cuda

    def routed(name):
        lib = libs[name]["whole"][0]

        def scatter_cuda(pvals, idx_pairs, cplan, cidx):
            out = torch.empty((cplan.base.grid[2], cplan.base.grid[1],
                               pvals.shape[3], cplan.nxb, cplan.wl),
                              dtype=torch.float32, device=pvals.device)
            launcher(lib, tree_of[name], pvals, idx_pairs, cidx, cplan,
                     out)()
            return out
        return scatter_cuda

    bench.prepare_device("cuda")
    out = {}
    try:
        for spec in specs:
            mode, n = spec.split(":")
            md, ens, state, observer = bench.setup(mode, int(n))
            step = md.make_step(ens, 1.0 / TIME_UNIT_CONVERSION, observer)
            with torch.no_grad():
                carry0 = md.init_carry(state)
                carry0 = carry0._replace(state=md.compute(carry0.state,
                                                          carry0.idx))
                aux0 = ens.init(carry0.state)
                ms = {name: [] for name in libs}
                order = list(libs)
                for r in range(rounds):
                    for name in (order if r % 2 == 0 else order[::-1]):
                        nc._scatter_cuda = routed(name)
                        carry, aux = carry0, aux0
                        for _ in range(3):  # warm this source's path
                            carry, aux = step(carry, aux)[:2]
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(n_steps):
                            carry, aux = step(carry, aux)[:2]
                        torch.cuda.synchronize()
                        ms[name].append(1e3 * (time.perf_counter() - t0)
                                        / n_steps)
                        if bool(carry.overflow):
                            raise RuntimeError(f"{spec}: {name}'s block "
                                               "overflowed")
                        if not bool(torch.isfinite(
                                carry.state.position).all()):
                            raise RuntimeError(f"{spec}: {name}'s block "
                                               "is not finite")
            natoms = int(state.position.shape[0])
            for name in order:
                med = float(np.median(ms[name]))
                print(f"[ab_scatter] steps {mode} {natoms:,} atoms: {name}: "
                      f"median {med:.3f} ms/step "
                      f"({natoms / med * 1e3:.6e} atom-step/s); blocks "
                      + ", ".join(f"{t:.3f}" for t in ms[name]))
            out[spec] = {"n": natoms, "ms": ms}
            del md, ens, state, observer, step, carry, aux, carry0, aux0
            torch.cuda.empty_cache()
    finally:
        nc._scatter_cuda = own
    return out


def design(lib, tree, pch, cp, vec=None, group=None) -> dict:
    """Shared memory a CTA, resident CTAs an SM, channels a CTA, grid."""
    blocks = ctypes.c_int(0)
    if tree:
        sp = nc.scatter_plan(cp.nb, pch, cp.wl, cp.a_pad)
        sp = sp._replace(vec=sp.vec if vec is None else vec)
        if group is not None:
            sp = sp._replace(group=group, groups=pch // group,
                             smem=4 * group * cp.wl,
                             ctas=cp.nb * pch // group)
        rc = lib.scatter_occupancy(sp.vec, sp.group, sp.smem,
                                   ctypes.byref(blocks))
        smem, chans, grid = sp.smem, sp.group, sp.ctas
    else:
        smem, chans, grid = 4 * pch * cp.wl, pch, cp.nb
        rc = lib.ab_occupancy(smem, ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"occupancy query returned CUDA error {rc}")
    return {"smem": smem, "ctas_an_sm": blocks.value,
            "channels_a_cta": chans, "grid": grid}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="NAME=PATH of a scatter.cu (default: this tree's)")
    ap.add_argument("--stages", default="frame,loads,whole,occ",
                    help="the cuts to build and time (whole: the kernel)")
    ap.add_argument("--steps", default="",
                    help="MODE:N,... of bench.py's twin to time with each "
                    "source's scatter (e.g. hnemd:262144,hnemd:1000000)")
    args = ap.parse_args(argv)
    stages = tuple(args.stages.split(","))
    if "whole" not in stages:
        raise ValueError("--stages must include whole, the kernel")
    dev = probe_device()
    sources = dict(s.split("=", 1) for s in args.sources) or {
        "tree": str(cuda_build.CSRC / "scatter.cu")}
    libs = build(sources, stages)
    tree_of = {name: _is_tree(Path(path).read_text())
               for name, path in sources.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab_scatter] {device_name(dev)} ({smi})")
    report = {"card": smi, "builds": {}, "cases": {}}
    for name in sources:
        rep = libs[name]["whole"][1]
        stems = (["14scatter_kernelILi4E", "14scatter_kernelILi1E"]
                 if tree_of[name] else ["14scatter_kernelPKf"])
        px = {s: ptxas_entry(rep, s) for s in stems}
        sass = sass_atomics(libs[name]["whole"][2])
        report["builds"][name] = {"ptxas": px, "sass_atomics": sass}
        for s, e in px.items():
            print(f"[ab_scatter] {name}: ptxas {e.get('regs')} registers, "
                  f"{e.get('stack')} B stack, {e.get('spill_stores')} B "
                  f"spill stores, {e.get('spill_loads')} B spill loads "
                  f"({e.get('entry')})")
        for fn, ops in sass.items():
            print(f"[ab_scatter] {name}: SASS atomics of {fn}: {ops}")

    with torch.no_grad():
        cases = pbte_cases(dev)
    for label, pvals, idx_a, cidx, cp in cases:
        pch = pvals.shape[3]
        out = torch.empty((cp.base.grid[2], cp.base.grid[1], pch, cp.nxb,
                           cp.wl), device=dev)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (pvals, idx_a, out)
                     + (() if cidx is None else (cidx,)))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ref = nc.scatter_plain(pvals, idx_a, cp, cidx)
        scale = max(float(ref.abs().max()), 1e-30)
        live = int((pvals != 0).sum())
        print(f"[ab_scatter] {label}: nb {cp.nb}, mnp {pvals.shape[4]}, "
              f"a_pad {cp.a_pad}, wl {cp.wl}, cl {cp.cl}; nonzero values "
              f"{live} of {pvals.numel()} ({100 * live / pvals.numel():.1f}"
              f"%); bound {bound_ms:.4f} ms by bytes ({nbytes / 1e6:.1f} MB)")
        variants, shapes = {}, {}
        for name in sources:
            tree = tree_of[name]
            for stage, (lib, _, _) in libs[name].items():
                if stage == "occ" and pch != 4:
                    continue  # pch 12's shared memory at pch 12 is "whole"
                variants[f"{name}/{stage}"] = launcher(lib, tree, pvals,
                                                       idx_a, cidx, cp, out)
                shapes[f"{name}/{stage}"] = design(
                    lib, tree, 12 if stage == "occ" else pch, cp)
            if tree:
                lib = libs[name]["whole"][0]
                plan = nc.scatter_plan(cp.nb, pch, cp.wl, cp.a_pad)
                kws = [("vec1", dict(vec=1))] + [
                    (f"group{g}", dict(group=g)) for g in (2, 1)
                    if g != plan.group and pch % g == 0]
                for key, kw in kws:
                    variants[f"{name}/whole-{key}"] = launcher(
                        lib, tree, pvals, idx_a, cidx, cp, out, **kw)
                    shapes[f"{name}/whole-{key}"] = design(lib, tree, pch,
                                                           cp, **kw)
        errors = {}
        for key, fn in variants.items():
            if "/whole" in key or key.endswith("/occ"):
                out.fill_(float("nan"))
                fn()
                torch.cuda.synchronize()
                err = float((out - ref).abs().max()) / scale
                errors[key] = err
                if not err <= TOL:
                    raise RuntimeError(f"{label}: {key} disagrees with "
                                       f"scatter_plain: {err:.3e}")
        times = {k: [] for k in variants}
        order = list(variants)
        for _ in range(ROUNDS):
            for key in order + order[::-1]:
                times[key].append(_time_ms(variants[key]))
        case = {"bound_ms": bound_ms, "nbytes": nbytes, "nb": cp.nb,
                "wl": cp.wl, "cl": cp.cl, "nonzero": live, "variants": {}}
        for key in order:
            ms = min(times[key])
            row = {"ms": ms, "tb_per_s": nbytes / ms / 1e9,
                   "pct_of_bound": 100 * bound_ms / ms, **shapes[key]}
            if key in errors:
                row["rel_err"] = errors[key]
            case["variants"][key] = row
            print(f"[ab_scatter] {label}: {key}: {ms:.4f} ms, "
                  f"{row['tb_per_s']:.3f} TB/s, {row['pct_of_bound']:.1f}% "
                  f"of bound; {row['smem']} B shared memory a CTA, "
                  f"{row['ctas_an_sm']} CTAs an SM, "
                  f"{row['channels_a_cta']} channels a CTA, grid "
                  f"{row['grid']}"
                  + (f"; rel err {errors[key]:.2e}" if key in errors
                     else ""))
        report["cases"][label] = case
        del out, ref
    cases = pvals = idx_a = cidx = None  # free the inputs before --steps
    torch.cuda.empty_cache()
    if args.steps:
        report["steps"] = steps_in_turns(libs, tree_of,
                                         args.steps.split(","))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
