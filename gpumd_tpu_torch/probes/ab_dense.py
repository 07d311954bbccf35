"""Stage profile of the dense engines' pair kernels (csrc/nep_dense.cu) at
PbTe 262,144 atoms on the v2 plan, for one or more versions of the source,
timed in turns in one process.

Each source is built three times, cut after a stage, into its own shared
library under build/ab_dense/ (one nvcc each, all at once):

  0  (the queues' source only, with --stages 0,...) the cell staged: the
     live centres and the packed candidates in shared memory
  1  the cell staged and every (centre, candidate) slot tested
  2  and the live pairs evaluated (their terms or p_ij), not summed
  3  the whole kernel

Each cut is text put into a copy of the source at its anchors: a sink that
keeps the stage's results alive, and the next stage taken out.  A source
with the live-pair queues (dense_occupancy exported) is cut at TREE_CUTS'
anchors; the nep_dense.cu before it (a warp a centre forward, a thread a
candidate backward, every slot tested inside the pair loop) at
PARENT_CUTS'.  The forward (dense_fwd_kernel) and the backward
(dense_bwd_kernel) are timed as round 2's K1b and K2b and round 1's K1
and K2.

  python -m gpumd_tpu_torch.probes.ab_dense \\
      parent=OLD/gpumd_tpu_torch/csrc/nep_dense.cu \\
      tree=gpumd_tpu_torch/csrc/nep_dense.cu

prints ptxas's registers, stack frame and spill for each build's instance
at the model's l_max, each variant's ms (best of 3 rounds; a round runs
every variant in turn, then in reverse, 10 launches a reading after one to
warm up) beside the whole kernel's byte bound, and, last, one JSON object.
The inputs are one dense_nep_compute_v2 pass and one dense_nep_compute
pass (plain) of rocksalt PbTe at 32^3 cells (a0 6.57 A, 262,144 atoms)
with the trained NEP4 model
(artifacts/trainer_parity_r5_nep.txt), skin 1.5, f32, on the plan
DenseNEPMD(engine="v2") makes.
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
from gpumd_tpu_torch.engine import nep_dense as nd
from gpumd_tpu_torch.probes import device_name, probe_device

OUT_DIR = cuda_build.BUILD_ROOT / "ab_dense"
MODEL = Path(__file__).resolve().parents[2] / "artifacts" / \
    "trainer_parity_r5_nep.txt"
ROUNDS, REPS = 3, 10
NC = 32  # rocksalt cells a side: 262,144 atoms
HBM_BYTES_PER_S = 3.35e12
STAGES = (1, 2, 3)

# the nep_dense.cu before the queues
_PARENT_SINK_FWD = (
    "      unsigned mr = __ballot_sync(DK_FULL, lr);\n"
    "      unsigned ma = __ballot_sync(DK_FULL, la);",
    "      const unsigned sk_r = __ballot_sync(DK_FULL, lr);\n"
    "      const unsigned sk_a = __ballot_sync(DK_FULL, la);\n"
    "      if (lane == 0) acc_s[0] += (float)(__popc(sk_r) + __popc(sk_a));\n"
    "      unsigned mr = 0u, ma = 0u;")
_PARENT_NO_REDUCE = ("      if (__any_sync(DK_FULL, live)) {",
                     "      if (false) {")
PARENT_CUTS = {
    1: [_PARENT_SINK_FWD,
        ("          if (lr) {\n            gk_cheb(p.d, p.rcp_r",
         "          if (false) {\n            gk_cheb(p.d, p.rcp_r"),
        ("          if (la) {\n            gk_cheb(p.d, p.rcp_a",
         "          if (false) {\n            gk_cheb(p.d, p.rcp_a"),
        ("      if (live) {\n        const float u[3]",
         "      gj[0] += live ? 1.0f : 0.0f;\n      if (false) {\n"
         "        const float u[3]"),
        _PARENT_NO_REDUCE],
    2: [_PARENT_SINK_FWD, _PARENT_NO_REDUCE],
}
# the nep_dense.cu with the queues: stage 1 leaves a group after its
# queues, stage 2 skips the ordered sums
_TREE_SINK = ("      // the live pairs:",
              "      if (true) {\n"
              "        if (threadIdx.x == 0) SINK += (float)(s.off_r[ng] + "
              "s.off_a[ng]);\n        continue;\n      }\n"
              "      // the live pairs:")
TREE_CUTS = {
    0: [("      dk_slot_test(c, s, c0, ng, nc, nwc);",
         "      if (true) {\n"
         "        if (threadIdx.x == 0) SINK += (float)(nc + ng);\n"
         "        continue;\n      }\n"
         "      dk_slot_test(c, s, c0, ng, nc, nwc);")],
    1: [_TREE_SINK],
    2: [("        // radial sums:", "        if (false)  // radial sums:"),
        ("        // angular sums:", "        if (false)  // angular sums:"),
        ("          // centre sums:", "          if (false)  // centre sums:"),
        ("          // candidate sums:",
         "          if (false)  // candidate sums:")],
}


def _variant_source(text: str, stage: int) -> str:
    """`text` cut after `stage` (3: whole)."""
    tree = "dense_occupancy" in text
    cuts = TREE_CUTS if tree else PARENT_CUTS
    for anchor, new in cuts.get(stage, []):
        n = text.count(anchor)
        want = 2 if (tree and "SINK" in new) else 1
        if n != want:
            raise ValueError(f"stage {stage}: anchor {anchor!r} found {n} "
                             f"times, expected {want}")
        if tree and "SINK" in new:
            # the forward's sink is s_out, the backward's dcand_out
            first, rest = text.split(anchor, 1)
            text = (first + new.replace("SINK", "s_out[(size_t)cell * cap * "
                                        "sw]")
                    + rest.replace(anchor, new.replace(
                        "SINK", "dcand_out[(size_t)cell * 3 * g.C]"), 1))
        else:
            text = text.replace(anchor, new)
    return text


def build(sources: dict, stages=STAGES) -> dict:
    """name -> {stage: (CDLL, ptxas report)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path in sources.items():
        path = Path(path).resolve()
        text = path.read_text()
        for stage in stages:
            cu = OUT_DIR / f"{name}-s{stage}.cu"
            cu.write_text(_variant_source(text, stage))
            so = OUT_DIR / f"{name}-s{stage}.so"
            procs.append(((name, stage), so, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
                 "-I", str(path.parent), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
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


def pbte_inputs(dev):
    """The kernels' inputs and outputs of one dense_nep_compute_v2 pass and
    one dense_nep_compute pass of rocksalt PbTe at NC^3 cells, with the
    plan and spec."""
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.potentials.nep.model import NEP

    a0 = 6.57
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(NC)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    types = np.tile([1, 1, 1, 1, 0, 0, 0, 0], len(cells))
    nep = NEP.from_file(str(MODEL), dtype=torch.float32, device=dev)
    box = Box.orthogonal([NC * a0] * 3, dtype=torch.float32, device=dev)
    n = len(pos)
    md = DenseNEPMD(nep, box, n, position=pos, skin=1.5, engine="v2")
    carry = md.init_carry(make_state(pos, np.where(types == 1, 207.2, 127.6),
                                     types, box))
    if bool(carry.overflow):
        raise RuntimeError("PbTe inputs: overflow at the binning")
    # the plain kernels: the inputs need no build of the library
    s, k2, k1 = carry.state, {}, {}
    for fn, keep in ((nd.dense_nep_compute_v2, k2),
                     (nd.dense_nep_compute, k1)):
        fn(s.position, s.type, s.mask, s.box, md.plan, nep.model, nep.params,
           plain=True, keep=keep)
    return k2, k1, md.plan, md.spec


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
                    help="NAME=PATH of a nep_dense.cu (default: this tree's)")
    ap.add_argument("--stages", default="1,2,3",
                    help="the cuts to build and time (3: the whole kernel)")
    args = ap.parse_args(argv)
    stages = tuple(int(x) for x in args.stages.split(","))
    if 3 not in stages:
        raise ValueError("--stages must include 3, the whole kernel")
    dev = probe_device()
    sources = dict(s.split("=", 1) for s in args.sources) or {
        "tree": str(cuda_build.CSRC / "nep_dense.cu")}
    libs = build(sources, stages)
    k2, k1, plan, spec = pbte_inputs(dev)
    nx, ny, nz = plan.grid
    cap, c_pad = plan.cap, k2["cand"].shape[-1]
    ptrs, ints, floats = nd._kernel_args(spec, dev)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = P(torch.cuda.current_stream().cuda_stream)
    tail = [F(v) for v in floats] + [stream]
    empty = torch.empty_like
    # kind -> (launcher, inputs, outputs, candidate lanes, backward)
    kinds = {
        "k1b": ("dense_k1b_launch", (k2["centers"], k2["cand"]),
                (empty(k2["s"]), empty(k2["a"])), c_pad, False),
        "k2b": ("dense_k2b_launch",
                (k2["centers"], k2["cand"], k2["cot_s"], k2["cot_a"]),
                (empty(k2["dcenter"]), empty(k2["dcand"])), c_pad, True),
        "dense_k1": ("dense_k1_launch", (k1["garr"],),
                     (empty(k1["s"]), empty(k1["a"])), 27 * cap, False),
        "dense_k2": ("dense_k2_launch",
                     (k1["garr"], k1["cot_s"], k1["cot_a"]),
                     (empty(k1["g"]),), 27 * cap, True),
    }
    tiles = {kind: nd.dense_tiling(spec, cap, v[3], v[4])
             for kind, v in kinds.items()}

    def launcher(lib, kind):
        fname, ins, outs, lanes, _ = kinds[kind]
        tree = hasattr(lib, "dense_occupancy")
        geo = (nx, ny, nz, cap) + ((c_pad,) if kind in ("k1b", "k2b")
                                   else ())
        extra = [I(v) for v in tiles[kind]] if tree else []
        fn = getattr(lib, fname)
        fn.restype = I
        argv_ = ([P(t.data_ptr()) for t in ins + outs] + list(ptrs)
                 + [I(v) for v in geo + tuple(ints)] + extra + tail)

        def call():
            rc = fn(*argv_)
            if rc:
                raise RuntimeError(f"{fname} returned CUDA error {rc}")
        return call

    def staged(name):
        # a source without the queues has no staging-only cut
        return [st for st in stages
                if st or hasattr(libs[name][st][0], "dense_occupancy")]

    variants = {(name, kind, stage): launcher(libs[name][stage][0], kind)
                for name in sources for stage in staged(name)
                for kind in kinds}
    for fn in variants.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in variants}
    order = list(variants)
    for _ in range(ROUNDS):
        for key in order + order[::-1]:
            times[key].append(_time_ms(variants[key]))
    best = {k: min(v) for k, v in times.items()}

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    bound = {kind: nbytes(v[1] + v[2]) / HBM_BYTES_PER_S * 1e3
             for kind, v in kinds.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab_dense] {device_name(dev)} ({smi}); PbTe {8 * NC ** 3} "
          f"atoms: grid {plan.grid}, cap {cap}, C {c_pad}; tiles "
          + ", ".join(f"{k} {tuple(t)}" for k, t in tiles.items()))
    report = {}
    for name in sources:
        for kind, v in kinds.items():
            for stage in staged(name):
                lib, rep = libs[name][stage]
                # the kernels without queues are templates on l_max alone
                stem = (nd.dense_entry(spec, v[4])
                        if hasattr(lib, "dense_occupancy") else
                        f"dense_{'bwd' if v[4] else 'fwd'}_kernel"
                        f"ILi{spec.l_max}EEv")
                px = ptxas_entry(rep, stem)
                ms = best[(name, kind, stage)]
                report[f"{name}/{kind}/s{stage}"] = {"ms": ms, **px}
                print(f"[ab_dense] {name} {kind} stage {stage}: {ms:.4f} ms; "
                      f"ptxas {px.get('regs')} registers, {px.get('stack')} B "
                      f"stack, {px.get('spill_stores')} B spill stores, "
                      f"{px.get('spill_loads')} B spill loads "
                      f"({px.get('entry')})")
            ms = best[(name, kind, 3)]
            print(f"[ab_dense] {name} {kind}: whole kernel {ms:.4f} ms, bound "
                  f"{bound[kind]:.4f} ms by bytes "
                  f"({100 * bound[kind] / ms:.1f}%)")
    report["bound_ms"] = bound
    report["card"] = smi
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
