#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (gpumd_tpu_torch) on one NVIDIA GPU.

Drives the port's main path, NEP molecular dynamics of rocksalt PbTe under
NVE on the compact engine (DenseNEPMD, full-window rung), with the trained
NEP4 Te/Pb model in artifacts/trainer_parity_r5_nep.txt at its full width,
in float32.  Phases:

  1. build   compile the CUDA kernels from gpumd_tpu_torch/csrc with nvcc;
             print the build time and the card's name and power limit
  2. kernels at 32,768 atoms, run each kernel (K1, K2, scatter, fold) and
             its plain torch version on the same tensors from one pipeline
             pass (K2 and scatter with per-atom virials off and on) and
             hold the errors to the stated tolerances
  3. md      200 NVE steps at 32,768 atoms, 300 K, dt 1 fs: finite, no
             overflow, every kernel launched at least once per step; the
             first 20 steps track the all-plain pipeline on the card
  4. time    50 steps at 262,144 atoms after warm-up (atom-step/s), each
             kernel against its plain version at those shapes (CUDA events),
             and the cost of the per-step host sync of the rebuild check

Usage: python3 chip_smoke.py [--phases build,kernels,md,time]
Prints the kernels' JSON line, then, last, {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device or on any
failed check.
"""

import argparse
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL = ROOT / "artifacts" / "trainer_parity_r5_nep.txt"

# Tolerances, relative to max|plain|.  K1 and the fold add the same terms
# in another order in f32 (descriptor sums of ~100 pairs): 1e-5.  K2 and
# the scatter also differ by hand-derived vs autograd-free op order and by
# shared-memory atomics whose order changes from run to run: 1e-4.
TOL = {"k1": 1e-5, "fold": 1e-5, "k2": 1e-4, "scatter": 1e-4}
# Positions after 20 NVE steps, kernels vs plain versions on the card: the
# two runs differ only by f32 summation order (~1e-7 relative in forces),
# which 20 fs of chaotic dynamics amplifies far less than 1e-3 A.
POS_TOL = 1e-3
# Total-energy change over the 200-step run, per atom: f32 velocity Verlet
# at dt 1 fs conserves it to ~1e-5 eV/atom; broken forces do not.
DRIFT_TOL = 5e-4

REPLACES = {
    "k1": "gpumd_tpu/engine/nep_compact.py:1099",
    "k2": "gpumd_tpu/engine/nep_compact.py:1223",
    "scatter": "gpumd_tpu/engine/nep_compact.py:1425",
    "fold": "gpumd_tpu/engine/fold_kernel.py:55",
}
SOURCES = {
    "k1": "gpumd_tpu_torch/csrc/nep_k1.cu",
    "k2": "gpumd_tpu_torch/csrc/nep_k2.cu",
    "scatter": "gpumd_tpu_torch/csrc/scatter.cu",
    "fold": "gpumd_tpu_torch/csrc/fold.cu",
}


def build_pbte(nc, a0=6.57):
    """Rocksalt PbTe supercell, 8 atoms per cubic cell (0 = Te, 1 = Pb)."""
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    types_cell = np.array([1, 1, 1, 1, 0, 0, 0, 0])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    return pos, np.tile(types_cell, len(cells)), np.full(3, nc * a0)


class System:
    """PbTe at nc^3 cells with the trained model, on the card in f32."""

    def __init__(self, nc, plain=False, seed=3, jitter=0.0):
        from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
        from gpumd_tpu_torch.integrate.velocity import initialize_velocity
        from gpumd_tpu_torch.model.box import Box
        from gpumd_tpu_torch.model.state import make_state
        from gpumd_tpu_torch.potentials.nep.model import NEP

        dev = torch.device("cuda")
        pos, types, lengths = build_pbte(nc)
        if jitter:  # thermal-like displacements: a perfect lattice's
            # forces cancel to rounding noise, which no check can resolve
            pos = pos + np.random.default_rng(seed).normal(0, jitter,
                                                           pos.shape)
        self.n = len(pos)
        self.nep = NEP.from_file(str(MODEL), dtype=torch.float32, device=dev)
        self.box = Box.orthogonal(lengths, dtype=torch.float32, device=dev)
        state = make_state(pos, np.where(types == 1, 207.2, 127.6), types,
                           self.box)
        self.state = initialize_velocity(state, 300.0, seed=seed)
        self.md = DenseNEPMD(self.nep, self.box, self.n, position=pos,
                             skin=1.5, plain=plain)

    def pipeline(self, carry, per_atom_virial):
        from gpumd_tpu_torch.engine.grid import pack_ghost
        from gpumd_tpu_torch.engine.nep_compact import compact_pipeline

        s = carry.state
        garr = pack_ghost(s.position, s.type, s.mask, s.box, self.md.plan)
        keep = {}
        compact_pipeline(garr, s.type, s.mask, self.md.cplan, carry.idx,
                         self.nep.model, self.nep.params, per_atom_virial,
                         spec=self.md.spec, keep=keep)
        return keep


def kernel_pairs(md, keep):
    """(name, kernel fn, plain fn) on one pipeline pass's tensors."""
    from gpumd_tpu_torch.engine import fold_kernel as fk
    from gpumd_tpu_torch.engine import nep_compact as nc

    cp, spec = md.cplan, md.spec
    pav = keep["pvals"].shape[3] == 12
    return [
        ("k1", lambda: nc.k1_call(keep["centers"], keep["cand"], keep["idx"],
                                  cp, spec),
         lambda: nc.k1_plain(keep["centers"], keep["cand"], keep["idx"], cp,
                             spec)),
        ("k2", lambda: nc.k2_call(keep["centers"], keep["tiles"], keep["idx"],
                                  keep["cotc"], keep["cotw"], cp, spec, pav),
         lambda: nc.k2_plain(keep["centers"], keep["tiles"], keep["idx"],
                             keep["cotc"], keep["cotw"], cp, spec, pav)),
        ("scatter", lambda: nc.scatter_call(keep["pvals"], keep["idx_a"], cp),
         lambda: nc.scatter_plain(keep["pvals"], keep["idx_a"], cp)),
        ("fold", lambda: fk.fold_windows_to_rows(keep["dcand"], cp.base,
                                                 cp.bx),
         lambda: fk.fold_windows_to_rows_plain(keep["dcand"], cp.base,
                                               cp.bx)),
    ]


def _outputs(x):
    return [t for t in (x if isinstance(x, tuple) else (x,)) if t is not None]


def phase_build():
    from gpumd_tpu_torch.engine import cuda_build

    t0 = time.time()
    cuda_build.library()
    print(f"[build] kernels built and loaded in {time.time() - t0:.1f} s "
          f"(nvcc {cuda_build.build_info.get('seconds', 0.0):.1f} s)")
    report = cuda_build.build_info.get("ptxas", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", report)]
    print(f"[build] ptxas: {len(regs)} kernels, max {max(regs, default=0)} "
          f"registers/thread, {sum(spills)} bytes of spill stores")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card)  # the card's name and power limit, as nvidia-smi gives them


def phase_kernels(results):
    sysm = System(16, jitter=0.1)
    print(f"[kernels] PbTe n={sysm.n} plan={sysm.md.plan} "
          f"bx={sysm.md.cplan.bx} mn_r={sysm.md.cplan.mn_r} "
          f"mn_a={sysm.md.cplan.mn_a} a_pad={sysm.md.cplan.a_pad} "
          f"wl={sysm.md.cplan.wl}")
    failures = []
    with torch.no_grad():
        carry = sysm.md.init_carry(sysm.state)
        if bool(carry.overflow):
            raise RuntimeError("overflow at init")
        for pav in (False, True):
            keep = sysm.pipeline(carry, pav)
            for name, kern, plain in kernel_pairs(sysm.md, keep):
                if name in ("k1", "fold") and pav:
                    continue  # the same inputs' shapes as with pav off
                got = _outputs(kern())
                ref = _outputs(plain())
                torch.cuda.synchronize()
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                rel = max(float((g - r).abs().max())
                          / max(float(r.abs().max()), 1e-30)
                          for g, r in zip(got, ref))
                fin = all(bool(torch.isfinite(g).all()) for g in got)
                ok = fin and rel <= TOL[name]
                tag = f"{name}{'[pav]' if pav else ''}"
                print(f"[kernels] {tag}: max_abs_err={err:.3e} "
                      f"rel={rel:.3e} tol={TOL[name]:.0e} "
                      f"{'ok' if ok else 'FAIL'}")
                r = results.setdefault(name, {"max_abs_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if not ok:
                    failures.append(tag)
    if failures:
        raise RuntimeError(f"kernels disagree with plain versions: {failures}")


def _run_steps(sysm, n_steps, snap_at=None):
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    md, ens = sysm.md, NVE()
    dt = 1.0 / TIME_UNIT_CONVERSION
    carry = md.init_carry(sysm.state)
    carry = carry._replace(state=md.compute(carry.state, carry.idx))
    aux = ens.init(carry.state)
    step = md.make_step(ens, dt)
    snap = None
    e0 = total_energy(carry.state)
    for s in range(n_steps):
        carry, aux = step(carry, aux)
        if snap_at is not None and s + 1 == snap_at:
            snap = md.to_input_order(carry, sysm.n).position.clone()
    return carry, e0, snap


def total_energy(state):
    pe = torch.sum(state.potential_energy * state.mask)
    return float(state.kinetic_energy() + pe) / float(state.mask.sum())


def phase_md(results):
    from gpumd_tpu_torch.engine import cuda_build

    n_steps = 200
    with torch.no_grad():
        sysm = System(16)
        cuda_build.reset_launches()
        carry, e0, snap = _run_steps(sysm, n_steps, snap_at=20)
        torch.cuda.synchronize()
        counts = dict(cuda_build.launches)
        e1 = total_energy(carry.state)
        s = carry.state
        finite = all(bool(torch.isfinite(t).all()) for t in
                     (s.position, s.velocity, s.force, s.potential_energy))
        overflow = bool(carry.overflow)
        print(f"[md] n={sysm.n} steps={n_steps} launches={counts} "
              f"finite={finite} overflow={overflow}")
        print(f"[md] total energy per atom: start {e0:.8f} eV, end "
              f"{e1:.8f} eV, change {e1 - e0:+.3e} eV (bound {DRIFT_TOL})")
        for name, c in counts.items():
            results.setdefault(name, {})["launches"] = c
        if not finite or overflow:
            raise RuntimeError("MD produced non-finite values or overflow")
        low = [k for k, c in counts.items() if c < n_steps]
        if low:
            raise RuntimeError(f"kernels launched fewer than {n_steps} "
                               f"times: {low}")
        if abs(e1 - e0) > DRIFT_TOL:
            raise RuntimeError("total energy not conserved")
        ref = System(16, plain=True)
        cuda_build.reset_launches()
        _, _, snap_p = _run_steps(ref, 20, snap_at=20)
        if any(cuda_build.launches.values()):
            raise RuntimeError("the plain reference run launched kernels")
        dpos = sysm.box.minimum_image(snap - snap_p)
        dmax = float(dpos.abs().max())
        print(f"[md] 20-step positions, kernels vs plain: max |dx| = "
              f"{dmax:.3e} A (bound {POS_TOL})")
        if not dmax <= POS_TOL:
            raise RuntimeError("kernel trajectory departs from the plain one")


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_time(results):
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    n_steps = 50
    with torch.no_grad():
        sysm = System(32)
        md, ens = sysm.md, NVE()
        dt = 1.0 / TIME_UNIT_CONVERSION
        print(f"[time] PbTe n={sysm.n} plan={md.plan} bx={md.cplan.bx} "
              f"mn_r={md.cplan.mn_r} mn_a={md.cplan.mn_a}")
        carry = md.init_carry(sysm.state)
        carry = carry._replace(state=md.compute(carry.state, carry.idx))
        aux = ens.init(carry.state)
        step = md.make_step(ens, dt)
        for _ in range(5):  # warm-up
            carry, aux = step(carry, aux)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            carry, aux = step(carry, aux)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if bool(carry.overflow) or not bool(
                torch.isfinite(carry.state.position).all()):
            raise RuntimeError("timed block invalid (overflow/non-finite)")
        print(f"[time] {n_steps} steps in {wall:.4f} s: "
              f"{sysm.n * n_steps / wall:.6e} atom-step/s "
              f"({1e3 * wall / n_steps:.3f} ms/step)")
        # the same steps without the rebuild check's host sync
        state = carry.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, aux = ens.step1(state, aux, dt)
            state = md.compute(state, carry.idx)
            state, aux = ens.step2(state, aux, dt)
        torch.cuda.synchronize()
        wall_ns = time.perf_counter() - t0
        print(f"[time] without the per-step rebuild check and its host "
              f"sync: {1e3 * wall_ns / n_steps:.3f} ms/step; sync cost "
              f"{1e3 * (wall - wall_ns) / n_steps:.3f} ms/step")
        keep = sysm.pipeline(carry, False)
        for name, kern, plain in kernel_pairs(md, keep):
            k_ms, p_ms = [], []
            for _ in range(2):  # in turns: plain, kernel, kernel, plain
                p_ms.append(_time_ms(plain, 3))
                k_ms.append(_time_ms(kern, 10))
            k, p = min(k_ms), min(p_ms)
            results.setdefault(name, {}).update(ms=k, plain_ms=p)
            print(f"[time] {name}: kernel {k:.4f} ms, plain {p:.4f} ms "
                  f"({p / k:.2f}x)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,md,time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke test needs one")
    from gpumd_tpu_torch.engine.nep_compact import pin_fp32_matmul

    pin_fp32_matmul()
    phases = args.phases.split(",")
    results = {}
    phase_build()
    if "kernels" in phases:
        phase_kernels(results)
    if "md" in phases:
        phase_md(results)
    if "time" in phases:
        phase_time(results)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], **results.get(k, {})}
        for k in ("k1", "k2", "scatter", "fold")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
