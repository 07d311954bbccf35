"""Headline benchmark of the port: MD throughput (atom-step/s) on one GPU.

Twin of the JAX package's bench.py, with its four modes and metric names:

  nep      NEP PbTe MD under NVE            nep_pbte_md_throughput
  npt      the same under NPT (Berendsen)   nep_pbte_npt_md_throughput
           (BASELINE config 3 as written)
  hnemd    HNEMD: per-atom virials, the     nep_hnemd_md_throughput
           driving force Fe = (1e-4, 0, 0) 1/A and a per-step heat-current
           observer, under NVE (BASELINE config 4's path)
  tersoff  Tersoff-1989 Si MD under NVE     tersoff_si_md_throughput
           (BASELINE config 2; the published Si set, SI_TERSOFF)

The NEP modes run rocksalt PbTe with bench.py's NEP4 Te/Pb architecture
(cutoffs 8/4 A, n_max 6/6, basis 6/6, l_max 4 with q222, 30 neurons) and
`random_params(seed=1)` weights, in float32, 300 K, dt 1 fs.  A run warms
a carry (the first rebuild and force pass) and runs one untimed block,
then times one block of GPUMD_BENCH_STEPS steps from the warmed carry,
ending in torch.cuda.synchronize(); it fails on overflow or a non-finite
result.  Mid-run rebuilds stay inside the timed block.

  python -m gpumd_tpu_torch.bench

prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} (value /
1e8, BASELINE.md's target) and, on stderr, the size, wall time and peak
device memory.  Environment: GPUMD_BENCH_N (atoms, default ~1M),
GPUMD_BENCH_STEPS (100), GPUMD_BENCH_MODE (nep), GPUMD_BENCH_ENGINE
(compact: the default rung, compact candidate lists; windows: the
full-window rung; v2: the round-2 dense engine, NEP modes without
per-atom virials only; list: the general path, ForceField with mn 112,
skin 1.0 and total virials, as bench.py's list rung, nep mode only;
tersoff has one rung, compact), GPUMD_BENCH_SKIN (1.5 A; tersoff and
list 1.0).  On the list rung the warm carry is the first force pass and
neighbour cache, and a final cache that overflowed MN fails the run.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

METRICS = {"nep": "nep_pbte_md_throughput",
           "npt": "nep_pbte_npt_md_throughput",
           "hnemd": "nep_hnemd_md_throughput",
           "tersoff": "tersoff_si_md_throughput"}
ENGINES = ("compact", "windows", "v2", "list")
BASELINE = 1e8  # atom-step/s (BASELINE.md)
HNEMD_FE = (1.0e-4, 0.0, 0.0)  # 1/A, a typical kappa driving force
# the npt mode's coupling: PbTe-like bulk modulus ~40 GPa, tau_p 1 ps
# (reference's npt_ber defaults, src/integrate/ensemble_ber.cu)
NPT_BARO = dict(t0=300.0, target_pressure=(0.0, 0.0, 0.0),
                elastic_modulus=(40.0, 40.0, 40.0), tau_p=1000.0)


def build_pbte(nx, ny, nz, a0=6.57):
    """Rocksalt PbTe supercell: 8 atoms per cubic cell, types 0 = Te,
    1 = Pb (the model file's order Te Pb)."""
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    types_cell = np.array([1, 1, 1, 1, 0, 0, 0, 0])
    cells = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz), indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    return (pos, np.tile(types_cell, len(cells)),
            np.array([nx, ny, nz]) * a0)


def build_diamond(nc, a0=5.431):
    """Diamond-lattice Si supercell, 8 atoms per cubic cell."""
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.25, .25, .25], [.75, .75, .25], [.75, .25, .75],
                     [.25, .75, .75]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    return pos, np.full(3, nc * a0)


def prepare_device(device):
    """Fail without the card unless the CPU was asked for; on the card pin
    full-f32 matmuls, as every run of the port's kernels does."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the path on the CPU")
        from gpumd_tpu_torch.engine.nep_compact import pin_fp32_matmul

        pin_fp32_matmul()


def cells_for(target_n: int) -> int:
    """Cubic cells a side for ~target_n atoms (8 a cell), at least 2."""
    return max(2, round((target_n / 8) ** (1 / 3)))


def pbte_mass(types):
    return np.where(types == 1, 207.2, 127.6)


def bench_nep(device):
    """bench.py's NEP4 Te/Pb architecture with random_params(seed=1)."""
    from gpumd_tpu_torch.potentials.nep.model import NEP
    from gpumd_tpu_torch.potentials.nep.params import NepModel, random_params

    model = NepModel(
        version=4, model_type=0, num_types=2, symbols=("Te", "Pb"),
        atomic_numbers=(52, 82), rc_radial=(8.0, 8.0), rc_angular=(4.0, 4.0),
        mn_radial=92, mn_angular=16, n_max_radial=6, n_max_angular=6,
        basis_size_radial=6, basis_size_angular=6, l_max=4,
        has_q=(1, 0, 0, 0, 0, 0), neurons=30)
    return NEP(model=model, params=random_params(model, seed=1,
                                                 device=device))


def setup(mode: str, target_n: int, engine: str = "compact",
          skin=None, device="cuda"):
    """(md, ensemble, input-order state, observer) of one mode; on the list
    rung `md` is a ForceField."""
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.integrate.ensembles.npt import NPTBerendsen
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.integrate.velocity import initialize_velocity
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state

    if mode not in METRICS:
        raise ValueError(f"unknown GPUMD_BENCH_MODE {mode!r}")
    if engine not in ENGINES:
        raise ValueError(f"unknown GPUMD_BENCH_ENGINE {engine!r}: "
                         f"one of {ENGINES}")
    device = torch.device(device)
    nc = cells_for(target_n)
    if mode == "tersoff":
        from gpumd_tpu_torch.engine.tersoff_compact import CompactTersoffMD
        from gpumd_tpu_torch.potentials.tersoff import (
            SI_TERSOFF,
            Tersoff1989,
        )

        if engine != "compact":
            raise ValueError("the tersoff mode has one rung: "
                             "GPUMD_BENCH_ENGINE=compact")
        pos, lengths = build_diamond(nc)
        n = len(pos)
        box = Box.orthogonal(lengths, dtype=torch.float32, device=device)
        state = make_state(pos, np.full(n, 28.085), np.zeros(n, int), box)
        pot = Tersoff1989.from_text(SI_TERSOFF, device=device)
        md = CompactTersoffMD(pot, box, n, position=pos,
                              skin=1.0 if skin is None else skin)
        return md, NVE(), initialize_velocity(state, 300.0, seed=3), None

    pos, types, lengths = build_pbte(nc, nc, nc)
    n = len(pos)
    box = Box.orthogonal(lengths, dtype=torch.float32, device=device)
    state = make_state(pos, pbte_mass(types), types, box)
    state = initialize_velocity(state, 300.0, seed=3)
    if engine == "list":
        from gpumd_tpu_torch.forcefield import ForceField

        if mode != "nep":
            raise ValueError("the list rung runs the nep mode only")
        ff = ForceField.create([bench_nep(device)], box, n, mn=112,
                               skin=1.0 if skin is None else skin,
                               per_atom_virial=False)
        return ff, NVE(), state, None
    hnemd = mode == "hnemd"
    if hnemd and engine == "v2":
        raise ValueError("the hnemd mode needs per-atom virials: "
                         "GPUMD_BENCH_ENGINE=compact or windows")
    md = DenseNEPMD(bench_nep(device), box, n, position=pos,
                    skin=1.5 if skin is None else skin,
                    engine="v2" if engine == "v2" else "compact",
                    compact_lists=engine == "compact", per_atom_virial=hnemd)
    observer = None
    if hnemd:
        from gpumd_tpu_torch.measure.properties import heat_current_total

        md.hnemd_fe = HNEMD_FE
        observer = heat_current_total
    ens = NPTBerendsen(**NPT_BARO) if mode == "npt" else NVE()
    return md, ens, state, observer


def _list_block(ff, ens, dt, n_steps):
    """(warm, block, check) of the list rung: the carry is (state, aux,
    neighbour cache), as integrate/run.py's MD loop has it.  A block
    records, on the device, whether the cache it starts from or any cache
    a rebuild made in it holds an over-full row (ForceField keeps the
    first MN neighbours of such a row and goes on), and check refuses the
    run if one did."""
    from gpumd_tpu_torch.integrate.run import make_md_step

    step = make_md_step(ff, ens, dt, observer=lambda s: None)
    mn = ff.neighbor.mn

    def warm(state):
        state = ff.compute(state)
        return (state, ens.init(state), ff.refresh_cache(state)), None

    def block(carry, aux):
        over = carry[2].count.max() > mn
        for _ in range(n_steps):
            cache = carry[2]
            carry, _ = step(carry)
            if carry[2] is not cache:  # rebuilt: no sync, one device op
                over = over | (carry[2].count.max() > mn)
        return carry, over

    def check(carry, over):
        return bool(over), carry[0].position

    return warm, block, check


def run(mode: str, target_n: int, n_steps: int, engine: str = "compact",
        skin=None, device="cuda") -> dict:
    """Time one block of `n_steps` from a warmed carry; returns the atom
    count, steps, wall seconds and peak device memory (GiB, None off the
    card)."""
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    md, ens, state, observer = setup(mode, target_n, engine, skin, device)
    dt = 1.0 / TIME_UNIT_CONVERSION
    if engine == "list":
        warm, block, check = _list_block(md, ens, dt, n_steps)
    else:
        step = md.make_step(ens, dt, observer=observer)

        def warm(state):
            carry = md.init_carry(state)
            carry = carry._replace(state=md.compute(carry.state, carry.idx))
            return carry, ens.init(carry.state)

        def block(carry, aux):
            if observer is None:
                for _ in range(n_steps):
                    carry, aux = step(carry, aux)
                return carry, None
            ys = []
            for _ in range(n_steps):
                carry, aux, _, y = step(carry, aux)
                ys.append(y)
            return carry, torch.stack(ys)

        def check(carry, ys):
            return (bool(carry.overflow),
                    ys if ys is not None else carry.state.position)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with torch.no_grad():
        carry0, aux0 = warm(state)
        block(carry0, aux0)  # warm-up
        sync()
        t0 = time.perf_counter()
        carry, ys = block(carry0, aux0)
        sync()
        wall = time.perf_counter() - t0
    overflow, out = check(carry, ys)
    if overflow or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{mode} benchmark invalid (overflow or "
                           f"non-finite)")
    return {"n": int(state.position.shape[0]), "steps": n_steps,
            "wall": wall,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if cuda else None)}


def main(device="cuda"):
    target_n = int(os.environ.get("GPUMD_BENCH_N", 1_000_000))
    n_steps = int(os.environ.get("GPUMD_BENCH_STEPS", 100))
    mode = os.environ.get("GPUMD_BENCH_MODE", "nep")
    engine = os.environ.get("GPUMD_BENCH_ENGINE", "compact")
    skin = os.environ.get("GPUMD_BENCH_SKIN")
    prepare_device(device)
    r = run(mode, target_n, n_steps, engine,
            None if skin is None else float(skin), device)
    value = r["n"] * r["steps"] / r["wall"]
    print(json.dumps({"metric": METRICS[mode], "value": value,
                      "unit": "atom_step_per_s_per_chip",
                      "vs_baseline": value / BASELINE}))
    peak = ("" if r["peak_gib"] is None
            else f" peak_memory={r['peak_gib']:.3f}GiB")
    print(f"# N={r['n']} steps={r['steps']} wall={r['wall']:.4f}s "
          f"engine={engine}{peak}", file=sys.stderr)
    return r


if __name__ == "__main__":
    main()
