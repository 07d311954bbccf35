"""NVE energy-drift gate of the port: a long f32 run on the default rung.

Twin of the JAX package's scripts/drift_gate.py.  It measures the drift of
the total energy in eV/atom/ns for the configuration that ships: f32 NEP
PbTe on the compact engine's default rung (compact candidate lists, skin
1.5 A), with compensated (TwoSum) positions and velocities.  The north
star's gate is < 1e-5 eV/atom/ns (BASELINE.md).

Method: make_state(compensated=True), initialize_velocity(300 K, seed=3),
NVE blocks of 1000 steps; after each block the total energy is summed in
f64 on the host from the per-atom f32 values (one copy a block); the drift
is the slope of a linear fit over the samples after the first 10%
(thermal transient), over the atom count.

  python -m gpumd_tpu_torch.scripts.drift_gate

prints one JSON line {"metric": "nve_drift", "value", "unit", "n_atoms",
"sim_ps", "gate", "pass", "e_first", "e_last"}.  Environment:
GPUMD_DRIFT_N (atoms, default 32,000: 32,768 on the lattice),
GPUMD_DRIFT_PS (50 ps), GPUMD_DRIFT_DT (fs, 1.0), GPUMD_DRIFT_MODEL (a
nep.txt whose symbols are Te Pb or Pb Te; default the trained NEP4 Te/Pb
model in artifacts/trainer_parity_r5_nep.txt).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

GATE = 1e-5  # eV/atom/ns
MODEL = (Path(__file__).resolve().parents[2] / "artifacts"
         / "trainer_parity_r5_nep.txt")


def load_pbte_model(path, types, device):
    """The NEP at `path` in f32, and the bench geometry's types (0 = Te,
    1 = Pb) in the model's symbol order."""
    from gpumd_tpu_torch.potentials.nep.model import NEP

    nep = NEP.from_file(str(path), dtype=torch.float32, device=device)
    syms = tuple(nep.model.symbols)
    if syms == ("Pb", "Te"):
        types = 1 - types
    elif syms != ("Te", "Pb"):
        raise SystemExit(f"unexpected symbols {syms}")
    return nep, types


def total_energy(state) -> float:
    """Potential plus kinetic energy, summed in f64 on the host."""
    s = state
    m = s.mask.double()
    pe = torch.sum(s.potential_energy.double() * m)
    v = s.velocity.double()
    ke = 0.5 * torch.sum(s.mass.double() * m * torch.sum(v * v, dim=1))
    return float((pe + ke).cpu())


def drift(times_ns, energies, n_atoms) -> float:
    """|slope| / N of a linear fit after the first 10% of the samples."""
    times_ns, energies = np.asarray(times_ns), np.asarray(energies)
    k0 = max(1, len(times_ns) // 10)
    slope, _ = np.polyfit(times_ns[k0:], energies[k0:], 1)
    return abs(slope) / n_atoms


def run_drift(target_n: int, ps: float, dt_fs: float = 1.0,
              model=MODEL, device="cuda", block: int = 1000,
              samples: Optional[list] = None) -> dict:
    """The drift run; returns the JSON line's fields.  `samples`, when
    given, receives each block's (time in ns, total energy in eV)."""
    from gpumd_tpu_torch.bench import (
        build_pbte,
        cells_for,
        pbte_mass,
        prepare_device,
    )
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.integrate.velocity import initialize_velocity
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    n_steps = int(round(ps * 1000.0 / dt_fs))
    prepare_device(device)
    nc = cells_for(target_n)
    pos, types, lengths = build_pbte(nc, nc, nc)
    n = len(pos)
    nep, types = load_pbte_model(model, types, device)
    box = Box.orthogonal(lengths, dtype=torch.float32, device=device)
    state = make_state(pos, pbte_mass(types), types, box, compensated=True)
    state = initialize_velocity(state, 300.0, seed=3)
    dt = dt_fs / TIME_UNIT_CONVERSION
    md = DenseNEPMD(nep, box, n, position=pos, skin=1.5)
    print(f"# N={n} engine={md.engine} cl={md.cplan.cl} steps={n_steps} "
          f"block={block}", file=sys.stderr)
    ens = NVE()
    times, energies = [], []
    t0 = time.time()
    done = 0
    with torch.no_grad():
        carry = md.init_carry(state)
        carry = carry._replace(state=md.compute(carry.state, carry.idx))
        aux = ens.init(carry.state)
        step = md.make_step(ens, dt)
        while done < n_steps:
            for _ in range(block):
                carry, aux = step(carry, aux)
            done += block
            if bool(carry.overflow):
                raise RuntimeError("overflow during drift run")
            e = total_energy(carry.state)
            if not np.isfinite(e):
                raise RuntimeError("non-finite energy during drift run")
            times.append(done * dt_fs * 1e-6)  # ns
            energies.append(e)
            if samples is not None:
                samples.append((times[-1], e))
            if done % (10 * block) == 0:
                print(f"# step {done}: E={e:.6f} eV "
                      f"({time.time() - t0:.0f}s)", file=sys.stderr)
    value = drift(times, energies, n)
    return {"metric": "nve_drift", "value": value,
            "unit": "eV_per_atom_per_ns", "n_atoms": n,
            "sim_ps": done * dt_fs * 1e-3, "gate": GATE,
            "pass": bool(value < GATE), "e_first": float(energies[0]),
            "e_last": float(energies[-1])}


def main(device="cuda", block: int = 1000) -> dict:
    out = run_drift(int(os.environ.get("GPUMD_DRIFT_N", 32000)),
                    float(os.environ.get("GPUMD_DRIFT_PS", 50.0)),
                    float(os.environ.get("GPUMD_DRIFT_DT", 1.0)),
                    os.environ.get("GPUMD_DRIFT_MODEL", str(MODEL)),
                    device, block)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
