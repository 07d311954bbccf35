"""HNEMD thermal-conductivity sanity run of the port (BASELINE config 4's
physics check).

Twin of the JAX package's scripts/hnemd_kappa_sanity.py.  It runs
homogeneous-NEMD heat transport of PbTe with a trained NEP on the compact
engine's default rung with per-atom virials, and reports the running
thermal conductivity

    kappa_x = KAPPA_UNIT_CONVERSION * <J_x> / (V * T * Fe)

(ref: src/measure/hnemd_kappa.cu; J_i = W_i v_i per compute_heat.cu:18-29).
The point is a sanity value (PbTe at 300 K is a low-kappa thermoelectric,
~2 W/mK measured), not a converged production number.  Equilibration
under NVTBDP (300 K, coupling 100), then production with the driving
force, still under NVTBDP, in blocks of 1000 steps with the heat-current
observer; a block's currents stay on the card and come to the host at its
end.

  python -m gpumd_tpu_torch.scripts.hnemd_kappa_sanity

prints one JSON line {"metric": "hnemd_kappa_pbte_300K",
"kappa_x_W_per_mK", "kappa_x_half_window", "n_atoms", "steps", "fe_per_A",
"throughput_atom_step_per_s"}.  Environment: GPUMD_KAPPA_N (32768),
GPUMD_KAPPA_EQ (equilibration steps, 2000), GPUMD_KAPPA_STEPS
(production, 20000), GPUMD_KAPPA_FE (1/A, 1e-4).  The model is the
drift gate's default, artifacts/trainer_parity_r5_nep.txt.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from gpumd_tpu_torch.scripts.drift_gate import MODEL, load_pbte_model


def main(device="cuda", block: int = 1000) -> dict:
    from gpumd_tpu_torch.bench import (
        build_pbte,
        cells_for,
        pbte_mass,
        prepare_device,
    )
    from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
    from gpumd_tpu_torch.integrate.ensembles.nvt import NVTBDP
    from gpumd_tpu_torch.integrate.velocity import initialize_velocity
    from gpumd_tpu_torch.measure.properties import heat_current_total
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.units import (
        KAPPA_UNIT_CONVERSION,
        TIME_UNIT_CONVERSION,
    )

    target_n = int(os.environ.get("GPUMD_KAPPA_N", 32768))
    eq_steps = int(os.environ.get("GPUMD_KAPPA_EQ", 2000))
    n_steps = int(os.environ.get("GPUMD_KAPPA_STEPS", 20000))
    fe_x = float(os.environ.get("GPUMD_KAPPA_FE", 1.0e-4))
    temperature = 300.0
    prepare_device(device)

    nc = cells_for(target_n)
    pos, types, lengths = build_pbte(nc, nc, nc)
    n = len(pos)
    nep, types = load_pbte_model(MODEL, types, device)
    box = Box.orthogonal(lengths, dtype=torch.float32, device=device)
    state = make_state(pos, pbte_mass(types), types, box)
    state = initialize_velocity(state, temperature, seed=7)
    dt = 1.0 / TIME_UNIT_CONVERSION
    volume = float(np.prod(lengths))
    md = DenseNEPMD(nep, box, n, position=pos, skin=1.5,
                    per_atom_virial=True)
    ens = NVTBDP(t0=temperature, t1=temperature, coupling=100.0)

    def run_block(carry, aux, steps, step):
        ys = []
        for _ in range(steps):
            carry, aux, _, y = step(carry, aux)
            ys.append(y)
        return carry, aux, torch.stack(ys)

    with torch.no_grad():
        carry = md.init_carry(state)
        carry = carry._replace(state=md.compute(carry.state, carry.idx))
        aux = ens.init(carry.state)
        t0 = time.time()
        # equilibration (no driving force)
        carry, aux, _ = run_block(carry, aux, eq_steps,
                                  md.make_step(ens, dt, heat_current_total))
        if bool(carry.overflow):
            raise SystemExit("kappa run invalid (overflow in equilibration)")
        print(f"# equilibrated {eq_steps} steps in {time.time() - t0:.1f}s",
              file=sys.stderr)
        # production with the HNEMD driving force
        md.hnemd_fe = (fe_x, 0.0, 0.0)
        step = md.make_step(ens, dt, heat_current_total)
        t0 = time.time()
        js_all = []
        for i in range(n_steps // block):
            carry, aux, js = run_block(carry, aux, block, step)
            js_all.append(js.double().cpu().numpy())
            print(f"# block {i + 1}/{n_steps // block}", file=sys.stderr)
        wall = time.time() - t0
    js = np.concatenate(js_all, axis=0)
    if bool(carry.overflow) or not np.isfinite(js).all():
        raise SystemExit("kappa run invalid (overflow/non-finite)")
    factor = KAPPA_UNIT_CONVERSION / (volume * temperature * fe_x)
    kappa_run = np.cumsum(js[:, 0]) / np.arange(1, len(js) + 1) * factor
    out = {"metric": "hnemd_kappa_pbte_300K",
           "kappa_x_W_per_mK": float(kappa_run[-1]),
           "kappa_x_half_window": float(kappa_run[len(js) // 2]),
           "n_atoms": n, "steps": n_steps, "fe_per_A": fe_x,
           "throughput_atom_step_per_s": n * n_steps / wall}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
