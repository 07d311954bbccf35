"""The list path's block size, timed in turns in one process.

The general path's NEP force pass takes energy and gradient a block of
atoms at a time (potentials/base.py::energy_and_partials); a block costs
~650 torch operators whatever its size, so on the card the block size sets
how many launches a step issues, and the graph of one block how much
memory the pass holds.  This probe steps NEP PbTe on the list path
(ForceField MN 112, skin 1.0, total virials, the trained model of
artifacts/trainer_parity_r5_nep.txt in f32, 300 K, dt 1 fs, NVE) with
potentials/nep/model.py's CARD_BLOCK set to each size in turn, from one
warmed carry, and prints for each turn the ms a step over a block of
steps and the peak device memory over the carry:

  python -m gpumd_tpu_torch.probes.ab_list_block [--cells 32] \\
      [--steps 10] [--blocks 4096,32768,32768,4096,65536]

(4,096 is the JAX package's block, which bounds TPU memory; 32,768 the
card's.)  It needs the card.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from gpumd_tpu_torch.probes import device_name, probe_device

MODEL = Path(__file__).resolve().parents[2] / "artifacts" / \
    "trainer_parity_r5_nep.txt"


def main(argv=None):
    from gpumd_tpu_torch.bench import (
        build_pbte,
        pbte_mass,
        prepare_device,
    )
    from gpumd_tpu_torch.forcefield import ForceField
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.integrate.run import make_md_step
    from gpumd_tpu_torch.integrate.velocity import initialize_velocity
    from gpumd_tpu_torch.model.box import Box
    from gpumd_tpu_torch.model.state import make_state
    from gpumd_tpu_torch.potentials.nep import model as nep_model
    from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--blocks", default="4096,32768,32768,4096,65536")
    args = ap.parse_args(argv)
    dev = probe_device("cuda")
    prepare_device(dev)
    pos, types, lengths = build_pbte(args.cells, args.cells, args.cells)
    n = len(pos)
    nep = nep_model.NEP.from_file(str(MODEL), dtype=torch.float32)
    box = Box.orthogonal(lengths, dtype=torch.float32)
    state = initialize_velocity(make_state(pos, pbte_mass(types), types, box),
                                300.0, seed=3)
    ff = ForceField.create([nep], box, n, mn=112, skin=1.0,
                           per_atom_virial=False)
    ens = NVE()
    step = make_md_step(ff, ens, 1.0 / TIME_UNIT_CONVERSION,
                        observer=lambda s: None)
    print(f"[ab_list_block] {device_name(dev)}: PbTe n={n}, "
          f"{ff.neighbor}")
    keep = nep_model.CARD_BLOCK
    try:
        with torch.no_grad():
            state = ff.compute(state)
            carry = (state, ens.init(state), ff.refresh_cache(state))
            for blk in (int(b) for b in args.blocks.split(",")):
                nep_model.CARD_BLOCK = blk
                carry, _ = step(carry)  # warm-up at this size
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    carry, _ = step(carry)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0) / args.steps
                peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
                print(f"[ab_list_block] {blk} atoms a block: {ms:.3f} "
                      f"ms/step, {n / ms * 1e3:.6e} atom-step/s, peak over "
                      f"the carry {peak:.3f} GiB", flush=True)
    finally:
        nep_model.CARD_BLOCK = keep
    if not bool(torch.isfinite(carry[0].position).all()):
        raise RuntimeError("the list path went non-finite")


if __name__ == "__main__":
    main()
