"""A synthetic PbTe training set for the NEP trainers (BASELINE config 5).

    python -m gpumd_tpu_torch.scripts.pbte_train_set OUT_DIR [--frames 25]
        [--cells 3] [--model artifacts/trainer_parity_r5_nep.txt]
        [--device cpu]

Config 5 trains on the reference's PbTe train.xyz (examples/nep_train/),
which is not in this repository.  This writes a stand-in: rocksalt PbTe
frames of 8 n^3 atoms (n^3 conventional cells), the lattice constant 6.46 A
scaled by U(0.97, 1.03) a frame and every atom jittered by N(0, 0.1 A),
from a fixed numpy seed; each labelled with energy, forces and a
9-component virial by a NEP model through the port's list path
(ForceField) in float64, and written with io.xyz.write_xyz.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.io.xyz import XYZFrame, write_xyz
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state

A0 = 6.46
_BASE = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                  [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
_TYPES = np.array([1, 1, 1, 1, 0, 0, 0, 0])  # 0 = Te, 1 = Pb


def pbte_frames(n_frames: int, cells: int, seed: int = 20260816,
                jitter: float = 0.1):
    """[(positions (N, 3), types (N,), edge length)] of jittered rocksalt
    PbTe cubes of `cells`^3 conventional cells."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(cells)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    unit = (grid[:, None, :] + _BASE[None]).reshape(-1, 3)
    types = np.tile(_TYPES, len(grid))
    out = []
    for _ in range(n_frames):
        a0 = A0 * rng.uniform(0.97, 1.03)
        pos = unit * a0 + rng.normal(0.0, jitter, unit.shape)
        out.append((pos, types, cells * a0))
    return out


def write_train_set(path, nep, n_frames: int = 25, cells: int = 3,
                    seed: int = 20260816, jitter: float = 0.1,
                    device=torch.device("cuda")):
    """Write the frames of `pbte_frames`, labelled by `nep` (a NEP of
    types Te Pb, in float64 on `device`) through ForceField, to the
    extended-XYZ file `path`."""
    Path(path).unlink(missing_ok=True)
    symbols = nep.model.symbols
    for pos, types, edge in pbte_frames(n_frames, cells, seed, jitter):
        n = len(pos)
        box = Box.orthogonal([edge] * 3, dtype=torch.float64, device=device)
        ff = ForceField.create([nep], box, n, mn=128)
        st = ff.compute(make_state(pos, np.ones(n), types, box))
        if bool(ff.neighbor.build(st.position, box, st.mask).overflowed()):
            raise RuntimeError("neighbour overflow while labelling")
        virial = torch.sum(st.virial, dim=0).cpu().numpy().ravel()
        frame = XYZFrame(symbols=[symbols[t] for t in types], positions=pos,
                         lattice=np.diag([edge] * 3),
                         forces=st.force.cpu().numpy())
        write_xyz(str(path), frame, append=True, with_forces=True,
                  extra_info={
                      "energy": f"{float(st.potential_energy.sum()):.10f}",
                      "virial": '"' + " ".join(f"{x:.10f}" for x in virial)
                      + '"'})


def main(argv=None):
    from gpumd_tpu_torch.potentials.nep.model import NEP

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--cells", type=int, default=3)
    ap.add_argument("--model", default=str(
        Path(__file__).resolve().parents[2] / "artifacts"
        / "trainer_parity_r5_nep.txt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    nep = NEP.from_file(args.model, dtype=torch.float64, device=args.device)
    write_train_set(os.path.join(args.out_dir, "train.xyz"), nep,
                    args.frames, args.cells, device=args.device)


if __name__ == "__main__":
    main()
