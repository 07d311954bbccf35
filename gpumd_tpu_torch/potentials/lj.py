"""Lennard-Jones pair potential with per-type-pair parameters.

Counterpart of gpumd_tpu/potentials/lj.py.  File format and conventions
match the reference (ref: src/force/lj.cu:28-75):

    lj <num_types> <sym1> ...
    eps(0,0) sigma(0,0) cutoff(0,0)
    eps(0,1) ...                      # num_types^2 rows, row-major

u(r) = 4 eps [(sigma/r)^12 - (sigma/r)^6], unshifted, with a hard cutoff
per type pair; an atom takes u/2 of each ordered pair.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.potentials.base import (
    PotentialOutput,
    compute_from_pair_energy,
)


class LJ(NamedTuple):
    s6e4: torch.Tensor  # (T, T) 4 eps sigma^6
    s12e4: torch.Tensor  # (T, T) 4 eps sigma^12
    cutoff_sq: torch.Tensor  # (T, T)
    rc: float  # host-side largest cutoff

    @staticmethod
    def from_params(epsilon, sigma, cutoff, dtype=torch.float64,
                    device=torch.device("cuda")) -> "LJ":
        """From (T, T) arrays (or scalars for one type), on the card
        unless `device` says otherwise."""
        eps = np.atleast_2d(np.asarray(epsilon, dtype=np.float64))
        sig = np.atleast_2d(np.asarray(sigma, dtype=np.float64))
        cut = np.atleast_2d(np.asarray(cutoff, dtype=np.float64))

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return LJ(s6e4=t(4.0 * eps * sig ** 6), s12e4=t(4.0 * eps * sig ** 12),
                  cutoff_sq=t(cut ** 2), rc=float(np.max(cut)))

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "LJ":
        """Parse a GPUMD LJ potential file."""
        with open(path) as f:
            tokens = f.read().split()
        if tokens[0] != "lj":
            raise ValueError(f"{path}: not an LJ potential file")
        t = int(tokens[1])
        vals = [float(x) for x in tokens[2 + t:]]
        if len(vals) < 3 * t * t:
            raise ValueError(f"{path}: expected {3 * t * t} LJ parameters")
        arr = np.array(vals[:3 * t * t]).reshape(t, t, 3)
        return LJ.from_params(arr[..., 0], arr[..., 1], arr[..., 2],
                              dtype=dtype, device=device)

    def pair_energies(self, r12, t1, t2):
        """Per-atom energies (B,) from displacements (B, MN, 3) and the
        centre / neighbour types; padded slots fall outside every cutoff."""
        d2 = torch.sum(r12 * r12, dim=-1)  # (B, MN)
        t1 = t1.long()[:, None]
        t2 = t2.long()
        s6 = self.s6e4[t1, t2].to(d2.dtype)
        s12 = self.s12e4[t1, t2].to(d2.dtype)
        csq = self.cutoff_sq[t1, t2].to(d2.dtype)
        inv2 = 1.0 / d2
        inv6 = inv2 * inv2 * inv2
        u = s12 * inv6 * inv6 - s6 * inv6
        u = torch.where(d2 < csq, u, torch.zeros_like(u))
        return 0.5 * torch.sum(u, dim=-1)

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        t2 = type_[nbr.idx.long()]
        return compute_from_pair_energy(
            lambda r12, rows: self.pair_energies(r12, type_[rows], t2[rows]),
            nbr, mask, per_atom_virial=per_atom_virial)
