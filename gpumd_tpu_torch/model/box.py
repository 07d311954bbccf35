"""Simulation box: triclinic h-matrix, minimum image, volume/thickness.

Counterpart of gpumd_tpu/model/box.py (ref: src/model/box.cuh:18-129).
The columns of h are the lattice vectors a, b, c, so r = h @ s for
fractional s; model.xyz's `Lattice=` rows give h = lattice.T.  Products
with h are written per component (`_matvec3`), exactly as in the JAX
package, so both packages bin atoms identically.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def inv3(h: torch.Tensor) -> torch.Tensor:
    """Explicit 3x3 inverse via the adjugate (rows = reciprocal vectors)."""
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    bxc = torch.linalg.cross(b, c)
    cxa = torch.linalg.cross(c, a)
    axb = torch.linalg.cross(a, b)
    det = torch.sum(a * bxc)
    return torch.stack([bxc, cxa, axb], dim=0) / det


def _matvec3(m: torch.Tensor, v):
    """y_k = sum_j m[k, j] v_j for v of shape (..., 3) or a list of three
    (...,) components; returns a list of components."""
    if isinstance(v, (list, tuple)):
        vx, vy, vz = v
    else:
        vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    m = m.to(vx.dtype)
    return [m[k, 0] * vx + m[k, 1] * vy + m[k, 2] * vz for k in range(3)]


class Box(NamedTuple):
    """Triclinic periodic box.

    h: (3, 3) lattice vectors as columns; h_inv: its inverse;
    pbc: (3,) float mask, 1.0 where periodic.
    """

    h: torch.Tensor
    h_inv: torch.Tensor
    pbc: torch.Tensor

    @staticmethod
    def from_lattice(lattice, pbc=(True, True, True), dtype=torch.float64,
                     device=torch.device("cuda")) -> "Box":
        """Build from a row-major lattice (rows = a, b, c), on the card
        unless `device` says otherwise."""
        lat = torch.as_tensor(np.asarray(lattice, np.float64).reshape(3, 3),
                              dtype=dtype, device=device)
        h = lat.T.contiguous()
        return Box(h=h, h_inv=inv3(h),
                   pbc=torch.as_tensor([float(bool(p)) for p in pbc],
                                       dtype=dtype, device=device))

    @staticmethod
    def orthogonal(lengths, pbc=(True, True, True), dtype=torch.float64,
                   device=torch.device("cuda")) -> "Box":
        return Box.from_lattice(np.diag(np.asarray(lengths, np.float64)),
                                pbc=pbc, dtype=dtype, device=device)

    def with_h(self, h) -> "Box":
        """A box with the lattice `h` (e.g. after a barostat step), on this
        box's device and in its dtype."""
        h = torch.as_tensor(h, dtype=self.h.dtype, device=self.h.device)
        return Box(h=h, h_inv=inv3(h), pbc=self.pbc)

    @property
    def volume(self):
        a, b, c = self.h[:, 0], self.h[:, 1], self.h[:, 2]
        return torch.abs(torch.sum(a * torch.linalg.cross(b, c)))

    def thickness(self) -> torch.Tensor:
        """Perpendicular slab thicknesses d_k = V / |cross of the other two|."""
        a, b, c = self.h[:, 0], self.h[:, 1], self.h[:, 2]
        v = torch.abs(torch.dot(a, torch.linalg.cross(b, c)))
        areas = torch.stack([
            torch.linalg.norm(torch.linalg.cross(b, c)),
            torch.linalg.norm(torch.linalg.cross(c, a)),
            torch.linalg.norm(torch.linalg.cross(a, b)),
        ])
        return v / areas

    def minimum_image(self, r12):
        """Minimum-image displacements (..., 3); non-periodic axes untouched."""
        s = _matvec3(self.h_inv, r12)
        pbc = self.pbc.to(s[0].dtype)
        s = [si - torch.round(si) * pbc[k] for k, si in enumerate(s)]
        return torch.stack(_matvec3(self.h, s), dim=-1)

    def wrap(self, positions):
        """Wrap into the primary cell [0, 1) along periodic directions."""
        s = _matvec3(self.h_inv, positions)
        pbc = self.pbc.to(s[0].dtype)
        s = [si - torch.floor(si) * pbc[k] for k, si in enumerate(s)]
        return torch.stack(_matvec3(self.h, s), dim=-1)

    def fractional(self, positions):
        return torch.stack(_matvec3(self.h_inv, positions), dim=-1)

    def cartesian(self, frac):
        return torch.stack(_matvec3(self.h, frac), dim=-1)


def num_replicas_for_cutoff(box: Box, rc: float) -> tuple:
    """Host-side: periodic images needed per direction so every neighbour
    within rc is found (the reference's small-box expanded box, ref:
    src/force/nep.cu:1141+).  0 for non-periodic directions.  Reads the
    box's thickness back to the host."""
    t = box.thickness().tolist()
    pbc = box.pbc.tolist()
    reps = []
    for d in range(3):
        if pbc[d] > 0:
            # after MIC the fractional displacement is in [-1/2, 1/2]; an
            # image shift n can still land within rc iff |n| <= rc/t + 1/2
            m = int(np.ceil(rc / float(t[d]) + 0.5 - 1e-9)) - 1
            reps.append(max(0, m))
        else:
            reps.append(0)
    return tuple(reps)
