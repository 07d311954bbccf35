"""Force-constant potential (FCP), orders 2-6.

Counterpart of gpumd_tpu/potentials/fcp.py (ref: src/force/fcp.cu:
25-1130): the Taylor expansion in the displacements u = x - r0,

  E = sum_c2 1/2 u_i^a phi2_ab u_j^b + sum_c3 1/6 phi3_abc u_i^a u_j^b u_k^c
    + sum_cK w_c phiK u_i u_j ...   (orders 4-6: ordered clusters with
                                     multiplicity weights 1/prod(m!))

is one differentiable scalar of the gathered cluster displacements;
forces are its autograd gradient.  Per-atom energies and the heat-current
virial follow the reference's attribution: a cluster's energy and virial
land on its first atom, W_i[r, a] += 0.5 r0_ij,r dE_cluster/du_i,a
(orders 2 and 3, ref: gpu_find_force_fcp2/3).  The net force is zero-summed
(ref: force.cu:610-631).

Two departures from the JAX package, both where its numbers are wrong:
u is the minimum image of x - r0 (the JAX package takes x - r0 of the
wrapped positions, so an atom that leaves the box through a face gets
u = L - d: ROADMAP queue 3, item 21), and the order-3 contraction is
sum_bc phi_abc u_j^b u_k^c (the JAX einsum "cabc,cb,cc->ca" names the
cluster axis and the third Cartesian axis alike, which raises unless
there are exactly three clusters: queue 3, item 22).  The force
constants are rounded to float32 as the JAX package stores them.

Input files (ref: fcp.cu read_*):
  potential file: "fcp num_types syms..." + "order heat_order" + path
  <path>/r0.in                 N lines "x y z" equilibrium positions
  <path>/fcs_orderK.in         num_fcs, then 3^K lines "a b [c..] phi"
  <path>/clusters_orderK.in    numK, then lines "i j [k..] index"
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.potentials.base import PotentialOutput


class FCPOrder(NamedTuple):
    atoms: torch.Tensor  # (C, K) int64 cluster atom indices
    index: torch.Tensor  # (C,) int64 phi row
    phi: torch.Tensor  # (num_fcs, 3, ..., 3) K Cartesian axes
    weight: Optional[torch.Tensor] = None  # (C,) orders >= 4
    rij_half: Optional[torch.Tensor] = None  # (C, 3) orders 2-3 virial


def _weights(atoms: np.ndarray) -> np.ndarray:
    """1/prod(run length!) over the runs of equal atoms of each cluster
    (ref: fcp.cu:345-364 and the order-5/6 analogs)."""
    weight = np.ones(len(atoms))
    for c, row in enumerate(atoms):
        run = 1
        for t in range(1, len(row) + 1):
            if t < len(row) and row[t] == row[t - 1]:
                run += 1
            else:
                weight[c] /= math.factorial(run)
                run = 1
    return weight


class FCP(NamedTuple):
    order: int
    heat_order: int
    r0: torch.Tensor  # (N, 3)
    orders: tuple  # an FCPOrder per order 2..order
    rc: float = 0.0  # no neighbour list needed

    @staticmethod
    def from_file(path: str, workdir: str = ".", dtype=torch.float64,
                  device=torch.device("cuda")) -> "FCP":
        with open(path) as f:
            toks = f.read().split()
        if toks[0] != "fcp":
            raise ValueError(f"{path}: not an fcp file")
        p = 2 + int(toks[1])  # skip the symbols
        order, heat_order = int(toks[p]), int(toks[p + 1])
        if heat_order not in (2, 3):
            raise ValueError("heat current order should be 2 or 3")
        fdir = toks[p + 2]
        if not os.path.isabs(fdir):
            fdir = os.path.join(workdir, fdir)
        r0 = np.loadtxt(os.path.join(fdir, "r0.in"))
        n = len(r0)

        def ten(x, dt=dtype):
            return torch.as_tensor(x, dtype=dt, device=device)

        orders = []
        for k in range(2, order + 1):
            with open(os.path.join(fdir, f"fcs_order{k}.in")) as f:
                fc = f.read().split()
            num_fcs = int(fc[0])
            # each line: k Cartesian indices, then the value
            vals = np.asarray(fc[1:1 + num_fcs * 3 ** k * (k + 1)],
                              dtype=np.float64).reshape(-1, k + 1)[:, k]
            phi = vals.reshape((num_fcs,) + (3,) * k).astype(np.float32)
            with open(os.path.join(fdir, f"clusters_order{k}.in")) as f:
                cl = f.read().split()
            arr = np.asarray(cl[1:], dtype=np.int64).reshape(int(cl[0]),
                                                             k + 1)
            atoms = arr[:, :k]
            if (atoms >= n).any() or (atoms < 0).any():
                raise ValueError(f"clusters_order{k}.in: atom out of range")
            weight = (ten(_weights(atoms).astype(np.float32))
                      if k >= 4 else None)
            orders.append(FCPOrder(atoms=ten(atoms, torch.int64),
                                   index=ten(arr[:, k], torch.int64),
                                   phi=ten(phi), weight=weight))
        return FCP(order=order, heat_order=heat_order, r0=ten(r0),
                   orders=tuple(orders))

    def attach_box(self, box: Box) -> "FCP":
        """The minimum-image half bonds of the order-2/3 virial (ref:
        fcp.cu:158-166, 240-248)."""
        out = []
        for k, od in enumerate(self.orders, start=2):
            if k <= 3:
                rij = self.r0[od.atoms[:, 1]] - self.r0[od.atoms[:, 0]]
                rij = box.minimum_image(rij.to(box.h.dtype))
                od = od._replace(rij_half=0.5 * rij.to(self.r0.dtype))
            out.append(od)
        return self._replace(orders=tuple(out))

    def displacements(self, positions, box: Box, mask):
        """u = the minimum image of x - r0, zero on padding atoms."""
        u = box.minimum_image(positions - self.r0.to(positions.dtype))
        return u * mask[:, None]

    def _cluster_energies(self, u, od: FCPOrder, k: int):
        """Per-cluster energies (C,) and, for orders 2-3, dE/du of the
        first atom (C, 3) as the reference's virial takes it."""
        phi = od.phi.to(u.dtype)[od.index]
        us = [u[od.atoms[:, t]] for t in range(k)]
        if k == 2:
            g = torch.einsum("cab,cb->ca", phi, us[1])
            return 0.5 * torch.sum(us[0] * g, dim=-1), g
        if k == 3:
            g = torch.einsum("cabd,cb,cd->ca", phi, us[1], us[2])
            return torch.sum(us[0] * g, dim=-1) / 6.0, 0.5 * g
        g = phi  # contract the last slots first, leaving the first
        for t in range(k - 1, 0, -1):
            g = torch.einsum("c...a,ca->c...", g, us[t])
        return od.weight.to(u.dtype) * torch.sum(us[0] * g, dim=-1), None

    def energies(self, u):
        """Per-atom energies (N,): each cluster's on its first atom."""
        e_atom = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
        for k, od in enumerate(self.orders, start=2):
            e_c, _ = self._cluster_energies(u, od, k)
            e_atom = e_atom.index_add(0, od.atoms[:, 0], e_c)
        return e_atom

    def compute_with_state(self, state, nbr=None) -> PotentialOutput:
        mask = state.mask
        with torch.enable_grad():
            pos = state.position.detach().requires_grad_(True)
            e_atom = self.energies(self.displacements(pos, state.box, mask))
            (dpos,) = torch.autograd.grad(torch.sum(e_atom), pos)
        force = -dpos * mask[:, None]
        n_real = torch.clamp(torch.sum(mask), min=1.0)
        force = (force - torch.sum(force, dim=0) / n_real) * mask[:, None]
        # the heat-current virial: orders 2..heat_order (at most 3)
        u = self.displacements(state.position, state.box, mask)
        w = torch.zeros((u.shape[0], 3, 3), dtype=u.dtype, device=u.device)
        for k, od in enumerate(self.orders, start=2):
            if k > min(self.heat_order, 3):
                continue
            _, de_first = self._cluster_energies(u, od, k)
            wc = od.rij_half.to(u.dtype)[:, :, None] * de_first[:, None, :]
            w = w.index_add(0, od.atoms[:, 0], wc)
        return PotentialOutput(energy=e_atom.detach(), force=force,
                               virial=w)
