"""qNEP: NEP with ANN-predicted charges and Ewald electrostatics.

Counterpart of gpumd_tpu/potentials/nep/charge.py (ref: src/force/
nep_charge.cu, ewald.cu):

  descriptors -> one hidden layer, two output heads (energy, charge)
  q -= mean(q)                      (charge neutrality, 1346-1348)
  alpha = pi / rc_radial            (344)
  real space (charge_mode 1), within rc_radial:
     E = K_C [ sum_pairs 1/2 q1 q2 erfc(alpha d)/d - alpha/sqrt(pi) q^2 ]
  reciprocal, Ewald: half-space k with |k|^2 < (2 pi alpha)^2,
     G_k = 2 (2 pi / V) exp(-k^2/(4 alpha^2)) / k^2,
     E = K_C sum_k G_k |S(k)|^2, S(k) = sum q e^{-i k r};
  or PPPM (pppm.py), the default (ref: nep_charge.cuh:179).

The charge head, the neutrality shift and both electrostatic parts sit in
one energy, differentiated by one autograd sweep with respect to two
leaves: the displacement rows r12 (the short-range part and the real-space
pairs) and the positions (the reciprocal sum).  The rows are detached
from the positions, so no term is counted twice; force = the pair force
of the r12 partials - dE/dx.  The reciprocal virial is its analytic total,
spread evenly over the atoms, as the JAX package spreads it.

The Ewald k-vectors are enumerated on the host (numpy, vectorised, the
JAX package's set and order) once for a box and kept until the box
changes; the (N, K) cos/sin sums run on the state's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.potentials.base import (
    PotentialOutput,
    _scatter_rows,
    forces_virial_from_partials,
)
from gpumd_tpu_torch.potentials.nep.model import NEP, _zbl_energy
from gpumd_tpu_torch.potentials.nep.params import (
    NepModel,
    NepParams,
    load_nep_txt,
)
from gpumd_tpu_torch.potentials.nep.pppm import (
    best_mesh,
    pppm_reciprocal_energy,
    pppm_virial_total,
)
from gpumd_tpu_torch.units import K_C, PI


def two_head_energy_charge(model: NepModel, params: NepParams, r12, t1, t2):
    """Per-atom (NEP energy, raw charge) from the shared hidden layer's two
    heads (ref: main_nep/nep_charge.cu apply_ann, two outputs)."""
    dtype = r12.dtype
    t1 = t1.long()
    q_desc, d = NEP(model, params).raw_descriptors(r12, t1, t2)
    q_scaled = q_desc * params.q_scaler.to(dtype)
    x1 = torch.tanh(torch.einsum("pd,tud->ptu", q_scaled,
                                 params.w0.to(dtype)) - params.b0.to(dtype))
    e_t = torch.einsum("ptu,tu->pt", x1, params.w1.to(dtype))
    c_t = torch.einsum("ptu,tu->pt", x1, params.w1_charge.to(dtype))
    e = torch.gather(e_t, 1, t1[:, None])[:, 0] - params.b1.to(dtype)
    charge = torch.gather(c_t, 1, t1[:, None])[:, 0]
    if model.zbl:
        e = e + torch.sum(_zbl_energy(d, t1, t2, model, params), dim=-1)
    return e, charge


def _neutral(q_raw, mask):
    """(q_raw - its mean over the real atoms) on the real atoms."""
    q_raw = q_raw * mask
    n_real = torch.clamp(torch.sum(mask), min=1.0)
    return (q_raw - torch.sum(q_raw) / n_real) * mask


def ewald_kvectors(h: np.ndarray, alpha: float):
    """Half-space k-vectors (K, 3) and their G_k (K,) for the cell h
    (columns a, b, c) in float64 (ref: ewald.cu:63-126): n1 in [0, n1max],
    n2 in [-n2max, n2max], n3 in [-n3max, n3max] in that nesting, the
    half space n1 > 0 or (n1 = 0 and (n2 > 0 or (n2 = 0 and n3 > 0))),
    |k|^2 < (2 pi alpha)^2."""
    a1, a2, a3 = h[:, 0], h[:, 1], h[:, 2]
    det = float(np.dot(a1, np.cross(a2, a3)))
    two_pi = 2.0 * np.pi
    b1 = two_pi / det * np.cross(a2, a3)
    b2 = two_pi / det * np.cross(a3, a1)
    b3 = two_pi / det * np.cross(a1, a2)
    volume_k = two_pi ** 3 / abs(det)

    def n_max(x, y):
        return int(alpha * two_pi * np.linalg.norm(np.cross(x, y))
                   / volume_k)

    m1, m2, m3 = n_max(b2, b3), n_max(b3, b1), n_max(b1, b2)
    n1, n2, n3 = (g.reshape(-1) for g in np.meshgrid(
        np.arange(0, m1 + 1), np.arange(-m2, m2 + 1),
        np.arange(-m3, m3 + 1), indexing="ij"))
    half = (n1 > 0) | (n2 > 0) | ((n2 == 0) & (n3 > 0))
    n1, n2, n3 = n1[half], n2[half], n3[half]
    k = (n1[:, None] * b1[None] + n2[:, None] * b2[None]
         + n3[:, None] * b3[None])
    ksq = k[:, 0] * k[:, 0] + k[:, 1] * k[:, 1] + k[:, 2] * k[:, 2]
    keep = ksq < (two_pi * alpha) ** 2
    k, ksq = k[keep], ksq[keep]
    gk = 2.0 * abs(two_pi / det) / ksq * np.exp(-ksq / (4.0 * alpha * alpha))
    return k, gk


class NEPCharge(NamedTuple):
    """qNEP potential: charge_mode 1 (real space and k-space) or 2
    (k-space only); k-space by PPPM (the default) or Ewald (ref:
    nep_charge.cu:46-75, the run.in `kspace` keyword)."""

    model: NepModel
    params: NepParams  # with w1_charge and sqrt_epsilon_inf
    charge_mode: int
    kspace_method: str = "pppm"
    # the PPPM mesh; () derives it from the box at each pass
    pppm_mesh: tuple = ()
    # the Ewald k-vectors of the last cell, {"key", "k" (K, 3), "g" (K,)},
    # kept across passes (from_file gives each potential its own); None
    # enumerates them at every pass
    kcache: Optional[dict] = None

    @property
    def rc(self) -> float:
        return self.model.rc_radial_max

    @staticmethod
    def from_file(path: str, dtype=torch.float32,
                  device=torch.device("cuda")) -> "NEPCharge":
        with open(path) as f:
            name = f.read(64).split()[0]
        if "charge" not in name:
            raise ValueError(f"{path}: not a charge NEP model")
        model, params = load_nep_txt(path, dtype=dtype, device=device)
        if model.charge_mode not in (1, 2):
            raise NotImplementedError(
                "only charge_mode 1 (real + k-space) and 2 (k-space only) "
                "exist (ref: nep_charge.cu:118-141)")
        return NEPCharge(model=model, params=params,
                         charge_mode=model.charge_mode, kcache={})

    # ---- pieces ----------------------------------------------------------

    def energy_and_charge(self, r12, t1, t2):
        return two_head_energy_charge(self.model, self.params, r12, t1, t2)

    def _alpha(self) -> float:
        return PI / self.model.rc_radial_max

    def real_space_energy(self, q, r12, idx, nbr_mask):
        """K_C [ 1/2 q1 q2 erfc(alpha d)/d a pair - alpha/sqrt(pi) q^2 ]."""
        alpha = self._alpha()
        rc = self.model.rc_radial_max
        d = torch.sqrt(torch.sum(r12 * r12, dim=-1))
        qq = q[:, None] * q[idx.long()]
        erfc_r = torch.special.erfc(alpha * torch.clamp(d, max=rc)) / d
        pair = torch.where((d < rc) & (nbr_mask > 0), qq * erfc_r,
                           torch.zeros_like(d))
        self_term = -(alpha / math.sqrt(PI)) * q * q
        return K_C * (0.5 * torch.sum(pair, dim=-1) + self_term)

    def kvectors(self, box: Box):
        """(k (K, 3), G_k (K,)) on the box's device in its dtype, enumerated
        on the host once for a cell and kept until it changes."""
        h = box.h.detach().cpu().numpy().astype(np.float64)
        key = (tuple(h.reshape(-1)), self._alpha(), box.h.dtype,
               box.h.device)
        cache = self.kcache if self.kcache is not None else {}
        if cache.get("key") != key:
            k, g = ewald_kvectors(h, self._alpha())
            cache.update(key=key, k=torch.as_tensor(
                k, dtype=box.h.dtype, device=box.h.device),
                g=torch.as_tensor(g, dtype=box.h.dtype, device=box.h.device))
        return cache["k"], cache["g"]

    @staticmethod
    def structure_factor(q, positions, kvec):
        """(Re S(k), Im S(k)) (K,), S(k) = sum_i q_i e^{-i k r_i}."""
        kr = positions @ kvec.T  # (N, K)
        return (torch.sum(q[:, None] * torch.cos(kr), dim=0),
                -torch.sum(q[:, None] * torch.sin(kr), dim=0))

    def reciprocal_energy(self, q, positions, kvec, gk):
        """E_rec = K_C sum over the half space of G_k |S(k)|^2 (ref: ewald.cu
        find_k_and_G; the textbook (2 pi K_C / V) sum over all k of |S|^2
        e^{-k^2/4a^2} / k^2)."""
        s_re, s_im = self.structure_factor(q, positions, kvec)
        return K_C * torch.sum(gk * (s_re ** 2 + s_im ** 2))

    # ---- the potential interface ------------------------------------------

    def compute_with_state(self, state, nbr: NeighborList) -> PotentialOutput:
        mask = state.mask
        dtype = state.position.dtype
        type_ = state.type
        t2 = type_[nbr.idx.long()]
        alpha = self._alpha()
        box = state.box
        if self.kspace_method == "pppm":
            mesh = self.pppm_mesh or best_mesh(box)
        else:
            kvec, gk = self.kvectors(box)
            kvec, gk = kvec.to(dtype), gk.to(dtype)
        with torch.enable_grad():
            r12 = nbr.r12.detach().requires_grad_(True)
            pos = state.position.detach().requires_grad_(True)
            e_nep, q_raw = self.energy_and_charge(r12, type_, t2)
            q = _neutral(q_raw, mask)
            if self.charge_mode == 1:
                e_real = self.real_space_energy(q, r12, nbr.idx, nbr.mask)
            else:
                # k-space only: no real-space pairs, no self energy (ref:
                # find_force_charge_real_space is mode-1 gated,
                # nep_charge.cu:1429)
                e_real = torch.zeros_like(q)
            if self.kspace_method == "pppm":
                e_rec, s2 = pppm_reciprocal_energy(q, pos, box, alpha, mesh)
            else:
                s_re, s_im = self.structure_factor(q, pos, kvec)
                s2 = s_re ** 2 + s_im ** 2
                e_rec = K_C * torch.sum(gk * s2)
            e_atoms = (e_nep + e_real) * mask
            p, dpos = torch.autograd.grad(torch.sum(e_atoms) + e_rec,
                                          (r12, pos))
        force_pair, virial = forces_virial_from_partials(p, nbr)
        force = force_pair - dpos
        s2 = s2.detach()
        if self.kspace_method == "pppm":
            w_rec = pppm_virial_total(s2, box, alpha, mesh, dtype)
        else:
            ksq = torch.sum(kvec * kvec, dim=1)
            pref = K_C * gk * s2
            w_rec = (torch.sum(pref) * torch.eye(3, dtype=dtype,
                                                 device=pref.device)
                     - torch.einsum("k,ka,kb->ab", pref * 2.0 * (
                         1.0 / ksq + 1.0 / (4.0 * alpha ** 2)), kvec, kvec))
        n_real = torch.clamp(torch.sum(mask), min=1.0)
        virial = virial + w_rec[None] / n_real * mask[:, None, None]
        e_atoms = e_atoms.detach() + (e_rec.detach() / n_real) * mask
        return PotentialOutput(energy=e_atoms, force=force, virial=virial)

    def charges(self, state, nbr: NeighborList):
        """The neutralised per-atom charges (N,)."""
        t2 = state.type[nbr.idx.long()]
        _, q_raw = self.energy_and_charge(nbr.r12, state.type, t2)
        return _neutral(q_raw, state.mask)

    def born_effective_charges(self, state, nbr: NeighborList):
        """Born effective charges Z*_i (N, 3, 3) in the reference's
        bond-centred gauge (ref: find_bec_diagonal/radial/angular and
        scale_bec, nep_charge.cu:~800-860): Z* = sqrt(eps_inf) [ q I +
        sum_pairs (+-1/2) r12 (x) dq_centre/dr12 ]; one sweep gives every
        pair's charge derivative, as q_i depends on its own row only."""
        types = state.type
        mask = state.mask
        t2 = types[nbr.idx.long()]
        with torch.enable_grad():
            r12 = nbr.r12.detach().requires_grad_(True)
            _, q_raw = self.energy_and_charge(r12, types, t2)
            (y,) = torch.autograd.grad(torch.sum(q_raw * mask), r12)
        q = _neutral(q_raw.detach(), mask)
        b = (0.5 * nbr.r12[..., :, None] * y[..., None, :]
             * nbr.mask[..., None, None])
        own = torch.sum(b, dim=1)
        recv = _scatter_rows(b.reshape(-1, 3, 3), nbr.idx, b.shape[0])
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        bec = own - recv + q[:, None, None] * eye
        return bec * self.params.sqrt_epsilon_inf.to(q.dtype)
