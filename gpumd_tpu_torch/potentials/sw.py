"""Stillinger-Weber potential (the sw_1985 file; the sw_ilp intralayer
model's form).

Counterpart of gpumd_tpu/potentials/sw.py (ref: src/force/ilp_tmd_sw.cu:
146-1300):

  2-body: p2 = A_eps exp(1/(r/sigma - a)) (B (sigma/r)^4 - 1),  r < sigma a
  3-body: lambda exp(gamma12/(r12/s12 - a12) + gamma13/(r13/s13 - a13))
                 * dcos^2,   dcos = smooth(cos(theta) - cos0)

with the TMD angular smoothing (dcos tapered to zero over |dcos| in
[_D1, _D2]).  The per-atom energy is written once; potentials/base.py
differentiates it a block of MANY_BODY_BLOCK centres at a time, so the
(B, MN, MN) angle tensors of one block are alive at a time.

File formats (ref: initialize_sw_1985_{1,2,3}): 1 element = one row
[epsilon lambda A B a gamma sigma cos0]; 2/3 elements = per-pair 2-body
rows [A B a sigma gamma] + per-triple rows [lambda cos0].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.potentials import base
from gpumd_tpu_torch.potentials.base import (
    PotentialOutput,
    compute_from_pair_energy,
)

_D1, _D2 = 0.25, 0.35  # TMD delta_cos taper window


class SW(NamedTuple):
    a_eps: torch.Tensor  # (T, T) epsilon * A
    b: torch.Tensor
    a: torch.Tensor
    sigma: torch.Tensor
    gamma: torch.Tensor
    rc_pair: torch.Tensor  # sigma * a
    lam: torch.Tensor  # (T, T, T) epsilon * lambda
    cos0: torch.Tensor  # (T, T, T)
    num_types: int
    rc: float

    @staticmethod
    def from_tokens(vals, num_types: int, dtype=torch.float64,
                    device=torch.device("cuda")) -> "SW":
        t = num_types
        if t == 1:
            eps, lam, aa, bb, a_, gam, sig, c0 = vals[:8]
            a2 = np.full((1, 1), eps * aa)
            b2, aarr = np.full((1, 1), bb), np.full((1, 1), a_)
            sarr, garr = np.full((1, 1), sig), np.full((1, 1), gam)
            lam3 = np.full((1, 1, 1), eps * lam)
            c3 = np.full((1, 1, 1), c0)
        elif t == 2:
            # 3 rows [A B a sigma gamma] indexed by n1 + n2 (0, 1, 2)
            rows = np.asarray(vals[:15]).reshape(3, 5)
            a2, b2, aarr, sarr, garr = (np.zeros((2, 2)) for _ in range(5))
            for n1 in range(2):
                for n2 in range(2):
                    r = rows[n1 + n2]
                    a2[n1, n2], b2[n1, n2], aarr[n1, n2] = r[0], r[1], r[2]
                    sarr[n1, n2], garr[n1, n2] = r[3], r[4]
            tb = np.asarray(vals[15:15 + 16]).reshape(8, 2)
            lam3 = tb[:, 0].reshape(2, 2, 2)
            c3 = tb[:, 1].reshape(2, 2, 2)
        else:
            rows = np.asarray(vals[:t * t * 5]).reshape(t, t, 5)
            a2, b2 = rows[..., 0], rows[..., 1]
            aarr, sarr, garr = rows[..., 2], rows[..., 3], rows[..., 4]
            tb = np.asarray(vals[t * t * 5:t * t * 5 + t ** 3 * 2]
                            ).reshape(t, t, t, 2)
            lam3, c3 = tb[..., 0], tb[..., 1]
        rc_pair = sarr * aarr

        def ten(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                   device=device)

        return SW(a_eps=ten(a2), b=ten(b2), a=ten(aarr), sigma=ten(sarr),
                  gamma=ten(garr), rc_pair=ten(rc_pair), lam=ten(lam3),
                  cos0=ten(c3), num_types=t, rc=float(rc_pair.max()))

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "SW":
        """Read an `sw_1985` file (or a headerless embedded block); the
        tables go on the card unless `device` says otherwise."""
        with open(path) as f:
            toks = f.read().split()
        if toks and toks[0] == "sw_1985":
            t = int(toks[1])
            vals = [float(x) for x in toks[2 + t:]]
        else:
            vals = [float(x) for x in toks]
            n = len(vals)
            t = 1 if n == 8 else (2 if n == 31 else 3)
        return SW.from_tokens(vals, t, dtype=dtype, device=device)

    def per_atom_energy(self, r12, t1, t2, nbr_mask):
        """Per-atom energies (B,) from r12 (B, MN, 3), the centre types,
        the neighbour types (B, MN) and the slot mask (B, MN)."""
        dtype = r12.dtype
        t1, t2 = t1.long(), t2.long()
        d2 = torch.sum(r12 * r12, dim=-1)
        d = torch.sqrt(torch.clamp(d2, min=1e-12))

        def p2tab(tab):
            return tab[t1[:, None], t2].to(dtype)

        sig = p2tab(self.sigma)
        ok = (nbr_mask > 0) & (d < p2tab(self.rc_pair))
        rr = d / sig
        # guarded exponent: 1/(r/sigma - a) diverges at the cutoff
        inv = 1.0 / torch.clamp(rr - p2tab(self.a), max=-1e-3)
        e2 = p2tab(self.a_eps) * torch.exp(inv) * (
            p2tab(self.b) / torch.clamp(rr, min=1e-6) ** 4 - 1.0)
        zero = torch.zeros_like(e2)
        e2 = torch.where(ok, 0.5 * e2, zero)

        # 3-body: the pairs (m, k) of a centre's neighbour slots
        gam_term = torch.where(ok, p2tab(self.gamma) * inv,
                               torch.full_like(e2, -60.0))
        dot = torch.einsum("nmx,nkx->nmk", r12, r12)
        cosv = dot / torch.clamp(d[:, :, None] * d[:, None, :], min=1e-12)
        trip = (t1[:, None, None], t2[:, :, None], t2[:, None, :])
        t3 = self.lam[trip].to(dtype)
        dcos = cosv - self.cos0[trip].to(dtype)
        adc = torch.abs(dcos)
        one = torch.ones_like(adc)
        factor = torch.where(
            adc >= _D2, torch.zeros_like(adc),
            torch.where(adc > _D1,
                        0.5 + 0.5 * torch.cos(math.pi * (adc - _D1)
                                              / (_D2 - _D1)), one))
        dcos = dcos * factor
        expf = torch.exp(torch.clamp(gam_term[:, :, None]
                                     + gam_term[:, None, :], -60.0, 0.0))
        pair_ok = ok[:, :, None] & ok[:, None, :]
        # m == k (the same neighbour slot) is no angle
        diag = torch.eye(d.shape[1], dtype=torch.bool, device=d.device)[None]
        e3 = torch.where(pair_ok & ~diag, 0.5 * t3 * expf * dcos * dcos,
                         torch.zeros_like(dcos))
        return torch.sum(e2, dim=1) + torch.sum(e3, dim=(1, 2))

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        t2 = type_[nbr.idx.long()]
        return compute_from_pair_energy(
            lambda r12, rows: self.per_atom_energy(
                r12, type_[rows], t2[rows], nbr.mask[rows]),
            nbr, mask, per_atom_virial=per_atom_virial,
            block=base.MANY_BODY_BLOCK)
