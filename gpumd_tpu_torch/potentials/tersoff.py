"""Tersoff bond-order potentials: the 1989 form, Tersoff-1988 and
Tersoff-mini.

Counterpart of gpumd_tpu/potentials/tersoff.py.  Tersoff1989's file parser
keeps its mixing rules for one or two types (geometric A, B * chi, r1, r2;
arithmetic lambda, mu; ref: src/force/tersoff1989.cu:30-120) and the table
layout the compact engine (engine/tersoff_compact.py) reads.  On the list
path each class writes the per-atom energy

    E_i = 1/2 sum_j fc(r_ij) [ A e^{-lambda r} - b_ij B e^{-mu r} ]
    b_ij = (1 + (beta zeta_ij)^n)^{-1/(2n)},  zeta_ij = sum_{k != j} ...

once, and potentials/base.py differentiates it a block of 2,048 centres
(MANY_BODY_BLOCK) at a time, forward and backward inside the block: the
(B, MN, MN) angle tensors of one block are alive at a time (the JAX
package's jax.checkpoint over lax.map).  The reference's zeta < 1e-16 guard of
d(beta zeta)^n / dzeta is kept as written there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.potentials.base import (
    PotentialOutput,
    compute_typed,
    read_tokens,
)

# The published Tersoff-1989 Si set (Phys. Rev. B 39, 5566 (1989), Table
# I), in the format Tersoff1989.from_file reads
SI_TERSOFF = """tersoff_1989 1 Si
1830.8 471.18 2.4799 1.7322 1.1e-6 0.78734 1.0039e5 16.217 -0.59825 2.7 3.0
"""


class Tersoff1989(NamedTuple):
    # pair-indexed (T, T)
    a: torch.Tensor
    b: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    # centre-type-indexed (T,)
    beta: torch.Tensor
    n: torch.Tensor
    c2: torch.Tensor
    d2: torch.Tensor
    h: torch.Tensor
    rc: float

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "Tersoff1989":
        """Read a `tersoff_1989` file; the tables go on the card unless
        `device` says otherwise."""
        with open(path) as f:
            return Tersoff1989.from_text(f.read(), dtype, device, name=path)

    @staticmethod
    def from_text(text: str, dtype=torch.float64,
                  device=torch.device("cuda"),
                  name: str = "text") -> "Tersoff1989":
        """Parse the text of a `tersoff_1989` file (e.g. SI_TERSOFF)."""
        tokens = text.split()
        if tokens[0] != "tersoff_1989":
            raise ValueError(f"{name}: not a tersoff_1989 file")
        t = int(tokens[1])
        if t not in (1, 2):
            raise ValueError("tersoff_1989 supports 1 or 2 types")
        vals = [float(x) for x in tokens[2 + t:]]
        rows = [vals[11 * i:11 * (i + 1)] for i in range(t)]
        chi = vals[11 * t] if t == 2 else 1.0

        pair = {k: np.zeros((t, t)) for k in ("a", "b", "lam", "mu", "r1",
                                               "r2")}
        for i in range(t):
            for k, col in (("a", 0), ("b", 1), ("lam", 2), ("mu", 3),
                           ("r1", 9), ("r2", 10)):
                pair[k][i, i] = rows[i][col]
        if t == 2:
            for k in ("a", "r1", "r2"):
                pair[k][0, 1] = pair[k][1, 0] = np.sqrt(pair[k][0, 0]
                                                        * pair[k][1, 1])
            pair["b"][0, 1] = pair["b"][1, 0] = np.sqrt(
                pair["b"][0, 0] * pair["b"][1, 1]) * chi
            for k in ("lam", "mu"):
                pair[k][0, 1] = pair[k][1, 0] = 0.5 * (pair[k][0, 0]
                                                       + pair[k][1, 1])

        def col(c):
            return np.array([rows[i][c] for i in range(t)])

        def ten(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return Tersoff1989(
            **{k: ten(v) for k, v in pair.items()},
            beta=ten(col(4)), n=ten(col(5)), c2=ten(col(6) ** 2),
            d2=ten(col(7) ** 2), h=ten(col(8)),
            rc=float(pair["r2"].max()))

    @property
    def num_types(self) -> int:
        return self.beta.shape[0]

    def pair_energies(self, r12, t1, t2):
        """Per-atom energies (B,) from displacements (B, MN, 3), the centre
        types (B,) and the neighbour types (B, MN)."""
        dtype = r12.dtype
        t1 = t1.long()
        tp = (t1[:, None], t2.long())
        d = torch.sqrt(torch.sum(r12 * r12, dim=-1))  # (B, MN)
        r1p = self.r1[tp].to(dtype)
        r2p = self.r2[tp].to(dtype)
        fc = _fc(d, r1p, r2p)
        dsafe = torch.minimum(d, r2p)
        fr = self.a[tp].to(dtype) * torch.exp(-self.lam[tp].to(dtype) * dsafe)
        fa = self.b[tp].to(dtype) * torch.exp(-self.mu[tp].to(dtype) * dsafe)

        # zeta_ij = sum_k fc_ik g(cos theta_jik), k != j (the same list)
        cosjk = _cosines(r12, d)  # (B, MN, MN)
        c2 = self.c2[t1].to(dtype)[:, None, None]
        d2 = self.d2[t1].to(dtype)[:, None, None]
        hh = self.h[t1].to(dtype)[:, None, None]
        g = (1.0 + c2 / d2) - c2 / (d2 + (cosjk - hh) ** 2)
        zeta = _zeta(fc, g)
        bij = _bond_order(zeta, self.beta[t1].to(dtype)[:, None],
                          self.n[t1].to(dtype)[:, None])
        return torch.sum(0.5 * fc * (fr - bij * fa), dim=-1)

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        return compute_typed(self.pair_energies, type_, nbr, mask,
                             per_atom_virial)


def _fc(d, r1, r2):
    """Tersoff's switch: 1 below r1, a cosine ramp to 0 at r2."""
    x = torch.clamp((d - r1) / torch.clamp(r2 - r1, min=1e-30), 0.0, 1.0)
    fc = 0.5 * (1.0 + torch.cos(math.pi * x))
    return torch.where(d < r2, fc, torch.zeros_like(fc))


def _cosines(r12, d):
    """cos theta between every two slots of a centre: (B, MN, MN)."""
    u = r12 / d[..., None]
    return torch.einsum("pma,pka->pmk", u, u)


def _not_self(mn, dtype, device):
    return 1.0 - torch.eye(mn, dtype=dtype, device=device)


def _zeta(fc, g):
    """zeta (B, MN) = sum over k != m of fc[k] g[m, k]."""
    return torch.einsum("pk,pmk,mk->pm", fc, g,
                        _not_self(fc.shape[-1], fc.dtype, fc.device))


def _bond_order(zeta, beta, nn):
    """b = (1 + (beta zeta)^n)^(-1/(2n)), (beta zeta)^n taken as 0 for
    zeta <= 1e-16 (the reference's guard of the n < 1 singularity)."""
    zeta_ok = zeta > 1e-16
    bzn = torch.where(
        zeta_ok, (beta * torch.where(zeta_ok, zeta, torch.ones_like(zeta)))
        ** nn, torch.zeros_like(zeta))
    return (1.0 + bzn) ** (-0.5 / nn)


class TersoffMini(NamedTuple):
    """Mini-Tersoff (Fan 2019), one or two elements.

    File (ref: src/force/tersoff_mini.cu:30-85): per pair class (2T - 1
    entries indexed by t1 + t2) D0 alpha r0 S beta n h r1 r2, converted to
    the A/B/lambda/mu form; angular g = (h - cos)^2."""

    a: torch.Tensor  # (P,) pair-class tables, P = 2T - 1
    b: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    beta: torch.Tensor
    n: torch.Tensor
    h: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    rc: float

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "TersoffMini":
        """Read a `tersoff_mini` file; the tables go on the card unless
        `device` says otherwise."""
        tokens = read_tokens(path, "tersoff_mini")
        t = int(tokens[1])
        n_entries = 2 * t - 1
        vals = np.array([float(x) for x in tokens[2 + t:2 + t
                                                   + 9 * n_entries]]
                        ).reshape(n_entries, 9)
        d0, alpha, r0, s = vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3]

        def ten(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return TersoffMini(
            a=ten(d0 / (s - 1) * np.exp(np.sqrt(2 * s) * alpha * r0)),
            b=ten(s * d0 / (s - 1) * np.exp(np.sqrt(2 / s) * alpha * r0)),
            lam=ten(np.sqrt(2 * s) * alpha), mu=ten(np.sqrt(2 / s) * alpha),
            beta=ten(vals[:, 4]), n=ten(vals[:, 5]), h=ten(vals[:, 6]),
            r1=ten(vals[:, 7]), r2=ten(vals[:, 8]),
            rc=float(vals[:, 8].max()))

    def pair_energies(self, r12, t1, t2):
        dtype = r12.dtype
        d = torch.sqrt(torch.sum(r12 * r12, dim=-1))
        tp = t1.long()[:, None] + t2.long()  # pair class (ref: t1 + t2)
        r2p = self.r2[tp].to(dtype)
        fc = _fc(d, self.r1[tp].to(dtype), r2p)
        dsafe = torch.minimum(d, r2p)
        fr = self.a[tp].to(dtype) * torch.exp(-self.lam[tp].to(dtype) * dsafe)
        fa = self.b[tp].to(dtype) * torch.exp(-self.mu[tp].to(dtype) * dsafe)
        hh = self.h[tp].to(dtype)[..., None]  # h of the i-j pair
        g = (hh - _cosines(r12, d)) ** 2
        zeta = _zeta(fc, g)
        bij = _bond_order(zeta, self.beta[tp].to(dtype),
                          self.n[tp].to(dtype))
        return torch.sum(0.5 * fc * (fr - bij * fa), dim=-1)

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        return compute_typed(self.pair_energies, type_, nbr, mask,
                             per_atom_virial)


class Tersoff1988(NamedTuple):
    """Full-parameter Tersoff (1988), triple-indexed.

    File (ref: src/force/tersoff1988.cu:57-180): `tersoff_1988 T syms`,
    then T^3 entries of 14 values A B lambda mu beta n c d h r1 r2 m alpha
    gamma.  zeta_ij = sum_k fc^{ijk}(r13) g^{ijk}(cos) e^{ijk}, e =
    exp(alpha (d12 - d13)^m) (m = 1 or 3; alpha < 1e-10 -> 1), g = gamma
    (1 + c^2/d^2 - c^2/(d^2 + (h - cos)^2)); the pair terms and (beta, n)
    of the (i, j, j) entry."""

    p: torch.Tensor  # (T^3, 14) the file's table
    num_types: int
    rc: float

    _A, _B, _LAM, _MU, _BETA, _EN, _C, _D, _H, _R1, _R2, _M, _ALPHA, \
        _GAMMA = range(14)

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "Tersoff1988":
        """Read a `tersoff_1988` file; the table goes on the card unless
        `device` says otherwise."""
        tokens = read_tokens(path, "tersoff_1988")
        t = int(tokens[1])
        n_entries = t * t * t
        vals = np.array([float(x) for x in tokens[2 + t:2 + t
                                                   + 14 * n_entries]]
                        ).reshape(n_entries, 14)
        return Tersoff1988(p=torch.as_tensor(vals, dtype=dtype,
                                             device=device),
                           num_types=t, rc=float(vals[:, 10].max()))

    def _col(self, idx, col, dtype):
        return self.p[idx, col].to(dtype)

    def pair_energies(self, r12, t1, t2):
        dtype = r12.dtype
        t = self.num_types
        t1, t2 = t1.long(), t2.long()
        d = torch.sqrt(torch.sum(r12 * r12, dim=-1))  # (B, MN)
        ijj = (t1[:, None] * t + t2) * t + t2  # the pair entry (i, j, j)
        r2p = self._col(ijj, self._R2, dtype)
        fc12 = _fc(d, self._col(ijj, self._R1, dtype), r2p)
        dsafe = torch.minimum(d, r2p)
        fr = self._col(ijj, self._A, dtype) * torch.exp(
            -self._col(ijj, self._LAM, dtype) * dsafe)
        fa = self._col(ijj, self._B, dtype) * torch.exp(
            -self._col(ijj, self._MU, dtype) * dsafe)

        # the triple entry (i, j(m), k(slot)): (B, MN, MN)
        ijk = (t1[:, None, None] * t + t2[:, :, None]) * t + t2[:, None, :]
        cosjk = _cosines(r12, d)
        c2 = self._col(ijk, self._C, dtype) ** 2
        d2 = self._col(ijk, self._D, dtype) ** 2
        hh = self._col(ijk, self._H, dtype)
        g = self._col(ijk, self._GAMMA, dtype) * (
            1.0 + c2 / d2 - c2 / (d2 + (cosjk - hh) ** 2))
        alpha = self._col(ijk, self._ALPHA, dtype)
        mm = self._col(ijk, self._M, dtype)
        # dr clamped to keep exp bounded on padded far slots (fc13 = 0)
        drc = torch.clamp(d[:, :, None] - d[:, None, :], -10.0, 10.0)
        e_fac = torch.where(
            alpha < 1e-10, torch.ones_like(alpha),
            torch.where(mm > 2.0, torch.exp(alpha * drc ** 3),
                        torch.exp(alpha * drc)))
        fc13 = _fc(d[:, None, :].expand_as(cosjk),
                   self._col(ijk, self._R1, dtype),
                   self._col(ijk, self._R2, dtype))
        zeta = torch.einsum("pmk,mk->pm", fc13 * g * e_fac,
                            _not_self(d.shape[-1], dtype, d.device))
        bij = _bond_order(zeta, self._col(ijj, self._BETA, dtype),
                          self._col(ijj, self._EN, dtype))
        return torch.sum(0.5 * fc12 * (fr - bij * fa), dim=-1)

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        return compute_typed(self.pair_energies, type_, nbr, mask,
                             per_atom_virial)
