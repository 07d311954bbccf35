"""EAM potentials: Zhou 2004 analytic, tabulated eam/alloy (setfl), the
angular-dependent ADP and Dai 2006 (Finnis-Sinclair).

Counterpart of gpumd_tpu/potentials/eam.py.  File formats (ref:
src/force/eam.cu:28-128, eam_alloy.cu, adp.cu):
    eam_zhou_2004 <T> <syms>   then 21 numbers per type:
        re fe rho_e rho_s alpha beta A B kappa lambda
        Fn0 Fn1 Fn2 Fn3 F0 F1 F2 F3 eta Fe rc
    eam_dai_2006 1 <sym>       then 9 numbers: A d c c0 c1 c2 c3 c4 B
    eam/alloy: 3 comment lines, then the setfl body
    adp T syms, an optional `comment n` block, then the setfl body with
        the u and w pair tables after r*phi

E_i = F_{t_i}(rho_i) + 1/2 sum_j phi_{t_i t_j}(r_ij), rho_i = sum_j
f_{t_j}(r_ij) (plus ADP's dipole and quadrupole terms).  The per-atom
energy is written once and potentials/base.py differentiates it (the
embedding chain rule the reference hand-codes in two passes).  A table
is evaluated by indexing its rows per pair, never by gathering a table a
pair: (row, knot) -> the four cubic coefficients.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.potentials.base import (
    PotentialOutput,
    compute_typed,
    read_tokens,
)


class EAMZhou2004(NamedTuple):
    # all (T,) tables
    re: torch.Tensor
    fe: torch.Tensor
    rho_e: torch.Tensor
    rho_s: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    kappa: torch.Tensor
    lam: torch.Tensor
    fn: torch.Tensor  # (T, 4) Fn0..Fn3
    f03: torch.Tensor  # (T, 4) F0..F3
    eta: torch.Tensor
    fe_emb: torch.Tensor  # Fe, the embedding prefactor
    rc_t: torch.Tensor
    rc: float

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "EAMZhou2004":
        """Read an `eam_zhou_2004` file; the tables go on the card unless
        `device` says otherwise."""
        tokens = read_tokens(path, "eam_zhou_2004")
        t = int(tokens[1])
        vals = np.array([float(x) for x in tokens[2 + t:]]).reshape(t, 21)

        def ten(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        cols = ("re", "fe", "rho_e", "rho_s", "alpha", "beta", "a", "b",
                "kappa", "lam")
        return EAMZhou2004(
            **{k: ten(vals[:, i]) for i, k in enumerate(cols)},
            fn=ten(vals[:, 10:14]), f03=ten(vals[:, 14:18]),
            eta=ten(vals[:, 18]), fe_emb=ten(vals[:, 19]),
            rc_t=ten(vals[:, 20]), rc=float(vals[:, 20].max()))

    @staticmethod
    def _pow20(x):
        x2 = x * x
        x4 = x2 * x2
        return x4 * x4 * x4 * x4 * x4

    def _phi_single(self, t, d, dtype):
        """The same-type pair function phi_t(r), t a per-pair type."""
        rr = d / self.re[t].to(dtype)
        t1 = self._pow20(rr - self.kappa[t].to(dtype))
        t2 = self._pow20(rr - self.lam[t].to(dtype))
        phi1 = (self.a[t].to(dtype) / (1.0 + t1)
                * torch.exp(-self.alpha[t].to(dtype) * (rr - 1.0)))
        phi2 = (self.b[t].to(dtype) / (1.0 + t2)
                * torch.exp(-self.beta[t].to(dtype) * (rr - 1.0)))
        return phi1 - phi2

    def _f_single(self, t, d, dtype):
        rr = d / self.re[t].to(dtype)
        t2 = self._pow20(rr - self.lam[t].to(dtype))
        return (self.fe[t].to(dtype)
                * torch.exp(-self.beta[t].to(dtype) * (rr - 1.0)) / (1.0 + t2))

    def _embed(self, t1, rho, dtype):
        rho_e = self.rho_e[t1].to(dtype)
        rho_n = rho_e * 0.85
        rho_0 = rho_e * 1.15
        fn = self.fn[t1].to(dtype)
        f03 = self.f03[t1].to(dtype)
        eta = self.eta[t1].to(dtype)
        xn = rho / rho_n - 1.0
        f_lo = ((fn[..., 3] * xn + fn[..., 2]) * xn + fn[..., 1]) * xn \
            + fn[..., 0]
        xe = rho / rho_e - 1.0
        f_mid = ((f03[..., 3] * xe + f03[..., 2]) * xe + f03[..., 1]) * xe \
            + f03[..., 0]
        xs = torch.clamp(rho / self.rho_s[t1].to(dtype), min=1e-10)
        f_hi = (self.fe_emb[t1].to(dtype) * (1.0 - eta * torch.log(xs))
                * xs ** eta)
        return torch.where(rho < rho_n, f_lo,
                           torch.where(rho < rho_0, f_mid, f_hi))

    def pair_energies(self, r12, t1, t2):
        dtype = r12.dtype
        t1, t2 = t1.long(), t2.long()
        d = torch.sqrt(torch.sum(r12 * r12, dim=-1))
        in_rc = (d < self.rc).to(dtype)
        d = torch.clamp(d, max=self.rc)  # pow/exp tame on padded slots

        f_2u = self._f_single(t2, d, dtype)
        rho = torch.sum(f_2u * in_rc, dim=-1)

        # pair term with Zhou's cross mixing
        t1b = t1[:, None].expand_as(t2)
        phi_11 = self._phi_single(t1b, d, dtype)
        phi_22 = self._phi_single(t2, d, dtype)
        f_1 = self._f_single(t1b, d, dtype)
        cross = 0.5 * (phi_11 * f_2u / torch.clamp(f_1, min=1e-30)
                       + phi_22 * f_1 / torch.clamp(f_2u, min=1e-30))
        phi = torch.where(t1b == t2, phi_11, cross) * in_rc
        return self._embed(t1, rho, dtype) + 0.5 * torch.sum(phi, dim=-1)

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        return compute_typed(self.pair_energies, type_, nbr, mask,
                             per_atom_virial)


def _hermite_coeffs(y: np.ndarray) -> np.ndarray:
    """LAMMPS-style cubic Hermite coefficients per knot interval (ref:
    eam_alloy.cu:29-70), derivatives by centred differences: (n, 4)
    [a, b, c, d] with f(i + t) = a + b t + c t^2 + d t^3, the last
    interval's row repeated for the last knot."""
    n = len(y)
    d = np.zeros(n)
    d[1:-1] = 0.5 * (y[2:] - y[:-2])
    d[0] = y[1] - y[0]
    d[-1] = y[-1] - y[-2]
    a = y[:-1]
    b = d[:-1]
    c = 3.0 * (y[1:] - y[:-1]) - 2.0 * d[:-1] - d[1:]
    e = -2.0 * (y[1:] - y[:-1]) + d[:-1] + d[1:]
    coef = np.stack([a, b, c, e], axis=1)
    return np.concatenate([coef, coef[-1:]], axis=0)


def _spline_eval(coef, row, x, h):
    """A Hermite table at x (physical units): coef (R, n, 4) tables,
    row (...) the table of each point (a long tensor, or an int)."""
    n = coef.shape[-2]
    t = x / h
    i = torch.clamp(torch.floor(t).long(), 0, n - 2)
    dt = t - i.to(t.dtype)
    c = coef[row, i]  # (..., 4)
    return c[..., 0] + dt * (c[..., 1] + dt * (c[..., 2] + dt * c[..., 3]))


def _read_setfl(words, i):
    """The setfl body from words[i]: (T, symbols, nrho, drho, nr, dr, rc,
    F (T, nrho), rho (T, nr), index after it)."""
    t = int(words[i]); i += 1
    symbols = tuple(words[i:i + t]); i += t
    nrho, drho = int(words[i]), float(words[i + 1])
    nr, dr = int(words[i + 2]), float(words[i + 3])
    rc = float(words[i + 4]); i += 5
    f_tab = np.zeros((t, nrho))
    rho_tab = np.zeros((t, nr))
    for e in range(t):
        i += 4  # Z mass lattice-constant structure
        f_tab[e] = [float(w) for w in words[i:i + nrho]]; i += nrho
        rho_tab[e] = [float(w) for w in words[i:i + nr]]; i += nr
    return t, symbols, nrho, drho, nr, dr, rc, f_tab, rho_tab, i


def _read_pairs(words, i, t, nr):
    """A (T, T, nr) symmetric pair table from its j <= i triangle."""
    tab = np.zeros((t, t, nr))
    for a in range(t):
        for b in range(a + 1):
            tab[a, b] = tab[b, a] = [float(w) for w in words[i:i + nr]]
            i += nr
    return tab, i


def _coeffs(tab, dtype, device):
    """(rows..., n) knot tables -> (R, n, 4) coefficient tables, rows
    flattened (a pair table's row of (a, b) is a * T + b)."""
    flat = tab.reshape(-1, tab.shape[-1])
    return torch.as_tensor(np.stack([_hermite_coeffs(y) for y in flat]),
                           dtype=dtype, device=device)


def _setfl_terms(pot, r12, t1, t2):
    """A setfl potential's (F(rho) (B,), 1/2 sum phi (B,), in_rc, the
    clamped distances, the pair-table rows) for EAMAlloy and ADP."""
    dtype = r12.dtype
    d = torch.sqrt(torch.sum(r12 * r12, dim=-1))
    in_rc = (d < pot.rc).to(dtype)
    dc = torch.clamp(d, max=pot.rc)
    # density from the neighbours (tables of the NEIGHBOUR's type)
    rho = torch.sum(_spline_eval(pot.rho_coef.to(dtype), t2, dc, pot.dr)
                    * in_rc, dim=-1)
    f_c = pot.f_coef.to(dtype)
    rho_cl = torch.clamp(rho, max=(f_c.shape[1] - 1) * pot.drho)
    emb = _spline_eval(f_c, t1, rho_cl, pot.drho)
    # pair term: the tables hold r*phi
    pair = t1[:, None] * pot.f_coef.shape[0] + t2
    rphi = _spline_eval(pot.phi_coef.to(dtype), pair, dc, pot.dr)
    phi = torch.where(d > 1e-6, rphi / torch.clamp(d, min=1e-6),
                      torch.zeros_like(rphi)) * in_rc
    return emb, 0.5 * torch.sum(phi, dim=-1), in_rc, dc, pair


class EAMAlloy(NamedTuple):
    """Tabulated eam/alloy (setfl) potential with cubic Hermite splines
    (ref: src/force/eam_alloy.cu; format: 3 comment lines, `Nelem syms`,
    `nrho drho nr dr cutoff`, per element [Z mass lat struct, F(rho),
    rho(r)], then r*phi(r) for the (i >= j) pair triangle)."""

    f_coef: torch.Tensor  # (T, nrho, 4) embedding F(rho)
    rho_coef: torch.Tensor  # (T, nr, 4) density rho(r)
    phi_coef: torch.Tensor  # (T * T, nr, 4) r*phi(r), symmetric
    drho: float
    dr: float
    rc: float
    symbols: tuple

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "EAMAlloy":
        """Read a setfl file; the tables go on the card unless `device`
        says otherwise."""
        with open(path) as f:
            lines = f.readlines()
        words = " ".join(lines[3:]).split()  # after 3 comment lines
        (t, symbols, _, drho, nr, dr, rc, f_tab, rho_tab,
         i) = _read_setfl(words, 0)
        phi_tab, _ = _read_pairs(words, i, t, nr)
        return EAMAlloy(f_coef=_coeffs(f_tab, dtype, device),
                        rho_coef=_coeffs(rho_tab, dtype, device),
                        phi_coef=_coeffs(phi_tab, dtype, device),
                        drho=drho, dr=dr, rc=rc, symbols=symbols)

    def pair_energies(self, r12, t1, t2):
        emb, half_phi, *_ = _setfl_terms(self, r12, t1.long(), t2.long())
        return emb + half_phi

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        return compute_typed(self.pair_energies, type_, nbr, mask,
                             per_atom_virial)


class ADP(NamedTuple):
    """Angular-dependent potential: EAM + dipole/quadrupole distortion
    terms (Mishin ADP; ref: src/force/adp.cu).

    File: `adp T syms`, comment lines, setfl body (F, rho per element;
    then r*phi, u, w pair tables for the j <= i triangle).

    E_i = F(rho_i) + 1/2 sum phi + 1/2 |mu_i|^2 + 1/2 sum_ab lambda_ab^2
          - nu_i^2 / 6,
    mu_ia = sum_j u(r) r_a,  lambda_iab = sum_j w(r) r_a r_b, nu = tr lambda.
    """

    f_coef: torch.Tensor  # (T, nrho, 4)
    rho_coef: torch.Tensor  # (T, nr, 4)
    phi_coef: torch.Tensor  # (T * T, nr, 4) r*phi
    u_coef: torch.Tensor  # (T * T, nr, 4)
    w_coef: torch.Tensor  # (T * T, nr, 4)
    drho: float
    dr: float
    rc: float
    symbols: tuple

    @staticmethod
    def from_file(path: str, dtype=torch.float64,
                  device=torch.device("cuda")) -> "ADP":
        """Read an `adp` file; the tables go on the card unless `device`
        says otherwise."""
        with open(path) as f:
            lines = f.readlines()
        if lines[0].split()[0] != "adp":
            raise ValueError(f"{path}: not an adp file")
        # "comment n": the header block is n lines from the `comment` line
        # itself on (Ta.adp.txt: `comment 2` + one text line)
        idx = 1
        second = lines[1].split()
        if second and second[0] == "comment":
            idx = 1 + int(second[1])
        words = " ".join(lines[idx:]).split()
        (t, symbols, _, drho, nr, dr, rc, f_tab, rho_tab,
         i) = _read_setfl(words, 0)
        phi_tab, i = _read_pairs(words, i, t, nr)
        u_tab, i = _read_pairs(words, i, t, nr)
        w_tab, _ = _read_pairs(words, i, t, nr)
        return ADP(f_coef=_coeffs(f_tab, dtype, device),
                   rho_coef=_coeffs(rho_tab, dtype, device),
                   phi_coef=_coeffs(phi_tab, dtype, device),
                   u_coef=_coeffs(u_tab, dtype, device),
                   w_coef=_coeffs(w_tab, dtype, device),
                   drho=drho, dr=dr, rc=rc, symbols=symbols)

    def pair_energies(self, r12, t1, t2):
        dtype = r12.dtype
        emb, half_phi, in_rc, dc, pair = _setfl_terms(self, r12, t1.long(),
                                                      t2.long())
        u = _spline_eval(self.u_coef.to(dtype), pair, dc, self.dr) * in_rc
        w = _spline_eval(self.w_coef.to(dtype), pair, dc, self.dr) * in_rc
        r12m = torch.where(in_rc[..., None] > 0, r12, torch.zeros_like(r12))
        mu = torch.einsum("pm,pma->pa", u, r12m)  # (B, 3)
        lam = torch.einsum("pm,pma,pmb->pab", w, r12m, r12m)  # (B, 3, 3)
        nu = torch.diagonal(lam, dim1=-2, dim2=-1).sum(-1)
        e_ang = (0.5 * torch.sum(mu * mu, dim=-1)
                 + 0.5 * torch.sum(lam * lam, dim=(-2, -1)) - nu * nu / 6.0)
        return emb + half_phi + e_ang

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        return compute_typed(self.pair_energies, type_, nbr, mask,
                             per_atom_virial)


class EAMDai2006(NamedTuple):
    """Finnis-Sinclair-type EAM (Dai 2006), one element
    (ref: eam.cu:97-128, 234-287):
        phi(r) = (r - c)^2 (c0 + c1 r + c2 r^2 + c3 r^3 + c4 r^4), r < c
        f(r)   = (r - d)^2 + B^2 (r - d)^4, r < d
        F(rho) = -A sqrt(rho)
    """

    a: float
    d: float
    c: float
    c0: float
    c1: float
    c2: float
    c3: float
    c4: float
    b: float
    rc: float

    @staticmethod
    def from_file(path: str, dtype=None, device=None) -> "EAMDai2006":
        """Read an `eam_dai_2006` file (host floats: `dtype` and `device`
        are taken for the family's signature)."""
        tokens = read_tokens(path, "eam_dai_2006")
        a, d, c, c0, c1, c2, c3, c4, b = (float(x) for x in tokens[3:12])
        return EAMDai2006(a=a, d=d, c=c, c0=c0, c1=c1, c2=c2, c3=c3, c4=c4,
                          b=b, rc=max(c, d))

    def pair_energies(self, r12, t1, t2):
        dd = torch.sqrt(torch.sum(r12 * r12, dim=-1))
        zero = torch.zeros_like(dd)
        dc = torch.clamp(dd, max=self.c)
        phi = (dc - self.c) ** 2 * (
            self.c0 + self.c1 * dc + self.c2 * dc ** 2 + self.c3 * dc ** 3
            + self.c4 * dc ** 4)
        phi = torch.where(dd < self.c, phi, zero)
        dr = torch.clamp(dd, max=self.d)
        f = (dr - self.d) ** 2 + self.b ** 2 * (dr - self.d) ** 4
        rho = torch.sum(torch.where(dd < self.d, f, zero), dim=-1)
        emb = -self.a * torch.sqrt(torch.clamp(rho, min=1e-30))
        emb = torch.where(rho > 0, emb, torch.zeros_like(emb))
        return emb + 0.5 * torch.sum(phi, dim=-1)

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        return compute_typed(self.pair_energies, type_, nbr, mask,
                             per_atom_virial)
