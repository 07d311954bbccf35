"""DFT-D3 dispersion correction with Becke-Johnson damping.

Counterpart of gpumd_tpu/potentials/dftd3.py (ref: src/force/dftd3.cu:
54-212; Grimme's published D3 reference data ship as the port's own
assets/dftd3para.npz: num_cn, cn_ref, r2r4, covalent radii and the
triangular C6(CN_i, CN_j) table):

  CN_i   = sum_j 1 / (1 + exp(-16 (R_cov,ij / d - 1)))     (d < rc_cn)
  C6_ij  = sum_kl c6ref_ij,kl L_kl / sum_kl L_kl,
           L_kl = exp(-4 ((CN_i - cnref_ik)^2 + (CN_j - cnref_jl)^2))
  E_i    = -1/2 sum_j [ s6 C6 / (d^6 + R0^6) + s8 C8 / (d^8 + R0^8) ],
           R0 = a1 sqrt(C8/C6) + a2,  C8 = 3 r2r4_i r2r4_j Bohr^2 C6

An atom's energy reads its neighbours' CN, so the energy is not a sum of
row-local terms: the CN (N,) comes first from the whole list, then the
C6 part runs a block of rows at a time (its (B, MN, 5, 5) tensors stay
under D3_BLOCK_BYTES each), each block's sweep giving its rows' partials
and its share of dE/dCN, and one last sweep takes dE/dCN back through
the CN to the displacements.  The numbers are those of the JAX package's
single sweep, up to summation order.

The tables are float32 in the asset; sums and products of them are taken
in float32 before the cast to the working type, as the JAX package does.

run.in: `dftd3 <functional> rc_potential rc_cn` after `potential`.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.elements import atomic_number
from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.potentials.base import (
    PotentialOutput,
    output_from_partials,
)

BOHR = 0.5291772575069165
BOHR2 = 0.280028569862541
HARTREE_BOHR6 = 0.597527426643772
_MAX_CN = 5

# bytes of one (B, MN, 5, 5) tensor of a block of rows
D3_BLOCK_BYTES = 1 << 30

# (s6, a1, s8, a2) per functional, BJ damping (ref: dftd3.cu:1112-1166)
FUNCTIONALS = {
    "b1b95": (1.000, 0.2092, 1.4507, 5.5545),
    "b2gpplyp": (0.560, 0.0000, 0.2597, 6.3332),
    "b2plyp": (0.640, 0.3065, 0.9147, 5.0570),
    "b3lyp": (1.000, 0.3981, 1.9889, 4.4211),
    "b3pw91": (1.000, 0.4312, 2.8524, 4.4693),
    "b97d": (1.000, 0.5545, 2.2609, 3.2297),
    "bhlyp": (1.000, 0.2793, 1.0354, 4.9615),
    "blyp": (1.000, 0.4298, 2.6996, 4.2359),
    "bmk": (1.000, 0.1940, 2.0860, 5.9197),
    "bop": (1.000, 0.4870, 3.295, 3.5043),
    "bp86": (1.000, 0.3946, 3.2822, 4.8516),
    "bpbe": (1.000, 0.4567, 4.0728, 4.3908),
    "camb3lyp": (1.000, 0.3708, 2.0674, 5.4743),
    "dsdblyp": (0.500, 0.0000, 0.2130, 6.0519),
    "hcth120": (1.000, 0.3563, 1.0821, 4.3359),
    "hf": (1.000, 0.3385, 0.9171, 2.883),
    "hse-hjs": (1.000, 0.3830, 2.3100, 5.685),
    "lc-wpbe08": (1.000, 0.3919, 1.8541, 5.0897),
    "lcwpbe": (1.000, 0.3919, 1.8541, 5.0897),
    "m11": (1.000, 0.0000, 2.8112, 10.1389),
    "mn12l": (1.000, 0.0000, 2.2674, 9.1494),
    "mn12sx": (1.000, 0.0983, 1.1674, 8.0259),
    "mpw1b95": (1.000, 0.1955, 1.0508, 6.4177),
    "mpwb1k": (1.000, 0.1474, 0.9499, 6.6223),
    "mpwlyp": (1.000, 0.4831, 2.0077, 4.5323),
    "n12sx": (1.000, 0.3283, 2.4900, 5.7898),
    "olyp": (1.000, 0.5299, 2.6205, 2.8065),
    "opbe": (1.000, 0.5512, 3.3816, 2.9444),
    "otpss": (1.000, 0.4634, 2.7495, 4.3153),
    "pbe": (1.000, 0.4289, 0.7875, 4.4407),
    "pbe0": (1.000, 0.4145, 1.2177, 4.8593),
    "pbe38": (1.000, 0.3995, 1.4623, 5.1405),
    "pbesol": (1.000, 0.4466, 2.9491, 6.1742),
    "ptpss": (0.750, 0.000, 0.2804, 6.5745),
    "pw6b95": (1.000, 0.2076, 0.7257, 6.375),
    "pwb6k": (1.000, 0.1805, 0.9383, 7.7627),
    "pwpb95": (0.820, 0.0000, 0.2904, 7.3141),
    "revpbe": (1.000, 0.5238, 2.3550, 3.5016),
    "revpbe0": (1.000, 0.4679, 1.7588, 3.7619),
    "revpbe38": (1.000, 0.4309, 1.4760, 3.9446),
    "revssb": (1.000, 0.4720, 0.4389, 4.0986),
    "rpbe": (1.000, 0.1820, 0.8318, 4.0094),
    "rpw86pbe": (1.000, 0.4613, 1.3845, 4.5062),
    "scan": (1.000, 0.5380, 0.0000, 5.42),
    "sogga11x": (1.000, 0.1330, 1.1426, 5.7381),
    "ssb": (1.000, -0.0952, -0.1744, 5.2170),
    "tpss": (1.000, 0.4535, 1.9435, 4.4752),
    "tpss0": (1.000, 0.3768, 1.2576, 4.5865),
    "tpssh": (1.000, 0.4529, 2.2382, 4.6550),
    "b2kplyp": (0.64, 0.0000, 0.1521, 7.1916),
    "dsd-pbep86": (0.418, 0.0000, 0.0000, 5.6500),
    "b97m": (1.0000, -0.0780, 0.1384, 5.5946),
    "wb97x": (1.0000, 0.0000, 0.2641, 5.4959),
    "wb97m": (1.0000, 0.5660, 0.3908, 3.1280),
}


def _load_tables():
    return np.load(os.path.join(os.path.dirname(__file__), "..", "assets",
                                "dftd3para.npz"))


def _c6_block(c6_flat, za: int, zb: int) -> np.ndarray:
    """The (5, 5) reference C6 block of the element pair (za, zb), 0-based,
    from the triangular table: pair (zs <= zl) at zs 94 - zs (zs - 1) / 2
    + (zl - zs), its entry (i, j) ordered by (z1 < z2) ? (i, j) : (j, i)."""
    zs, zl = min(za, zb), max(za, zb)
    blk = c6_flat[zs * 94 - (zs * (zs - 1)) // 2 + (zl - zs)]
    return blk if za <= zb else blk.T


class DFTD3(NamedTuple):
    """D3(BJ) dispersion term on the types of one simulation; it adds to
    any base potential."""

    s6: float
    a1: float
    s8: float
    a2: float
    z_of_type: Tuple[int, ...]  # 0-based atomic index (Z - 1) per type
    rc_radial: float
    rc_cn: float
    cn_ref: torch.Tensor  # (T, 5); unused slots parked far away
    rcov_sum: torch.Tensor  # (T, T) Bohr (rcov_a + rcov_b)
    c6: torch.Tensor  # (T, T, 5, 5)
    c6_last: torch.Tensor  # (T, T) the largest-CN reference entry
    c8_over_c6: torch.Tensor  # (T, T) 3 r2r4_a r2r4_b Bohr^2

    @property
    def rc(self) -> float:
        return self.rc_radial

    @staticmethod
    def create(functional: str, rc_radial: float, rc_cn: float, symbols,
               dtype=torch.float64,
               device=torch.device("cuda")) -> "DFTD3":
        """The term for the type names `symbols`; the tables go on the card
        unless `device` says otherwise."""
        fn = functional.lower()
        if fn not in FUNCTIONALS:
            raise ValueError(f"functional {functional!r} not supported for "
                             f"DFT-D3 (BJ)")
        s6, a1, s8, a2 = FUNCTIONALS[fn]
        tab = _load_tables()
        num_cn = tab["num_cn"]
        z = [atomic_number(s) - 1 for s in symbols]
        cn_ref = tab["cn_ref"][z].copy()
        for t, zt in enumerate(z):
            cn_ref[t, num_cn[zt]:] = 1.0e3
        c6_flat = tab["c6_ref"].reshape(-1, _MAX_CN, _MAX_CN)
        c6 = np.stack([np.stack([_c6_block(c6_flat, za, zb) for zb in z])
                       for za in z])
        last = np.asarray([num_cn[zt] - 1 for zt in z])
        c6_last = c6[np.arange(len(z))[:, None], np.arange(len(z))[None],
                     last[:, None], last[None, :]]
        rcov, r2r4 = tab["covalent_radius"][z], tab["r2r4"][z]
        # float32 sums and products, then the cast (the JAX order)
        rcov_sum = BOHR * (rcov[:, None] + rcov[None, :]).astype(np.float64)
        c8 = 3.0 * (r2r4[:, None] * r2r4[None, :]).astype(np.float64) * BOHR2

        def ten(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                   device=device)

        return DFTD3(s6=s6, a1=a1, s8=s8, a2=a2, z_of_type=tuple(z),
                     rc_radial=float(rc_radial), rc_cn=float(rc_cn),
                     cn_ref=ten(cn_ref), rcov_sum=ten(rcov_sum), c6=ten(c6),
                     c6_last=ten(c6_last), c8_over_c6=ten(c8))

    def coordination(self, r12, t1, t2, ok):
        """CN (N,) of every atom from its own row."""
        dtype = r12.dtype
        d = torch.sqrt(torch.clamp(torch.sum(r12 * r12, dim=-1), min=1e-12))
        rs = self.rcov_sum.to(dtype)[t1[:, None], t2]
        term = 1.0 / (torch.exp(-16.0 * (rs / d - 1.0)) + 1.0)
        return torch.sum(torch.where(ok & (d < self.rc_cn), term,
                                     torch.zeros_like(term)), dim=1)

    def pair_energy(self, r12, t1, t2, cn_i, cn_j, ok):
        """Per-atom D3 energies (B,) of a block of rows given the CN of the
        centres (B,) and of their neighbours (B, MN)."""
        dtype = r12.dtype
        d2 = torch.sum(r12 * r12, dim=-1)
        d = torch.sqrt(torch.clamp(d2, min=1e-12))
        pair = (t1[:, None], t2)
        cn_ref = self.cn_ref.to(dtype)
        di = cn_i[:, None] - cn_ref[t1]  # (B, 5)
        dj = cn_j[..., None] - cn_ref[t2]  # (B, MN, 5)
        big_l = torch.exp(-4.0 * (di[:, None, :, None] ** 2
                                  + dj[..., None, :] ** 2))  # (B, MN, 5, 5)
        c6_ref = self.c6.to(dtype)[pair]
        w = torch.sum(big_l, dim=(-2, -1))
        zsum = torch.sum(c6_ref * big_l, dim=(-2, -1))
        c6 = torch.where(w < 1e-30, self.c6_last.to(dtype)[pair],
                         zsum / torch.clamp(w, min=1e-30)) * HARTREE_BOHR6
        c8_over_c6 = self.c8_over_c6.to(dtype)[pair]
        c8 = c6 * c8_over_c6
        damp = self.a1 * torch.sqrt(c8_over_c6) + self.a2
        d6 = d2 * d2 * d2
        d8 = d6 * d2
        e = -(self.s6 * c6 / (d6 + damp ** 6)
              + self.s8 * c8 / (d8 + damp ** 8)) * 0.5
        e = torch.where(ok & (d < self.rc_radial), e, torch.zeros_like(e))
        return torch.sum(e, dim=1)

    def block_rows(self, mn: int, dtype) -> int:
        """Rows a block: one (B, MN, 5, 5) tensor under D3_BLOCK_BYTES."""
        item = torch.finfo(dtype).bits // 8
        return max(1, D3_BLOCK_BYTES // (mn * _MAX_CN * _MAX_CN * item))

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        n, mn = nbr.idx.shape
        t1 = type_.long()
        jdx = nbr.idx.long()
        t2 = t1[jdx]
        ok = nbr.mask > 0
        m = mask.to(nbr.r12.dtype)
        with torch.enable_grad():
            r_all = nbr.r12.detach().requires_grad_(True)
            cn = self.coordination(r_all, t1, t2, ok)
            cn_leaf = cn.detach().requires_grad_(True)
            e = torch.empty_like(cn_leaf)
            p = torch.empty_like(r_all)
            g_cn = torch.zeros_like(cn_leaf)
            step = self.block_rows(mn, nbr.r12.dtype)
            for s in range(0, n, step):
                rows = slice(s, min(s + step, n))
                r = nbr.r12[rows].detach().requires_grad_(True)
                eb = self.pair_energy(r, t1[rows], t2[rows], cn_leaf[rows],
                                      cn_leaf[jdx[rows]], ok[rows])
                g_r, g_c = torch.autograd.grad(eb, (r, cn_leaf),
                                               grad_outputs=m[rows])
                e[rows] = eb.detach()
                p[rows] = g_r
                g_cn += g_c
            (g_chain,) = torch.autograd.grad(cn, r_all, grad_outputs=g_cn)
        return output_from_partials(e.detach() * m, p + g_chain, nbr, m,
                                    per_atom_virial)
