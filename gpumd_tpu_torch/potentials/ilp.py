"""Interlayer potential (ILP) hybrids for layered materials.

Counterpart of gpumd_tpu/potentials/ilp.py (ref: src/force/ilp_tersoff.cu,
ilp_nep.cu, ilp_tmd_sw.cu): a registry-dependent Kolmogorov-Crespi-type
term between layers told apart by a grouping method, plus an intralayer
potential (Tersoff-1988, Stillinger-Weber or NEP) on same-layer pairs.

The interlayer energy per ordered pair (i -> j, other layer, within
rcut_global, tapered):

    E_ij = Tap(r) [ e^{-lambda (r - z0)} (eps/2 + C e^{-rho_ij^2/delta^2})
                    - C6 / (2 r^6 (1 + e^{-d (r/(sR reff)) + d})) ]

with rho_ij^2 = r^2 - (r12 . n_i)^2 and n_i atom i's local normal from
its first <= 3 same-layer neighbours within rcut_ilp, in list order (ref:
calc_normal ilp_tersoff.cu:396-660).  Forces, the normals' chain
included, are one autograd sweep of this per-atom energy a block of rows
at a time (potentials/base.py).

The JAX package hands the intralayer potential the ILP's long list
(rcut_global, ~16 A) with the other-layer slots parked far away; a
many-body potential's (B, MN, MN) angle tensors then grow with that MN.
Here the intralayer potential gets a list of its own: the same-layer
pairs within its own cutoff, packed by an order-keeping compaction (a
cumulative rank and one scatter) into `intra_mn` slots, built anew from
the long list at every force pass.  A pair past the cutoff adds exactly
0 through every cutoff function, so the numbers are the JAX package's up
to summation order; a row with more pairs than `intra_mn` raises.

File formats (ref: ilp_tersoff.cu:60-115, ilp_nep.cu:58-160): a
`tersoff_ilp`/`nep_ilp`/`sw_ilp` header, the group method(s), T^2 rows of
12 ILP parameters; tersoff_ilp's second file a headerless T^3 x 14
Tersoff-1988 block, sw_ilp's an SW block, nep_ilp's a NEP map.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.neighbor.neighbor import _FAR, NeighborList
from gpumd_tpu_torch.potentials import base
from gpumd_tpu_torch.potentials.base import (
    PotentialOutput,
    compute_from_pair_energy,
)

# long-range taper polynomial (x = r / rcut_global; ref: Tap_coeff_CBN)
_TAP = (1.0, 0.0, 0.0, 0.0, -35.0, 84.0, -70.0, 20.0)


class ILPTerm(NamedTuple):
    """The interlayer term alone: (T, T) parameter tables and the layer
    label of every atom."""

    z0: torch.Tensor  # beta
    lam: torch.Tensor  # alpha / beta
    delta2inv: torch.Tensor
    epsilon: torch.Tensor  # meV-scaled
    cc: torch.Tensor  # C, meV-scaled
    d: torch.Tensor
    d_seff: torch.Tensor  # d / (sR reff)
    c6: torch.Tensor  # meV-scaled
    rcutsq_ilp: torch.Tensor  # the normal neighbours' cutoff^2
    rcut_global: torch.Tensor
    labels: torch.Tensor  # (N,) layer label per atom
    rc: float

    @staticmethod
    def parse_rows(rows, t: int, labels, dtype=torch.float64,
                   device=torch.device("cuda")) -> "ILPTerm":
        """rows (T*T, 12): beta alpha delta eps C d sR reff C6 S rcut_ilp
        rcut_global."""
        rows = np.asarray(rows, np.float64).reshape(t, t, 12)
        mev = 1e-3 * rows[..., 9]  # S scale (ref: meV = 1e-3 * S)

        def ten(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return ILPTerm(
            z0=ten(rows[..., 0]), lam=ten(rows[..., 1] / rows[..., 0]),
            delta2inv=ten(1.0 / rows[..., 2] ** 2),
            epsilon=ten(rows[..., 3] * mev), cc=ten(rows[..., 4] * mev),
            d=ten(rows[..., 5]),
            d_seff=ten(rows[..., 5] / rows[..., 6] / rows[..., 7]),
            c6=ten(rows[..., 8] * mev), rcutsq_ilp=ten(rows[..., 10] ** 2),
            rcut_global=ten(rows[..., 11]),
            labels=torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                                   device=device),
            rc=float(rows[..., 11].max()))

    @staticmethod
    def normals(r12, ok):
        """(B, 3) local normals from the first <= 3 selected neighbours of
        each row (`ok` (B, MN)), in slot order (ref: ILP_neighbor +
        calc_normal): z for fewer than two, their cross product for two,
        the mean of the three cyclic cross products for three."""
        okf = ok.to(r12.dtype)
        rank = torch.cumsum(okf, dim=1) * okf  # 1-based among selected
        vet = torch.stack([torch.einsum("nm,nmx->nx",
                                        (rank == k).to(r12.dtype) * okf, r12)
                           for k in (1.0, 2.0, 3.0)], dim=1)  # (B, 3, 3)
        cont = torch.sum(okf, dim=1)
        cross01 = torch.linalg.cross(vet[:, 0], vet[:, 1])
        cross12 = torch.linalg.cross(vet[:, 1], vet[:, 2])
        cross20 = torch.linalg.cross(vet[:, 2], vet[:, 0])
        n3 = (cross01 + cross12 + cross20) / 3.0
        zhat = torch.zeros_like(cross01)
        zhat[:, 2] = 1.0
        n_raw = torch.where((cont <= 1)[:, None], zhat,
                            torch.where((cont == 2)[:, None], cross01, n3))
        norm = torch.sqrt(torch.clamp(torch.sum(n_raw * n_raw, dim=1),
                                      min=1e-24))
        return n_raw / norm[:, None]

    def per_atom_energy(self, r12, t1, t2, lab1, lab2, nbr_mask):
        """Per-atom interlayer energies (B,) of a block of rows: the centre
        types and labels (B,), the neighbours' (B, MN)."""
        dtype = r12.dtype
        t1, t2 = t1.long(), t2.long()
        real = nbr_mask > 0
        same = (lab1[:, None] == lab2) & real
        d2 = torch.sum(r12 * r12, dim=-1)
        r = torch.sqrt(torch.clamp(d2, min=1e-12))

        def p(tab):
            return tab[t1[:, None], t2].to(dtype)

        normal = self.normals(r12, same & (d2 < p(self.rcutsq_ilp)))
        x = r / p(self.rcut_global)
        tap = torch.zeros_like(x)
        for k in range(7, -1, -1):
            tap = tap * x + _TAP[k]
        prod = torch.einsum("nx,nmx->nm", normal, r12)
        rho2 = torch.clamp(d2 - prod * prod, min=0.0)
        exp0 = torch.exp(-p(self.lam) * (r - p(self.z0)))
        exp1 = torch.exp(-rho2 * p(self.delta2inv))
        e_rep = exp0 * (0.5 * p(self.epsilon) + p(self.cc) * exp1)
        ts = 1.0 + torch.exp(torch.clamp(-p(self.d_seff) * r + p(self.d),
                                         -60.0, 60.0))
        e_vdw = -0.5 * p(self.c6) / torch.clamp(d2 * d2 * d2,
                                                min=1e-12) / ts
        e_pair = torch.where((~same) & real & (x < 1.0),
                             tap * (e_rep + e_vdw), torch.zeros_like(x))
        return torch.sum(e_pair, dim=1)

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        jdx = nbr.idx.long()
        t2 = type_[jdx]
        lab2 = self.labels[torch.clamp(jdx, max=self.labels.shape[0] - 1)]
        return compute_from_pair_energy(
            lambda r12, rows: self.per_atom_energy(
                r12, type_[rows], t2[rows], self.labels[rows], lab2[rows],
                nbr.mask[rows]),
            nbr, mask, per_atom_virial=per_atom_virial,
            block=base.MANY_BODY_BLOCK)


def narrow_list(nbr: NeighborList, keep: torch.Tensor,
                mn: int) -> NeighborList:
    """The slots `keep` (N, MN) of `nbr` packed into `mn` slots a row in
    their order: a slot's place is its rank among its row's kept slots
    (a cumulative sum), and one scatter writes it there; padded slots
    point at the atom itself at _FAR.  Raises when a row keeps more than
    `mn` slots."""
    n = keep.shape[0]
    dev = keep.device
    count = torch.sum(keep, dim=1)
    if int(torch.max(count)) > mn:  # the pass's one read
        raise RuntimeError(
            f"neighbor overflow in the ILP intralayer list: an atom has "
            f"{int(torch.max(count))} same-layer neighbours within the "
            f"intralayer cutoff but the capacity is {mn}")
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    rows = torch.arange(n, device=dev)[:, None]
    # kept slots to (row, rank); the rest to a spare column mn, dropped
    dest = (rows * (mn + 1) + torch.where(keep, rank,
                                          torch.full_like(rank, mn))
            ).reshape(-1)
    idx = rows.expand(n, mn + 1).reshape(-1).clone()
    idx[dest] = nbr.idx.long().reshape(-1)
    r12 = torch.full((n * (mn + 1), 3), _FAR, dtype=nbr.r12.dtype,
                     device=dev)
    r12[dest] = nbr.r12.detach().reshape(-1, 3)
    valid = torch.arange(mn, device=dev)[None, :] < count[:, None]
    return NeighborList(idx=idx.reshape(n, mn + 1)[:, :mn].to(torch.int32),
                        r12=r12.reshape(n, mn + 1, 3)[:, :mn],
                        mask=valid.to(nbr.mask.dtype),
                        count=count.to(torch.int32))


class ILPHybrid(NamedTuple):
    """An intralayer potential on same-layer pairs plus the ILP term."""

    intra: object  # one potential, or a tuple of NEPs (per-group nep_ilp)
    ilp: ILPTerm
    rc: float
    # ILP type index -> the intralayer potential's type index (a nep_ilp
    # NEP may cover a subset of the ILP's elements); a tuple of such maps
    # for a per-group nep_ilp
    type_map: Optional[tuple] = None
    # (N,) index of each atom's NEP (nep_map[group]; ref: ilp_nep.cu:
    # 349-375); None for one intralayer potential
    nep_labels: Optional[torch.Tensor] = None
    # slots of the intralayer list; None: the long list's MN
    intra_mn: Optional[int] = None

    @property
    def intra_rc(self) -> float:
        pots = self.intra if _is_group(self.intra) else (self.intra,)
        return max(p.rc for p in pots)

    def _intra_single(self, intra, tmap, state, nbr_intra, mask):
        t_intra = state.type
        if tmap is not None:
            t_intra = torch.as_tensor(tmap, device=state.type.device)[
                state.type.long()]
        return intra.compute(t_intra, nbr_intra, mask)

    def compute_with_state(self, state, nbr: NeighborList) -> PotentialOutput:
        labels = self.ilp.labels
        n = labels.shape[0]
        jdx = torch.clamp(nbr.idx.long(), max=n - 1)
        d2 = torch.sum(nbr.r12 * nbr.r12, dim=-1)
        same = ((labels[:, None] == labels[jdx]) & (nbr.mask > 0)
                & (d2 < self.intra_rc ** 2))
        mn = self.intra_mn or nbr.idx.shape[1]
        if _is_group(self.intra):
            # atoms whose nep_map[group] == k: NEP k on the pairs inside
            # its atom set (ref: ilp_nep.cu:122-375)
            nl = self.nep_labels
            parts = []
            for k, (intra, tmap) in enumerate(zip(self.intra,
                                                  self.type_map)):
                keep = same & (nl[:, None] == k) & (nl[jdx] == k)
                parts.append(self._intra_single(
                    intra, tmap, state, narrow_list(nbr, keep, mn),
                    state.mask * (nl == k).to(state.mask.dtype)))
        else:
            parts = [self._intra_single(self.intra, self.type_map, state,
                                        narrow_list(nbr, same, mn),
                                        state.mask)]
        parts.append(self.ilp.compute(state.type, nbr, state.mask))
        return PotentialOutput(*(sum(o[k] for o in parts)
                                 for k in range(3)))


def _is_group(intra) -> bool:
    """A plain tuple of NEPs (NamedTuple potentials have _fields)."""
    return isinstance(intra, tuple) and not hasattr(intra, "_fields")


def _parse_ilp_header(path: str, n_group_ints: int):
    with open(path) as f:
        toks = f.read().split()
    t = int(toks[1])
    pos = 2 + t  # skip the symbols
    gms = [int(toks[pos + i]) for i in range(n_group_ints)]
    pos += n_group_ints
    rows = np.asarray([float(x) for x in toks[pos:pos + t * t * 12]]
                      ).reshape(t * t, 12)
    return t, toks[2:2 + t], gms, rows


def load_tersoff_ilp(ilp_path: str, tersoff_path: str, labels,
                     dtype=torch.float64, device=torch.device("cuda"),
                     intra_mn: Optional[int] = None):
    """potential tersoff_ilp <ilp_file> <tersoff_file> (ref: force.cu:
    189-195, ilp_tersoff.cu:60-230) -> (hybrid, ILP group method)."""
    from gpumd_tpu_torch.potentials.tersoff import Tersoff1988

    t, _, gms, rows = _parse_ilp_header(ilp_path, 1)
    ilp = ILPTerm.parse_rows(rows, t, labels, dtype=dtype, device=device)
    with open(tersoff_path) as f:  # a headerless T^3 x 14 block
        vals = np.asarray([float(x) for x in f.read().split()]
                          ).reshape(t * t * t, 14)
    intra = Tersoff1988(p=torch.as_tensor(vals, dtype=dtype, device=device),
                        num_types=t, rc=float(vals[:, 10].max()))
    return ILPHybrid(intra=intra, ilp=ilp, rc=max(ilp.rc, intra.rc),
                     intra_mn=intra_mn), gms[0]


def load_nep_ilp(ilp_path: str, map_path: str, labels, dtype=torch.float64,
                 device=torch.device("cuda"),
                 intra_mn: Optional[int] = None):
    """potential nep_ilp <ilp_file> <nep_map_file> (ref: force.cu:182-188,
    ilp_nep.cu:58-160).  The map file: nep_group_method, num_nep, the
    nep.txt paths (relative to the map file), then num_nep_group indices,
    one NEP a group.  Returns (hybrid, ilp group method, nep group method,
    nep_map); one NEP gives nep group method -1 and nep_map None."""
    from gpumd_tpu_torch.potentials.nep.model import NEP

    t, ilp_syms, gms, rows = _parse_ilp_header(ilp_path, 2)
    ilp = ILPTerm.parse_rows(rows, t, labels, dtype=dtype, device=device)
    with open(map_path) as f:
        mtoks = f.read().split()
    nep_gm, num_nep = int(mtoks[0]), int(mtoks[1])

    def load_one(fname):
        path = (fname if os.path.isabs(fname)
                else os.path.join(os.path.dirname(map_path), fname))
        nep = NEP.from_file(path, dtype=dtype, device=device)
        syms = list(nep.model.symbols)
        return nep, tuple(syms.index(s) if s in syms else 0
                          for s in ilp_syms)

    loaded = [load_one(f) for f in mtoks[2:2 + num_nep]]
    if num_nep == 1:
        nep, tmap = loaded[0]
        return ILPHybrid(intra=nep, ilp=ilp, rc=max(ilp.rc, nep.rc),
                         type_map=tmap, intra_mn=intra_mn), gms[0], -1, None
    neps, tmaps = zip(*loaded)
    rest = mtoks[2 + num_nep:]
    nep_map = np.asarray([int(x) for x in rest[1:1 + int(rest[0])]],
                         np.int32)
    if (nep_map >= num_nep).any():
        raise ValueError("nep_ilp: group mapped to a nonexistent NEP")
    rc = max([ilp.rc] + [p.rc for p in neps])
    return ILPHybrid(intra=tuple(neps), ilp=ilp, rc=rc, type_map=tuple(tmaps),
                     intra_mn=intra_mn), gms[0], nep_gm, nep_map


def load_sw_ilp(ilp_path: str, sw_path: str, labels, dtype=torch.float64,
                device=torch.device("cuda"), intra_mn: Optional[int] = None):
    """potential sw_ilp <ilp_file> <sw_file> (ref: force.cu:196-202,
    ilp_tmd_sw.cu:40-240) -> (hybrid, ILP group method)."""
    from gpumd_tpu_torch.potentials.sw import SW

    t, _, gms, rows = _parse_ilp_header(ilp_path, 1)
    ilp = ILPTerm.parse_rows(rows, t, labels, dtype=dtype, device=device)
    with open(sw_path) as f:
        vals = [float(x) for x in f.read().split()]
    intra = SW.from_tokens(np.asarray(vals), t, dtype=dtype, device=device)
    return ILPHybrid(intra=intra, ilp=ilp, rc=max(ilp.rc, intra.rc),
                     intra_mn=intra_mn), gms[0]


def layer_bound(position, labels, h, pbc, r: float) -> int:
    """A capacity for rows of the atoms of one layer within r of an atom
    of that layer (labels None: all atoms one layer): the fullest layer's
    atoms a unit area of the box's xy face times pi r^2, times the
    periodic copies along z a window of 2 r plus the layer's thickness
    can meet, x 1.5 + 8.  A bilayer in a vacuum box (the 3-D density
    bound of the app's _auto_mn counts the vacuum) keeps a bound above
    its rows."""
    pos = np.asarray(position, np.float64)
    h = np.asarray(h, np.float64)  # the cell's columns a, b, c
    area = float(np.linalg.norm(np.cross(h[:, 0], h[:, 1])))
    lz = abs(float(np.linalg.det(h))) / max(area, 1e-30)
    labels = (np.zeros(len(pos), int) if labels is None
              else np.asarray(labels)[:len(pos)])
    worst = 0.0
    for lab in np.unique(labels):
        z = pos[labels == lab, 2]
        span = float(z.max() - z.min())
        copies = int(np.ceil((2.0 * r + span) / lz)) if pbc[2] else 1
        worst = max(worst, len(z) / area * np.pi * r * r * copies)
    return int(worst * 1.5) + 8
