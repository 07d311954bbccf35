"""Training dataset: structures -> static batched tensors.

Counterpart of gpumd_tpu/train/dataset.py.  The reference's Dataset
concatenates structures per batch and precomputes STATIC neighbour lists
and r12 displacements once (ref: src/main_nep/dataset.cu:276-338,
structure.cu:55-67); training cells are tiny, so virtual-image
replication handles boxes thinner than 2 rc.

A batch is a dense (C, A, ...) set of tensors on one device: C configs
padded to A atoms and MN neighbour slots.  Beside the JAX package's
fields it carries `rev`, the mirror slot of every pair within its config
(neighbor.build_reverse_map on the host), so that the trainers reduce
forces by a gather, whose order is fixed, where the JAX package uses
segment_sum: index_add_ on the card sums in no fixed order, and a resumed
gnep run would drift from a straight one.

A qNEP batch (charge_mode > 0) also carries the positions as given, the
total charge and Born effective charge labels, and each config's Ewald
k-vectors and G(k) (potentials/nep/charge.py::ewald_kvectors on the
lattice, alpha = pi / rc), padded with zeros to the batch's largest K.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gpumd_tpu_torch.io.xyz import XYZFrame
from gpumd_tpu_torch.neighbor.neighbor import NeighborList, build_reverse_map
from gpumd_tpu_torch.potentials.nep.charge import ewald_kvectors


class StructureBatch(NamedTuple):
    """Dense batch of training configurations (torch tensors)."""

    # Per-pair static neighbour data (built once, like the reference).
    r12: torch.Tensor  # (C, A, MN, 3)
    idx: torch.Tensor  # (C, A, MN) int32 (within-config indices)
    nbr_mask: torch.Tensor  # (C, A, MN)
    # Per-atom
    type: torch.Tensor  # (C, A) int32
    mask: torch.Tensor  # (C, A)
    force_ref: torch.Tensor  # (C, A, 3)
    # Per-config
    n_atoms: torch.Tensor  # (C,)
    energy_ref: torch.Tensor  # (C,) total energy (eV)
    virial_ref: torch.Tensor  # (C, 6) Voigt xx yy zz xy yz zx
    has_virial: torch.Tensor  # (C,)
    weight: torch.Tensor  # (C,) per-config loss weight
    energy_weight: torch.Tensor  # (C,)
    # per-atom tensorial references (atomic_v; adipole/apol columns)
    avirial_ref: Optional[torch.Tensor] = None  # (C, A, 6) Voigt
    has_avirial: Optional[torch.Tensor] = None  # (C,)
    # rev[c, a, m] = a' * MN + m', the slot of config c holding the mirror
    # pair of slot (a, m); 0 on padded slots (masked by nbr_mask)
    rev: Optional[torch.Tensor] = None  # (C, A, MN) int64
    # qNEP training extras (charge_mode > 0; None otherwise)
    position: Optional[torch.Tensor] = None  # (C, A, 3) as given
    charge_ref: Optional[torch.Tensor] = None  # (C,) total config charge
    bec_ref: Optional[torch.Tensor] = None  # (C, A, 9) Born charges
    has_bec: Optional[torch.Tensor] = None  # (C,)
    kvec: Optional[torch.Tensor] = None  # (C, K, 3) Ewald k (zero padded)
    gk: Optional[torch.Tensor] = None  # (C, K) G(k); 0 on padding

    @property
    def num_configs(self) -> int:
        return self.type.shape[0]

    @property
    def max_atoms(self) -> int:
        return self.type.shape[1]


def _parse_virial(info) -> Optional[tuple]:
    """virial= / stress= 9 or 6 components -> (key, 3x3).
    (ref: structure.cu reads both forms; stress needs -V factor)"""
    for key in ("virial", "stress"):
        if key in info:
            vals = np.array([float(x) for x in info[key].split()])
            if vals.size == 9:
                m = vals.reshape(3, 3)
            elif vals.size == 6:
                # Voigt xx yy zz yz xz xy input order
                m = np.array([[vals[0], vals[5], vals[4]],
                              [vals[5], vals[1], vals[3]],
                              [vals[4], vals[3], vals[2]]])
            else:
                raise ValueError(f"{key}= must have 6 or 9 numbers")
            return key, m
    return None


def _host_neighbors(pos, lattice, pbc, rc, mn, ci):
    """Pure-numpy per-frame neighbour build (MIC + periodic images): the
    JAX package's, with the same slot order, plus each slot's integer
    image shift (for the reverse map).

    Same semantics as neighbor_brute + num_replicas_for_cutoff; training
    cells are small, so host numpy is milliseconds per frame and dataset
    preparation never waits on the device."""
    n = pos.shape[0]
    h = lattice.T  # columns = lattice vectors (Box convention)
    h_inv = np.linalg.inv(h)
    pbcf = np.asarray([1.0 if p else 0.0 for p in pbc])
    vol = abs(np.linalg.det(h))
    a1, a2, a3 = h[:, 0], h[:, 1], h[:, 2]
    thick = [vol / np.linalg.norm(np.cross(a2, a3)),
             vol / np.linalg.norm(np.cross(a3, a1)),
             vol / np.linalg.norm(np.cross(a1, a2))]
    reps = [max(0, int(np.ceil(rc / thick[d] + 0.5 - 1e-9)) - 1)
            if pbcf[d] > 0 else 0 for d in range(3)]
    sf = np.stack(
        np.meshgrid(*[np.arange(-r, r + 1) for r in reps], indexing="ij"),
        axis=-1).reshape(-1, 3).astype(np.float64)
    zi = int(np.argmax(np.all(sf == 0, axis=1)))
    sf[[0, zi]] = sf[[zi, 0]]  # zero shift first (self-exclusion below)
    shifts = sf @ h.T  # (n_img, 3)

    out_idx = np.zeros((n, mn), np.int32)
    out_r12 = np.full((n, mn, 3), 1.0e5, np.float64)
    out_msk = np.zeros((n, mn), np.float64)
    out_shift = np.zeros((n, mn, 3), np.int64)
    rc2 = rc * rc
    blk = 512
    for lo in range(0, n, blk):
        hi = min(n, lo + blk)
        rij = pos[None, :, :] - pos[lo:hi, None, :]  # j - i
        s = rij @ h_inv.T
        mic = np.round(s) * pbcf[None, None, :]
        rij = (s - mic) @ h.T
        d_all = rij[:, :, None, :] + shifts[None, None, :, :]
        d2 = np.einsum("bjmk,bjmk->bjm", d_all, d_all)
        valid = d2 < rc2
        valid[np.arange(hi - lo), np.arange(lo, hi), 0] = False  # self
        for b in range(hi - lo):
            jj, mm = np.nonzero(valid[b])
            cnt = len(jj)
            if cnt > mn:
                raise ValueError(
                    f"config {ci}: neighbor overflow ({cnt} > {mn})")
            out_idx[lo + b, :cnt] = jj
            out_r12[lo + b, :cnt] = d_all[b, jj, mm]
            out_msk[lo + b, :cnt] = 1.0
            # r12 = pos_j - pos_i + (sf - mic) h^T: the slot's lattice shift
            out_shift[lo + b, :cnt] = np.rint(sf[mm] - mic[b, jj])
    return out_idx, out_r12, out_msk, out_shift


def _reverse_map(idx, msk, shift):
    """Mirror slot of every pair of one config, flat a * MN + m (the port's
    build_reverse_map on the host; a padding column is added when A * MN
    is odd, which no valid slot's mirror lands in)."""
    a, mn = idx.shape
    width = mn + (a * mn) % 2
    pad = width - mn

    def widen(x, fill):
        return np.concatenate(
            [x, np.full((a, pad) + x.shape[2:], fill, x.dtype)], axis=1)

    if pad:
        idx = widen(idx, 0)
        msk = widen(msk, 0.0)
        shift = widen(shift, 0)
    nbr = NeighborList(idx=torch.as_tensor(idx),
                       r12=torch.zeros(idx.shape + (3,)),
                       mask=torch.as_tensor(msk),
                       count=torch.zeros(a, dtype=torch.int32))
    rev = build_reverse_map(nbr, torch.as_tensor(shift)).numpy()
    rev = rev.astype(np.int64)[:, :mn]
    # flat a' * width + m' -> a' * MN + m' (m' < MN on every valid slot)
    return np.where(msk[:, :mn] > 0, (rev // width) * mn + rev % width, 0)


def batch_structures(
    frames: Sequence[XYZFrame],
    symbols: Sequence[str],
    rc: float,
    mn: int,
    max_atoms: Optional[int] = None,
    dtype=torch.float32,
    model_type: int = 0,
    charge_mode: int = 0,
    trim: bool = True,
    device=torch.device("cuda"),
) -> StructureBatch:
    """Build a dense batch on `device`.  Neighbour lists are computed per
    config with the brute-force + periodic-image path on the host.

    With `trim` the slot columns that are padding in every row are cut
    (MN becomes the batch's largest neighbour count, rounded up to even):
    padded slots give exact zeros, so the numbers do not change."""
    c = len(frames)
    a = max_atoms or max(f.n_atoms for f in frames)
    r12 = np.full((c, a, mn, 3), 1.0e5)
    idx = np.zeros((c, a, mn), dtype=np.int32)
    nbr_mask = np.zeros((c, a, mn))
    rev = np.zeros((c, a, mn), dtype=np.int64)
    type_ = np.zeros((c, a), dtype=np.int32)
    mask = np.zeros((c, a))
    force_ref = np.zeros((c, a, 3))
    n_atoms = np.zeros((c,), dtype=np.int32)
    energy_ref = np.zeros((c,))
    virial_ref = np.zeros((c, 6))
    has_virial = np.zeros((c,))
    weight = np.ones((c,))
    energy_weight = np.ones((c,))
    avirial_ref = None  # allocated on the first adipole/apol column
    has_avirial = None
    position = np.zeros((c, a, 3)) if charge_mode else None
    charge_ref = np.zeros((c,)) if charge_mode else None
    bec_ref = np.zeros((c, a, 9)) if charge_mode else None
    has_bec = np.zeros((c,)) if charge_mode else None
    kg_list = []
    alpha_ewald = np.pi / rc  # ref: nep_charge.cu:207 alpha = pi/rc_radial

    sym_index = {s: i for i, s in enumerate(symbols)}
    for ci, f in enumerate(frames):
        n = f.n_atoms
        if n > a:
            raise ValueError(f"config {ci} has {n} atoms > max_atoms {a}")
        h_idx, h_r12, h_msk, h_shift = _host_neighbors(
            np.asarray(f.positions, np.float64),
            np.asarray(f.lattice, np.float64).reshape(3, 3),
            f.pbc, rc, mn, ci)
        r12[ci, :n] = h_r12
        idx[ci, :n] = h_idx
        nbr_mask[ci, :n] = h_msk
        rev[ci, :n] = _reverse_map(h_idx, h_msk, h_shift)
        type_[ci, :n] = [sym_index[s] for s in f.symbols]
        mask[ci, :n] = 1.0
        n_atoms[ci] = n
        if f.forces is not None:
            force_ref[ci, :n] = f.forces
        if "energy" in f.info:
            energy_ref[ci] = float(f.info["energy"])
        if model_type == 1:
            # TNEP dipole training: total dipole rides the virial slots
            # (ref: structure.cu:351-374)
            if "dipole" in f.info:
                virial_ref[ci, :3] = [float(x)
                                      for x in f.info["dipole"].split()]
                has_virial[ci] = 1.0
            ad = None
            if f.arrays:
                ad = f.arrays.get("adipole", f.arrays.get("atomic_dipole"))
            if ad is not None:
                if avirial_ref is None:
                    avirial_ref = np.zeros((c, a, 6))
                    has_avirial = np.zeros((c,))
                avirial_ref[ci, :n, :3] = np.asarray(ad)
                has_avirial[ci] = 1.0
            if "weight" in f.info:
                weight[ci] = float(f.info["weight"])
            continue
        if model_type == 2:
            # TNEP polarizability training: 9 -> Voigt (xx yy zz xy yz zx)
            # (ref: structure.cu:384-404 reduced_index)
            if "pol" in f.info:
                m = np.asarray([float(x)
                                for x in f.info["pol"].split()]).reshape(3, 3)
                virial_ref[ci] = [m[0, 0], m[1, 1], m[2, 2],
                                  m[0, 1], m[1, 2], m[2, 0]]
                has_virial[ci] = 1.0
            ap = None
            if f.arrays:
                ap = f.arrays.get("apol",
                                  f.arrays.get("atomic_polarizability"))
            if ap is not None:
                if avirial_ref is None:
                    avirial_ref = np.zeros((c, a, 6))
                    has_avirial = np.zeros((c,))
                m9 = np.asarray(ap).reshape(n, 3, 3)
                avirial_ref[ci, :n] = np.stack(
                    [m9[:, 0, 0], m9[:, 1, 1], m9[:, 2, 2],
                     m9[:, 0, 1], m9[:, 1, 2], m9[:, 2, 0]], axis=1)
                has_avirial[ci] = 1.0
            if "weight" in f.info:
                weight[ci] = float(f.info["weight"])
            continue
        v = _parse_virial(f.info)
        if v is not None:
            key, m = v
            if key == "stress":
                # stress (eV/A^3) -> virial (eV): W = -V * stress
                m = -abs(np.linalg.det(np.asarray(f.lattice))) * m
            virial_ref[ci] = [m[0, 0], m[1, 1], m[2, 2],
                              m[0, 1], m[1, 2], m[2, 0]]
            has_virial[ci] = 1.0
        if "weight" in f.info:
            weight[ci] = float(f.info["weight"])
        if "energy_weight" in f.info:
            energy_weight[ci] = float(f.info["energy_weight"])
        if charge_mode:
            position[ci, :n] = np.asarray(f.positions)
            if "charge" in f.info:
                charge_ref[ci] = float(f.info["charge"])
            bec = f.arrays.get("bec") if f.arrays else None
            if bec is not None:
                bec_ref[ci, :n] = np.asarray(bec).reshape(n, 9)
                has_bec[ci] = 1.0
            lat = np.asarray(f.lattice, np.float64).reshape(3, 3)
            kg_list.append(ewald_kvectors(lat.T, alpha_ewald))

    kvec = gk = None
    if charge_mode:
        kmax = max(max(len(g) for _, g in kg_list), 1)
        kvec = np.zeros((c, kmax, 3))
        gk = np.zeros((c, kmax))
        for ci, (ks, gs) in enumerate(kg_list):
            kvec[ci, :len(gs)] = ks
            gk[ci, :len(gs)] = gs

    if trim:
        width = int(nbr_mask.sum(-1).max())
        width = min(mn, width + width % 2)
        if width < mn:
            # a slot a * MN + m moves to a * width + m
            rev = np.where(nbr_mask[..., :width] > 0,
                           (rev[..., :width] // mn) * width
                           + rev[..., :width] % mn, 0)
            r12, idx, nbr_mask = (x[:, :, :width] for x in
                                  (r12, idx, nbr_mask))

    def put(x, kind=dtype):
        # float arrays reach the batch's dtype through the JAX package's
        # float32 host arrays when dtype is float32, so the values agree
        if x is None:
            return None
        if kind.is_floating_point:
            x = np.asarray(x, np.float64 if kind == torch.float64
                           else np.float32)
        return torch.as_tensor(x, dtype=kind, device=device)

    # Padded-atom neighbour slots point at atom 0; idx of padded rows is 0.
    return StructureBatch(
        r12=put(r12), idx=put(idx, torch.int32), nbr_mask=put(nbr_mask),
        type=put(type_, torch.int32), mask=put(mask),
        force_ref=put(force_ref), n_atoms=put(n_atoms, torch.int32),
        energy_ref=put(energy_ref), virial_ref=put(virial_ref),
        has_virial=put(has_virial), weight=put(weight),
        energy_weight=put(energy_weight), avirial_ref=put(avirial_ref),
        has_avirial=put(has_avirial), rev=put(rev, torch.int64),
        position=put(position), charge_ref=put(charge_ref),
        bec_ref=put(bec_ref), has_bec=put(has_bec), kvec=put(kvec),
        gk=put(gk))
