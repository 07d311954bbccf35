"""Phonons: finite-difference force constants -> dynamical matrix ->
dispersion along a k-path.

Counterpart of gpumd_tpu/phonon/hessian.py (ref: src/phonon/hessian.cu):
the system is a (cx, cy, cz) supercell of a primitive basis (atom n
belongs to basis n % num_basis); each basis atom is displaced +-delta in
x/y/z and force constants are read off the force response; D(k) is
assembled with exp(i k . r) phases and diagonalized; omega^2 in THz^2 goes
to omega2.out (natural->THz^2 factor 1e6/TIME_UNIT_CONVERSION^2,
hessian.cu:352-357).

kpoints.in: lines `kx ky kz name` (fractional, primitive reciprocal
coordinates); blank lines split path segments; 100 interpolation points
per leg (hessian.cu:110-180).

The 6 * num_basis force passes run one after another through
`ForceField.compute` on the state's device; D(k) is assembled there for
every k-point at once (minimum-image phases, one einsum a basis atom) and
solved by `torch.linalg.eigvalsh`, batched over the k-points.  The path
and its file parsing are numpy, copied from the JAX module.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION

# omega^2 in natural units -> THz^2 (ref: hessian.cu:352-357)
NATURAL_TO_THZ2 = 1.0e6 / TIME_UNIT_CONVERSION ** 2


def parse_kpoints_in(path: str):
    """Returns (segments, names): segments = list of lists of frac k."""
    segments: List[List[np.ndarray]] = []
    names: List[str] = []
    cur: List[np.ndarray] = []
    cur_names: List[str] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                if cur:
                    segments.append(cur)
                    names.append(" ".join(cur_names))
                    cur, cur_names = [], []
                continue
            if toks[0].startswith("#"):
                continue
            if len(toks) < 4:
                raise ValueError("kpoints.in needs `kx ky kz name` per line")
            cur.append(np.array([float(x) for x in toks[:3]]))
            cur_names.append(toks[3])
    if cur:
        segments.append(cur)
        names.append(" ".join(cur_names))
    return segments, names


def build_kpath(segments, prim_lattice_rows: np.ndarray, points_per_leg=100):
    """Interpolate Cartesian k-points along the path; returns
    (kpoints (K,3), kpath (K,), sym_positions)."""
    rec = 2.0 * np.pi * np.linalg.inv(prim_lattice_rows).T  # rows b1,b2,b3
    kpts = []
    kpath = [0.0]
    sym_pos = [0.0]
    first = segments[0][0] @ rec
    kpts.append(first)
    for seg in segments:
        for i in range(1, len(seg)):
            start = seg[i - 1] @ rec
            end = seg[i] @ rec
            last = kpts[-1]
            for j in range(1, points_per_leg + 1):
                k = start + (end - start) * (j / points_per_leg)
                kpath.append(kpath[-1] + np.linalg.norm(k - last))
                kpts.append(k)
                last = k
            sym_pos.append(kpath[-1])
    return np.array(kpts), np.array(kpath), np.array(sym_pos)


def force_constants(ff: ForceField, state: MDState, basis_indices,
                    displacement: float) -> torch.Tensor:
    """Phi[b, alpha, j, beta] = -dF_j,beta / du_b,alpha by central
    differences over 6 * num_basis force passes, on the state's device:
    (nb, 3, N, 3)."""
    forces = []
    with torch.no_grad():
        for b in basis_indices:
            for alpha in range(3):
                pair = []
                for sgn in (1.0, -1.0):
                    pos = state.position.clone()
                    pos[b, alpha] += sgn * displacement
                    pair.append(ff.compute(
                        state._replace(position=pos)).force)
                forces.append(pair)
    f = torch.stack([torch.stack(p) for p in forces])  # (nb * 3, 2, N, 3)
    phi = -(f[:, 0] - f[:, 1]) / (2.0 * displacement)
    return phi.reshape(len(basis_indices), 3, *phi.shape[1:])


def dynamical_matrices(phi: torch.Tensor, state: MDState, kpts: np.ndarray,
                       mass: np.ndarray) -> torch.Tensor:
    """D(k) for every k-point, (K, 3 nb, 3 nb) complex on phi's device,
    hermitised: block (b, j) sums phi[b][:, n, :] exp(i k . r_bn) /
    sqrt(m_b m_n) over the atoms n of basis j, r_bn the minimum image
    of r_n - r_b."""
    nb, n = phi.shape[0], phi.shape[2]
    dev = phi.device
    ctype = torch.complex128 if phi.dtype == torch.float64 \
        else torch.complex64
    pos = state.position.to(phi.dtype)
    h = state.box.h.to(phi.dtype)
    hinv = torch.linalg.inv(h)
    label = torch.arange(n, device=dev) % nb
    onehot = torch.nn.functional.one_hot(label, nb).to(phi.dtype)  # (N, nb)
    mass_t = torch.as_tensor(np.asarray(mass, np.float64), dtype=phi.dtype,
                             device=dev)
    k = torch.as_tensor(kpts, dtype=phi.dtype, device=dev)  # (K, 3)
    blocks = []
    for b in range(nb):
        s = (pos - pos[b]) @ hinv.T
        r12 = (s - torch.round(s)) @ h.T  # (N, 3)
        phase = torch.polar(torch.ones((), dtype=phi.dtype, device=dev),
                            k @ r12.T)  # (K, N)
        w = phase / torch.sqrt(mass_t[b] * mass_t[label])[None, :]
        # (K, 3, nb, 3): row a of basis b against column c of basis j
        blocks.append(torch.einsum("anc,kn,nj->kajc",
                                   phi[b].to(ctype), w.to(ctype),
                                   onehot.to(ctype)))
    d = torch.stack(blocks, dim=1)  # (K, nb, 3, nb, 3)
    d = d.reshape(k.shape[0], 3 * nb, 3 * nb)
    return 0.5 * (d + d.conj().transpose(1, 2))


def compute_phonon_dispersion(ff: ForceField, state: MDState,
                              cxyz: Tuple[int, int, int],
                              displacement: float, workdir: str = ".",
                              masses=None):
    """omega^2 along kpoints.in's path into omega2.out and D(k) into D.out
    (the JAX module's formats); returns (kpath, omega2) as numpy."""
    n = state.position.shape[0]
    num_basis = n // (cxyz[0] * cxyz[1] * cxyz[2])
    mass = (state.mass[:num_basis].detach().cpu().numpy().astype(np.float64)
            if masses is None else np.asarray(masses, np.float64))
    phi = force_constants(ff, state, list(range(num_basis)), displacement)

    # primitive lattice: supercell lattice / replication (rows = vectors)
    sup_rows = state.box.h.detach().cpu().numpy().astype(np.float64).T
    prim_rows = sup_rows / np.asarray(cxyz)[:, None]
    segments, names = parse_kpoints_in(os.path.join(workdir, "kpoints.in"))
    kpts, kpath, sym_pos = build_kpath(segments, prim_rows)

    d = dynamical_matrices(phi, state, kpts, mass)
    omega2 = torch.linalg.eigvalsh(d) * NATURAL_TO_THZ2
    # D.out: 3 * N_basis rows a k-point, [real | imag] column blocks
    # (ref: hessian.cu output_D / D_out.rst)
    d_rows = torch.cat([d.real, d.imag], dim=2) * NATURAL_TO_THZ2
    d_rows = d_rows.detach().cpu().numpy().astype(np.float64)
    omega2 = omega2.detach().cpu().numpy().astype(np.float64)
    with open(os.path.join(workdir, "D.out"), "w") as f:
        for dmat in d_rows:
            for row in dmat:
                f.write(" ".join(f"{x:g}" for x in row) + "\n")
    with open(os.path.join(workdir, "omega2.out"), "w") as f:
        f.write("#")
        for s in sym_pos:
            f.write(f" {s:.6f}")
        f.write(" ")
        f.write("|".join(names))
        f.write("\n")
        for ik in range(len(kpts)):
            f.write(f"{kpath[ik]:.6f} ")
            f.write(" ".join(f"{w:g}" for w in omega2[ik]))
            f.write("\n")
    return kpath, omega2
