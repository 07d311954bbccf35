"""Shared potential machinery: partial forces -> forces and per-atom virials.

Counterpart of gpumd_tpu/potentials/base.py.  The reference's many-body
reducer (ref: src/force/potential.cu:73-113) turns per-pair partial forces
into per-atom force and Fan2015 per-atom virial.  Here the partial force
p_ij = dE/dr12_ij comes from one reverse sweep through the energy function
(torch.autograd.grad of sum(e_atom * mask) with respect to a leaf r12), and
the reduction is either a gather through the reverse-pair map or a
scatter:

    F_k  = sum_j p_kj  -  sum over pairs (a -> k) of p_ak
    W_b += (-r12_ab) (x) p_ab   over the pairs (a -> b)   (Fan2015)

Energies are smooth and vanish at the cutoff, so padded slots (parked at
_FAR) add exactly zero to the energy and its gradient.  The autograd graph
lives inside one force pass: callers may run under torch.no_grad().
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gpumd_tpu_torch.neighbor.neighbor import NeighborList, gather_vec3


class PotentialOutput(NamedTuple):
    energy: torch.Tensor  # (N,) per-atom potential energy, eV
    force: torch.Tensor  # (N, 3) eV/A
    virial: torch.Tensor  # (N, 3, 3) eV, Fan2015 per-atom convention


def _scatter_rows(values: torch.Tensor, idx: torch.Tensor, n: int):
    """sum over flat pairs of values into rows idx (the JAX segment_sum)."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, idx.reshape(-1).long(), values)


def forces_virial_from_partials(p: torch.Tensor, nbr: NeighborList):
    """Per-atom force (N, 3) and virial (N, 3, 3) from p (N, MN, 3).

    With nbr.rev (the cached path): F_i = sum_m (p[i,m] - p[rev[i,m]]),
    W_i = sum_m r12[i,m] (x) p[rev[i,m]] (potential.cu:73-113), a gather
    whose order is fixed.  Without it, a scatter over neighbour indices
    (index_add_, whose order on the card is not fixed)."""
    n = p.shape[0]
    if nbr.rev is not None:
        p_rev = gather_vec3(p.reshape(-1, 3), nbr.rev) * nbr.mask[..., None]
        force = torch.sum(p - p_rev, dim=1)
        virial = torch.einsum("nma,nmb->nab", nbr.r12 * nbr.mask[..., None],
                              p_rev)
        return force, virial
    force = torch.sum(p, dim=1) - _scatter_rows(p.reshape(-1, 3), nbr.idx, n)
    # W_b = sum over pairs (a -> b) of (-r12_ab) (x) p_ab; padded slots have
    # p == 0 but r12 == _FAR: masked anyway
    w_pair = (-nbr.r12[..., :, None] * p[..., None, :]
              * nbr.mask[..., None, None])
    return force, _scatter_rows(w_pair.reshape(-1, 3, 3), nbr.idx, n)


def energy_and_partials(energy_fn: Callable, r12: torch.Tensor,
                        mask: torch.Tensor, block: Optional[int] = None):
    """(e (N,) * mask, p = d sum(e * mask) / d r12 (N, MN, 3)).

    energy_fn(r12_rows, rows) -> (B,) energies of the atoms `rows` (a
    slice).  An atom's energy depends only on its own r12 rows, so with
    `block` the energy and its gradient are taken block by block, forward
    and backward inside the loop: the graph of one block at a time."""
    n = r12.shape[0]
    step = block or max(n, 1)
    e = torch.empty(n, dtype=r12.dtype, device=r12.device)
    p = torch.empty_like(r12)
    for s in range(0, n, step):
        rows = slice(s, min(s + step, n))
        with torch.enable_grad():
            r = r12[rows].detach().requires_grad_(True)
            eb = energy_fn(r, rows)
            (g,) = torch.autograd.grad(eb, r, grad_outputs=mask[rows].to(
                eb.dtype))
        e[rows] = eb.detach()
        p[rows] = g
    return e * mask, p


def compute_from_pair_energy(energy_fn: Callable, nbr: NeighborList,
                             mask: torch.Tensor, per_atom_virial: bool = True,
                             block: Optional[int] = None) -> PotentialOutput:
    """Full evaluation from a per-atom energy function of r12.

    energy_fn(r12_rows, rows) -> (B,) per-atom energies (see
    `energy_and_partials`; the JAX package's takes the whole r12).  With
    per_atom_virial False and no reverse map only the total virial is
    computed and spread uniformly over real atoms (pressure and thermo
    stay exact); with a reverse map the per-atom virial is a cheap gather
    and is always computed."""
    e_atom, p = energy_and_partials(energy_fn, nbr.r12, mask, block)
    return output_from_partials(e_atom, p, nbr, mask, per_atom_virial)


def output_from_partials(e_atom: torch.Tensor, p: torch.Tensor,
                         nbr: NeighborList, mask: torch.Tensor,
                         per_atom_virial: bool = True) -> PotentialOutput:
    """PotentialOutput from the masked per-atom energies and the partials
    p = d sum(e * mask) / d r12 (see compute_from_pair_energy)."""
    if per_atom_virial or nbr.rev is not None:
        force, virial = forces_virial_from_partials(p, nbr)
    else:
        n = p.shape[0]
        force = (torch.sum(p, dim=1)
                 - _scatter_rows(p.reshape(-1, 3), nbr.idx, n))
        w_total = -torch.einsum("pma,pmb->ab",
                                nbr.r12 * nbr.mask[..., None], p)
        n_real = torch.clamp(torch.sum(mask), min=1.0)
        virial = (w_total / n_real) * mask[:, None, None]
    return PotentialOutput(energy=e_atom, force=force, virial=virial)


# centres a block of a many-body potential's energy and its autograd sweep
# (the JAX package's block of pair_energies): the (B, MN, MN) angle
# tensors of one block are alive at a time
MANY_BODY_BLOCK = 2048


def compute_typed(pair_energies: Callable, type_: torch.Tensor,
                  nbr: NeighborList, mask: torch.Tensor,
                  per_atom_virial: bool = True) -> PotentialOutput:
    """compute_from_pair_energy of `pair_energies(r12, t1, t2)` (the
    centre types (B,) and the neighbour types (B, MN)), a block of
    MANY_BODY_BLOCK centres at a time."""
    t2 = type_[nbr.idx.long()]
    return compute_from_pair_energy(
        lambda r12, rows: pair_energies(r12, type_[rows], t2[rows]), nbr,
        mask, per_atom_virial=per_atom_virial, block=MANY_BODY_BLOCK)


def read_tokens(path: str, header: str) -> list:
    """The whitespace tokens of a potential file whose first is `header`."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != header:
        raise ValueError(f"{path}: not a {header} file")
    return tokens
