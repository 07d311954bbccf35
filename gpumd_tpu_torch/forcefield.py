"""ForceField: neighbour build + potential dispatch for one MD step.

Counterpart of gpumd_tpu/forcefield.py; plays the role of the reference's
`Force` driver (ref: src/force/force.cu:75-218 parse, 424-631 per-step
wrap / zero / dispatch): `ff.compute(state) -> state` with force,
per-atom energy and per-atom virial filled.

The neighbour strategy is chosen once, on the host, from the initial box:
small boxes take brute force with periodic images, large ones the dense
cell list (ref: the small/large-box duality of nep.cu:1356-1389).  The
Verlet-skin cache (`refresh_cache`, `compute_cached`) keeps the list,
built at rc + skin, until an atom has moved more than skin/2; testing
that is one host sync a step (`bool(need)`), where the JAX package used
lax.cond.  Everything runs in plain torch on the state's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.model.box import Box, num_replicas_for_cutoff
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.neighbor.neighbor import (
    _FAR,
    NeighborList,
    build_reverse_map,
    choose_grid,
    default_cell_cap,
    max_cell_occupancy,
    neighbor_brute,
    neighbor_cell_dense,
)


def _pin_fp32(t: torch.Tensor):
    """Full-f32 matmuls on the card (no TF32), as every NEP path of the
    port runs (engine/nep_compact.py's pin_fp32_matmul)."""
    if t.is_cuda:
        from gpumd_tpu_torch.engine.nep_compact import pin_fp32_matmul

        pin_fp32_matmul()


@dataclass(frozen=True)
class NeighborConfig:
    rc: float
    mn: int
    method: str  # "brute" | "cell"
    reps: tuple = (0, 0, 0)
    grid: Optional[tuple] = None
    cell_cap: Optional[int] = None

    @staticmethod
    def create(box: Box, rc: float, n_atoms: int, mn: int,
               skin: float = 0.0) -> "NeighborConfig":
        """Host-side plan from the initial box."""
        mn += mn & 1  # even MN keeps the N * MN pair sort aligned
        rc_eff = rc + skin
        grid = choose_grid(box, rc_eff)
        if grid is None or n_atoms <= 2048:
            return NeighborConfig(rc=rc_eff, mn=mn, method="brute",
                                  reps=num_replicas_for_cutoff(box, rc_eff))
        return NeighborConfig(rc=rc_eff, mn=mn, method="cell", grid=grid,
                              cell_cap=default_cell_cap(box, grid, n_atoms))

    def build(self, position, box: Box, mask) -> NeighborList:
        """The list of `position` (wrapped).  The cell bins hold at least
        the fullest cell of this build (one host read): a compressed region
        (a shock, a deformed box) past the plan's cell_cap would otherwise
        drop atoms from every list of its cells."""
        if self.method == "brute":
            return neighbor_brute(position, box, mask, rc=self.rc,
                                  mn=self.mn, reps=self.reps)
        cap = max(self.cell_cap,
                  max_cell_occupancy(position, box, mask, self.grid))
        return neighbor_cell_dense(position, box, mask, rc=self.rc,
                                   mn=self.mn, grid=self.grid, cell_cap=cap)


class NeighborCache(NamedTuple):
    """Verlet-list cache: the neighbour topology kept across steps.

    `shift_frac` holds each pair's integer lattice-image shift, so
    r12 = pos[j] - pos[i] + shift @ h^T stays exact without wrapping
    (positions are not wrapped between rebuilds)."""

    idx: torch.Tensor  # (N, MN) int32
    shift_frac: torch.Tensor  # (N, MN, 3) int8 lattice-image shifts
    mask: torch.Tensor  # (N, MN)
    count: torch.Tensor  # (N,)
    ref_position: torch.Tensor  # (N, 3) positions at build time
    rev: torch.Tensor  # (N, MN) int32 reverse-pair map
    # () the deepest row (pre-cap count) of every list this cache has
    # held: compared with MN at a caller's chunk end, with no sync here
    peak: Optional[torch.Tensor] = None


def _dispatch(pot, state: MDState, nbr: NeighborList, per_atom_virial):
    """One potential's output: compute_with_state where it has one (as the
    JAX package's _evaluate_prec), else compute on the types."""
    if hasattr(pot, "compute_with_state"):
        return pot.compute_with_state(state, nbr)
    return pot.compute(state.type, nbr, state.mask,
                       per_atom_virial=per_atom_virial)


@dataclass(frozen=True)
class ForceField:
    """One or more potentials on a shared neighbour plan.  A potential
    exposes .rc and .compute(type_, nbr, mask, per_atom_virial) ->
    PotentialOutput, or .compute_with_state(state, nbr) when it needs more
    of the state than the types (positions, the box: FCP, DP, qNEP, the
    ILP hybrids), which the dispatch then prefers."""

    potentials: tuple
    neighbor: NeighborConfig
    # per-atom virials (heat-current observables) or the total spread over
    # the atoms (pressure and thermo exact either way)
    per_atom_virial: bool = True
    # Verlet skin (A): lists built at rc + skin, kept until an atom moved
    # more than skin/2
    skin: float = 0.0
    # HNEMD driving force Fe (1/A): F_i += W_i^T Fe, then the net force is
    # removed (ref: force.cu:567-608); None disables
    hnemd_fe: Optional[tuple] = None
    # HNEMDEC (ref: force.cu:355-961): mode 0 heat flow, k > 0 colour flow
    # of species k-1; coef from hnemdec_coefficients()
    hnemdec_mode: Optional[int] = None
    hnemdec_fe: Optional[tuple] = None
    hnemdec_coef: Optional[tuple] = None
    # several potentials: their mean instead of their sum
    # (ref: force.cu:514-565)
    average: bool = False

    @staticmethod
    def create(potentials, box: Box, n_atoms: int, mn: int = 256,
               skin: float = 0.0, per_atom_virial: bool = True):
        rc = max(p.rc for p in potentials)
        cfg = NeighborConfig.create(box, rc, n_atoms, mn=mn, skin=skin)
        return ForceField(potentials=tuple(potentials), neighbor=cfg,
                          per_atom_virial=per_atom_virial, skin=skin)

    def compute(self, state: MDState) -> MDState:
        """One-shot evaluation: wrap, rebuild neighbours, evaluate."""
        pos = state.box.wrap(state.position)
        nbr = self.neighbor.build(pos, state.box, state.mask)
        return self._evaluate(state._replace(position=pos), nbr)

    def _evaluate(self, state: MDState, nbr: NeighborList) -> MDState:
        _pin_fp32(state.position)
        e = torch.zeros_like(state.potential_energy)
        f = torch.zeros_like(state.force)
        w = torch.zeros_like(state.virial)
        for pot in self.potentials:
            out = _dispatch(pot, state, nbr, self.per_atom_virial)
            e = e + out.energy
            f = f + out.force
            w = w + out.virial
        if self.average and len(self.potentials) > 1:
            inv = 1.0 / len(self.potentials)
            e, f, w = e * inv, f * inv, w * inv
        m = state.mask
        if self.hnemd_fe is not None:
            fe = torch.as_tensor(self.hnemd_fe, dtype=f.dtype, device=f.device)
            f = f + torch.einsum("nba,b->na", w, fe) * m[:, None]
            n_real = torch.clamp(torch.sum(m), min=1.0)
            f = (f - torch.sum(f, dim=0) / n_real) * m[:, None]
        elif self.hnemdec_mode is not None:
            fe = torch.as_tensor(self.hnemdec_fe, dtype=f.dtype,
                                 device=f.device)
            coef = torch.as_tensor(self.hnemdec_coef, dtype=f.dtype,
                                   device=f.device)
            typ = state.type.long()
            if self.hnemdec_mode == 0:
                # heat flow: S_i = E_i I + W_i; f += S^T Fe + per-type
                # terms (ref: force.cu:898-948)
                e_i = (0.5 * state.mass * torch.sum(state.velocity ** 2, -1)
                       + e)
                s = w + e_i[:, None, None] * torch.eye(3, dtype=f.dtype,
                                                       device=f.device)
                s = s * m[:, None, None]
                s_tot = torch.sum(s, dim=0)
                c1 = coef.reshape(-1, 2)[typ, 0]
                c2 = coef.reshape(-1, 2)[typ, 1]
                drive = (torch.einsum("nba,b->na", s, fe)
                         + c1[:, None] * (s_tot.T @ fe)[None, :]
                         + c2[:, None] * fe[None, :])
                f = f + drive * m[:, None]
            else:
                # colour flow: f_i += Fe coef[type_i] (ref: force.cu:750-769)
                f = f + coef[typ][:, None] * fe[None, :] * m[:, None]
        # per-atom heat current J_i = W_i . v_i (ref: compute_heat.cu:18-29)
        j = torch.einsum("nab,nb->na", w, state.velocity)
        return state._replace(force=f, potential_energy=e, virial=w,
                              heat_current=j)

    def _evaluate_with(self, state: MDState, pot) -> MDState:
        """ONE potential on a fresh neighbour list (the dump_observer's
        per-observer pass, ref: dump_observer.cu).  A potential whose
        cutoff lies beyond the plan's rc + skin gets a plan at its own
        cutoff, so no pair it sees is left out of its list."""
        _pin_fp32(state.position)
        pos = state.box.wrap(state.position)
        cfg = self.neighbor
        if pot.rc > cfg.rc:
            cfg = NeighborConfig.create(state.box, pot.rc,
                                        state.position.shape[0], cfg.mn)
        nbr = cfg.build(pos, state.box, state.mask)
        out = _dispatch(pot, state._replace(position=pos), nbr, True)
        j = torch.einsum("nab,nb->na", out.virial, state.velocity)
        return state._replace(position=pos, force=out.force,
                              potential_energy=out.energy,
                              virial=out.virial, heat_current=j)

    # ---- Verlet-skin cached path (the hot loop) --------------------------

    def refresh_cache(self, state: MDState) -> NeighborCache:
        """Full rebuild -> cache with integer image shifts relative to the
        raw (unwrapped) positions."""
        pos_raw = state.position
        nbr = self.neighbor.build(state.box.wrap(pos_raw), state.box,
                                  state.mask)
        # shift = r12 - (raw_j - raw_i), an exact lattice translation
        hin = state.box.h_inv.to(pos_raw.dtype)
        jdx = nbr.idx.long()
        sc = [nbr.r12[..., k] - (pos_raw[:, k][jdx] - pos_raw[:, k][:, None])
              for k in range(3)]
        shift_frac = torch.stack(
            [torch.round(hin[k, 0] * sc[0] + hin[k, 1] * sc[1]
                         + hin[k, 2] * sc[2]) for k in range(3)], dim=-1)
        shift_frac = torch.where(nbr.mask[..., None] > 0, shift_frac,
                                 torch.zeros_like(shift_frac)).to(torch.int8)
        return NeighborCache(idx=nbr.idx, shift_frac=shift_frac,
                             mask=nbr.mask, count=nbr.count,
                             ref_position=pos_raw,
                             rev=build_reverse_map(nbr, shift_frac),
                             peak=torch.max(nbr.count))

    def cache_r12(self, state: MDState, cache: NeighborCache) -> NeighborList:
        dtype = state.position.dtype
        h = state.box.h.to(dtype)
        pos = state.position
        jdx = cache.idx.long()
        valid = cache.mask > 0
        sf = [cache.shift_frac[..., k].to(dtype) for k in range(3)]
        comps = []
        for k in range(3):
            shift_k = sf[0] * h[k, 0] + sf[1] * h[k, 1] + sf[2] * h[k, 2]
            rk = pos[:, k][jdx] - pos[:, k][:, None] + shift_k
            comps.append(torch.where(valid, rk, torch.full_like(rk, _FAR)))
        return NeighborList(idx=cache.idx, r12=torch.stack(comps, dim=-1),
                            mask=cache.mask, count=cache.count,
                            rev=cache.rev)

    def compute_cached(self, state: MDState, cache: NeighborCache):
        """Force pass with Verlet-list reuse: rebuild only when some atom
        moved more than skin/2 (minimum image) since the cache was
        built."""
        if self.skin <= 0.0:
            return self.compute(state), cache
        disp = state.box.minimum_image(state.position - cache.ref_position)
        need = (torch.max(torch.sum(disp * disp, dim=-1))
                > (0.5 * self.skin) ** 2)
        if bool(need):  # the step's host sync
            fresh = self.refresh_cache(state)
            cache = fresh._replace(peak=torch.maximum(cache.peak, fresh.peak))
        return self._evaluate(state, self.cache_r12(state, cache)), cache


def hnemdec_coefficients(mode: int, masses, types, num_types: int):
    """Host-side HNEMDEC coefficient table (ref: force.cu:355-422
    set_hnemdec_parameters).

    mode 0 (heat flow): per type [c1, c2 / kBT], c_hv = (M_tot - N m_t) /
    M_tot, c1 = (c_hv - 1)/N, c2 = kB T c_hv (kB T applied by the caller).
    mode k > 0 (colour flow on species k-1): coef[k-1] = N/N_el,
    coef[other] = -N m_other / sum_other(m N).
    Returns (coef, mass_type, factor), factor the Onsager normalisation
    (ref: hnemdec_kappa.cu:70-82)."""
    masses = np.asarray(masses, dtype=float)
    types = np.asarray(types)
    n = len(masses)
    mass_type = np.zeros(num_types)
    type_size = np.zeros(num_types, dtype=int)
    for t in range(num_types):
        sel = types == t
        type_size[t] = sel.sum()
        if type_size[t]:
            mass_type[t] = masses[sel][0]
    total_mass = float(masses.sum())
    if mode == 0:
        coef = np.zeros(num_types * 2)
        for t in range(num_types):
            c_hv = (total_mass - n * mass_type[t]) / total_mass
            coef[2 * t] = (c_hv - 1.0) / n
            coef[2 * t + 1] = c_hv  # x kB T by the caller
        factor = 1.0
    else:
        el = mode - 1
        coef = np.zeros(num_types)
        coef[el] = float(n) / max(type_size[el], 1)
        partial_mass = sum(mass_type[t] * type_size[t]
                           for t in range(num_types) if t != el)
        for t in range(num_types):
            if t != el:
                coef[t] = -n * mass_type[t] / max(partial_mass, 1e-30)
        factor = 1.0 / (n * (1.0 / max(partial_mass, 1e-30)
                             + 1.0 / max(type_size[el] * mass_type[el],
                                         1e-30)))
    return tuple(coef), tuple(mass_type), factor
