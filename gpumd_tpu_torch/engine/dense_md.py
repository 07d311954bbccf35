"""NEP MD loop on the dense cell-grid state (the throughput path).

Counterpart of gpumd_tpu/engine/dense_md.py, engine="compact" with
compact_lists=False.  State lives permuted (sorted by cell) between rebins;
`orig_id` rides along so results map back to input order.  A rebin (re-sort
plus neighbour-index rebuild) runs when the barostat-safe Verlet criterion
trips.  The JAX package chose between rebin and keep with lax.cond inside
one scan; here the choice is a Python branch on a device bool, which costs
one host sync per step.  The sticky `overflow` flag stays on the device and
is read by the caller once per block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.engine.grid import (
    apply_perm,
    bin_dense,
    pack_block_windows,
    pack_ghost,
    plan_grid,
)
from gpumd_tpu_torch.engine.nep_compact import (
    CompactSpec,
    block_centers,
    build_indices,
    compact_nep_compute,
    make_compact_plan,
    plan_grid_compact,
)
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.potentials.nep.model import NEP


class DenseCarry(NamedTuple):
    state: MDState  # slot-ordered, n_slots rows
    orig_id: torch.Tensor  # (n_slots,) input-order index (n for empty)
    ref_frac: torch.Tensor  # (n_slots, 3) fractional positions at last rebin
    ref_thick: torch.Tensor  # (3,) box thicknesses at last rebin
    overflow: torch.Tensor  # sticky bool: cap/MN overflow (results invalid)
    idx: Optional[torch.Tensor] = None  # neighbour index tiles


class DenseNEPMD:
    """NEP MD on the dense grid.  Build once per (box shape, N).

    `plain=True` runs every kernel's plain version instead of the CUDA
    kernel (a reference run on the card)."""

    def __init__(
        self,
        nep: NEP,
        box: Box,
        n_atoms: int,
        position: Optional[np.ndarray] = None,
        skin: float = 1.0,
        cap: Optional[int] = None,
        engine: str = "auto",
        per_atom_virial: bool = False,
        mn_r: Optional[int] = None,
        mn_a: Optional[int] = None,
        zero_net_force: bool = True,
        compact_lists: bool = False,
        plain: bool = False,
    ):
        if engine == "v2":
            raise NotImplementedError(
                "engine='v2' (round-2 dense window kernels k1b/k2b) is not "
                "ported yet: ROADMAP queue 2, items 8-9")
        if engine not in ("auto", "compact"):
            raise ValueError(f"unknown engine {engine!r}")
        self.nep = nep
        # subtract the mean net force each step: restores exact global
        # Newton III against the f32 rounding of the two pair halves
        self.zero_net_force = zero_net_force
        self.spec = CompactSpec.from_model(nep.model, nep.params)
        if cap is None:
            self.plan = plan_grid_compact(box, nep.model.rc_radial_max, skin,
                                          n_atoms, position=position)
        else:
            self.plan = plan_grid(box, nep.model.rc_radial_max, skin,
                                  n_atoms, position=position, cap=cap)
        if self.plan is None:
            raise ValueError("box too thin for the dense engine (needs >= 3 "
                             "cells of rc+skin per periodic direction)")
        self.skin = skin
        self.per_atom_virial = per_atom_virial
        self.plain = plain
        self.cplan = make_compact_plan(
            self.plan, position=position, box=box,
            rc_angular=nep.model.rc_angular_max, mn_r=mn_r, mn_a=mn_a,
            compact_lists=compact_lists)

    # ---- state management ------------------------------------------------

    def _build_idx(self, sstate: MDState):
        garr = pack_ghost(sstate.position, sstate.type, sstate.mask,
                          sstate.box, self.plan)
        centers = block_centers(garr, self.cplan)
        cand = pack_block_windows(garr, self.plan, self.cplan.bx,
                                  self.cplan.wl)
        return build_indices(centers, cand, self.cplan,
                             self.nep.model.rc_angular_max)

    def init_carry(self, state: MDState) -> DenseCarry:
        """Input-order MDState (N rows) -> slot-ordered carry."""
        n = state.position.shape[0]
        sstate, orig_id, overflow = self._rebin_arrays(
            state, torch.arange(n, device=state.position.device), state.box)
        idx, ok = self._build_idx(sstate)
        overflow = overflow | ~ok | ~self._cells_valid(sstate.box)
        return DenseCarry(state=sstate, orig_id=orig_id,
                          ref_frac=sstate.box.fractional(sstate.position),
                          ref_thick=sstate.box.thickness(),
                          overflow=overflow, idx=idx)

    def _cells_valid(self, box: Box):
        """Cells must be >= rc+skin thick at build time (single-cell
        non-periodic axes are exempt)."""
        t = box.thickness()
        grid = torch.as_tensor(self.plan.grid, dtype=t.dtype, device=t.device)
        exempt = torch.as_tensor(
            [(not p) and g == 1 for p, g in zip(self.plan.pbc,
                                                self.plan.grid)],
            device=t.device)
        ratio = torch.where(exempt, torch.full_like(t, float("inf")),
                            t / grid)
        return torch.min(ratio) >= self.plan.rc + self.plan.skin - 1e-9

    def _rebin_arrays(self, state: MDState, orig_id, box: Box):
        pos_w = box.wrap(state.position)
        perm, slot_mask, overflow = bin_dense(pos_w, box, state.mask,
                                              self.plan)

        def g(a, fill=0.0):
            return None if a is None else apply_perm(a, perm, fill)

        sstate = state._replace(
            position=g(pos_w), velocity=g(state.velocity),
            force=g(state.force), mass=g(state.mass, 1.0),
            type=g(state.type.to(torch.int32), 0),
            potential_energy=g(state.potential_energy),
            virial=g(state.virial), heat_current=g(state.heat_current),
            mask=slot_mask,
            unwrapped_position=g(state.unwrapped_position),
            # the low parts stay valid: the wrap moves the high part by one
            # lattice vector, consistent with MIC to one ulp
            position_c=g(state.position_c), velocity_c=g(state.velocity_c),
        )
        new_id = apply_perm(orig_id, perm, fill=0)
        new_id = torch.where(slot_mask > 0, new_id,
                             torch.full_like(new_id, orig_id.shape[0]))
        return sstate, new_id, overflow

    # ---- force pass ------------------------------------------------------

    def compute(self, state: MDState, idx) -> MDState:
        out = compact_nep_compute(
            state.position, state.type, state.mask, state.box, self.cplan,
            idx, self.nep.model, self.nep.params,
            per_atom_virial=self.per_atom_virial,
            temperature=self.nep.temperature, spec=self.spec,
            plain=self.plain)
        f = out.force
        n_real = torch.clamp(torch.sum(state.mask), min=1.0)
        if out.virial_atom is not None:
            w = out.virial_atom
        else:
            w = (out.virial_total / n_real) * state.mask[:, None, None]
        if self.zero_net_force:
            f = (f - torch.sum(f, dim=0) / n_real) * state.mask[:, None]
        # J_i = W_i v_i
        j = torch.sum(w * state.velocity[:, None, :], dim=2)
        return state._replace(force=f,
                              potential_energy=out.energy * state.mask,
                              virial=w, heat_current=j)

    # ---- MD step ---------------------------------------------------------

    def make_step(self, ensemble, dt):
        """Returns step(carry, aux) -> (carry, aux).

        Rebuild criterion (barostat-safe): the list built at the last rebin
        stays complete while 2*u_max <= smin*rc_out - rc, with u_i the
        non-affine displacement since the rebin and smin the smallest axis
        scale since then; with a fixed box this is the skin/2 criterion."""
        rc = self.plan.rc
        rc_out = rc + self.skin

        def step(c: DenseCarry, aux):
            state, aux = ensemble.step1(c.state, aux, dt)
            smin = torch.min(state.box.thickness() / c.ref_thick)
            ref_cart = state.box.cartesian(c.ref_frac)
            disp = state.box.minimum_image(state.position - ref_cart)
            thresh = torch.clamp(0.5 * (smin * rc_out - rc), min=0.0)
            need = (torch.max(torch.sum(disp * disp, dim=-1) * state.mask)
                    > thresh * thresh)
            if bool(need):  # the one host sync of the step
                state, orig_id, ov = self._rebin_arrays(state, c.orig_id,
                                                        state.box)
                idx, ok = self._build_idx(state)
                ov = ov | ~ok | ~self._cells_valid(state.box)
                reff = state.box.fractional(state.position)
                reft = state.box.thickness()
            else:
                orig_id, reff, reft, idx = (c.orig_id, c.ref_frac,
                                            c.ref_thick, c.idx)
                ov = torch.zeros_like(c.overflow)
            state = self.compute(state, idx)
            state, aux = ensemble.step2(state, aux, dt)
            return DenseCarry(state=state, orig_id=orig_id, ref_frac=reff,
                              ref_thick=reft, overflow=c.overflow | ov,
                              idx=idx), aux

        return step

    def run(self, state: MDState, ensemble, dt, n_steps: int):
        """One block from input-order state; returns (carry, aux)."""
        with torch.no_grad():
            carry = self.init_carry(state)
            carry = carry._replace(state=self.compute(carry.state,
                                                      carry.idx))
            aux = ensemble.init(carry.state)
            step = self.make_step(ensemble, dt)
            for _ in range(n_steps):
                carry, aux = step(carry, aux)
        return carry, aux

    def to_input_order(self, carry: DenseCarry, n: int) -> MDState:
        """Slot state -> input atom order."""
        s = carry.state
        oid = carry.orig_id
        valid = oid < n
        inv = torch.zeros(n, dtype=torch.int64, device=oid.device)
        inv[oid[valid]] = torch.nonzero(valid)[:, 0]

        def take(a):
            return None if a is None else a[inv]

        return s._replace(
            position=take(s.position), velocity=take(s.velocity),
            force=take(s.force), mass=take(s.mass), type=take(s.type),
            potential_energy=take(s.potential_energy),
            virial=take(s.virial), heat_current=take(s.heat_current),
            mask=take(s.mask),
            unwrapped_position=take(s.unwrapped_position),
            position_c=take(s.position_c), velocity_c=take(s.velocity_c))
