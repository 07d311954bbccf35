"""NEP MD loop on the dense cell-grid state (the throughput path).

Counterpart of gpumd_tpu/engine/dense_md.py.  engine="compact" runs the
compact engine on both rungs: compact candidate lists (the default, as in
the JAX package) and full windows (compact_lists=False).  engine="v2" runs
the round-2 dense window engine (engine/nep_dense.py), kept for models the
compact engine rejects; "auto" picks compact when it takes the model.
State lives permuted (sorted by cell) between rebins; `orig_id` rides
along so results map back to input order.  A rebin (re-sort, plus the
neighbour-index rebuild on the compact engine) runs when the
barostat-safe Verlet criterion trips.  The JAX package chose between rebin
and keep with lax.cond inside one scan; here the choice is a Python branch
on a device bool, which costs one host sync per step.  The sticky
`overflow` flag stays on the device and is read by the caller once per
block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

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
    CompactNeighbors,
    CompactSpec,
    block_centers,
    build_compact_neighbors,
    build_indices,
    compact_nep_compute,
    make_compact_plan,
    plan_grid_compact,
)
from gpumd_tpu_torch.engine.nep_dense import DenseNepSpec, dense_nep_compute_v2
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.potentials.nep.model import NEP


class DenseCarry(NamedTuple):
    state: MDState  # slot-ordered, n_slots rows
    orig_id: torch.Tensor  # (n_slots,) input-order index (n for empty)
    ref_frac: torch.Tensor  # (n_slots, 3) fractional positions at last rebin
    ref_thick: torch.Tensor  # (3,) box thicknesses at last rebin
    overflow: torch.Tensor  # sticky bool: cap/MN overflow (results invalid)
    # neighbour index tiles, or the compact lists' rebuild products
    idx: Union[torch.Tensor, CompactNeighbors, None] = None


class DenseNEPMD:
    """NEP MD on the dense grid.  Build once per (box shape, N).

    `plain=True` runs every kernel's plain version instead of the CUDA
    kernel (a reference run on the card)."""

    # the force path; subclasses that set none (CompactTersoffMD) run the
    # compact one
    engine = "compact"
    _hnemd_fe: Optional[Tuple[float, float, float]] = None
    _fe_t: Optional[torch.Tensor] = None  # hnemd_fe on the force's device

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
        compact_lists: bool = True,
        plain: bool = False,
    ):
        if engine not in ("auto", "compact", "v2"):
            raise ValueError(f"unknown engine {engine!r}")
        self.nep = nep
        # subtract the mean net force each step: restores exact global
        # Newton III against the f32 rounding of the two pair halves
        self.zero_net_force = zero_net_force
        if engine in ("auto", "compact") and cap is None:
            self.plan = plan_grid_compact(box, nep.model.rc_radial_max, skin,
                                          n_atoms, position=position)
        else:
            self.plan = plan_grid(box, nep.model.rc_radial_max, skin,
                                  n_atoms, position=position, cap=cap)
        if self.plan is None:
            raise ValueError("box too thin for the dense engine (needs >= 3 "
                             "cells of rc+skin per periodic direction)")
        self.skin = skin
        self.plain = plain
        if engine == "auto":
            # compact when the model qualifies, else the round-2 engine
            try:
                CompactSpec.from_model(nep.model, nep.params)
                engine = "compact"
            except NotImplementedError:
                engine = "v2"
        self.engine = engine
        self.per_atom_virial = per_atom_virial and engine == "compact"
        if engine == "v2":
            self.spec = DenseNepSpec.from_model(nep.model)
            self.cplan = None
            return
        self.spec = CompactSpec.from_model(nep.model, nep.params)
        self.cplan = make_compact_plan(
            self.plan, position=position, box=box,
            rc_angular=nep.model.rc_angular_max, mn_r=mn_r, mn_a=mn_a,
            compact_lists=compact_lists)

    @property
    def hnemd_fe(self) -> Optional[Tuple[float, float, float]]:
        """The HNEMD driving force Fe (1/A), None when off.  `compute` then
        adds W_i^T Fe to each force before removing the net force (ref:
        src/force/force.cu:567-608).  It needs per-atom virials: the
        compact engine with per_atom_virial=True."""
        return self._hnemd_fe

    @hnemd_fe.setter
    def hnemd_fe(self, value):
        if value is not None:
            if self.engine != "compact":
                raise ValueError(
                    f"HNEMD needs per-atom virials, which engine="
                    f"{self.engine!r} does not compute: use "
                    f"engine=\"compact\"")
            if not self.per_atom_virial:
                raise ValueError("HNEMD needs per_atom_virial=True")
            value = tuple(float(x) for x in value)
        self._hnemd_fe, self._fe_t = value, None

    # ---- state management ------------------------------------------------

    def _build_idx(self, sstate: MDState):
        garr = pack_ghost(sstate.position, sstate.type, sstate.mask,
                          sstate.box, self.plan)
        if self.cplan.cl:
            return build_compact_neighbors(garr, sstate.box, self.cplan,
                                           self.nep.model.rc_angular_max,
                                           plain=self.plain)
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
        idx = None
        if self.engine == "compact":
            idx, ok = self._build_idx(sstate)
            overflow = overflow | ~ok
        overflow = overflow | ~self._cells_valid(sstate.box)
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

    def _force_pass(self, state: MDState, idx):
        """Energy, force and virials of slot state (the potential's
        part of `compute`)."""
        return compact_nep_compute(
            state.position, state.type, state.mask, state.box, self.cplan,
            idx, self.nep.model, self.nep.params,
            per_atom_virial=self.per_atom_virial,
            temperature=self.nep.temperature, spec=self.spec,
            plain=self.plain)

    def compute(self, state: MDState, idx=None) -> MDState:
        if self.engine == "v2":
            return self._compute_v2(state)
        out = self._force_pass(state, idx)
        f = out.force
        n_real = torch.clamp(torch.sum(state.mask), min=1.0)
        if out.virial_atom is not None:
            w = out.virial_atom
        else:
            w = (out.virial_total / n_real) * state.mask[:, None, None]
        if self.zero_net_force and self._hnemd_fe is None:
            f = (f - torch.sum(f, dim=0) / n_real) * state.mask[:, None]
        if self._hnemd_fe is not None:
            # F_i += W_i^T Fe, then the net force goes (ref: force.cu:567-608)
            fe = self._fe_t
            if fe is None or fe.dtype != f.dtype or fe.device != f.device:
                fe = self._fe_t = torch.as_tensor(self._hnemd_fe,
                                                  dtype=f.dtype,
                                                  device=f.device)
            drive = torch.sum(w * fe[None, :, None], dim=1)
            f = f + drive * state.mask[:, None]
            f = (f - torch.sum(f, dim=0) / n_real) * state.mask[:, None]
        # J_i = W_i v_i
        j = torch.sum(w * state.velocity[:, None, :], dim=2)
        return state._replace(force=f,
                              potential_energy=out.energy * state.mask,
                              virial=w, heat_current=j)

    def _compute_v2(self, state: MDState) -> MDState:
        out = dense_nep_compute_v2(
            state.position, state.type, state.mask, state.box, self.plan,
            self.nep.model, self.nep.params, plain=self.plain)
        # the total virial spread uniformly over the real atoms: pressure
        # and thermo are exact; per-atom observables need engine="compact"
        n_real = torch.clamp(torch.sum(state.mask), min=1.0)
        w = (out.virial_total / n_real) * state.mask[:, None, None]
        f = out.force
        if self.zero_net_force:
            f = (f - torch.sum(f, dim=0) / n_real) * state.mask[:, None]
        return state._replace(force=f,
                              potential_energy=out.energy * state.mask,
                              virial=w)

    # ---- MD step ---------------------------------------------------------

    def make_step(self, ensemble, dt, observer=None, measure=None):
        """Returns step(carry, aux) -> (carry, aux) without hooks.

        With hooks, step(carry, aux, maccs=None) -> (carry, aux, maccs, ys):
        `observer(state)` -> a tensor of the step (ys, None without one;
        the HNEMD heat current), `measure(maccs, state, orig_id)` -> the
        measurement accumulators (maccs, passed through without one; SHC's
        ring buffers).  Both run after step2, the reference's
        measure-after-integrate order (run.cu:295-299), and neither reads
        anything back: stack a block's ys on the card.

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
                idx = None
                if self.engine == "compact":
                    idx, ok = self._build_idx(state)
                    ov = ov | ~ok
                ov = ov | ~self._cells_valid(state.box)
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

        if observer is None and measure is None:
            return step

        def step_hooked(c: DenseCarry, aux, maccs=None):
            c, aux = step(c, aux)
            ys = observer(c.state) if observer is not None else None
            if measure is not None:
                maccs = measure(maccs, c.state, c.orig_id)
            return c, aux, maccs, ys

        return step_hooked

    def run(self, state: MDState, ensemble, dt, n_steps: int,
            observer=None, measure=None, maccs=None):
        """One block from input-order state; returns (carry, aux), or with
        hooks (carry, aux, maccs, ys): ys the observer's tensors stacked
        over the steps (None without an observer)."""
        with torch.no_grad():
            carry = self.init_carry(state)
            carry = carry._replace(state=self.compute(carry.state,
                                                      carry.idx))
            aux = ensemble.init(carry.state)
            step = self.make_step(ensemble, dt, observer, measure)
            if observer is None and measure is None:
                for _ in range(n_steps):
                    carry, aux = step(carry, aux)
                return carry, aux
            ys = []
            for _ in range(n_steps):
                carry, aux, maccs, y = step(carry, aux, maccs)
                ys.append(y)
        return (carry, aux, maccs,
                torch.stack(ys) if observer is not None and ys else None)

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
