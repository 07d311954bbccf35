"""Shock-wall ensembles (ref: src/integrate/ensemble_wall_{piston,mirror,
harmonic}.cu): NVE with wall rules along x.

Counterpart of gpumd_tpu/integrate/ensembles/walls.py.

  wall_piston:   atoms with x < thickness at init move rigidly at vx = vp
                 (the piston); atoms with x > Lx - thickness are frozen
  wall_mirror:   a frozen right wall; a specular mirror starting at x = 0
                 advances at vp, and atoms crossing it reflect in the
                 moving frame (x -> 2 p - x, vx -> 2 vp - vx)
  wall_harmonic: a frozen right wall; a harmonic wall at x = vp t pushes
                 the atoms left of it with f_x += k (x_wall - x); a hard
                 floor at x = 0 reflects

Wall membership is fixed at `init` from the initial positions (the
reference's gpu_find_wall).  Everything runs on the card; the wall's
position is a host float: no read a step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gpumd_tpu_torch.model.state import MDState


def _half_kick(state: MDState, dt, frozen, piston=None,
               vp: float = 0.0) -> MDState:
    a = state.force / state.mass[:, None]
    v = state.velocity + 0.5 * dt * a
    v = torch.where(frozen[:, None] > 0, torch.zeros_like(v), v)
    if piston is not None:
        vpvec = torch.zeros_like(v)
        vpvec[:, 0] = vp
        v = torch.where(piston[:, None] > 0, vpvec, v)
    return state._replace(velocity=v * state.mask[:, None])


def _drift(state: MDState, dt) -> MDState:
    return state._replace(position=state.position + dt * state.velocity
                          * state.mask[:, None])


def _with_x(state: MDState, x, vx) -> MDState:
    """The state with new x positions and x velocities."""
    pos, vel = state.position.clone(), state.velocity.clone()
    pos[:, 0], vel[:, 0] = x, vx
    return state._replace(position=pos, velocity=vel)


def _right_wall(state: MDState, thickness: float):
    x = state.position[:, 0]
    return (x > state.box.h[0, 0] - thickness).to(x.dtype) * state.mask


@dataclass(frozen=True)
class WallPiston:
    """ensemble wall_piston vp v thickness d; vp in natural units (the
    parser converts km/s)."""

    vp: float = 0.0
    thickness: float = 20.0

    def init(self, state: MDState):
        x = state.position[:, 0]
        return {"piston": (x < self.thickness).to(x.dtype) * state.mask,
                "frozen": _right_wall(state, self.thickness), "i": 0}

    def step1(self, state: MDState, aux, dt):
        state = _half_kick(state, dt, aux["frozen"], aux["piston"], self.vp)
        return _drift(state, dt), aux

    def step2(self, state: MDState, aux, dt):
        state = _half_kick(state, dt, aux["frozen"], aux["piston"], self.vp)
        return state, {**aux, "i": aux["i"] + 1}


@dataclass(frozen=True)
class WallMirror:
    """ensemble wall_mirror vp v [thickness d]."""

    vp: float = 0.0
    thickness: float = 20.0

    def init(self, state: MDState):
        return {"frozen": _right_wall(state, self.thickness), "pos": 0.0,
                "i": 0}

    def _reflect(self, state: MDState, p: float) -> MDState:
        x, vx = state.position[:, 0], state.velocity[:, 0]
        hit = x < p
        return _with_x(state, torch.where(hit, 2.0 * p - x, x),
                       torch.where(hit, 2.0 * self.vp - vx, vx))

    def step1(self, state: MDState, aux, dt):
        state = _drift(_half_kick(state, dt, aux["frozen"]), dt)
        return self._reflect(state, aux["pos"]), aux

    def step2(self, state: MDState, aux, dt):
        p = aux["pos"] + dt * self.vp
        state = self._reflect(_half_kick(state, dt, aux["frozen"]), p)
        return state, {**aux, "pos": p, "i": aux["i"] + 1}


@dataclass(frozen=True)
class WallHarmonic:
    """ensemble wall_harmonic vp v k kk [thickness d]."""

    vp: float = 0.0
    k: float = 5.0  # eV/A^2
    thickness: float = 20.0

    def init(self, state: MDState):
        return {"frozen": _right_wall(state, self.thickness), "pos": 0.0,
                "i": 0}

    def _wall_force(self, state: MDState, p: float) -> MDState:
        x = state.position[:, 0]
        push = (x < p).to(x.dtype) * state.mask
        f = state.force.clone()
        f[:, 0] = f[:, 0] + push * self.k * (p - x)
        return state._replace(force=f)

    @staticmethod
    def _floor(state: MDState) -> MDState:
        x, vx = state.position[:, 0], state.velocity[:, 0]
        hit = x < 0.0
        return _with_x(state, torch.where(hit, -x, x),
                       torch.where(hit, -vx, vx))

    def step1(self, state: MDState, aux, dt):
        state = self._wall_force(state, aux["pos"])
        state = _drift(_half_kick(state, dt, aux["frozen"]), dt)
        return self._floor(state), aux

    def step2(self, state: MDState, aux, dt):
        p = aux["pos"] + dt * self.vp
        state = _half_kick(self._wall_force(state, p), dt, aux["frozen"])
        return self._floor(state), {**aux, "pos": p, "i": aux["i"] + 1}
