"""MSST: the multi-scale shock technique (Reed et al., PRL 90, 235503).

Counterpart of gpumd_tpu/integrate/ensembles/msst.py (ref: src/integrate/
ensemble_msst.cu:1-362).  The cell length along the shock direction is a
dynamical variable with inertia `qmass`, damped by `mu` and driven by the
Rayleigh-line imbalance; the particle velocities get a drag coupled to
the volume motion.  run.in:

  ensemble msst x|y|z <vs_km_s> [qmass q] [mu m] [tscale f] [p0 P]
                [v0 V] [e0 E]

The reference quantities (v0, e0, p0) default to the initial state's.
The volume rate omega and the Lagrangian are host floats (float64): each
half step reads the stress along the shock and the cell in one copy (two
reads a step).  The velocity update, with the reference's two-pass
velocity-sum predictor, and the cell's dilation run on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gpumd_tpu_torch.integrate.ensembles.mttk import volume_host
from gpumd_tpu_torch.integrate.verlet import velocity_verlet_step1
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import (
    K_B,
    PRESSURE_UNIT_CONVERSION,
    TIME_UNIT_CONVERSION,
)


@dataclass(frozen=True)
class MSST:
    shock_direction: int = 0  # 0=x, 1=y, 2=z
    vs: float = 0.0  # km/s as parsed
    qmass: float = 1.0e4
    mu: float = 0.0
    tscale: float = 0.0
    p0: Optional[float] = None  # GPa as parsed
    v0: Optional[float] = None
    e0: Optional[float] = None
    n_steps: int = 0
    mobile: Optional[object] = None

    @property
    def _vs_nat(self):
        # km/s = 0.01 A/fs; natural time = fs * TIME_UNIT_CONVERSION
        return self.vs * 0.01 * TIME_UNIT_CONVERSION

    def _read(self, state: MDState):
        """(kinetic energy, potential energy, the stress along the shock,
        the volume, the mass): one read."""
        m = state.mass * state.mask
        d = self.shock_direction
        v = state.velocity
        vals = torch.cat([torch.stack([
            0.5 * torch.sum(m * torch.sum(v ** 2, dim=-1)),
            torch.sum(state.potential_energy * state.mask),
            torch.sum(m * v[:, d] * v[:, d]),
            torch.sum(state.virial[:, d, d] * state.mask),
            torch.sum(m)]), state.box.h.to(v.dtype).reshape(-1)]).tolist()
        ke, pe, kin, w, mass = vals[:5]
        vol = volume_host(np.reshape(vals[5:], (3, 3)))
        return ke, pe, (kin + w) / vol, vol, mass

    def init(self, state: MDState):
        ke, pe, p_cur, vol, total_mass = self._read(state)
        return {"omega": -math.sqrt(self.tscale * total_mass / self.qmass
                                    * ke),
                "v0": self.v0 if self.v0 is not None else vol,
                "e0": self.e0 if self.e0 is not None else ke + pe,
                "p0": (self.p0 / PRESSURE_UNIT_CONVERSION
                       if self.p0 is not None else p_cur),
                "total_mass": total_mass, "tscale_applied": False,
                "lagrangian": 0.0}

    def _get_omega(self, p_cur: float, vol: float, aux, dthalf):
        """omega's half step at fixed volume (ref: get_omega)."""
        m_tot, v0 = aux["total_mass"], aux["v0"]
        p_msst = self._vs_nat ** 2 * m_tot * (v0 - vol) / (v0 * v0)
        a = m_tot * (p_cur - aux["p0"] - p_msst) / self.qmass
        b = m_tot * self.mu / (self.qmass * vol)
        if vol > v0 and a > 0.0:
            a = -a
        om = aux["omega"]
        if b * dthalf > 1.0e-6:
            om = (om + a * (math.exp(b * dthalf) - 1.0) / b) * math.exp(
                -b * dthalf)
        else:
            om = om + (a - b * om) * dthalf + 0.5 * (
                b * b * om - a * b) * dthalf * dthalf
        return {**aux, "omega": om}

    def _msst_v(self, state: MDState, om: float, dthalf, vsum) -> MDState:
        """The half step's velocities with the volume-coupled drag
        (ref: gpu_msst_v), on the card."""
        vol = state.box.volume.to(state.velocity.dtype)
        c = state.force / state.mass[:, None]
        tmp = om * om * self.mu / (vsum * state.mass * vol)
        d = torch.stack([tmp, tmp, tmp], dim=-1)
        d[:, self.shock_direction] += -2.0 * om / vol
        v = state.velocity
        big = torch.abs(dthalf * d) > 1.0e-6
        dn = torch.where(big, d, torch.ones_like(d))
        expd = torch.exp(dn * dthalf)
        exact = expd * (c + dn * v - c / expd) / dn
        taylor = v + (c + d * v) * dthalf + 0.5 * (
            d * d * v + c * d) * dthalf * dthalf
        v = torch.where(big, exact, taylor) * state.mask[:, None]
        if self.mobile is not None:
            v = torch.where(self.mobile[:, None] > 0, v, state.velocity)
        return state._replace(velocity=v)

    @staticmethod
    def _vsum(state: MDState):
        return torch.clamp(torch.sum(torch.sum(state.velocity ** 2, dim=-1)
                                     * state.mask), min=1e-30)

    def _remap(self, state: MDState, dilation: float) -> MDState:
        d = self.shock_direction
        h = state.box.h.clone()
        h[d, d] = h[d, d] * dilation
        scale = [1.0, 1.0, 1.0]
        scale[d] = dilation

        def col(x):
            return torch.stack([x[:, k] * scale[k] if k == d else x[:, k]
                                for k in range(3)], dim=-1)

        up = state.unwrapped_position
        return state._replace(
            position=col(state.position), velocity=col(state.velocity),
            box=state.box.with_h(h),
            unwrapped_position=col(up) if up is not None else None)

    def step1(self, state: MDState, aux, dt):
        dthalf = 0.5 * dt
        if not aux["tscale_applied"]:  # one velocity rescale at step 0
            state = state._replace(
                velocity=state.velocity * math.sqrt(1.0 - self.tscale))
            aux = {**aux, "tscale_applied": True}
        _, _, p_cur, vol, _ = self._read(state)
        aux = self._get_omega(p_cur, vol, aux, dthalf)
        om = aux["omega"]
        # the velocity-sum predictor: advance once for vsum, then redo
        probe = self._msst_v(state, om, dthalf, self._vsum(state))
        state = self._msst_v(state, om, dthalf, self._vsum(probe))
        vol1 = vol + om * dthalf
        state = self._remap(state, vol1 / vol)
        state = velocity_verlet_step1(state, dt, self.mobile, kick=False)
        vol2 = vol1 + om * dthalf
        return self._remap(state, vol2 / vol1), aux

    def step2(self, state: MDState, aux, dt):
        dthalf = 0.5 * dt
        state = self._msst_v(state, aux["omega"], dthalf, self._vsum(state))
        _, _, p_cur, vol, _ = self._read(state)
        aux = self._get_omega(p_cur, vol, aux, dthalf)
        lag = aux["lagrangian"] - self._vs_nat * vol / aux["v0"] * dt
        step = state.step + 1 if state.step is not None else None
        return state._replace(step=step), {**aux, "lagrangian": lag}

    def conserved(self, state: MDState, aux):
        """(e_conserved per atom, dHugoniot in K, dRayleigh in GPa)
        (ref: get_conserved); one read."""
        ke, pe, p_cur, vol, _ = self._read(state)
        etotal = ke + pe
        m_tot, v0 = aux["total_mass"], aux["v0"]
        vs2 = self._vs_nat ** 2
        n = max(float(state.mask.sum()), 1.0)
        e_msst = (0.5 * self.qmass * aux["omega"] ** 2 / m_tot
                  - 0.5 * m_tot * vs2 * (1.0 - vol / v0) ** 2
                  - aux["p0"] * (v0 - vol))
        dhugo = (0.5 * (p_cur + aux["p0"]) * (v0 - vol) + aux["e0"]
                 - etotal) / (3.0 * n * K_B)
        dray = (p_cur - aux["p0"] - m_tot * vs2 * (1.0 - vol / v0) / v0
                ) * PRESSURE_UNIT_CONVERSION
        return (etotal + e_msst) / n, dhugo, dray
