"""NPT ensembles: Berendsen weak coupling and stochastic cell rescaling.

Counterpart of gpumd_tpu/integrate/ensembles/npt.py.  run.in convention
(ref: src/integrate/integrate.cu:614-700):
  ensemble npt_ber T1 T2 Tc  p_iso           C  tau_p          (isotropic)
  ensemble npt_ber T1 T2 Tc  px py pz  Cx Cy Cz  tau_p         (orthogonal)
Pressures and elastic moduli C in GPa; the coupling applied per step is
  p_coupling = 1 / (tau_p * 3 * C)         [GPa^-1]
  scale_k    = 1 - p_coupling * (p0_k - p_k)
with positions and box scaled together (ref: ensemble_ber.cu:95-150).
Moduli > 2000 GPa disable that direction (reference behaviour).

The instantaneous pressure (kinetic plus virial tensor over the volume) is
reduced on the card in the state's dtype, and the box and positions are
rescaled there: a step reads nothing back.  Constant vectors go to the
card once, at `init`; NPTSCR's noise (BDP's two draws and its own xi) is
drawn on the host as NVTBDP's is and written into a device vector element
by element, since a copy from host memory would wait for the card.  As in
the JAX package, a compensated state's `position_c` is left as it is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.integrate.ensembles.nvt import (
    _ndof,
    _RampMixin,
    bdp_scale,
)
from gpumd_tpu_torch.integrate.verlet import (
    velocity_verlet_step1,
    velocity_verlet_step2,
)
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import K_B, PRESSURE_UNIT_CONVERSION


def _vec3(values, like: torch.Tensor) -> torch.Tensor:
    """Host floats (three here; MTTK's cell writes nine) as a vector in
    `like`'s dtype on its device, each written in place (no host-to-device
    copy, so no wait for the card)."""
    values = [float(x) for x in values]
    v = torch.empty(len(values), dtype=like.dtype, device=like.device)
    for k, x in enumerate(values):
        v[k] = x
    return v


@dataclass(frozen=True)
class _Barostat(_RampMixin):
    target_pressure: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # GPa
    elastic_modulus: Tuple[float, float, float] = (50.0, 50.0, 50.0)  # GPa
    tau_p: float = 1000.0
    isotropic: bool = False

    def _p_coupling(self):
        return tuple(0.0 if c > 2.0e3 else 1.0 / (self.tau_p * 3.0 * c)
                     for c in self.elastic_modulus)

    def _consts(self, state: MDState):
        return {"pc": _vec3(self._p_coupling(), state.velocity),
                "p0": _vec3(self.target_pressure, state.velocity)}

    def step1(self, state: MDState, aux, dt):
        return velocity_verlet_step1(state, dt, self.mobile), aux

    def _pressure(self, state: MDState):
        """The diagonal of the pressure tensor in GPa (its trace / 3 in
        each direction when isotropic), and the volume."""
        m = state.mask
        kin = torch.einsum("n,na,nb->ab", state.mass * m, state.velocity,
                           state.velocity)
        w = torch.einsum("nab,n->ab", state.virial, m)
        vol = state.box.volume
        p = (kin + w) / vol * PRESSURE_UNIT_CONVERSION
        if self.isotropic:
            return (torch.trace(p) / 3.0).expand(3), vol
        return torch.diagonal(p), vol

    @staticmethod
    def _rescale(state: MDState, scale) -> MDState:
        """Box columns (lattice vectors) and positions times scale_k."""
        unwrapped = (state.unwrapped_position * scale[None, :]
                     if state.unwrapped_position is not None else None)
        return state._replace(
            position=state.position * scale[None, :],
            box=state.box.with_h(state.box.h * scale[None, :]),
            unwrapped_position=unwrapped)


@dataclass(frozen=True)
class NPTBerendsen(_Barostat):
    """Berendsen NPT: NVT-Berendsen thermostat + per-direction box
    rescale."""

    def init(self, state: MDState):
        return {"i": 0, **self._consts(state)}

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile)
        # thermostat
        tf = torch.sqrt(1.0 + (self._temp(aux) / state.temperature() - 1.0)
                        / self.coupling)
        tf = torch.where(torch.isfinite(tf), tf, torch.ones_like(tf))
        state = state._replace(velocity=state.velocity * tf)
        # barostat
        diag, _ = self._pressure(state)
        scale = 1.0 - aux["pc"] * (aux["p0"] - diag)
        return self._rescale(state, scale), {**aux, "i": aux["i"] + 1}


@dataclass(frozen=True)
class NPTSCR(_Barostat):
    """NPT with stochastic cell rescaling (Bernetti-Bussi) + BDP velocity
    rescaling (ref: ensemble_npt_scr.cu:87-130, npt_utilities.cuh):
      scale_k = 1 - pc (p0 - p) + sqrt(2 pc kB T / V) xi
    with pc = 1/(tau_p 3 C) per direction (GPa convention as npt_ber).
    A step draws rr, the chi^2 term and then xi(3) from the generator, in
    the JAX package's order."""

    seed: int = 12345
    # as NVTBDP's: standard_normal(size) and gamma(shape)
    generator: Optional[object] = None

    def init(self, state: MDState):
        rng = (self.generator if self.generator is not None
               else np.random.default_rng(self.seed))
        sqrt_pc = [math.sqrt(c) for c in self._p_coupling()]
        return {"i": 0, "rng": rng, "ndeg": float(_ndof(state)),
                "sqrt_pc": sqrt_pc, **self._consts(state)}

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile)
        t0 = self._temp(aux)
        # BDP thermostat
        scale_v = bdp_scale(state, aux, t0, self.coupling)
        state = state._replace(velocity=state.velocity * scale_v)
        # SCR barostat: sqrt(2 pc kbt) xi = sqrt(2 kbt) (sqrt(pc) xi)
        diag, vol = self._pressure(state)
        xi = np.asarray(aux["rng"].standard_normal(3), np.float64)
        if self.isotropic:
            xi = np.full(3, xi[0])
        kbt_gpa = K_B * t0 / vol * PRESSURE_UNIT_CONVERSION
        noise = _vec3([s * x for s, x in zip(aux["sqrt_pc"], xi)], diag)
        scale = (1.0 - aux["pc"] * (aux["p0"] - diag)
                 + torch.sqrt(2.0 * kbt_gpa) * noise)
        return self._rescale(state, scale), {**aux, "i": aux["i"] + 1}
