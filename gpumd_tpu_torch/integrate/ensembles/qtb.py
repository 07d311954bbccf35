"""Quantum thermal bath (QTB): Langevin with coloured noise whose spectrum
carries the quantum harmonic oscillator's energy hbar omega (1/2 + n_BE)
instead of kB T (Dammak et al., PRL 103, 190601).

Counterpart of gpumd_tpu/integrate/ensembles/qtb.py (ref: src/integrate/
ensemble_qtb.cu:1-338).  The bath force on an atom is a moving-average
filter over its Gaussian history,
  fran_i = gamma3 sqrt(m_i) sum_m H[m] r_i[nfreq2 - 1 - m],
refreshed every `alpha` steps (alpha = max(1, 1 / (2 f_max dt))), with the
time filter H the inverse DFT of the target spectrum, built on the host
at `init`.  A half step: v += dt/2 (fran/m - v/tau), then the total
momentum is zeroed.

The (N, 2 N_f, 3) history is a ring on the state's device: a refresh
writes the new draw over the oldest column and advances the ring's
start; the filter is rolled by the start instead of the history being
shifted (the JAX package concatenates, a full copy a refresh).  Nothing is
read back to the host (the refresh counter and the ring's start are host
integers).  Noise: `draw(shape, dtype, device)` standard normals when
given (the tests hand in JAX's), else a torch.Generator seeded with `seed`
on the state's device: the whole history at `init`, an (N, 1, 3) column a
refresh.

run.in: ensemble nvt_qtb T1 T2 Tc [f_max THz] [N_f n]
        ensemble npt_qtb temp T1 T2 [tperiod x] [f_max v] [N_f n]
                 iso|aniso|tri ps pe | x|y|z ps pe [pperiod x]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from gpumd_tpu_torch.integrate.ensembles.nvt import normal_source
from gpumd_tpu_torch.integrate.velocity import _zero_linear_momentum
from gpumd_tpu_torch.integrate.verlet import (
    velocity_verlet_step1,
    velocity_verlet_step2,
)
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import HBAR, K_B, TIME_UNIT_CONVERSION


def qtb_time_filter(temperature, dt, f_max_thz, n_f, alpha):
    """The time-domain filter H on the host (ref: update_time_filter)."""
    nfreq2 = 2 * n_f
    h_timestep = alpha * dt
    omega_h = np.zeros(nfreq2)
    for k in range(nfreq2):
        ks = k - n_f
        if k == n_f:
            omega_h[k] = np.sqrt(K_B * temperature)
            continue
        f_k = ks / (nfreq2 * h_timestep)
        energy_k = 2.0 * np.pi * HBAR * abs(f_k)
        x = energy_k / (K_B * temperature)
        qfac = 0.5 + (1.0 / (np.exp(x) - 1.0) if x < 200.0 else 0.0)
        val = np.sqrt(energy_k * qfac)
        num = np.sin(ks * np.pi / (2.0 * alpha * n_f))
        den = np.sin(ks * np.pi / (2.0 * n_f))
        omega_h[k] = val * alpha * num / den
    t_n = np.arange(nfreq2) - n_f
    omega_k = (np.arange(nfreq2) - n_f) * np.pi / n_f
    return (omega_h[None, :] * np.cos(omega_k[None, :] * t_n[:, None])).sum(
        axis=1) / nfreq2


@dataclass(frozen=True)
class NVTQTB:
    temperature: float = 300.0
    coupling: float = 100.0  # tau / dt
    dt: float = 0.01  # natural units, for the filter at init
    f_max: float = 50.0  # THz
    n_f: int = 100
    seed: int = 615461
    mobile: Optional[object] = None
    draw: Optional[Callable] = None  # (shape, dtype, device) -> normals

    def _alpha(self) -> int:
        f_nat = self.f_max * TIME_UNIT_CONVERSION / 1000.0
        return max(1, int(1.0 / (2.0 * f_nat * self.dt)))

    def init(self, state: MDState):
        v = state.velocity
        n = v.shape[0]
        alpha = self._alpha()
        time_h = qtb_time_filter(self.temperature, self.dt, self.f_max,
                                 self.n_f, alpha)
        draw = normal_source(self.draw, self.seed, v.device)
        ring = draw((n, 2 * self.n_f, 3), v.dtype, v.device) / np.sqrt(12.0)
        fric = 1.0 / (self.coupling * self.dt)
        return {"draw": draw, "ring": ring, "start": 0, "counter": 0,
                "fran": torch.zeros_like(v),
                "h_rev": torch.as_tensor(time_h[::-1].copy(), dtype=v.dtype,
                                         device=v.device),
                "gamma3": (np.sqrt(2.0 * fric * 12.0 / (alpha * self.dt))
                           * torch.sqrt(state.mass)).to(v.dtype)}

    def _refresh(self, aux):
        """A new (N, 3) draw over the ring's oldest column, and the filter
        applied to the ring in its logical order."""
        ring = aux["ring"]
        n, nfreq2 = ring.shape[0], ring.shape[1]
        fresh = aux["draw"]((n, 1, 3), ring.dtype, ring.device)
        start = aux["start"]
        ring[:, start] = fresh[:, 0] / np.sqrt(12.0)
        start = (start + 1) % nfreq2
        # logical column m is ring column (start + m) % nfreq2
        filt = torch.roll(aux["h_rev"], shifts=start)
        fran = torch.einsum("nmk,m->nk", ring, filt) * aux["gamma3"][:, None]
        return {**aux, "start": start, "fran": fran}

    def _half_kick(self, state: MDState, aux, dt) -> MDState:
        fric = 1.0 / (self.coupling * self.dt)
        v0 = state.velocity
        v = v0 + 0.5 * dt * (aux["fran"] / state.mass[:, None] - fric * v0)
        if self.mobile is not None:
            v = torch.where(self.mobile[:, None] > 0, v, v0)
        v = _zero_linear_momentum(v, state.mass, state.mask)
        return state._replace(velocity=v * state.mask[:, None])

    def _maybe_refresh(self, aux):
        return self._refresh(aux) if aux["counter"] == 0 else aux

    def _count(self, aux):
        return {**aux, "counter": (aux["counter"] + 1) % self._alpha()}

    def step1(self, state: MDState, aux, dt):
        aux = self._maybe_refresh(aux)
        state = self._half_kick(state, aux, dt)
        return velocity_verlet_step1(state, dt, self.mobile), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile)
        return self._half_kick(state, aux, dt), self._count(aux)


@dataclass(frozen=True)
class NPTQTB:
    """npt_qtb: the QTB coloured-noise thermostat with an MTTK
    Parrinello-Rahman barostat (ref: src/integrate/ensemble_npt_qtb.cu):
    the barostat runs without its own temperature chain, and the QTB
    kicks wrap its half steps.  Host reads: the barostat's, two a step."""

    qtb: NVTQTB
    baro: object  # MTTK with use_barostat=True, use_thermostat=False

    @property
    def mobile(self):
        return self.qtb.mobile

    def init(self, state: MDState):
        return {**self.baro.init(state), **self.qtb.init(state)}

    def step1(self, state: MDState, aux, dt):
        aux = self.qtb._maybe_refresh(aux)
        state = self.qtb._half_kick(state, aux, dt)
        return self.baro.step1(state, aux, dt)

    def step2(self, state: MDState, aux, dt):
        state, aux = self.baro.step2(state, aux, dt)
        return self.qtb._half_kick(state, aux, dt), self.qtb._count(aux)
