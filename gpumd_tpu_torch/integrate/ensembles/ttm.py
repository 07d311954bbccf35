"""Two-temperature model (TTM): ttm and heat_ttm.

Counterpart of gpumd_tpu/integrate/ensembles/ttm.py (ref: src/integrate/
ensemble_ttm.cu): an electron-temperature field T_e on an (nz, ny, nx)
voxel grid, coupled to the lattice through Langevin-like forces

    f_i = -gamma v_i + sqrt(24 kB T_e(cell_i) gamma_p / dt) (u - 1/2),
    gamma = gamma_p (+ gamma_s when |v| > v_0: electronic stopping),

and advanced by the explicit-Euler heat equation with the electron-phonon
power as a sink and an optional volumetric source (laser heating):

    c_vol dT_e/dt = kappa_e lap(T_e) - P_eph / V_cell + S.

Everything runs on the state's device with nothing read back: voxel
binning by floor division, the power deposit by index_add_, and the
diffusion as `n_sub` substeps of a torch.roll stencil a step, n_sub fixed
at construction from the Fourier limit of the parse-time voxels
(`substeps`).  The uniform draws u come from `draw(shape, dtype, device)`
when given (the tests hand in JAX's), else from a torch.Generator seeded
with `seed` on the state's device: one (N, 3) tensor a step.

run.in: ensemble ttm <gm> <gid> Ce rho_e kappa_e gamma_p gamma_s v_0
        nx ny nz T_e_init [ttm_out_interval n] [ttm_source s]
Units (ref: initialize_ttm_common): Ce rho_e in eV/K/A^3; kappa_e input
eV/(ps K A), /1000 here; gamma in amu/ps -> natural; v_0 in km/s = A/ps
-> natural.  The app writes ttm_electron_temperature.out at a run's end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from gpumd_tpu_torch.integrate.ensembles.heat import as_mask
from gpumd_tpu_torch.integrate.verlet import (
    velocity_verlet_step1,
    velocity_verlet_step2,
)
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION


def uniform_source(draw: Optional[Callable], seed: int, device):
    """draw(shape, dtype, device) -> uniform [0, 1) tensor: `draw` when
    given, else torch.rand from a generator seeded with `seed`."""
    if draw is not None:
        return draw
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def rand(shape, dtype, dev):
        return torch.rand(shape, generator=gen, dtype=dtype, device=dev)

    return rand


@dataclass(frozen=True)
class TTM:
    gmask: object  # (N,) 1.0 on TTM-coupled atoms
    c_vol: float  # Ce * rho_e, eV / (K A^3)
    kappa_e: float  # eV / (fs K A) (input / 1000)
    gamma_p: float  # natural mass/time units
    gamma_s: float = 0.0
    v0_sq: float = 0.0  # natural
    grid: Tuple[int, int, int] = (1, 1, 1)  # (nx, ny, nz)
    t_e_init: float = 300.0
    source: float = 0.0  # eV / (A^3 fs)
    out_interval: int = 1
    seed: int = 777
    mobile: Optional[object] = None
    # the parse-time voxel sizes (the explicit step's stability)
    dcell_static: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    draw: Optional[Callable] = None  # (shape, dtype, device) -> U[0, 1)

    def substeps(self, dt_fs: float) -> int:
        """Diffusion substeps a step: the uniform-property Fourier limit
        with a 0.9 margin."""
        dx, dy, dz = self.dcell_static
        voxel = 1.0 / dx ** 2 + 1.0 / dy ** 2 + 1.0 / dz ** 2
        fourier = 2.0 * self.kappa_e * voxel / self.c_vol
        return max(1, int(math.ceil(dt_fs * fourier / 0.9)))

    def _cell_of(self, state: MDState):
        nx, ny, nz = self.grid
        h, p = state.box.h, state.position

        def idx(k, nk):
            return torch.remainder(
                torch.floor(p[:, k] / h[k, k] * nk).to(torch.int64), nk)

        return (idx(2, nz) * ny + idx(1, ny)) * nx + idx(0, nx)

    def init(self, state: MDState):
        nx, ny, nz = self.grid
        v = state.velocity
        nvox = nx * ny * nz
        return {"rand": uniform_source(self.draw, self.seed, v.device),
                "gm": as_mask(self.gmask, v),
                "t_e": torch.full((nvox,), self.t_e_init, dtype=v.dtype,
                                  device=v.device),
                "ttm_force": torch.zeros_like(v),
                "net_power": torch.zeros(nvox, dtype=v.dtype,
                                         device=v.device),
                "i": 0}

    def _half_kick_ttm(self, state: MDState, aux, dt) -> MDState:
        v0 = state.velocity
        v = v0 + 0.5 * dt * aux["ttm_force"] / state.mass[:, None]
        v = torch.where(aux["gm"][:, None] > 0, v, v0)
        return state._replace(velocity=v * state.mask[:, None])

    def _update_force(self, state: MDState, aux, dt):
        v = state.velocity
        t_e = aux["t_e"][self._cell_of(state)]
        u = aux["rand"](tuple(v.shape), v.dtype, v.device) - 0.5
        vsq = torch.sum(v ** 2, dim=-1)
        gamma = torch.where(vsq > self.v0_sq,
                            torch.full_like(vsq, self.gamma_p + self.gamma_s),
                            torch.full_like(vsq, self.gamma_p))
        gfac = torch.sqrt(torch.clamp(t_e, min=0.0) * 24.0 * K_B
                          * self.gamma_p / dt)
        f = -gamma[:, None] * v + gfac[:, None] * u
        f = f * (aux["gm"] * (t_e > 0))[:, None]
        return {**aux, "ttm_force": f}

    def _accumulate_power(self, state: MDState, aux):
        p = torch.sum(aux["ttm_force"] * state.velocity, dim=-1) * aux["gm"]
        p = p / TIME_UNIT_CONVERSION  # eV per fs
        net = torch.zeros_like(aux["net_power"]).index_add_(
            0, self._cell_of(state), p)
        return {**aux, "net_power": net}

    def _diffuse(self, state: MDState, aux, dt):
        nx, ny, nz = self.grid
        h = state.box.h.to(aux["t_e"].dtype)
        dx, dy, dz = h[0, 0] / nx, h[1, 1] / ny, h[2, 2] / nz
        vol = dx * dy * dz
        dt_fs = dt * TIME_UNIT_CONVERSION
        n_sub = self.substeps(float(dt_fs))
        inner = dt_fs / n_sub
        sink = (aux["net_power"] / vol).reshape(nz, ny, nx)
        t = aux["t_e"].reshape(nz, ny, nx)
        for _ in range(n_sub):
            lap = ((torch.roll(t, 1, 2) + torch.roll(t, -1, 2) - 2 * t)
                   / (dx * dx)
                   + (torch.roll(t, 1, 1) + torch.roll(t, -1, 1) - 2 * t)
                   / (dy * dy)
                   + (torch.roll(t, 1, 0) + torch.roll(t, -1, 0) - 2 * t)
                   / (dz * dz))
            t = t + inner / self.c_vol * (self.kappa_e * lap - sink
                                          + self.source)
        return {**aux, "t_e": t.reshape(-1)}

    def step1(self, state: MDState, aux, dt):
        state = self._half_kick_ttm(state, aux, dt)
        return velocity_verlet_step1(state, dt, self.mobile), aux

    def step2(self, state: MDState, aux, dt):
        aux = self._update_force(state, aux, dt)
        state = velocity_verlet_step2(state, dt, self.mobile)
        state = self._half_kick_ttm(state, aux, dt)
        aux = self._accumulate_power(state, aux)
        aux = self._diffuse(state, aux, dt)
        return state, {**aux, "i": aux["i"] + 1}
