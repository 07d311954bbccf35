"""NEMD heat-source/sink ensembles: heat_lan, heat_nhc, heat_bdp and
heat_hybrid.

Counterpart of gpumd_tpu/integrate/ensembles/heat.py.

  * heat_lan  Langevin baths at T + dT on the source group and T - dT on
              the sink group; every other atom evolves as NVE
              (ref: integrate.cu:700-752, ensemble_lan.cu:60-80)
  * heat_nhc  one Nose-Hoover chain a bath on the group's centre-of-mass-
              relative kinetic energy, rescaling only the relative
              velocities (ref: ensemble_nhc.cu:236-335, ensemble.cu:
              700-880 find_vc_and_ke / scale_velocity_local)
  * heat_bdp  BDP stochastic rescaling a bath, the same way
              (ref: ensemble_bdp.cu:104-160)
  * heat_hybrid  N local baths, each NHC or Langevin; bath 0 the source
              (ref: ensemble_heat_hybrid.cu)

Each accumulates the energy its baths take from the system in
aux["e_transfer"] (source then sink; one entry a bath for heat_hybrid), a
float64 tensor on the state's device, as the reference's double
energy_transferred[] (system -> bath positive).  The `compute` keyword
writes it beside the group temperatures.

Host reads: heat_lan and heat_bdp read nothing (BDP draws its four
numbers a step on the host from a numpy generator, as NVTBDP does, and
reads its degrees of freedom once at `init`); heat_nhc reads the two
baths' relative kinetic energies in one copy a half step (two a step),
and integrates both chains on the host in float64 as NVTNoseHooverChain
does; heat_hybrid reads once an NHC bath a half step.  The Langevin
noise comes from `draw(shape, dtype, device)` when given (the tests hand
in JAX's draws), else from a torch.Generator seeded with `seed` on the
state's device: heat_lan draws the source's (N, 3) normals then the
sink's at each kick, heat_hybrid one (N, 3) tensor a Langevin bath.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from gpumd_tpu_torch.integrate.ensembles.nvt import (
    nhc_scalar,
    normal_source,
)
from gpumd_tpu_torch.integrate.verlet import (
    velocity_verlet_step1,
    velocity_verlet_step2,
)
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import K_B

_CHAIN_VEL0 = (1.0, -1.0, 1.0, -1.0)


def as_mask(m, like: torch.Tensor) -> torch.Tensor:
    """A group mask (numpy array or tensor) in `like`'s dtype and device."""
    if torch.is_tensor(m):
        return m.to(dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(m), dtype=like.dtype,
                           device=like.device)


def host_sum(m) -> float:
    """The sum of a group mask: a numpy one's on the host, a tensor's in
    one read."""
    return float(m.sum()) if torch.is_tensor(m) else float(np.sum(m))


def group_vc_ke2(state: MDState, gmask: torch.Tensor):
    """The group's centre-of-mass velocity (3,) and twice its COM-relative
    kinetic energy (ref: ensemble.cu:700-777 gpu_find_vc_and_ke)."""
    m = state.mass * gmask
    mc = torch.sum(m)
    vc = torch.sum(m[:, None] * state.velocity, dim=0) / mc
    ke2 = torch.sum(m * torch.sum(state.velocity ** 2, dim=-1))
    return vc, ke2 - mc * torch.sum(vc * vc)


def scale_relative(state: MDState, gmask, vc, factor) -> MDState:
    """v <- vc + factor (v - vc) on the group (momentum conserving)."""
    v = vc[None, :] + factor * (state.velocity - vc[None, :])
    v = torch.where(gmask[:, None] > 0, v, state.velocity)
    return state._replace(velocity=v * state.mask[:, None])


def _chain_masses(kt: float, dn: float, tau: float):
    return [kt * tau * tau * dn] + [kt * tau * tau] * 3


def _e_add(aux, de):
    """aux with the baths' energies `de` (a list of device scalars) added
    to its float64 e_transfer."""
    return {**aux, "e_transfer": aux["e_transfer"]
            + torch.stack(de).to(torch.float64)}


@dataclass(frozen=True)
class HeatLangevin:
    temperature: float
    coupling: float  # tau / dt
    delta_t: float
    source_mask: object  # (N,) 1.0 on source atoms
    sink_mask: object
    seed: int = 12345
    mobile: Optional[object] = None
    draw: Optional[Callable] = None  # (shape, dtype, device) -> normals

    def init(self, state: MDState):
        v = state.velocity
        return {"draw": normal_source(self.draw, self.seed, v.device),
                "src": as_mask(self.source_mask, v),
                "snk": as_mask(self.sink_mask, v),
                "e_transfer": torch.zeros(2, dtype=torch.float64,
                                          device=v.device)}

    def _kick(self, state: MDState, aux):
        c1 = math.exp(-0.5 / self.coupling)
        v0 = state.velocity
        src, snk = aux["src"], aux["snk"]
        draw = aux["draw"]
        n_src = draw(tuple(v0.shape), v0.dtype, v0.device)
        n_snk = draw(tuple(v0.shape), v0.dtype, v0.device)
        cc = (1.0 - c1 * c1) * K_B
        c2_src = torch.sqrt(cc * (self.temperature + self.delta_t)
                            / state.mass).to(v0.dtype)
        c2_snk = torch.sqrt(cc * (self.temperature - self.delta_t)
                            / state.mass).to(v0.dtype)
        v = torch.where(src[:, None] > 0, c1 * v0 + c2_src[:, None] * n_src,
                        torch.where(snk[:, None] > 0,
                                    c1 * v0 + c2_snk[:, None] * n_snk, v0))
        # the reference's sign: energy from the system to the bath
        # (ref: ensemble_lan.cu:152-194, += before, -= after), in float64
        m64 = state.mass.to(torch.float64)
        de = 0.5 * m64 * (torch.sum(v0.to(torch.float64) ** 2, dim=-1)
                          - torch.sum(v.to(torch.float64) ** 2, dim=-1))
        aux = {**aux, "e_transfer": aux["e_transfer"] + torch.stack(
            [torch.sum(de * src), torch.sum(de * snk)])}
        return state._replace(velocity=v * state.mask[:, None]), aux

    def step1(self, state: MDState, aux, dt):
        state, aux = self._kick(state, aux)
        return velocity_verlet_step1(state, dt, self.mobile), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile)
        return self._kick(state, aux)


@dataclass(frozen=True)
class HeatNHC:
    """heat_nhc: one NHC a bath on COM-relative velocities
    (ref: ensemble_nhc.cu:236-335); the chains on the host, one read of
    both baths' kinetic energies a half step."""

    temperature: float
    coupling: float  # tau / dt
    delta_t: float
    source_mask: object
    sink_mask: object
    mobile: Optional[object] = None

    def init(self, state: MDState):
        v = state.velocity
        return {"pos1": [0.0] * 4, "vel1": list(_CHAIN_VEL0),
                "pos2": [0.0] * 4, "vel2": list(_CHAIN_VEL0),
                "src": as_mask(self.source_mask, v),
                "snk": as_mask(self.sink_mask, v),
                "dn1": 3.0 * host_sum(self.source_mask),
                "dn2": 3.0 * host_sum(self.sink_mask),
                "e_transfer": torch.zeros(2, dtype=torch.float64,
                                          device=v.device)}

    def _baths(self, state: MDState, aux, dt):
        tau = dt * self.coupling
        vc1, ek1 = group_vc_ke2(state, aux["src"])
        vc2, ek2 = group_vc_ke2(state, aux["snk"])
        e1, e2 = torch.stack([ek1, ek2]).tolist()  # the half step's read
        out = {**aux}
        fs = []
        for b, ek, t in ((1, e1, self.temperature + self.delta_t),
                         (2, e2, self.temperature - self.delta_t)):
            kt, dn = K_B * t, aux[f"dn{b}"]
            f, out[f"pos{b}"], out[f"vel{b}"] = nhc_scalar(
                aux[f"pos{b}"], aux[f"vel{b}"], _chain_masses(kt, dn, tau),
                ek, kt, dn, 0.5 * dt)
            fs.append(f)
        f1, f2 = fs
        out = _e_add(out, [ek1 * (0.5 * (1.0 - f1 * f1)),
                           ek2 * (0.5 * (1.0 - f2 * f2))])
        state = scale_relative(state, aux["src"], vc1, f1)
        state = scale_relative(state, aux["snk"], vc2, f2)
        return state, out

    def step1(self, state: MDState, aux, dt):
        state, aux = self._baths(state, aux, dt)
        return velocity_verlet_step1(state, dt, self.mobile), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile)
        return self._baths(state, aux, dt)


@dataclass(frozen=True)
class HeatBDP:
    """heat_bdp: BDP stochastic rescaling a bath on COM-relative
    velocities (ref: ensemble_bdp.cu:104-160; dN = 3 (N_group - 1)).  A
    step draws the source's normal and Gamma((dN - 1) / 2), then the
    sink's, from `generator` (numpy.random.Generator's standard_normal()
    and gamma(shape)) or numpy.random.default_rng(seed)."""

    temperature: float
    coupling: float
    delta_t: float
    source_mask: object
    sink_mask: object
    seed: int = 12345
    mobile: Optional[object] = None
    generator: Optional[object] = None

    def init(self, state: MDState):
        v = state.velocity
        rng = (self.generator if self.generator is not None
               else np.random.default_rng(self.seed))
        return {"rng": rng, "src": as_mask(self.source_mask, v),
                "snk": as_mask(self.sink_mask, v),
                "dn1": 3.0 * (host_sum(self.source_mask) - 1.0),
                "dn2": 3.0 * (host_sum(self.sink_mask) - 1.0),
                "e_transfer": torch.zeros(2, dtype=torch.float64,
                                          device=v.device)}

    def _resample(self, rng, kk, sigma: float, ndeg: float):
        factor = math.exp(-1.0 / self.coupling)
        rr = float(rng.standard_normal())
        sumn = 2.0 * float(rng.gamma(0.5 * (ndeg - 1.0)))
        kk_new = (kk + (1.0 - factor) * (sigma * (sumn + rr * rr) / ndeg - kk)
                  + 2.0 * rr * torch.sqrt(kk * sigma / ndeg * (1.0 - factor)
                                          * factor))
        return torch.sqrt(kk_new / kk)

    def _baths(self, state: MDState, aux, dt):
        vc1, ek1 = group_vc_ke2(state, aux["src"])
        vc2, ek2 = group_vc_ke2(state, aux["snk"])
        dn1, dn2 = aux["dn1"], aux["dn2"]
        s1 = 0.5 * dn1 * K_B * (self.temperature + self.delta_t)
        s2 = 0.5 * dn2 * K_B * (self.temperature - self.delta_t)
        f1 = self._resample(aux["rng"], 0.5 * ek1, s1, dn1)
        f2 = self._resample(aux["rng"], 0.5 * ek2, s2, dn2)
        aux = _e_add(aux, [ek1 * 0.5 * (1.0 - f1 * f1),
                           ek2 * 0.5 * (1.0 - f2 * f2)])
        state = scale_relative(state, aux["src"], vc1, f1)
        state = scale_relative(state, aux["snk"], vc2, f2)
        return state, aux

    def step1(self, state: MDState, aux, dt):
        return velocity_verlet_step1(state, dt, self.mobile), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile)
        return self._baths(state, aux, dt)


@dataclass(frozen=True)
class HeatHybrid:
    """heat_hybrid: N local baths, each NHC or Langevin, on grouping-
    method-0 groups; bath 0 the source at T + dT, the rest sinks at T - dT
    (ref: ensemble_heat_hybrid.cu).  NHC baths act on COM-relative
    velocities (momentum conserving); Langevin baths kick the whole
    group."""

    kinds: tuple  # ("nhc" | "lan", ...) a bath
    temperature: float
    couplings: tuple  # tau / dt a bath
    delta_t: float
    masks: tuple  # a bath's (N,) group mask
    seed: int = 12345
    mobile: Optional[object] = None
    draw: Optional[Callable] = None  # (shape, dtype, device) -> normals

    def _target(self, i: int) -> float:
        return self.temperature + (self.delta_t if i == 0 else -self.delta_t)

    def init(self, state: MDState):
        v = state.velocity
        nt = len(self.kinds)
        return {"pos": [[0.0] * 4 for _ in range(nt)],
                "vel": [list(_CHAIN_VEL0) for _ in range(nt)],
                "draw": normal_source(self.draw, self.seed, v.device),
                "g": [as_mask(m, v) for m in self.masks],
                "dn": [3.0 * host_sum(m) for m in self.masks],
                "e_transfer": torch.zeros(nt, dtype=torch.float64,
                                          device=v.device)}

    def _baths(self, state: MDState, aux, dt):
        pos, vel = list(aux["pos"]), list(aux["vel"])
        de = []
        for i, kind in enumerate(self.kinds):
            g = aux["g"][i]
            kt = K_B * self._target(i)
            if kind == "nhc":
                dn = aux["dn"][i]
                vc, ek2 = group_vc_ke2(state, g)
                f, pos[i], vel[i] = nhc_scalar(
                    pos[i], vel[i],
                    _chain_masses(kt, dn, dt * self.couplings[i]),
                    float(ek2), kt, dn, 0.5 * dt)  # the bath's read
                state = scale_relative(state, g, vc, f)
                de.append(ek2 * (0.5 * (1.0 - f * f)))
            else:
                c1 = math.exp(-0.5 / self.couplings[i])
                v0 = state.velocity
                c2 = torch.sqrt((1 - c1 * c1) * kt / state.mass).to(v0.dtype)
                noise = aux["draw"](tuple(v0.shape), v0.dtype, v0.device)
                v = torch.where(g[:, None] > 0, c1 * v0 + c2[:, None] * noise,
                                v0) * state.mask[:, None]
                state = state._replace(velocity=v)
                m64 = state.mass.to(torch.float64)
                de.append(torch.sum(0.5 * m64 * g.to(torch.float64) * (
                    torch.sum(v0.to(torch.float64) ** 2, dim=-1)
                    - torch.sum(v.to(torch.float64) ** 2, dim=-1))))
        return state, _e_add({**aux, "pos": pos, "vel": vel}, de)

    def step1(self, state: MDState, aux, dt):
        state, aux = self._baths(state, aux, dt)
        return velocity_verlet_step1(state, dt, self.mobile), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile)
        return self._baths(state, aux, dt)
