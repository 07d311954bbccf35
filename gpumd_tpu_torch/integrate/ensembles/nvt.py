"""NVT thermostats: Berendsen, Langevin, BAOAB, Nose-Hoover chain and BDP.

Counterpart of gpumd_tpu/integrate/ensembles/nvt.py (NVTBerendsen,
NVTLangevin, NVTBAOAB, NVTNoseHooverChain, NVTBDP).  `coupling` is
tau/dt (a step count), as parsed from `ensemble nvt_xxx T1 T2 coupling`
(ref: src/integrate/integrate.cu:394-546); T1 -> T2 ramps linearly by
the step index aux["i"] over `n_steps`.

  * nvt_ber  Berendsen velocity rescale (ensemble_ber.cu), on the card
  * nvt_lan  Langevin OVO splitting: c1 = exp(-dt/(2 tau)),
             c2 = sqrt((1-c1^2) kB T / m), a half kick before step 1 and
             after step 2 (ensemble_lan.cu:35-36)
  * nvt_bao  BAOAB Langevin splitting (ensemble_bao.cu): B half kick,
             A half drift, O full Ornstein-Uhlenbeck, A half drift; B
             half kick
  * nvt_nhc  Nose-Hoover chain of 4, Suzuki-Yoshida 7 weights x n_respa 4,
             masses kT tau^2 (x 3N for the first) (ensemble_nhc.cu:28-150)
  * nvt_bdp  Bussi-Donadio-Parrinello stochastic velocity rescaling
             (svr_utilities.cuh resamplekin)

The chain's scalars are integrated on the host in Python floats (f64), as
the reference does (ensemble_nhc.cu copies the kinetic energy to the
CPU): a half step reads twice the kinetic energy and the degrees of
freedom in one device-to-host copy (one sync) and applies one velocity
scale on the card.  On the card the chain is some thousand scalar
operations a half step, each of which would be a launch.

BDP draws its two random numbers a step in f64 on the host, from a
`numpy.random.Generator` (the ensemble's `generator`, or one seeded with
`seed`), and reads the degrees of freedom once at `init`: a step needs no
device value on the host and adds no sync.  The new kinetic energy and
the velocity scale are computed on the card.  The stream differs from
that of JAX's random module; to reproduce a JAX run, give both the same
draws.

Langevin and BAOAB draw one (N, 3) normal tensor a half kick (Langevin:
step 1 before the drift, step 2 after the kick; BAOAB: in step 1's O
part) on the card, from a torch.Generator seeded with `seed` on the
state's device; `draw(shape, dtype, device)`, when given, replaces it
(the tests pass JAX's draws: the streams differ).  Nothing is read back
to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from gpumd_tpu_torch.integrate.velocity import _zero_linear_momentum
from gpumd_tpu_torch.integrate.verlet import (
    velocity_verlet_step1,
    velocity_verlet_step2,
)
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import K_B

NHC_LENGTH = 4
# Suzuki-Yoshida weights (Tuckerman), ref: ensemble_nhc.cu:118-127
_SY_W = (0.784513610477560, 0.235573213359357, -1.17767998417887,
         1.31518632068391, -1.17767998417887, 0.235573213359357,
         0.784513610477560)
_N_RESPA = 4


def nhc_scalar(pos, vel, mas, ek2: float, kt: float, dn: float,
               dt_half: float, n_respa: int = 4):
    """One Nose-Hoover-chain half update on host floats; returns (velocity
    scale factor, pos', vel').  The chain length is len(pos)
    (ref: ensemble_nhc.cu:97-160 nhc())."""
    pos, vel = list(pos), list(vel)
    m = len(pos)
    factor = 1.0

    def sweep(j, dt4, dt8):
        tmp = math.exp(-dt8 * vel[j + 1] / mas[j + 1])
        g = (vel[j - 1] ** 2 / mas[j - 1] - kt) if j > 0 else ek2 - dn * kt
        vel[j] = tmp * (tmp * vel[j] + dt4 * g)

    for w in _SY_W:
        dt2 = dt_half * w / n_respa
        dt4 = dt2 * 0.5
        dt8 = dt4 * 0.5
        for _ in range(n_respa):
            vel[m - 1] += dt4 * (vel[m - 2] ** 2 / mas[m - 2] - kt)
            for j in range(m - 2, -1, -1):
                sweep(j, dt4, dt8)
            pos = [p + dt2 * v / ms for p, v, ms in zip(pos, vel, mas)]
            s = math.exp(-dt2 * vel[0] / mas[0])
            factor *= s
            ek2 *= s * s
            for j in range(0, m - 1):
                sweep(j, dt4, dt8)
            vel[m - 1] += dt4 * (vel[m - 2] ** 2 / mas[m - 2] - kt)
    return factor, pos, vel


def _ke2(state: MDState):
    """Twice the kinetic energy (a device scalar)."""
    return torch.sum(state.mass * torch.sum(state.velocity ** 2, dim=-1)
                     * state.mask)


def _ndof(state: MDState):
    return 3.0 * torch.sum(state.mask)


@dataclass(frozen=True)
class _RampMixin:
    t0: float = 300.0
    t1: float = 300.0
    coupling: float = 100.0  # tau / dt
    n_steps: int = 0  # for the ramp; 0 = constant t0
    mobile: Optional[object] = None  # (N,) mobility mask (1 = free)
    pinned: Optional[tuple] = None  # (mask, velocity) constant-velocity group

    def _temp(self, aux) -> float:
        """Target temperature at step aux["i"]; the ramp fraction is
        rounded to float32 as in the JAX package."""
        if self.n_steps <= 0 or self.t0 == self.t1:
            return self.t0
        f32 = np.float32
        frac = f32(aux["i"]) / f32(self.n_steps)
        return float(f32(self.t0) + f32(self.t1 - self.t0) * frac)


@dataclass(frozen=True)
class NVTBerendsen(_RampMixin):
    def init(self, state: MDState):
        return {"i": 0}

    def step1(self, state: MDState, aux, dt):
        return velocity_verlet_step1(state, dt, self.mobile, self.pinned), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile, self.pinned)
        t_now = state.temperature()
        factor = torch.sqrt(1.0 + (self._temp(aux) / t_now - 1.0)
                            / self.coupling)
        # the startup T = 0 singularity: leave the velocities as they are
        factor = torch.where(torch.isfinite(factor), factor,
                             torch.ones_like(factor))
        return (state._replace(velocity=state.velocity * factor),
                {"i": aux["i"] + 1})


def normal_source(draw: Optional[Callable], seed: int, device):
    """draw(shape, dtype, device) -> standard normal tensor: `draw` itself
    when given, else torch.randn from a generator seeded with `seed` on
    `device`."""
    if draw is not None:
        return draw
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def randn(shape, dtype, dev):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    return randn


def _ou_c2(c1: float, t0: float, state: MDState):
    """sqrt((1 - c1^2) kB T / m) per atom, in the velocity's dtype."""
    return torch.sqrt((1.0 - c1 * c1) * K_B * t0 / state.mass).to(
        state.velocity.dtype)


@dataclass(frozen=True)
class NVTLangevin(_RampMixin):
    """Langevin (OVO) thermostat; aux holds the step index and the normal
    source.  Without a `mobile` mask the net momentum the kicks impart is
    removed after each one (ref: ensemble_lan.cu:111-124), so the centre
    of mass does not random-walk."""

    seed: int = 12345
    draw: Optional[Callable] = None  # (shape, dtype, device) -> normals

    def init(self, state: MDState):
        return {"i": 0, "draw": normal_source(self.draw, self.seed,
                                              state.velocity.device)}

    def _kick(self, state: MDState, aux):
        c1 = math.exp(-0.5 / self.coupling)
        v0 = state.velocity
        noise = aux["draw"](tuple(v0.shape), v0.dtype, v0.device)
        v = c1 * v0 + _ou_c2(c1, self._temp(aux), state)[:, None] * noise
        if self.mobile is not None:
            v = torch.where(self.mobile[:, None] > 0, v, v0)
        else:
            v = _zero_linear_momentum(v, state.mass, state.mask)
        return state._replace(velocity=v * state.mask[:, None])

    def step1(self, state: MDState, aux, dt):
        state = self._kick(state, aux)
        return velocity_verlet_step1(state, dt, self.mobile, self.pinned), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile, self.pinned)
        return self._kick(state, aux), {**aux, "i": aux["i"] + 1}


@dataclass(frozen=True)
class NVTBAOAB(_RampMixin):
    """BAOAB Langevin splitting (ref: ensemble_bao.cu): step 1 is B (half
    kick), A (half drift), O (a full Ornstein-Uhlenbeck step with friction
    1/(coupling dt)) and A; step 2 the last B.  It drifts the positions
    itself and moves `unwrapped_position` with them."""

    seed: int = 12345
    draw: Optional[Callable] = None  # (shape, dtype, device) -> normals

    def init(self, state: MDState):
        return {"i": 0, "draw": normal_source(self.draw, self.seed,
                                              state.velocity.device)}

    def step1(self, state: MDState, aux, dt):
        mob = self.mobile
        v = state.velocity + (0.5 * dt) * state.force / state.mass[:, None]
        if mob is not None:
            v = v * mob[:, None]
        x = state.position + 0.5 * dt * v
        c1 = math.exp(-1.0 / self.coupling)
        noise = aux["draw"](tuple(v.shape), v.dtype, v.device)
        v = c1 * v + _ou_c2(c1, self._temp(aux), state)[:, None] * noise
        if mob is not None:
            v = v * mob[:, None]
        v = v * state.mask[:, None]
        x = x + 0.5 * dt * v
        unwrapped = (state.unwrapped_position + (x - state.position)
                     if state.unwrapped_position is not None else None)
        return state._replace(position=x, velocity=v,
                              unwrapped_position=unwrapped), aux

    def step2(self, state: MDState, aux, dt):
        v = state.velocity + (0.5 * dt) * state.force / state.mass[:, None]
        if self.mobile is not None:
            v = v * self.mobile[:, None]
        step = state.step + 1 if state.step is not None else None
        return (state._replace(velocity=v, step=step),
                {**aux, "i": aux["i"] + 1})


@dataclass(frozen=True)
class NVTNoseHooverChain(_RampMixin):
    """Nose-Hoover chain of 4 with the SY(7) x n_respa 4 factorization;
    aux holds the chain's positions and velocities as Python floats."""

    def init(self, state: MDState):
        return {"i": 0, "pos": [0.0] * NHC_LENGTH,
                "vel": [1.0, -1.0, 1.0, -1.0]}

    def _chain(self, state: MDState, aux, dt, dt_half):
        """One NHC half-update; returns (velocity scale factor, aux')."""
        kt = K_B * self._temp(aux)
        ek2, dn = torch.stack([_ke2(state), _ndof(state)]).tolist()
        tau = dt * self.coupling
        mas = [kt * tau * tau] * NHC_LENGTH
        mas[0] *= dn
        factor, pos, vel = nhc_scalar(aux["pos"], aux["vel"], mas, ek2, kt,
                                      dn, dt_half, _N_RESPA)
        return factor, {**aux, "pos": pos, "vel": vel}

    def step1(self, state: MDState, aux, dt):
        factor, aux = self._chain(state, aux, dt, 0.5 * dt)
        state = state._replace(velocity=state.velocity * factor)
        return velocity_verlet_step1(state, dt, self.mobile, self.pinned), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile, self.pinned)
        factor, aux = self._chain(state, aux, dt, 0.5 * dt)
        state = state._replace(velocity=state.velocity * factor)
        return state, {**aux, "i": aux["i"] + 1}


@dataclass(frozen=True)
class NVTBDP(_RampMixin):
    """Bussi-Donadio-Parrinello stochastic velocity rescaling
    (ref: svr_utilities.cuh:104-125 resamplekin).  aux holds the step
    index, the generator and the degrees of freedom."""

    seed: int = 12345
    # anything with numpy.random.Generator's standard_normal() and
    # gamma(shape); None: numpy.random.default_rng(seed)
    generator: Optional[object] = None

    def init(self, state: MDState):
        rng = (self.generator if self.generator is not None
               else np.random.default_rng(self.seed))
        return {"i": 0, "rng": rng, "ndeg": float(_ndof(state))}

    def step1(self, state: MDState, aux, dt):
        return velocity_verlet_step1(state, dt, self.mobile, self.pinned), aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile, self.pinned)
        scale = bdp_scale(state, aux, self._temp(aux), self.coupling)
        return (state._replace(velocity=state.velocity * scale),
                {**aux, "i": aux["i"] + 1})


def bdp_scale(state: MDState, aux, t0: float, coupling: float):
    """The BDP velocity scale sqrt(K_new / K) (a device scalar), K_new drawn
    from aux's generator: a normal rr and the sum of ndeg - 1 squared
    normals, 2 Gamma((ndeg - 1) / 2)."""
    rng, ndeg = aux["rng"], aux["ndeg"]
    rr = float(rng.standard_normal())
    sumn = 2.0 * float(rng.gamma(0.5 * (ndeg - 1.0)))
    kk = 0.5 * _ke2(state)  # current kinetic energy
    sigma = 0.5 * ndeg * K_B * t0  # target kinetic energy
    factor = math.exp(-1.0 / coupling)
    kk_new = (kk + (1.0 - factor) * (sigma * (sumn + rr * rr) / ndeg - kk)
              + 2.0 * rr * torch.sqrt(kk * (sigma / ndeg * (1.0 - factor)
                                            * factor)))
    return torch.sqrt(kk_new / kk)
