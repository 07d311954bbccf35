"""Thermodynamic-integration ensembles: ti_spring, ti, ti_rs, ti_as and
ti_liquid.

Counterpart of gpumd_tpu/integrate/ensembles/ti.py.

  * ti_spring  nonequilibrium Frenkel-Ladd switching to an Einstein
               crystal (ref: ensemble_ti_spring.cu): a global Langevin
               thermostat at T; x0 frozen at the run's start; the mixed
               force (1 - lambda) f_pot - lambda k (x - x0); lambda
               equilibrates t_equil steps, switches 0 -> 1 over t_switch
               (the C3-continuous polynomial), equilibrates and switches
               back; spring constants given a species or estimated from
               the equilibration MSD (k = 3 kB T / <msd>); E_diff =
               1/2 integral (U - U_spring) |dlambda| / N over both legs,
               and F = E_Einstein + E_diff at the run's end
  * ti         the same mixed force at a fixed lambda (ensemble_ti.cu)
  * ti_rs      reversible scaling: MTTK NPT with the whole Hamiltonian
               scaled by lambda(t) from 1 to T_start / T_max and back
               (ensemble_ti_rs.cu)
  * ti_as      adiabatic switching over pressure: MTTK NPT whose target
               ramps p_min -> p_max and back (ensemble_ti_as.cu)
  * ti_liquid  switching to the Uhlenbeck-Ford fluid (ensemble_ti_liquid
               .cu), its excess free energy from the spline tables in
               assets/uf_spline.npz

The schedule (lambda, dlambda and the legs) is host arithmetic on the
step index; the sums (U, U_spring, the MSD, E_diff in float64) stay on
the state's device: ti_spring, ti and ti_liquid add no read a step;
ti_rs and ti_as read what their MTTK barostat reads (two a step).  The
.csv rows come from the run's per-step observations (`observe`,
`csv_rows`) and the .yaml summary (`free_energy`) reads the state once at
the run's end.  The Langevin noise: one (N, 3) normal tensor a half step,
from `draw(shape, dtype, device)` when given (the tests hand in JAX's),
else a torch.Generator seeded with `seed` on the state's device.

TILiquid's Uhlenbeck-Ford pair sum is all pairs under the minimum image,
in row blocks of 512 atoms (exp(-r^2 / sigma^2) dies within ~2 A, so the
far pairs add exactly zero): the slice's one O(N^2) pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.integrate.ensembles.mttk import MTTK
from gpumd_tpu_torch.integrate.ensembles.nvt import normal_source
from gpumd_tpu_torch.integrate.velocity import _zero_linear_momentum
from gpumd_tpu_torch.integrate.verlet import (
    velocity_verlet_step1,
    velocity_verlet_step2,
)
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import HBAR, K_B, PRESSURE_UNIT_CONVERSION

UF_SPLINE = Path(__file__).resolve().parents[2] / "assets" / "uf_spline.npz"
UF_BLOCK = 512  # rows a block of the UF pair sum


def _host(x) -> np.ndarray:
    """A stacked observation (tensor on any device, or numbers) on the
    host."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def schedule(n_steps: int, t_switch: int, t_equil: int):
    """(t_switch, t_equil): given, else 0.4 and 0.1 of the run."""
    return (t_switch if t_switch > 0 else int(n_steps * 0.4),
            t_equil if t_equil > 0 else int(n_steps * 0.1))


def _legs(i: int, ts: int, te: int, inclusive: bool):
    """(in the forward leg, in the backward leg, x1, x2) at step i."""
    t = float(i - te)
    r = 1.0 / ts
    leg1 = 0 <= t <= ts if inclusive else 0 <= t < ts
    leg2 = te + ts <= t <= te + 2 * ts
    x1 = min(max(t * r, 0.0), 1.0)
    x2 = min(max(1.0 - (t - ts - te) * r, 0.0), 1.0)
    return leg1, leg2, x1, x2


@dataclass(frozen=True)
class TISpring:
    """ti_spring (Frenkel-Ladd nonequilibrium switching).

    run.in: ensemble ti_spring temp T [tperiod tau] [tswitch n tequil n]
            [press P] [spring El k ...]
    """

    temperature: float = 300.0
    coupling: float = 100.0  # tau / dt (tperiod)
    t_switch: int = -1  # auto: 0.4 n_steps
    t_equil: int = -1  # auto: 0.1 n_steps
    target_pressure: float = 0.0  # eV/A^3 (parsed from GPa)
    spring_k: Optional[Tuple[float, ...]] = None  # a species' k, eV/A^2
    num_types: int = 1
    n_steps: int = 0
    seed: int = 12345
    mobile: Optional[object] = None
    draw: Optional[Callable] = None  # (shape, dtype, device) -> normals

    csv_name = "ti_spring.csv"
    csv_header = "lambda,dlambda,pe,espring\n"
    yaml_name = "ti_spring.yaml"

    def observe(self, state: MDState, aux):
        return (aux["lambda"], aux["dlambda"], aux["pe"], aux["espring"])

    def csv_rows(self, obs, n):
        lam, dlam, pe, es = (_host(o) for o in obs)
        for r in range(len(lam)):
            if dlam[r] != 0.0:
                yield (f"{lam[r]:e},{dlam[r]:e},"
                       f"{pe[r] / n:e},{es[r] / n:e}\n")

    def _schedule(self):
        return schedule(self.n_steps, self.t_switch, self.t_equil)

    # the C3 switch (ref: ensemble_ti_spring.cu switch_func/dswitch_func)
    @staticmethod
    def _switch(t):
        t2 = t * t
        t5 = t2 * t2 * t
        return (70.0 * t2 * t2 - 315.0 * t2 * t + 540.0 * t2 - 420.0 * t
                + 126.0) * t5

    @staticmethod
    def _dswitch(t, t_switch):
        t2 = t * t
        t4 = t2 * t2
        return ((630.0 * t2 * t2 - 2520.0 * t2 * t + 3780.0 * t2
                 - 2520.0 * t + 630.0) * t4) / t_switch

    def _lambda(self, i, lam_prev, inclusive=True):
        """(lambda, dlambda, in a leg) at step i."""
        ts, te = self._schedule()
        leg1, leg2, x1, x2 = _legs(i, ts, te, inclusive)
        if leg1:
            return self._switch(x1), self._dswitch(x1, ts), True
        if leg2:
            return self._switch(x2), -self._dswitch(x2, ts), True
        return lam_prev, 0.0, False

    def _common(self, state: MDState):
        v = state.velocity
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        return {"i": 0, "draw": normal_source(self.draw, self.seed, v.device),
                "n": max(float(state.mask.sum()), 1.0), "lambda": 0.0,
                "dlambda": 0.0, "pe": zero, "e_diff": torch.zeros(
                    (), dtype=torch.float64, device=v.device)}

    def init(self, state: MDState):
        v = state.velocity
        if self.spring_k is not None:
            table = torch.as_tensor(self.spring_k, dtype=v.dtype,
                                    device=v.device)
            k = table[state.type.long()] * state.mask
        else:
            k = torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
        return {**self._common(state), "x0": state.position.clone(),
                "k": k, "espring": torch.zeros((), dtype=v.dtype,
                                               device=v.device)}

    # ---- the global Langevin thermostat (ref: Ensemble_LAN type 3) ------

    def _kick(self, state: MDState, aux) -> MDState:
        c1 = math.exp(-0.5 / self.coupling)
        v0 = state.velocity
        c2 = torch.sqrt((1.0 - c1 * c1) * K_B * self.temperature
                        / state.mass).to(v0.dtype)
        noise = aux["draw"](tuple(v0.shape), v0.dtype, v0.device)
        v = _zero_linear_momentum(c1 * v0 + c2[:, None] * noise, state.mass,
                                  state.mask)
        return state._replace(velocity=v * state.mask[:, None])

    def step1(self, state: MDState, aux, dt):
        state = self._kick(state, aux)
        return velocity_verlet_step1(state, dt, self.mobile), aux

    def _e_diff(self, aux, pe, e_ref, dlam, in_leg):
        """E_diff + 1/2 (U - U_ref) |dlambda| / N inside a leg."""
        if not in_leg:
            return aux["e_diff"]
        return aux["e_diff"] + (0.5 * (pe - e_ref) * abs(dlam)
                                / aux["n"]).to(torch.float64)

    def _find_lambda(self, state: MDState, aux):
        """The step's lambda schedule, MSD/k estimate and work integral
        (ref: ensemble_ti_spring.cu:295-365 find_lambda)."""
        ts, te = self._schedule()
        i = aux["i"]
        disp = state.box.minimum_image(state.position - aux["x0"])
        d2 = torch.sum(disp * disp, dim=-1) * state.mask
        k = aux["k"]
        if self.spring_k is None:
            if i < te:  # equilibration: accumulate the MSD
                k = k + d2
            if i == te - 1:  # a species' mean MSD -> its spring constant
                types = state.type.long()
                ksum = torch.zeros(self.num_types, dtype=k.dtype,
                                   device=k.device).index_add_(
                    0, types, k * state.mask)
                cnt = torch.zeros_like(ksum).index_add_(0, types, state.mask)
                msd = ksum / torch.clamp(cnt, min=1.0) / te
                k_el = 3.0 * K_B * self.temperature / torch.clamp(msd,
                                                                  min=1e-12)
                k = k_el[types] * state.mask
        lam, dlam, in_leg = self._lambda(i, aux["lambda"])
        pe = torch.sum(state.potential_energy * state.mask)
        espring = torch.sum(0.5 * k * d2)
        return {**aux, "k": k, "lambda": lam, "dlambda": dlam,
                "e_diff": self._e_diff(aux, pe, espring, dlam, in_leg),
                "pe": pe, "espring": espring}, disp

    def step2(self, state: MDState, aux, dt):
        aux, disp = self._find_lambda(state, aux)
        lam = aux["lambda"]
        # the mixed force (ref: gpu_add_spring_force)
        f = (1.0 - lam) * state.force + lam * (-aux["k"][:, None] * disp)
        state = state._replace(force=f * state.mask[:, None])
        state = velocity_verlet_step2(state, dt, self.mobile)
        return self._kick(state, aux), {**aux, "i": aux["i"] + 1}

    # ---- the summary at the run's end ------------------------------------

    def free_energy(self, state: MDState, aux) -> dict:
        """E_Einstein + E_diff (ref: ~Ensemble_TI_Spring)."""
        kt = K_B * self.temperature
        k, mass = _host(aux["k"]), _host(state.mass)
        mask = _host(state.mask) > 0
        n = int(mask.sum())
        lnterm = np.log(np.sqrt(k[mask] / mass[mask]) * HBAR / kt)
        e_ein = 3.0 * kt * float(np.sum(lnterm)) / n
        e_diff = float(aux["e_diff"])
        v = float(state.box.volume) / n
        return {"E_Einstein": e_ein, "E_diff": e_diff, "F": e_ein + e_diff,
                "T": self.temperature, "V": v, "P": self.target_pressure,
                "G": e_ein + e_diff + self.target_pressure * v}


@dataclass(frozen=True)
class TI(TISpring):
    """Equilibrium TI at a fixed lambda (ref: src/integrate/ensemble_ti.cu):
    the mixed force under the global Langevin thermostat; ti.csv rows
    (pe/N, espring/N) integrate dF/dlambda over runs on a lambda grid.

    run.in: ensemble ti lambda x temp T [tperiod tau] spring El k ...
    """

    lam: float = 0.0

    csv_name = "ti.csv"
    csv_header = "pe,espring\n"
    yaml_name = None

    def init(self, state: MDState):
        if self.spring_k is None:
            raise ValueError("ti: spring constants are required")
        return {**super().init(state), "lambda": self.lam}

    def step2(self, state: MDState, aux, dt):
        disp = state.box.minimum_image(state.position - aux["x0"])
        d2 = torch.sum(disp * disp, dim=-1) * state.mask
        pe = torch.sum(state.potential_energy * state.mask)
        espring = torch.sum(0.5 * aux["k"] * d2)
        f = ((1.0 - self.lam) * state.force
             - self.lam * aux["k"][:, None] * disp)
        state = state._replace(force=f * state.mask[:, None])
        state = velocity_verlet_step2(state, dt, self.mobile)
        return self._kick(state, aux), {**aux, "i": aux["i"] + 1, "pe": pe,
                                        "espring": espring}

    def observe(self, state: MDState, aux):
        return (aux["pe"], aux["espring"])

    def csv_rows(self, obs, n):
        pe, es = (_host(o) for o in obs)
        for r in range(len(pe)):
            yield f"{pe[r] / n:e},{es[r] / n:e}\n"


@dataclass(frozen=True)
class TIRS(MTTK):
    """Reversible-scaling TI (ref: src/integrate/ensemble_ti_rs.cu): MTTK
    NPT with the Hamiltonian (forces, virial, target pressure) scaled by
    lambda(t), from 1 to lambda_f = T_start / T_max and back; one run
    gives F(T) over [T_start, T_max].  ti_rs.csv rows: lambda, dlambda,
    enthalpy/N.

    run.in: ensemble ti_rs temp T Tmax iso|aniso|tri P
            [tperiod x] [pperiod x] [tswitch n] [tequil n]
    """

    t_max: float = 0.0
    t_switch: int = -1
    t_equil: int = -1

    csv_name = "ti_rs.csv"
    csv_header = "lambda,dlambda,enthalpy\n"
    yaml_name = None

    @property
    def lambda_f(self):
        return self.t_start / self.t_max

    def _switch(self, x):  # ref: ensemble_ti_rs.cu:283-289
        return 1.0 / (1.0 + x * (1.0 / self.lambda_f - 1.0))

    def _dswitch(self, x, ts):
        a = 1.0 / self.lambda_f - 1.0
        return -(a / (1.0 + a * x) ** 2) / ts

    def _lambda_update(self, aux):
        ts, te = schedule(self.n_steps, self.t_switch, self.t_equil)
        leg1, leg2, x1, x2 = _legs(aux["i"], ts, te, inclusive=False)
        if leg1:
            return self._switch(x1), self._dswitch(x1, ts)
        if leg2:
            return self._switch(x2), -self._dswitch(x2, ts)
        return aux["lambda"], 0.0

    def init(self, state: MDState):
        v = state.velocity
        return {**super().init(state), "lambda": 1.0, "dlambda": 0.0,
                "pe": torch.zeros((), dtype=v.dtype, device=v.device),
                "vol": state.box.volume.to(v.dtype)}

    def _p_target(self, aux):
        # the target pressure scales with lambda (ref: get_target_pressure)
        pt, hydro = super()._p_target(aux)
        return pt * aux["lambda"], hydro * aux["lambda"]

    def step2(self, state: MDState, aux, dt):
        lam, dlam = self._lambda_update(aux)
        aux = {**aux, "lambda": lam, "dlambda": dlam,
               "pe": torch.sum(state.potential_energy * state.mask),
               "vol": state.box.volume.to(state.velocity.dtype)}
        state = state._replace(force=state.force * lam,
                               virial=state.virial * lam)
        return super().step2(state, aux, dt)

    def observe(self, state: MDState, aux):
        return (aux["lambda"], aux["dlambda"], aux["pe"], aux["vol"])

    def csv_rows(self, obs, n):
        lam, dlam, pe, vol = (_host(o) for o in obs)
        p0 = self.p_start[0][0] / PRESSURE_UNIT_CONVERSION
        for r in range(len(lam)):
            if dlam[r] != 0.0:
                h = (pe[r] + p0 * vol[r]) / n
                yield f"{lam[r]:e},{dlam[r]:e},{h:e}\n"


@dataclass(frozen=True)
class TIAS(MTTK):
    """Adiabatic-switching TI over pressure (ref: ensemble_ti_as.cu): MTTK
    NPT whose diagonal target ramps p_min -> p_max and back; G(p) follows
    from V dp along the ramp.  ti_as.csv rows: p, V/N.

    run.in: ensemble ti_as temp T press pmin pmax [iso P] [tperiod x]
            [pperiod x] [tswitch n] [tequil n]
    """

    p_min: float = 0.0  # GPa
    p_max: float = 0.0  # GPa
    t_switch: int = -1
    t_equil: int = -1

    csv_name = "ti_as.csv"
    csv_header = "p,V\n"
    yaml_name = None

    def _pp(self, aux):
        """The diagonal target in eV/A^3 and whether the step is in a leg
        (ref: ensemble_ti_as.cu get_target_pressure; the backward leg
        subtracts the equilibration offset, so the ramp returns exactly to
        p_min, as in the JAX package)."""
        ts, te = schedule(self.n_steps, self.t_switch, self.t_equil)
        t = float(aux["i"])
        r = 1.0 / max(ts - 1, 1)
        pmin = self.p_min / PRESSURE_UNIT_CONVERSION
        pmax = self.p_max / PRESSURE_UNIT_CONVERSION
        leg1 = 0 <= t < ts
        leg2 = te + ts <= t <= te + 2 * ts
        if ts <= t < te + ts:  # hold at p_max between the legs
            pp = pmax
        elif leg1:
            pp = pmin + t * r * (pmax - pmin)
        elif leg2:
            pp = pmax - min(max((t - ts - te) * r, 0.0), 1.0) * (pmax - pmin)
        else:
            pp = pmin
        return pp, leg1 or leg2

    def _p_target(self, aux):
        pt = np.eye(3) * self._pp(aux)[0]
        return pt, pt

    def init(self, state: MDState):
        return {**super().init(state),
                "vol": state.box.volume.to(state.velocity.dtype)}

    def step2(self, state: MDState, aux, dt):
        aux = {**aux, "vol": state.box.volume.to(state.velocity.dtype)}
        return super().step2(state, aux, dt)

    def observe(self, state: MDState, aux):
        pp, inleg = self._pp(aux)
        return (pp, aux["vol"], inleg)

    def csv_rows(self, obs, n):
        pp, vol, inleg = (_host(o) for o in obs)
        for r in range(len(pp)):
            if inleg[r]:
                yield f"{pp[r] * PRESSURE_UNIT_CONVERSION:e},{vol[r] / n:e}\n"


def uf_pair(state: MDState, temperature: float, sigma_sqrd: float,
            p_uf: float, block: int = UF_BLOCK):
    """Per-atom Uhlenbeck-Ford energies (N,) and forces (N, 3), all pairs
    under the minimum image in row blocks (ref: calc_UF_force,
    ensemble_ti_liquid.cu:38-96): beta u(r) = -p ln(1 - exp(-r^2/s^2)),
    x = r^2 / s^2 clipped to [1e-12, 60]."""
    pos, mask = state.position, state.mask
    n = pos.shape[0]
    beta = 1.0 / (K_B * temperature)
    pref_f = -2.0 * p_uf / (beta * sigma_sqrd)
    energies, forces = [], []
    for lo in range(0, n, block):
        rows = torch.arange(lo, min(lo + block, n), device=pos.device)
        valid = mask[rows] > 0
        disp = state.box.minimum_image(pos[None, :, :] - pos[rows][:, None])
        d2 = torch.sum(disp * disp, dim=-1)
        pair = valid[:, None] & (mask[None, :] > 0) & (d2 > 1e-9)
        x = torch.clamp(d2 / sigma_sqrd, 1e-12, 60.0)
        zero = torch.zeros_like(x)
        fac = torch.where(pair, pref_f / torch.expm1(x), zero)
        e = torch.where(pair, -(p_uf / beta) * torch.log1p(-torch.exp(-x)),
                        zero)
        forces.append(torch.einsum("bn,bnx->bx", fac, disp))
        energies.append(0.5 * torch.sum(e, dim=1))
    return torch.cat(energies), torch.cat(forces)


@dataclass(frozen=True)
class TILiquid(TISpring):
    """ti_liquid: nonequilibrium switching to the Uhlenbeck-Ford fluid
    (ref: src/integrate/ensemble_ti_liquid.cu:1-528), the purely repulsive
    pair fluid beta u(r) = -p ln(1 - exp(-r^2 / sigma^2)) whose excess
    free energy is tabulated over the reduced density
    x = (pi sigma^2)^{3/2} rho / 2.  The run mixes
    (1 - lambda) f_pot + lambda f_UF under the global Langevin thermostat
    with ti_spring's schedule, accumulates E_diff = 1/2 integral
    (U - U_UF) |dlambda| / N, and adds E_ref = (F_UF + F_ideal gas) / N
    at the end (ref destructor, :284-387).

    run.in: ensemble ti_liquid temp T [tperiod tau] [tswitch n tequil n]
            [press P] [sigmasqrd s2] [p P_UF]
    """

    sigma_sqrd: float = 2.0  # sigma^2 (A^2)
    p_uf: float = 50.0  # the UF softness p: 1, 25, 50, 75 or 100

    csv_name = "ti_liquid.csv"
    csv_header = "lambda,dlambda,pe,eUF\n"
    yaml_name = "ti_liquid.yaml"

    def init(self, state: MDState):
        v = state.velocity
        return {**self._common(state),
                "euf": torch.zeros((), dtype=v.dtype, device=v.device)}

    def _uf_pair(self, state: MDState):
        return uf_pair(state, self.temperature, self.sigma_sqrd, self.p_uf)

    def step2(self, state: MDState, aux, dt):
        lam, dlam, in_leg = self._lambda(aux["i"], aux["lambda"])
        e_uf_atom, f_uf = self._uf_pair(state)
        pe = torch.sum(state.potential_energy * state.mask)
        euf = torch.sum(e_uf_atom * state.mask)
        f = (1.0 - lam) * state.force + lam * f_uf
        state = state._replace(force=f * state.mask[:, None])
        state = velocity_verlet_step2(state, dt, self.mobile)
        return self._kick(state, aux), {
            **aux, "i": aux["i"] + 1, "lambda": lam, "dlambda": dlam,
            "e_diff": self._e_diff(aux, pe, euf, dlam, in_leg), "pe": pe,
            "euf": euf}

    def observe(self, state: MDState, aux):
        return (aux["lambda"], aux["dlambda"], aux["pe"], aux["euf"])


    @staticmethod
    def _fe_uf(x, coef, sum_spline, index):
        """The spline-integrated UF excess free energy (kT a atom) at the
        reduced density x (ref: Ensemble_TI_Liquid::fe, :205-240)."""
        if x < 0.0025:
            return coef[0] * x * x / 2.0 + coef[1] * x
        if x < 0.1:
            if int(x * 10000) % 25 == 0:
                return sum_spline[index - 1]
            x0 = 0.0025 * int(x * 400)
        elif x < 1:
            if int(x * 1000) % 25 == 0:
                return sum_spline[index - 1]
            x0 = 0.025 * int(x * 40)
        elif x < 4:
            if int(x * 100) % 10 == 0:
                return sum_spline[index - 1]
            x0 = 0.1 * int(x * 10)
        else:
            return sum_spline[index]
        return (sum_spline[index - 1] + coef[0] * (x * x - x0 * x0) / 2.0
                + coef[1] * (x - x0) + (coef[2] - 1.0) * np.log(x / x0)
                - coef[3] * (1.0 / x - 1.0 / x0))

    def free_energy(self, state: MDState, aux) -> dict:
        kt = K_B * self.temperature
        mask = _host(state.mask) > 0
        mass = _host(state.mass).astype(np.float64)[mask]
        types = _host(state.type)[mask]
        n = int(mask.sum())
        v = float(state.box.volume) / n  # volume a atom; rho = 1/v
        x_uf = (np.pi * self.sigma_sqrd) ** 1.5 / (2.0 * v)
        if x_uf < 0.1:
            index = int(x_uf * 400)
        elif x_uf < 1:
            index = 40 + int(x_uf * 40 - 4)
        elif x_uf < 4:
            index = 76 + int(x_uf * 10 - 10)
        else:
            index = 105
        tab = np.load(UF_SPLINE)
        pkey = int(round(self.p_uf))
        f_uf = self._fe_uf(x_uf, tab[f"spline{pkey}"][index],
                           tab[f"sum_spline{pkey}"], index) * kt * n
        # the ideal gas: N kT (ln rho - 1 + sum_c c ln c)
        #                + 3 kT sum_i ln(hbar sqrt(2 pi / m_i kT))
        de_broglie = float(np.sum(np.log(
            HBAR * np.sqrt(2.0 * np.pi / (mass * kt)))))
        c_sum = 0.0
        for tt in np.unique(types):
            c = float((types == tt).sum()) / n
            if c > 0:
                c_sum += c * np.log(c)
        f_ig = n * kt * (np.log(1.0 / v) - 1.0 + c_sum) + 3.0 * kt * de_broglie
        e_ref = (f_uf + f_ig) / n
        e_diff = float(aux["e_diff"])
        return {"E_UFmodel": e_ref, "ES_diff": e_diff, "F": e_ref + e_diff,
                "T": self.temperature, "V": v, "P": self.target_pressure,
                "G": e_ref + e_diff + self.target_pressure * v}
