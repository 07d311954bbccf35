"""MTTK (Martyna-Tobias-Klein) ensembles: nvt_mttk, npt_mttk, nph_mttk and
the NPT Hugoniostat nphug.

Counterpart of gpumd_tpu/integrate/ensembles/mttk.py: a Nose-Hoover-chain
thermostat and a Parrinello-Rahman-style barostat with the whole
triclinic cell as a dynamical variable, in the reference's operator
splitting (ref: src/integrate/ensemble_mttk.cu:1-917; Shinoda2004 Eq. (1),
Parrinello1981 Eq. (2.24)):

  step1: pchain -> tchain -> omega_dot(+dt/2) -> nh_v_press
         -> VV half kick -> box(dt/2) -> VV drift -> box(dt/2)
  step2: VV half kick -> nh_v_press -> omega_dot(+dt/2)
         -> tchain -> pchain

The chains, omega_dot and the cell's Trotter ladder are scalars: they are
integrated on the host in float64, as the reference integrates them on
the CPU.  A half step reads from the card, in one copy, the kinetic and
virial tensors and the cell (nvt_mttk: twice the kinetic energy only;
nphug's first half step also the potential energy): two reads a step.
The card applies what the host computed: the velocity scale, the
cell-coupled velocity map (nh_v_press, per component as the JAX package
writes it) and the affine remap of positions through the old fractional
coordinates, with the new cell written into a device tensor element by
element (npt.py's _vec3: no copy from host memory, which would wait for
the card).

The JAX package computes the target temperature in float32 (its step
fraction is float32, and the products with it stay float32: kB T and the
chain masses); the host keeps those roundings (numpy float32 scalars), so
both packages integrate the same chains.

run.in syntax (parsed in app/gpumd.py):
  ensemble npt_mttk temp T1 T2 [tperiod tau] iso|aniso|tri P1 P2 [pperiod tau]
  ensemble npt_mttk temp T1 T2 x P1 P2 y P1 P2 z P1 P2 [xy ..][xz ..][yz ..]
  ensemble nvt_mttk temp T1 T2 [tperiod tau]
  ensemble nph_mttk iso|aniso|tri P1 P2 [pperiod tau]
Pressures in GPa; tperiod/pperiod in time steps (default 100/1000).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.integrate.ensembles.npt import _vec3
from gpumd_tpu_torch.integrate.verlet import (
    velocity_verlet_step1,
    velocity_verlet_step2,
)
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import K_B, PRESSURE_UNIT_CONVERSION

TCHAIN = 4
PCHAIN = 4

NONE, XYZ, XY, YZ, XZ = 0, 1, 2, 3, 4


def inv3_host(h: np.ndarray) -> np.ndarray:
    """The 3x3 inverse through the adjugate, as model/box.py's inv3."""
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    bxc, cxa, axb = np.cross(b, c), np.cross(c, a), np.cross(a, b)
    return np.stack([bxc, cxa, axb]) / np.sum(a * bxc)


def volume_host(h: np.ndarray) -> float:
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    return abs(float(np.sum(a * np.cross(b, c))))


def affine_remap(x: torch.Tensor, m_inv: np.ndarray, m_new: np.ndarray):
    """x -> m_new (m_inv x) per component, with host coefficients: the
    JAX package's remap through the old fractional coordinates."""
    f = [m_inv[k, 0] * x[:, 0] + m_inv[k, 1] * x[:, 1] + m_inv[k, 2] * x[:, 2]
         for k in range(3)]
    return torch.stack([m_new[k, 0] * f[0] + m_new[k, 1] * f[1]
                        + m_new[k, 2] * f[2] for k in range(3)], dim=-1)


class Reading:
    """One half step's read of the state: the kinetic tensor sum m v v^T,
    the virial sum, the cell h, and (when asked) the potential energy, as
    host float64 numpy values."""

    def __init__(self, state: MDState, tensors: bool = True,
                 pe: bool = False):
        m = state.mass * state.mask
        parts = []
        if tensors:
            parts += [torch.einsum("n,na,nb->ab", m, state.velocity,
                                   state.velocity).reshape(-1),
                      torch.einsum("nab,n->ab", state.virial,
                                   state.mask).reshape(-1),
                      state.box.h.to(state.velocity.dtype).reshape(-1)]
        else:
            parts.append(torch.sum(m * torch.sum(state.velocity ** 2,
                                                 dim=-1)).reshape(1))
        if pe:
            parts.append(torch.sum(state.potential_energy
                                   * state.mask).reshape(1))
        vals = np.asarray(torch.cat(parts).tolist(), np.float64)
        if tensors:
            self.kin = vals[:9].reshape(3, 3)
            self.w = vals[9:18].reshape(3, 3)
            self.h = vals[18:27].reshape(3, 3)
            self.ke2 = float(np.trace(self.kin))
        else:
            self.kin = self.w = self.h = None
            self.ke2 = float(vals[0])
        self.pe = float(vals[-1]) if pe else None


@dataclass(frozen=True)
class MTTK:
    """MTTK integrator.  The static configuration mirrors the reference's
    parsed flags; the chains and the cell velocity ride in aux."""

    # thermostat
    use_thermostat: bool = False
    t_start: float = 300.0
    t_stop: float = 300.0
    t_period: float = 100.0  # time steps
    # barostat
    use_barostat: bool = False
    p_start: Tuple[Tuple[float, ...], ...] = ((0.0,) * 3,) * 3  # GPa
    p_stop: Tuple[Tuple[float, ...], ...] = ((0.0,) * 3,) * 3  # GPa
    p_flag: Tuple[Tuple[bool, ...], ...] = ((False,) * 3,) * 3
    p_period: float = 1000.0  # time steps
    couple_type: int = NONE
    non_hydrostatic: bool = False
    need_scale: Tuple[Tuple[bool, ...], ...] = ((True,) * 3,) * 3
    h0_reset_interval: int = 1000
    n_steps: int = 0  # the run's steps (for the T/P ramps)
    mobile: Optional[object] = None
    pinned: Optional[tuple] = None

    # ---- construction ----------------------------------------------------

    @staticmethod
    def nvt(t_start, t_stop, t_period=100.0, n_steps=0, **kw) -> "MTTK":
        return MTTK(use_thermostat=True, t_start=t_start, t_stop=t_stop,
                    t_period=t_period, n_steps=n_steps, **kw)

    @staticmethod
    def npt(t_start, t_stop, p1, p2, mode="iso", t_period=100.0,
            p_period=1000.0, n_steps=0, **kw) -> "MTTK":
        return MTTK(use_thermostat=True, t_start=t_start, t_stop=t_stop,
                    t_period=t_period, use_barostat=True, p_period=p_period,
                    n_steps=n_steps, **MTTK._baro_config(p1, p2, mode), **kw)

    @staticmethod
    def nph(p1, p2, mode="iso", p_period=1000.0, n_steps=0, **kw) -> "MTTK":
        return MTTK(use_barostat=True, p_period=p_period, n_steps=n_steps,
                    **MTTK._baro_config(p1, p2, mode), **kw)

    @staticmethod
    def _baro_config(p1, p2, mode):
        """iso/aniso/tri hydrostatic modes (ref: ensemble_mttk.cu:133-160);
        p1/p2 scalars (hydrostatic) or dicts {component: (start, stop)}
        over {x, y, z, xy, xz, yz} for non-hydrostatic runs."""
        ps, pe = np.zeros((3, 3)), np.zeros((3, 3))
        flag = np.zeros((3, 3), bool)
        scale = np.ones((3, 3), bool)
        couple, nonhydro = NONE, False
        if isinstance(p1, dict):
            comp = {"x": (0, 0), "y": (1, 1), "z": (2, 2),
                    "xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}
            for k, (a, b) in p1.items():
                i, j = comp[k]
                ps[i, j] = ps[j, i] = a
                pe[i, j] = pe[j, i] = (p2[k][1] if isinstance(p2, dict)
                                       else b)
                flag[i, j] = flag[j, i] = True
                if i != j:
                    scale[i, j] = scale[j, i] = False
            nonhydro = True
        else:
            for d in range(3):
                ps[d, d], pe[d, d], flag[d, d] = p1, p2, True
            if mode == "iso":
                couple = XYZ
            if mode == "tri":
                off = ~np.eye(3, dtype=bool)
                flag[off], scale[off] = True, False
        return dict(p_start=tuple(map(tuple, ps)),
                    p_stop=tuple(map(tuple, pe)),
                    p_flag=tuple(map(tuple, flag.tolist())),
                    need_scale=tuple(map(tuple, scale.tolist())),
                    couple_type=couple, non_hydrostatic=nonhydro)

    # ---- targets ---------------------------------------------------------

    def _delta(self, aux) -> np.float32:
        """The run's fraction done, float32 as in the JAX package."""
        if self.n_steps <= 0:
            return np.float32(0.0)
        return np.float32(aux["i"]) / np.float32(self.n_steps)

    def _t_target(self, aux):
        """The target temperature as a numpy scalar of the JAX package's
        precision (float32 here)."""
        f32 = np.float32
        return f32(self.t_start) + f32(self.t_stop - self.t_start) * \
            self._delta(aux)

    def _p_target(self, aux):
        """(target stress, its hydrostatic part) in eV/A^3, host 3x3."""
        ps = np.asarray(self.p_start, np.float64) / PRESSURE_UNIT_CONVERSION
        pe = np.asarray(self.p_stop, np.float64) / PRESSURE_UNIT_CONVERSION
        pt = ps + (pe - ps) * float(self._delta(aux))
        return pt, np.trace(pt) / 3.0 * np.eye(3)

    def _kt_baro(self, aux) -> float:
        t = float(self._t_target(aux))
        return K_B * (aux["t_baro"] if t < 1.0 else t)

    # ---- the read's quantities -------------------------------------------

    def _pressure(self, kin: np.ndarray, w: np.ndarray,
                  vol: float) -> np.ndarray:
        """The stress tensor in eV/A^3 (kinetic + virial), symmetrized and
        coupled (ref: ensemble_mttk.cu get_pressure)."""
        p = (kin + w) / vol
        p = 0.5 * (p + p.T)
        if self.couple_type != NONE:
            d = np.diagonal(p).copy()
            pairs = {XYZ: (0, 1, 2), XY: (0, 1), YZ: (1, 2), XZ: (0, 2)}
            idx = pairs[self.couple_type]
            avg = (d[0] + d[1] + d[2]) / 3.0 if len(idx) == 3 else \
                0.5 * (d[idx[0]] + d[idx[1]])
            newd = d.copy()
            newd[list(idx)] = avg
            p = p - np.diag(d) + np.diag(newd)
        return p

    # ---- the chains ------------------------------------------------------

    def _nhc_temp(self, ke2: float, aux, dt):
        """Thermostat chain half update -> velocity scale factor
        (ref: ensemble_mttk.cu:622-654 nhc_temp_integrate)."""
        dt2, dt4, dt8 = dt / 2, dt / 4, dt / 8
        tt = self._t_target(aux)
        one = tt.dtype.type
        kt_s = one(K_B) * tt  # kB T at the target's precision
        dof = aux["dof"]
        t_freq = 1.0 / (self.t_period * dt)
        q = float(kt_s / one(t_freq * t_freq))
        q0 = q * dof
        qn = [q0] + [q] * (TCHAIN - 1)
        kt, t_t = float(kt_s), float(tt)
        eta_dot = list(aux["eta_dot"])
        t_current = ke2 / (dof * K_B)

        def g_of(n, g0):
            return g0 if n == 0 else (qn[n - 1] * eta_dot[n - 1] ** 2
                                      - kt) / qn[n]

        g0 = dof * K_B * (t_current - t_t) / q0
        for n in range(TCHAIN - 1, -1, -1):
            expfac = math.exp(-dt8 * eta_dot[n + 1])
            eta_dot[n] = (expfac * eta_dot[n] + g_of(n, g0) * dt4) * expfac
        factor = math.exp(-dt2 * eta_dot[0])
        t_current = t_current * factor * factor
        g0 = dof * K_B * (t_current - t_t) / q0
        for n in range(TCHAIN):
            expfac = math.exp(-dt8 * eta_dot[n + 1])
            eta_dot[n] = (expfac * eta_dot[n] + g_of(n, g0) * dt4) * expfac
        # eta positions: only the conserved quantity's diagnostics
        eta = [e + dt2 * ed for e, ed in zip(aux["eta"], eta_dot)]
        return factor, {**aux, "eta_dot": eta_dot, "eta": eta}

    def _omega_mass(self, aux, dt):
        kt = self._kt_baro(aux)
        p_freq = 1.0 / (self.p_period * dt)
        return kt, (aux["n"] + 1.0) * kt / (p_freq * p_freq), \
            kt / (p_freq * p_freq)

    def _nhc_press(self, aux, dt):
        """Barostat chain half update acting on omega_dot
        (ref: ensemble_mttk.cu:656-726 nhc_press_integrate)."""
        dt2, dt4, dt8 = dt / 2, dt / 4, dt / 8
        kt, omega_mass, qp = self._omega_mass(aux, dt)
        od = aux["omega_dot"]
        epd = list(aux["eta_p_dot"])
        flag = np.asarray(self.p_flag)
        upper = [(i, j) for i in range(3) for j in range(3)
                 if i <= j and flag[i, j]]
        cell_dof = 1 if self.couple_type == XYZ else len(upper)
        ke_cur = 0.0
        for i, j in upper:
            ke_cur = ke_cur + omega_mass * od[i, j] ** 2
        ke_target = cell_dof * kt

        def g_of(n, g0):
            return g0 if n == 0 else (qp * epd[n - 1] ** 2 - kt) / qp

        g0 = (ke_cur - ke_target) / qp
        for n in range(PCHAIN - 1, -1, -1):
            expfac = math.exp(-dt8 * epd[n + 1])
            epd[n] = (epd[n] * expfac + g_of(n, g0) * dt4) * expfac
        factor = math.exp(-dt2 * epd[0])
        od = np.where(flag, od * factor, od)
        ke_cur = float(np.sum(flag * omega_mass * od ** 2))
        g0 = (ke_cur - ke_target) / qp
        for n in range(PCHAIN):
            expfac = math.exp(-dt8 * epd[n + 1])
            epd[n] = (epd[n] * expfac + g_of(n, g0) * dt4) * expfac
        return {**aux, "omega_dot": od, "eta_p_dot": epd}

    # ---- the barostat ----------------------------------------------------

    def _omega_dot_update(self, rd: Reading, aux, dt):
        """omega_dot += dt/2 V (p_current - p_hydro [- deviatoric]) / W
        (ref: ensemble_mttk.cu:500-521 nh_omega_dot)."""
        vol = volume_host(rd.h)
        p_cur = self._pressure(rd.kin, rd.w, vol)
        p_target, p_hydro = self._p_target(aux)
        _, omega_mass, _ = self._omega_mass(aux, dt)
        f_omega = vol * (p_cur - p_hydro)
        if self.non_hydrostatic:
            # sigma = V_ref h_ref_inv (S - p_hydro) h_ref_inv^T
            hri = aux["h_ref_inv"]
            sigma = aux["vol_ref"] * (hri @ (p_target - p_hydro) @ hri.T)
            f_omega = f_omega - rd.h @ sigma @ rd.h.T
        flag = np.asarray(self.p_flag, np.float64)
        return {**aux, "omega_dot": aux["omega_dot"]
                + flag * (f_omega / omega_mass) * (dt / 2)}

    def _nh_v_press(self, state: MDState, aux, dt) -> MDState:
        """The velocities' coupling to the cell motion (ref:
        gpu_nh_v_press): host coefficients, per component on the card."""
        od = aux["omega_dot"]
        dt4, dt2 = dt / 4, dt / 2
        f = [math.exp(-dt4 * od[k, k]) for k in range(3)]
        v0 = state.velocity
        v = [v0[:, k] * f[k] for k in range(3)]
        vx = v[0] - dt2 * (v[1] * od[0, 1] + v[2] * od[0, 2])
        vy = v[1] - dt2 * (vx * od[1, 0] + v[2] * od[1, 2])
        vz = v[2] - dt2 * (vx * od[2, 0] + vy * od[2, 1])
        v = torch.stack([vx * f[0], vy * f[1], vz * f[2]], dim=-1)
        if self.mobile is not None:
            v = torch.where(self.mobile[:, None] > 0, v, v0)
        return state._replace(velocity=v * state.mask[:, None])

    def _box_ladder(self, h: np.ndarray, od: np.ndarray, dt) -> np.ndarray:
        """h advanced by dt/2: the symmetric Trotter ladder over the cell
        (ref: ensemble_mttk.cu:523-599 propagate_box*), on the host."""
        h = h.copy()
        dt2, dt4, dt8, dt16 = dt / 2, dt / 4, dt / 8, dt / 16
        flag = np.asarray(self.p_flag)
        scale_f = np.asarray(self.need_scale)
        exp = math.exp

        def upd02():
            e = exp(dt16 * od[0, 0])
            h[0, 2] = (h[0, 2] * e + dt8 * (od[0, 1] * h[1, 2]
                                            + od[0, 2] * h[2, 2])) * e

        def upd12():
            e = exp(dt8 * od[1, 1])
            h[1, 2] = (h[1, 2] * e + dt4 * (od[1, 0] * h[0, 2]
                                            + od[1, 2] * h[2, 2])) * e

        def upd20():
            e = exp(dt16 * od[2, 2])
            h[2, 0] = (h[2, 0] * e + dt8 * (od[2, 0] * h[0, 0]
                                            + od[2, 1] * h[1, 0])) * e

        def upd10():
            e = exp(dt8 * od[1, 1])
            h[1, 0] = (h[1, 0] * e + dt4 * (od[1, 0] * h[0, 0]
                                            + od[1, 2] * h[2, 0])) * e

        def upd21():
            e = exp(dt16 * od[2, 2])
            h[2, 1] = (h[2, 1] * e + dt8 * (od[2, 0] * h[0, 1]
                                            + od[2, 1] * h[1, 1])) * e

        def upd01():
            e = exp(dt8 * od[0, 0])
            h[0, 1] = (h[0, 1] * e + dt4 * (od[0, 1] * h[1, 1]
                                            + od[0, 2] * h[2, 1])) * e

        def off_diag():
            for ok, fn in ((flag[0][2], upd02), (flag[1][2], upd12),
                           (flag[0][2], upd02), (flag[2][0], upd20),
                           (flag[1][0], upd10), (flag[2][0], upd20),
                           (flag[2][1], upd21), (flag[0][1], upd01),
                           (flag[2][1], upd21)):
                if ok:
                    fn()

        off_diag()
        for d in range(3):
            e = exp(dt4 * od[d, d])
            others = [k for k in range(3) if k != d]
            h[d, d] = (h[d, d] * e + dt2 * sum(od[d, k] * h[k, d]
                                               for k in others)) * e
            for k in others:
                if scale_f[k][d]:
                    h[k, d] = h[k, d] * e
        off_diag()
        return h

    def _propagate_box(self, state: MDState, h_old: np.ndarray, aux, dt):
        """The cell by dt/2 and the positions' affine remap through their
        old fractional coordinates; returns (state, the new host h)."""
        h = self._box_ladder(h_old, aux["omega_dot"], dt)
        hinv_old = inv3_host(h_old)
        box = state.box.with_h(_vec3(h.reshape(-1), state.box.h).view(3, 3))
        up = state.unwrapped_position
        return state._replace(
            position=affine_remap(state.position, hinv_old, h), box=box,
            unwrapped_position=(affine_remap(up, hinv_old, h)
                                if up is not None else None)), h

    def _maybe_reset_href(self, rd: Reading, aux):
        if not (self.non_hydrostatic and self.h0_reset_interval > 0):
            return aux
        if aux["i"] % self.h0_reset_interval:
            return aux
        return {**aux, "h_ref_inv": inv3_host(rd.h),
                "vol_ref": volume_host(rd.h)}

    # ---- the ensemble protocol ------------------------------------------

    def _read(self, state: MDState, pe: bool = False) -> Reading:
        return Reading(state, tensors=self.use_barostat, pe=pe)

    def init(self, state: MDState):
        rd = Reading(state, tensors=True)
        n = float(state.mask.sum())
        t_baro = rd.ke2 / (3.0 * n * K_B)
        if self.use_thermostat:
            t_baro = max(t_baro, self.t_start)
        return {"i": 0, "n": n, "dof": 3.0 * n,
                "eta_dot": [0.0] * (TCHAIN + 1),
                "eta_p_dot": [0.0] * (PCHAIN + 1),
                "omega_dot": np.zeros((3, 3)), "eta": [0.0] * TCHAIN,
                "h_ref_inv": inv3_host(rd.h), "vol_ref": volume_host(rd.h),
                "t_baro": t_baro}

    def step1(self, state: MDState, aux, dt):
        return self._step1(state, aux, dt, self._read(state))

    def _step1(self, state: MDState, aux, dt, rd: Reading):
        if self.use_barostat:
            aux = self._maybe_reset_href(rd, aux)
            aux = self._nhc_press(aux, dt)
        if self.use_thermostat:
            factor, aux = self._nhc_temp(rd.ke2, aux, dt)
            state = state._replace(velocity=state.velocity * factor)
            if rd.kin is not None:
                rd.kin = rd.kin * (factor * factor)
        if self.use_barostat:
            aux = self._omega_dot_update(rd, aux, dt)
            state = self._nh_v_press(state, aux, dt)
        state = velocity_verlet_step1(state, dt, self.mobile, self.pinned,
                                      drift=False)
        h = rd.h
        if self.use_barostat:
            state, h = self._propagate_box(state, h, aux, dt)
        state = velocity_verlet_step1(state, dt, self.mobile, self.pinned,
                                      kick=False)
        if self.use_barostat:
            state, _ = self._propagate_box(state, h, aux, dt)
        return state, aux

    def step2(self, state: MDState, aux, dt):
        state = velocity_verlet_step2(state, dt, self.mobile, self.pinned)
        if self.use_barostat:
            state = self._nh_v_press(state, aux, dt)
        rd = self._read(state)
        if self.use_barostat:
            aux = self._omega_dot_update(rd, aux, dt)
        if self.use_thermostat:
            factor, aux = self._nhc_temp(rd.ke2, aux, dt)
            state = state._replace(velocity=state.velocity * factor)
        if self.use_barostat:
            aux = self._nhc_press(aux, dt)
        return state, {**aux, "i": aux["i"] + 1}

    def conserved(self, state: MDState, aux, dt) -> float:
        """The thermostatted MTTK's conserved quantity (no barostat):
        KE + U + sum 1/2 Q eta_dot^2 + dof kT eta_0 + kT sum eta_n, in eV;
        one read."""
        ke2, pe = torch.stack([
            torch.sum(state.mass * torch.sum(state.velocity ** 2, dim=-1)
                      * state.mask),
            torch.sum(state.potential_energy * state.mask)]).tolist()
        tt = self._t_target(aux)
        kt = float(tt.dtype.type(K_B) * tt)
        dof = aux["dof"]
        q = kt / (1.0 / (self.t_period * dt)) ** 2
        qs = [q * dof] + [q] * (TCHAIN - 1)
        chain = sum(0.5 * qq * e * e for qq, e in zip(qs, aux["eta_dot"]))
        eta = aux["eta"]
        return (0.5 * ke2 + pe + chain + dof * kt * eta[0]
                + kt * sum(eta[1:]))


@dataclass(frozen=True)
class NPHug(MTTK):
    """NPT Hugoniostat (ref: src/integrate/ensemble_nphug.cu): MTTK NPT
    whose thermostat target follows the Hugoniot condition

        dHugo = [1/2 (P + P0)(V0 - V) + E0 - E] / (3 N kB)
        T_target = T_current + dHugo   (floor 1 K)

    P is the uniaxial stress for x|y|z compression or the hydrostatic mean
    for iso/aniso/tri; (P0, V0, E0) default to the state at step 0, E
    includes the kinetic part as U + 1.5 N kB T.  Its first half step's
    read also takes the potential energy: still two reads a step."""

    p0: Optional[float] = None  # eV/A^3
    v0: Optional[float] = None  # A^3
    e0: Optional[float] = None  # eV
    uniaxial: int = -1  # -1 hydrostatic, 0/1/2 = x/y/z

    def _measure(self, rd: Reading, n: float):
        t_cur = rd.ke2 / (3.0 * n * K_B)
        e_cur = rd.pe + 1.5 * n * K_B * t_cur
        vol = volume_host(rd.h)
        p = self._pressure(rd.kin, rd.w, vol)
        p_h = (p[self.uniaxial, self.uniaxial] if self.uniaxial >= 0
               else np.trace(p) / 3.0)
        return t_cur, e_cur, float(p_h), vol

    def _read(self, state: MDState, pe: bool = False) -> Reading:
        return Reading(state, tensors=True, pe=pe)

    def init(self, state: MDState):
        aux = super().init(state)
        rd = Reading(state, tensors=True, pe=True)
        t_cur, e_cur, p_h, vol = self._measure(rd, aux["n"])
        return {**aux,
                "hug_p0": self.p0 if self.p0 is not None else p_h,
                "hug_v0": self.v0 if self.v0 is not None else vol,
                "hug_e0": self.e0 if self.e0 is not None else e_cur,
                "t_hug": t_cur}

    def _t_target(self, aux):
        return np.float64(aux["t_hug"])

    def step1(self, state: MDState, aux, dt):
        rd = self._read(state, pe=True)
        t_cur, e_cur, p_h, vol = self._measure(rd, aux["n"])
        dhugo = ((0.5 * (p_h + aux["hug_p0"]) * (aux["hug_v0"] - vol)
                  + aux["hug_e0"] - e_cur) / (3.0 * aux["n"] * K_B))
        aux = {**aux, "t_hug": max(t_cur + dhugo, 1.0)}
        return self._step1(state, aux, dt, rd)
