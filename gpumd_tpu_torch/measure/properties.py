"""Measured properties: observables computed during run blocks.

Counterpart of gpumd_tpu/measure/properties.py, whose names it keeps (the
tight-binding transport solver `compute_lsqt`, gpumd_tpu/measure/lsqt.py,
is not ported: ROADMAP queue 1, item 8).  The properties follow the
reference Property protocol (ref: src/measure/property.cuh):

  * per-step values are reduced on the state's device (`heat_current_5`,
    `stress_6`, `onsager_flux`, SHC's accumulators) and reach the host a
    block at a time;
  * per-sample work at chunk boundaries runs on the state's device too:
    the neighbour-based measures (RDF, AngularRDF, ADF, OrientOrder) build
    their lists there and bin there, ModalAnalysis projects onto modes held
    there; only histograms, per-atom columns, binned rows or (N, 3) frames
    (MSD, SDC, DOS, IonicConductivity) come back;
  * correlations and transforms run on the host in numpy, in float64, at
    postprocess.

The output files (hac.out, kappa.out, shc.out, msd.out, sdc.out, dos.out,
mvac.out, viscosity.out, rdf.out, onsager.out, angular_rdf.out, adf.out,
orientorder.out, heatmode.out, kappamode.out, ic.out) have the JAX
package's formats.

`session` is duck-typed as in the JAX package: `workdir`, `_n` (the real
atom count), `state.box` (a box of either package) and, for
ModalAnalysis, `_file(name)`.
"""

from __future__ import annotations

import math
import os
from math import factorial
from typing import List, Optional

import numpy as np
import torch

from gpumd_tpu_torch.model.box import num_replicas_for_cutoff
from gpumd_tpu_torch.neighbor.neighbor import build_neighbor_list
from gpumd_tpu_torch.units import (
    K_B,
    KAPPA_UNIT_CONVERSION,
    TIME_UNIT_CONVERSION,
)


def _host(x) -> np.ndarray:
    """A tensor of either package (or an array) as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def heat_current_total(state) -> torch.Tensor:
    """sum_i J_i (3,) of the state's per-atom heat currents, on the card:
    the per-step observer of the HNEMD runs."""
    return torch.sum(state.heat_current * state.mask[:, None], dim=0)


def heat_current_5(state) -> torch.Tensor:
    """System heat current, GPUMD 5-component convention
    (ref: compute_heat.cu: jx_in jx_out jy_in jy_out jz), on the card."""
    w, v, m = state.virial, state.velocity, state.mask
    jx_in = torch.sum((w[:, 0, 0] * v[:, 0] + w[:, 0, 1] * v[:, 1]) * m)
    jx_out = torch.sum(w[:, 0, 2] * v[:, 2] * m)
    jy_in = torch.sum((w[:, 1, 0] * v[:, 0] + w[:, 1, 1] * v[:, 1]) * m)
    jy_out = torch.sum(w[:, 1, 2] * v[:, 2] * m)
    jz = torch.sum((w[:, 2, 0] * v[:, 0] + w[:, 2, 1] * v[:, 1]
                    + w[:, 2, 2] * v[:, 2]) * m)
    return torch.stack([jx_in, jx_out, jy_in, jy_out, jz])


class HAC:
    """compute_hac sample_interval Nc output_interval -> hac.out
    (ref: src/measure/hac.cu).  Green-Kubo: stores J(t), autocorrelates at
    postprocess, writes HAC + running kappa."""

    needs_heat = True

    def __init__(self, sample_interval, nc, output_interval, dt, temperature):
        self.sample_interval = int(sample_interval)
        self.nc = int(nc)
        self.output_interval = int(output_interval)
        self.dt = dt  # natural units per MD step
        self.temperature = temperature
        self.samples: List[np.ndarray] = []
        self.interval = self.sample_interval

    def consume_heat(self, j5_rows, first_global_step):
        """j5_rows: (chunk, 5) heat currents for steps
        first_global_step+1 .. first_global_step+chunk."""
        j5_rows = _host(j5_rows)
        steps = first_global_step + 1 + np.arange(len(j5_rows))
        sel = (steps % self.sample_interval) == 0
        if sel.any():
            self.samples.append(j5_rows[sel])

    def postprocess(self, session):
        heat = np.concatenate(self.samples, axis=0)  # (Nd, 5)
        nd = len(heat)
        nc = min(self.nc, nd)
        hac = np.zeros((nc, 5))
        # GPUMD in/out cross-correlation convention (hac.cu:111-165)
        pair = {0: 1, 1: 0, 2: 3, 3: 2, 4: 4}
        for lag in range(nc):
            a = heat[: nd - lag]
            b = heat[lag:]
            for k in range(5):
                cross = 0.0 if k == 4 else np.sum(a[:, k] * b[:, pair[k]])
                hac[lag, k] = (np.sum(a[:, k] * b[:, k]) + cross) / (nd - lag)
        dt_sample = self.dt * self.sample_interval
        volume = float(session.state.box.volume)
        factor = (dt_sample * 0.5 / (K_B * self.temperature ** 2 * volume)
                  ) * KAPPA_UNIT_CONVERSION
        rtc = np.zeros_like(hac)
        for lag in range(1, nc):
            rtc[lag] = rtc[lag - 1] + (hac[lag - 1] + hac[lag]) * factor
        dt_ps = dt_sample * TIME_UNIT_CONVERSION / 1000.0
        with open(os.path.join(session.workdir, "hac.out"), "a") as f:
            for nd_out in range(nc // self.output_interval):
                c0 = nd_out * self.output_interval
                sl = slice(c0, c0 + self.output_interval)
                h = hac[sl].mean(axis=0)
                r = rtc[sl].mean(axis=0)
                t = (c0 + self.output_interval * 0.5) * dt_ps
                row = [t, *h, *r]
                f.write("".join(f"{x:25.15e}" for x in row) + "\n")


class HNEMDKappa:
    """compute_hnemd output_interval fe_x fe_y fe_z -> kappa.out
    (ref: hnemd_kappa.cu; the driving force is DenseNEPMD.hnemd_fe)."""

    needs_heat = True

    def __init__(self, output_interval, fe, dt, temperature):
        self.output_interval = int(output_interval)
        self.fe = np.asarray(fe, dtype=float)
        self.fe_mag = float(np.linalg.norm(self.fe))
        self.temperature = temperature
        self.interval = self.output_interval
        self._acc = np.zeros(5)
        self._count = 0

    def consume_heat(self, j5_rows, first_global_step):
        j5_rows = _host(j5_rows)
        self._acc += j5_rows.sum(axis=0)
        self._count += len(j5_rows)

    def maybe_output(self, session):
        """Write one kappa.out row for each full output window."""
        while self._count >= self.output_interval:
            volume = float(session.state.box.volume)
            factor = KAPPA_UNIT_CONVERSION / self.output_interval
            factor /= volume * self.temperature * self.fe_mag
            with open(os.path.join(session.workdir, "kappa.out"), "a") as f:
                f.write("".join(f"{x * factor:25.15f}" for x in self._acc)
                        + "\n")
            self._acc = np.zeros(5)
            self._count -= self.output_interval

    def postprocess(self, session):
        pass


class SHC:
    """compute_shc sample_interval Nc direction num_omega max_omega
    [group method id] -> shc.out (ref: src/measure/shc.cu).

    K(t) = <sum_{i in group} W_i[dir, :2] . v_i[:2](t)> (in-plane, ki) and
    the out-of-plane ko; +-Nc lags, Hann window, cosine transform to
    shc_i/o(omega).
    """

    needs_heat = False
    needs_atom_virial = True  # samples W_i rows; dense path must not spread

    def __init__(self, sample_interval, nc, direction, num_omega, max_omega,
                 dt, group_mask=None):
        self.sample_interval = int(sample_interval)
        self.nc = int(nc)
        self.direction = int(direction)
        self.num_omega = int(num_omega)
        self.max_omega = float(max_omega)
        self.dt = dt
        self.group_mask = group_mask  # (N,) numpy or None
        self.interval = self.sample_interval
        self.s_frames: List[np.ndarray] = []
        self.v_frames: List[np.ndarray] = []

    # ---- accumulation on the card ------------------------------------------
    #
    # As the reference (shc.cu, shc.cuh:26-75), ring buffers of the
    # group's per-atom (s, v) and +-Nc-lag correlation sums stay on the
    # card, in float32 as in the JAX package; a sample updates every lag
    # with one (Nc, G, 3) x (G, 3) contraction each way.  The step and
    # sample counts are known on the host, so a step reads nothing back.
    # The correlation pairs equal those of the host path (mean over t of
    # sum_i s_i(t) v_i(t+lag)).

    def device_init(self, session, n, device=None):
        """The accumulators, on `device` (default: the session box's)."""
        if device is None:
            device = session.state.box.h.device
        self.n = int(n)
        if self.group_mask is not None:
            gidx = np.nonzero(_host(self.group_mask)[:n] > 0)[0]
        else:
            gidx = np.arange(n)
        self._gidx = torch.as_tensor(gidx, dtype=torch.int64, device=device)
        self._lags = torch.arange(self.nc, device=device)
        g, nc, f32 = len(gidx), self.nc, torch.float32
        return {
            "step": 0,
            "count": 0,
            "s_ring": torch.zeros((nc, g, 3), dtype=f32, device=device),
            "v_ring": torch.zeros((nc, g, 3), dtype=f32, device=device),
            "kpos": torch.zeros((nc, 3), dtype=f32, device=device),
            "kneg": torch.zeros((nc, 3), dtype=f32, device=device),
            "nvalid": np.zeros(nc, np.int64),
        }

    def device_update(self, macc, state, orig_id):
        """One step: samples every `sample_interval`-th step; `orig_id`
        maps the state's slots to input atoms.  The ring buffers are
        updated in place (a copy a sample would move the whole ring)."""
        step = macc["step"] + 1
        if step % self.sample_interval:
            return {**macc, "step": step}
        nc, count = self.nc, macc["count"]
        inv = torch.zeros(self.n + 1, dtype=torch.int64,
                          device=orig_id.device)
        inv[orig_id.long()] = torch.arange(orig_id.shape[0],
                                           device=orig_id.device)
        slots = inv[self._gidx]
        rdt = macc["s_ring"].dtype
        s_now = state.virial[slots][:, self.direction, :].to(rdt)
        v_now = state.velocity[slots].to(rdt)  # (G, 3)
        pos = count % nc
        s_ring, v_ring = macc["s_ring"], macc["v_ring"]  # updated in place
        s_ring[pos] = s_now
        v_ring[pos] = v_now
        # d[l, c] = sum_g s(ring l) v(now); e[l, c] = sum_g s(now) v(ring l)
        d = torch.einsum("lgc,gc->lc", s_ring, v_now)
        e = torch.einsum("gc,lgc->lc", s_now, v_ring)
        slot_for_lag = (pos - self._lags) % nc
        valid = (self._lags <= count)[:, None]
        valid_h = np.arange(nc) <= count
        return {
            "step": step,
            "count": count + 1,
            "s_ring": s_ring,
            "v_ring": v_ring,
            "kpos": macc["kpos"] + torch.where(valid, d[slot_for_lag], 0.0),
            "kneg": macc["kneg"] + torch.where(valid, e[slot_for_lag], 0.0),
            "nvalid": macc["nvalid"] + valid_h,
        }

    def device_postprocess(self, session, macc):
        kpos = _host(macc["kpos"]).astype(np.float64)
        kneg = _host(macc["kneg"]).astype(np.float64)
        nvalid = np.asarray(macc["nvalid"], np.float64)
        nc = int(np.count_nonzero(nvalid))
        if nc == 0:
            return
        cnt = np.maximum(nvalid[:nc], 1.0)[:, None]
        kp = kpos[:nc] / cnt
        kn = kneg[:nc] / cnt
        ki_pos, ko_pos = kp[:, 0] + kp[:, 1], kp[:, 2]
        ki_neg, ko_neg = kn[:, 0] + kn[:, 1], kn[:, 2]
        ki = np.concatenate([ki_neg[::-1][:-1], ki_pos])
        ko = np.concatenate([ko_neg[::-1][:-1], ko_pos])
        self._write_out(session, ki, ko, nc)

    # ---- host path ----------------------------------------------------------

    def sample_state(self, session, state, step):
        n = session._n
        w = _host(state.virial)[:n]  # (N, 3, 3)
        v = _host(state.velocity)[:n]
        if self.group_mask is not None:
            sel = _host(self.group_mask)[:n] > 0
            w, v = w[sel], v[sel]
        self.s_frames.append(w[:, self.direction, :].copy())
        self.v_frames.append(v.copy())

    def postprocess(self, session):
        if not self.s_frames:  # device path already wrote, or no samples
            return
        s = np.stack(self.s_frames)  # (Nd, G, 3)
        v = np.stack(self.v_frames)
        nd = len(s)
        nc = min(self.nc, nd)
        # ki = sx vx + sy vy, ko = sz vz (x/y/z of the virial row)
        ki_pos = np.zeros(nc)
        ko_pos = np.zeros(nc)
        ki_neg = np.zeros(nc)
        ko_neg = np.zeros(nc)
        for lag in range(nc):
            a_s = s[: nd - lag]
            b_v = v[lag:]
            ki_pos[lag] = np.mean(
                np.sum(a_s[..., 0] * b_v[..., 0] + a_s[..., 1] * b_v[..., 1],
                       axis=1), axis=0)
            ko_pos[lag] = np.mean(
                np.sum(a_s[..., 2] * b_v[..., 2], axis=1), axis=0)
            a_s2 = s[lag:]
            b_v2 = v[: nd - lag]
            ki_neg[lag] = np.mean(
                np.sum(a_s2[..., 0] * b_v2[..., 0]
                       + a_s2[..., 1] * b_v2[..., 1], axis=1), axis=0)
            ko_neg[lag] = np.mean(
                np.sum(a_s2[..., 2] * b_v2[..., 2], axis=1), axis=0)
        # assemble t = -(Nc-1)..(Nc-1)
        ki = np.concatenate([ki_neg[::-1][:-1], ki_pos])
        ko = np.concatenate([ko_neg[::-1][:-1], ko_pos])
        self._write_out(session, ki, ko, nc)

    def _write_out(self, session, ki, ko, nc):
        # natural velocity -> A/ps
        vel_unit = 1000.0 / TIME_UNIT_CONVERSION
        ki = ki * vel_unit
        ko = ko * vel_unit
        dt_ps = self.dt * self.sample_interval * TIME_UNIT_CONVERSION / 1000.0
        t = (np.arange(2 * nc - 1) - (nc - 1)) * dt_ps
        # Hann window + cosine transform (shc.cu:350-395)
        hann = 0.5 * (np.cos(np.pi * (np.arange(2 * nc - 1) + 1 - nc) / nc)
                      + 1.0)
        kiw = ki * hann
        kow = ko * hann
        d_omega = self.max_omega / self.num_omega
        omega = (np.arange(self.num_omega) + 1) * d_omega
        shc_i = 2.0 * dt_ps * np.array(
            [np.sum(kiw * np.cos(w * t)) for w in omega])
        shc_o = 2.0 * dt_ps * np.array(
            [np.sum(kow * np.cos(w * t)) for w in omega])
        h = _host(session.state.box.h)
        with open(os.path.join(session.workdir, "shc.out"), "a") as f:
            f.write(
                f"# compute_shc {self.sample_interval} {self.nc} "
                f"{self.direction} {self.num_omega} {self.max_omega:g}\n"
                "# format_version 1\n"
                f"# num_atoms {session._n}\n"
                "# cell " + " ".join(f"{x:.10e}" for x in h.T.ravel()) + "\n"
                f"# dt_output {dt_ps:.10e} ps\n"
                f"# num_correlation_rows {2 * nc - 1}\n"
                f"# num_frequency_rows {self.num_omega}\n"
                "# columns_correlation time_ps ki ko\n"
                "# columns_shc omega_THz shc_i shc_o\n"
            )
            for i in range(2 * nc - 1):
                f.write(f"{t[i]:g} {ki[i]:g} {ko[i]:g}\n")
            for i in range(self.num_omega):
                f.write(f"{omega[i]:g} {shc_i[i]:g} {shc_o[i]:g}\n")


# ---- frame correlations ------------------------------------------------------


def _frame(x: torch.Tensor) -> np.ndarray:
    """A sampled (N, 3) frame, copied to the host."""
    return _host(x).copy()


def _frames(frames: List[np.ndarray]) -> np.ndarray:
    """The sampled (N, 3) frames as one float64 (T, N, 3) array."""
    return np.stack(frames).astype(np.float64)


def _lag_sums(a: np.ndarray, b: np.ndarray, nc: int) -> np.ndarray:
    """s[lag, c] = sum over t < T - lag and atoms i of a[t, i, c] *
    b[t + lag, i, c], lag < nc: the frame correlations of the JAX package's
    loops over lags, from one (T, T) Gram matrix a component."""
    out = np.zeros((nc, a.shape[2]))
    for c in range(a.shape[2]):
        g = a[:, :, c] @ b[:, :, c].T  # g[s, u] = sum_i a[s, i, c] b[u, i, c]
        out[:, c] = [np.trace(g, offset=lag) for lag in range(nc)]
    return out


def _squared_displacements(x: np.ndarray, nc: int) -> np.ndarray:
    """d[lag, c] = sum over t < T - lag and atoms i of (x[t + lag, i, c] -
    x[t, i, c])^2, lag < nc.  The per-atom time mean is taken out first,
    so the sums of squares carry displacements, not box-sized positions."""
    x = x - x.mean(axis=0, keepdims=True)
    sq = np.sum(x * x, axis=1)  # (T, 3)
    head = np.cumsum(sq, axis=0)  # sum over t <= k
    tail = np.cumsum(sq[::-1], axis=0)  # sum over t >= T - 1 - k
    nt = len(x)
    out = -2.0 * _lag_sums(x, x, nc)
    for lag in range(nc):
        out[lag] += head[nt - 1 - lag] + tail[nt - 1 - lag]
    return out


class MSD:
    """compute_msd sample_interval Nc -> msd.out (all atoms).  SDC columns
    are the MSD slope / 2 (ref: msd.cu writes msd xyz + sdc xyz per
    correlation step)."""

    needs_heat = False

    def __init__(self, sample_interval, nc, dt):
        self.sample_interval = int(sample_interval)
        self.nc = int(nc)
        self.dt = dt
        self.interval = self.sample_interval
        self.frames: List[np.ndarray] = []

    def sample_state(self, session, state, step):
        if state.unwrapped_position is None:
            raise ValueError("compute_msd requires unwrapped positions")
        self.frames.append(_frame(state.unwrapped_position[:session._n]))

    def postprocess(self, session):
        frames = _frames(self.frames)  # (Nd, N, 3)
        nd, n = frames.shape[:2]
        nc = min(self.nc, nd - 1)
        dt_ps = self.dt * self.sample_interval * TIME_UNIT_CONVERSION / 1000.0
        sums = _squared_displacements(frames, nc + 1)[1:]
        msd = sums / ((nd - np.arange(1, nc + 1))[:, None] * n)
        # SDC (A^2/ps): slope / 2 per direction
        sdc = np.zeros_like(msd)
        t = np.arange(1, nc + 1) * dt_ps
        sdc[0] = msd[0] / (2 * t[0])
        sdc[1:] = (msd[1:] - msd[:-1]) / (2 * dt_ps)
        with open(os.path.join(session.workdir, "msd.out"), "a") as f:
            f.write(
                f"# compute_msd {self.sample_interval} {self.nc}\n"
                "# format_version 1\n"
                f"# num_atoms {session._n}\n"
                "# columns time_ps msdx msdy msdz sdcx sdcy sdcz\n"
            )
            for i in range(nc):
                row = [t[i], *msd[i], *sdc[i]]
                f.write(" ".join(f"{x:g}" for x in row) + "\n")


class SDC:
    """compute_sdc sample_interval Nc -> sdc.out: VAC and its running
    integral (ref: sdc.cu)."""

    needs_heat = False

    def __init__(self, sample_interval, nc, dt):
        self.sample_interval = int(sample_interval)
        self.nc = int(nc)
        self.dt = dt
        self.interval = self.sample_interval
        self.frames: List[np.ndarray] = []

    def sample_state(self, session, state, step):
        self.frames.append(_frame(state.velocity[:session._n]))

    def postprocess(self, session):
        v = _frames(self.frames)  # (Nd, N, 3)
        nd, n = v.shape[:2]
        nc = min(self.nc, nd)
        vac = _lag_sums(v, v, nc) / ((nd - np.arange(nc))[:, None] * n)
        dt_sample = self.dt * self.sample_interval
        dt_ps = dt_sample * TIME_UNIT_CONVERSION / 1000.0
        # natural velocity^2 -> A^2/ps^2
        v2unit = (1000.0 / TIME_UNIT_CONVERSION) ** 2
        sdc = np.zeros_like(vac)
        for lag in range(1, nc):
            sdc[lag] = sdc[lag - 1] + (vac[lag - 1] + vac[lag]) * 0.5 * dt_ps
        with open(os.path.join(session.workdir, "sdc.out"), "a") as f:
            for i in range(nc):
                row = [i * dt_ps, *(vac[i] * v2unit), *(sdc[i] * v2unit)]
                f.write(" ".join(f"{x:g}" for x in row) + "\n")


class DOS:
    """compute_dos sample_interval Nc max_omega [num_dos_points n]
    -> mvac.out + dos.out (mass-weighted VAC, discrete cosine transform;
    ref: dos.cu).  max_omega in THz (omega = 2 pi nu)."""

    needs_heat = False

    def __init__(self, sample_interval, nc, max_omega_thz, dt,
                 num_points=None):
        self.sample_interval = int(sample_interval)
        self.nc = int(nc)
        self.max_omega = float(max_omega_thz)
        self.num_points = int(num_points) if num_points else int(nc)
        self.dt = dt
        self.interval = self.sample_interval
        self.frames: List[np.ndarray] = []
        self.masses: Optional[np.ndarray] = None

    def sample_state(self, session, state, step):
        n = session._n
        if self.masses is None:
            self.masses = _host(state.mass[:n]).astype(np.float64)
        self.frames.append(_frame(state.velocity[:n]))

    def postprocess(self, session):
        v = _frames(self.frames)  # (Nd, N, 3)
        nd, n = v.shape[:2]
        nc = min(self.nc, nd)
        mv = self.masses[None, :, None] * v
        vac = _lag_sums(mv, v, nc) / ((nd - np.arange(nc))[:, None] * n)
        vac /= vac[0].sum() / 3.0  # normalized (mvac convention)
        dt_sample_ps = (self.dt * self.sample_interval * TIME_UNIT_CONVERSION
                        / 1000.0)
        t = np.arange(nc) * dt_sample_ps
        with open(os.path.join(session.workdir, "mvac.out"), "a") as f:
            for i in range(nc):
                f.write(" ".join(f"{x:g}" for x in (t[i], *vac[i])) + "\n")
        omega = np.linspace(self.max_omega / self.num_points, self.max_omega,
                            self.num_points)  # THz angular
        # DCT with Hann window, normalized to 3N per direction integral
        hann = 0.5 * (np.cos(np.pi * np.arange(nc) / nc) + 1.0)
        dos = np.zeros((self.num_points, 3))
        for w_i, w in enumerate(omega):
            c = np.cos(w * t) * hann
            dos[w_i] = 2.0 * dt_sample_ps * np.sum(vac * c[:, None],
                                                   axis=0) * n
        with open(os.path.join(session.workdir, "dos.out"), "a") as f:
            for i in range(self.num_points):
                f.write(" ".join(f"{x:g}" for x in (omega[i], *dos[i]))
                        + "\n")


class IonicConductivity:
    """compute_ic sample_int Nc type charge -> ic.out: Nernst-Einstein
    ionic conductivity from the per-type MSD derivative
    (ref: iron_conductivity.cu; factor = q^2 e / (V kB T dt) in S/cm
    units via 1.602176634e7)."""

    def __init__(self, sample_interval, nc, target_type, charge, dt,
                 temperature):
        self.sample_interval = int(sample_interval)
        self.nc = int(nc)
        self.target_type = int(target_type)
        self.charge = float(charge)
        self.dt = dt
        self.temperature = temperature
        self.interval = self.sample_interval
        self.frames: List[np.ndarray] = []
        self._volume = None

    def sample_state(self, session, state, step):
        if state.unwrapped_position is None:
            raise ValueError("compute_ic requires unwrapped positions")
        n = session._n
        sel = state.type[:n] == self.target_type
        self.frames.append(_frame(state.unwrapped_position[:n][sel]))
        # in float64 whatever the state's precision: a float32 cell's own
        # product rounds the volume by ~1e-7, which flips the last of the
        # six digits ic.out prints
        h = state.box.h.detach().double()
        self._volume = float(torch.abs(torch.dot(
            h[:, 0], torch.linalg.cross(h[:, 1], h[:, 2]))))

    def postprocess(self, session):
        frames = _frames(self.frames)  # (Nd, Nt, 3)
        nd = len(frames)
        nc = min(self.nc, nd)
        dt_nat = self.dt * self.sample_interval
        dt_ps = dt_nat * TIME_UNIT_CONVERSION / 1000.0
        # summed (not per-atom-averaged) squared displacement per lag
        msd = _squared_displacements(frames, nc) / (nd - np.arange(nc))[:,
                                                                         None]
        msd[0] = 0.0
        factor = (self.charge ** 2 * 1.602176634e7 * 0.5
                  / (TIME_UNIT_CONVERSION * self._volume * K_B
                     * self.temperature * dt_nat))
        ic = np.zeros((nc, 3))
        ic[1:] = (msd[1:] - msd[:-1]) * factor
        with open(os.path.join(session.workdir, "ic.out"), "a") as f:
            for i in range(nc):
                f.write(f"{i * dt_ps:g} {ic[i, 0]:g} {ic[i, 1]:g} "
                        f"{ic[i, 2]:g}\n")


# ---- per-step observers of the list path ---------------------------------------


def stress_6(state) -> torch.Tensor:
    """Total stress tensor components (xx yy zz xy xz yz), eV (virial +
    kinetic), for Green-Kubo viscosity (ref: viscosity.cu), on the state's
    device."""
    m = state.mask
    kin = torch.einsum("n,na,nb->ab", state.mass * m, state.velocity,
                       state.velocity)
    s = kin + torch.einsum("nab,n->ab", state.virial, m)
    return torch.stack([s[0, 0], s[1, 1], s[2, 2], s[0, 1], s[0, 2],
                        s[1, 2]])


class Viscosity:
    """compute_viscosity sample_interval Nc -> viscosity.out: stress
    autocorrelation and running shear viscosity via Green-Kubo
    eta = V/(kB T) int <s(0) s(t)> dt (ref: src/measure/viscosity.cu)."""

    needs_heat = False
    needs_stress = True

    def __init__(self, sample_interval, nc, dt, temperature):
        self.sample_interval = int(sample_interval)
        self.nc = int(nc)
        self.dt = dt
        self.temperature = temperature
        self.interval = self.sample_interval
        self.samples: List[np.ndarray] = []

    def consume_stress(self, s6_rows, first_global_step):
        s6_rows = _host(s6_rows)
        steps = first_global_step + 1 + np.arange(len(s6_rows))
        sel = (steps % self.sample_interval) == 0
        if sel.any():
            self.samples.append(s6_rows[sel])

    def postprocess(self, session):
        s = np.concatenate(self.samples, axis=0).astype(np.float64)
        # remove mean of diagonal components (pressure offset)
        s = s - s.mean(axis=0, keepdims=True)
        nd = len(s)
        nc = min(self.nc, nd)
        corr = np.zeros((nc, 6))
        for lag in range(nc):
            corr[lag] = np.mean(s[: nd - lag] * s[lag:], axis=0)
        dt_sample = self.dt * self.sample_interval
        volume = float(session.state.box.volume)
        factor = dt_sample / (K_B * self.temperature * volume)
        run = np.zeros_like(corr)
        for lag in range(1, nc):
            run[lag] = run[lag - 1] + 0.5 * (corr[lag - 1] + corr[lag]) * factor
        # natural viscosity unit -> Pa s: eV * (natural time) / A^3
        # = 1.602177e-19 J * 1.018051e-14 s / 1e-30 m^3 = 1.6311e3 Pa s
        run *= 1.602177e-19 * 1.018051e-14 / 1e-30
        dt_ps = dt_sample * TIME_UNIT_CONVERSION / 1000.0
        with open(os.path.join(session.workdir, "viscosity.out"), "a") as f:
            for lag in range(nc):
                row = [lag * dt_ps, *corr[lag], *run[lag]]
                f.write(" ".join(f"{x:g}" for x in row) + "\n")


def onsager_flux(state, mass_type, num_types) -> torch.Tensor:
    """Per-step HNEMDEC fluxes on the state's device: the 3-component
    energy current J = (E_i I + W_i) v_i summed over atoms, then per-type
    mass fluxes m_t sum_{i in t} v_i (ref: hnemdec_kappa.cu:85-148,
    compute_heat.cu:133-166)."""
    w, v, m = state.virial, state.velocity, state.mask
    e_i = 0.5 * state.mass * torch.sum(v ** 2, dim=-1) \
        + state.potential_energy
    j = torch.einsum("nab,nb->na", w, v) + e_i[:, None] * v
    parts = [torch.sum(j * m[:, None], dim=0)]
    for t in range(num_types):
        sel = ((state.type == t) & (m > 0))[:, None]
        parts.append(float(mass_type[t])
                     * torch.sum(torch.where(sel, v, 0.0), dim=0))
    return torch.cat(parts)  # (3 + 3T,)


class HNEMDECOnsager:
    """compute_hnemdec <mode> <output_interval> fe_x fe_y fe_z ->
    onsager.out (ref: hnemdec_kappa.cu:155-241)."""

    needs_onsager = True

    def __init__(self, mode, output_interval, fe, temperature, num_types,
                 factor):
        self.mode = int(mode)
        self.output_interval = int(output_interval)
        self.fe = np.asarray(fe, dtype=float)
        self.fe_mag = float(np.linalg.norm(self.fe))
        self.temperature = float(temperature)
        self.num_types = int(num_types)
        self.factor = float(factor)  # FACTOR normalization
        self.mass_type = None  # set by the keyword
        self.interval = self.output_interval
        self._acc = np.zeros(3 + 3 * num_types)
        self._count = 0

    def consume_onsager(self, rows, first_global_step):
        rows = _host(rows)
        self._acc += rows.sum(axis=0)
        self._count += len(rows)

    def maybe_output(self, session):
        # natural -> 1e-6 kg/smK and 1e-12 kgs/m^3K (ref constants)
        massflux = 1631.0961499964144
        massmass = 16.905134572911963
        while self._count >= self.output_interval:
            volume = float(session.state.box.volume)
            denom = (self.output_interval * volume * self.temperature
                     * self.fe_mag)
            if self.mode == 0:
                f1 = KAPPA_UNIT_CONVERSION / denom
                f2 = massflux * self.factor / denom
            else:
                f1 = massflux * self.factor / denom
                f2 = massmass * self.factor / denom
            cols = list(self._acc[:3] * f1) + list(self._acc[3:] * f2)
            with open(os.path.join(session.workdir, "onsager.out"), "a") as f:
                f.write("".join(f"{x:25.15f}" for x in cols) + "\n")
            self._acc[:] = 0.0
            self._count -= self.output_interval

    def postprocess(self, session):
        pass


# ---- neighbour-based measures --------------------------------------------------


def _neighbors(session, state, rc: float, mn: int):
    """The list of the real atoms at `rc` with `mn` slots, built on the
    state's device (the cell list where the box allows, brute force with
    images otherwise), cut to the widest row's neighbour count: the
    builders put a row's neighbours first, so the slots past it are empty
    in every row.  Returns (r12, mask, idx) and the atom count."""
    n = session._n
    box = state.box
    nbr = build_neighbor_list(state.position[:n], box, state.mask[:n],
                              rc=rc, mn=mn,
                              reps=num_replicas_for_cutoff(box, rc))
    width = int(torch.clamp(nbr.count.max(), max=mn)) if n else 0
    return (nbr.r12[:, :width], nbr.mask[:, :width],
            nbr.idx[:, :width].long(), n)


def _bincount(bins: torch.Tensor, sel: torch.Tensor, nbins: int):
    """Counts of bins[sel] in [0, nbins)."""
    return torch.bincount(torch.where(sel, bins, nbins).reshape(-1),
                          minlength=nbins + 1)[:nbins]


def _pair_types(types: torch.Tensor, idx: torch.Tensor):
    """The types of each slot's centre and neighbour (images fold back)."""
    return types[:, None].expand_as(idx), types[idx % types.shape[0]]


class RDF:
    """compute_rdf r_cut num_bins sample_interval -> rdf.out
    (ref: rdf.cu:215-330): columns radius, total g(r), then one column per
    unordered type pair a-b in type order, like the reference header
    '#radius total A-A A-B B-B'."""

    needs_heat = False

    def __init__(self, r_cut, num_bins, sample_interval, num_types=1,
                 type_names=None):
        self.r_cut = float(r_cut)
        self.num_bins = int(num_bins)
        self.sample_interval = int(sample_interval)
        self.num_types = int(num_types)
        self.type_names = list(type_names or [])
        self.interval = self.sample_interval
        self.pairs = [(a, b) for a in range(self.num_types)
                      for b in range(a, self.num_types)]
        self.hist = np.zeros(self.num_bins)
        self.hist_pair = np.zeros((len(self.pairs), self.num_bins))
        self.n_samples = 0
        self.density = None
        self.type_counts = None

    def sample_state(self, session, state, step):
        r12, mask, idx, n = _neighbors(session, state, self.r_cut, 1024)
        types = state.type[:n]
        nbins = self.num_bins
        d = torch.sqrt(torch.sum(r12 ** 2, dim=-1))
        ri = torch.clamp(torch.floor(d / self.r_cut * nbins).long(), 0,
                         nbins - 1)
        ok = (mask > 0) & (d < self.r_cut)
        hs = [_bincount(ri, ok, nbins)]
        if self.num_types > 1:
            ti, tj = _pair_types(types, idx)
            for a, b in self.pairs:
                sel = ok & (((ti == a) & (tj == b)) | ((ti == b) & (tj == a)))
                hs.append(_bincount(ri, sel, nbins))
        h = _host(torch.stack(hs))  # one read
        self.hist += h[0]
        self.hist_pair[:len(h) - 1] += h[1:]
        self.n_samples += 1
        if self.density is None:
            self.density = n / float(state.box.volume)
            t = _host(types)
            self.type_counts = np.array(
                [(t == k).sum() for k in range(self.num_types)])

    def postprocess(self, session):
        n = session._n
        dr = self.r_cut / self.num_bins
        r = (np.arange(self.num_bins) + 0.5) * dr
        shell = 4.0 * np.pi * r ** 2 * dr
        vol = n / self.density
        ns = max(self.n_samples, 1)
        g = self.hist / ns / n / (shell * self.density)
        gp = []
        for k, (a, b) in enumerate(self.pairs):
            na = max(self.type_counts[a], 1)
            nb = max(self.type_counts[b], 1)
            # ordered-pair count / (N_a N_b / V) per shell; a != b counts
            # both directions -> halve
            norm = 1.0 if a == b else 0.5
            gp.append(self.hist_pair[k] * norm * vol / (ns * na * nb * shell))
        with open(os.path.join(session.workdir, "rdf.out"), "a") as f:
            if self.num_types > 1:
                names = self.type_names or [str(t)
                                            for t in range(self.num_types)]
                head = " ".join(f"{names[a]}-{names[b]}"
                                for a, b in self.pairs)
                f.write(f"#radius total {head}\n")
            for i in range(self.num_bins):
                cols = f"{r[i]:.5f} {g[i]:.5f}"
                if self.num_types > 1:
                    cols += "".join(f" {gk[i]:.5f}" for gk in gp)
                f.write(cols + "\n")


class AngularRDF:
    """compute_angular_rdf r_cut r_bins theta_bins interval [a b]...
    -> angular_rdf.out (ref: angular_rdf.cu:60-660): g(r, theta) with
    theta = atan2(y12, x12) the in-plane bond azimuth, bin volume =
    shell_volume * dtheta/2pi; per-pair columns use the reference's
    symmetrized 1/(N_a rho_b) + 1/(N_b rho_a) normalization."""

    needs_heat = False

    def __init__(self, r_cut, r_bins, theta_bins, sample_interval,
                 pairs=()):
        self.r_cut = float(r_cut)
        self.r_bins = int(r_bins)
        self.t_bins = int(theta_bins)
        self.interval = int(sample_interval)
        self.pairs = [tuple(p) for p in pairs]
        self.hist = np.zeros((self.r_bins, self.t_bins))
        self.hist_pair = np.zeros((len(self.pairs), self.r_bins,
                                   self.t_bins))
        self.n_samples = 0
        self.density = None
        self.type_counts = None

    def sample_state(self, session, state, step):
        r12, mask, idx, n = _neighbors(session, state, self.r_cut, 1024)
        types = state.type[:n]
        # a flat (r, theta) bin index a slot, counted on the device
        nbins = self.r_bins * self.t_bins
        d = torch.sqrt(torch.sum(r12 ** 2, dim=-1))
        theta = torch.atan2(r12[..., 1], r12[..., 0])
        ri = torch.clamp(torch.floor(d / self.r_cut * self.r_bins).long(), 0,
                         self.r_bins - 1)
        tiq = torch.clamp(torch.floor((theta + np.pi) / (2 * np.pi)
                                      * self.t_bins).long(), 0,
                          self.t_bins - 1)
        flat = ri * self.t_bins + tiq
        ok = (mask > 0) & (d < self.r_cut)
        hs = [_bincount(flat, ok, nbins)]
        ti, tj = _pair_types(types, idx)
        for a, b in self.pairs:
            sel = ok & (((ti == a) & (tj == b)) | ((ti == b) & (tj == a)))
            hs.append(_bincount(flat, sel, nbins))
        h = _host(torch.stack(hs)).reshape(-1, self.r_bins, self.t_bins)
        self.hist += h[0]
        self.hist_pair += h[1:]
        self.n_samples += 1
        if self.density is None:
            self.density = n / float(state.box.volume)
            t = _host(types)
            nt = int(t.max()) + 1 if n else 1
            self.type_counts = np.array([(t == k).sum() for k in range(nt)])

    def postprocess(self, session):
        n = session._n
        dr = self.r_cut / self.r_bins
        r_lo = np.arange(self.r_bins) * dr
        r_up = r_lo + dr
        shell = 4.0 / 3.0 * np.pi * (r_up ** 3 - r_lo ** 3)
        bin_vol = shell[:, None] * (1.0 / self.t_bins)  # dtheta/2pi
        r_c = r_lo + 0.5 * dr
        t_c = -np.pi + (np.arange(self.t_bins) + 0.5) * (2 * np.pi
                                                         / self.t_bins)
        ns = max(self.n_samples, 1)
        vol = n / self.density
        g = self.hist / (ns * n * self.density * bin_vol)
        gps = []
        for k, (a, b) in enumerate(self.pairs):
            na = max(self.type_counts[a], 1)
            nb = max(self.type_counts[b], 1)
            # both-direction counts; the reference accumulates each
            # direction with 1/(N_row rho_col) (angular_rdf.cu:228-236),
            # 2 x V/(2 Na Nb) for a != b
            gps.append(self.hist_pair[k] * (vol / (na * nb))
                       / (ns * bin_vol))
        with open(os.path.join(session.workdir, "angular_rdf.out"), "a") as f:
            f.write("#radius theta total" + "".join(
                f" type_{a}_{b}" for a, b in self.pairs) + "\n")
            for i in range(self.r_bins):
                for j in range(self.t_bins):
                    row = f"{r_c[i]:.5f} {t_c[j]:.5f} {g[i, j]:.5f}"
                    for gp in gps:
                        row += f" {gp[i, j]:.5f}"
                    f.write(row + "\n")


# Triples (centre, j, k) an ADF chunk: bounds the (atoms, width, width)
# angle tensors of one chunk.
_ADF_TRIPLES = 1 << 22


class ADF:
    """compute_adf: bond-angle distribution -> adf.out (ref: adf.cu).

    Global form: compute_adf interval bins rc_min rc_max - histogram of
    angles j-i-k over all triples with both bond lengths inside
    [rc_min, rc_max), bins over [0, 180) degrees, normalized to unit area.

    Triple form: compute_adf interval bins (i j k rcmin_j rcmax_j rcmin_k
    rcmax_k)xM - per-(itype, jtype, ktype) histograms with independent
    bond windows, one output column per triple.
    """

    def __init__(self, sample_interval, num_bins, rc_min=None, rc_max=None,
                 triples=None):
        self.sample_interval = int(sample_interval)
        self.interval = self.sample_interval
        self.num_bins = int(num_bins)
        self.global_ = triples is None
        self.rc_min = float(rc_min) if rc_min is not None else 0.0
        self.rc_max = float(rc_max) if rc_max is not None else 0.0
        self.triples = triples or []
        ncol = 1 if self.global_ else len(self.triples)
        self.hist = np.zeros((ncol, self.num_bins))
        self.n_samples = 0
        self.last_step = 0

    def _rc_top(self):
        if self.global_:
            return self.rc_max
        return max(max(t[4], t[6]) for t in self.triples)

    def sample_state(self, session, state, step):
        r12, mask, idx, n = _neighbors(session, state, self._rc_top(), 96)
        types = state.type[:n]
        tj_all = types[idx % n]
        nb = self.num_bins
        width = r12.shape[1]
        # the (atoms, width, width) angle tensors stay on the device, a
        # chunk of atoms at a time; only the bin counts come back
        jk = torch.triu(torch.ones((width, width), dtype=torch.bool,
                                   device=r12.device), diagonal=1)[None]
        block = max(1, _ADF_TRIPLES // max(width * width, 1))
        out = torch.zeros((self.hist.shape[0], nb), dtype=torch.int64,
                          device=r12.device)
        for s0 in range(0, n, block):
            sl = slice(s0, s0 + block)
            r12c, mc, tic, tjc = r12[sl], mask[sl] > 0, types[sl], tj_all[sl]
            d = torch.sqrt(torch.sum(r12c ** 2, dim=-1))
            dots = torch.sum(r12c[:, :, None, :] * r12c[:, None, :, :],
                             dim=-1)
            dd = d[:, :, None] * d[:, None, :]
            cosv = torch.clamp(dots / torch.clamp(dd, min=1e-30), -1.0, 1.0)
            theta = torch.arccos(cosv) * (180.0 / math.pi)
            bins = torch.clamp(torch.floor(theta / 180.0 * nb).long(), 0,
                               nb - 1)
            if self.global_:
                okj = mc & (d >= self.rc_min) & (d < self.rc_max)
                sel = okj[:, :, None] & okj[:, None, :] & jk
                out[0] += _bincount(bins, sel, nb)
                continue
            for c, (it, jt, kt, rmnj, rmxj, rmnk, rmxk) in enumerate(
                    self.triples):
                ci = tic == it
                wj = mc & (d >= rmnj) & (d < rmxj) & (tjc == jt)
                wk = mc & (d >= rmnk) & (d < rmxk) & (tjc == kt)
                sel = wj[:, :, None] & wk[:, None, :] & ci[:, None, None]
                if jt == kt:
                    sel = sel & jk
                out[c] += _bincount(bins, sel, nb)
        self.hist += _host(out)
        self.n_samples += 1
        self.last_step = step

    def postprocess(self, session):
        delta = 180.0 / self.num_bins
        angles = np.arange(self.num_bins) * delta
        with open(os.path.join(session.workdir, "adf.out"), "a") as f:
            if self.global_:
                f.write(f"#angles total step = {self.last_step}\n")
                total = max(self.hist[0].sum(), 1.0)
                for i in range(self.num_bins):
                    f.write(f"{angles[i]:g} "
                            f"{self.hist[0, i] / (total * delta):g}\n")
            else:
                head = " ".join(f"triples_{t[0]}-{t[1]}-{t[2]}"
                                for t in self.triples)
                f.write(f"#angles {head} step = {self.last_step}\n")
                totals = np.maximum(self.hist.sum(axis=1), 1.0)
                for i in range(self.num_bins):
                    cols = " ".join(
                        f"{self.hist[c, i] / (totals[c] * delta):g}"
                        for c in range(len(self.triples)))
                    f.write(f"{angles[i]:g} {cols}\n")


def _legendre_ylm(l, m, x, sx):
    """norm * P_l^m(x) by the associated-Legendre recurrences (P_m^m
    upward in m, then P_l^m upward in l), for any array type."""
    pmm = x * 0.0 + 1.0
    fact = 1.0
    for _ in range(m):
        pmm = -pmm * fact * sx
        fact += 2.0
    if l == m:
        plm = pmm
    else:
        pmmp1 = x * (2 * m + 1) * pmm
        plm = pmmp1
        for ll in range(m + 2, l + 1):
            plm = (x * (2 * ll - 1) * pmmp1 - (ll + m - 1) * pmm) / (ll - m)
            pmm, pmmp1 = pmmp1, plm
    return np.sqrt((2 * l + 1) / (4 * np.pi) * factorial(l - m)
                   / factorial(l + m)) * plm


def _ylm_complex(l, theta_cos, phi):
    """Complex spherical harmonics Y_l^m for m = -l..l via the standard
    associated-Legendre recurrence (host-side numpy; l <= ~20 stable)."""
    x = np.asarray(theta_cos)
    sx = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    out = {}
    for m in range(l + 1):
        y = _legendre_ylm(l, m, x, sx) * np.exp(1j * m * phi)
        out[m] = y
        if m > 0:
            out[-m] = (-1) ** m * np.conj(y)
    return out


def _ylm_complex_torch(l, theta_cos, phi):
    """Device (torch) variant of _ylm_complex: the same recurrences, on
    complex tensors of the inputs' precision on their device."""
    sx = torch.sqrt(torch.clamp(1.0 - theta_cos * theta_cos, min=0.0))
    out = {}
    for m in range(l + 1):
        plm = _legendre_ylm(l, m, theta_cos, sx)
        y = torch.complex(plm * torch.cos(m * phi), plm * torch.sin(m * phi))
        out[m] = y
        if m > 0:
            out[-m] = (-1) ** m * torch.conj(y)
    return out


def _wigner3j(j1, j2, j3, m1, m2, m3):
    """Wigner 3j symbol by the Racah sum (exact for small integer j)."""
    if m1 + m2 + m3 != 0:
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    f = factorial
    delta = np.sqrt(f(j1 + j2 - j3) * f(j1 - j2 + j3) * f(-j1 + j2 + j3)
                    / float(f(j1 + j2 + j3 + 1)))
    pref = delta * np.sqrt(float(f(j1 - m1) * f(j1 + m1) * f(j2 - m2)
                                 * f(j2 + m2) * f(j3 - m3) * f(j3 + m3)))
    tmin = max(0, j2 - j3 - m1, j1 - j3 + m2)
    tmax = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    total = 0.0
    for t in range(tmin, tmax + 1):
        denom = (f(t) * f(j3 - j2 + t + m1) * f(j3 - j1 + t - m2)
                 * f(j1 + j2 - j3 - t) * f(j1 - t - m1) * f(j2 - t + m2))
        total += (-1.0) ** t / denom
    return ((-1.0) ** (j1 - j2 - m3)) * pref * total


class OrientOrder:
    """compute_orientorder: Steinhardt bond-orientational order parameters
    q_l (optionally Lechner-Dellago neighbor-averaged), third-order
    invariants w_l and normalized w_l^hat -> orientorder.out
    (ref: orientorder.cu:317-575).

    run.in: compute_orientorder <interval> cutoff <rc> | nnn <n>
            <ndegrees> <l1> <l2> ... [average] [wl] [wlhat]
    """

    def __init__(self, interval, mode, mode_param, degrees, average=False,
                 wl=False, wlhat=False, nnn_rc=6.0):
        self.interval = int(interval)
        self.mode = mode  # "cutoff" | "nnn"
        self.rc = float(mode_param) if mode == "cutoff" else float(nnn_rc)
        self.nnn = int(mode_param) if mode == "nnn" else 0
        self.degrees = [int(d) for d in degrees]
        self.average = bool(average)
        self.wl = bool(wl)
        self.wlhat = bool(wlhat)
        self.blocks = []  # (step, per-atom columns)
        # the Wigner-3j terms (m1, m2, m3, 3j) of each degree, host-side
        self._wig = {}
        if self.wl or self.wlhat:
            for l in set(self.degrees):
                self._wig[l] = [
                    (m1, m2, -(m1 + m2), cg)
                    for m1 in range(-l, l + 1) for m2 in range(-l, l + 1)
                    if abs(m1 + m2) <= l
                    for cg in (_wigner3j(l, l, l, m1, m2, -(m1 + m2)),)
                    if cg != 0.0]

    def sample_state(self, session, state, step):
        r12, mask, idx, n = _neighbors(session, state, self.rc, 96)
        m = mask > 0
        d = torch.sqrt(torch.sum(r12 ** 2, dim=-1))
        if self.nnn > 0:
            # the nnn nearest (a stable sort, as jnp.argsort)
            dd = torch.where(m, d, torch.inf)
            order = torch.argsort(dd, dim=1, stable=True)
            keep = torch.zeros_like(m)
            keep.scatter_(1, order[:, :self.nnn], True)
            m = m & keep
        nb_count = m.sum(dim=1)
        mf = m.to(d.dtype)
        ct = torch.where(m, r12[..., 2] / torch.clamp(d, min=1e-30), 0.0)
        phi = torch.atan2(r12[..., 1], r12[..., 0])
        count = torch.clamp(nb_count, min=1).to(d.dtype)
        qlm = {}
        for l in set(self.degrees):
            y = _ylm_complex_torch(l, ct, phi)
            for mm in range(-l, l + 1):
                qlm[(l, mm)] = torch.sum(y[mm] * mf, dim=1) / count
        if self.average:
            for key, v in list(qlm.items()):
                nb_sum = torch.sum(v[idx % n] * mf, dim=1)
                qlm[key] = (v + nb_sum) / (nb_count + 1).to(d.dtype)
        cols = []
        qnorm = {}
        for l in self.degrees:
            s2 = sum(torch.abs(qlm[(l, mm)]) ** 2 for mm in range(-l, l + 1))
            qnorm[l] = torch.sqrt(4.0 * np.pi / (2 * l + 1) * s2)
            cols.append(qnorm[l])
        if self.wl or self.wlhat:
            wsums = {}
            for l in self.degrees:
                w = torch.zeros_like(qnorm[l])
                for m1, m2, m3, cg in self._wig[l]:
                    w = w + cg * torch.real(qlm[(l, m1)] * qlm[(l, m2)]
                                            * qlm[(l, m3)])
                wsums[l] = w
            if self.wl:
                cols += [wsums[l] for l in self.degrees]
            if self.wlhat:
                for l in self.degrees:
                    qfac = (np.sqrt(4.0 * np.pi / (2 * l + 1))
                            / torch.clamp(qnorm[l], min=1e-30))
                    cols.append(wsums[l] * qfac ** 3)
        out = torch.stack(cols, dim=1)
        if self.nnn > 0:
            out = torch.where((nb_count < self.nnn)[:, None], 0.0, out)
        self.blocks.append((step, _host(out)))

    def postprocess(self, session):
        head = " ".join(f"ql{l}" for l in self.degrees)
        if self.wl:
            head += " " + " ".join(f"wl{l}" for l in self.degrees)
        if self.wlhat:
            head += " " + " ".join(f"wlhat{l}" for l in self.degrees)
        with open(os.path.join(session.workdir, "orientorder.out"), "a") as f:
            for step, arr in self.blocks:
                f.write(f"step = {step}\n{head}\n")
                for row in arr:
                    f.write(" ".join(f"{x:f}" for x in row) + "\n")


class ModalAnalysis:
    """compute_gkma / compute_hnema: modal decomposition of the heat
    current onto normal-mode eigenvectors (ref: modal_analysis.cu:241-657).

    Reads `eigenvector.in` (binary float32: 3*Np omega^2 values in
    ascending order, then per mode [ex(Np), ey(Np), ez(Np)]) and keeps the
    modes on the state's device.  Per sample, with mass-scaled modal
    velocity xdot_c[m] = sum_i e_c[m,i] sqrt(m_i) v_i,c and stress columns
    W[:, a, c]/sqrt(m_i):

        jm_c[m, a] = (sum_i e_c[m,i] W[i,a,c]/sqrt(m_i)) * xdot_c[m]
        jxi = jmx[:,0]+jmy[:,0]; jxo = jmz[:,0]; jyi = jmx[:,1]+jmy[:,1];
        jyo = jmz[:,1]; jz = jmx[:,2]+jmy[:,2]+jmz[:,2]

    GKMA (heatmode.out): per-sample binned modal currents (the user runs
    the Green-Kubo integral offline).  HNEMA (kappamode.out): accumulates
    over samples and emits per-bin kappa scaled by
    KAPPA_UNIT_CONVERSION / (V T fe samples_per_output).  The products are
    float32 matmuls on the card (TF32 off), binned in float64; only the
    (bins, 5) rows reach the host.
    """

    needs_atom_virial = True  # samples W_i columns per mode

    def __init__(self, method, sample_interval, first_mode, last_mode,
                 bin_size=None, f_bin_size=None, output_interval=None,
                 fe=0.0, temperature=300.0, eig_path="eigenvector.in"):
        self.method = method  # "gkma" | "hnema"
        self.sample_interval = int(sample_interval)
        self.output_interval = int(output_interval or sample_interval)
        self.interval = self.sample_interval
        self.first_mode = int(first_mode)
        self.last_mode = int(last_mode)
        self.num_modes = self.last_mode - self.first_mode + 1
        self.bin_size = bin_size
        self.f_bin_size = f_bin_size
        self.fe = fe
        self.temperature = temperature
        self.eig_path = eig_path
        self._eig = None
        self._jm_acc = None
        self._nsamp = 0

    def _load(self, n_atoms, like: torch.Tensor):
        raw = np.fromfile(self.eig_path, dtype=np.float32)
        np3 = 3 * n_atoms
        if raw.size < np3 * (1 + self.last_mode):
            raise ValueError(f"eigenvector.in too small: {raw.size} floats, "
                             f"need >= {np3 * (1 + self.last_mode)}")
        om2 = raw[:np3]
        eig = raw[np3:np3 * (1 + self.last_mode)].reshape(-1, 3, n_atoms)
        eig = eig[self.first_mode - 1:self.last_mode]  # (modes, 3, Np)
        # (3, modes, Np): one contiguous (modes, Np) matrix a direction
        self._eig = torch.as_tensor(np.ascontiguousarray(
            eig.transpose(1, 0, 2)), dtype=like.dtype, device=like.device)
        # binning (ref: preprocess f_flag branch)
        if self.f_bin_size is not None:
            f = np.copysign(np.sqrt(np.abs(om2)) / (2.0 * np.pi),
                            om2)[self.first_mode - 1:self.last_mode]
            eps = 1e-6
            fmax = ((np.floor(abs(f[-1]) / self.f_bin_size) + 1)
                    * self.f_bin_size)
            fmin = np.floor(abs(f[0]) / self.f_bin_size) * self.f_bin_size
            shift = int(np.floor(abs(fmin) / self.f_bin_size + eps))
            self.num_bins = int(np.floor((fmax - fmin) / self.f_bin_size
                                         + eps))
            mode_bin = np.abs(f / self.f_bin_size).astype(np.int64) - shift
        else:
            bs = int(self.bin_size)
            self.num_bins = int(np.ceil(self.num_modes / bs))
            mode_bin = np.arange(self.num_modes) // bs
        self._mode_bin = torch.as_tensor(mode_bin, device=like.device)
        self._jm_acc = torch.zeros((self.num_modes, 5), dtype=torch.float64,
                                   device=like.device)

    def sample_state(self, session, state, step):
        n = session._n
        v = state.velocity[:n]
        if self._eig is None:
            if v.is_cuda:
                from gpumd_tpu_torch.engine.nep_compact import (
                    pin_fp32_matmul,
                )

                pin_fp32_matmul()
            self._load(n, v)
        w = state.virial[:n]  # (Np, 3, 3), J_a = W_ab v_b
        sq = torch.sqrt(state.mass[:n])
        jm_c = []
        for c in range(3):
            e_c = self._eig[c]  # (modes, Np)
            xdot = e_c @ (sq * v[:, c])  # (modes,)
            sm = w[:, :, c] / sq[:, None]  # (Np, 3): columns W[a, c]
            jm_c.append((e_c @ sm) * xdot[:, None])
        jx, jy, jz = jm_c
        jm = torch.stack([jx[:, 0] + jy[:, 0], jz[:, 0],
                          jx[:, 1] + jy[:, 1], jz[:, 1],
                          jx[:, 2] + jy[:, 2] + jz[:, 2]],
                         dim=1).to(torch.float64)  # (modes, 5)
        if self.method == "gkma":
            self._write_bins(session, jm)
            return
        self._jm_acc += jm
        self._nsamp += 1
        if (self._nsamp * self.sample_interval) % self.output_interval == 0:
            spo = self.output_interval // self.sample_interval
            factor = KAPPA_UNIT_CONVERSION / (
                float(state.box.volume) * self.temperature * self.fe * spo)
            self._write_bins(session, self._jm_acc * factor)
            self._jm_acc.zero_()
            self._nsamp = 0

    def _write_bins(self, session, jm: torch.Tensor):
        out = torch.zeros((self.num_bins, 5), dtype=torch.float64,
                          device=jm.device)
        out.index_add_(0, self._mode_bin, jm)
        name = "heatmode.out" if self.method == "gkma" else "kappamode.out"
        f = session._file(name)
        for row in _host(out):
            f.write(" ".join(f"{x:g}" for x in row) + "\n")
        f.flush()

    def postprocess(self, session):
        pass
