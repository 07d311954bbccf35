"""Measured properties of the heat-transport path: heat current, HAC,
HNEMD thermal conductivity and spectral heat current.

Counterpart of part of gpumd_tpu/measure/properties.py (`heat_current_5`,
`HAC`, `HNEMDKappa`, `SHC`); the rest of that module is not ported yet
(ROADMAP queue 1, item 8).  The properties follow the reference Property
protocol (ref: src/measure/property.cuh): per-step values are reduced on
the card (`heat_current_5`, SHC's accumulators), the host receives them a
block at a time, and correlations and transforms run on the host in numpy
at postprocess.  The output files (hac.out, kappa.out, shc.out) have the
JAX package's formats byte for byte.

`session` is duck-typed as in the JAX package: `workdir`, `_n` (the real
atom count) and `state.box` (a box of either package).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

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
