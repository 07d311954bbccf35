"""LSQT: linear-scaling quantum transport on MD positions.

Counterpart of gpumd_tpu/measure/lsqt.py (ref: src/measure/lsqt.cu): a
tight-binding Hamiltonian is built on the instantaneous MD geometry and
the energy-resolved DOS, carrier velocity and running conductivity
sigma(E, t) are computed with Chebyshev machinery:

  * KPM moments mu_m = <sl| T_m(H~) |sr> with Jackson damping for the
    delta-function resolution (ref: find_moments_chebyshev/apply_damping/
    perform_chebyshev_summation);
  * U(dt)|s> via the Chebyshev-Bessel expansion of exp(-i H t / hbar)
    (ref: evolve, gpu_chebyshev_01/2);
  * current operator J|s> = i [H, X] |s> using per-bond hopping distances
    (ref: gpu_apply_current).

States are complex tensors on the state's device (complex128 in float64,
complex64 in float32); H|s> is an (N, MN) gather and a contraction, and
the moment and Bessel loops are Python loops of such applies with the
moments kept on the device until the summation.  Two models: the
single-pi-orbital carbon model (hopping -2.7 (1.42/d)^2 eV within 2.1 A,
the reference's USE_GRAPHENE_TB variant, lsqt.cu:503-550) and the
four-orbital sp3 Slater-Koster model (lsqt.cu:554-643).

The neighbour list comes from the port's NeighborConfig (brute force with
images on small boxes, the cell list on large ones) with its capacity
taken from the deepest row of the geometry, so no hopping is dropped: the
JAX module keeps the first 10 neighbours of a row, which on diamond at the
sp3 model's 2.6 A (4 + 12 neighbours) drops hoppings and leaves H
unsymmetric.  Where JAX's rows fit, the two Hamiltonians are equal.

Outputs per sample: lsqt_dos.out (states/eV/atom), lsqt_velocity.out
(m/s), lsqt_sigma.out (S/m, running time integral).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from gpumd_tpu_torch.forcefield import NeighborConfig

# GPUMD natural time -> hbar/eV (ref: lsqt.cu preprocess: * 15.46692)
_TIME_TO_HBAR_EV = 15.46692
# A eV / hbar -> m/s (ref: lsqt.cu:852)
_M_PER_S = 1.60217663e5 / 1.054571817
# conductance quantum factor -> S/m (ref: lsqt.cu sigma output)
_S_PER_M = 7.748091729e5 * np.pi
# sp3 carbon (ref: lsqt.cuh:33-42): on-site energies, Slater-Koster
# integrals, GSP scaling
_SP3_ONSITE = (-2.99, 3.71, 3.71, 3.71)
_V_SSS, _V_SPS, _V_PPS, _V_PPP = -5.0, 4.7, 5.5, -1.55
_GSP_NC, _GSP_RC, _GSP_R0 = 6.5, 2.18, 1.536329
# the first capacity tried for a list; the deepest row sets the next
_MN_START = 16


def _jackson(nm: int) -> np.ndarray:
    k = np.arange(nm)
    a = 1.0 / (nm + 1.0)
    return (1.0 - k * a) * np.cos(k * np.pi * a) + np.sin(k * np.pi * a) * (
        a / np.tan(np.pi * a))


def _bessel_coeffs(x: float, max_m: int = 10000) -> np.ndarray:
    from scipy.special import jv

    out = [jv(0, x), 2.0 * jv(1, x)]
    for m in range(2, max_m):
        b = jv(m, x)
        if abs(b) < 1e-15:
            break
        out.append(2.0 * b)
    return np.asarray(out)


def _complex(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def neighbor_rows(position, box, rc: float):
    """The list of every atom within rc, at the capacity of its deepest
    row: a build at _MN_START slots, rebuilt wider when a row holds more
    (one read of the deepest row a build), then cut to that row.  Returns
    (idx (N, MN) int64, r12 (N, MN, 3), mask (N, MN)) with empty slots
    masked."""
    n = position.shape[0]
    mask = torch.ones(n, dtype=position.dtype, device=position.device)
    pos = box.wrap(position)
    cfg = NeighborConfig.create(box, rc, n, _MN_START)
    nbr = cfg.build(pos, box, mask)
    deepest = int(nbr.count.max())
    if deepest > cfg.mn:
        cfg = NeighborConfig.create(box, rc, n, deepest)
        nbr = cfg.build(pos, box, mask)
    width = max(deepest, 1)
    return (nbr.idx[:, :width].long(), nbr.r12[:, :width],
            nbr.mask[:, :width])


class LSQT:
    """compute_lsqt x|y|z Nm Ne E_start E_end E_max [sp3]
    (ref: lsqt.cu parse)."""

    def __init__(self, direction, n_moments, n_energies, e_start, e_end,
                 e_max, dt, rc=2.1, seed=13, model="graphene"):
        self.direction = {"x": 0, "y": 1, "z": 2}[direction]
        self.model = model  # "graphene" (pi orbital) | "sp3" (4 orbitals)
        self.nm = int(n_moments)
        self.ne = int(n_energies)
        self.e = np.linspace(e_start, e_end, self.ne)
        self.em = float(e_max)
        self.dt_hbar = dt * _TIME_TO_HBAR_EV
        self.rc = rc
        self.seed = seed
        self.interval = 1
        self._sl = None  # evolving left state
        self._sr = None
        self._sigma = np.zeros(self.ne)
        self._damp = _jackson(self.nm)
        self._bessel = _bessel_coeffs(self.dt_hbar * self.em)

    # ---- Hamiltonian on the current geometry -----------------------------

    def _build_h(self, state):
        """(u on-site (N,), hop (N, MN), xx (N, MN) bond x along the
        direction, idx (N, MN)) on the state's device, N the orbitals."""
        n = int(state.mask.sum())
        idx, r12, smask = neighbor_rows(state.position[:n], state.box,
                                        self.rc)
        d = torch.sqrt(torch.sum(r12 ** 2, dim=-1))
        if self.model == "sp3":
            return self._sp3_orbitals(n, idx, r12, smask, d)
        # pi-orbital carbon TB: t(d) = -2.7 (1.42/d)^2 (ref: lsqt.cu:545)
        live = smask > 0
        hop = torch.where(live, -2.7 * 1.42 ** 2
                          / torch.clamp(d, min=0.1) ** 2,
                          torch.zeros_like(d))
        xx = torch.where(live, r12[..., self.direction], torch.zeros_like(d))
        u = torch.zeros(n, dtype=d.dtype, device=d.device)
        return u, hop, xx, idx

    def _sp3_orbitals(self, n, idx_a, r12, smask, d):
        """Carbon sp3 Slater-Koster model, 4 orbitals (s, px, py, pz) per
        atom with GSP distance scaling (ref: lsqt.cu:554-643 and the TB
        struct lsqt.cuh:33-42).  Orbital site index = atom + k * N."""
        mn = idx_a.shape[1]
        live = smask > 0
        dd = torch.clamp(d, min=0.1)
        s12 = (_GSP_R0 / dd) ** 2 * torch.exp(
            2.0 * (-((dd / _GSP_RC) ** _GSP_NC)
                   + (_GSP_R0 / _GSP_RC) ** _GSP_NC))
        s12 = torch.where(live, s12, torch.zeros_like(s12))
        cx, cy, cz = (r12[..., k] / dd for k in range(3))
        dpp = _V_PPS - _V_PPP
        # H12[k1][k2] (N, MN) blocks (ref: :607-624)
        h = torch.stack([
            torch.stack([torch.full_like(cx, _V_SSS), _V_SPS * cx,
                         _V_SPS * cy, _V_SPS * cz], -1),
            torch.stack([-_V_SPS * cx, _V_PPS * cx ** 2
                         + _V_PPP * (1 - cx ** 2), dpp * cx * cy,
                         dpp * cz * cx], -1),
            torch.stack([-_V_SPS * cy, dpp * cx * cy,
                         _V_PPS * cy ** 2 + _V_PPP * (1 - cy ** 2),
                         dpp * cy * cz], -1),
            torch.stack([-_V_SPS * cz, dpp * cz * cx, dpp * cy * cz,
                         _V_PPS * cz ** 2 + _V_PPP * (1 - cz ** 2)], -1),
        ], -2) * s12[..., None, None]  # (N, MN, 4 k1, 4 k2)
        # orbital layout: row = n + k1 N, column = k2 MN + slot
        hop = h.permute(2, 0, 3, 1).reshape(4 * n, 4 * mn)
        orb = torch.arange(4, device=idx_a.device)
        idx = (idx_a[None, :, None, :] + orb[None, None, :, None] * n)
        idx = idx.expand(4, n, 4, mn).reshape(4 * n, 4 * mn)
        xr = torch.where(live, r12[..., self.direction],
                         torch.zeros_like(d))
        xx = xr[None, :, None, :].expand(4, n, 4, mn).reshape(4 * n, 4 * mn)
        u = torch.as_tensor(_SP3_ONSITE, dtype=d.dtype,
                            device=d.device).repeat_interleave(n)
        return u, hop, xx, idx

    # ---- operators -------------------------------------------------------

    @staticmethod
    def _h_apply(s, u, hop, idx, em_inv):
        return (u * s + torch.sum(hop * s[idx], dim=-1)) * em_inv

    @staticmethod
    def _j_apply(s, hop, xx, idx):
        # J|s>: sor = +Im, soi = -Re of sum hop*x*s  ->  -i * sum(...)
        return -1j * torch.sum((hop * xx) * s[idx], dim=-1)

    def _moments(self, sl, sr, u, hop, idx):
        """mu_m = Re <sl| T_m(H / E_max) |sr>, m < Nm, on the device."""
        em_inv = 1.0 / self.em
        s0 = sr
        s1 = self._h_apply(sr, u, hop, idx, em_inv)
        out = [torch.vdot(sl, s0).real, torch.vdot(sl, s1).real]
        for _ in range(self.nm - 2):
            s0, s1 = s1, 2.0 * self._h_apply(s1, u, hop, idx, em_inv) - s0
            out.append(torch.vdot(sl, s1).real)
        return torch.stack(out)

    def _summation(self, moments):
        """The damped Chebyshev series at the Ne energies, the recursion
        vectorised over the energies (on the moments' device)."""
        eps = torch.as_tensor(self.e / self.em, dtype=moments.dtype,
                              device=moments.device)
        mom = moments * torch.as_tensor(self._damp, dtype=moments.dtype,
                                        device=moments.device)
        c0 = torch.ones_like(eps)
        c1 = eps
        acc = mom[1] * eps
        for m in range(2, self.nm):
            c0, c1 = c1, 2.0 * eps * c1 - c0
            acc = acc + mom[m] * c1
        t = 2.0 * acc + mom[0]
        return t * 2.0 / (math.pi * torch.sqrt(1.0 - eps ** 2)) / self.em

    def _evolve(self, s, u, hop, idx, direction):
        """U(direction * dt)|s> by the Chebyshev-Bessel series
        (ref: evolve/gpu_chebyshev_01/2 label table)."""
        em_inv = 1.0 / self.em
        bessel = self._bessel
        s0 = s
        s1 = self._h_apply(s, u, hop, idx, em_inv)
        out = bessel[0] * s0 + bessel[1] * direction * (-1j) * s1
        # coefficient i^{-m} for U(-t): phases cycle 1, -i, -1, i
        phases = (1.0 + 0j, -1j * direction, -1.0 + 0j, 1j * direction)
        for m in range(2, bessel.shape[0]):
            s0, s1 = s1, 2.0 * self._h_apply(s1, u, hop, idx, em_inv) - s0
            out = out + (bessel[m] * phases[m % 4]) * s1
        return out

    # ---- measure-property protocol ---------------------------------------

    def sample_state(self, session, state, step):
        u, hop, xx, idx = self._build_h(state)
        n = u.shape[0]  # orbital count
        n_atoms = n // (4 if self.model == "sp3" else 1)
        rng = np.random.default_rng(self.seed)
        phase = rng.random(n) * 2.0 * np.pi
        ctype = _complex(u.dtype)

        def dos_of(sl, sr):
            return self._summation(self._moments(sl, sr, u, hop, idx))

        s = torch.as_tensor(np.exp(1j * phase), dtype=ctype, device=u.device)
        js = self._j_apply(s, hop, xx, idx)
        # sigma(E, t): evolve both states, correlate with J
        if self._sl is None:
            self._sl, self._sr = s, js
        else:
            self._sl = self._evolve(self._sl, u, hop, idx, -1.0)
            self._sr = self._evolve(self._sr, u, hop, idx, -1.0)
        sc = self._j_apply(self._sl, hop, xx, idx)
        rows = torch.stack([dos_of(s, s), dos_of(js, js),
                            dos_of(sc, self._sr)])
        dos, vel, vac = rows.to(torch.float64).cpu().numpy()  # one read
        wd = session.workdir
        with open(os.path.join(wd, "lsqt_dos.out"), "a") as f:
            # states/eV/ATOM (ref: lsqt.cu:817)
            f.write("".join(f"{v / n_atoms:25.15e}" for v in dos) + "\n")
        # velocity: <s J+ | J s> correlation at t = 0
        with open(os.path.join(wd, "lsqt_velocity.out"), "a") as f:
            row = np.sqrt(np.maximum(vel, 0.0)
                          / np.maximum(dos, 1e-30)) * _M_PER_S
            f.write("".join(f"{v:25.15e}" for v in row) + "\n")
        self._sigma += vac * self.dt_hbar / float(state.box.volume)
        with open(os.path.join(wd, "lsqt_sigma.out"), "a") as f:
            f.write("".join(f"{v * _S_PER_M:25.15e}" for v in self._sigma)
                    + "\n")

    def postprocess(self, session):
        pass
