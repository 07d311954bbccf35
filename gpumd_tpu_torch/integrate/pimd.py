"""Path-integral MD: PIMD / RPMD / TRPMD, the beads a leading tensor axis.

Counterpart of gpumd_tpu/integrate/pimd.py; the algorithm is the
reference's (ref: src/integrate/ensemble_pimd.cu):
  * real DFT bead <-> normal-mode transform C (152-172)
  * free ring-polymer evolution per mode with Cayley-stabilised rotation,
    omega_k = 2 omega_n sin(k pi / P), omega_n = P kB T / hbar (230-245)
  * PILE Langevin on normal modes: c1_k = exp(-dt omega_k) for internal
    modes; centroid c1_0 = exp(-dt/(2 tau)) (PIMD only) (324-326)
  * c2_k = sqrt((1 - c1^2) P kB T / m)

Modes:  pimd  — thermostat all modes (centroid + internal)
        trpmd — thermostat internal modes only
        rpmd  — no thermostat

Beads are a leading axis (P, N, 3) and the normal-mode transform a
(P, P) product on it.  The force pass loops over the beads through
ForceField (each bead's list rebuilt every step, as the JAX runner's
vmap of ff.compute does); the deepest neighbour row seen rides the state
on the device, so a caller tests the list capacity at a chunk's end with
no extra sync.  Normals come from a torch.Generator seeded at `init` on
the state's device, or from an injected `draw(shape, dtype, device)`.
The step's observables (bead temperature, mean potential) stay on the
device, stacked over a block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.integrate.ensembles.nvt import normal_source
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import HBAR, K_B


def transformation_matrix(p: int) -> np.ndarray:
    """(P, P) orthogonal real-DFT matrix C[j, k]
    (ref: ensemble_pimd.cu:152-172)."""
    c = np.zeros((p, p))
    s1 = np.sqrt(1.0 / p)
    s2 = np.sqrt(2.0 / p)
    for j in range(1, p + 1):
        sign = 1.0 if j % 2 == 0 else -1.0
        for k in range(p):
            arg = 2.0 * np.pi * j * k / p
            if k == 0:
                c[j - 1, k] = s1
            elif k < p // 2:
                c[j - 1, k] = s2 * np.cos(arg)
            elif k == p // 2:
                c[j - 1, k] = s1 * sign
            else:
                c[j - 1, k] = s2 * np.sin(arg)
    return c


class PIMDState(NamedTuple):
    position: torch.Tensor  # (P, N, 3)
    velocity: torch.Tensor  # (P, N, 3)
    force: torch.Tensor  # (P, N, 3)
    potential: torch.Tensor  # (P, N)
    # the deepest neighbour row of any bead's list since init (pre-cap)
    max_count: torch.Tensor  # () int


@dataclass
class PIMDRunner:
    """A PIMD run over a base MDState template (mass, type, box, mask)."""

    ff: ForceField
    base: MDState
    n_beads: int
    temperature: float
    coupling: float  # tau/dt of the centroid thermostat (pimd)
    mode: str = "pimd"  # pimd | rpmd | trpmd
    draw: Optional[Callable] = None  # (shape, dtype, device) -> normals

    def __post_init__(self):
        if self.mode not in ("pimd", "rpmd", "trpmd"):
            raise ValueError(f"unknown path-integral mode {self.mode!r}")
        self._normal = None
        dev, dtype = self.base.position.device, self.base.position.dtype
        self._c = torch.as_tensor(transformation_matrix(self.n_beads),
                                  dtype=dtype, device=dev)
        self._k = np.arange(self.n_beads)

    def init(self, seed: int = 0) -> PIMDState:
        """Every bead at the base positions, velocities drawn at P kB T,
        forces evaluated."""
        base = self.base
        p = self.n_beads
        dev, dtype = base.position.device, base.position.dtype
        self._normal = normal_source(self.draw, seed, dev)
        sigma = torch.sqrt(p * K_B * self.temperature / base.mass).to(dtype)
        v = (self._normal((p, *base.velocity.shape), dtype, dev)
             * sigma[None, :, None] * base.mask[None, :, None])
        pos = base.position[None].expand(p, -1, -1).clone()
        st = PIMDState(position=pos, velocity=v,
                       force=torch.zeros_like(pos),
                       potential=torch.zeros(p, pos.shape[1], dtype=dtype,
                                             device=dev),
                       max_count=torch.zeros((), dtype=torch.int64,
                                             device=dev))
        with torch.no_grad():
            return self._forces(st)

    # ---- pieces ---------------------------------------------------------

    def _forces(self, st: PIMDState) -> PIMDState:
        """Every bead's force pass on a fresh list (ForceField.compute's
        wrap, build and evaluate)."""
        base, ff = self.base, self.ff
        forces, pes = [], []
        max_count = st.max_count
        for pos in st.position:
            wrapped = base.box.wrap(pos)
            nbr = ff.neighbor.build(wrapped, base.box, base.mask)
            out = ff._evaluate(base._replace(position=wrapped), nbr)
            forces.append(out.force)
            pes.append(out.potential_energy)
            max_count = torch.maximum(max_count,
                                      torch.max(nbr.count).to(torch.int64))
        return st._replace(force=torch.stack(forces),
                           potential=torch.stack(pes), max_count=max_count)

    def _omega(self, temperature=None):
        t = self.temperature if temperature is None else temperature
        return self.n_beads * K_B * t / HBAR

    def _langevin(self, st: PIMDState, dt, temperature=None) -> PIMDState:
        if self.mode == "rpmd":
            return st
        t = self.temperature if temperature is None else temperature
        p = self.n_beads
        dtype, dev = st.velocity.dtype, st.velocity.device
        # internal modes: c1 = exp(-dt 2 w_n sin(k pi / P)) (the reference
        # applies exp(-dt w_n sin) per half step, 325)
        c1 = np.exp(-dt * 2.0 * self._omega(t) * np.sin(self._k * np.pi / p))
        c1[0] = np.exp(-0.5 / self.coupling) if self.mode == "pimd" else 1.0
        c1 = torch.as_tensor(c1, dtype=dtype, device=dev)
        c2 = torch.sqrt((1.0 - c1 * c1)[:, None]
                        * (p * K_B * t / self.base.mass)[None, :]).to(dtype)
        vn = torch.einsum("jk,jnd->knd", self._c, st.velocity)
        noise = self._normal(tuple(vn.shape), dtype, dev)
        vn = c1[:, None, None] * vn + c2[:, :, None] * noise
        v = torch.einsum("jk,knd->jnd", self._c, vn)
        return st._replace(velocity=v * self.base.mask[None, :, None])

    def _free_rp(self, st: PIMDState, dt, temperature=None) -> PIMDState:
        """Exact (Cayley-stabilised) free ring-polymer drift in normal-mode
        space; the centroid (k = 0) drifts."""
        p = self.n_beads
        dtype, dev = st.velocity.dtype, st.velocity.device
        omega_k = 2.0 * self._omega(temperature) * np.sin(self._k * np.pi / p)
        half = 0.5 * dt
        cay = 1.0 / (1.0 + (omega_k * half) ** 2)
        cosf = cay * (1.0 - (omega_k * half) ** 2)
        sinf = cay * omega_k * dt
        pos_k = omega_k > 0
        sin_over = np.where(pos_k, sinf / np.where(pos_k, omega_k, 1.0), dt)
        sin_times = sinf * omega_k

        def col(x):
            return torch.as_tensor(x, dtype=dtype, device=dev)[:, None, None]

        cosf, sin_over, sin_times = col(cosf), col(sin_over), col(sin_times)
        vn = torch.einsum("jk,jnd->knd", self._c, st.velocity)
        xn = torch.einsum("jk,jnd->knd", self._c, st.position)
        vn2 = cosf * vn - sin_times * xn
        xn2 = sin_over * vn + cosf * xn
        return st._replace(velocity=torch.einsum("jk,knd->jnd", self._c, vn2),
                           position=torch.einsum("jk,knd->jnd", self._c, xn2))

    def _kick(self, st: PIMDState, dt) -> PIMDState:
        inv_m = (1.0 / self.base.mass)[None, :, None]
        return st._replace(velocity=st.velocity + 0.5 * dt * st.force * inv_m)

    # ---- run --------------------------------------------------------------

    def run(self, st: PIMDState, dt, n_steps: int, t_end=None,
            first: int = 0, total: Optional[int] = None):
        """Advance n_steps; returns (state, {"t_beads", "pe"} stacked over
        the steps on the device).  With `t_end` the target temperature
        (thermostat AND ring-polymer frequencies) ramps linearly
        temperature -> t_end over `total` steps (default n_steps), of
        which this block is steps first .. first + n_steps - 1 (ref: run.cu
        interpolates temperature1 -> temperature2 every step)."""
        if self._normal is None:
            raise ValueError("PIMDRunner.run before init")
        t_start = self.temperature
        t_final = t_start if t_end is None else float(t_end)
        total = n_steps if total is None else total
        base = self.base
        n_real = torch.sum(base.mask)
        t_beads, pes = [], []
        with torch.no_grad():
            for i in range(first, first + n_steps):
                t_i = t_start + (t_final - t_start) * (i / max(total, 1))
                st = self._langevin(st, 0.5 * dt, t_i)
                st = self._kick(st, dt)
                st = self._free_rp(st, dt, t_i)
                st = self._forces(st)
                st = self._kick(st, dt)
                st = self._langevin(st, 0.5 * dt, t_i)
                t_beads.append(torch.sum(
                    base.mask * base.mass
                    * torch.sum(st.velocity ** 2, dim=(0, -1)))
                    / (3.0 * self.n_beads * n_real * K_B))
                pes.append(torch.mean(torch.sum(st.potential, dim=1)))
        return st, {"t_beads": torch.stack(t_beads), "pe": torch.stack(pes)}

    def centroid(self, st: PIMDState) -> MDState:
        """The base state at the beads' centroid (position and velocity)."""
        return self.base._replace(position=torch.mean(st.position, dim=0),
                                  velocity=torch.mean(st.velocity, dim=0))
