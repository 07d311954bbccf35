"""External per-step force drivers: add_force / add_efield /
add_random_force / electron_stop / add_spring.

Counterpart of gpumd_tpu/integrate/drivers.py.  The drivers act after the
force pass and before integrate-2, where the reference's run loop applies
them (ref: src/main_gpumd/run.cu:289-293); `make_md_step` takes them as
`drivers`.  Each is a frozen dataclass with `apply(state) -> state`.  The
step index is the state's device counter `state.step`, so a table row or a
ghost anchor is chosen on the card and a step reads nothing back.

The JAX package's AddRandomForce derives a key a step with
`fold_in(state.step)`; here the noise comes from one torch.Generator
seeded once with `seed` on the state's device, or from an injected
`draw(shape, dtype, device)` (the tests pass JAX's draws: the streams
differ).  The masks and tables may be numpy arrays or tensors; they are
moved to the state's device and dtype once and kept.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from gpumd_tpu_torch.integrate.ensembles.nvt import normal_source


def _on(obj, name: str, value, like: torch.Tensor) -> torch.Tensor:
    """`value` as a tensor on `like`'s device and dtype, converted once and
    cached on the (frozen) driver."""
    cache = obj._dev
    key = (name, like.dtype, like.device)
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(value) if not torch.is_tensor(
            value) else value, dtype=like.dtype, device=like.device)
    return cache[key]


def _row(obj, table, state) -> torch.Tensor:
    """The table row of this step, step %% table length, on the card."""
    t = _on(obj, "table", table, state.force)
    return t[state.step.long() % t.shape[0]]


@dataclass(frozen=True)
class AddForce:
    """add_force <gm> <gid> fx fy fz | add_force <gm> <gid> <file>
    (ref: add_force.cu:73-162): a constant or per-step tabulated force on a
    group, the table indexed by step %% table_length."""

    gmask: object  # (N,) 1.0 on driven atoms
    table: object  # (L, 3) force table
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def apply(self, state):
        gm = _on(self, "gmask", self.gmask, state.force)
        f = state.force + gm[:, None] * _row(self, self.table, state)[None, :]
        return state._replace(force=f * state.mask[:, None])


@dataclass(frozen=True)
class AddEfield:
    """add_efield <gm> <gid> Ex Ey Ez [charge|bec] (ref: add_efield.cu):
    F += q E with the state's charges, or F += Z* E with the per-atom Born
    effective charge tensors of a qNEP model (bec mode), which `bec_fn`
    (state -> (N, 3, 3)) evaluates every step."""

    gmask: object
    table: object  # (L, 3) E-field table (V/A)
    use_bec: bool = False
    bec_fn: Optional[Callable] = None
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def apply(self, state):
        if self.use_bec:
            if self.bec_fn is None:
                raise ValueError("add_efield bec mode needs a qNEP model")
            ef = _row(self, self.table, state)
            gm = _on(self, "gmask", self.gmask, state.force)
            add = torch.einsum("nab,b->na", self.bec_fn(state), ef)
            f = state.force + gm[:, None] * add
            return state._replace(force=f * state.mask[:, None])
        if state.charge is None:
            raise ValueError("add_efield needs charges (model.xyz or qNEP)")
        ef = _row(self, self.table, state)
        gm = _on(self, "gmask", self.gmask, state.force)
        f = state.force + gm[:, None] * (state.charge[:, None] * ef[None, :])
        return state._replace(force=f * state.mask[:, None])


@dataclass(frozen=True)
class AddRandomForce:
    """add_random_force <variance> (ref: add_random_force.cu:118-145):
    a Gaussian force of the given variance on every atom, the net force
    removed (momentum conserving)."""

    variance: float
    seed: int = 20240813
    draw: Optional[Callable] = None  # (shape, dtype, device) -> normals
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def apply(self, state):
        f0 = state.force
        if "draw" not in self._dev:
            self._dev["draw"] = normal_source(self.draw, self.seed, f0.device)
        noise = (float(np.sqrt(self.variance))
                 * self._dev["draw"](tuple(f0.shape), f0.dtype, f0.device))
        noise = noise * state.mask[:, None]
        n_real = torch.clamp(torch.sum(state.mask), min=1.0)
        noise = noise - torch.sum(noise, dim=0) / n_real
        return state._replace(force=(f0 + noise) * state.mask[:, None])


@dataclass(frozen=True)
class ElectronStop:
    """electron_stop <file> (ref: electron_stop.cu): a stopping force
    against the velocity from a per-type tabulated stopping power S(E_kin),
    linearly interpolated; the mean stopping force is subtracted from all
    atoms to conserve momentum."""

    table: object  # (num_types, num_points) stopping power
    energy_min: float
    energy_max: float
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def apply(self, state):
        v = state.velocity
        table = _on(self, "table", self.table, v)
        npts = table.shape[1]
        v2 = torch.sum(v ** 2, dim=-1)
        energy = 0.5 * state.mass * v2
        interval = (self.energy_max - self.energy_min) / (npts - 1)
        frac = (energy - self.energy_min) / interval
        il = torch.clamp(frac.to(torch.int32), 0, npts - 2).long()
        wr = torch.clamp(frac - il, 0.0, 1.0)
        rows = table[state.type.long()]  # (N, npts)
        sl = torch.gather(rows, 1, il[:, None])[:, 0]
        sr = torch.gather(rows, 1, il[:, None] + 1)[:, 0]
        sp = sl * (1.0 - wr) + sr * wr
        inside = ((energy >= self.energy_min + 1e-6)
                  & (energy <= self.energy_max - 1e-6) & (state.mask > 0))
        factor = torch.where(inside, -sp * torch.rsqrt(torch.clamp(
            v2, min=1e-30)), torch.zeros_like(sp))
        fs = factor[:, None] * v
        n_real = torch.clamp(torch.sum(state.mask), min=1.0)
        fs = (fs - torch.sum(fs, dim=0) / n_real) * state.mask[:, None]
        return state._replace(force=state.force + fs)

    @staticmethod
    def from_file(path, num_types):
        """Stopping-power file: first line 'num_points emin emax', then
        num_points rows of num_types values (ref: electron_stop.cu parse)."""
        with open(path) as f:
            toks = f.read().split()
        npts = int(toks[0])
        emin, emax = float(toks[1]), float(toks[2])
        vals = np.asarray([float(x) for x in toks[3:3 + npts * num_types]])
        table = vals.reshape(npts, num_types).T  # (num_types, npts)
        return ElectronStop(table=table, energy_min=emin, energy_max=emax)


def parse_table_or_values(args, workdir="."):
    """'fx fy fz' or 'filename' for add_force / add_efield (ref:
    add_force.cu:110-155): a table file is its row count, then rows of 3
    values."""
    if len(args) == 3:
        return np.asarray([[float(a) for a in args]])
    if len(args) == 1:
        path = args[0]
        if not os.path.isabs(path):
            path = os.path.join(workdir, path)
        with open(path) as f:
            toks = f.read().split()
        n = int(toks[0])
        vals = np.asarray([float(x) for x in toks[1:1 + 3 * n]])
        return vals.reshape(n, 3)
    raise ValueError("expected 'fx fy fz' or a table filename")


@dataclass(frozen=True)
class AddSpring:
    """add_spring ghost_com <gm> <gid> vx vy vz couple k R0 x0 y0 z0 |
    ... decouple kx ky kz x0 y0 z0 (ref: add_spring.cu MODE_GHOST_COM): a
    ghost anchor starts at the group's centre of mass at registration plus
    `offset` and moves at `velocity` A/step; the spring force on the
    anchor-COM separation is spread over the group by mass (SMD
    pulling)."""

    gmask: object  # (N,) 1.0 on pulled atoms
    com0: object  # (3,) group COM at registration
    velocity: object  # (3,) A/step
    offset: object  # (3,)
    couple: bool = True
    k: float = 0.0  # couple spring constant
    r0: float = 0.0  # couple rest length
    k3: object = (0.0, 0.0, 0.0)  # decouple constants
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def apply(self, state):
        f0 = state.force
        m = state.mass * _on(self, "gmask", self.gmask, f0)
        msum = torch.clamp(torch.sum(m), min=1e-30)
        pos = (state.unwrapped_position
               if state.unwrapped_position is not None else state.position)
        com = torch.sum(m[:, None] * pos, dim=0) / msum
        ghost = (_on(self, "com0", self.com0, f0)
                 + _on(self, "offset", self.offset, f0)
                 + _on(self, "velocity", self.velocity, f0)
                 * state.step.to(f0.dtype))
        d = ghost - com
        if self.couple:
            r = torch.sqrt(torch.clamp(torch.sum(d * d), min=1e-40))
            f_tot = torch.where(r > 1e-20, self.k * (r - self.r0) / r,
                                torch.zeros_like(r)) * d
        else:
            f_tot = _on(self, "k3", self.k3, f0) * d
        f = f0 + (m / msum)[:, None] * f_tot[None, :]
        return state._replace(force=f * state.mask[:, None])
