"""Atom-sharded force evaluation over a devices list, in plain torch.

Counterpart of gpumd_tpu/parallel/domain.py.  The reference's NEP_MULTIGPU
shards atoms into 1-D spatial slabs with 2*rc halo rings, staged through
GPU 0 (ref: src/force/nep_multigpu.cu:1424-1803).  Here, as in the JAX
package, each device owns a static slice of the (padded) atom axis: it
gathers every position and type (the JAX all_gather: a copy to each
device), builds the lists of its own atoms against them, evaluates the
potentials on its rows and scatters the pair partials over all atoms; the
reduce-scatter of those partials (the JAX psum_scatter) sums each
device's contributions on the owner of the rows.  One process drives
every device; a devices list may repeat an entry (all on the CPU in the
tests, several slices on one card).

For locality the caller sorts atoms by a spatial key first, so that each
slice is a contiguous slab (`sort_by_slab`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gpumd_tpu_torch.engine.sharded import (
    box_on,
    device_ctx,
    normalize_devices,
)
from gpumd_tpu_torch.forcefield import NeighborConfig
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.neighbor.neighbor import (
    NeighborList,
    brute_rows,
    cell_bins,
    cell_rows,
    image_shifts_cart,
)
from gpumd_tpu_torch.potentials.base import _scatter_rows, energy_and_partials


def make_mesh(n_devices: Optional[int] = None, device="cuda"):
    """The devices list of the JAX package's Mesh: the first `n_devices`
    visible cards, or `n_devices` (default 1) entries of the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if not devs:
            raise RuntimeError("no CUDA device visible")
        return devs[:n_devices] if n_devices is not None else devs
    return [device] * (n_devices or 1)


def sort_by_slab(position, box: Box, axis: int = 0) -> np.ndarray:
    """Host-side: the permutation that sorts atoms along one box direction,
    so that each device's slice is a spatial slab (the reference partitions
    along the longest axis, nep_multigpu.cu:1429-1455)."""
    frac = box.fractional(torch.as_tensor(
        position, dtype=box.h.dtype, device=box.h.device))
    return np.argsort(frac[:, axis].detach().cpu().numpy(), kind="stable")


@dataclass(frozen=True)
class ShardedMD:
    """Atom-sharded force evaluation: the atom axis is cut into one equal
    slice a `devices` entry (N_pad must divide by their number)."""

    potentials: tuple
    neighbor: NeighborConfig
    devices: tuple

    @staticmethod
    def create(potentials, box: Box, n_atoms: int, devices,
               mn: int = 256) -> "ShardedMD":
        rc = max(p.rc for p in potentials)
        cfg = NeighborConfig.create(box, rc, n_atoms, mn=mn)
        return ShardedMD(potentials=tuple(potentials), neighbor=cfg,
                         devices=tuple(normalize_devices(devices)))

    def shard_state(self, state: MDState) -> MDState:
        """The state as compute_forces takes it: its atom axis must cut
        into equal slices (the devices' shares are copied at each pass)."""
        if state.position.shape[0] % len(self.devices):
            raise ValueError(f"{state.position.shape[0]} atoms do not cut "
                             f"into {len(self.devices)} equal slices")
        return state

    def compute_forces(self, state: MDState) -> MDState:
        """Energies, forces, per-atom virials and heat currents: each
        device lists and evaluates its own atoms against all of them; the
        partials scattered onto other devices' atoms are summed on their
        owners."""
        nd = len(self.devices)
        n = state.position.shape[0]
        if n % nd:
            raise ValueError(f"{n} atoms do not cut into {nd} equal slices")
        n_l = n // nd
        dev0 = state.position.device
        pos = state.box.wrap(state.position)
        parts = []
        for j, dev in enumerate(self.devices):
            rows = slice(j * n_l, (j + 1) * n_l)
            with device_ctx(dev):
                pos_g, type_g, mask_g = (pos.to(dev), state.type.to(dev),
                                         state.mask.to(dev))
                box = box_on(state.box, dev)
                nbr = _local_neighbors(pos_g, mask_g, box, self.neighbor,
                                       j * n_l + torch.arange(n_l,
                                                              device=dev))
                parts.append(self._evaluate(nbr, type_g, mask_g, rows, n))
        energy, force, virial = [], [], []
        for j, dev in enumerate(self.devices):
            rows = slice(j * n_l, (j + 1) * n_l)
            with device_ctx(dev):
                # reduce-scatter: every device's partials on my rows
                recv_f = sum(p[2][rows].to(dev) for p in parts)
                recv_w = sum(p[3][rows].to(dev) for p in parts)
                energy.append(parts[j][0].to(dev0))
                force.append((parts[j][1] - recv_f).to(dev0))
                virial.append(recv_w.to(dev0))
        energy, force, virial = (torch.cat(energy), torch.cat(force),
                                 torch.cat(virial))
        j_heat = torch.einsum("nab,nb->na", virial, state.velocity)
        return state._replace(force=force, potential_energy=energy,
                              virial=virial, heat_current=j_heat)

    def _evaluate(self, nbr: NeighborList, type_g, mask_g, rows, n: int):
        """(energy, sum of own partials, partials scattered onto all n
        atoms, pair virials scattered onto all n atoms) of one slice."""
        type_l, mask_l = type_g[rows], mask_g[rows]
        dtype = nbr.r12.dtype
        e = torch.zeros(type_l.shape[0], dtype=dtype, device=nbr.r12.device)
        p_sum = torch.zeros_like(nbr.r12[:, 0])
        recv_f = torch.zeros((n, 3), dtype=dtype, device=nbr.r12.device)
        recv_w = torch.zeros((n, 3, 3), dtype=dtype, device=nbr.r12.device)
        t2 = type_g[nbr.idx.long()]
        for pot in self.potentials:
            e_atom, pp = energy_and_partials(
                lambda r12, sl, _pot=pot: _pot.pair_energies(
                    r12, type_l[sl], t2[sl]), nbr.r12, mask_l.to(dtype))
            e = e + e_atom
            p_sum = p_sum + torch.sum(pp, dim=1)
            recv_f = recv_f + _scatter_rows(pp.reshape(-1, 3), nbr.idx, n)
            w_pair = (-nbr.r12[..., :, None] * pp[..., None, :]
                      * nbr.mask[..., None, None])
            recv_w = recv_w + _scatter_rows(w_pair.reshape(-1, 3, 3),
                                            nbr.idx, n)
        return e, p_sum, recv_f, recv_w


def _local_neighbors(pos_g, mask_g, box: Box, cfg: NeighborConfig,
                     rows) -> NeighborList:
    """The lists of the local atoms `rows` against all of them (global
    indices): the cell list where the plan has one (every device bins
    all atoms and walks the stencil for its own rows, the reference's
    per-GPU build over owned + halo slabs, nep_multigpu.cu:1585-1650),
    else all pairs times the periodic images."""
    real = mask_g > 0
    if cfg.method == "cell":
        return cell_rows(pos_g, box, real, rows,
                         cell_bins(pos_g, box, mask_g, cfg.grid), rc=cfg.rc,
                         mn=cfg.mn, grid=cfg.grid, cell_cap=cfg.cell_cap)
    return brute_rows(pos_g, box, real, rows,
                      image_shifts_cart(box, cfg.reps), rc=cfg.rc, mn=cfg.mn)
