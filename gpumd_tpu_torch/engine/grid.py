"""Dense cell-grid state layout for the fused MD engine.

Counterpart of gpumd_tpu/engine/grid.py.  Atoms live in a dense
(nz, ny, nx, cap) cell grid between re-sorts; pair candidates of a block of
cells are a window of the ghost-padded grid; periodic ghost cells carry the
exact lattice shift.  Layouts match the JAX package exactly, so the
kernels' inputs and outputs can be compared element by element.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.model.box import Box

FAR = 1.0e5


def round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclass(frozen=True)
class DenseGridPlan:
    """Static description of the dense cell grid."""

    grid: Tuple[int, int, int]  # (nx, ny, nz) cells
    cap: int  # slots per cell
    rc: float
    skin: float
    pbc: Tuple[bool, bool, bool]

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.grid
        return nx * ny * nz

    @property
    def n_slots(self) -> int:
        return self.n_cells * self.cap


def plan_grid(box: Box, rc: float, skin: float, n_atoms: int,
              position: Optional[np.ndarray] = None,
              cap: Optional[int] = None,
              cap_margin: float = 1.3) -> Optional[DenseGridPlan]:
    """Host-side planning: cells at least rc+skin thick, per-cell capacity.
    Returns None when a periodic axis holds fewer than 3 cells."""
    t = box.thickness().detach().cpu().numpy().astype(np.float64)
    pbc_np = box.pbc.detach().cpu().numpy() > 0
    grid = []
    for d in range(3):
        nd = int(np.floor(float(t[d]) / (rc + skin)))
        if pbc_np[d]:
            if nd < 3:
                return None
        else:
            nd = max(nd, 1)
        grid.append(nd)
    grid = tuple(grid)
    if cap is None:
        if position is None:
            occ = n_atoms / (grid[0] * grid[1] * grid[2])
        else:
            occ = _max_occupancy(np.asarray(position), box, grid)
        cap = max(int(np.ceil(occ * cap_margin / 8.0)) * 8, 8)
    return DenseGridPlan(grid=grid, cap=cap, rc=rc, skin=skin,
                         pbc=tuple(bool(p) for p in pbc_np))


def _max_occupancy(position: np.ndarray, box: Box, grid) -> int:
    """Worst-case cell occupancy over both float32 and float64 binning."""
    nx, ny, nz = grid
    hinv64 = box.h_inv.detach().cpu().numpy().astype(np.float64)
    worst = 0
    for dt in (np.float64, np.float32):
        s = position.astype(dt) @ hinv64.astype(dt).T
        s = s - np.floor(s)
        idx = np.minimum(np.floor(s * np.asarray(grid, dt)).astype(np.int64),
                         np.asarray(grid) - 1)
        cid = (idx[:, 2] * ny + idx[:, 1]) * nx + idx[:, 0]
        worst = max(worst, int(np.bincount(cid, minlength=nx * ny * nz).max()))
    return worst


def cell_ids(position, box: Box, mask, plan: DenseGridPlan):
    """(N,) int64 cell id per atom; padding atoms -> the overflow cell."""
    nx, ny, nz = plan.grid
    s = box.fractional(position)
    pbc = torch.tensor([1.0 if p else 0.0 for p in plan.pbc],
                       dtype=s.dtype, device=s.device)
    # wrap periodic dims; clip non-periodic ones into the end cells
    s = torch.where(pbc > 0, s - torch.floor(s),
                    torch.clamp(s, 0.0, 1.0 - 1e-7))
    gridf = torch.tensor([nx, ny, nz], dtype=s.dtype, device=s.device)
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], device=s.device)
    cxyz = torch.minimum(torch.clamp(torch.floor(s * gridf).long(), min=0),
                         hi)
    cid = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
    return torch.where(mask > 0, cid, torch.full_like(cid, plan.n_cells))


def bin_dense(position, box: Box, mask, plan: DenseGridPlan):
    """Sort atoms into the dense slot layout.

    Returns perm (n_slots,) int64 (row feeding each slot; empty slots point
    at row R, the caller's pad row), slot_mask (n_slots,) and a device bool
    `overflow` (some cell exceeded cap: its extra atoms are dropped).
    """
    r = position.shape[0]
    dev = position.device
    cid = cell_ids(position, box, mask, plan)
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    starts = torch.searchsorted(
        sorted_cid, torch.arange(plan.n_cells + 1, device=dev))
    rank = torch.arange(r, device=dev) - starts[
        torch.clamp(sorted_cid, max=plan.n_cells)]
    occ = starts[1:] - starts[:-1]
    overflow = torch.any(occ > plan.cap)
    dest = sorted_cid * plan.cap + torch.clamp(rank, max=plan.cap - 1)
    ok = (rank < plan.cap) & (sorted_cid < plan.n_cells)
    dest = torch.where(ok, dest, torch.full_like(dest, plan.n_slots))  # sink
    perm = torch.full((plan.n_slots + 1,), r, dtype=torch.int64, device=dev)
    perm[dest] = order
    slot_mask = torch.zeros(plan.n_slots + 1, dtype=position.dtype,
                            device=dev)
    slot_mask[dest] = 1.0
    return perm[:plan.n_slots], slot_mask[:plan.n_slots], overflow


def apply_perm(arr, perm, fill=0.0):
    """Gather rows of `arr` into slot order; perm == len(arr) -> fill."""
    pad = torch.full((1,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad], dim=0)[perm]


def pack_ghost(position_slots, type_slots, slot_mask, box: Box,
               plan: DenseGridPlan):
    """Slot state -> ghost-padded (nz+2, ny+2, 4, (nx+2)*cap): channels
    x, y, z (ghosts carry the lattice shift) and type as float.  Empty
    slots sit at FAR with type -1; non-periodic ghost layers are FAR."""
    nx, ny, nz = plan.grid
    cap = plan.cap
    dtype = position_slots.dtype
    h = box.h.to(dtype)
    live = slot_mask > 0
    pos = torch.where(live[:, None], position_slots,
                      torch.full_like(position_slots, FAR))
    t = torch.where(live, type_slots.to(dtype),
                    torch.full_like(slot_mask, -1.0, dtype=dtype))
    comps = [pos[:, k].reshape(nz, ny, nx * cap) for k in range(3)]
    comps.append(t.reshape(nz, ny, nx * cap))

    def pad_axis(arrs, axis, shift_col, periodic):
        out = []
        for k, a in enumerate(arrs):
            if axis == 2:
                lo, hi = a[..., -cap:], a[..., :cap]
            else:
                n = a.shape[axis]
                lo, hi = a.narrow(axis, n - 1, 1), a.narrow(axis, 0, 1)
            if periodic:
                if k < 3:
                    lo, hi = lo + shift_col[k], hi - shift_col[k]
            else:
                fill = FAR if k < 3 else -1.0
                lo, hi = torch.full_like(lo, fill), torch.full_like(hi, fill)
            out.append(torch.cat([lo, a, hi], dim=axis))
        return out

    # x (lanes), then y, then z: corner ghosts compose shifts exactly
    comps = pad_axis(comps, 2, -h[:, 0], plan.pbc[0])
    comps = pad_axis(comps, 1, -h[:, 1], plan.pbc[1])
    comps = pad_axis(comps, 0, -h[:, 2], plan.pbc[2])
    return torch.stack(comps, dim=2)


def pack_ghost_rows(rows, plan: DenseGridPlan, fill=0.0):
    """Ghost-pad a values grid (nz, ny, C, nx*cap) ->
    (nz+2, ny+2, C, (nx+2)*cap) with plain periodic copies."""
    cap = plan.cap

    def pad(a, axis, periodic):
        if axis == 3:
            lo, hi = a[..., -cap:], a[..., :cap]
        else:
            n = a.shape[axis]
            lo, hi = a.narrow(axis, n - 1, 1), a.narrow(axis, 0, 1)
        if not periodic:
            lo, hi = torch.full_like(lo, fill), torch.full_like(hi, fill)
        return torch.cat([lo, a, hi], dim=axis)

    rows = pad(rows, 3, plan.pbc[0])
    rows = pad(rows, 1, plan.pbc[1])
    return pad(rows, 0, plan.pbc[2])


def pack_block_windows(g, plan: DenseGridPlan, bx: int, wl: int,
                       far_channels=3):
    """Ghost grid (nzg, nyg, C, nxg*cap) -> per-x-block candidate windows
    (nzg-2, ny, nxb, C, wl).  Window lanes: cells (dz, dy, wx) for dz, dy in
    0..2 and wx in 0..bx+1, cell-major, cap lanes each; padded to wl with
    FAR positions (channels < far_channels), type -1, or 0."""
    nx, ny, _ = plan.grid
    cap = plan.cap
    nzg, nyg, c = g.shape[0], g.shape[1], g.shape[2]
    nz_out = nzg - 2
    nxb = nx // bx
    g5 = g.reshape(nzg, nyg, c, nx + 2, cap)
    chunks = []
    for dz in range(3):
        for dy in range(3):
            for wx in range(bx + 2):
                sl = g5[dz:dz + nz_out, dy:dy + ny, :,
                        wx:wx + (nxb - 1) * bx + 1:bx]
                chunks.append(sl.movedim(3, 2))  # (nz, ny, nxb, C, cap)
    used = 9 * (bx + 2) * cap
    if wl > used:
        pad = torch.zeros(chunks[0].shape[:-1] + (wl - used,),
                          dtype=g.dtype, device=g.device)
        if far_channels:
            pad[..., :far_channels, :] = FAR
        if c >= 4 and far_channels == 3:
            pad[..., 3, :] = -1.0
        chunks.append(pad)
    return torch.cat(chunks, dim=-1)


def fold_block_windows(dw, plan: DenseGridPlan, bx: int):
    """Adjoint of pack_block_windows: window cotangents (nz, ny, C, nxb, wl)
    -> ghost-grid cotangents (nz+2, ny+2, C, (nx+2)*cap)."""
    nx, ny, nz = plan.grid
    cap = plan.cap
    nxb = nx // bx
    c = dw.shape[2]
    out = torch.zeros((nz + 2, ny + 2, c, nx + 2, cap), dtype=dw.dtype,
                      device=dw.device)
    k = 0
    for dz in range(3):
        for dy in range(3):
            for wx in range(bx + 2):
                seg = dw[..., k * cap:(k + 1) * cap]  # (nz, ny, C, nxb, cap)
                out[dz:dz + nz, dy:dy + ny, :,
                    wx:wx + (nxb - 1) * bx + 1:bx] += seg
                k += 1
    return out.reshape(nz + 2, ny + 2, c, (nx + 2) * cap)


def pack_candidates(garr, plan: DenseGridPlan, lane_align: int = 128):
    """Ghost grid (nz+2, ny+2, 4, (nx+2)*cap) -> per-cell packed candidates
    (nz, ny, nx, 4, C) and centres (nz, ny, nx, 4, cap).  Candidate lanes
    are the 27 cells of the 3^3 window, (dz, dy, dx)-major, cap lanes
    each; C = 27*cap rounded up to `lane_align`, the pad lanes at FAR with
    type -1."""
    nx, ny, nz = plan.grid
    cap = plan.cap
    g5 = garr.reshape(nz + 2, ny + 2, 4, nx + 2, cap).movedim(3, 2)
    chunks = [g5[dz:dz + nz, dy:dy + ny, dx:dx + nx]
              for dz in range(3) for dy in range(3) for dx in range(3)]
    c_pad = round_up(27 * cap, lane_align)
    if c_pad > 27 * cap:
        pad = torch.full((nz, ny, nx, 4, c_pad - 27 * cap), FAR,
                         dtype=garr.dtype, device=garr.device)
        pad[..., 3, :] = -1.0
        chunks.append(pad)
    return g5[1:1 + nz, 1:1 + ny, 1:1 + nx], torch.cat(chunks, dim=-1)


def fold_candidate_grad(dcand, plan: DenseGridPlan):
    """Adjoint of pack_candidates on the position channels: candidate
    cotangents (nz, ny, nx, 3, C) -> ghost-grid cotangents
    (nz+2, ny+2, 3, (nx+2)*cap).  The pad lanes are dropped."""
    nx, ny, nz = plan.grid
    cap = plan.cap
    dg5 = torch.zeros((nz + 2, ny + 2, nx + 2, 3, cap), dtype=dcand.dtype,
                      device=dcand.device)
    k = 0
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                dg5[dz:dz + nz, dy:dy + ny, dx:dx + nx] += \
                    dcand[..., k * cap:(k + 1) * cap]
                k += 1
    return dg5.movedim(2, 3).reshape(nz + 2, ny + 2, 3, (nx + 2) * cap)


def fold_ghost_grad(dg, plan: DenseGridPlan):
    """Adjoint of pack_ghost on the position channels (the lattice shift is
    additive, so cotangents pass through): (nz+2, ny+2, 3, (nx+2)*cap) ->
    (n_slots, 3)."""
    return fold_ghost_grad_c(dg, plan)


def fold_ghost_xy(dg, plan: DenseGridPlan):
    """Fold the x and y ghost cells of ghost-grid cotangents onto their
    interior cells and keep the z ghost rows (a slab's, for its
    neighbours): (nz+2, ny+2, C, (nx+2)*cap) -> (nz+2, ny, C, nx*cap)."""
    cap = plan.cap
    core = dg[:, 1:-1].clone()
    if plan.pbc[1]:
        core[:, -1] += dg[:, 0]
        core[:, 0] += dg[:, -1]
    inner = core[..., cap:-cap].clone()
    if plan.pbc[0]:
        inner[..., -cap:] += core[..., :cap]
        inner[..., :cap] += core[..., -cap:]
    return inner


def fold_ghost_grad_c(dg, plan: DenseGridPlan):
    """Fold ghost-layer cotangents back onto their interior cells:
    (nz+2, ny+2, C, (nx+2)*cap) -> (n_slots, C)."""
    c = dg.shape[2]
    core = dg[1:-1].clone()
    if plan.pbc[2]:
        core[-1] += dg[0]
        core[0] += dg[-1]
    return fold_ghost_xy(core, plan).movedim(2, 0).reshape(c, -1).T
