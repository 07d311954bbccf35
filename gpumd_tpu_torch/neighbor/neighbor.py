"""Fixed-width neighbour lists: brute force, sort-based cell list, and the
dense cell-major cell list.

Counterpart of gpumd_tpu/neighbor/neighbor.py (ref: src/force/neighbor.cu,
and the small-box path of src/force/nep.cu:1141+).  Every builder returns
a `NeighborList` with the JAX package's (N, MN) layout and slot order:

  idx   (N, MN) int32 neighbour index, padded with the atom's own index
  r12   (N, MN, 3) displacement r_j + shift - r_i (image resolved)
  mask  (N, MN) 1.0 where the slot holds a neighbour within rc
  count (N,) int32 neighbours found before the MN cap

Padded slots point at the atom itself with a displacement of `_FAR`, so
smooth-cutoff potentials give them exactly zero; `mask` serves hard
cutoffs (LJ).  An atom with more neighbours than MN keeps the first MN in
candidate order and reports its full count (`NeighborList.overflowed`).

The builders run on the positions' device, in plain torch: no function of
the JAX list path reaches a Pallas kernel, and none here launches a
hand-written one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gpumd_tpu_torch.model.box import Box

# Displacement magnitude parked on padded slots; far outside any cutoff.
_FAR = 1.0e5

# The 27 stencil offsets (ox, oy, oz), ox fastest: the candidate order of
# both cell lists.
_OFFSETS = [(i, j, k) for k in (-1, 0, 1) for j in (-1, 0, 1)
            for i in (-1, 0, 1)]


def gather_vec3(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points[idx]: (..., 3) rows by index (the JAX package gathers per
    component to keep TPU layouts narrow; one gather here)."""
    return points[idx]


class NeighborList(NamedTuple):
    idx: torch.Tensor  # (N, MN) int32
    r12: torch.Tensor  # (N, MN, 3)
    mask: torch.Tensor  # (N, MN)
    count: torch.Tensor  # (N,) int32 true neighbour count (pre-cap)
    # rev[i, m] = flat index j * MN + m' of the mirror slot (idx[j, m'] == i
    # with the opposite image shift): the gather-only force reduction
    rev: Optional[torch.Tensor] = None  # (N, MN) int32

    @property
    def max_neighbors(self) -> int:
        return self.idx.shape[1]

    def overflowed(self) -> torch.Tensor:
        """A device bool: some atom had more neighbours than MN slots."""
        return torch.any(self.count > self.max_neighbors)


def _enc(sv: torch.Tensor) -> torch.Tensor:
    # shifts are small integers (|s| < 16 by construction)
    return ((sv[..., 0] + 16) + 33 * (sv[..., 1] + 16)
            + 1089 * (sv[..., 2] + 16))


def build_reverse_map(nbr: NeighborList,
                      shift_frac: torch.Tensor) -> torch.Tensor:
    """rev[i, m] = flat index j * MN + m' of the mirror pair slot.

    Every ordered pair (i -> j, shift s) gets the canonical key (min(i, j),
    max(i, j), canonical shift); a pair and its mirror share it and all
    other keys differ, so after a lexicographic sort mirrors sit at 2k and
    2k + 1.  The JAX package sorts on the three keys at once; here three
    stable sorts, least significant key first, give the same order at any
    N * MN.  Needs a loss-free list (no MN overflow); invalid slots get
    arbitrary in-range values, masked by the consumers.
    """
    n, mn = nbr.idx.shape
    if (n * mn) % 2 != 0:
        raise ValueError("N * MN must be even for pair matching (use even MN)")
    dev = nbr.idx.device
    i = torch.arange(n, device=dev)[:, None].expand(n, mn)
    j = nbr.idx.long()
    a = torch.minimum(i, j)
    b = torch.maximum(i, j)
    s = shift_frac.long()
    # canonical orientation: atom order for i != j; the shift's sign for
    # self-image pairs (i == j), where both mirror slots must share a key
    keep = (i < j) | ((i == j) & (_enc(s) > _enc(-s)))
    s = torch.where(keep[..., None], s, -s)
    enc = _enc(s)
    valid = nbr.mask.reshape(-1) > 0
    flat = torch.arange(n * mn, device=dev)
    # invalid slots sort to the tail with unique keys (the valid pair count
    # is even, so valid mirrors stay 2k / 2k+1 aligned at the front)
    a = torch.where(valid, a.reshape(-1), torch.full_like(flat, n))
    b = torch.where(valid, b.reshape(-1), flat)
    enc = torch.where(valid, enc.reshape(-1), torch.zeros_like(flat))
    order = flat
    for key in (enc, b, a):
        order = order[torch.sort(key[order], stable=True).indices]
    swapped = order.view(-1, 2).flip(1).reshape(-1)
    inv = torch.empty_like(order)
    inv[order] = flat
    return swapped[inv].reshape(n, mn).to(torch.int32)


def _image_shifts(reps: Sequence[int]) -> np.ndarray:
    """Integer image shifts [-m, m]^3 as (n_img, 3), the zero shift first."""
    rx, ry, rz = reps
    shifts = [(i, j, k) for i in range(-rx, rx + 1)
              for j in range(-ry, ry + 1) for k in range(-rz, rz + 1)]
    shifts.sort(key=lambda s: (s != (0, 0, 0),))  # zero image first
    return np.asarray(shifts, dtype=np.float64)


def _compact_rows(valid: torch.Tensor, mn: int):
    """The first MN valid candidates of each row, in column order (the JAX
    package's top_k on a column key).

    valid (R, C) bool -> (src (R, MN) int64 column of each slot, slot_valid
    (R, MN) bool).  Slots past a row's valid count hold column 0 (the JAX
    package puts the first invalid columns there; every caller masks
    them).  torch.nonzero lists the valid entries in row-major order, so
    an entry's rank in its row is its position minus the row's start.
    """
    rows, n_cand = valid.shape
    k = min(mn, n_cand)
    cnt = valid.sum(-1)
    r, c = torch.nonzero(valid, as_tuple=True)
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(r.numel(), device=valid.device) - start[r]
    take = rank < k
    src = torch.zeros((rows, mn), dtype=torch.int64, device=valid.device)
    src[r[take], rank[take]] = c[take]
    slot_valid = (torch.arange(mn, device=valid.device)[None, :]
                  < torch.clamp(cnt, max=k)[:, None])
    return src, slot_valid


def neighbor_brute(position: torch.Tensor, box: Box, mask: torch.Tensor, *,
                   rc: float, mn: int, reps: tuple = (0, 0, 0),
                   row_block: int = 512) -> NeighborList:
    """All pairs times periodic images, in row blocks (peak memory
    O(row_block * N * n_img)); exact for any small box given `reps` from
    `num_replicas_for_cutoff`."""
    n = position.shape[0]
    dtype, dev = position.dtype, position.device
    shifts_frac = torch.as_tensor(_image_shifts(reps), dtype=dtype,
                                  device=dev)
    shifts_cart = box.cartesian(shifts_frac)  # (n_img, 3)
    n_img = shifts_cart.shape[0]
    real = mask > 0
    cols = torch.arange(n, device=dev)
    img0 = torch.arange(n_img, device=dev) == 0
    out = []
    for s0 in range(0, n, row_block):
        rows = torch.arange(s0, min(s0 + row_block, n), device=dev)
        rij = box.minimum_image(position[None, :, :]
                                - position[rows][:, None, :])
        rij_all = rij[:, :, None, :] + shifts_cart[None, None, :, :]
        d2 = torch.sum(rij_all ** 2, dim=-1)  # (B, N, n_img)
        pair = real[rows][:, None] & real[None, :]
        is_self = ((rows[:, None] == cols[None, :])[:, :, None]
                   & img0[None, None, :])
        valid = (d2 < rc * rc) & pair[:, :, None] & ~is_self
        valid2 = valid.reshape(len(rows), n * n_img)
        cnt = valid2.sum(-1).to(torch.int32)
        src, slot_valid = _compact_rows(valid2, mn)
        r12 = torch.gather(rij_all.reshape(len(rows), n * n_img, 3), 1,
                           src[:, :, None].expand(-1, -1, 3))
        idx = torch.where(slot_valid, src // n_img, rows[:, None])
        r12 = torch.where(slot_valid[:, :, None], r12,
                          torch.full_like(r12, _FAR))
        out.append((idx.to(torch.int32), r12, slot_valid.to(dtype), cnt))
    idx, r12, smask, count = (torch.cat(x) for x in zip(*out))
    return NeighborList(idx=idx, r12=r12, mask=smask, count=count)


def _bin_atoms(position, box: Box, mask, grid):
    """Cell coordinates (N, 3) int64 and cell ids (padding atoms in the
    overflow cell nx*ny*nz); fractional coordinates wrapped along periodic
    directions."""
    nx, ny, nz = grid
    s = box.fractional(position)
    s = s - torch.floor(s) * box.pbc.to(s.dtype)
    gridf = torch.as_tensor(grid, dtype=s.dtype, device=s.device)
    hi = torch.as_tensor([nx - 1, ny - 1, nz - 1], device=s.device)
    cell_xyz = torch.clamp(torch.floor(s * gridf).long(), min=0)
    cell_xyz = torch.minimum(cell_xyz, hi)
    cell_id = (cell_xyz[:, 2] * ny + cell_xyz[:, 1]) * nx + cell_xyz[:, 0]
    cell_id = torch.where(mask > 0, cell_id,
                          torch.full_like(cell_id, nx * ny * nz))
    return cell_xyz, cell_id


def max_cell_occupancy(position: torch.Tensor, box: Box, mask: torch.Tensor,
                       grid: tuple) -> int:
    """The most real atoms any cell of `grid` holds (one host read)."""
    _, cell_id = _bin_atoms(position, box, mask, grid)
    n_cells = grid[0] * grid[1] * grid[2]
    return int(torch.bincount(cell_id, minlength=n_cells + 1)[:n_cells].max())


def neighbor_cell_list(position: torch.Tensor, box: Box, mask: torch.Tensor,
                       *, rc: float, mn: int, grid: tuple, cell_cap: int,
                       row_block: int = 16384) -> NeighborList:
    """O(N) sort-based cell list: atoms sorted by cell (stable), a 3^3
    stencil of cells >= rc thick (>= 3 a periodic direction), `cell_cap`
    candidates a cell; atoms past the cap are not seen."""
    n = position.shape[0]
    dtype, dev = position.dtype, position.device
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    cell_xyz, cell_id = _bin_atoms(position, box, mask, grid)
    order = torch.argsort(cell_id, stable=True)
    cell_start = torch.searchsorted(cell_id[order],
                                    torch.arange(n_cells + 1, device=dev))
    offs = torch.as_tensor(_OFFSETS, device=dev)  # (27, 3)
    dims = torch.as_tensor(grid, device=dev)
    pbc = box.pbc > 0
    slot = torch.arange(cell_cap, device=dev)
    real = mask > 0
    out = []
    for s0 in range(0, n, row_block):
        rows = torch.arange(s0, min(s0 + row_block, n), device=dev)
        neigh = cell_xyz[rows][:, None, :] + offs[None]  # (B, 27, 3)
        wrapped = torch.remainder(neigh, dims)
        in_range = torch.all(pbc | ((neigh >= 0) & (neigh < dims)), dim=-1)
        ncell = (wrapped[..., 2] * ny + wrapped[..., 1]) * nx + wrapped[..., 0]
        ncell = torch.where(in_range, ncell, torch.full_like(ncell, n_cells))
        start = cell_start[ncell]
        end = cell_start[torch.clamp(ncell + 1, max=n_cells)]
        end = torch.where(ncell >= n_cells, start, end)
        cand_pos = start[:, :, None] + slot  # (B, 27, cap)
        cand_valid = cand_pos < end[:, :, None]
        cand_j = order[torch.clamp(cand_pos, max=n - 1)]
        rij = box.minimum_image(position[cand_j]
                                - position[rows][:, None, None, :])
        d2 = torch.sum(rij ** 2, dim=-1)
        valid = (cand_valid & (d2 < rc * rc)
                 & (cand_j != rows[:, None, None]) & real[rows][:, None, None])
        b = len(rows)
        valid2 = valid.reshape(b, 27 * cell_cap)
        cnt = valid2.sum(-1).to(torch.int32)
        src, slot_valid = _compact_rows(valid2, mn)
        r12 = torch.gather(rij.reshape(b, 27 * cell_cap, 3), 1,
                           src[:, :, None].expand(-1, -1, 3))
        idx = torch.gather(cand_j.reshape(b, 27 * cell_cap), 1, src)
        idx = torch.where(slot_valid, idx, rows[:, None])
        r12 = torch.where(slot_valid[:, :, None], r12,
                          torch.full_like(r12, _FAR))
        out.append((idx.to(torch.int32), r12, slot_valid.to(dtype), cnt))
    idx, r12, smask, count = (torch.cat(x) for x in zip(*out))
    return NeighborList(idx=idx, r12=r12, mask=smask, count=count)


def neighbor_cell_dense(position: torch.Tensor, box: Box, mask: torch.Tensor,
                        *, rc: float, mn: int, grid: tuple,
                        cell_cap: int) -> NeighborList:
    """O(N) cell list on a dense cell-major layout (ForceField's builder).

    Atoms go once into a (nz, ny, nx, cap) array; the 3^3 stencil is 27
    rolls of it, distances are taken cell against cell, and only boolean
    validity is kept for the (cells * cap, 27 * cap) candidate axis.  The
    chosen displacements are recomputed from positions with an exact
    integer lattice shift for wrapped cells.  A cell holding more than
    `cell_cap` atoms sets every count to MN + 1 (overflow).
    """
    n = position.shape[0]
    dtype, dev = position.dtype, position.device
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    nslots = n_cells * cell_cap

    # binning (stable sort: the slot layout is the JAX package's)
    _, cell_id = _bin_atoms(position, box, mask, grid)
    order = torch.argsort(cell_id, stable=True)
    sorted_cell = cell_id[order]
    cell_start = torch.searchsorted(sorted_cell,
                                    torch.arange(n_cells + 1, device=dev))
    rank = (torch.arange(n, device=dev)
            - cell_start[torch.clamp(sorted_cell, max=n_cells)])
    cell_overflow = torch.max(cell_start[1:] - cell_start[:-1]) > cell_cap

    # dense cell-major arrays (one scatter; dropped rows go to a sink slot)
    dest = sorted_cell * cell_cap + torch.clamp(rank, max=cell_cap - 1)
    dest = torch.where((rank < cell_cap) & (sorted_cell < n_cells), dest,
                       torch.full_like(dest, nslots))
    dense_pos = torch.full((nslots + 1, 3), _FAR, dtype=dtype, device=dev)
    dense_pos[dest] = position[order]
    dense_idx = torch.zeros(nslots + 1, dtype=torch.int64, device=dev)
    dense_idx[dest] = order
    dense_valid = torch.zeros(nslots + 1, dtype=torch.bool, device=dev)
    dense_valid[dest] = True
    grid_pos = dense_pos[:nslots].reshape(nz, ny, nx, cell_cap, 3)
    grid_valid = dense_valid[:nslots].reshape(nz, ny, nx, cell_cap)

    coords = torch.meshgrid(torch.arange(nz, device=dev),
                            torch.arange(ny, device=dev),
                            torch.arange(nx, device=dev), indexing="ij")
    coords = (coords[2], coords[1], coords[0])  # x, y, z cell coordinates
    dims = (nx, ny, nz)
    pbc = box.pbc.tolist()
    h = box.h.to(dtype)
    eye = torch.eye(cell_cap, dtype=torch.bool, device=dev)
    valid2 = torch.empty((nslots, 27, cell_cap), dtype=torch.bool,
                         device=dev)
    for o, off in enumerate(_OFFSETS):
        ox, oy, oz = off
        rolled_pos = torch.roll(grid_pos, shifts=(-oz, -oy, -ox),
                                dims=(0, 1, 2))
        rolled_valid = torch.roll(grid_valid, shifts=(-oz, -oy, -ox),
                                  dims=(0, 1, 2))
        # integer lattice shift of wrapped cells; out of bounds if the
        # direction is not periodic
        sf = []
        inbounds = torch.ones((nz, ny, nx), dtype=torch.bool, device=dev)
        for axis in range(3):
            hi = coords[axis] + off[axis] >= dims[axis]
            lo = coords[axis] + off[axis] < 0
            sf.append(hi.to(dtype) - lo.to(dtype))
            if not pbc[axis] > 0:
                inbounds = inbounds & ~(hi | lo)
        d2 = 0.0
        for k in range(3):
            shift_k = sf[0] * h[k, 0] + sf[1] * h[k, 1] + sf[2] * h[k, 2]
            diff_k = (rolled_pos[..., None, :, k] + shift_k[..., None, None]
                      - grid_pos[..., :, None, k])
            d2 = d2 + diff_k * diff_k  # (nz, ny, nx, cap, cap)
        ok = ((d2 < rc * rc) & rolled_valid[..., None, :]
              & grid_valid[..., :, None] & inbounds[..., None, None])
        if off == (0, 0, 0):
            ok = ok & ~eye
        valid2[:, o, :] = ok.reshape(nslots, cell_cap)
    del d2, ok, diff_k

    # map back to atom order; compact and decode the atoms' rows only
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, device=dev)
    row_of_atom = torch.clamp(dest[inv_order], max=nslots - 1)
    valid_a = valid2.reshape(nslots, 27 * cell_cap)[row_of_atom]
    del valid2
    count = valid_a.sum(-1).to(torch.int32)
    src, slot_valid = _compact_rows(valid_a, mn)
    del valid_a
    # decoding is integer arithmetic (the offsets list has ox fastest)
    off_sel, slot_sel = src // cell_cap, src % cell_cap
    cell_lin = (row_of_atom // cell_cap)[:, None]
    ncx = cell_lin % nx + off_sel % 3 - 1
    ncy = (cell_lin // nx) % ny + (off_sel // 3) % 3 - 1
    ncz = cell_lin // (nx * ny) + off_sel // 9 - 1
    sfx = (ncx >= nx).to(dtype) - (ncx < 0).to(dtype)
    sfy = (ncy >= ny).to(dtype) - (ncy < 0).to(dtype)
    sfz = (ncz >= nz).to(dtype) - (ncz < 0).to(dtype)
    ncell = ((torch.remainder(ncz, nz) * ny + torch.remainder(ncy, ny)) * nx
             + torch.remainder(ncx, nx))
    idx = dense_idx[ncell * cell_cap + slot_sel]  # (N, MN)
    sel_valid = slot_valid & (mask > 0)[:, None]
    comps = []
    for k in range(3):
        shift_k = sfx * h[k, 0] + sfy * h[k, 1] + sfz * h[k, 2]
        rk = position[:, k][idx] - position[:, k][:, None] + shift_k
        comps.append(torch.where(sel_valid, rk, torch.full_like(rk, _FAR)))
    r12 = torch.stack(comps, dim=-1)
    idx = torch.where(sel_valid, idx, torch.arange(n, device=dev)[:, None])
    count = torch.where(mask > 0, count, torch.zeros_like(count))
    # cell overflow shows as a neighbour-count overflow
    count = torch.where(cell_overflow, torch.full_like(count, mn + 1), count)
    return NeighborList(idx=idx.to(torch.int32), r12=r12,
                        mask=sel_valid.to(dtype), count=count)


def default_cell_cap(box: Box, grid: tuple, n_atoms: int) -> int:
    """Expected atoms a cell times a safety factor of 2 (at least 8)."""
    volume = float(box.volume)
    vol_cell = volume / (grid[0] * grid[1] * grid[2])
    return max(8, int(np.ceil(n_atoms / volume * vol_cell * 2.0)))


def choose_grid(box: Box, rc: float) -> Optional[tuple]:
    """Host-side: a cell grid with cells >= rc thick, or None if the box is
    too thin for the cell lists (brute force with images instead)."""
    t = box.thickness().tolist()
    pbc = box.pbc.tolist()
    grid = []
    for d in range(3):
        nd = max(1, int(np.floor(float(t[d]) / rc)))
        if pbc[d] > 0 and nd < 3:
            return None
        grid.append(nd)
    return tuple(grid)


def build_neighbor_list(position, box: Box, mask, *, rc: float, mn: int,
                        reps: tuple = (0, 0, 0),
                        cell_cap: Optional[int] = None,
                        force_brute: bool = False) -> NeighborList:
    """Brute force for small or thin boxes, else the sort-based cell list
    (ref: the small-box / large-box duality of src/force/nep.cu:1356-1389),
    chosen on the host from the box."""
    n = position.shape[0]
    grid = None if force_brute else choose_grid(box, rc)
    if grid is None or n <= 2048:
        return neighbor_brute(position, box, mask, rc=rc, mn=mn, reps=reps)
    if cell_cap is None:
        cell_cap = default_cell_cap(box, grid, n)
    return neighbor_cell_list(position, box, mask, rc=rc, mn=mn, grid=grid,
                              cell_cap=cell_cap)
