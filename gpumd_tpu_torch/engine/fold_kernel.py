"""Fold of window cotangents onto interior rows: CUDA kernel + plain version.

Counterpart of gpumd_tpu/engine/fold_kernel.py.  `fold_windows_to_rows`
maps dw (nz, ny, C, nxb, wl) to interior row sums (nz, ny, C, nx*cap),
exactly fold_ghost_grad_c(fold_block_windows(dw)) viewed as rows.  A CUDA
tensor goes to the kernel in csrc/fold.cu (which, having no lane-alignment
rule, serves every plan), launched as `fold_plan` says; a CPU tensor goes
to the plain version.  `fold_windows_to_halo_rows` is the kernel's z-halo
mode for a slab of the sharded engine (engine/sharded.py): z is not
wrapped and the two ghost rows are kept for the neighbouring slabs.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine.grid import (
    DenseGridPlan,
    fold_block_windows,
    fold_ghost_grad_c,
    fold_ghost_xy,
)


def rows_to_slots(rows):
    """(nz, ny, C, nx*cap) -> (n_slots, C)."""
    c = rows.shape[2]
    return rows.movedim(2, 0).reshape(c, -1).T


def fold_windows_to_rows_plain(dw, plan: DenseGridPlan, bx: int):
    nx, ny, nz = plan.grid
    c = dw.shape[2]
    slots = fold_ghost_grad_c(fold_block_windows(dw, plan, bx), plan)
    return slots.T.reshape(c, nz, ny, nx * plan.cap).movedim(0, 2)


def fold_windows_to_halo_rows_plain(dw, plan: DenseGridPlan, bx: int):
    """fold_block_windows, then the x/y fold with the z ghost rows kept:
    (nz, ny, C, nxb, wl) -> (nz+2, ny, C, nx*cap)."""
    return fold_ghost_xy(fold_block_windows(dw, plan, bx), plan)


FOLD_THREADS = 128  # most threads a block (kFoldMaxThreads in fold.cu)


@dataclass(frozen=True)
class FoldPlan:
    """How the fold kernel runs a call: one block of `threads` an output
    row (z, y, c), `blocks` rows; a row is `units` units of `vec` floats
    (16-byte loads and stores at vec 4), walked as (x-block, lane);
    `fold_occupancy` gives the resident blocks an SM."""

    vec: int
    threads: int
    units: int
    blocks: int

    @property
    def entry(self) -> str:
        """The kernel instance's (mangled) name, as ptxas reports it."""
        return f"fold_rows_kernelILi{self.vec}E"


def fold_plan(plan: DenseGridPlan, bx: int, c: int, wl: int,
              aligned: bool = True, halo: bool = False) -> FoldPlan:
    """The fold's launch at this grid plan, or ValueError where the window
    does not cover the plan.  Units are 4 floats where cap and wl are
    multiples of 4 and the bases are 16-byte aligned, else 1.  `halo`:
    the z-halo mode, nz + 2 output rows."""
    nx, ny, nz = plan.grid
    cap = plan.cap
    if bx < 1 or nx % bx or wl < 9 * (bx + 2) * cap:
        raise ValueError("fold: window width does not cover the plan")
    vec = 4 if cap % 4 == 0 and wl % 4 == 0 and aligned else 1
    units = nx * cap // vec
    threads = min(FOLD_THREADS, -(-units // 32) * 32)
    return FoldPlan(vec, threads, units, (nz + 2 * halo) * ny * c)


def fold_occupancy(fp: FoldPlan) -> int:
    """Resident blocks an SM of the plan's kernel instance
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    rc = cuda_build.library().fold_occupancy(fp.vec, fp.threads,
                                             ctypes.addressof(blocks))
    cuda_build.check(rc, "fold_occupancy")
    return blocks.value


def _fold_cuda(dw, plan: DenseGridPlan, bx: int, halo: bool = False):
    nx, ny, nz = plan.grid
    cap = plan.cap
    c, wl = dw.shape[2], dw.shape[4]
    cuda_build.require(dw, "dw", torch.float32,
                       (nz, ny, c, nx // bx, wl))
    out = torch.empty((nz + 2 * halo, ny, c, nx * cap), dtype=dw.dtype,
                      device=dw.device)
    fp = fold_plan(plan, bx, c, wl,
                   aligned=(dw.data_ptr() | out.data_ptr()) % 16 == 0,
                   halo=halo)
    lib = cuda_build.library()
    if halo:
        rc = lib.fold_halo_launch(
            cuda_build.ptr(dw), cuda_build.ptr(out), nx, ny, nz, cap, bx, c,
            wl, int(plan.pbc[0]), int(plan.pbc[1]), fp.vec, fp.threads,
            cuda_build.stream())
        cuda_build.check(rc, "fold_halo_launch")
        cuda_build.launches["fold_halo"] += 1
        return out
    rc = lib.fold_launch(cuda_build.ptr(dw), cuda_build.ptr(out), nx, ny, nz,
                         cap, bx, c, wl, int(plan.pbc[0]), int(plan.pbc[1]),
                         int(plan.pbc[2]), fp.vec, fp.threads,
                         cuda_build.stream())
    cuda_build.check(rc, "fold_launch")
    cuda_build.launches["fold"] += 1
    return out


def fold_windows_to_rows(dw, plan: DenseGridPlan, bx: int):
    """dw (nz, ny, C, nxb, wl) -> interior row sums (nz, ny, C, nx*cap)."""
    if dw.is_cuda:
        return _fold_cuda(dw, plan, bx)
    return fold_windows_to_rows_plain(dw, plan, bx)


def fold_windows_to_halo_rows(dw, plan: DenseGridPlan, bx: int):
    """dw (nz, ny, C, nxb, wl) -> (nz+2, ny, C, nx*cap): x and y folded as
    in fold_windows_to_rows, z never wrapped; rows 0 and nz+1 hold what
    falls below and above the slab."""
    if dw.is_cuda:
        return _fold_cuda(dw, plan, bx, halo=True)
    return fold_windows_to_halo_rows_plain(dw, plan, bx)


def fold_windows_to_slots(dw, plan: DenseGridPlan, bx: int):
    """dw -> (n_slots, C), the fold_ghost_grad_c output layout."""
    return rows_to_slots(fold_windows_to_rows(dw, plan, bx))
