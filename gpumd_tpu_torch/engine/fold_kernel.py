"""Fold of window cotangents onto interior rows: CUDA kernel + plain version.

Counterpart of gpumd_tpu/engine/fold_kernel.py.  `fold_windows_to_rows`
maps dw (nz, ny, C, nxb, wl) to interior row sums (nz, ny, C, nx*cap),
exactly fold_ghost_grad_c(fold_block_windows(dw)) viewed as rows.  A CUDA
tensor goes to the kernel in csrc/fold.cu (which, having no lane-alignment
rule, serves every plan); a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine.grid import (
    DenseGridPlan,
    fold_block_windows,
    fold_ghost_grad_c,
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


def _fold_cuda(dw, plan: DenseGridPlan, bx: int):
    nx, ny, nz = plan.grid
    cap = plan.cap
    c, wl = dw.shape[2], dw.shape[4]
    cuda_build.require(dw, "dw", torch.float32,
                       (nz, ny, c, nx // bx, wl))
    if nx % bx or wl < 9 * (bx + 2) * cap:
        raise ValueError("fold: window width does not cover the plan")
    out = torch.empty((nz, ny, c, nx * cap), dtype=dw.dtype,
                      device=dw.device)
    lib = cuda_build.library()
    rc = lib.fold_launch(cuda_build.ptr(dw), cuda_build.ptr(out), nx, ny, nz,
                         cap, bx, c, wl, int(plan.pbc[0]), int(plan.pbc[1]),
                         int(plan.pbc[2]), cuda_build.stream())
    cuda_build.check(rc, "fold_launch")
    cuda_build.launches["fold"] += 1
    return out


def fold_windows_to_rows(dw, plan: DenseGridPlan, bx: int):
    """dw (nz, ny, C, nxb, wl) -> interior row sums (nz, ny, C, nx*cap)."""
    if dw.is_cuda:
        return _fold_cuda(dw, plan, bx)
    return fold_windows_to_rows_plain(dw, plan, bx)


def fold_windows_to_slots(dw, plan: DenseGridPlan, bx: int):
    """dw -> (n_slots, C), the fold_ghost_grad_c output layout."""
    return rows_to_slots(fold_windows_to_rows(dw, plan, bx))
