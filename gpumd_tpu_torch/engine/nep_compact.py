"""Compact-tile NEP engine on the dense cell grid.

Counterpart of gpumd_tpu/engine/nep_compact.py, on both of its rungs.
With compact candidate lists (cplan.cl > 0, the default) each rebuild keeps
the ~cl window lanes that lie near a block (compact_select) and sorts every
centre's neighbours over that list (build_indices_compact); each step
gathers the kept lanes (compact_rows_call straight from the ghost rows, or
compact_windows_call from a packed window) for the positions and for the
cotangent rows.  Without them (compact_lists=False, the full-window rung)
every centre indexes its block's whole window (build_indices).  Each step
runs

  compact the kept lanes of positions (cl > 0)
  K1      descriptor sums per centre (S[t,k], ZBL energy, s_{n,lm})
  middle  c-tensor contraction, rotation invariants, ANN; its VJP by
          torch.autograd.grad (the JAX package used jax.vjp)
  compact the kept lanes of the cotangent rows (cl > 0)
  K2      two-sided radial forces, ZBL, angular VJP -> centre gradient,
          virial rows and per-pair angular cotangents p_ij
  scatter p_ij onto the neighbours' window lanes (through cidx when cl > 0)
  fold    window lanes back onto the owning slots (engine/fold_kernel.py)

The two compactions, K1, K2, the scatter and the fold are hand-written CUDA
kernels (gpumd_tpu_torch/csrc/).  Each `*_call` wrapper keeps the Pallas
kernel's contract (inputs, outputs, layouts, masking) and sends a CUDA
tensor to its kernel and a CPU tensor to the plain torch version beside it;
the plain versions follow the kernels step for step.  Model constants
(c_angular, cutoffs, ZBL coefficients) are device tensors, not baked
constants.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine.fold_kernel import (
    fold_windows_to_rows,
    fold_windows_to_rows_plain,
    rows_to_slots,
)
from gpumd_tpu_torch.engine.grid import (
    FAR,
    DenseGridPlan,
    _max_occupancy,
    cell_ids,
    pack_block_windows,
    pack_ghost,
    pack_ghost_rows,
    plan_grid,
    round_up,
)
from gpumd_tpu_torch.engine.nep_dense import _ylm_tile, z_tables_flat
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.potentials.nep.model import (
    _COVALENT_RADIUS,
    _ZBL_UNIVERSAL,
    _angular_q,
)
from gpumd_tpu_torch.potentials.nep.params import NepModel, NepParams
from gpumd_tpu_torch.units import K_C

_EPS2 = 1.0e-6
_BIG = 1.0e30
# shared memory one block may use on Hopper (bytes), and what K1 and K2
# aim for: two 256-thread blocks an SM (228 KB, 1 KB reserved a block)
_SMEM_LIMIT = 232448
_SMEM_TARGET = 112 * 1024
# the scatter accumulator's bytes that leave 8 CTAs of 256 threads an SM
# (228 KB an SM, 1 KB reserved a CTA)
_SCATTER_SMEM_TARGET = 233472 // 8 - 1024
# compile-time bounds on kr1, ka1, na1 of the K1/K2 template instances
_NMAX = (8, 20)


class CompactPlan(NamedTuple):
    """Static geometry of the compact engine."""

    base: DenseGridPlan
    bx: int  # x-cells per kernel block
    mn_r: int  # radial neighbour cap (multiple of 8)
    mn_a: int  # angular cap = prefix of the radial tile (multiple of 8)
    cl: int = 0  # compact candidate lanes (0 = gather from full windows)

    @property
    def nxb(self) -> int:
        return self.base.grid[0] // self.bx

    @property
    def nb(self) -> int:
        return self.base.grid[2] * self.base.grid[1] * self.nxb

    @property
    def a(self) -> int:
        """Atom lanes per block before padding."""
        return self.bx * self.base.cap

    @property
    def a_pad(self) -> int:
        return round_up(self.a, 128)

    @property
    def wl(self) -> int:
        """Window lanes (candidate slots), padded to 128."""
        return round_up(9 * (self.bx + 2) * self.base.cap, 128)

    @property
    def src_lanes(self) -> int:
        """Lane width of K1's and K2's gather source: the compact candidate
        list when enabled, else the full window."""
        return self.cl if self.cl else self.wl


def _pick_bx(nx: int, cap: int) -> int:
    for b in range(min(nx, max(1, 128 // cap)), 0, -1):
        if nx % b == 0 and b * cap <= 128:
            return b
    return 1


def plan_grid_compact(box: Box, rc: float, skin: float, n_atoms: int,
                      position: Optional[np.ndarray] = None,
                      cap_margin: float = 1.3) -> Optional[DenseGridPlan]:
    """Grid planning scored by padded-lane volume (see the JAX package):
    scans nx downward and keeps the (nx, cap, bx) with the smallest
    nb*a_pad*64 + nb*wl//8, using the occupancy device binning sees."""
    base = plan_grid(box, rc, skin, n_atoms, position=position)
    if base is None:
        return None
    nx0, ny, nz = base.grid

    def cap_for(grid):
        if position is not None:
            occ = _max_occupancy(np.asarray(position), box, grid)
        else:
            occ = n_atoms / (grid[0] * grid[1] * grid[2])
        return max(8, int(np.ceil(occ * cap_margin / 8.0)) * 8)

    def occ_device(grid):
        probe = DenseGridPlan(grid=grid, cap=8, rc=rc, skin=skin,
                              pbc=base.pbc)
        p = box.wrap(torch.as_tensor(np.asarray(position), dtype=box.h.dtype,
                                     device=box.h.device))
        cid = cell_ids(p, box, torch.ones(p.shape[0], dtype=p.dtype,
                                          device=p.device), probe)
        cnt = torch.bincount(cid, minlength=probe.n_cells + 1)
        return int(cnt[:probe.n_cells].max())

    best = None
    for nx in range(nx0, max(2, (2 * nx0) // 3), -1):
        occ = cap_for((nx, ny, nz)) / cap_margin
        if position is not None:
            occ = max(occ, occ_device((nx, ny, nz)))
        cap = max(8, int(np.ceil(occ * cap_margin / 8.0)) * 8)
        bx = _pick_bx(nx, cap)
        nb = nz * ny * (nx // bx)
        score = (nb * round_up(bx * cap, 128) * 64
                 + nb * round_up(9 * (bx + 2) * cap, 128) // 8)
        if best is None or score < best[0]:
            best = (score, nx, cap)
    _, nx, cap = best
    return DenseGridPlan(grid=(nx, ny, nz), cap=cap, rc=rc, skin=skin,
                         pbc=base.pbc)


def make_compact_plan(plan: DenseGridPlan,
                      position: Optional[np.ndarray] = None,
                      box: Optional[Box] = None,
                      rc_angular: float = 0.0,
                      mn_r: Optional[int] = None,
                      mn_a: Optional[int] = None,
                      margin: float = 1.25,
                      slack_mul: float = 1.15,
                      slack_add: int = 4,
                      rnd: int = 8,
                      compact_lists: bool = True) -> CompactPlan:
    """Block width and neighbour caps, sized like the reference's MN
    estimation (ref nep.cu:226-237) on the initial configuration, and the
    compact candidate-list width cl (0 = full windows) when
    `compact_lists` and the list narrows the window."""
    bx = _pick_bx(plan.grid[0], plan.cap)
    if mn_r is None or mn_a is None:
        rc_out = plan.rc + plan.skin
        rc_a_out = rc_angular + plan.skin
        max_r = max_a = None
        if position is not None and box is not None:
            try:
                from scipy.spatial import cKDTree

                pos = np.asarray(position, np.float64)
                lens = box.thickness().detach().cpu().numpy().astype(
                    np.float64)
                if bool(np.all(box.pbc.detach().cpu().numpy() > 0)):
                    tree = cKDTree(np.mod(pos, lens), boxsize=lens)
                else:
                    tree = cKDTree(pos)
                m = min(len(pos), 20000)
                sel = np.random.default_rng(0).choice(len(pos), m,
                                                      replace=False)
                # +0.35 A: thermal shell buffer (see the JAX package)
                max_r = int(tree.query_ball_point(
                    tree.data[sel], rc_out + 0.35, return_length=True).max())
                max_a = int(tree.query_ball_point(
                    tree.data[sel], rc_a_out + 0.35,
                    return_length=True).max())
            except (ImportError, ValueError):
                max_r = max_a = None
        if max_r is not None:
            if mn_r is None:
                mn_r = int(round_up(int((max_r - 1) * slack_mul) + slack_add,
                                    rnd))
            if mn_a is None:
                mn_a = int(round_up(int((max_a - 1) * 1.1) + 4, 8))
        else:
            density = (position.shape[0] / float(box.volume)
                       if position is not None and box is not None else 0.05)
            est_r = density * 4.0 / 3.0 * np.pi * rc_out ** 3
            est_a = density * 4.0 / 3.0 * np.pi * rc_a_out ** 3
            if mn_r is None:
                mn_r = int(round_up(int(np.ceil(est_r * margin)) + 8, 32))
            if mn_a is None:
                mn_a = int(round_up(int(np.ceil(est_a * margin)) + 4, 8))
    mn_r = max(32, int(round_up(mn_r, 8)))
    mn_a = max(8, min(int(round_up(mn_a, 8)), mn_r))
    cl = 0
    if compact_lists and position is not None and box is not None:
        wl = round_up(9 * (bx + 2) * plan.cap, 128)
        cl_est = estimate_cl(plan, bx, position, box)
        # only pay the compaction when it narrows the source
        if cl_est <= min(4096, wl - 128):
            cl = cl_est
    return CompactPlan(base=plan, bx=bx, mn_r=mn_r, mn_a=mn_a, cl=cl)


class CompactNeighbors(NamedTuple):
    """Rebuild products of the compact-candidate path (cplan.cl > 0).

    idx:  (nz, ny, nxb, mn_r, a_pad) int32, each centre's neighbour entries
          as compact-list lanes (angular prefix first, then radial, then
          out-of-range entries parked on lane cl - 1);
    cidx: (nz, ny, nxb, cl) int32, the window lane of each compact lane;
    cnt:  (nz, ny, nxb) int32, live compact lanes per block.
    """

    idx: torch.Tensor
    cidx: torch.Tensor
    cnt: torch.Tensor


def estimate_cl(plan: DenseGridPlan, bx: int, position, box: Box,
                margin: float = 1.15, samples: int = 96) -> int:
    """Host-side compact-list capacity: exact fractional-space counts of
    atom images inside sampled blocks' bounds dilated by rc+skin (the keep
    criterion of compact_select), times a thermal-motion margin.  Every
    rebuild re-checks the count against cl and flags overflow."""
    nx, ny, nz = plan.grid
    nxb = nx // bx
    pos = np.asarray(position, np.float64)
    hinv = box.h_inv.detach().cpu().numpy().astype(np.float64)
    s = pos @ hinv.T
    s -= np.floor(s)
    rc_out = plan.rc + plan.skin
    m = rc_out * np.linalg.norm(hinv, axis=1) + 1e-4
    nbk = nz * ny * nxb
    rng = np.random.default_rng(0)
    blocks = (np.arange(nbk) if nbk <= samples
              else rng.choice(nbk, samples, replace=False))
    worst = 0
    wid = np.asarray([bx / nx, 1.0 / ny, 1.0 / nz])
    for b in blocks:
        z, rem = divmod(int(b), ny * nxb)
        y, xb = divmod(rem, nxb)
        lo = np.asarray([xb * bx / nx, y / ny, z / nz])
        images = np.ones(len(pos), np.int64)
        for d in range(3):
            delta = (s[:, d] - lo[d]) % 1.0
            # a window spanning most of a small periodic box holds an atom
            # as its direct and its wrapped image: count images
            if plan.pbc[d]:
                cnt_d = (delta <= wid[d] + m[d]).astype(np.int64) + (
                    delta >= 1.0 - m[d]).astype(np.int64)
            else:
                du = s[:, d] - lo[d]
                cnt_d = ((du >= -m[d]) & (du <= wid[d] + m[d])).astype(
                    np.int64)
            images *= cnt_d
        worst = max(worst, int(images.sum()))
    return int(round_up(int(worst * margin) + 16, 128))


def compact_select(cand, box: Box, cplan: CompactPlan):
    """Per-block compact candidate selection (rebuild time).

    A window lane is kept when its shift-carrying position lies inside the
    block's fractional cell bounds dilated by ||h_inv[d]|| * (rc+skin) per
    axis, a conservative cover of every in-range pair; empty slots and FAR
    ghosts drop out.  The kept lanes come first, in ascending window-lane
    order.  The box enters as tensors (it may change between rebuilds).

    Returns cidx (nz, ny, nxb, cl) int32, cnt (nz, ny, nxb) int32 and a
    device bool `ok`, False unless every count stays below cl: the last
    compact lane must stay a dead pad, the parking lane of
    build_indices_compact."""
    plan = cplan.base
    nx, ny, nz = plan.grid
    bx, cl = cplan.bx, cplan.cl
    dtype, dev = cand.dtype, cand.device
    hinv = box.h_inv.to(dtype)
    s = [hinv[d, 0] * cand[..., 0, :] + hinv[d, 1] * cand[..., 1, :]
         + hinv[d, 2] * cand[..., 2, :] for d in range(3)]
    rc_out = plan.rc + plan.skin
    m = [rc_out * torch.sqrt(torch.sum(hinv[d] * hinv[d])) + 1e-4
         for d in range(3)]
    zi = torch.arange(nz, dtype=dtype, device=dev)[:, None, None, None]
    yi = torch.arange(ny, dtype=dtype, device=dev)[None, :, None, None]
    xi = torch.arange(cplan.nxb, dtype=dtype, device=dev)[None, None, :, None]
    lo = [xi * bx / nx, yi / ny, zi / nz]
    hi = [(xi * bx + bx) / nx, (yi + 1.0) / ny, (zi + 1.0) / nz]
    keep = cand[..., 3, :] > -0.5
    for d in range(3):
        keep = keep & (s[d] >= lo[d] - m[d]) & (s[d] <= hi[d] + m[d])
    lane = torch.arange(keep.shape[-1], dtype=torch.int32, device=dev)
    key = torch.where(keep, lane, lane | (1 << 20))
    cidx = torch.sort(key, dim=-1).values[..., :cl] & ((1 << 20) - 1)
    cnt = torch.sum(keep, dim=-1, dtype=torch.int32)
    return cidx.contiguous(), cnt, torch.max(cnt) < cl


class CompactSpec(NamedTuple):
    """NEP tile-math sizes plus the model constants as tensors (on the
    params' device and in their dtype)."""

    num_types: int
    nr1: int
    kr1: int
    na1: int
    ka1: int
    l_max: int
    zbl_mode: int  # 0 none, 1 universal, 2 typewise, 3 flexible
    zbl_typewise_factor: float
    zbl_rc_inner: float
    zbl_rc_outer: float
    rc_radial: torch.Tensor  # (T,)
    rc_angular: torch.Tensor  # (T,)
    c_angular: torch.Tensor  # (T, T, NA1, KA1)
    znum: torch.Tensor  # (T,) atomic numbers
    rcov: torch.Tensor  # (T,) covalent radii
    zbl_flex: torch.Tensor  # (T(T+1)/2, 10), or (1, 10) zeros
    ztab: torch.Tensor  # Y_lm z-polynomials (nep_dense.z_tables_flat)

    @property
    def nlm(self) -> int:
        return self.l_max * (self.l_max + 2)

    @property
    def sr(self) -> int:
        """Radial channels: type-resolved S[t, k] sums."""
        return self.num_types * self.kr1

    @property
    def ch(self) -> int:
        """K1 output channels: S[t,k] + zbl + s_{n,lm}, padded to 8."""
        return round_up(self.sr + 1 + self.na1 * self.nlm, 8)

    @property
    def wch(self) -> int:
        """Window cotangent channels: cot_S + cot_zbl, padded to 8."""
        return round_up(self.sr + 1, 8)

    @staticmethod
    def from_model(model: NepModel, params: NepParams) -> "CompactSpec":
        if model.model_type not in (0, 3):
            raise NotImplementedError(
                "compact engine: potential / temperature models only "
                "(dipole/pol observables use the list path)")
        if model.num_types > 8:
            raise NotImplementedError(
                "compact engine: <= 8 SIMULATED species (restrict the "
                "model to the present species, or use the list path)")
        dev, dt = params.c_angular.device, params.c_angular.dtype

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dt,
                                   device=dev).contiguous()

        if not model.zbl:
            mode = 0
        elif model.zbl_flexible:
            mode = 3
        elif model.zbl_typewise_factor > 0.0:
            mode = 2
        else:
            mode = 1
        flex = (params.zbl_flex.to(dt).contiguous() if mode == 3
                else t(np.zeros((1, 10))))
        zs = np.asarray(model.atomic_numbers)
        return CompactSpec(
            num_types=model.num_types,
            nr1=model.n_max_radial + 1,
            kr1=model.basis_size_radial + 1,
            na1=model.n_max_angular + 1,
            ka1=model.basis_size_angular + 1,
            l_max=model.l_max,
            zbl_mode=mode,
            zbl_typewise_factor=float(model.zbl_typewise_factor),
            zbl_rc_inner=float(model.zbl_rc_inner),
            zbl_rc_outer=float(model.zbl_rc_outer),
            rc_radial=t(model.rc_radial),
            rc_angular=t(model.rc_angular),
            c_angular=params.c_angular.contiguous(),
            znum=t(zs),
            rcov=t(_COVALENT_RADIUS[np.maximum(zs - 1, 0)]),
            zbl_flex=flex,
            ztab=t(z_tables_flat(model.l_max)),
        )


# --------------------------------------------------------------------------
# pair-tile math of the plain versions (mirrors csrc/nep_common.cuh)
# --------------------------------------------------------------------------


def _by_type(tcode, values):
    """values[t] where tcode is within 0.5 of t (t >= 1), else values[0]."""
    out = values[0] * torch.ones_like(tcode)
    for t in range(1, values.shape[0]):
        out = torch.where(torch.abs(tcode - t) < 0.5, values[t], out)
    return out


def _type_masks(tcode, t: int):
    return [(torch.abs(tcode - tt) < 0.5).to(tcode.dtype) for tt in range(t)]


def _cheb(d, rcp, ok, k_max: int, want_grad: bool):
    """Chebyshev radial basis f_k (+ df_k/dd) on pair tiles
    (ref: find_fn / find_fn_and_fnp, nep_utilities.cuh)."""
    x_rc = d / rcp
    inside = ok & (x_rc < 1.0)
    zero = torch.zeros_like(d)
    fc = torch.where(inside, 0.5 * torch.cos(torch.pi * x_rc) + 0.5, zero)
    x = torch.clamp(2.0 * (x_rc - 1.0) ** 2 - 1.0, -1.0, 1.0)
    fs = [fc]
    fps = None
    if want_grad:
        fcp = torch.where(
            inside, -0.5 * torch.pi / rcp * torch.sin(torch.pi * x_rc), zero)
        dxdd = 4.0 * (x_rc - 1.0) / rcp
        fps = [fcp]
    if k_max >= 1:
        t_prev, t_cur = torch.ones_like(x), x
        fs.append(0.5 * (t_cur + 1.0) * fc)
        if want_grad:
            tp_prev, tp_cur = torch.zeros_like(x), torch.ones_like(x)
            fps.append(0.5 * ((t_cur + 1.0) * fcp + tp_cur * dxdd * fc))
        for _ in range(2, k_max + 1):
            t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
            fs.append(0.5 * (t_cur + 1.0) * fc)
            if want_grad:
                tp_prev, tp_cur = (tp_cur,
                                   2.0 * t_prev + 2.0 * x * tp_cur - tp_prev)
                fps.append(0.5 * ((t_cur + 1.0) * fcp + tp_cur * dxdd * fc))
    return fs, fps


def _pair_gn(fk, mi, mj, ctab, n1: int):
    """g_n = sum_k c[t_i, t_j, n, k] f_k over the (t_i, t_j) mask
    products.  fk: list of (...,) tiles; ctab (T, T, n1, k1)."""
    t = ctab.shape[0]
    f = torch.stack(fk, dim=-1)  # (..., k1)
    out = None
    for a2 in range(t):
        for b2 in range(t):
            h = (f @ ctab[a2, b2].T) * (mi[a2] * mj[b2])[..., None]
            out = h if out is None else out + h
    return [out[..., n] for n in range(n1)]


def _zbl_pair(d, inv_d, ok, ti_code, tj_code, spec: CompactSpec,
              want_grad: bool):
    """Universal / typewise / flexible ZBL pair energy (halved per ordered
    pair) and optionally dE/dd (ref: find_force_ZBL nep.cu:863-975)."""
    t = spec.num_types
    zi = _by_type(ti_code, spec.znum)
    zj = _by_type(tj_code, spec.znum)
    a_inv = (zi ** 0.23 + zj ** 0.23) * 2.134563
    x = d * a_inv
    pref = 0.5 * K_C * zi * zj
    phi = 0.0
    phip = 0.0
    if spec.zbl_mode == 3:
        mi = _type_masks(ti_code, t)
        mj = _type_masks(tj_code, t)

        def pair_coeff(col):
            acc = None
            for a2 in range(t):
                for b2 in range(t):
                    ta, tb = min(a2, b2), max(a2, b2)
                    pi = ta * t - (ta * (ta - 1)) // 2 + (tb - ta)
                    term = mi[a2] * mj[b2] * spec.zbl_flex[pi, col]
                    acc = term if acc is None else acc + term
            return acc

        rc1 = pair_coeff(0)
        rc2 = pair_coeff(1)
        for j in range(4):
            cj = pair_coeff(2 + 2 * j)
            dj = pair_coeff(3 + 2 * j)
            e = cj * torch.exp(-dj * x)
            phi = phi + e
            phip = phip - dj * e
    else:
        if spec.zbl_mode == 2:
            ri = _by_type(ti_code, spec.rcov)
            rj = _by_type(tj_code, spec.rcov)
            rc2 = torch.clamp((ri + rj) * spec.zbl_typewise_factor,
                              max=spec.zbl_rc_outer)
            rc1 = torch.zeros_like(d)
        else:
            rc1 = torch.full_like(d, spec.zbl_rc_inner)
            rc2 = torch.full_like(d, spec.zbl_rc_outer)
        zp = _ZBL_UNIVERSAL
        for j in range(4):
            e = float(zp[2 * j]) * torch.exp(-float(zp[2 * j + 1]) * x)
            phi = phi + e
            phip = phip - float(zp[2 * j + 1]) * e
    span = torch.clamp(rc2 - rc1, min=1e-30)
    frac = (d - rc1) / span
    zero = torch.zeros_like(d)
    sw = torch.where(d < rc1, torch.ones_like(d),
                     torch.where(d < rc2,
                                 0.5 * torch.cos(torch.pi * frac) + 0.5,
                                 zero))
    sw = torch.where(ok, sw, zero)
    e = pref * inv_d * phi * sw
    if not want_grad:
        return e, None
    swp = torch.where(ok & (d >= rc1) & (d < rc2),
                      -0.5 * torch.pi / span * torch.sin(torch.pi * frac),
                      zero)
    dedd = pref * ((-inv_d * inv_d) * phi * sw + inv_d * phip * a_inv * sw
                   + inv_d * phi * swp)
    return e, dedd


def _gather_lanes(src, idx):
    """src (NB, C, W), idx (NB, M, A) -> (NB, C, M, A): src[b, c, idx]."""
    nb, c, _ = src.shape
    m, a = idx.shape[1], idx.shape[2]
    flat = idx.reshape(nb, 1, m * a).long()
    return torch.take_along_dim(src, flat, dim=2).reshape(nb, c, m, a)


def _pair_geometry(dx, dy, dz, tj):
    d2 = dx * dx + dy * dy + dz * dz
    ok = (d2 > _EPS2) & (tj > -0.5)
    inv_d = torch.rsqrt(torch.clamp(d2, min=_EPS2))
    return ok, inv_d, d2 * inv_d


def _f32_tables(spec: CompactSpec, device):
    """The spec's constant tensors as the kernels take them."""
    names = ("rc_radial", "rc_angular", "c_angular", "znum", "rcov",
             "zbl_flex", "ztab")
    out = []
    for n in names:
        v = getattr(spec, n)
        if v.device != device or v.dtype != torch.float32:
            raise ValueError(f"spec.{n}: kernels take float32 on {device}")
        out.append(cuda_build.ptr(v))
    return out


class KernelLayout(NamedTuple):
    """Template instance and shared-memory plan of one K1 or K2 launch."""

    nmax: int  # compile-time bound on kr1, ka1, na1 (8 or 20)
    mw: int  # 32-bit mask words per centre (mn_a slots)
    qcap: int  # queue positions a chunk may start in
    ccap: int  # centres a chunk may hold
    fstride: int  # K1: words a queued pair keeps (g_n, Y_lm), odd
    region: int  # K2: words of the cot-rows / cot-columns region
    stage_w: int  # K2: 1 when the cot rows of the radial stage fit it
    smem: int  # bytes of dynamic shared memory a block


def _nmax(spec: CompactSpec, name: str) -> int:
    top = max(spec.kr1, spec.ka1, spec.na1)
    if not (1 <= spec.l_max <= 8 and top <= _NMAX[-1]
            and spec.num_types <= 8):
        raise ValueError(f"{name}: model outside the kernel's sizes "
                         f"(l_max 1-8, kr1/ka1/na1 <= {_NMAX[-1]}, <= 8 "
                         f"types)")
    return next(n for n in _NMAX if top <= n)


def _bookkeeping_words(a_pad: int, mw: int) -> int:
    """csrc/nep_common.cuh gk_live_views: lane_of, c_of, mask, off, chunk,
    counts."""
    return a_pad * (4 + mw) + 4


def kernel_layout(name: str, spec: CompactSpec,
                  cplan: CompactPlan) -> KernelLayout:
    """Instance and shared-memory plan of K1 ("k1") or K2 ("k2"), in the
    order the kernels lay their shared memory out.  A block targets
    _SMEM_TARGET (two 256-thread blocks an SM) and takes up to _SMEM_LIMIT
    when the target would leave chunks smaller than a block's lanes; a
    chunk always fits its worst case (every centre with mn_a pairs)."""
    nmax = _nmax(spec, name)
    a_pad, mn_a = cplan.a_pad, cplan.mn_a
    if a_pad > 1024:
        raise ValueError(f"{name}: a_pad {a_pad} above 1024")
    mw = -(-mn_a // 32)
    fixed = spec.ztab.numel() + _bookkeeping_words(a_pad, mw)
    nang = spec.na1 * spec.nlm
    for budget in (_SMEM_TARGET, _SMEM_LIMIT):
        free = budget // 4
        if name == "k1":  # window, centres, then (qcap + mn_a) pairs
            fstride, region, stage_w = (spec.na1 + spec.nlm) | 1, 0, 0
            free -= fixed + 4 * cplan.src_lanes + 4 * a_pad
            qcap, ccap = free // fstride - mn_a, a_pad
            # the pair buffer also holds the radial sums of the second
            # phase of each lane while a_pad < 256 (two threads a lane)
            red = (2 * nmax + 1) * a_pad if a_pad < 256 else 0
            words = budget // 4 - free + max((qcap + mn_a) * fstride, red)
            fits = qcap >= a_pad
        else:  # region, 6-word pairs, radial sums, centre types
            fstride, qcap = 0, 4 * a_pad
            free -= fixed + 13 * a_pad + (qcap + mn_a) * 6
            ccap = min(a_pad, (free - 3) // nang)
            rows = (spec.sr + 1) * (cplan.src_lanes + a_pad)
            stage_w = int(rows <= free - 3)
            region = round_up(max(ccap * nang, rows * stage_w), 4)
            words = budget // 4 - free + region
            fits = ccap >= min(a_pad, 16)
        if fits:
            break
    if qcap < 1 or ccap < 1 or 4 * words > _SMEM_LIMIT:
        raise ValueError(f"{name}: the plan's windows and model need more "
                         f"than {_SMEM_LIMIT} B of shared memory a block")
    return KernelLayout(nmax=nmax, mw=mw, qcap=qcap, ccap=ccap,
                        fstride=fstride, region=region, stage_w=stage_w,
                        smem=4 * words)


def kernel_occupancy(name: str, spec: CompactSpec,
                     cplan: CompactPlan) -> int:
    """Resident blocks an SM of K1 or K2's instance for this plan
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lay = kernel_layout(name, spec, cplan)
    blocks = ctypes.c_int(0)
    lib = cuda_build.library()
    fn = lib.k1_occupancy if name == "k1" else lib.k2_occupancy
    cuda_build.check(fn(spec.l_max, lay.nmax, lay.smem,
                        ctypes.addressof(blocks)), f"{name}_occupancy")
    return blocks.value


def kernel_entry(name: str, spec: CompactSpec) -> str:
    """The mangled-name fragment of K1 or K2's instance for `spec` (the
    ptxas report names template instances so)."""
    return f"{name}_kernelILi{spec.l_max}ELi{_nmax(spec, name)}E"


def _consts_args(spec: CompactSpec):
    return (spec.num_types, spec.kr1, spec.na1, spec.ka1, spec.l_max,
            spec.zbl_mode, spec.ztab.numel())


def _zbl_floats(spec: CompactSpec):
    """rc_inner, rc_outer, the typewise factor, and the distance beyond
    which every ZBL pair adds exact zeros (flexible ZBL: none)."""
    zcut = {0: 0.0, 1: spec.zbl_rc_outer, 2: spec.zbl_rc_outer}.get(
        spec.zbl_mode, float("inf"))
    return (spec.zbl_rc_inner, spec.zbl_rc_outer, spec.zbl_typewise_factor,
            zcut)


# --------------------------------------------------------------------------
# K1: descriptor sums
# --------------------------------------------------------------------------


def k1_plain(centers, cand, idx, cplan: CompactPlan, spec: CompactSpec,
             save_tiles: bool = True):
    """Plain version of K1 (csrc/nep_k1.cu) on whole tensors."""
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nb, a_pad, mn_a = cplan.nb, cplan.a_pad, cplan.mn_a
    t = spec.num_types
    c = centers.reshape(nb, 4, 1, a_pad)
    g = _gather_lanes(cand.reshape(nb, 4, -1),
                      idx.reshape(nb, cplan.mn_r, a_pad))
    dx, dy, dz, tj = g[:, 0] - c[:, 0], g[:, 1] - c[:, 1], g[:, 2] - c[:, 2], g[:, 3]
    ct = c[:, 3]
    ok, inv_d, d = _pair_geometry(dx, dy, dz, tj)
    mj = _type_masks(tj, t)
    rcp_r = 0.5 * (_by_type(ct, spec.rc_radial) + _by_type(tj, spec.rc_radial))
    fk, _ = _cheb(d, rcp_r, ok, spec.kr1 - 1, False)
    rows = [torch.sum(fk[k] * mj[tt], dim=1)
            for tt in range(t) for k in range(spec.kr1)]
    if spec.zbl_mode:
        ez, _ = _zbl_pair(d, inv_d, ok, ct, tj, spec, False)
        rows.append(torch.sum(ez, dim=1))
    else:
        rows.append(torch.zeros_like(rows[0]))
    sl = slice(0, mn_a)
    da, oka, tja = d[:, sl], ok[:, sl], tj[:, sl]
    rcp_a = 0.5 * (_by_type(ct, spec.rc_angular)
                   + _by_type(tja, spec.rc_angular))
    fka, _ = _cheb(da, rcp_a, oka, spec.ka1 - 1, False)
    gn = torch.stack(_pair_gn(fka, _type_masks(ct, t), _type_masks(tja, t),
                              spec.c_angular, spec.na1), dim=-1)
    ida = inv_d[:, sl]
    ylm = torch.stack(_ylm_tile(dx[:, sl] * ida, dy[:, sl] * ida,
                                dz[:, sl] * ida, spec.l_max), dim=0)
    s = torch.einsum("bman,lbma->nlba", gn, ylm)
    out = torch.cat([torch.stack(rows, dim=0),
                     s.reshape(spec.na1 * spec.nlm, nb, a_pad)], dim=0)
    pad = spec.ch - out.shape[0]
    if pad:
        out = torch.cat([out, out.new_zeros((pad, nb, a_pad))], dim=0)
    out = out.reshape(spec.ch, nb * a_pad)
    tiles = None
    if save_tiles:
        tiles = torch.stack([dx, dy, dz, tj], dim=1).reshape(
            nz, ny, cplan.nxb, 4, cplan.mn_r, a_pad)
    return out, tiles


def _k1_cuda(centers, cand, idx, cplan: CompactPlan, spec: CompactSpec,
             save_tiles: bool):
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nxb, nb, a_pad, src = cplan.nxb, cplan.nb, cplan.a_pad, cplan.src_lanes
    dev = centers.device
    cuda_build.require(centers, "centers", torch.float32,
                       (nz, ny, nxb, 4, a_pad))
    cuda_build.require(cand, "cand", torch.float32, (nz, ny, nxb, 4, src),
                       dev)
    cuda_build.require(idx, "idx", torch.int32,
                       (nz, ny, nxb, cplan.mn_r, a_pad), dev)
    lay = kernel_layout("k1", spec, cplan)
    out = torch.empty((spec.ch, nb * a_pad), dtype=torch.float32, device=dev)
    tiles = (torch.empty((nz, ny, nxb, 4, cplan.mn_r, a_pad),
                         dtype=torch.float32, device=dev)
             if save_tiles else None)
    lib = cuda_build.library()
    rc = lib.k1_launch(
        cuda_build.ptr(centers), cuda_build.ptr(cand), cuda_build.ptr(idx),
        cuda_build.ptr(out),
        cuda_build.ptr(tiles) if save_tiles else cuda_build.P(None),
        *_f32_tables(spec, dev), nb, a_pad, src, cplan.mn_r, cplan.mn_a,
        spec.ch, *_consts_args(spec), lay.mw, lay.qcap, lay.fstride,
        lay.nmax, lay.smem, *_zbl_floats(spec), cuda_build.stream())
    cuda_build.check(rc, "k1_launch")
    cuda_build.launches["k1"] += 1
    return out, tiles


def k1_call(centers, cand, idx, cplan: CompactPlan, spec: CompactSpec,
            save_tiles: bool = True):
    """cand (nz, ny, nxb, 4, src_lanes) -> descriptor sums in the flat
    channel-major layout (ch, NB*a_pad), plus the (nz, ny, nxb, 4, mn_r,
    a_pad) displacement/type tiles."""
    if centers.is_cuda:
        return _k1_cuda(centers, cand, idx, cplan, spec, save_tiles)
    return k1_plain(centers, cand, idx, cplan, spec, save_tiles)


# --------------------------------------------------------------------------
# K2: forces (radial two-sided; angular pair cotangents emitted)
# --------------------------------------------------------------------------


def _pch(per_atom_virial: bool) -> int:
    return round_up(12 if per_atom_virial else 3, 4)


def k2_plain(centers, tiles, idx, cotc, cotw, cplan: CompactPlan,
             spec: CompactSpec, per_atom_virial: bool):
    """Plain version of K2 (csrc/nep_k2.cu); the angular VJP uses the same
    hand-derived formula as the kernel:
      p = u sum_lm b'_lm Y_lm + (G - u (u.G)) / d,
    b_lm = sum_n cot[n,lm] g_n, b'_lm = sum_n cot[n,lm] g_n',
    G = sum_lm b_lm dY_lm/du."""
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nb, a_pad, mn_r, mn_a = cplan.nb, cplan.a_pad, cplan.mn_r, cplan.mn_a
    t, kr1, sr = spec.num_types, spec.kr1, spec.sr
    ct = centers.reshape(nb, 4, 1, a_pad)[:, 3]
    tl = tiles.reshape(nb, 4, mn_r, a_pad)
    dx, dy, dz, tj = tl[:, 0], tl[:, 1], tl[:, 2], tl[:, 3]
    ok, inv_d, d = _pair_geometry(dx, dy, dz, tj)
    u = (dx * inv_d, dy * inv_d, dz * inv_d)
    rr = (dx, dy, dz)
    cc = cotc.reshape(cotc.shape[0], nb, 1, a_pad)
    cj = _gather_lanes(cotw.reshape(nb, spec.wch, -1)[:, :sr + 1],
                       idx.reshape(nb, mn_r, a_pad))
    mi = _type_masks(ct, t)
    mj = _type_masks(tj, t)

    rcp_r = 0.5 * (_by_type(ct, spec.rc_radial) + _by_type(tj, spec.rc_radial))
    _, fkp = _cheb(d, rcp_r, ok, kr1 - 1, True)
    sig_i = torch.zeros_like(d)
    sig_j = torch.zeros_like(d)
    for k in range(kr1):
        ci = sum(mj[tt] * cc[tt * kr1 + k] for tt in range(t))
        cjr = sum(mi[tt] * cj[:, tt * kr1 + k] for tt in range(t))
        sig_i = sig_i + ci * fkp[k]
        sig_j = sig_j + cjr * fkp[k]
    if spec.zbl_mode:
        _, dedd = _zbl_pair(d, inv_d, ok, ct, tj, spec, True)
        sig_i = sig_i + cc[sr] * dedd
        sig_j = sig_j + cj[:, sr] * dedd
    sig = sig_i + sig_j
    grad = [torch.sum(-sig * u[q], dim=1) for q in range(3)]
    wv = [torch.sum(rr[av] * (-sig_j * u[bv]), dim=1)
          for av in range(3) for bv in range(3)]

    sl = slice(0, mn_a)
    da, oka, tja, ida = d[:, sl], ok[:, sl], tj[:, sl], inv_d[:, sl]
    ua = [uq[:, sl] for uq in u]
    ra = [rq[:, sl] for rq in rr]
    rcp_a = 0.5 * (_by_type(ct, spec.rc_angular)
                   + _by_type(tja, spec.rc_angular))
    fka, fkpa = _cheb(da, rcp_a, oka, spec.ka1 - 1, True)
    mja = _type_masks(tja, t)
    gn = torch.stack(_pair_gn(fka, mi, mja, spec.c_angular, spec.na1), -1)
    gnp = torch.stack(_pair_gn(fkpa, mi, mja, spec.c_angular, spec.na1), -1)
    cot_s = cc[sr + 1:sr + 1 + spec.na1 * spec.nlm, :, 0].reshape(
        spec.na1, spec.nlm, nb, a_pad)
    bl = torch.einsum("nlba,bman->lbma", cot_s, gn)
    bpl = torch.einsum("nlba,bman->lbma", cot_s, gnp)
    ylm, dylm = _ylm_tile(ua[0], ua[1], ua[2], spec.l_max, with_grad=True)
    sval = sum(bpl[lm] * ylm[lm] for lm in range(spec.nlm))
    gvec = [sum(bl[lm] * dylm[lm][q] for lm in range(spec.nlm))
            for q in range(3)]
    ug = ua[0] * gvec[0] + ua[1] * gvec[1] + ua[2] * gvec[2]
    p = [sval * ua[q] + (gvec[q] - ua[q] * ug) * ida for q in range(3)]
    grad = [grad[q] - torch.sum(p[q], dim=1) for q in range(3)]
    pch_list = list(p)
    if per_atom_virial:
        pch_list += [-ra[av] * p[bv] for av in range(3) for bv in range(3)]
    else:
        wv = [wv[av * 3 + bv] + torch.sum(-ra[av] * p[bv], dim=1)
              for av in range(3) for bv in range(3)]
    pch = _pch(per_atom_virial)
    pch_list += [torch.zeros_like(p[0])] * (pch - len(pch_list))
    pvals = torch.stack(pch_list, dim=1).reshape(nz, ny, cplan.nxb, pch,
                                                 mn_a, a_pad)
    rows = grad + wv + [torch.zeros_like(grad[0])] * 4
    out = torch.stack(rows, dim=0).reshape(16, nb * a_pad)
    return out, pvals


def _k2_cuda(centers, tiles, idx, cotc, cotw, cplan: CompactPlan,
             spec: CompactSpec, per_atom_virial: bool):
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nxb, nb, a_pad, src = cplan.nxb, cplan.nb, cplan.a_pad, cplan.src_lanes
    mn_r, mn_a = cplan.mn_r, cplan.mn_a
    dev = centers.device
    cuda_build.require(centers, "centers", torch.float32,
                       (nz, ny, nxb, 4, a_pad))
    cuda_build.require(tiles, "tiles", torch.float32,
                       (nz, ny, nxb, 4, mn_r, a_pad), dev)
    cuda_build.require(idx, "idx", torch.int32, (nz, ny, nxb, mn_r, a_pad),
                       dev)
    cuda_build.require(cotc, "cotc", torch.float32, (spec.ch, nb * a_pad),
                       dev)
    cuda_build.require(cotw, "cotw", torch.float32,
                       (nz, ny, nxb, spec.wch, src), dev)
    lay = kernel_layout("k2", spec, cplan)
    pch = _pch(per_atom_virial)
    out = torch.empty((16, nb * a_pad), dtype=torch.float32, device=dev)
    pvals = torch.empty((nz, ny, nxb, pch, mn_a, a_pad), dtype=torch.float32,
                        device=dev)
    lib = cuda_build.library()
    rc = lib.k2_launch(
        cuda_build.ptr(centers), cuda_build.ptr(tiles), cuda_build.ptr(idx),
        cuda_build.ptr(cotc), cuda_build.ptr(cotw), cuda_build.ptr(out),
        cuda_build.ptr(pvals), *_f32_tables(spec, dev), nb, a_pad, src, mn_r,
        mn_a, spec.wch, pch, int(per_atom_virial), *_consts_args(spec),
        lay.mw, lay.qcap, lay.ccap, lay.region, lay.stage_w, lay.nmax,
        lay.smem, *_zbl_floats(spec), cuda_build.stream())
    cuda_build.check(rc, "k2_launch")
    cuda_build.launches["k2"] += 1
    return out, pvals


def k2_call(centers, tiles, idx, cotc, cotw, cplan: CompactPlan,
            spec: CompactSpec, per_atom_virial: bool):
    """cotc (ch, NB*a_pad) from the middle's VJP and the window cotangent
    rows cotw (nz, ny, nxb, wch, src_lanes) -> (16, NB*a_pad) centre
    gradient + virial rows, and pair cotangents (nz, ny, nxb, pch, mn_a,
    a_pad), pch = 4 (12 with per_atom_virial)."""
    if centers.is_cuda:
        return _k2_cuda(centers, tiles, idx, cotc, cotw, cplan, spec,
                        per_atom_virial)
    return k2_plain(centers, tiles, idx, cotc, cotw, cplan, spec,
                    per_atom_virial)


# --------------------------------------------------------------------------
# scatter of pair cotangents onto window lanes
# --------------------------------------------------------------------------


def scatter_plain(pvals, idx_pairs, cplan: CompactPlan, cidx=None):
    """Plain version of csrc/scatter.cu."""
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nb, nxb, wl = cplan.nb, cplan.nxb, cplan.wl
    pch, mnp, a_pad = pvals.shape[3], pvals.shape[4], pvals.shape[5]
    vals = pvals.reshape(nb, pch, mnp * a_pad)
    lanes = idx_pairs.reshape(nb, mnp * a_pad).long()
    if cidx is not None:  # compact lanes -> window lanes
        lanes = torch.gather(cidx.reshape(nb, -1).long(), 1, lanes)
    lanes = lanes[:, None, :].expand(nb, pch, mnp * a_pad)
    acc = vals.new_zeros((nb, pch, wl)).scatter_add_(2, lanes, vals)
    return acc.reshape(nz, ny, nxb, pch, wl).permute(0, 1, 3, 2, 4) \
        .contiguous()


class ScatterPlan(NamedTuple):
    """How csrc/scatter.cu runs a call: `group` channels a CTA (the kernel
    instance's G) in a shared-memory accumulator of `smem` bytes, `groups`
    CTAs a grid block (`ctas` in all, 256 threads each), units of `vec`
    lanes (16-byte loads and stores at 4); `scatter_occupancy` gives the
    resident CTAs an SM."""

    vec: int
    group: int
    groups: int
    smem: int
    ctas: int

    @property
    def entry(self) -> str:
        """The kernel instance's (mangled) name stem, as ptxas reports it."""
        return f"14scatter_kernelILi{self.vec}ELi{self.group}E"


def scatter_plan(nb: int, pch: int, wl: int, a_pad: int,
                 aligned: bool = True) -> ScatterPlan:
    """The scatter's launch for nb blocks of pch channels over a window of
    wl lanes, or ValueError where one channel's accumulator does not fit
    in a block's shared memory.  Two channels a CTA where 2 divides pch
    and their accumulator leaves 8 CTAs an SM, else 1; 4-lane units where
    a_pad and wl are multiples of 4 and the bases and idx strides allow
    16-byte loads (`aligned`), else 1."""
    if 4 * wl > _SMEM_LIMIT:
        raise ValueError(f"scatter: one channel's window accumulator "
                         f"({4 * wl} B) exceeds shared memory "
                         f"({_SMEM_LIMIT} B)")
    group = 2 if pch % 2 == 0 and 8 * wl <= _SCATTER_SMEM_TARGET else 1
    vec = 4 if a_pad % 4 == 0 and wl % 4 == 0 and aligned else 1
    groups = pch // group
    return ScatterPlan(vec, group, groups, 4 * group * wl, nb * groups)


def scatter_occupancy(sp: ScatterPlan) -> int:
    """Resident CTAs an SM of the plan's kernel instance
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    rc = cuda_build.library().scatter_occupancy(sp.vec, sp.group, sp.smem,
                                                ctypes.addressof(blocks))
    cuda_build.check(rc, "scatter_occupancy")
    return blocks.value


def _scatter_cuda(pvals, idx_pairs, cplan: CompactPlan, cidx):
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nb, nxb, wl = cplan.nb, cplan.nxb, cplan.wl
    pch, mnp, a_pad = pvals.shape[3], pvals.shape[4], pvals.shape[5]
    cuda_build.require(pvals, "pvals", torch.float32,
                       (nz, ny, nxb, pch, mnp, a_pad))
    # idx_pairs may be the mn_a prefix view of idx: lanes contiguous,
    # blocks and rows strided
    if (idx_pairs.dtype != torch.int32 or idx_pairs.device != pvals.device
            or tuple(idx_pairs.shape) != (nz, ny, nxb, mnp, a_pad)
            or idx_pairs.stride(4) != 1
            or idx_pairs.stride(1) != nxb * idx_pairs.stride(2)
            or idx_pairs.stride(0) != ny * idx_pairs.stride(1)):
        raise ValueError("scatter: idx_pairs must be int32 (nz, ny, nxb, "
                         "mnp, a_pad) on the pvals device, lanes contiguous")
    if cidx is not None:
        cuda_build.require(cidx, "cidx", torch.int32,
                           (nz, ny, nxb, cplan.cl), pvals.device)
    out = torch.empty((nz, ny, pch, nxb, wl), dtype=torch.float32,
                      device=pvals.device)
    bstride, mstride = idx_pairs.stride(2), idx_pairs.stride(3)
    aligned = ((pvals.data_ptr() | idx_pairs.data_ptr() | out.data_ptr())
               % 16 == 0 and bstride % 4 == 0 and mstride % 4 == 0)
    sp = scatter_plan(nb, pch, wl, a_pad, aligned)
    lib = cuda_build.library()
    rc = lib.scatter_launch(
        cuda_build.ptr(pvals), cuda_build.ptr(idx_pairs),
        cuda_build.P(None) if cidx is None else cuda_build.ptr(cidx),
        cuda_build.ptr(out), nb, pch, mnp, a_pad, wl, nxb, bstride, mstride,
        cplan.cl, sp.vec, sp.group, cuda_build.stream())
    cuda_build.check(rc, "scatter_launch")
    cuda_build.launches["scatter"] += 1
    return out


def scatter_call(pvals, idx_pairs, cplan: CompactPlan, cidx=None):
    """pvals (nz, ny, nxb, pch, mnp, a_pad) + idx_pairs (nz, ny, nxb, mnp,
    a_pad) -> window cotangents (nz, ny, pch, nxb, wl).  With compact lists
    idx_pairs holds compact lanes and `cidx` (nz, ny, nxb, cl) maps them to
    window lanes."""
    if (cidx is None) != (cplan.cl == 0):
        raise ValueError("scatter: cidx is required exactly when cplan.cl "
                         "> 0")
    if pvals.is_cuda:
        return _scatter_cuda(pvals, idx_pairs, cplan, cidx)
    return scatter_plain(pvals, idx_pairs, cplan, cidx)


# --------------------------------------------------------------------------
# compaction of the kept window lanes
# --------------------------------------------------------------------------


def rows_compact_eligible(cplan: CompactPlan) -> bool:
    """The JAX package's dispatch between the two compactions: gather
    straight from the ghost rows when the window groups and x-block offsets
    are 128-lane aligned (then wl == 9 * (bx + 2) * cap), else from a
    packed window."""
    cap = cplan.base.cap
    wgrp = (cplan.bx + 2) * cap
    return (cplan.cl > 0 and wgrp % 128 == 0
            and (cplan.bx * cap) % 128 == 0)


def compact_rows_plain(grows, cidx, cplan: CompactPlan):
    """Plain version of csrc/compact.cu:compact_rows_kernel.  Window lane L
    of block (z, y, xb) is ghost row (z + dz, y + dy), lane xb*bx*cap +
    off, with g = L // wgrp = 3 dz + dy and off = L % wgrp (the lane
    numbering of pack_block_windows)."""
    ny, nz = cplan.base.grid[1], cplan.base.grid[2]
    cap = cplan.base.cap
    wgrp = (cplan.bx + 2) * cap
    _, nyg, c, lanes = grows.shape
    dev = cidx.device
    lane = cidx.long()
    g, off = lane // wgrp, lane % wgrp
    z = torch.arange(nz, device=dev)[:, None, None, None]
    y = torch.arange(ny, device=dev)[None, :, None, None]
    xb = torch.arange(cplan.nxb, device=dev)[None, None, :, None]
    row = (z + g // 3) * nyg + (y + g % 3)
    fidx = row * lanes + xb * (cplan.bx * cap) + off
    flat = grows.movedim(2, 0).reshape(c, -1)
    out = flat[:, fidx.reshape(-1)].reshape((c,) + tuple(cidx.shape))
    return out.movedim(0, 3).contiguous()


def _check_rows(grows, cplan: CompactPlan):
    nx, ny, nz = cplan.base.grid
    if not rows_compact_eligible(cplan):  # JAX's dispatch, kept as is
        raise ValueError("compact_rows: plan not rows_compact_eligible")
    if (grows.dim() != 4 or grows.shape[0] != nz + 2
            or grows.shape[1] != ny + 2
            or grows.shape[3] != (nx + 2) * cplan.base.cap):
        raise ValueError(f"compact_rows: ghost rows of shape "
                         f"{tuple(grows.shape)} do not fit the plan")


def _compact_rows_cuda(grows, cidx, cplan: CompactPlan):
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nxb, cl, cap = cplan.nxb, cplan.cl, cplan.base.cap
    _, nyg, c, lanes = grows.shape
    cuda_build.require(grows, "grows", torch.float32)
    cuda_build.require(cidx, "cidx", torch.int32, (nz, ny, nxb, cl),
                       grows.device)
    out = torch.empty((nz, ny, nxb, c, cl), dtype=torch.float32,
                      device=grows.device)
    lib = cuda_build.library()
    rc = lib.compact_rows_launch(
        cuda_build.ptr(grows), cuda_build.ptr(cidx), cuda_build.ptr(out),
        cplan.nb, ny, nxb, nyg, c, lanes, cl, (cplan.bx + 2) * cap,
        cplan.bx * cap, cuda_build.stream())
    cuda_build.check(rc, "compact_rows_launch")
    cuda_build.launches["compact_rows"] += 1
    return out


def compact_rows_call(grows, cidx, cplan: CompactPlan):
    """Ghost-padded rows (nz+2, ny+2, C, (nx+2)*cap) + cidx -> compact
    source (nz, ny, nxb, C, cl), without packing the window: the window is
    a lane renumbering of 9 ghost-row slices.  Equals
    compact_windows_call(pack_block_windows(grows), cidx) on the plans
    rows_compact_eligible accepts."""
    _check_rows(grows, cplan)
    if grows.is_cuda:
        return _compact_rows_cuda(grows, cidx, cplan)
    return compact_rows_plain(grows, cidx, cplan)


def compact_windows_plain(win, cidx, cplan: CompactPlan):
    """Plain version of csrc/compact.cu:compact_windows_kernel."""
    lanes = cidx.long()[:, :, :, None, :].expand(
        tuple(win.shape[:4]) + (cplan.cl,))
    return torch.gather(win, 4, lanes)


def _compact_windows_cuda(win, cidx, cplan: CompactPlan):
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nxb, cl = cplan.nxb, cplan.cl
    c, wl = win.shape[3], win.shape[4]
    cuda_build.require(win, "win", torch.float32, (nz, ny, nxb, c, wl))
    cuda_build.require(cidx, "cidx", torch.int32, (nz, ny, nxb, cl),
                       win.device)
    out = torch.empty((nz, ny, nxb, c, cl), dtype=torch.float32,
                      device=win.device)
    lib = cuda_build.library()
    rc = lib.compact_windows_launch(
        cuda_build.ptr(win), cuda_build.ptr(cidx), cuda_build.ptr(out),
        cplan.nb, c, wl, cl, cuda_build.stream())
    cuda_build.check(rc, "compact_windows_launch")
    cuda_build.launches["compact_windows"] += 1
    return out


def compact_windows_call(win, cidx, cplan: CompactPlan):
    """win (nz, ny, nxb, C, wl) + cidx -> compact source (nz, ny, nxb, C,
    cl).  Pad lanes (>= cnt) carry whatever they index: callers that feed
    positions mask them FAR (mask_compact_pads)."""
    if win.is_cuda:
        return _compact_windows_cuda(win, cidx, cplan)
    return compact_windows_plain(win, cidx, cplan)


def mask_compact_pads(cand_c, cnt):
    """Park pad lanes (lane >= cnt) at FAR with type -1 so that parked
    neighbour entries never alias a live atom."""
    cl = cand_c.shape[-1]
    lane = torch.arange(cl, device=cand_c.device)
    valid = lane < cnt[..., None, None]
    fill = cand_c.new_zeros((cand_c.shape[3], 1))
    fill[:3] = FAR
    fill[3:4] = -1.0
    return torch.where(valid, cand_c, fill)


# --------------------------------------------------------------------------
# assembly
# --------------------------------------------------------------------------


def block_centers(garr, cplan: CompactPlan):
    """Ghost grid -> (nz, ny, nxb, C, a_pad) centre blocks (pad lanes at
    FAR with type -1)."""
    plan = cplan.base
    nx, ny, nz = plan.grid
    cap = plan.cap
    c = garr.shape[2]
    inner = garr[1:-1, 1:-1, :, cap:cap + nx * cap]
    v = inner.reshape(nz, ny, c, cplan.nxb, cplan.a).movedim(2, 3)
    if cplan.a_pad > cplan.a:
        pad = v.new_zeros(v.shape[:-1] + (cplan.a_pad - cplan.a,))
        if c >= 4:
            pad[..., :3, :] = FAR
            pad[..., 3, :] = -1.0
        v = torch.cat([v, pad], dim=-1)
    return v.contiguous()


def build_indices(centers, cand, cplan: CompactPlan, rc_a_max: float):
    """Per-atom window-relative neighbour indices, distance-sorted (stable,
    so ties keep lane order as in the JAX package).  Returns idx
    (nz, ny, nxb, mn_r, a_pad) int32 and a device bool `ok`, False when a
    radial or angular count exceeds its cap (the reference's neighbour
    overflow abort)."""
    plan = cplan.base
    rcut2 = (plan.rc + plan.skin) ** 2
    rca2 = (rc_a_max + plan.skin) ** 2
    slabs = []
    ok = torch.ones((), dtype=torch.bool, device=centers.device)
    for z in range(plan.grid[2]):
        c, w = centers[z], cand[z]
        d2 = None
        for k in range(3):
            diff = w[..., k, None, :] - c[..., k, :, None]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        live = d2 > _EPS2
        near = live & (d2 < rcut2)
        key = torch.where(near, d2, torch.full_like(d2, _BIG))
        order = torch.argsort(key, dim=-1, stable=True)[..., :cplan.mn_r]
        cnt_r = torch.sum(near, dim=-1)
        cnt_a = torch.sum(live & (d2 < rca2), dim=-1)
        ok = ok & (cnt_r.max() <= cplan.mn_r) & (cnt_a.max() <= cplan.mn_a)
        slabs.append(order.to(torch.int32).transpose(-1, -2))
    return torch.stack(slabs).contiguous(), ok


def build_indices_compact(centers, cand_c, cplan: CompactPlan,
                          rc_a_max: float):
    """Per-atom neighbour entries over the compact candidate list.

    The kernels need only a class partition (angular prefix, radial,
    out of range), so each lane gets one int32 key, class << 12 | lane;
    the keys of a row are unique, so the sort gives the JAX package's
    order.  Out-of-range entries are parked on lane cl - 1, which
    mask_compact_pads keeps FAR.  Returns idx (nz, ny, nxb, mn_r, a_pad)
    int32 and a device bool `ok`, False when a radial or angular count
    exceeds its cap."""
    plan = cplan.base
    rcut2 = (plan.rc + plan.skin) ** 2
    rca2 = (rc_a_max + plan.skin) ** 2
    if cplan.cl > 4096:
        raise ValueError("build_indices_compact: cl above the 12-bit lane "
                         "field of the sort key")
    lane = torch.arange(cplan.cl, dtype=torch.int32, device=centers.device)
    slabs = []
    ok = torch.ones((), dtype=torch.bool, device=centers.device)
    for z in range(plan.grid[2]):
        c, w = centers[z], cand_c[z]
        d2 = None
        for k in range(3):
            diff = w[..., k, None, :] - c[..., k, :, None]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        live = d2 > _EPS2
        two = torch.full_like(d2, 2, dtype=torch.int32)
        cls = torch.where(live & (d2 < rca2), 0,
                          torch.where(live & (d2 < rcut2), 1, two))
        key = torch.sort((cls << 12) | lane, dim=-1).values[..., :cplan.mn_r]
        idx = torch.where(key >> 12 >= 2, cplan.cl - 1, key & 0xFFF)
        cnt_a = torch.sum(cls == 0, dim=-1)
        cnt_r = cnt_a + torch.sum(cls == 1, dim=-1)
        ok = ok & (cnt_r.max() <= cplan.mn_r) & (cnt_a.max() <= cplan.mn_a)
        slabs.append(idx.to(torch.int32).transpose(-1, -2))
    return torch.stack(slabs).contiguous(), ok


def build_compact_neighbors(garr, box: Box, cplan: CompactPlan,
                            rc_a_max: float, plain: bool = False):
    """Full rebuild of the compact-candidate path: windows -> keep and sort
    -> compact positions -> per-atom class sort.  Returns
    (CompactNeighbors, ok)."""
    plan = cplan.base
    centers = block_centers(garr, cplan)
    cand = pack_block_windows(garr, plan, cplan.bx, cplan.wl)
    cidx, cnt, ok_cl = compact_select(cand, box, cplan)
    if rows_compact_eligible(cplan):
        rowsf = compact_rows_plain if plain else compact_rows_call
        cand_c = rowsf(garr, cidx, cplan)
    else:
        winf = compact_windows_plain if plain else compact_windows_call
        cand_c = winf(cand, cidx, cplan)
    cand_c = mask_compact_pads(cand_c, cnt)
    idx, ok = build_indices_compact(centers, cand_c, cplan, rc_a_max)
    return CompactNeighbors(idx=idx, cidx=cidx, cnt=cnt), ok & ok_cl


def _slots_to_lane_blocks(vals, cplan: CompactPlan, fill):
    """Per-slot (ns,) -> (NB, a_pad), lane-padded with `fill`."""
    v = vals.reshape(cplan.nb, cplan.a)
    if cplan.a_pad > cplan.a:
        v = torch.cat([v, torch.full((cplan.nb, cplan.a_pad - cplan.a), fill,
                                     dtype=v.dtype, device=v.device)], 1)
    return v


def _lane_blocks_to_slots(v, cplan: CompactPlan):
    """(NB, a_pad) -> (ns,)."""
    return v[:, :cplan.a].reshape(-1)


def blocks_to_slots(v, cplan: CompactPlan):
    """(nz, ny, nxb, C, a_pad) -> (n_slots, C)."""
    v = v[..., :cplan.a].movedim(3, 4)
    return v.reshape(-1, v.shape[-1])


def middle_compact_flat(s_rad, e_zbl, s_flat, ti, mask, model: NepModel,
                        params: NepParams, temperature=None):
    """c-tensor contraction + invariants + ANN in the flat channel-major
    layout: s_rad (T*KR1, N), e_zbl (N,), s_flat (NA1*NLM, N), ti (N,),
    mask (N,) -> per-lane energy (N,)."""
    dtype = s_rad.dtype
    n = s_rad.shape[-1]
    t = model.num_types
    kr1 = model.basis_size_radial + 1
    nr1 = model.n_max_radial + 1
    na1 = model.n_max_angular + 1
    nlm = model.l_max * (model.l_max + 2)
    c_r = params.c_radial.to(dtype)
    w_r = c_r.movedim(1, 2).reshape(t * nr1, t * kr1)
    # unbind, not indexing: one stacked backward instead of one full-size
    # gradient buffer per selected row
    qr_all = (w_r @ s_rad).reshape(t, nr1, n).unbind(0)
    q_rad = qr_all[0]
    for a_t in range(1, t):
        q_rad = torch.where(ti == a_t, qr_all[a_t], q_rad)
    q_ang = _angular_q(s_flat.reshape(1, na1, nlm, n), model,
                       channels_last=False)[0]
    q = torch.cat([q_rad, q_ang.reshape(-1, n)], dim=0)
    if model.model_type == 3:
        q = torch.cat([q, torch.full((1, n), float(temperature), dtype=dtype,
                                     device=q.device)], dim=0)
    q = q * params.q_scaler.to(dtype)[:, None]
    w0 = params.w0.to(dtype)
    u, dd = w0.shape[1], w0.shape[2]
    z = (w0.reshape(t * u, dd) @ q
         - params.b0.to(dtype).reshape(t * u)[:, None]).reshape(
             t, u, n).unbind(0)
    zsel = z[0]
    for a_t in range(1, t):
        zsel = torch.where(ti == a_t, z[a_t], zsel)
    e_all = (params.w1.to(dtype) @ torch.tanh(zsel)).unbind(0)
    b1t = params.b1_type.to(dtype)
    e = e_all[0] - b1t[0]
    for a_t in range(1, t):
        e = torch.where(ti == a_t, e_all[a_t] - b1t[a_t], e)
    e = e - params.b1.to(dtype)
    return (e + e_zbl) * mask


class CompactNepOutput(NamedTuple):
    energy: torch.Tensor  # (n_slots,)
    force: torch.Tensor  # (n_slots, 3)
    virial_total: torch.Tensor  # (3, 3)
    virial_atom: Optional[torch.Tensor]  # (n_slots, 3, 3) or None


def pin_fp32_matmul():
    """Full-f32 matmuls on the card: TF32 noise on the middle and its VJP
    breaks energy conservation, as bf16 passes did on the TPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def compact_nep_compute(position_slots, type_slots, slot_mask, box: Box,
                        cplan: CompactPlan, idx, model: NepModel,
                        params: NepParams, per_atom_virial: bool = False,
                        temperature=None, spec: Optional[CompactSpec] = None,
                        plain: bool = False) -> CompactNepOutput:
    """Full compact-tile NEP evaluation on dense slot state.  `idx` comes
    from the last rebin: build_indices, or build_compact_neighbors when
    cplan.cl > 0.  `plain=True` runs every kernel's plain version (the
    reference run on the card)."""
    if model.model_type == 3 and temperature is None:
        raise ValueError("temperature-mode NEP needs `temperature`")
    if position_slots.is_cuda:
        pin_fp32_matmul()
    garr = pack_ghost(position_slots, type_slots, slot_mask, box, cplan.base)
    return compact_pipeline(garr, type_slots, slot_mask, cplan, idx, model,
                            params, per_atom_virial=per_atom_virial,
                            temperature=temperature, spec=spec, plain=plain)


def compact_pipeline(garr, type_slots, slot_mask, cplan: CompactPlan, idx,
                     model: NepModel, params: NepParams,
                     per_atom_virial: bool, temperature=None,
                     spec: Optional[CompactSpec] = None, plain: bool = False,
                     keep: Optional[dict] = None) -> CompactNepOutput:
    """(compaction ->) K1 -> middle (+VJP) -> (compaction ->) K2 -> scatter
    -> fold on the ghost array `garr`.  `idx` is build_indices' tensor, or
    a CompactNeighbors when cplan.cl > 0.  `keep`, when given, receives
    every kernel's inputs and outputs (for checks against the plain
    versions)."""
    plan = cplan.base
    spec = spec or CompactSpec.from_model(model, params)
    if plain:
        k1f, k2f, scf, foldf = (k1_plain, k2_plain, scatter_plain,
                                fold_windows_to_rows_plain)
        rowsf, winf = compact_rows_plain, compact_windows_plain
    else:
        k1f, k2f, scf, foldf = (k1_call, k2_call, scatter_call,
                                fold_windows_to_rows)
        rowsf, winf = compact_rows_call, compact_windows_call
    dtype = garr.dtype
    nz, ny = plan.grid[2], plan.grid[1]
    nb, a_pad, a = cplan.nb, cplan.a_pad, cplan.a
    n_flat = nb * a_pad
    sr = spec.sr
    nsd = spec.na1 * spec.nlm
    rows_path = rows_compact_eligible(cplan)
    saved = {}

    centers = block_centers(garr, cplan)
    if cplan.cl:
        if not isinstance(idx, CompactNeighbors):
            raise TypeError("compact lists: idx must be CompactNeighbors")
        neigh, idx = idx, idx.idx
        cidx = neigh.cidx
        if rows_path:  # straight from the 9 ghost-row slices
            cand_c = rowsf(garr, cidx, cplan)
        else:
            saved["cand_win"] = pack_block_windows(garr, plan, cplan.bx,
                                                   cplan.wl)
            cand_c = winf(saved["cand_win"], cidx, cplan)
        cand = mask_compact_pads(cand_c, neigh.cnt)
        saved.update(cidx=cidx, cnt=neigh.cnt, cand_c=cand_c)
    else:
        cidx = None
        cand = pack_block_windows(garr, plan, cplan.bx, cplan.wl)
    k1, tiles = k1f(centers, cand, idx, cplan, spec)

    ti_f = _slots_to_lane_blocks(type_slots.to(torch.int64), cplan,
                                 0).reshape(n_flat)
    mask_f = _slots_to_lane_blocks(slot_mask, cplan, 0.0).reshape(n_flat)
    with torch.enable_grad():
        srad = k1[:sr].detach().requires_grad_(True)
        ez = k1[sr].detach().requires_grad_(True)
        sf = k1[sr + 1:sr + 1 + nsd].detach().requires_grad_(True)
        e_flat = middle_compact_flat(srad, ez, sf, ti_f, mask_f, model,
                                     params, temperature=temperature)
        cot_sr, cot_z, cot_s = torch.autograd.grad(e_flat.sum(),
                                                   (srad, ez, sf))
    e_atom = _lane_blocks_to_slots(e_flat.detach().reshape(nb, a_pad), cplan)

    zeros = garr.new_zeros
    ch_pad = spec.ch - (sr + 1 + nsd)
    cotc = torch.cat([cot_sr, cot_z[None], cot_s, zeros((ch_pad, n_flat))],
                     dim=0)
    wpad = spec.wch - (sr + 1)
    cotw_rows = torch.cat([cot_sr, cot_z[None], zeros((wpad, n_flat))],
                          dim=0).reshape(spec.wch, nz, ny, cplan.nxb, a_pad)
    rows = cotw_rows[..., :a].movedim(0, 2).reshape(nz, ny, spec.wch,
                                                    cplan.nxb * a)
    rows_p = pack_ghost_rows(rows, plan)
    if cplan.cl and rows_path:
        cotw = rowsf(rows_p, cidx, cplan)
    else:
        cotw = pack_block_windows(rows_p, plan, cplan.bx, cplan.wl,
                                  far_channels=0)
        if cplan.cl:
            saved["cotw_win"] = cotw
            cotw = winf(cotw, cidx, cplan)

    outf, pvals = k2f(centers, tiles, idx, cotc, cotw, cplan, spec,
                      per_atom_virial)
    idx_a = idx[:, :, :, :cplan.mn_a, :]
    dcand = scf(pvals, idx_a, cplan, cidx)
    drows = foldf(dcand, plan, cplan.bx)
    dslots = rows_to_slots(drows)
    if keep is not None:
        keep.update(garr=garr, rows_p=rows_p, centers=centers, cand=cand,
                    idx=idx, k1=k1, tiles=tiles, cotc=cotc, cotw=cotw,
                    outf=outf, pvals=pvals, idx_a=idx_a, dcand=dcand,
                    drows=drows, **saved)

    og = outf.reshape(16, nb, a_pad)[..., :a].reshape(16, -1).T
    force = -(og[:, :3] + dslots[:, :3]) * slot_mask[:, None]
    w_local = og[:, 3:12].reshape(-1, 3, 3)
    if per_atom_virial:
        w_atom = (w_local + dslots[:, 3:12].reshape(-1, 3, 3)) \
            * slot_mask[:, None, None]
        w_total = torch.sum(w_atom, dim=0)
    else:
        w_atom = None
        w_total = torch.einsum("nab,n->ab", w_local, slot_mask.to(dtype))
    return CompactNepOutput(energy=e_atom, force=force, virial_total=w_total,
                            virial_atom=w_atom)
