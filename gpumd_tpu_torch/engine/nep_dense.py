"""Dense-window NEP engines on the cell grid.

Counterpart of gpumd_tpu/engine/nep_dense.py, both of its engines.  Every
centre of a cell meets every slot of the 27 cells around it; pairs beyond
the cutoff add exact zeros.  Per cell the kernels accumulate the
type-resolved basis sums

    S[t, k]      = sum_{j: type_j = t} f_k(r_ij)             (+ ZBL energy)
    A[t, k, lm]  = sum_{j: type_j = t} f_k(r_ij) Y_lm(u_ij)

and the middle (`middle_energy`, plain torch) contracts them with the c
tensors, forms the rotation invariants and runs the ANN; its VJP is
torch.autograd.grad.  The backward kernels take the cotangents of S and A
back to the centre and candidate coordinates.

  round 2, `dense_nep_compute_v2` (DenseNEPMD(engine="v2")):
    pack_candidates -> K1b -> middle + VJP -> K2b -> fold_candidate_grad
  round 1, `dense_nep_compute`:
    ghost rows -> K1 -> middle + VJP -> K2 -> 81 slice-adds

K1b, K2b, K1 and K2 are hand-written CUDA kernels (csrc/nep_dense.cu),
sharing one pair evaluation; the round-1 pair only reads and writes other
layouts.  Each `*_call` keeps the Pallas kernel's contract and sends a CUDA
tensor to its kernel and a CPU tensor to the plain torch version beside
it.  The plain versions evaluate `_tile_chunk`, the JAX package's tile
math, over chunks of cells, and the backward ones differentiate it with
torch.autograd, an independent check of the kernels' hand-derived
gradient.  Total virial: W = -sum_g x_g (x) dE/dx_g over the ghost
coordinates; per-atom virials are not produced.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine.grid import (
    DenseGridPlan,
    fold_candidate_grad,
    fold_ghost_grad,
    pack_candidates,
    pack_ghost,
)
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.potentials.nep import tables
from gpumd_tpu_torch.potentials.nep.model import (
    _ZBL_UNIVERSAL,
    _angular_q,
    ann_energy,
)
from gpumd_tpu_torch.potentials.nep.params import NepModel, NepParams
from gpumd_tpu_torch.units import K_C

_EPS2 = 1.0e-6  # d^2 below this: self pair or parked slot, masked
# shared memory one block may use on Hopper (bytes), and the most that
# lets three blocks share an SM (228 KB an SM, 1 KB reserved a block), as
# many as the kernels' registers allow (their launch bounds)
_SMEM_LIMIT = 232448
_SMEM_THREE = 228 * 1024 // 3 - 1024
# threads per block of the four kernels (csrc/nep_dense.cu: DK_THREADS)
_THREADS = 256
# pair slots per chunk of cells in the plain versions: bounds their
# temporaries (the backward's autograd graph) to a few GB in f32
_PLAIN_PAIRS = 1 << 22


class DenseNepSpec(NamedTuple):
    """Static tile-math constants of a NepModel (hashable)."""

    num_types: int
    kr1: int  # basis_size_radial + 1
    ka1: int  # basis_size_angular + 1
    l_max: int
    rc_radial: Tuple[float, ...]
    rc_angular: Tuple[float, ...]
    zbl: bool
    zbl_rc_inner: float
    zbl_rc_outer: float
    atomic_numbers: Tuple[int, ...]

    @property
    def nlm(self) -> int:
        return self.l_max * (self.l_max + 2)

    @property
    def ch_r(self) -> int:
        return self.num_types * self.kr1

    @property
    def ch_a(self) -> int:
        return self.num_types * self.ka1

    @property
    def s_width(self) -> int:
        return self.ch_r + 1  # + ZBL energy channel

    @property
    def a_width(self) -> int:
        return self.ch_a * self.nlm

    @staticmethod
    def from_model(model: NepModel) -> "DenseNepSpec":
        if model.model_type != 0:
            raise NotImplementedError("dense engine: potential models only")
        if model.num_types > 4:
            raise NotImplementedError("dense engine: <= 4 species (use list "
                                      "path)")
        if model.zbl and (model.zbl_flexible or model.zbl_typewise_factor):
            raise NotImplementedError("dense engine: universal ZBL only")
        return DenseNepSpec(
            num_types=model.num_types,
            kr1=model.basis_size_radial + 1,
            ka1=model.basis_size_angular + 1,
            l_max=model.l_max,
            rc_radial=tuple(float(v) for v in model.rc_radial),
            rc_angular=tuple(float(v) for v in model.rc_angular),
            zbl=bool(model.zbl),
            zbl_rc_inner=float(model.zbl_rc_inner),
            zbl_rc_outer=float(model.zbl_rc_outer),
            atomic_numbers=tuple(int(z) for z in model.atomic_numbers),
        )


def z_tables_flat(l_max: int) -> np.ndarray:
    """Y_lm z-polynomial coefficients for L = 1..l_max, each (L+1)x(L+1)
    row-major, concatenated: the layout the CUDA kernels read."""
    return np.concatenate([tables.z_coefficient_table(L).ravel()
                           for L in range(1, l_max + 1)])


# --------------------------------------------------------------------------
# tile math (the plain versions; csrc/nep_common.cuh mirrors it per pair)
# --------------------------------------------------------------------------


def _by_type(tcode, values):
    """values[t] where the float type code is within 0.5 of t (t >= 1),
    else values[0]."""
    out = torch.full_like(tcode, values[0])
    for t in range(1, len(values)):
        out = torch.where(torch.abs(tcode - t) < 0.5, values[t], out)
    return out


def _chebyshev_tile(d, rcp, fc, k_max: int):
    """f_0 = fc; f_k = (T_k(x) + 1)/2 fc (ref: find_fn) on a pair tile."""
    x = torch.clamp(2.0 * (d / rcp - 1.0) ** 2 - 1.0, -1.0, 1.0)
    fs = [fc]
    if k_max >= 1:
        t_prev, t_cur = torch.ones_like(x), x
        fs.append(0.5 * (t_cur + 1.0) * fc)
        for _ in range(2, k_max + 1):
            t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
            fs.append(0.5 * (t_cur + 1.0) * fc)
    return fs


def _ylm_tile(ux, uy, uz, l_max: int, with_grad: bool = False):
    """Real spherical-harmonic components of unit vectors, reference s
    order: per L = 1..l_max -> [m=0, m=1 re, m=1 im, ...].

    With with_grad, also returns each component's gradient with respect to
    (ux, uy, uz), treating Y_lm as a polynomial in the three components:
    d(ux + i uy)^m/dux = m (ux + i uy)^(m-1) and d/duy = i times that.
    """
    zp = [torch.ones_like(uz)]
    for _ in range(l_max):
        zp.append(zp[-1] * uz)
    cr = [torch.ones_like(ux)]
    ci = [torch.zeros_like(ux)]
    for _ in range(l_max):
        cr_new = cr[-1] * ux - ci[-1] * uy
        ci_new = cr[-1] * uy + ci[-1] * ux
        cr.append(cr_new)
        ci.append(ci_new)
    comps, grads = [], []
    for L in range(1, l_max + 1):
        ztab = tables.z_coefficient_table(L)
        for m in range(L + 1):
            q = torch.zeros_like(uz)
            qd = torch.zeros_like(uz)
            for k in range(L + 1):
                c = float(ztab[m, k])
                if c == 0.0:
                    continue
                q = q + zp[k] * c
                if k > 0:
                    qd = qd + zp[k - 1] * (c * k)
            if m == 0:
                comps.append(q)
                grads.append((0.0, 0.0, qd))
            else:
                comps.append(q * cr[m])
                comps.append(q * ci[m])
                grads.append((q * m * cr[m - 1], -q * m * ci[m - 1],
                              qd * cr[m]))
                grads.append((q * m * ci[m - 1], q * m * cr[m - 1],
                              qd * ci[m]))
    if with_grad:
        return comps, grads
    return comps


def _tile_chunk(cx, cy, cz, wx, wy, wz, ct, wt, spec: DenseNepSpec):
    """Pair math of centre cells against their candidates.

    cx, cy, cz, ct: (..., cap, 1) centre coordinates and float type codes;
    wx, wy, wz, wt: (..., 1, L) candidates.  Returns s (..., cap, s_width),
    the radial type-resolved basis sums and the ZBL energy, and
    a (..., cap, ch_a, nlm), the angular basis x Y_lm sums."""
    t = spec.num_types
    dx, dy, dz = wx - cx, wy - cy, wz - cz
    d2 = dx * dx + dy * dy + dz * dz
    pair_ok = d2 > _EPS2
    inv_d = torch.rsqrt(torch.clamp(d2, min=_EPS2))
    d = d2 * inv_d
    zero = torch.zeros_like(d)
    rcp_r = 0.5 * (_by_type(ct, spec.rc_radial) + _by_type(wt, spec.rc_radial))
    rcp_a = 0.5 * (_by_type(ct, spec.rc_angular)
                   + _by_type(wt, spec.rc_angular))
    # neighbour type one-hots: zero on parked slots (type -1)
    m_t = [(torch.abs(wt - tt) < 0.5).to(d.dtype) for tt in range(t)]

    xr = d / rcp_r
    fc_r = torch.where(pair_ok & (xr < 1.0),
                       0.5 * torch.cos(torch.pi * xr) + 0.5, zero)
    fn_r = _chebyshev_tile(d, rcp_r, fc_r, spec.kr1 - 1)
    s_cols = [torch.sum(fn_r[k] * m_t[tt], dim=-1)
              for tt in range(t) for k in range(spec.kr1)]
    if spec.zbl:
        zn = [float(z) for z in spec.atomic_numbers]
        zi = _by_type(ct, zn)
        zj = _by_type(wt, zn)
        a_inv = (zi ** 0.23 + zj ** 0.23) * 2.134563
        x = d * a_inv
        zp = _ZBL_UNIVERSAL
        phi = (float(zp[0]) * torch.exp(-float(zp[1]) * x)
               + float(zp[2]) * torch.exp(-float(zp[3]) * x)
               + float(zp[4]) * torch.exp(-float(zp[5]) * x)
               + float(zp[6]) * torch.exp(-float(zp[7]) * x))
        rc1, rc2 = spec.zbl_rc_inner, spec.zbl_rc_outer
        frac = (d - rc1) / max(rc2 - rc1, 1e-30)
        sw = torch.where(d < rc1, torch.ones_like(d),
                         torch.where(d < rc2,
                                     0.5 * torch.cos(torch.pi * frac) + 0.5,
                                     zero))
        sw = torch.where(pair_ok, sw, zero)
        ez = 0.5 * K_C * zi * zj * inv_d * phi * sw
        # real neighbours of any type contribute: gate on sum of one-hots
        s_cols.append(torch.sum(ez * sum(m_t), dim=-1))
    else:
        s_cols.append(torch.zeros_like(s_cols[0]))
    s_out = torch.stack(s_cols, dim=-1)

    xa = d / rcp_a
    fc_a = torch.where(pair_ok & (xa < 1.0),
                       0.5 * torch.cos(torch.pi * xa) + 0.5, zero)
    fn_a = _chebyshev_tile(d, rcp_a, fc_a, spec.ka1 - 1)
    ylm = _ylm_tile(dx * inv_d, dy * inv_d, dz * inv_d, spec.l_max)
    f_ang = torch.stack([fn_a[k] * m_t[tt] for tt in range(t)
                         for k in range(spec.ka1)], dim=-2)  # (.., ch_a, L)
    y_stack = torch.stack(ylm, dim=-2)  # (..., cap, nlm, L)
    a_out = f_ang @ y_stack.transpose(-1, -2)  # (..., cap, ch_a, nlm)
    return s_out, a_out


def _chunk_lanes(cap: int) -> int:
    """The JAX kernels' candidate-chunk width; it fixes the lane alignment
    of pack_candidates, C = round_up(27 cap, _chunk_lanes(cap))."""
    return int(np.clip((16384 // cap) // 128 * 128, 128, 512))


def _cell_chunks(n_cells: int, cap: int, lanes: int):
    step = max(1, _PLAIN_PAIRS // (cap * lanes))
    return [slice(b, min(b + step, n_cells)) for b in range(0, n_cells, step)]


def _cells_forward(c, w, spec: DenseNepSpec):
    """c (B, 4, cap) centres, w (B, 4, L) candidates -> s (B, cap,
    s_width), a (B, cap, ch_a, nlm), in chunks of cells."""
    ss, aa = [], []
    for sl in _cell_chunks(c.shape[0], c.shape[2], w.shape[2]):
        cc, ww = c[sl, :, :, None], w[sl, :, None, :]
        s, a = _tile_chunk(cc[:, 0], cc[:, 1], cc[:, 2], ww[:, 0], ww[:, 1],
                           ww[:, 2], cc[:, 3], ww[:, 3], spec)
        ss.append(s)
        aa.append(a)
    return torch.cat(ss), torch.cat(aa)


def _cells_vjp(c, w, cot_s, cot_a, spec: DenseNepSpec):
    """Gradient of sum(s cot_s) + sum(a cot_a) of the tile forward with
    respect to the centre and candidate coordinates, by autograd:
    cot_s (B, cap, s_width), cot_a (B, cap, ch_a, nlm) -> dcenter
    (B, 3, cap), dcand (B, 3, L)."""
    dcs, dws = [], []
    for sl in _cell_chunks(c.shape[0], c.shape[2], w.shape[2]):
        with torch.enable_grad():
            xc = [c[sl, k, :, None].detach().requires_grad_(True)
                  for k in range(3)]
            xw = [w[sl, k, None, :].detach().requires_grad_(True)
                  for k in range(3)]
            s, a = _tile_chunk(*xc, *xw, c[sl, 3, :, None], w[sl, 3, None, :],
                               spec)
            loss = torch.sum(s * cot_s[sl]) + torch.sum(a * cot_a[sl])
            g = torch.autograd.grad(loss, xc + xw)
        dcs.append(torch.stack([g[k][..., 0] for k in range(3)], dim=1))
        dws.append(torch.stack([g[3 + k][:, 0] for k in range(3)], dim=1))
    return torch.cat(dcs), torch.cat(dws)


# --------------------------------------------------------------------------
# CUDA launch helpers
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _tables(spec: DenseNepSpec, device: torch.device):
    """rc_radial, rc_angular, atomic numbers and the Y_lm table as float32
    tensors on `device`: the kernels' model constants."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32,
                               device=device).contiguous()

    return (t(spec.rc_radial), t(spec.rc_angular), t(spec.atomic_numbers),
            t(z_tables_flat(spec.l_max)))


def _kernel_args(spec: DenseNepSpec, device):
    tabs = _tables(spec, device)
    return ([cuda_build.ptr(v) for v in tabs],
            [spec.num_types, spec.kr1, spec.ka1, spec.l_max, int(spec.zbl),
             tabs[3].numel()],
            [spec.zbl_rc_inner, spec.zbl_rc_outer])


class DenseTile(NamedTuple):
    """How the dense kernels cut a cell's work (csrc/nep_dense.cu DkTile):
    windows of `cw` candidate lanes, groups of `gc` live centres, and
    pieces of `qr` radial and `qa` angular queue positions; `smem` bytes of
    shared memory a block."""

    cw: int
    gc: int
    qr: int
    qa: int
    smem: int


def _dense_smem_words(spec: DenseNepSpec, cap: int, cw: int, gc: int,
                      qr: int, qa: int, backward: bool) -> int:
    """Shared memory (4-byte words) of a dense kernel's block: dk_layout in
    csrc/nep_dense.cu, term for term (the launcher refuses another size)."""
    capr = -(-cap // 32) * 32
    t = spec.num_types
    words = 4 * cw + 6 * capr + (3 if backward else 2) * capr
    if backward:
        words += 4 * cw  # packed index of each lane, candidate sums
    words += 3 * gc * (cw // 32) + 2 * (gc + 1) + _THREADS // 32 + 2
    words += 2 * t * t + z_tables_flat(spec.l_max).size
    if backward:  # a radial and an angular piece: pairs and p_ij
        return words + 4 * (qr + qa)
    rowr, rowa = (2 + spec.kr1) | 1, (1 + spec.ka1 + spec.nlm) | 1
    return words + max(qr, qa) + max(qr * rowr, qa * rowa)


def dense_tiling(spec: DenseNepSpec, cap: int, lanes: int,
                 backward: bool) -> DenseTile:
    """The largest cut of a cell (`cap` slots, `lanes` candidates) whose
    block fits in shared memory: one window and one group where they fit
    (the PbTe plans), else smaller pieces, then groups, then windows.  The
    forward pieces hold up to a pair row a thread (angular rows; radial
    rows are shorter, so more fit); the backward's radial pieces four
    3-float pair cotangents a thread, its angular ones one.  Pieces shrink
    first, down to half a pair a thread, to let three blocks share an SM
    (the kernels' registers allow three).  Raises ValueError when even the
    smallest cut does not fit."""
    rowr, rowa = (2 + spec.kr1) | 1, (1 + spec.ka1 + spec.nlm) | 1
    tile = {"cw": -(-lanes // 32) * 32, "gc": cap, "q": _THREADS}

    def make():
        q = tile["q"]
        if backward:
            qr, qa = 4 * q, q
        else:
            region = q * max(rowr, rowa)
            qr, qa = region // rowr, region // rowa
        words = _dense_smem_words(spec, cap, tile["cw"], tile["gc"], qr, qa,
                                  backward)
        return DenseTile(tile["cw"], tile["gc"], qr, qa, 4 * words)

    while make().smem > _SMEM_THREE and tile["q"] > _THREADS // 2:
        tile["q"] -= 32
    for key, floor in (("q", 64), ("gc", 1), ("cw", 32), ("q", 32)):
        while make().smem > _SMEM_LIMIT and tile[key] > floor:
            v = -(-tile[key] // 2)
            tile[key] = max(floor, -(-v // 32) * 32 if key == "cw" else v)
    out = make()
    if out.smem > _SMEM_LIMIT:
        raise ValueError(f"needs {out.smem} B of shared memory at the "
                         f"smallest cut, above {_SMEM_LIMIT}")
    return out


def dense_entry(spec: DenseNepSpec, backward: bool) -> str:
    """The mangled-name fragment of the forward or backward kernel's
    instance for `spec` (l_max, and the bound 8 or 20 on kr1/ka1)."""
    kmax = 8 if max(spec.kr1, spec.ka1) <= 8 else 20
    kind = "bwd" if backward else "fwd"
    return f"dense_{kind}_kernelILi{spec.l_max}ELi{kmax}E"


def dense_occupancy(spec: DenseNepSpec, tile: DenseTile, cap: int,
                    backward: bool) -> int:
    """Resident blocks an SM of the kernel's instance at this cut
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    rc = cuda_build.library().dense_occupancy(
        int(backward), cap, spec.num_types, spec.kr1, spec.ka1, spec.l_max,
        z_tables_flat(spec.l_max).size, *tile, ctypes.addressof(blocks))
    cuda_build.check(rc, "dense_occupancy")
    return blocks.value


def _check_lanes(cap: int, c_pad: int, name: str):
    if c_pad < 27 * cap:
        raise ValueError(f"{name}: cand shape has {c_pad} lanes, fewer than "
                         f"the 27 cap = {27 * cap} candidates")


def _launch_tile(spec: DenseNepSpec, cap: int, lanes: int, backward: bool,
                 name: str) -> DenseTile:
    if not (1 <= spec.l_max <= 8 and spec.kr1 <= 20 and spec.ka1 <= 20):
        raise ValueError(f"{name}: model outside the kernel's sizes")
    try:
        return dense_tiling(spec, cap, lanes, backward)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


# --------------------------------------------------------------------------
# round 2: K1b / K2b on packed candidates
# --------------------------------------------------------------------------


def k1b_plain(centers, cand, plan: DenseGridPlan, spec: DenseNepSpec):
    """Plain version of K1b (csrc/nep_dense.cu)."""
    nx, ny, nz = plan.grid
    cap = plan.cap
    s, a = _cells_forward(centers.reshape(-1, 4, cap),
                          cand.reshape(-1, 4, cand.shape[-1]), spec)
    return (s.reshape(nz, ny, nx, cap, spec.s_width),
            a.transpose(1, 2).reshape(nz, ny, nx, spec.ch_a, cap, spec.nlm))


def _k1b_cuda(centers, cand, plan: DenseGridPlan, spec: DenseNepSpec):
    nx, ny, nz = plan.grid
    cap, c_pad = plan.cap, cand.shape[-1]
    dev = centers.device
    cuda_build.require(centers, "centers", torch.float32,
                       (nz, ny, nx, 4, cap))
    cuda_build.require(cand, "cand", torch.float32, (nz, ny, nx, 4, c_pad),
                       dev)
    _check_lanes(cap, c_pad, "k1b")
    tile = _launch_tile(spec, cap, c_pad, False, "k1b")
    s = torch.empty((nz, ny, nx, cap, spec.s_width), dtype=torch.float32,
                    device=dev)
    a = torch.empty((nz, ny, nx, spec.ch_a, cap, spec.nlm),
                    dtype=torch.float32, device=dev)
    ptrs, ints, floats = _kernel_args(spec, dev)
    rc = cuda_build.library().dense_k1b_launch(
        cuda_build.ptr(centers), cuda_build.ptr(cand), cuda_build.ptr(s),
        cuda_build.ptr(a), *ptrs, nx, ny, nz, cap, c_pad, *ints, *tile,
        *floats, cuda_build.stream())
    cuda_build.check(rc, "dense_k1b_launch")
    cuda_build.launches["k1b"] += 1
    return s, a


def k1b_call(centers, cand, plan: DenseGridPlan, spec: DenseNepSpec):
    """centres (nz, ny, nx, 4, cap), candidates (nz, ny, nx, 4, C) ->
    s (nz, ny, nx, cap, s_width) and the channel-leading
    a (nz, ny, nx, ch_a, cap, nlm)."""
    if centers.is_cuda:
        return _k1b_cuda(centers, cand, plan, spec)
    return k1b_plain(centers, cand, plan, spec)


def k2b_plain(centers, cand, cot_s, cot_a, plan: DenseGridPlan,
              spec: DenseNepSpec):
    """Plain version of K2b: the autograd gradient of the plain tile
    forward, contracted with the cotangents."""
    nx, ny, nz = plan.grid
    cap, c_pad = plan.cap, cand.shape[-1]
    dcen, dcand = _cells_vjp(
        centers.reshape(-1, 4, cap), cand.reshape(-1, 4, c_pad),
        cot_s.reshape(-1, cap, spec.s_width),
        cot_a.reshape(-1, spec.ch_a, cap, spec.nlm).transpose(1, 2), spec)
    return (dcen.reshape(nz, ny, nx, 3, cap),
            dcand.reshape(nz, ny, nx, 3, c_pad))


def _k2b_cuda(centers, cand, cot_s, cot_a, plan: DenseGridPlan,
              spec: DenseNepSpec):
    nx, ny, nz = plan.grid
    cap, c_pad = plan.cap, cand.shape[-1]
    dev = centers.device
    cuda_build.require(centers, "centers", torch.float32,
                       (nz, ny, nx, 4, cap))
    cuda_build.require(cand, "cand", torch.float32, (nz, ny, nx, 4, c_pad),
                       dev)
    cuda_build.require(cot_s, "cot_s", torch.float32,
                       (nz, ny, nx, cap, spec.s_width), dev)
    cuda_build.require(cot_a, "cot_a", torch.float32,
                       (nz, ny, nx, spec.ch_a, cap, spec.nlm), dev)
    _check_lanes(cap, c_pad, "k2b")
    tile = _launch_tile(spec, cap, c_pad, True, "k2b")
    dcen = torch.empty((nz, ny, nx, 3, cap), dtype=torch.float32, device=dev)
    dcand = torch.empty((nz, ny, nx, 3, c_pad), dtype=torch.float32,
                        device=dev)
    ptrs, ints, floats = _kernel_args(spec, dev)
    rc = cuda_build.library().dense_k2b_launch(
        cuda_build.ptr(centers), cuda_build.ptr(cand), cuda_build.ptr(cot_s),
        cuda_build.ptr(cot_a), cuda_build.ptr(dcen), cuda_build.ptr(dcand),
        *ptrs, nx, ny, nz, cap, c_pad, *ints, *tile, *floats,
        cuda_build.stream())
    cuda_build.check(rc, "dense_k2b_launch")
    cuda_build.launches["k2b"] += 1
    return dcen, dcand


def k2b_call(centers, cand, cot_s, cot_a, plan: DenseGridPlan,
             spec: DenseNepSpec):
    """+ cot_s (nz, ny, nx, cap, s_width), cot_a (nz, ny, nx, ch_a, cap,
    nlm) -> dcenter (nz, ny, nx, 3, cap), dcand (nz, ny, nx, 3, C)."""
    if centers.is_cuda:
        return _k2b_cuda(centers, cand, cot_s, cot_a, plan, spec)
    return k2b_plain(centers, cand, cot_s, cot_a, plan, spec)


# --------------------------------------------------------------------------
# round 1: K1 / K2 on the ghost rows
# --------------------------------------------------------------------------


def _v1_cells(garr, plan: DenseGridPlan):
    """Centres (cells, 4, cap) and the 27 cap candidates (cells, 4, 27cap)
    of each cell: the nine (dz, dy) ghost-row windows of 3 cap lanes, in
    order, are pack_candidates' lanes without pad."""
    centers, cand = pack_candidates(garr, plan, lane_align=1)
    return (centers.reshape(-1, 4, plan.cap),
            cand.reshape(-1, 4, 27 * plan.cap))


def k1_plain(garr, plan: DenseGridPlan, spec: DenseNepSpec):
    """Plain version of K1 (csrc/nep_dense.cu)."""
    nx, ny, nz = plan.grid
    s, a = _cells_forward(*_v1_cells(garr, plan), spec)
    return (s.reshape(nz, ny, nx * plan.cap, spec.s_width),
            a.reshape(nz, ny, nx * plan.cap, spec.a_width))


def _v1_shapes(plan: DenseGridPlan):
    nx, ny, nz = plan.grid
    return (nz + 2, ny + 2, 4, (nx + 2) * plan.cap), (nz, ny, nx * plan.cap)


def _k1_cuda(garr, plan: DenseGridPlan, spec: DenseNepSpec):
    nx, ny, nz = plan.grid
    cap = plan.cap
    dev = garr.device
    gshape, rows = _v1_shapes(plan)
    cuda_build.require(garr, "garr", torch.float32, gshape)
    tile = _launch_tile(spec, cap, 27 * cap, False, "dense_k1")
    s = torch.empty(rows + (spec.s_width,), dtype=torch.float32, device=dev)
    a = torch.empty(rows + (spec.a_width,), dtype=torch.float32, device=dev)
    ptrs, ints, floats = _kernel_args(spec, dev)
    rc = cuda_build.library().dense_k1_launch(
        cuda_build.ptr(garr), cuda_build.ptr(s), cuda_build.ptr(a), *ptrs,
        nx, ny, nz, cap, *ints, *tile, *floats, cuda_build.stream())
    cuda_build.check(rc, "dense_k1_launch")
    cuda_build.launches["dense_k1"] += 1
    return s, a


def k1_call(garr, plan: DenseGridPlan, spec: DenseNepSpec):
    """Ghost rows (nz+2, ny+2, 4, (nx+2)cap) -> s (nz, ny, nx cap, s_width)
    and a (nz, ny, nx cap, a_width), channel-major (ch * nlm + lm)."""
    if garr.is_cuda:
        return _k1_cuda(garr, plan, spec)
    return k1_plain(garr, plan, spec)


def k2_plain(garr, cot_s, cot_a, plan: DenseGridPlan, spec: DenseNepSpec):
    """Plain version of K2: autograd of the plain tile forward, laid out as
    the TPU kernel's (27, 3cap) tiles, centre gradients in row 12 + k."""
    nx, ny, nz = plan.grid
    cap = plan.cap
    c, w = _v1_cells(garr, plan)
    dcen, dcand = _cells_vjp(
        c, w, cot_s.reshape(-1, cap, spec.s_width),
        cot_a.reshape(-1, cap, spec.ch_a, spec.nlm), spec)
    # candidate lane r * 3cap + l -> row r * 3 + k, lane l
    g = dcand.reshape(-1, 3, 9, 3 * cap).transpose(1, 2).reshape(
        nz, ny, nx, 27, 3 * cap)
    g[..., 12:15, cap:2 * cap] += dcen.reshape(nz, ny, nx, 3, cap)
    return g


def _k2_cuda(garr, cot_s, cot_a, plan: DenseGridPlan, spec: DenseNepSpec):
    nx, ny, nz = plan.grid
    cap = plan.cap
    dev = garr.device
    gshape, rows = _v1_shapes(plan)
    cuda_build.require(garr, "garr", torch.float32, gshape)
    cuda_build.require(cot_s, "cot_s", torch.float32, rows + (spec.s_width,),
                       dev)
    cuda_build.require(cot_a, "cot_a", torch.float32, rows + (spec.a_width,),
                       dev)
    tile = _launch_tile(spec, cap, 27 * cap, True, "dense_k2")
    g = torch.empty((nz, ny, nx, 27, 3 * cap), dtype=torch.float32,
                    device=dev)
    ptrs, ints, floats = _kernel_args(spec, dev)
    rc = cuda_build.library().dense_k2_launch(
        cuda_build.ptr(garr), cuda_build.ptr(cot_s), cuda_build.ptr(cot_a),
        cuda_build.ptr(g), *ptrs, nx, ny, nz, cap, *ints, *tile, *floats,
        cuda_build.stream())
    cuda_build.check(rc, "dense_k2_launch")
    cuda_build.launches["dense_k2"] += 1
    return g


def k2_call(garr, cot_s, cot_a, plan: DenseGridPlan, spec: DenseNepSpec):
    """+ cot_s (nz, ny, nx cap, s_width), cot_a (nz, ny, nx cap, a_width)
    -> per-cell cotangent tiles (nz, ny, nx, 27, 3cap): rows (dz, dy,
    component), lanes the 3-cell x window."""
    if garr.is_cuda:
        return _k2_cuda(garr, cot_s, cot_a, plan, spec)
    return k2_plain(garr, cot_s, cot_a, plan, spec)


# --------------------------------------------------------------------------
# middle (per-atom torch) + full evaluation
# --------------------------------------------------------------------------


def middle_energy(s_cat, a_cat, ti, model: NepModel, params: NepParams):
    """Per-slot energies from the basis sums: c-tensor contraction,
    rotation invariants, ANN, ZBL (ref: find_descriptor nep.cu:488-659).
    s_cat (ns, s_width), a_cat (ns, a_width) channel-major, ti (ns,)."""
    dtype = s_cat.dtype
    t = model.num_types
    kr1 = model.basis_size_radial + 1
    ka1 = model.basis_size_angular + 1
    nlm = model.l_max * (model.l_max + 2)
    ns = s_cat.shape[0]
    s_rad = s_cat[:, :t * kr1].reshape(ns, t, kr1)
    e_zbl = s_cat[:, t * kr1]
    a = a_cat.reshape(ns, t, ka1, nlm)
    c_r = params.c_radial.to(dtype)  # (T, T, NR1, KR1)
    c_a = params.c_angular.to(dtype)  # (T, T, NA1, KA1)
    q_rad = 0.0
    s_ang = 0.0
    for a_t in range(t):
        own = (ti == a_t)[:, None]
        q_rad = q_rad + torch.where(
            own, torch.einsum("ptk,tnk->pn", s_rad, c_r[a_t]), 0.0)
        s_ang = s_ang + torch.where(
            own[..., None], torch.einsum("ptkl,tnk->pnl", a, c_a[a_t]), 0.0)
    q_ang = _angular_q(s_ang, model)  # (ns, num_l, NA1)
    q = torch.cat([q_rad, q_ang.reshape(ns, -1)], dim=-1)
    q = q * params.q_scaler.to(dtype)
    return ann_energy(q, ti, params) + e_zbl


def _middle_vjp(s_flat, a_flat, type_slots, slot_mask, model: NepModel,
                params: NepParams):
    """Masked per-slot energy and its cotangents on (s, a)."""
    with torch.enable_grad():
        sf = s_flat.detach().requires_grad_(True)
        af = a_flat.detach().requires_grad_(True)
        e = middle_energy(sf, af, type_slots, model, params) * slot_mask
        cot_s, cot_a = torch.autograd.grad(e.sum(), (sf, af))
    return e.detach(), cot_s, cot_a


class DenseNepOutput(NamedTuple):
    energy: torch.Tensor  # (n_slots,)
    force: torch.Tensor  # (n_slots, 3)
    virial_total: torch.Tensor  # (3, 3), reference sign convention


def _finish(garr, dg, slot_mask, plan: DenseGridPlan, e_atom):
    # W_ab = -sum_g x_g,a dE/dx_g,b (ghost coordinates carry their shifts)
    w_total = -torch.einsum("zyax,zybx->ab", garr[:, :, :3], dg)
    force = -fold_ghost_grad(dg, plan) * slot_mask[:, None]
    return DenseNepOutput(energy=e_atom, force=force, virial_total=w_total)


def _pin(position_slots):
    if position_slots.is_cuda:
        # full-f32 matmuls, as the JAX package's matmul precision "high"
        from gpumd_tpu_torch.engine.nep_compact import pin_fp32_matmul

        pin_fp32_matmul()


def dense_nep_compute(position_slots, type_slots, slot_mask, box: Box,
                      plan: DenseGridPlan, model: NepModel,
                      params: NepParams, plain: bool = False,
                      keep: Optional[dict] = None) -> DenseNepOutput:
    """Round-1 evaluation on dense slot state: K1 on the ghost rows, the
    middle and its VJP, K2, and the 81 slice-adds that fold the per-cell
    (27, 3cap) tiles back onto the ghost grid.  `position_slots` holds the
    wrapped positions binned at the last rebin.  `plain=True` runs the
    kernels' plain versions; `keep` receives the kernels' inputs."""
    spec = DenseNepSpec.from_model(model)
    _pin(position_slots)
    k1f, k2f = (k1_plain, k2_plain) if plain else (k1_call, k2_call)
    nx, ny, nz = plan.grid
    cap = plan.cap
    ns = plan.n_slots
    garr = pack_ghost(position_slots, type_slots, slot_mask, box, plan)
    s_cat, a_cat = k1f(garr, plan, spec)
    e_atom, cot_s, cot_a = _middle_vjp(
        s_cat.reshape(ns, spec.s_width), a_cat.reshape(ns, spec.a_width),
        type_slots, slot_mask, model, params)
    cot_s = cot_s.reshape(nz, ny, nx * cap, spec.s_width)
    cot_a = cot_a.reshape(nz, ny, nx * cap, spec.a_width)
    g = k2f(garr, cot_s, cot_a, plan, spec)
    if keep is not None:
        keep.update(garr=garr, s=s_cat, a=a_cat, cot_s=cot_s, cot_a=cot_a,
                    g=g)
    dg = torch.zeros((nz + 2, ny + 2, 3, (nx + 2) * cap), dtype=garr.dtype,
                     device=garr.device)
    for dz in range(3):
        for dy in range(3):
            for k in range(3):
                row = (dz * 3 + dy) * 3 + k
                for dx in range(3):
                    seg = g[:, :, :, row, dx * cap:(dx + 1) * cap]
                    dg[dz:dz + nz, dy:dy + ny, k,
                       dx * cap:dx * cap + nx * cap] += seg.reshape(
                           nz, ny, nx * cap)
    return _finish(garr, dg, slot_mask, plan, e_atom)


def dense_nep_compute_v2(position_slots, type_slots, slot_mask, box: Box,
                         plan: DenseGridPlan, model: NepModel,
                         params: NepParams, plain: bool = False,
                         keep: Optional[dict] = None) -> DenseNepOutput:
    """Round-2 evaluation: packed candidates, K1b, the middle and its VJP,
    K2b, and the folds.  The whole grid goes through each kernel in one
    launch (the JAX package mapped over z slabs to fit a 16 GB chip).
    `plain=True` runs the kernels' plain versions; `keep` receives the
    kernels' inputs."""
    spec = DenseNepSpec.from_model(model)
    _pin(position_slots)
    k1f, k2f = (k1b_plain, k2b_plain) if plain else (k1b_call, k2b_call)
    nx, ny, nz = plan.grid
    cap = plan.cap
    ns = plan.n_slots
    garr = pack_ghost(position_slots, type_slots, slot_mask, box, plan)
    centers, cand = pack_candidates(garr, plan,
                                    lane_align=_chunk_lanes(cap))
    centers = centers.contiguous()
    s, a = k1f(centers, cand, plan, spec)
    e_atom, cot_s, cot_a = _middle_vjp(
        s.reshape(ns, spec.s_width),
        a.transpose(3, 4).reshape(ns, spec.a_width),
        type_slots, slot_mask, model, params)
    cot_s = cot_s.reshape(nz, ny, nx, cap, spec.s_width)
    cot_a = cot_a.reshape(nz, ny, nx, cap, spec.ch_a, spec.nlm).transpose(
        3, 4).contiguous()
    dcenter, dcand = k2f(centers, cand, cot_s, cot_a, plan, spec)
    if keep is not None:
        keep.update(garr=garr, centers=centers, cand=cand, s=s, a=a,
                    cot_s=cot_s, cot_a=cot_a, dcenter=dcenter, dcand=dcand)
    dg = fold_candidate_grad(dcand, plan)
    # centre cotangents land on the interior of the ghost grid
    dg[1:1 + nz, 1:1 + ny, :, cap:cap + nx * cap] += dcenter.movedim(
        3, 2).reshape(nz, ny, 3, nx * cap)
    return _finish(garr, dg, slot_mask, plan, e_atom)
