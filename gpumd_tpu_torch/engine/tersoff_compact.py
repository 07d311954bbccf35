"""Compact-tile Tersoff-1989 engine: the classical-potential fast path.

Counterpart of gpumd_tpu/engine/tersoff_compact.py.  It runs on the
compact engine's grid with full windows (no compact candidate lists, no ANN
middle).  Each step runs

  tersoff_scatter  per-atom energy, centre gradient and virial rows from
                   the (mn, A) bond tiles, and the per-pair cotangents
                   p_ij = dE_i/dr_ij added onto the neighbours' window
                   lanes in the same kernel (csrc/tersoff.cu, fused mode)
  fold             window lanes back onto the owning slots (csrc/fold.cu)

The JAX package runs the first as two kernels, the tersoff kernel (p_ij
into a (pch, mn, A) tile a block) and the scatter.  Both stay here:
`tersoff_kernel_call` (csrc/tersoff.cu, contract mode) and `scatter_call`
(csrc/scatter.cu).  The fused kernel equals their composition, and its
plain version is the composition of theirs; a plan whose window leaves no
room in shared memory for the fused kernel's accumulator runs the two in
its place (`fused_fits`).

The TPU kernel differentiated the tile energy in-kernel with
jax.value_and_grad; here the gradient is derived by hand, in the two passes
of the reference (ref: src/force/tersoff1989.cu:337-520).  For centre i and
slot j, with r_j = r_ij, u_j = r_j/d_j, c_jk = u_j.u_k, w_j = dE/dzeta_j =
-fc_j fa_j b'_j / 2:

  pass 1  zeta_j = sum_{k!=j} fc_k g(c_jk),
          b_j = (1 + (beta zeta_j)^n)^(-1/2n),
          E_i = 1/2 sum_j fc_j (fr_j - b_j fa_j)
  pass 2  p_j = [1/2 fc'_j (fr_j - b_j fa_j) + 1/2 fc_j (fr'_j - b_j fa'_j)
                 + fc'_j sum_{m!=j} w_m g(c_mj)] u_j
          + 1/d_j sum_{k!=j} (w_j fc_k + w_k fc_j) g'(c_jk) (u_k - c_jk u_j)

A slot with fc_j = 0 has p_j = 0 exactly (fc'_j = 0 there too), so the
kernel works on the live slots only.  `tersoff_kernel_plain` computes the
same two passes with torch tensor ops; `tersoff_energy_tiles` is the tile
energy alone, with the TPU kernel's guards, whose autograd the tests hold
the hand-derived gradient against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.engine.fold_kernel import (
    fold_windows_to_rows,
    fold_windows_to_rows_plain,
    rows_to_slots,
)
from gpumd_tpu_torch.engine.grid import (
    pack_block_windows,
    pack_ghost,
    plan_grid,
)
from gpumd_tpu_torch.engine.nep_compact import (
    _EPS2,
    _SMEM_LIMIT,
    CompactPlan,
    _gather_lanes,
    _pch,
    block_centers,
    blocks_to_slots,
    build_indices,
    make_compact_plan,
    plan_grid_compact,
    scatter_call,
    scatter_plain,
)
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.potentials.tersoff import Tersoff1989

# pair-pair elements of one chunk of the plain version (2^25: 128 MB per
# f32 tensor), so that it runs at 1M atoms
_PLAIN_CHUNK = 1 << 25
_PAIR = ("a", "b", "lam", "mu", "r1", "r2")
_CENTRE = ("beta", "n", "c2", "d2", "h")


class TersoffSpec(NamedTuple):
    """Tersoff-1989 constants as plain floats: the pair tables (T, T) and
    the centre tables (T,) flattened to tuples."""

    num_types: int
    a: Tuple[float, ...]
    b: Tuple[float, ...]
    lam: Tuple[float, ...]
    mu: Tuple[float, ...]
    r1: Tuple[float, ...]
    r2: Tuple[float, ...]
    beta: Tuple[float, ...]
    n: Tuple[float, ...]
    c2: Tuple[float, ...]
    d2: Tuple[float, ...]
    h: Tuple[float, ...]

    @staticmethod
    def from_potential(pot: Tersoff1989) -> "TersoffSpec":
        def flat(x):
            return tuple(float(v) for v in x.detach().cpu().reshape(-1))

        return TersoffSpec(num_types=pot.num_types,
                           **{k: flat(getattr(pot, k))
                              for k in _PAIR + _CENTRE})

    def kernel_consts(self):
        """The 34 floats csrc/tersoff.cu reads: each pair table padded to
        4 entries, then each centre table padded to 2."""
        vals = []
        for k in _PAIR:
            v = getattr(self, k)
            vals += list(v) + [0.0] * (4 - len(v))
        for k in _CENTRE:
            v = getattr(self, k)
            vals += list(v) + [0.0] * (2 - len(v))
        return (ctypes.c_float * len(vals))(*vals)


@functools.lru_cache(maxsize=8)
def kernel_consts(spec: TersoffSpec):
    """spec.kernel_consts() built once a spec, not at every launch: the
    launcher copies the floats into the kernel's arguments, so one array
    serves every call."""
    return spec.kernel_consts()


def _type_index(tcode, t: int):
    return torch.clamp(torch.round(tcode), 0, t - 1).long()


def _bond_terms(dx, dy, dz, tj, ct, spec: TersoffSpec):
    """Per-slot terms on tiles (..., mn, A) with centre types ct (..., 1, A).
    A parked centre (type -1) or neighbour zeroes every constant it enters,
    as the TPU kernel's type-mask products do; the centre tables then take
    the TPU kernel's safe substitutes (d2 and n + 1) and `real_c` masks
    the energy."""
    t = spec.num_types
    dtype, dev = dx.dtype, dx.device
    d2v = dx * dx + dy * dy + dz * dz
    ok = (d2v > _EPS2) & (tj > -0.5)
    inv_d = torch.rsqrt(torch.clamp(d2v, min=_EPS2))
    d = d2v * inv_d
    real_c = (ct > -0.5).to(dtype)
    real_p = real_c * (tj > -0.5).to(dtype)
    ti = _type_index(ct, t)
    pk = ti * t + _type_index(tj, t)

    def pair(k):
        return torch.as_tensor(getattr(spec, k), dtype=dtype,
                               device=dev)[pk] * real_p

    def centre(k):
        return torch.as_tensor(getattr(spec, k), dtype=dtype,
                               device=dev)[ti] * real_c

    r1p, r2p = pair("r1"), pair("r2")
    span = torch.clamp(r2p - r1p, min=1e-30)
    x = torch.clamp((d - r1p) / span, 0.0, 1.0)
    live = ok & (d < r2p)
    zero = torch.zeros_like(d)
    dsafe = torch.minimum(d, r2p)
    lam, mu = pair("lam"), pair("mu")
    terms = dict(
        d=d, inv_d=inv_d, live=live, real_c=real_c, x=x, span=span,
        r1=r1p, lam=lam, mu=mu, u=(dx * inv_d, dy * inv_d, dz * inv_d),
        fc=torch.where(live, 0.5 * (1.0 + torch.cos(torch.pi * x)), zero),
        fr=pair("a") * torch.exp(-lam * dsafe),
        fa=pair("b") * torch.exp(-mu * dsafe),
        c2=centre("c2"), d2c=centre("d2") + (1.0 - real_c), h=centre("h"),
        beta=centre("beta"), n=centre("n") + (1.0 - real_c))
    return terms


def _angle_tiles(tm):
    """cos_jk (..., mn_j, mn_k, A), g(cos_jk) and the not-self mask.

    g = 1 + c^2/d^2 - c^2/(d^2 + (cos - h)^2), as the TPU kernel writes
    it, is computed as 1 + c^2 (cos - h)^2 / (d^2 (d^2 + (cos - h)^2)): the
    same function without the cancellation of two ~3.8e7 terms (Si's
    c^2/d^2), which in f32 loses all of g near cos = h."""
    ux, uy, uz = tm["u"]
    cos = (ux[..., :, None, :] * ux[..., None, :, :]
           + uy[..., :, None, :] * uy[..., None, :, :]
           + uz[..., :, None, :] * uz[..., None, :, :])
    c2 = tm["c2"][..., None, :]
    d2c = tm["d2c"][..., None, :]
    dh2 = (cos - tm["h"][..., None, :]) ** 2
    g = 1.0 + c2 * dh2 / (d2c * (d2c + dh2))
    mn = ux.shape[-2]
    not_self = 1.0 - torch.eye(mn, dtype=ux.dtype, device=ux.device)[:, :,
                                                                      None]
    return cos, g, not_self


def _bond_order(zeta, tm):
    """b(zeta) and the (beta zeta)^n term, with the reference's guard:
    b = 1 (and b' = 0) for zeta <= 1e-16."""
    zeta_ok = zeta > 1e-16
    bzn = torch.where(zeta_ok,
                      (tm["beta"] * torch.where(zeta_ok, zeta,
                                                torch.ones_like(zeta)))
                      ** tm["n"], torch.zeros_like(zeta))
    return (1.0 + bzn) ** (-0.5 / tm["n"]), bzn, zeta_ok


def tersoff_energy_tiles(dx, dy, dz, tj, ct, spec: TersoffSpec):
    """Per-atom Tersoff energy (..., 1, A) from displacement tiles
    (..., mn, A): the TPU kernel's `_tersoff_energy_tiles`, guards kept."""
    tm = _bond_terms(dx, dy, dz, tj, ct, spec)
    _, g, not_self = _angle_tiles(tm)
    zeta = torch.sum(tm["fc"][..., None, :, :] * g * not_self, dim=-2)
    bij, _, _ = _bond_order(zeta, tm)
    e = 0.5 * tm["fc"] * (tm["fr"] - bij * tm["fa"]) * tm["real_c"]
    return torch.sum(e, dim=-2, keepdim=True)


def tersoff_tiles_plain(dx, dy, dz, tj, ct, spec: TersoffSpec):
    """Energy (..., 1, A) and the pair cotangents p_ij (three (..., mn, A)
    tiles) by the kernel's two hand-derived passes."""
    tm = _bond_terms(dx, dy, dz, tj, ct, spec)
    cos, g, not_self = _angle_tiles(tm)
    fc, fr, fa, live = tm["fc"], tm["fr"], tm["fa"], tm["live"]
    zero = torch.zeros_like(fc)
    # pass 1: bond orders and w_j = dE/dzeta_j
    zeta = torch.sum(fc[..., None, :, :] * g * not_self, dim=-2)
    bij, bzn, zeta_ok = _bond_order(zeta, tm)
    zsafe = torch.where(zeta_ok, zeta, torch.ones_like(zeta))
    bp = torch.where(zeta_ok, -0.5 * bij * bzn / (zsafe * (1.0 + bzn)),
                     zero)
    e = 0.5 * fc * (fr - bij * fa) * tm["real_c"]
    w = -0.5 * fc * fa * bp
    # pass 2
    fcp = torch.where(live & (tm["d"] > tm["r1"]),
                      -0.5 * torch.pi * torch.sin(torch.pi * tm["x"])
                      / tm["span"], zero)
    frp, fap = -tm["lam"] * fr, -tm["mu"] * fa
    rad = (0.5 * fcp * (fr - bij * fa) + 0.5 * fc * (frp - bij * fap)
           + fcp * torch.sum(w[..., None, :, :] * g * not_self, dim=-2))
    c2, d2c = tm["c2"][..., None, :], tm["d2c"][..., None, :]
    dh = cos - tm["h"][..., None, :]
    gp = 2.0 * c2 * dh / (d2c + dh ** 2) ** 2
    coef = (w[..., :, None, :] * fc[..., None, :, :]
            + w[..., None, :, :] * fc[..., :, None, :]) * gp * not_self
    ccos = torch.sum(coef * cos, dim=-2)
    p = []
    for uq in tm["u"]:
        gvec = torch.sum(coef * uq[..., None, :, :], dim=-2) - uq * ccos
        p.append((rad * uq + tm["inv_d"] * gvec) * tm["real_c"])
    return torch.sum(e, dim=-2, keepdim=True), p


def tersoff_kernel_plain(centers, cand, idx, cplan: CompactPlan,
                         spec: TersoffSpec, per_atom_virial: bool):
    """Plain version of csrc/tersoff.cu, through the blocks in chunks."""
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nb, a_pad, mn = cplan.nb, cplan.a_pad, cplan.mn_r
    pch = _pch(per_atom_virial)
    c_all = centers.reshape(nb, 4, 1, a_pad)
    w_all = cand.reshape(nb, 4, -1)
    i_all = idx.reshape(nb, mn, a_pad)
    outs, pvs = [], []
    step = max(1, _PLAIN_CHUNK // (mn * mn * a_pad))
    for s in range(0, nb, step):
        c = c_all[s:s + step]
        g = _gather_lanes(w_all[s:s + step], i_all[s:s + step])
        rr = (g[:, 0] - c[:, 0], g[:, 1] - c[:, 1], g[:, 2] - c[:, 2])
        e, p = tersoff_tiles_plain(*rr, g[:, 3], c[:, 3], spec)
        zeros = torch.zeros_like(e)
        virial = [torch.sum(-rr[av] * p[bv], dim=1, keepdim=True)
                  for av in range(3) for bv in range(3)]
        rows = ([-torch.sum(pq, dim=1, keepdim=True) for pq in p]
                + ([zeros] * 9 if per_atom_virial else virial)
                + [e] + [zeros] * 3)
        outs.append(torch.cat(rows, dim=1))
        chans = list(p)
        if per_atom_virial:
            chans += [-rr[av] * p[bv] for av in range(3) for bv in range(3)]
        chans += [torch.zeros_like(p[0])] * (pch - len(chans))
        pvs.append(torch.stack(chans, dim=1))
    outf = torch.cat(outs).reshape(nz, ny, cplan.nxb, 16, a_pad)
    pvals = torch.cat(pvs).reshape(nz, ny, cplan.nxb, pch, mn, a_pad)
    return outf, pvals


def tersoff_smem(fused: bool, wl: int, mn: int,
                 per_atom_virial: bool) -> int:
    """Shared memory a block of csrc/tersoff.cu: the window as (x, y, z,
    type) lanes, a tile of 128 centres and their mn neighbour lanes and,
    fused, the accumulator of the used channels (3, or 12 with per-atom
    virials)."""
    used = 12 if per_atom_virial else 3
    return 4 * wl * (4 + (used if fused else 0)) + 4 * (4 + mn) * 128


def _tersoff_launch(fused: bool, centers, cand, idx, cplan: CompactPlan,
                    spec: TersoffSpec, per_atom_virial: bool):
    nz, ny = cplan.base.grid[2], cplan.base.grid[1]
    nxb, a_pad, wl, mn = cplan.nxb, cplan.a_pad, cplan.wl, cplan.mn_r
    name = "tersoff_scatter" if fused else "tersoff"
    dev = centers.device
    # the kernel reads all three in 16-byte pieces
    cuda_build.require(centers, "centers", torch.float32,
                       (nz, ny, nxb, 4, a_pad), align=16)
    cuda_build.require(cand, "cand", torch.float32, (nz, ny, nxb, 4, wl), dev,
                       align=16)
    cuda_build.require(idx, "idx", torch.int32, (nz, ny, nxb, mn, a_pad), dev,
                       align=16)
    if mn > 128 or a_pad > 1024 or a_pad % 32 or wl % 4 \
            or spec.num_types > 2:
        raise ValueError(f"{name}: plan or potential outside the kernel's "
                         "sizes (mn <= 128, a_pad <= 1024, wl a multiple "
                         "of 4, <= 2 types)")
    if tersoff_smem(fused, wl, mn, per_atom_virial) > _SMEM_LIMIT:
        raise ValueError(f"{name}: window exceeds shared memory")
    pch = _pch(per_atom_virial)
    outf = torch.empty((nz, ny, nxb, 16, a_pad), dtype=torch.float32,
                       device=dev)
    shape = (nz, ny, pch, nxb, wl) if fused else (nz, ny, nxb, pch, mn,
                                                  a_pad)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    args = [cuda_build.ptr(centers), cuda_build.ptr(cand),
            cuda_build.ptr(idx), cuda_build.ptr(outf), cuda_build.ptr(out),
            kernel_consts(spec), cplan.nb, a_pad, wl, mn, pch,
            int(per_atom_virial), spec.num_types]
    if fused:
        rc = lib.tersoff_scatter_launch(*args, nxb, cuda_build.stream())
    else:
        rc = lib.tersoff_launch(*args, cuda_build.stream())
    cuda_build.check(rc, f"{name}_launch")
    cuda_build.launches[name] += 1
    return outf, out


def tersoff_kernel_call(centers, cand, idx, cplan: CompactPlan,
                        spec: TersoffSpec, per_atom_virial: bool):
    """centers (nz, ny, nxb, 4, a_pad), cand (nz, ny, nxb, 4, wl) and idx
    (nz, ny, nxb, mn, a_pad) int32 window lanes -> outf (nz, ny, nxb, 16,
    a_pad): rows 0-2 -sum_j p_ij, rows 3-11 sum_j -r_a p_b (zero with
    per-atom virials), row 12 E_i, rows 13-15 zero; and pvals (nz, ny, nxb,
    pch, mn, a_pad): p_ij, then -r_a p_b with per-atom virials (pch 12),
    else one zero channel (pch 4)."""
    if centers.is_cuda:
        return _tersoff_launch(False, centers, cand, idx, cplan, spec,
                               per_atom_virial)
    return tersoff_kernel_plain(centers, cand, idx, cplan, spec,
                                per_atom_virial)


def tersoff_scatter_plain(centers, cand, idx, cplan: CompactPlan,
                          spec: TersoffSpec, per_atom_virial: bool):
    """Plain version of csrc/tersoff.cu's fused mode: the tersoff kernel's
    plain version, then the scatter's."""
    outf, pvals = tersoff_kernel_plain(centers, cand, idx, cplan, spec,
                                       per_atom_virial)
    return outf, scatter_plain(pvals, idx, cplan)


def tersoff_scatter_call(centers, cand, idx, cplan: CompactPlan,
                         spec: TersoffSpec, per_atom_virial: bool):
    """The inputs of tersoff_kernel_call -> its outf and the window
    cotangents (nz, ny, pch, nxb, wl) that scatter_call makes from its
    pvals, in one kernel: the per-pair cotangents stay on chip."""
    if centers.is_cuda:
        return _tersoff_launch(True, centers, cand, idx, cplan, spec,
                               per_atom_virial)
    return tersoff_scatter_plain(centers, cand, idx, cplan, spec,
                                 per_atom_virial)


def tersoff_occupancy(fused: bool, cplan: CompactPlan,
                      per_atom_virial: bool) -> Tuple[int, int]:
    """(resident blocks an SM, shared memory a block) of the instance the
    plan launches, by the occupancy query (needs the card)."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib = cuda_build.library()
    rc = lib.tersoff_occupancy(int(fused), cplan.mn_r, int(per_atom_virial),
                               cplan.wl, ctypes.byref(blocks),
                               ctypes.byref(smem))
    cuda_build.check(rc, "tersoff_occupancy")
    return blocks.value, smem.value


def tersoff_live_cap() -> int:
    """The live bonds a centre csrc/tersoff.cu keeps in registers; a centre
    with more takes the kernel's general path (needs the card)."""
    return cuda_build.library().tersoff_live_cap()


def fused_fits(cplan: CompactPlan, per_atom_virial: bool) -> bool:
    """Whether the fused kernel's window, lane tile and accumulator fit in a
    block's shared memory at this plan."""
    return tersoff_smem(True, cplan.wl, cplan.mn_r,
                        per_atom_virial) <= _SMEM_LIMIT


def tersoff_entry(fused: bool, cplan: CompactPlan,
                  per_atom_virial: bool) -> str:
    """The mangled-name stem of the instance the plan launches, as ptxas
    reports it."""
    mn = next(m for m in (32, 64, 128) if cplan.mn_r <= m)
    name = "tersoff_scatter_kernel" if fused else "tersoff_kernel"
    return f"{len(name)}{name}ILi{mn}ELb{int(per_atom_virial)}E"


class CompactTersoffOutput(NamedTuple):
    energy: torch.Tensor  # (n_slots,)
    force: torch.Tensor  # (n_slots, 3)
    virial_total: torch.Tensor  # (3, 3)
    virial_atom: Optional[torch.Tensor]  # (n_slots, 3, 3) or None


def compact_tersoff_compute(position_slots, type_slots, slot_mask, box: Box,
                            cplan: CompactPlan, idx, spec: TersoffSpec,
                            per_atom_virial: bool = False,
                            plain: bool = False,
                            keep: Optional[dict] = None
                            ) -> CompactTersoffOutput:
    """Tersoff evaluation on dense slot state; `idx` from build_indices at
    the last rebin.  The fused kernel, or where its accumulator does not
    fit (`fused_fits`) the tersoff kernel and the scatter; `plain=True`
    runs the plain versions of the same route; `keep`, when given,
    receives the inputs and outputs of the pass."""
    plan = cplan.base
    foldf = fold_windows_to_rows_plain if plain else fold_windows_to_rows
    garr = pack_ghost(position_slots, type_slots, slot_mask, box, plan)
    centers = block_centers(garr, cplan)
    cand = pack_block_windows(garr, plan, cplan.bx, cplan.wl)
    args = (centers, cand, idx, cplan, spec, per_atom_virial)
    if fused_fits(cplan, per_atom_virial):
        outf, dcand = (tersoff_scatter_plain if plain
                       else tersoff_scatter_call)(*args)
    else:
        outf, pvals = (tersoff_kernel_plain if plain
                       else tersoff_kernel_call)(*args)
        dcand = (scatter_plain if plain else scatter_call)(pvals, idx, cplan)
    drows = foldf(dcand, plan, cplan.bx)
    if keep is not None:
        keep.update(centers=centers, cand=cand, idx=idx, outf=outf,
                    dcand=dcand, drows=drows)
    dslots = rows_to_slots(drows)
    og = blocks_to_slots(outf, cplan)
    force = -(og[:, :3] + dslots[:, :3]) * slot_mask[:, None]
    e_atom = og[:, 12] * slot_mask
    if per_atom_virial:
        w_atom = dslots[:, 3:12].reshape(-1, 3, 3) * slot_mask[:, None, None]
        w_total = torch.sum(w_atom, dim=0)
    else:
        w_atom = None
        w_total = torch.sum(og[:, 3:12].reshape(-1, 3, 3)
                            * slot_mask[:, None, None], dim=0)
    return CompactTersoffOutput(energy=e_atom, force=force,
                                virial_total=w_total, virial_atom=w_atom)


class CompactTersoffMD(DenseNEPMD):
    """Tersoff MD on the compact engine: DenseNEPMD's carry, rebin,
    rebuild criterion, step loop and hooks, `compute` (net-force zeroing,
    the HNEMD driving force `hnemd_fe`, virials, heat current J_i = W_i
    v_i) and input-order map, with the Tersoff force pass and neighbour
    build.  The pass's energy is already masked, so compute's mask leaves
    it as the JAX package's unmasked one.  `plain=True` runs every
    kernel's plain version."""

    def __init__(self, pot: Tersoff1989, box: Box, n_atoms: int,
                 position: Optional[np.ndarray] = None, skin: float = 1.0,
                 cap: Optional[int] = None, per_atom_virial: bool = False,
                 mn: Optional[int] = None, zero_net_force: bool = True,
                 plain: bool = False):
        self.spec = TersoffSpec.from_potential(pot)
        self.rc = pot.rc
        if cap is None:
            self.plan = plan_grid_compact(box, pot.rc, skin, n_atoms,
                                          position=position)
        else:
            self.plan = plan_grid(box, pot.rc, skin, n_atoms,
                                  position=position, cap=cap)
        if self.plan is None:
            raise ValueError("box too thin for the compact tersoff engine")
        self.skin = skin
        self.per_atom_virial = per_atom_virial
        self.zero_net_force = zero_net_force
        self.plain = plain
        # lighter cap margins than NEP's, in steps of 8; make_compact_plan
        # floors mn_r at 32, so Si lands at 32 at every size
        self.cplan = make_compact_plan(
            self.plan, position=position, box=box, rc_angular=pot.rc,
            mn_r=mn, mn_a=mn, slack_mul=1.2, slack_add=4, rnd=8,
            compact_lists=False)
        # one list: angular cap == radial cap
        self.cplan = self.cplan._replace(mn_a=self.cplan.mn_r)

    def _build_idx(self, sstate: MDState):
        garr = pack_ghost(sstate.position, sstate.type, sstate.mask,
                          sstate.box, self.plan)
        centers = block_centers(garr, self.cplan)
        cand = pack_block_windows(garr, self.plan, self.cplan.bx,
                                  self.cplan.wl)
        return build_indices(centers, cand, self.cplan, self.rc)

    def _force_pass(self, state: MDState, idx) -> CompactTersoffOutput:
        return compact_tersoff_compute(
            state.position, state.type, state.mask, state.box, self.cplan,
            idx, self.spec, per_atom_virial=self.per_atom_virial,
            plain=self.plain)
