"""NEP (neuroevolution potential): the list path and the pieces the
compact and dense engines share.

Counterpart of gpumd_tpu/potentials/nep/model.py (ref: src/force/nep.cu:
488-861, find_descriptor, find_force_radial, find_partial_force_angular,
find_force_ZBL):

  radial:   q_n    = sum_j g_n(r_ij),   g_n = sum_k c^{t1 t2}_{nk} f_k(r)
  angular:  s_lm^n = sum_j g^a_n(r_ij) * Q_lm(z) * Re/Im (x+iy)^m
            q_nl   = C_l0 s0^2 + 2 sum_{m>0} C_lm (s_re^2 + s_im^2)
            (+ the 4-body q222 and 5-body q1111 invariants, and the
            extended q112 / q123 / q233 / q134)
  ANN:      E_i = sum_nu w1[t1] tanh(w0[t1] . (q*scaler) - b0[t1]) - b1
  ZBL:      screened Coulomb pair repulsion (universal, flexible, typewise)

The list path (`NEP.compute` on a `NeighborList`) evaluates energies only;
the partial forces are one autograd sweep a block of atoms
(potentials/base.py), forward and backward inside the block loop.  It runs
in plain torch, as the JAX list path runs in plain XLA.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.neighbor.neighbor import NeighborList, gather_vec3
from gpumd_tpu_torch.potentials.base import (
    PotentialOutput,
    compute_from_pair_energy,
    energy_and_partials,
)
from gpumd_tpu_torch.potentials.nep import tables
from gpumd_tpu_torch.potentials.nep.params import (
    NepModel,
    NepParams,
    load_nep_txt,
)
from gpumd_tpu_torch.units import K_C

# Atoms a block of the list path's energy and its autograd sweep: the JAX
# package's 4,096 on the CPU (there it bounds TPU memory).  On the card a
# block's ~650 operators (~1,000 launches), not its memory, set the cost,
# so a block there holds 32,768 atoms: 8x fewer launches a step.
BLOCK = 4096
CARD_BLOCK = 32768


def block_size(t: torch.Tensor) -> int:
    """Atoms a block on `t`'s device."""
    return BLOCK if t.device.type == "cpu" else CARD_BLOCK


_ZBL_UNIVERSAL = np.array(
    [0.18175, 3.1998, 0.50986, 0.94229, 0.28022, 0.4029, 0.02817, 0.20162]
)

# Covalent radii (A) indexed by Z-1, for the typewise ZBL cutoff
# (ref: nep_utilities.cuh:143-153)
_COVALENT_RADIUS = np.array([
    0.426667, 0.613333, 1.6, 1.25333, 1.02667, 1.0, 0.946667, 0.84,
    0.853333, 0.893333, 1.86667, 1.66667, 1.50667, 1.38667, 1.46667,
    1.36, 1.32, 1.28, 2.34667, 2.05333, 1.77333, 1.62667, 1.61333,
    1.46667, 1.42667, 1.38667, 1.33333, 1.32, 1.34667, 1.45333, 1.49333,
    1.45333, 1.53333, 1.46667, 1.52, 1.56, 2.52, 2.22667, 1.96, 1.85333,
    1.76, 1.65333, 1.53333, 1.50667, 1.50667, 1.44, 1.53333, 1.64,
    1.70667, 1.68, 1.68, 1.64, 1.76, 1.74667, 2.78667, 2.34667, 2.16,
    1.96, 2.10667, 2.09333, 2.08, 2.06667, 2.01333, 2.02667, 2.01333,
    2.0, 1.98667, 1.98667, 1.97333, 2.04, 1.94667, 1.82667, 1.74667,
    1.64, 1.57333, 1.54667, 1.48, 1.49333, 1.50667, 1.76, 1.73333,
    1.73333, 1.81333, 1.74667, 1.84, 1.89333, 2.68, 2.41333, 2.22667,
    2.10667, 2.02667, 2.04, 2.05333, 2.06667,
])


def smooth_cutoff(d, rc):
    """fc(r) = (cos(pi r/rc) + 1)/2 for r < rc else 0 (ref: find_fc)."""
    x = d / rc
    return torch.where(x < 1.0, 0.5 * torch.cos(math.pi * x) + 0.5,
                       torch.zeros_like(x))


def _chebyshev(d, rc, fc, k_max: int):
    """f_0 = fc; f_k = (T_k(x)+1)/2 * fc for k >= 1.  x is clamped to
    [-1, 1]: exact inside the cutoff, and no inf * 0 on far slots."""
    x = torch.clamp(2.0 * (d / rc - 1.0) ** 2 - 1.0, -1.0, 1.0)
    out = [fc]
    if k_max >= 1:
        t_prev, t_cur = torch.ones_like(x), x
        out.append(0.5 * (t_cur + 1.0) * fc)
        for _ in range(2, k_max + 1):
            t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
            out.append(0.5 * (t_cur + 1.0) * fc)
    return torch.stack(out, dim=-1)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A constant table on `device`, copied there once a process: a copy
    from host memory waits for the card's queue, so a loop of small
    passes (an MC block's cluster energies) would stall at every one."""
    return torch.as_tensor(np.asarray(values, np.float64), dtype=dtype,
                           device=device)


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`a` as a constant in `like`'s dtype on its device."""
    return _constant(tuple(map(tuple, np.atleast_2d(a))), like.dtype,
                     like.device).reshape(a.shape)


def _pair_gn(fn, c_t1, t2, num_types: int):
    """g_n(r_ij) = sum_k c[t1, t2, n, k] f_k: fn (B, MN, K1), c_t1 (B, T,
    NB1, K1) gathered at each centre's type, t2 (B, MN) -> (B, MN, NB1)."""
    out = 0.0
    for t in range(num_types):
        gm = torch.einsum("pmk,pnk->pmn", fn, c_t1[:, t])
        out = out + gm * (t2 == t)[..., :, None]
    return out


def _angular_components(u, gn12, l_max: int):
    """s components (B, NA1, C), C = l_max (l_max + 2), from unit bond
    vectors u (B, MN, 3) and per-pair radial factors gn12 (B, MN, NA1)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    zp = [torch.ones_like(z)]
    for _ in range(l_max):
        zp.append(zp[-1] * z)
    zpow = torch.stack(zp, dim=-1)  # (B, MN, l_max + 1)
    # (x + iy)^m, m = 0..l_max
    cr = [torch.ones_like(x)]
    ci = [torch.zeros_like(x)]
    for _ in range(l_max):
        cr.append(cr[-1] * x - ci[-1] * y)
        ci.append(cr[-2] * y + ci[-1] * x)  # cr[-2]: the previous real part
    comps = []
    for L in range(1, l_max + 1):
        ztab = _table(np.asarray(tables.z_coefficient_table(L)), u)
        zf = torch.einsum("pmk,lk->pml", zpow[..., :L + 1], ztab)
        comps.append(zf[..., 0])  # m = 0
        for m in range(1, L + 1):
            comps.append(zf[..., m] * cr[m])
            comps.append(zf[..., m] * ci[m])
    ylm = torch.stack(comps, dim=-1)  # (B, MN, C)
    return torch.einsum("pmn,pmc->pnc", gn12, ylm)


def _angular_q(s, model: NepModel, channels_last: bool = True):
    """Rotation invariants from s components.

    channels_last: s (B, NA1, NLM) -> (B, num_l, NA1) (find_q ordering).
    Otherwise s (B, NA1, NLM, A) -> (B, num_l, NA1, A): the compact
    engine's layout with atoms on the last axis.
    """
    l_max = model.l_max
    nlm = l_max * (l_max + 2)
    c3b = tables.c3b_flat(l_max)
    # q_{nL} = sum over degree L's components of weight * s^2, as one
    # (l_max, NLM) matmul: per-channel slices would cost a full-size
    # gradient buffer per channel in the backward pass
    wmat = np.zeros((l_max, nlm))
    for L in range(1, l_max + 1):
        lo, hi = L * L - 1, (L + 1) * (L + 1) - 1
        wmat[L - 1, lo:hi] = [1.0] + [2.0] * (2 * L)
    wm = _table(wmat * c3b[None, :], s)
    s2 = s * s
    if channels_last:
        q = [(s2 @ wm.T).transpose(1, 2)]
    else:
        q = [(wm @ s2).transpose(1, 2)]
    has = model.has_q
    # one unbind: its backward stacks the channel gradients in one op
    sc = s.unbind(-1 if channels_last else -2) if any(has) else None
    if has[0]:  # q_222 (C4B)
        c4 = tables.C4B
        s3, s4, s5, s6, s7 = sc[3:8]
        q.append((c4[0] * s3 ** 3 + c4[1] * s3 * (s4 ** 2 + s5 ** 2)
                  + c4[2] * s3 * (s6 ** 2 + s7 ** 2)
                  + c4[3] * s6 * (s5 ** 2 - s4 ** 2)
                  + c4[4] * s4 * s5 * s7)[:, None])
    if has[1]:  # q_1111 (C5B)
        c5 = tables.C5B
        s0sq = sc[0] ** 2
        s12sq = sc[1] ** 2 + sc[2] ** 2
        q.append((c5[0] * s0sq ** 2 + c5[1] * s0sq * s12sq
                  + c5[2] * s12sq ** 2)[:, None])
    # extended 4-body invariants mixing L channels (ref: find_q,
    # nep_utilities.cuh:1578-1700); components: L=1 0..2, L=2 3..7,
    # L=3 8..14, L=4 15..23
    if has[2]:  # q_112
        c = tables.C4B2
        q.append((c[0] * sc[0] ** 2 * sc[3]
                  + c[1] * sc[0] * (sc[1] * sc[4] + sc[2] * sc[5])
                  + c[2] * sc[3] * (sc[1] ** 2 + sc[2] ** 2)
                  + c[3] * sc[6] * (sc[1] ** 2 - sc[2] ** 2)
                  + c[4] * sc[1] * sc[2] * sc[7])[:, None])
    if has[3]:  # q_123 (l_max >= 3)
        c = tables.C4B_123
        q.append((
            c[6] * (sc[12] * sc[2] * sc[4] - sc[11] * sc[2] * sc[5]
                    + sc[1] * sc[11] * sc[4] + sc[1] * sc[12] * sc[5])
            + c[5] * (sc[0] * sc[11] * sc[6] + sc[0] * sc[12] * sc[7])
            + c[3] * (sc[14] * sc[2] * sc[6] - sc[13] * sc[2] * sc[7]
                      + sc[1] * sc[13] * sc[6] + sc[1] * sc[14] * sc[7])
            + c[4] * (sc[10] * sc[0] * sc[5] + sc[0] * sc[4] * sc[9])
            + c[1] * (sc[10] * sc[2] * sc[3] + sc[0] * sc[3] * sc[8]
                      + sc[1] * sc[3] * sc[9])
            + c[0] * (sc[10] * sc[2] * sc[6] - sc[10] * sc[1] * sc[7]
                      - sc[2] * sc[7] * sc[9] - sc[1] * sc[6] * sc[9])
            + c[2] * (-sc[2] * sc[5] * sc[8] - sc[1] * sc[4] * sc[8])
        )[:, None])
    if has[4]:  # q_233 (l_max >= 3)
        c = tables.C4B_233
        q.append((
            c[0] * (sc[3] * sc[8] ** 2)
            + c[1] * (sc[10] ** 2 * sc[3] + sc[3] * sc[9] ** 2)
            + c[2] * (-sc[10] ** 2 * sc[6] + sc[6] * sc[9] ** 2)
            + c[3] * (sc[4] * sc[8] * sc[9] + sc[10] * sc[5] * sc[8])
            + c[4] * (-sc[13] ** 2 * sc[3] - sc[14] ** 2 * sc[3])
            + c[5] * (-sc[14] * sc[7] * sc[9] - sc[13] * sc[6] * sc[9]
                      - sc[10] * sc[14] * sc[6] + sc[10] * sc[13] * sc[7])
            + c[6] * (sc[10] * sc[7] * sc[9])
            + c[7] * (-sc[11] * sc[6] * sc[8] - sc[12] * sc[7] * sc[8])
            + c[8] * (sc[11] * sc[4] * sc[9] + sc[12] * sc[5] * sc[9]
                      + sc[10] * sc[12] * sc[4] - sc[10] * sc[11] * sc[5])
            + c[9] * (sc[12] * sc[14] * sc[4] + sc[11] * sc[14] * sc[5]
                      + sc[13] * sc[11] * sc[4] - sc[13] * sc[12] * sc[5])
        )[:, None])
    if has[5]:  # q_134 (l_max >= 4)
        c = tables.C4B_134
        q.append((
            c[0] * (-sc[10] * sc[15] * sc[2] - sc[1] * sc[15] * sc[9])
            + c[1] * (sc[0] * sc[15] * sc[8])
            + c[2] * (-sc[1] * sc[13] * sc[18] - sc[1] * sc[14] * sc[19]
                      - sc[2] * sc[14] * sc[18] + sc[2] * sc[13] * sc[19])
            + c[3] * (-sc[10] * sc[18] * sc[2] + sc[1] * sc[10] * sc[19]
                      + sc[1] * sc[18] * sc[9] + sc[2] * sc[19] * sc[9])
            + c[4] * (sc[1] * sc[16] * sc[8] + sc[2] * sc[17] * sc[8])
            + c[5] * (sc[0] * sc[10] * sc[17] + sc[0] * sc[16] * sc[9]
                      - sc[1] * sc[11] * sc[16] - sc[1] * sc[12] * sc[17]
                      - sc[2] * sc[12] * sc[16] + sc[2] * sc[11] * sc[17])
            + c[6] * (sc[1] * sc[13] * sc[22] + sc[1] * sc[14] * sc[23]
                      - sc[2] * sc[14] * sc[22] + sc[2] * sc[13] * sc[23])
            + c[7] * (sc[0] * sc[11] * sc[18] + sc[0] * sc[12] * sc[19])
            + c[8] * (sc[0] * sc[13] * sc[20] + sc[0] * sc[14] * sc[21])
            + c[9] * (sc[1] * sc[11] * sc[20] + sc[1] * sc[12] * sc[21]
                      - sc[2] * sc[12] * sc[20] + sc[2] * sc[11] * sc[21])
        )[:, None])
    return torch.cat(q, dim=1)


def _zbl_energy(d, t1, t2, model: NepModel, params: NepParams):
    """Universal / flexible ZBL pair energy, halved per ordered pair (ref:
    find_force_ZBL nep.cu:863-975).  With `zbl_typewise_factor` > 0 the
    outer cutoff is min(factor * (rcov_i + rcov_j), rc_outer) per pair and
    the inner one 0 (ref: nep.cu:935-941)."""
    dtype, dev = d.dtype, d.device
    zn = torch.as_tensor(model.atomic_numbers, dtype=dtype, device=dev)
    t1 = t1.long()
    t2 = t2.long()
    zi = zn[t1][..., None] * torch.ones_like(d)
    zj = zn[t2]
    a_inv = (zi ** 0.23 + zj ** 0.23) * 2.134563
    zizj = K_C * zi * zj
    x = d * a_inv
    if model.zbl_flexible:
        # symmetric pair index: t1 <= t2 -> t1 T - t1 (t1 - 1)/2 + (t2 - t1)
        ta = torch.minimum(t1[..., None], t2)
        tb = torch.maximum(t1[..., None], t2)
        pair_idx = ta * model.num_types - (ta * (ta - 1)) // 2 + (tb - ta)
        pp = params.zbl_flex.to(dtype)[pair_idx]  # (..., 10)
        rc1, rc2 = pp[..., 0], pp[..., 1]
        phi = (pp[..., 2] * torch.exp(-pp[..., 3] * x)
               + pp[..., 4] * torch.exp(-pp[..., 5] * x)
               + pp[..., 6] * torch.exp(-pp[..., 7] * x)
               + pp[..., 8] * torch.exp(-pp[..., 9] * x))
    else:
        if model.zbl_typewise_factor > 0.0:
            rcov = torch.as_tensor(_COVALENT_RADIUS[np.maximum(
                np.asarray(model.atomic_numbers) - 1, 0)], dtype=dtype,
                device=dev)
            rc2 = torch.clamp((rcov[t1][..., None] + rcov[t2])
                              * model.zbl_typewise_factor,
                              max=model.zbl_rc_outer) * torch.ones_like(d)
            rc1 = torch.zeros_like(d)
        else:
            rc1 = torch.full_like(d, model.zbl_rc_inner)
            rc2 = torch.full_like(d, model.zbl_rc_outer)
        zp = [float(v) for v in _ZBL_UNIVERSAL]
        phi = (zp[0] * torch.exp(-zp[1] * x) + zp[2] * torch.exp(-zp[3] * x)
               + zp[4] * torch.exp(-zp[5] * x)
               + zp[6] * torch.exp(-zp[7] * x))
    # outer cutoff switch (find_fc_and_fcp_zbl)
    frac = (d - rc1) / torch.clamp(rc2 - rc1, min=1e-30)
    one, zero = torch.ones_like(d), torch.zeros_like(d)
    fc = torch.where(d < rc1, one, torch.where(
        d < rc2, 0.5 * torch.cos(math.pi * frac) + 0.5, zero))
    return 0.5 * zizj / d * phi * fc


def ann_energy(q_scaled, t1, params: NepParams):
    """Per-atom ANN energy (ref: apply_ann_one_layer): every type branch,
    then the atom's own.  q_scaled (P, D), t1 (P,) int."""
    dtype = q_scaled.dtype
    x1 = torch.tanh(torch.einsum("pd,tud->ptu", q_scaled, params.w0.to(dtype))
                    - params.b0.to(dtype)[None])
    e_t = (torch.einsum("ptu,tu->pt", x1, params.w1.to(dtype))
           - params.b1_type.to(dtype)[None])
    e = torch.gather(e_t, 1, t1.long()[:, None])[:, 0]
    return e - params.b1.to(dtype)


class NEP(NamedTuple):
    """NEP potential: static architecture plus parameter tensors."""

    model: NepModel
    params: NepParams
    # target temperature (K) of a model_type 3 (temperature) model, the
    # last descriptor component (ref: nep.cu:1483)
    temperature: Optional[float] = None

    @property
    def rc(self) -> float:
        return self.model.rc_radial_max

    @staticmethod
    def from_file(path: str, dtype=torch.float32,
                  device=torch.device("cuda")) -> "NEP":
        model, params = load_nep_txt(path, dtype=dtype, device=device)
        return NEP(model=model, params=params)

    def restrict(self, present_symbols) -> "NEP":
        """The model sliced to the species present in a simulation (model
        order kept): every per-type table is gathered by (t_i, t_j) only,
        so the numbers are the same.  Remap the system's type codes with
        `remap_types`."""
        old = [str(s) for s in self.model.symbols]
        present = [s for s in old if s in set(present_symbols)]
        missing = set(present_symbols) - set(old)
        if missing:
            raise ValueError(f"species {sorted(missing)} not in the model")
        sel_np = np.asarray([old.index(s) for s in present])
        m = self.model
        model = dataclasses.replace(
            m, num_types=len(present), symbols=tuple(present),
            atomic_numbers=tuple(m.atomic_numbers[i] for i in sel_np),
            rc_radial=tuple(m.rc_radial[i] for i in sel_np),
            rc_angular=tuple(m.rc_angular[i] for i in sel_np))
        p = self.params
        sel = torch.as_tensor(sel_np, device=p.w0.device)

        def tsel(a):
            return None if a is None else a[sel]

        zbl_flex = None
        if p.zbl_flex is not None:
            def pidx(a, b, t):
                a, b = min(a, b), max(a, b)
                return a * t - (a * (a - 1)) // 2 + (b - a)

            rows = [pidx(int(sel_np[a]), int(sel_np[b]), m.num_types)
                    for a in range(len(sel_np))
                    for b in range(a, len(sel_np))]
            zbl_flex = p.zbl_flex[torch.as_tensor(rows, device=sel.device)]
        params = p._replace(
            w0=tsel(p.w0), b0=tsel(p.b0), w1=tsel(p.w1),
            b1_type=tsel(p.b1_type), c_radial=p.c_radial[sel][:, sel],
            c_angular=p.c_angular[sel][:, sel], zbl_flex=zbl_flex,
            w0_pol=tsel(p.w0_pol), b0_pol=tsel(p.b0_pol),
            w1_pol=tsel(p.w1_pol))
        return self._replace(model=model, params=params)

    def remap_types(self, types, original_symbols) -> np.ndarray:
        """Type codes of the original (unrestricted) model -> this model's."""
        old = [str(s) for s in original_symbols]
        lut = np.full(len(old), -1, np.int32)
        for i, s in enumerate(self.model.symbols):
            lut[old.index(s)] = i
        out = lut[np.asarray(types)]
        if (out < 0).any():
            raise ValueError("types present that the restricted model lacks")
        return out

    # ---- descriptor + energy ---------------------------------------------

    def pair_energies(self, r12, t1, t2):
        """Per-atom energies from displacements and centre / neighbour
        types (the potential protocol)."""
        return self.per_atom_energy(r12, t1, t2)

    def per_atom_energy(self, r12, t1, t2, block: Optional[int] = None):
        """Per-atom energies (N,) from r12 (N, MN, 3), in blocks of
        `block` atoms (default `block_size`).  The blocks are joined by
        one cat, with no write into a preallocated tensor, so torch.func
        can map the function over a population of parameters (the SNES
        trainer) and differentiate it twice (gnep)."""
        n = r12.shape[0]
        block = block or block_size(r12)
        return torch.cat([self._block_energy(r12[s:s + block],
                                             t1[s:s + block],
                                             t2[s:s + block])
                          for s in range(0, max(n, 1), block)])

    def raw_descriptors(self, r12, t1, t2):
        """Unscaled per-atom descriptors q (B, dim) and distances d (B, MN)
        (the trainer derives q_scaler from them, ref: find_max_min)."""
        model, params = self.model, self.params
        dtype, dev = r12.dtype, r12.device
        t1 = t1.long()
        t2 = t2.long()
        d = torch.sqrt(torch.sum(r12 * r12, dim=-1))  # (B, MN)
        rc_r = _constant(tuple(model.rc_radial), dtype, dev)
        rc_a = _constant(tuple(model.rc_angular), dtype, dev)
        rcp_r = 0.5 * (rc_r[t1][:, None] + rc_r[t2])
        rcp_a = 0.5 * (rc_a[t1][:, None] + rc_a[t2])
        # radial block
        fc_r = smooth_cutoff(d, rcp_r)
        fn_r = _chebyshev(d, rcp_r, fc_r, model.basis_size_radial)
        gn_r = _pair_gn(fn_r, params.c_radial.to(dtype)[t1], t2,
                        model.num_types)  # (B, MN, NR1)
        q_rad = torch.sum(gn_r, dim=1)
        # angular block
        fc_a = smooth_cutoff(d, rcp_a)
        fn_a = _chebyshev(d, rcp_a, fc_a, model.basis_size_angular)
        gn_a = _pair_gn(fn_a, params.c_angular.to(dtype)[t1], t2,
                        model.num_types)  # (B, MN, NA1)
        s = _angular_components(r12 / d[..., None], gn_a, model.l_max)
        q_ang = _angular_q(s, model)  # (B, num_l, NA1)
        return torch.cat([q_rad, q_ang.reshape(q_ang.shape[0], -1)],
                         dim=-1), d

    def _block_energy(self, r12, t1, t2):
        model = self.model
        q, d = self.raw_descriptors(r12, t1, t2)
        if model.model_type == 3:
            if self.temperature is None:
                raise ValueError("temperature-mode NEP needs NEP.temperature "
                                 "set")
            q = torch.cat([q, torch.full((q.shape[0], 1),
                                         float(self.temperature),
                                         dtype=q.dtype, device=q.device)],
                          dim=-1)
        q = q * self.params.q_scaler.to(q.dtype)
        e = ann_energy(q, t1, self.params)
        if model.zbl:
            # the ZBL switch vanishes beyond rc_outer; padded slots are far
            e = e + torch.sum(_zbl_energy(d, t1, t2, model, self.params),
                              dim=-1)
        return e

    def b_projection(self, r12, t1, t2):
        """Per-atom gradient of its energy with respect to its element's
        ANN parameters, [dE/dw0[n, :], dE/db0[n], dE/dw1[n]] per neuron n
        (the MaxVol active-learning features, ref: nep_utilities.cuh:
        254-283, nep.cu:394)."""
        params = self.params
        q_raw, _ = self.raw_descriptors(r12, t1, t2)
        dtype = q_raw.dtype
        q = q_raw * params.q_scaler.to(dtype)
        t1 = t1.long()
        w0 = params.w0.to(dtype)[t1]  # (B, neu, dim)
        b0 = params.b0.to(dtype)[t1]
        w1 = params.w1.to(dtype)[t1]
        x1 = torch.tanh(torch.einsum("pud,pd->pu", w0, q) - b0)
        td = 1.0 - x1 * x1
        dw0 = td[:, :, None] * q[:, None, :] * w1[:, :, None]
        db0 = -td * w1
        b = torch.cat([dw0, db0[..., None], x1[..., None]], dim=-1)
        return b.reshape(b.shape[0], -1)

    # ---- tensorial observables (TNEP) --------------------------------------

    def _energy_fn(self, type_, t2):
        return lambda r12, rows: self._block_energy(r12, type_[rows],
                                                    t2[rows])

    def dipole(self, type_, nbr: NeighborList, mask):
        """Global dipole of a nep*_dipole model (ref: nep.cu:737-742:
        mu_a = sum_i sum_j -|r12|^2 f21_a, f21 the mirror partial)."""
        if self.model.model_type != 1:
            raise ValueError("dipole() needs a _dipole model")
        t2 = type_[nbr.idx.long()]
        _, p = energy_and_partials(self._energy_fn(type_, t2), nbr.r12,
                                   mask.to(nbr.r12.dtype),
                                   block_size(nbr.r12))
        r2 = torch.sum(nbr.r12 ** 2, dim=-1) * nbr.mask
        if nbr.rev is not None:
            p = gather_vec3(p.reshape(-1, 3), nbr.rev) * nbr.mask[..., None]
        # without a reverse map: pair-mirror symmetry, the same sum
        return -torch.einsum("nm,nma->a", r2, p)

    def polarizability(self, type_, nbr: NeighborList, mask):
        """Polarizability tensor of a nep*_polarizability model: the
        second ANN head's scalar on the diagonal plus the r12 (x) f21
        virial terms (ref: find_descriptor, is_polarizability)."""
        if self.model.model_type != 2:
            raise ValueError("polarizability() needs a _polarizability model")
        t2 = type_[nbr.idx.long()]
        out = compute_from_pair_energy(self._energy_fn(type_, t2), nbr, mask,
                                       block=block_size(nbr.r12))
        w_total = torch.sum(out.virial * mask[:, None, None], dim=0)
        p = self.params
        q, _ = self.raw_descriptors(nbr.r12, type_, t2)
        dtype = q.dtype
        q = q * p.q_scaler.to(dtype)
        x1 = torch.tanh(torch.einsum("pd,tud->ptu", q, p.w0_pol.to(dtype))
                        - p.b0_pol.to(dtype)[None])
        f_t = torch.einsum("ptu,tu->pt", x1, p.w1_pol.to(dtype))
        f_pol = torch.gather(f_t, 1, type_.long()[:, None])[:, 0]
        f_pol = (f_pol - p.b1_pol.to(dtype)) * mask
        return w_total + torch.sum(f_pol) * torch.eye(3, dtype=dtype,
                                                      device=q.device)

    # ---- potential interface ---------------------------------------------

    def compute(self, type_, nbr: NeighborList, mask,
                per_atom_virial=True) -> PotentialOutput:
        t2 = type_[nbr.idx.long()]
        return compute_from_pair_energy(self._energy_fn(type_, t2), nbr,
                                        mask, per_atom_virial=per_atom_virial,
                                        block=block_size(nbr.r12))
