"""PPPM reciprocal-space electrostatics (the qNEP k-space backend).

Counterpart of gpumd_tpu/potentials/nep/pppm.py (ref: src/force/pppm.cu:
274-720): the energy is one differentiable function

    E_rec(q, x) = K_C * sum_k G_opt(k) |S_mesh(k)|^2,

with order-5 B-spline charge assignment onto a (K2, K1, K0) mesh and the
optimal influence function G_opt of Ballenegger, Cerda and Holm (JCTC 8,
936 (2012), Eqs. 2.21-2.26, the polynomials the reference hardcodes,
pppm.cu:38-47).  Forces, the charge-gradient chain and the Born charges
come from autograd through this scalar: the gradient of the meshed
energy, which conserves energy in MD.

The charge spread is index_add_ over flat mesh ids (125 a charge); the FFT
is torch.fft.fftn, as the JAX package's is jnp.fft.fftn outside any
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.units import K_C

# Order-5 cardinal B-spline assignment polynomials in the fractional offset
# d in (-1/2, 1/2): W[m](d) for mesh offsets m = -2..2 (Deserno and Holm,
# JCP 109, 7678 (1998), Appendix E; ref: pppm.cu:40-47)
_W_COEFF = np.array([
    [1.0 / 384, -1.0 / 48, 1.0 / 16, -1.0 / 12, 1.0 / 24],
    [19.0 / 96, -11.0 / 24, 1.0 / 4, 1.0 / 6, -1.0 / 6],
    [115.0 / 192, 0.0, -5.0 / 8, 0.0, 1.0 / 4],
    [19.0 / 96, 11.0 / 24, 1.0 / 4, -1.0 / 6, -1.0 / 6],
    [1.0 / 384, 1.0 / 48, 1.0 / 16, 1.0 / 12, 1.0 / 24],
])

# the denominator: sum over aliases of M5^2 as a polynomial in
# sin^2(pi n / K) (Ballenegger et al. Eq. 2.26; ref: pppm.cu:39)
_G_COEFF = (1.0, -5.0 / 3, 7.0 / 9, -17.0 / 189, 2.0 / 2835)


def best_mesh(box: Box, mesh_spacing: float = 1.0) -> Tuple[int, int, int]:
    """Power-of-two mesh size per axis, >= thickness / spacing, at least 16
    (ref: pppm.cu:30-36, 591-600)."""
    t = box.thickness().detach().cpu().numpy().astype(np.float64)
    out = []
    for d in range(3):
        k = 16
        while k < int(t[d] / mesh_spacing):
            k *= 2
        out.append(k)
    return tuple(out)


def _bspline5(d):
    """(..., 5) order-5 assignment weights at fractional offset d."""
    powers = torch.stack([torch.ones_like(d), d, d * d, d ** 3, d ** 4],
                         dim=-1)
    return powers @ torch.as_tensor(_W_COEFF.T, dtype=d.dtype,
                                    device=d.device)


def _axis_modes(k: int, device):
    n = torch.arange(k, device=device)
    return torch.where(n >= k // 2, n - k, n)


def k_grids(box: Box, mesh, dtype):
    """(kx, ky, kz, ksq) Cartesian k-vector grids, (K2, K1, K0) layout."""
    k0, k1, k2 = mesh
    dev = box.h.device
    b = 2.0 * math.pi * box.h_inv.to(dtype)  # rows: reciprocal vectors
    n0, n1, n2 = (_axis_modes(k, dev).to(dtype) for k in (k0, k1, k2))
    comps = [n2[:, None, None] * b[2, a] + n1[None, :, None] * b[1, a]
             + n0[None, None, :] * b[0, a] for a in range(3)]
    kx, ky, kz = comps
    return kx, ky, kz, kx * kx + ky * ky + kz * kz


def influence_function(box: Box, alpha: float, mesh, dtype):
    """G_opt on the (K2, K1, K0) mesh (ref: find_k_and_G_opt), from the
    box as it is now (a barostat's box changes flow through)."""
    dev = box.h.device
    g = _G_COEFF

    def denom_axis(k):
        t = torch.sin(math.pi * _axis_modes(k, dev).to(dtype) / k) ** 2
        p = (((g[4] * t + g[3]) * t + g[2]) * t + g[1]) * t + g[0]
        return p * p

    def numer_axis(k):
        # sinc by its series near 0 (ref: pppm.cu sinc)
        x = math.pi * _axis_modes(k, dev).to(dtype) / k
        small = torch.abs(x) < 1e-4
        xs = torch.where(small, torch.ones_like(x), x)
        return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xs) / xs)

    k0, k1, k2 = mesh
    d0, d1, d2 = denom_axis(k0), denom_axis(k1), denom_axis(k2)
    u0, u1, u2 = numer_axis(k0), numer_axis(k1), numer_axis(k2)
    _, _, _, ksq = k_grids(box, mesh, dtype)
    numer = (u2[:, None, None] * u1[None, :, None] * u0[None, None, :]) ** 10
    denom = d2[:, None, None] * d1[None, :, None] * d0[None, None, :]
    pref = 2.0 * math.pi / box.volume.to(dtype)
    return torch.where(
        ksq > 0,
        numer * pref / torch.clamp(ksq, min=1e-12)
        * torch.exp(-ksq / (4.0 * alpha * alpha)) / denom,
        torch.zeros_like(ksq))


def mesh_structure_factor(q, positions, box: Box, mesh):
    """FFT of the B-spline-assigned charge mesh (differentiable in q, x)."""
    k0, k1, k2 = mesh
    dtype, dev = positions.dtype, positions.device
    kvec = torch.as_tensor([k0, k1, k2], dtype=dtype, device=dev)
    s = (positions @ box.h_inv.to(dtype).T) * kvec  # fractional x K
    i0 = torch.floor(s + 0.5)
    w = _bspline5(s - i0)  # (N, 3, 5), the offsets in (-1/2, 1/2)
    offs = torch.arange(-2, 3, device=dev)
    idx = i0.long()[:, :, None] + offs[None, None, :]
    idx = torch.remainder(idx, torch.as_tensor([k0, k1, k2], device=dev
                                               )[None, :, None])
    # flat id n0 + K0 (n1 + K1 n2) over the (5z, 5y, 5x) stencil
    fid = (idx[:, 0, None, None, :]
           + k0 * (idx[:, 1, None, :, None] + k1 * idx[:, 2, :, None, None]))
    val = (q[:, None, None, None] * w[:, 2, :, None, None]
           * w[:, 1, None, :, None] * w[:, 0, None, None, :])
    grid = torch.zeros(k0 * k1 * k2, dtype=dtype, device=dev).index_add(
        0, fid.reshape(-1), val.reshape(-1))
    return torch.fft.fftn(grid.reshape(k2, k1, k0))


def pppm_reciprocal_energy(q, positions, box: Box, alpha: float, mesh):
    """K_C sum_k G_opt |S_mesh|^2, and |S_mesh|^2 (K2, K1, K0)."""
    s_k = mesh_structure_factor(q, positions, box, mesh)
    s2 = s_k.real ** 2 + s_k.imag ** 2
    g = influence_function(box, alpha, mesh, positions.dtype)
    return K_C * torch.sum(g * s2), s2


def pppm_virial_total(s2, box: Box, alpha: float, mesh, dtype):
    """The total reciprocal virial (3, 3) from |S_mesh|^2:
    W_ab = K_C sum_k G |S|^2 (delta_ab - (0.5/alpha^2 + 2/k^2) k_a k_b)
    (ref: find_mesh_virial / find_potential_and_virial, pppm.cu:224-268)."""
    g = influence_function(box, alpha, mesh, dtype)
    kx, ky, kz, ksq = k_grids(box, mesh, dtype)
    pref = K_C * g * s2
    akf = torch.where(ksq > 0, 0.5 / (alpha * alpha)
                      + 2.0 / torch.clamp(ksq, min=1e-12),
                      torch.zeros_like(ksq))
    e_tot = torch.sum(pref)
    kv = (kx, ky, kz)
    w = torch.stack([torch.stack([-torch.sum(pref * akf * kv[a] * kv[b])
                                  for b in range(3)]) for a in range(3)])
    return w + e_tot * torch.eye(3, dtype=dtype, device=w.device)
