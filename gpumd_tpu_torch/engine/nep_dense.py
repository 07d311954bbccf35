"""Pair-tile helpers shared by the compact kernels' plain versions.

Counterpart of the tile math in gpumd_tpu/engine/nep_dense.py.  Only
`_ylm_tile` is ported: the round-2 dense engine (engine="v2") is not.
"""

from __future__ import annotations

import numpy as np
import torch

from gpumd_tpu_torch.potentials.nep import tables


def z_tables_flat(l_max: int) -> np.ndarray:
    """Y_lm z-polynomial coefficients for L = 1..l_max, each (L+1)x(L+1)
    row-major, concatenated: the layout the CUDA kernels read."""
    return np.concatenate([tables.z_coefficient_table(L).ravel()
                           for L in range(1, l_max + 1)])


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
