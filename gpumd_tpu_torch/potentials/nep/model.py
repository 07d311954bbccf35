"""NEP pieces the compact engine's middle stage needs.

Counterpart of gpumd_tpu/potentials/nep/model.py: the rotation invariants
(`_angular_q`), the per-type ANN (`ann_energy`), the ZBL constants and a
small `NEP` holder.  The list-path evaluation (neighbor lists + autograd
forces) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.potentials.nep import tables
from gpumd_tpu_torch.potentials.nep.params import (
    NepModel,
    NepParams,
    load_nep_txt,
)

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
    wm = torch.as_tensor(wmat * c3b[None, :], dtype=s.dtype, device=s.device)
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
    if any(has[2:]):
        raise NotImplementedError(
            "extended 4-body invariants (q112/q123/q233/q134): not ported yet")
    return torch.cat(q, dim=1)


def ann_energy(q_scaled, t1, params: NepParams):
    """Per-atom ANN energy (ref: apply_ann_one_layer): every type branch,
    then the atom's own.  q_scaled (P, D), t1 (P,) int."""
    x1 = torch.tanh(torch.einsum("pd,tud->ptu", q_scaled, params.w0)
                    - params.b0[None])
    e_t = torch.einsum("ptu,tu->pt", x1, params.w1) - params.b1_type[None]
    e = torch.gather(e_t, 1, t1.long()[:, None])[:, 0]
    return e - params.b1


class NEP(NamedTuple):
    """NEP potential: static architecture plus parameter tensors."""

    model: NepModel
    params: NepParams
    temperature: Optional[float] = None  # model_type 3 only

    @property
    def rc(self) -> float:
        return self.model.rc_radial_max

    @staticmethod
    def from_file(path: str, dtype=torch.float32,
                  device=torch.device("cuda")) -> "NEP":
        model, params = load_nep_txt(path, dtype=dtype, device=device)
        return NEP(model=model, params=params)
