"""MD simulation state: per-atom tensors plus the box.

Counterpart of gpumd_tpu/model/state.py.  All arrays are padded to n_pad
rows; `mask` marks real atoms.  Updates build a new state with
`state._replace(...)`, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.units import K_B


class MDState(NamedTuple):
    position: torch.Tensor  # (N, 3)
    velocity: torch.Tensor  # (N, 3) natural units
    force: torch.Tensor  # (N, 3) eV/A
    mass: torch.Tensor  # (N,)
    type: torch.Tensor  # (N,) int32 potential type index
    box: Box
    potential_energy: torch.Tensor  # (N,) per-atom eV
    virial: torch.Tensor  # (N, 3, 3) eV
    heat_current: torch.Tensor  # (N, 3)
    mask: torch.Tensor  # (N,) 1.0 for real atoms
    charge: Optional[torch.Tensor] = None
    unwrapped_position: Optional[torch.Tensor] = None
    step: Optional[torch.Tensor] = None  # () int32
    # TwoSum compensation low parts (see integrate/verlet.py)
    position_c: Optional[torch.Tensor] = None
    velocity_c: Optional[torch.Tensor] = None

    def kinetic_energy(self):
        v2 = torch.sum(self.velocity ** 2, dim=-1)
        return 0.5 * torch.sum(self.mass * v2 * self.mask)

    def temperature(self):
        """Instantaneous temperature in K from 3N degrees of freedom."""
        n = torch.clamp(torch.sum(self.mask), min=1.0)
        return 2.0 * self.kinetic_energy() / (3.0 * n * K_B)


def make_state(
    position,
    mass,
    type_,
    box: Box,
    velocity=None,
    n_pad: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    compensated: bool = False,
) -> MDState:
    """Build an MDState on the box's device, padding all per-atom arrays to
    n_pad (padding atoms sit at the origin with mass 1 and mask 0)."""
    dtype = dtype or box.h.dtype
    device = box.h.device

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dt, device=device)

    position = t(position)
    n = position.shape[0]
    n_pad = n if n_pad is None else n_pad
    if n_pad < n:
        raise ValueError(f"n_pad={n_pad} < n_atoms={n}")
    pad = n_pad - n

    def padv(x, fill=0.0):
        if pad == 0:
            return x
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=device)
        return torch.cat([x, tail], dim=0)

    position = padv(position)
    zeros3 = torch.zeros((n_pad, 3), dtype=dtype, device=device)
    return MDState(
        position=position,
        velocity=padv(t(velocity)) if velocity is not None else zeros3,
        force=zeros3.clone(),
        mass=padv(t(mass), fill=1.0),
        type=padv(t(type_, torch.int32)),
        box=box,
        potential_energy=torch.zeros((n_pad,), dtype=dtype, device=device),
        virial=torch.zeros((n_pad, 3, 3), dtype=dtype, device=device),
        heat_current=zeros3.clone(),
        mask=torch.cat([torch.ones(n, dtype=dtype, device=device),
                        torch.zeros(pad, dtype=dtype, device=device)]),
        step=torch.zeros((), dtype=torch.int32, device=device),
        position_c=zeros3.clone() if compensated else None,
        velocity_c=zeros3.clone() if compensated else None,
    )
