"""Box deformation: strain-rate box stretching for tensile tests.

Counterpart of gpumd_tpu/integrate/ensembles/deform.py.  run.in:
`deform rate [rx ry rz] dx dy dz` (A a step on the flagged directions,
ref: integrate.cu:1381-1420; applied after the ensemble's second half
step as ensemble_ber.cu:93-105 does: the box length grows by the rate and
the positions scale with it).  Wraps any inner ensemble; on the card, no
read a step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from gpumd_tpu_torch.integrate.ensembles.npt import _vec3


@dataclass(frozen=True)
class DeformWrapper:
    inner: object
    rate: Tuple[float, float, float]  # A a step a direction (0 = off)

    def init(self, state):
        return self.inner.init(state)

    def step1(self, state, aux, dt):
        return self.inner.step1(state, aux, dt)

    def step2(self, state, aux, dt):
        state, aux = self.inner.step2(state, aux, dt)
        h = state.box.h
        lengths = torch.diagonal(h)
        scale = (lengths + _vec3(self.rate, h)) / lengths
        up = state.unwrapped_position
        return state._replace(
            position=state.position * scale[None, :],
            box=state.box.with_h(h * scale[None, :]),
            unwrapped_position=(up * scale[None, :] if up is not None
                                else None)), aux
