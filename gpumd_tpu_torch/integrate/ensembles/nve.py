"""NVE (microcanonical) ensemble: plain velocity-Verlet
(ref: src/integrate/ensemble_nve.cu:30-80).

Ensemble protocol: `init(state) -> aux`, `step1(state, aux, dt)`,
`step2(state, aux, dt) -> (state, aux)`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from gpumd_tpu_torch.integrate.verlet import (
    velocity_verlet_step1,
    velocity_verlet_step2,
)
from gpumd_tpu_torch.model.state import MDState


@dataclass(frozen=True)
class NVE:
    mobile: Optional[object] = None  # optional (N,) mobility mask
    pinned: Optional[tuple] = None  # (mask, velocity) constant-velocity group

    def init(self, state: MDState):
        return ()

    def step1(self, state: MDState, aux, dt):
        return velocity_verlet_step1(state, dt, self.mobile, self.pinned), aux

    def step2(self, state: MDState, aux, dt):
        return velocity_verlet_step2(state, dt, self.mobile, self.pinned), aux
