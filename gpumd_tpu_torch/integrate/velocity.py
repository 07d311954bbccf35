"""Initial Maxwell velocities with momentum zeroing
(ref: src/main_gpumd/velocity.cu:77-258).

Counterpart of gpumd_tpu/integrate/velocity.py.  Draws come from a
torch.Generator, whose stream differs from that of JAX's random module;
to reproduce a JAX run, pass the same raw velocities as `velocity` to
both packages.
"""

from __future__ import annotations

import torch

from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import K_B


def _zero_linear_momentum(v, mass, mask):
    m = mass * mask
    v_cm = torch.sum(m[:, None] * v, dim=0) / torch.sum(m)
    return (v - v_cm[None, :]) * mask[:, None]


def _zero_angular_momentum(v, position, mass, mask):
    m = mass * mask
    r_cm = torch.sum(m[:, None] * position, dim=0) / torch.sum(m)
    r = (position - r_cm) * mask[:, None]
    ang_mom = torch.sum(m[:, None] * torch.linalg.cross(r, v), dim=0)
    r2 = torch.sum(r * r, dim=-1)
    inertia = (torch.sum(m * r2) * torch.eye(3, dtype=v.dtype,
                                             device=v.device)
               - torch.einsum("n,na,nb->ab", m, r, r))
    omega = torch.linalg.solve(inertia, ang_mom)
    return (v - torch.linalg.cross(omega.expand_as(r), r)) * mask[:, None]


def initialize_velocity(state: MDState, temperature: float,
                        seed: int = 12345, zero_angular: bool = False,
                        velocity=None) -> MDState:
    """Maxwell velocities at `temperature` K (natural velocity units).

    `velocity` (N, 3), when given, replaces the random draw; momentum
    zeroing and the rescale to the exact temperature still apply."""
    dtype, dev = state.position.dtype, state.position.device
    n = state.position.shape[0]
    if velocity is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
        sigma = torch.sqrt(K_B * temperature / state.mass)
        v = torch.randn((n, 3), generator=generator, dtype=dtype,
                        device=dev) * sigma[:, None]
    else:
        v = torch.as_tensor(velocity, dtype=dtype, device=dev)
    v = _zero_linear_momentum(v, state.mass, state.mask)
    if zero_angular:
        v = _zero_angular_momentum(v, state.position, state.mass, state.mask)
    ke = 0.5 * torch.sum(state.mass * torch.sum(v * v, dim=-1) * state.mask)
    t_now = 2.0 * ke / (3.0 * torch.sum(state.mask) * K_B)
    return state._replace(velocity=v * torch.sqrt(temperature / t_now))
