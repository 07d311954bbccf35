"""Velocity-Verlet half-steps (ref: src/integrate/ensemble.cu:113-214).

Counterpart of gpumd_tpu/integrate/verlet.py: step 1 kicks v by dt/2 and
drifts x by dt; step 2 kicks v by dt/2.  When the state carries
compensation arrays (position_c / velocity_c) the updates accumulate with
exact TwoSum error terms, so f32 integration keeps ~f64 precision.
dt is in natural time units (fs / TIME_UNIT_CONVERSION).
"""

from __future__ import annotations

import torch

from gpumd_tpu_torch.model.state import MDState


def two_sum_acc(x, c, dx):
    """Accumulate dx into the extended-precision pair (x, c): Kahan feeds
    the carried compensation into the increment, then TwoSum captures the
    exact rounding error of the high-part addition."""
    y = dx + c
    t = x + y
    z = t - x
    err = (x - (t - z)) + (y - z)
    return t, err


def _kick(state: MDState, dt_half, mobile, pinned):
    dv = dt_half * state.force / state.mass[:, None]
    vc = state.velocity_c
    if vc is not None:
        v, vc = two_sum_acc(state.velocity, vc, dv)
    else:
        v = state.velocity + dv
    if mobile is not None:
        v = v * mobile[:, None]
        if vc is not None:
            vc = vc * mobile[:, None]
    if pinned is not None:
        mask, vel = pinned
        v = torch.where(mask[:, None] > 0,
                        torch.as_tensor(vel, dtype=v.dtype,
                                        device=v.device)[None, :], v)
        if vc is not None:
            vc = torch.where(mask[:, None] > 0, torch.zeros_like(vc), vc)
    return v, vc


def velocity_verlet_step1(state: MDState, dt, mobile=None, pinned=None,
                          kick=True, drift=True) -> MDState:
    if kick:
        v, vc = _kick(state, 0.5 * dt, mobile, pinned)
    else:
        v, vc = state.velocity, state.velocity_c
    if not drift:
        return state._replace(velocity=v, velocity_c=vc)
    dx = dt * v
    pc = state.position_c
    if pc is not None:
        pos, pc = two_sum_acc(state.position, pc, dx)
        pc = pc + dt * vc  # the velocity's low part advances x too
    else:
        pos = state.position + dx
    unwrapped = (state.unwrapped_position + dx
                 if state.unwrapped_position is not None else None)
    return state._replace(position=pos, velocity=v,
                          unwrapped_position=unwrapped, position_c=pc,
                          velocity_c=vc)


def velocity_verlet_step2(state: MDState, dt, mobile=None,
                          pinned=None) -> MDState:
    v, vc = _kick(state, 0.5 * dt, mobile, pinned)
    step = state.step + 1 if state.step is not None else None
    return state._replace(velocity=v, velocity_c=vc, step=step)
