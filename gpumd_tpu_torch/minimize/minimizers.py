"""Energy minimizers: steepest descent and FIRE, with or without the box.

Counterpart of gpumd_tpu/minimize/minimizers.py.  run.in keywords
(ref: src/minimize/minimize.cu:32-155):
    minimize sd   <force_tolerance> <max_steps>
    minimize fire <force_tolerance> <max_steps> [box_change [hydrostatic]]

FIRE constants match the reference (minimizer_fire.cuh:24-34): f_inc 1.1,
f_dec 0.5, alpha0 0.25, f_alpha 0.99, dt0 = 1 fs, dt in [0.02, 10] dt0,
N_min 20, fictitious mass 5; implicit-Euler velocity mixing
(minimizer_fire.cu:110-180).

The JAX package runs each minimizer as one `lax.while_loop` whose
condition is tested on the device.  Here the loop is a Python loop over
the same body, run on the state's device: its convergence test reads one
value a step (f_max, and for the box the stress with it), as the reference
syncs f_max every step, and stops at the step JAX's loop stops at.  The
step's branches (uphill or not, a better trial or not) select with
torch.where on the device, so the body reads nothing.  Every force pass is
`ForceField.compute` (a fresh list of the force field's plan); the box
variant moves the cell with `Box.with_h`, as the list path's barostats do.
Each function returns (state, steps).
"""

from __future__ import annotations

import torch

from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.model.state import MDState
from gpumd_tpu_torch.units import (PRESSURE_UNIT_CONVERSION,
                                   TIME_UNIT_CONVERSION)

# FIRE (ref: minimizer_fire.cuh:24-34)
F_INC, F_DEC = 1.1, 0.5
ALPHA0, F_ALPHA = 0.25, 0.99
N_MIN = 20
FIRE_MASS = 5.0
# the box variant's convergence bound on |stress| (GPa)
STRESS_TOL = 1e-4


def _fmax(state: MDState) -> torch.Tensor:
    f2 = torch.sum(state.force ** 2, dim=-1) * state.mask
    return torch.sqrt(torch.max(f2))


def _select(cond: torch.Tensor, a: MDState, b: MDState) -> MDState:
    """a where the 0-d `cond` holds, else b, field by field on the
    device (jnp.where over the state's tree)."""
    def pick(x, y):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(pick(u, v) for u, v in zip(x, y)))
        return torch.where(cond, x, y)

    return MDState(*(pick(x, y) for x, y in zip(a, b)))


def _fire_constants(dtype, device):
    dt0 = 1.0 / TIME_UNIT_CONVERSION
    return (torch.tensor(dt0, dtype=dtype, device=device),
            10.0 * dt0, 0.02 * dt0)


def minimize_sd(ff: ForceField, state: MDState, force_tolerance: float,
                max_steps: int, step_size: float = 0.01):
    """Steepest descent with adaptive step (ref: minimizer_sd.cu: moves
    along F by a trial step, rejects uphill moves and shrinks)."""
    with torch.no_grad():
        state = ff.compute(state)
        gamma = torch.tensor(step_size, dtype=state.position.dtype,
                             device=state.position.device)
        steps = 0
        while steps < max_steps and float(_fmax(state)) > force_tolerance:
            e0 = torch.sum(state.potential_energy * state.mask)
            fnorm = torch.sqrt(torch.sum(state.force ** 2
                                         * state.mask[:, None]))
            dx = gamma * state.force / torch.clamp(fnorm, min=1e-30)
            trial = ff.compute(state._replace(position=state.position + dx))
            e1 = torch.sum(trial.potential_energy * trial.mask)
            better = e1 < e0
            state = _select(better, trial, state)
            gamma = torch.where(better, gamma * 1.2, gamma * 0.5)
            steps += 1
    return state, steps


def _fire_schedule(p, dt, alpha, n_neg, dt_max, dt_min):
    """FIRE's step and mixing update from the power p = v . F: (uphill,
    dt, alpha, n_neg) of the next step."""
    uphill = p <= 0
    grow = (~uphill) & (n_neg > N_MIN)
    dt_new = torch.where(grow, torch.clamp(dt * F_INC, max=dt_max), dt)
    alpha_new = torch.where(grow, alpha * F_ALPHA, alpha)
    n_neg_new = torch.where(uphill, torch.zeros_like(n_neg), n_neg + 1)
    dt_new = torch.where(uphill, torch.clamp(dt * F_DEC, min=dt_min),
                         dt_new)
    alpha_new = torch.where(uphill, torch.full_like(alpha, ALPHA0),
                            alpha_new)
    return uphill, dt_new, alpha_new, n_neg_new


def minimize_fire(ff: ForceField, state: MDState, force_tolerance: float,
                  max_steps: int):
    """FIRE on the atoms (ref: minimizer_fire.cu:110-180)."""
    with torch.no_grad():
        state = ff.compute(state)
        dtype, dev = state.position.dtype, state.position.device
        dt, dt_max, dt_min = _fire_constants(dtype, dev)
        alpha = torch.tensor(ALPHA0, dtype=dtype, device=dev)
        n_neg = torch.zeros((), dtype=torch.int32, device=dev)
        v = torch.zeros_like(state.velocity)
        steps = 0
        while steps < max_steps and float(_fmax(state)) > force_tolerance:
            f = state.force * state.mask[:, None]
            uphill, dt_new, alpha, n_neg = _fire_schedule(
                torch.sum(v * f), dt, alpha, n_neg, dt_max, dt_min)
            pos = torch.where(uphill, state.position - 0.5 * dt * v,
                              state.position)
            v = torch.where(uphill, torch.zeros_like(v), v)
            # implicit Euler + velocity mixing
            f_mod = torch.sqrt(torch.sum(f * f))
            v = v + (dt_new / FIRE_MASS) * f
            v_mod = torch.sqrt(torch.sum(v * v))
            v = (1.0 - alpha) * v + alpha * (
                v_mod / torch.clamp(f_mod, min=1e-30)) * f
            pos = pos + dt_new * v
            state = ff.compute(state._replace(position=pos))
            dt = dt_new
            steps += 1
    return state, steps


def minimize_fire_box(ff: ForceField, state: MDState,
                      force_tolerance: float, max_steps: int,
                      hydrostatic: bool = False):
    """FIRE on the extended (atoms + box) coordinate vector
    (ref: src/minimize/minimizer_fire_box_change.cu:239-404).

    The box degrees of freedom see a generalized force W / L_scale (total
    virial, L_scale = cbrt(V0) fixed at start); each step applies the
    strain increment dEps = v_box dt / L_scale as H += dEps H and r += v dt
    + dEps r.  With `hydrostatic`, the virial is replaced by its isotropic
    part so only the volume relaxes.  Converged when f_max < tol AND max
    |stress| < 1e-4 GPa (the raw anisotropic tensor, or |pressure| in
    hydrostatic mode, matching :285-305); the test reads f_max and the
    stress together, one read a step."""
    with torch.no_grad():
        state = ff.compute(state)
        dtype, dev = state.position.dtype, state.position.device
        dt, dt_max, dt_min = _fire_constants(dtype, dev)
        alpha = torch.tensor(ALPHA0, dtype=dtype, device=dev)
        n_pos = torch.zeros((), dtype=torch.int32, device=dev)
        l_scale = torch.pow(state.box.volume, 1.0 / 3.0).to(dtype)
        eye = torch.eye(3, dtype=dtype, device=dev)

        def box_force(st):
            w = torch.sum(st.virial * st.mask[:, None, None], dim=0)
            stress = w / st.box.volume * PRESSURE_UNIT_CONVERSION
            if hydrostatic:
                max_stress = torch.abs(torch.trace(stress) / 3.0)
                w = eye * (torch.trace(w) / 3.0)
            else:
                max_stress = torch.max(torch.abs(stress))
            return w / l_scale, max_stress

        def converged(st):
            _, max_stress = box_force(st)
            fmax, smax = torch.stack([_fmax(st), max_stress]).tolist()
            return fmax < force_tolerance and smax < STRESS_TOL

        v = torch.zeros_like(state.velocity)
        vb = torch.zeros((3, 3), dtype=dtype, device=dev)
        steps = 0
        while steps < max_steps and not converged(state):
            f = state.force * state.mask[:, None]
            fb, _ = box_force(state)
            uphill, dt, alpha, n_pos = _fire_schedule(
                torch.sum(v * f) + torch.sum(vb * fb), dt, alpha, n_pos,
                dt_max, dt_min)
            v = torch.where(uphill, torch.zeros_like(v), v)
            vb = torch.where(uphill, torch.zeros_like(vb), vb)
            # implicit Euler + velocity mixing on the extended vector
            f_mod = torch.sqrt(torch.sum(f * f) + torch.sum(fb * fb))
            v = v + (dt / FIRE_MASS) * f
            vb = vb + (dt / FIRE_MASS) * fb
            v_mod = torch.sqrt(torch.sum(v * v) + torch.sum(vb * vb))
            mix = alpha * v_mod / torch.clamp(f_mod, min=1e-30)
            v = (1.0 - alpha) * v + mix * f
            vb = (1.0 - alpha) * vb + mix * fb
            d_eps = vb * dt / l_scale
            h = state.box.h
            pos = state.position + dt * v + state.position @ d_eps.T
            state = ff.compute(state._replace(
                position=pos, box=state.box.with_h(h + d_eps @ h)))
            steps += 1
    return state, steps
