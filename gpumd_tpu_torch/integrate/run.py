"""The MD loop of the general path: ForceField + an ensemble, step by step.

Counterpart of gpumd_tpu/integrate/run.py (ref: src/main_gpumd/run.cu:
252-318).  The JAX package scans one jitted step; here the step is a
Python loop on the card: integrate-1, the force pass (with the Verlet
cache's rebuild test, one host sync a step), drivers, integrate-2 and an
observer.  The observer's outputs are collected a step at a time and
stacked at the end of the block, as the scan stacks them.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional

import torch

from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.integrate.thermo import compute_thermo
from gpumd_tpu_torch.model.state import MDState


def make_md_step(ff: ForceField, ensemble, dt,
                 observer: Optional[Callable] = None, drivers: tuple = ()):
    """step(carry, _) -> (carry, out), carry = (state, ensemble aux,
    neighbour cache).  `observer(state)` or `observer(state, aux)` gives a
    step's output (default: thermo); `drivers` (external forces, .apply)
    act after the force pass, where the reference applies them (ref:
    run.cu:289-293).  The cache rides the carry: lists are rebuilt only
    when the displacement test trips (ff.skin > 0)."""
    obs = observer if observer is not None else (lambda s: compute_thermo(s))
    obs_wants_aux = len(inspect.signature(obs).parameters) >= 2

    def step(carry, _=None):
        state, aux, cache = carry
        state, aux = ensemble.step1(state, aux, dt)
        if ff.skin > 0.0:
            state, cache = ff.compute_cached(state, cache)
        else:
            state = ff.compute(state)
        for drv in drivers:
            state = drv.apply(state)
        state, aux = ensemble.step2(state, aux, dt)
        out = obs(state, aux) if obs_wants_aux else obs(state)
        return (state, aux, cache), out

    return step


def _stack(outs):
    """Stack a list of per-step outputs (tensors, numbers, None, or tuples,
    named tuples and dicts of them) along a new leading axis."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple):
        cols = [_stack(list(c)) for c in zip(*outs)]
        return type(first)(*cols) if hasattr(first, "_fields") else tuple(
            cols)
    if torch.is_tensor(first):
        return torch.stack(outs)
    return torch.as_tensor(outs)


class MDRunner:
    """An MD run block: build once, call many times."""

    def __init__(self, ff: ForceField, ensemble, dt, n_steps: int,
                 observer: Optional[Callable] = None, drivers: tuple = ()):
        self.ensemble = ensemble
        self.ff = ff
        self.n_steps = n_steps
        self._step = make_md_step(ff, ensemble, dt, observer, drivers)

    def __call__(self, state: MDState, aux=None, cache=None):
        """Returns (state, (aux, cache), observations stacked over the
        steps); pass the carry back in to continue a run."""
        with torch.no_grad():
            if aux is None:
                aux = self.ensemble.init(state)
            if cache is None and self.ff.skin > 0.0:
                cache = self.ff.refresh_cache(state)
            carry, outs = (state, aux, cache), []
            for _ in range(self.n_steps):
                carry, out = self._step(carry)
                outs.append(out)
        state, aux, cache = carry
        return state, (aux, cache), (_stack(outs) if outs else None)


def md_run(state: MDState, ff: ForceField, ensemble, dt, n_steps: int,
           observer: Optional[Callable] = None):
    """One block.  The first force evaluation (run.cu:236) is the
    caller's: `state = ff.compute(state)` before the first block."""
    return MDRunner(ff, ensemble, dt, n_steps, observer)(state)
