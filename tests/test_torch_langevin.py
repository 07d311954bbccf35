"""The port's NVTLangevin and NVTBAOAB against the JAX package's, f64 on
the CPU: step1 and step2 on a random state (forces fixed, as the force
pass between them would leave them), with and without a `mobile` mask,
for three steps and under the T0 -> T1 ramp, with JAX's own draws
injected into the port (the streams differ).  Positions, velocities and
unwrapped positions to 1e-6 (they agree to rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.integrate.ensembles import nvt as jnvt
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu_torch.integrate.ensembles import nvt as tnvt
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION
from torch_jax_draws import jax_half_kick_draws, popping_draw
from torch_one_thread import one_torch_thread  # noqa: F401

N = 40
DT = 2.0 / TIME_UNIT_CONVERSION
TOL = 1e-6


def _states(mobile):
    rng = np.random.default_rng(7)
    lengths = np.array([14.0, 15.0, 16.0])
    pos = rng.uniform(0, 1, (N, 3)) * lengths
    mass = rng.uniform(20.0, 200.0, N)
    vel = rng.normal(size=(N, 3)) * np.sqrt(K_B * 300.0 / mass)[:, None]
    force = rng.normal(size=(N, 3))
    mob = (rng.uniform(size=N) > 0.3).astype(float) if mobile else None
    j = jmake_state(pos, mass, np.zeros(N, int), JBox.orthogonal(lengths),
                    velocity=vel, track_unwrapped=True)
    j = j._replace(force=jnp.asarray(force))
    t = make_state(pos, mass, np.zeros(N, int),
                   Box.orthogonal(lengths, device="cpu"), velocity=vel)
    t = t._replace(force=torch.as_tensor(force),
                   unwrapped_position=t.position.clone())
    return j, t, mob


def _check(t, j, what):
    for name in ("position", "velocity", "unwrapped_position"):
        got = getattr(t, name).numpy()
        want = np.asarray(getattr(j, name))
        assert np.abs(got - want).max() <= TOL, (what, name)


@pytest.mark.parametrize("mobile", [False, True], ids=["free", "mobile"])
@pytest.mark.parametrize("name, draws_a_step",
                         [("NVTLangevin", 2), ("NVTBAOAB", 1)])
def test_steps_match_jax(name, draws_a_step, mobile):
    steps = 3
    j, t, mob = _states(mobile)
    kw = dict(t0=250.0, t1=250.0, coupling=20.0)
    jens = getattr(jnvt, name)(
        **kw, mobile=None if mob is None else jnp.asarray(mob))
    draw = popping_draw(jax_half_kick_draws(draws_a_step * steps, (N, 3)))
    tens = getattr(tnvt, name)(
        **kw, mobile=None if mob is None else torch.as_tensor(mob),
        draw=draw)
    jaux, taux = jens.init(j), tens.init(t)
    for k in range(steps):
        j, jaux = jens.step1(j, jaux, DT)
        t, taux = tens.step1(t, taux, DT)
        _check(t, j, f"step1 {k}")
        j, jaux = jens.step2(j, jaux, DT)
        t, taux = tens.step2(t, taux, DT)
        _check(t, j, f"step2 {k}")
    assert not draw.queue and taux["i"] == int(jaux["i"]) == steps
    if mob is not None:
        frozen = mob == 0
        assert np.abs(t.velocity.numpy()[frozen]).max() == 0.0
    elif name == "NVTLangevin":
        # the kicks' net momentum is removed
        p = (t.mass[:, None] * t.velocity).sum(0)
        assert float(p.abs().max()) < 1e-12


@pytest.mark.parametrize("name, draws_a_step",
                         [("NVTLangevin", 2), ("NVTBAOAB", 1)])
def test_ramp_matches_jax(name, draws_a_step):
    """T0 -> T1 over n_steps: the targets the steps use (JAX rounds the
    ramp fraction to float32, and so does the port) and the states."""
    steps = 5
    j, t, _ = _states(False)
    kw = dict(t0=20.0, t1=80.0, coupling=10.0, n_steps=steps)
    jens = getattr(jnvt, name)(**kw)
    tens = getattr(tnvt, name)(**kw, draw=popping_draw(
        jax_half_kick_draws(draws_a_step * steps, (N, 3))))
    jaux, taux = jens.init(j), tens.init(t)
    temps = []
    for _ in range(steps):
        temps.append((tens._temp(taux), float(jens._temp(jaux))))
        j, jaux = jens.step1(j, jaux, DT)
        t, taux = tens.step1(t, taux, DT)
        j, jaux = jens.step2(j, jaux, DT)
        t, taux = tens.step2(t, taux, DT)
    _check(t, j, "ramp")
    got, want = np.array(temps).T
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert want[0] == 20.0 and 60.0 < want[-1] < 80.0
