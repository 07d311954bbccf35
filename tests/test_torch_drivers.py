"""The port's force drivers (gpumd_tpu_torch/integrate/drivers.py) against
the JAX package's, on the CPU.

Each driver's `apply` on the same random f64 state (add_random_force with
JAX's draws injected: JAX keys its noise by fold_in(state.step), the port
draws from one seeded generator), to 1e-12; then the driver decks of the
JAX package's tests/test_drivers.py through both apps, LJ argon 32 atoms
on the list path, the port in float32 against the JAX app in float64:
the final positions within 1e-4 A and velocities within 1e-4 of their
largest magnitude, and the JAX tests' own checks on the port's run.
The decks start from model.xyz's velocities in place of the `velocity`
keyword (the streams differ)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.integrate import drivers as jdrv
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu_torch.integrate import drivers as tdrv
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.units import K_B
from test_torch_app_gpumd import run_pair, write_argon
from torch_jax_draws import jax_random_force_draws, popping_draw
from torch_one_thread import one_torch_thread  # noqa: F401

N = 30


def _states(step=4):
    rng = np.random.default_rng(3)
    lengths = np.array([12.0, 13.0, 14.0])
    pos = rng.uniform(0, 1, (N, 3)) * lengths
    mass = rng.uniform(20.0, 200.0, N)
    types = rng.integers(0, 2, N)
    vel = rng.normal(size=(N, 3)) * np.sqrt(K_B * 2000.0 / mass)[:, None]
    force = rng.normal(size=(N, 3))
    charge = rng.normal(size=N)
    unw = pos + rng.normal(size=(N, 3))
    j = jmake_state(pos, mass, types, JBox.orthogonal(lengths), velocity=vel,
                    charge=charge)
    j = j._replace(force=jnp.asarray(force), unwrapped_position=jnp.asarray(
        unw), step=jnp.asarray(step, jnp.int32))
    t = make_state(pos, mass, types, Box.orthogonal(lengths, device="cpu"),
                   velocity=vel)
    t = t._replace(force=torch.as_tensor(force),
                   charge=torch.as_tensor(charge),
                   unwrapped_position=torch.as_tensor(unw),
                   step=torch.tensor(step, dtype=torch.int32))
    return j, t, rng


def _drivers(rng):
    gmask = (rng.uniform(size=N) > 0.5).astype(float)
    table = rng.normal(size=(3, 3))
    stop = np.abs(rng.normal(size=(2, 5)))
    spring = dict(gmask=gmask, com0=(6.0, 6.5, 7.0), velocity=(0.01, 0, 0),
                  offset=(0.5, 0.0, -0.5))
    return {
        "add_force": dict(gmask=gmask, table=table),
        "add_efield": dict(gmask=gmask, table=table),
        "electron_stop": dict(table=stop, energy_min=1e-4, energy_max=0.5),
        "add_spring_couple": dict(spring, couple=True, k=2.0, r0=0.3),
        "add_spring_decouple": dict(spring, couple=False, k3=(1.0, 2.0, 0.5)),
    }


CLASSES = {"add_force": "AddForce", "add_efield": "AddEfield",
           "electron_stop": "ElectronStop", "add_spring_couple": "AddSpring",
           "add_spring_decouple": "AddSpring"}


@pytest.mark.parametrize("name", list(CLASSES))
def test_apply_matches_jax(name):
    j, t, rng = _states()
    kw = _drivers(rng)[name]
    got = getattr(tdrv, CLASSES[name])(**kw).apply(t)
    want = getattr(jdrv, CLASSES[name])(**kw).apply(j)
    assert not np.array_equal(np.asarray(want.force), np.asarray(j.force))
    np.testing.assert_allclose(got.force.numpy(), np.asarray(want.force),
                               rtol=1e-12, atol=1e-12)


def test_random_force_matches_jax_with_its_draws():
    steps = (4, 5, 9)
    draw = popping_draw(jax_random_force_draws(steps, (N, 3)))
    mine = tdrv.AddRandomForce(variance=0.3, draw=draw)
    theirs = jdrv.AddRandomForce(variance=0.3)
    for s in steps:
        j, t, _ = _states(step=s)
        got, want = mine.apply(t), theirs.apply(j)
        np.testing.assert_allclose(got.force.numpy(), np.asarray(want.force),
                                   rtol=1e-12, atol=1e-12)
        net = (got.force - t.force).sum(0)
        assert float(net.abs().max()) < 1e-12
    assert not draw.queue


def test_efield_needs_charges_and_bec_is_not_ported():
    """Charge mode needs charges; bec mode (ported with qNEP) needs a
    Born-charge function and, given one, matches the JAX driver's
    F += Z* E on the same tensors."""
    j, t, rng = _states()
    kw = _drivers(rng)["add_efield"]
    with pytest.raises(ValueError, match="charge"):
        tdrv.AddEfield(**kw).apply(t._replace(charge=None))
    with pytest.raises(ValueError, match="qNEP"):
        tdrv.AddEfield(**kw, use_bec=True).apply(t)
    z = rng.normal(size=(N, 3, 3))
    got = tdrv.AddEfield(**kw, use_bec=True,
                         bec_fn=lambda s: torch.as_tensor(z)).apply(t)
    want = jdrv.AddEfield(**kw, use_bec=True,
                          bec_fn=lambda s: jnp.asarray(z)).apply(j)
    np.testing.assert_allclose(got.force.numpy(), np.asarray(want.force),
                               rtol=1e-12, atol=1e-12)


def test_table_file_and_electron_stop_file(tmp_path):
    (tmp_path / "f.txt").write_text("2\n1 2 3\n4 5 6\n")
    (tmp_path / "s.txt").write_text("3 1.0 100.0\n0.2 0.1\n0.2 0.1\n0.3 0.1\n")
    for pkg in (tdrv, jdrv):
        tab = pkg.parse_table_or_values(["f.txt"], str(tmp_path))
        np.testing.assert_array_equal(tab, [[1, 2, 3], [4, 5, 6]])
        es = pkg.ElectronStop.from_file(str(tmp_path / "s.txt"), 2)
        np.testing.assert_array_equal(es.table, [[.2, .2, .3], [.1, .1, .1]])
    with pytest.raises(ValueError):
        tdrv.parse_table_or_values(["1", "2"])


# ---- the JAX package's driver decks (tests/test_drivers.py:30-127) --------

GROUPED = functools.partial(write_argon, cells=(2, 2, 2), temperature=10.0)
DECKS = {
    "add_force": (GROUPED, "potential lj.txt\ntime_step 5\n"
                  "add_force 0 0 0.02 0 0\ndump_restart 40\nrun 40\n"),
    "add_random_force": (GROUPED, "potential lj.txt\ntime_step 5\n"
                         "add_random_force 0.01\nrun 50\n"),
    "electron_stop": (functools.partial(write_argon, cells=(2, 2, 2),
                                        temperature=3000.0),
                      "potential lj.txt\ntime_step 1\n"
                      "electron_stop stop.txt\nrun 200\n"),
    "add_spring": (GROUPED, "potential lj.txt\ntime_step 5\nensemble nve\n"
                   "add_spring ghost_com 0 0 0.02 0 0 couple 1.0 0.0 0 0 0\n"
                   "run 200\n"),
}


def _maker(make, name):
    def build(d):
        make(d)
        (d / "stop.txt").write_text("3 1.0 100.0\n0.2\n0.2\n0.2\n")
        if name != "electron_stop":
            # write_argon's method 0 splits x < a0; the JAX decks drive
            # one group of everything
            text = (d / "model.xyz").read_text().splitlines()
            text[1] = text[1].replace("group:I:2", "group:I:1")
            text[2:] = [" ".join(ln.split()[:-2] + ["0"]) for ln in text[2:]]
            (d / "model.xyz").write_text("\n".join(text) + "\n")
    return build


@pytest.fixture(scope="module")
def driver_decks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drivers")
    out = {}
    for name, (make, deck) in DECKS.items():
        patches = ()
        if name == "add_random_force":
            draw = popping_draw(jax_random_force_draws(range(50), (32, 3)))
            patches = (("AddRandomForce", _random_force_class(draw)),)
        out[name] = run_pair(tmp, name, deck, make=_maker(make, name),
                             patches=patches)
    return out


def _random_force_class(draw):
    """AddRandomForce as the app builds it, with JAX's draws."""
    import gpumd_tpu_torch.integrate.drivers as drivers_mod

    class Injected(drivers_mod.AddRandomForce):
        def __init__(self, variance, **kw):
            super().__init__(variance=variance, draw=draw, **kw)

    return Injected


@pytest.mark.parametrize("name", list(DECKS))
def test_driver_deck_matches_jax(driver_decks, name):
    dirs, js, ts = driver_decks[name]
    n = 32
    assert ts.global_step == js.global_step
    assert "CPU device" in ts.route_reason
    pos_t, pos_j = ts.state.position.numpy()[:n], np.asarray(
        js.state.position)[:n]
    lengths = np.diag(np.asarray(js.state.box.h))
    d = pos_t - pos_j
    d -= np.round(d / lengths) * lengths
    assert np.abs(d).max() <= 1e-4, np.abs(d).max()
    vt, vj = ts.state.velocity.numpy()[:n], np.asarray(js.state.velocity)[:n]
    assert np.abs(vt - vj).max() <= 1e-4 * np.abs(vj).max()
    # the JAX tests' own checks, on the port's run
    m = ts.state.mass.numpy()[:n]
    if name == "add_force":
        assert vt[:, 0].mean() > 0.0 and abs(vt[:, 1].mean()) < 1e-6
    elif name == "add_random_force":
        assert np.abs((m[:, None] * vt).sum(0)).max() < 1e-4
    elif name == "electron_stop":
        assert float(ts.state.temperature()) < 2500.0
    else:
        x0 = np.asarray(ts.frame.positions)[:, 0]
        x1 = ts.state.unwrapped_position.numpy()[:n, 0]
        assert (x1 - x0).mean() > 1.0


def test_efield_deck_needs_charge(tmp_path):
    make = _maker(GROUPED, "add_efield")
    make(tmp_path)
    (tmp_path / "run.in").write_text(
        "potential lj.txt\ntime_step 5\nadd_efield 0 0 0.1 0 0 charge\n"
        "run 10\n")
    with pytest.raises(ValueError, match="charge"):
        tapp.Session(str(tmp_path), quiet=True, device="cpu").execute()
