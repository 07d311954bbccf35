"""The port's NPT and BDP ensembles vs the JAX package, f64 on the CPU.

`Box.with_h`; one NPTBerendsen / NPTSCR / NVTBDP step2 on a random state
(compensated, isotropic or not); and short trajectories of the default
rung (DenseNEPMD, compact candidate lists) of 512 PbTe atoms with the
trained NEP4 Te/Pb model (artifacts/trainer_parity_r5_nep.txt) under each
ensemble, held against the JAX list path (`ForceField`, which the JAX
package golden-tests under NPT in tests/test_npt_dense.py).  The two
packages draw different random streams, so the noise is injected: the
port's ensembles take a generator that returns fixed draws, and the JAX
side gets the same draws through a monkeypatched `jax.random.normal` and
`jax.random.gamma` (no JAX file is edited).  A statistical test holds the
port's BDP to the canonical kinetic-energy distribution, and a crushed box
must set the sticky overflow flag (tests/test_npt_dense.py:100).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.forcefield import ForceField
from gpumd_tpu.integrate.ensembles import npt as jnpt
from gpumd_tpu.integrate.ensembles.nvt import NVTBDP as JBDP
from gpumd_tpu.integrate.run import make_md_step, md_run
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.integrate.ensembles.npt import NPTSCR, NPTBerendsen
from gpumd_tpu_torch.integrate.ensembles.nvt import NVTBDP
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import NepModel, random_params
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

MODEL = str(Path(__file__).resolve().parent.parent / "artifacts"
            / "trainer_parity_r5_nep.txt")
DT = 1.0 / TIME_UNIT_CONVERSION
STEPS = 10
# moderate coupling: the box moves by ~1e-4 a step, and stays far from the
# grid's rc + skin margin
BARO = dict(t0=300.0, target_pressure=(1.0, 1.0, 1.0),
            elastic_modulus=(40.0, 40.0, 40.0), tau_p=100.0, coupling=20.0)
BARO_ISO = dict(BARO, elastic_modulus=(40.0, 40.0, 3.0e3), isotropic=True)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


class FixedDraws:
    """A generator stand-in: returns the given draws in order, whatever
    it is asked for (standard_normal(size) or gamma(shape))."""

    def __init__(self, draws):
        self.q = [x for d in draws for x in d]

    def standard_normal(self, size=None):
        v = self.q.pop(0)
        return v if size is None else np.reshape(v, size)

    def gamma(self, shape):
        return self.q.pop(0)


def _draws(n_steps, ndeg, with_xi, seed=11):
    """Per step: a normal, a Gamma((ndeg - 1) / 2) and, for SCR, xi(3)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        d = [float(rng.standard_normal()), float(rng.gamma(0.5 * (ndeg - 1)))]
        if with_xi:
            d.append(rng.standard_normal(3))
        out.append(d)
    return out


@pytest.fixture
def jax_draws(monkeypatch):
    """Point jax.random.normal/gamma at a list the caller fills."""
    holder = []

    def normal(key, shape=(), dtype=float):
        return jnp.reshape(jnp.asarray(holder.pop(0)), shape).astype(dtype)

    def gamma(key, a, shape=None, dtype=float):
        return jnp.asarray(holder.pop(0)).astype(dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "gamma", gamma)
    return holder


def test_box_with_h():
    h0 = np.array([[20.0, 1.5, -0.7], [0.0, 18.0, 2.1], [0.3, 0.0, 22.0]])
    h1 = h0 * np.array([1.01, 0.98, 1.002])[None, :]
    box = Box.from_lattice(h0.T, pbc=(True, True, False), device="cpu")
    jbox = JBox.from_lattice(jnp.asarray(h0.T), pbc=(True, True, False))
    new, jnew = box.with_h(torch.as_tensor(h1)), jbox.with_h(jnp.asarray(h1))
    np.testing.assert_array_equal(_np(new.h), h1)
    np.testing.assert_allclose(_np(new.h_inv), np.asarray(jnew.h_inv),
                               rtol=1e-14, atol=1e-16)
    np.testing.assert_array_equal(_np(new.pbc), _np(box.pbc))
    assert float(new.volume) == pytest.approx(float(jnew.volume), rel=1e-14)
    # a box keeps its dtype and device, whatever h arrives as
    f32 = Box.orthogonal([10.0, 11.0, 12.0], dtype=torch.float32,
                         device="cpu")
    assert f32.with_h(h1).h.dtype == torch.float32


def _random_states(n, compensated, seed=3):
    """The same random state (forces, virials, velocities) in both
    packages."""
    rng = np.random.default_rng(seed)
    lengths = np.array([18.0, 19.0, 21.0])
    pos = rng.uniform(0, 1, (n, 3)) * lengths
    mass = rng.uniform(20.0, 200.0, n)
    vel = rng.normal(size=(n, 3)) * np.sqrt(K_B * 300.0 / mass)[:, None]
    force = rng.normal(size=(n, 3))
    virial = rng.normal(size=(n, 3, 3)) * 0.3
    pos_c = rng.normal(size=(n, 3)) * 1e-9
    out = []
    for mk, bx, conv in ((make_state, Box.orthogonal(lengths, device="cpu"),
                          torch.as_tensor),
                         (jmake_state, JBox.orthogonal(lengths), jnp.asarray)):
        s = mk(pos, mass, np.zeros(n, int), bx, velocity=vel,
               compensated=compensated)
        s = s._replace(force=conv(force), virial=conv(virial),
                       unwrapped_position=conv(pos + 3.0))
        if compensated:
            s = s._replace(position_c=conv(pos_c))
        out.append(s)
    return out


ENS = {"ber": (NPTBerendsen, jnpt.NPTBerendsen),
       "scr": (NPTSCR, jnpt.NPTSCR),
       "bdp": (NVTBDP, JBDP)}


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
@pytest.mark.parametrize("name,iso", [("ber", False), ("ber", True),
                                      ("scr", False), ("scr", True),
                                      ("bdp", False)],
                         ids=["ber", "ber-iso", "scr", "scr-iso", "bdp"])
def test_step2_matches_jax(jax_draws, name, iso, compensated):
    """One step2 on the same state, with the same draws: velocities, box,
    positions (position_c left as it is, as in JAX) to 1e-12 relative."""
    mine_cls, jax_cls = ENS[name]
    kw = BARO_ISO if iso else BARO
    if name == "bdp":
        kw = dict(t0=300.0, coupling=20.0)
    n = 40
    state, jstate = _random_states(n, compensated)
    draws = _draws(1, 3 * n, name == "scr")
    ens = mine_cls(**kw, **({} if name == "ber" else
                            {"generator": FixedDraws(draws)}))
    jens = jax_cls(**kw)
    out, aux = ens.step2(state, ens.init(state), DT)
    if name != "ber":
        jax_draws[:] = draws[0]
    jout, jaux = jens.step2(jstate, jens.init(jstate), DT)
    assert jax_draws == [] and aux["i"] == 1
    for k in ("velocity", "position", "unwrapped_position", "position_c"):
        a, b = getattr(out, k), getattr(jout, k)
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-15)
    np.testing.assert_allclose(_np(out.box.h), np.asarray(jout.box.h),
                               rtol=1e-13)
    np.testing.assert_allclose(_np(out.box.h_inv), np.asarray(jout.box.h_inv),
                               rtol=1e-13)
    if name != "bdp":
        assert abs(float(out.box.h[0, 0]) - 18.0) > 1e-7
    if compensated:
        np.testing.assert_array_equal(_np(out.position_c),
                                      _np(state.position_c))


def _pbte(nc=4, jitter=0.1, seed=1, a0=6.57):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + np.random.default_rng(seed).normal(0, jitter, pos.shape)
    types = np.tile([1, 1, 1, 1, 0, 0, 0, 0], len(cells))
    mass = np.where(types == 1, 207.2, 127.6)
    vel = np.random.default_rng(5).normal(size=pos.shape) * np.sqrt(
        K_B * 300.0 / mass)[:, None]
    vel -= (mass[:, None] * vel).sum(0) / mass.sum()
    return pos, types, mass, vel, np.full(3, nc * a0)


@pytest.fixture(scope="module")
def pbte():
    pos, types, mass, vel, lengths = _pbte()
    n = len(pos)
    jbox = JBox.orthogonal(lengths)
    ff = ForceField.create([JNEP.from_file(MODEL, dtype=jnp.float64)], jbox,
                           n, mn=128, skin=1.0)
    jstate = ff.compute(jmake_state(pos, mass, types, jbox, velocity=vel))
    nep = NEP.from_file(MODEL, dtype=torch.float64, device="cpu")
    return dict(pos=pos, types=types, mass=mass, vel=vel, lengths=lengths,
                n=n, ff=ff, jstate=jstate, nep=nep)


def _port_run(pbte, ens):
    box = Box.orthogonal(pbte["lengths"], device="cpu")
    md = DenseNEPMD(pbte["nep"], box, pbte["n"], position=pbte["pos"],
                    skin=0.5)
    assert md.engine == "compact" and md.cplan.cl > 0
    state = make_state(pbte["pos"], pbte["mass"], pbte["types"], box,
                       velocity=pbte["vel"])
    carry, aux = md.run(state, ens, DT, STEPS)
    assert not bool(carry.overflow) and aux["i"] == STEPS
    return md.to_input_order(carry, pbte["n"])


def _jax_run_with_draws(pbte, jens, draws, holder):
    """JAX list-path steps, one jitted call a step, each step's draws
    handed in as arguments (the patched random functions return them)."""
    ff = pbte["ff"]
    step = make_md_step(ff, jens, DT, observer=lambda s: 0)

    @jax.jit
    def one(carry, d):
        holder[:] = list(d)
        carry, _ = step(carry, None)
        return carry

    st = pbte["jstate"]
    carry = (st, jens.init(st), ff.refresh_cache(st))
    for d in draws:
        carry = one(carry, tuple(jnp.asarray(x) for x in d))
    return carry[0]


def _compare(final, jfinal, box):
    """f64 force differences of ~1e-14 grow little over 10 fs: positions
    to 1e-8 A, velocities to 1e-9, the box to 1e-10 relative."""
    np.testing.assert_allclose(_np(final.box.h), np.asarray(jfinal.box.h),
                               rtol=1e-10)
    assert abs(float(final.box.h[0, 0]) - float(box[0])) > 1e-5
    dpos = final.box.minimum_image(final.position - torch.as_tensor(
        np.array(jfinal.position)))
    assert float(dpos.abs().max()) < 1e-8
    np.testing.assert_allclose(_np(final.velocity),
                               np.asarray(jfinal.velocity), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(_np(final.potential_energy),
                               np.asarray(jfinal.potential_energy),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("iso", [False, True], ids=["aniso", "iso"])
def test_npt_berendsen_trajectory_matches_jax(pbte, iso):
    kw = BARO_ISO if iso else BARO
    final = _port_run(pbte, NPTBerendsen(**kw))
    jfinal, _, _ = md_run(pbte["jstate"], pbte["ff"], jnpt.NPTBerendsen(**kw),
                          DT, STEPS)
    _compare(final, jfinal, pbte["lengths"])


@pytest.mark.parametrize("name", ["scr", "bdp"])
def test_stochastic_trajectory_matches_jax(pbte, jax_draws, name):
    """NPTSCR and NVTBDP with injected noise."""
    mine_cls, jax_cls = ENS[name]
    kw = BARO if name == "scr" else dict(t0=300.0, coupling=20.0)
    draws = _draws(STEPS, 3 * pbte["n"], name == "scr")
    final = _port_run(pbte, mine_cls(**kw, generator=FixedDraws(draws)))
    jfinal = _jax_run_with_draws(pbte, jax_cls(**kw), draws, jax_draws)
    if name == "scr":
        _compare(final, jfinal, pbte["lengths"])
    else:
        assert _np(final.box.h)[0, 0] == pbte["lengths"][0]
        np.testing.assert_allclose(_np(final.velocity),
                                   np.asarray(jfinal.velocity), rtol=0,
                                   atol=1e-9)


def test_bdp_samples_the_canonical_kinetic_energy():
    """With no forces BDP resamples the kinetic energy every step; over
    many steps its mean is ndeg kT / 2 and its variance ndeg (kT)^2 / 2
    (Gamma(ndeg / 2, kT)).  20,000 steps at coupling 1 (correlation
    exp(-1)) hold the mean to ~0.3% and the variance to ~2% (one standard
    error); the bounds are ten of those."""
    n, t0 = 10, 300.0
    rng = np.random.default_rng(0)
    mass = rng.uniform(20.0, 200.0, n)
    box = Box.orthogonal([30.0] * 3, device="cpu")
    state = make_state(rng.uniform(0, 30, (n, 3)), mass, np.zeros(n, int),
                       box, velocity=rng.normal(size=(n, 3)) * 0.01)
    ens = NVTBDP(t0=t0, coupling=1.0, seed=4)
    aux = ens.init(state)
    ke = np.empty(20000)
    for i in range(len(ke)):
        state, aux = ens.step2(state, aux, DT)
        ke[i] = float(state.kinetic_energy())
    ndeg, kt = 3 * n, K_B * t0
    ke = ke[100:]
    assert ke.mean() == pytest.approx(0.5 * ndeg * kt, rel=0.03)
    assert ke.var() == pytest.approx(0.5 * ndeg * kt * kt, rel=0.2)


def test_npt_shrink_below_margin_flags_overflow():
    """A box crushed past the grid's rc+skin cell margin must set the
    sticky overflow flag (the JAX package's
    test_npt_shrink_below_margin_flags_overflow, on the port)."""
    model = NepModel(
        version=4, model_type=0, num_types=2, symbols=("Te", "Pb"),
        atomic_numbers=(52, 82), rc_radial=(8.0, 8.0), rc_angular=(4.0, 4.0),
        mn_radial=96, mn_angular=24, n_max_radial=2, n_max_angular=2,
        basis_size_radial=2, basis_size_angular=2, l_max=2,
        has_q=(0,) * 6, neurons=10)
    nep = NEP(model=model, params=random_params(model, seed=7,
                                                dtype=torch.float64,
                                                device="cpu"))
    n, length = 256, 28.0
    rng = np.random.default_rng(9)
    nx = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(nx)] * 3, indexing="ij"), -1)
    pos = grid.reshape(-1, 3)[:n] * (length / nx)
    pos += rng.uniform(-0.3, 0.3, pos.shape)
    types = rng.integers(0, 2, n)
    box = Box.orthogonal([length] * 3, device="cpu")
    state = make_state(pos, np.where(types == 1, 207.2, 127.6), types, box)
    # full windows: the compact-list estimate (estimate_cl, in both
    # packages) misses the third image of a window as wide as this box,
    # and its count check would flag the first rebuild already
    md = DenseNEPMD(nep, box, n, position=pos, skin=1.0,
                    compact_lists=False)

    class Crusher:
        """A deterministic 1%/step box shrink (a barostat stand-in)."""

        def init(self, state):
            return ()

        def step1(self, state, aux, dt):
            return state, aux

        def step2(self, state, aux, dt):
            return state._replace(position=state.position * 0.99,
                                  box=state.box.with_h(state.box.h * 0.99)
                                  ), aux

    # cells start at 28/3 = 9.33 A; rc+skin = 9 A.  The affine criterion
    # keeps the (still valid) list until smin*rc_out < rc at ~12 steps;
    # the forced rebuild then fails _cells_valid
    carry, _ = md.run(state, Crusher(), DT, 10)
    assert not bool(carry.overflow)
    carry, _ = md.run(state, Crusher(), DT, 20)
    assert bool(carry.overflow)
