"""Shared harness of the ensemble parity tests (tests/test_torch_heat.py,
test_torch_mttk.py, test_torch_shock.py, test_torch_qtb_ttm.py,
test_torch_ti.py): the same LJ argon state in both packages in float64,
each package's ensemble class driven step by step around its own force
pass (the JAX halves and force pass through jax.jit, the force pass
compiled once a process), and JAX's random draws recomputed from its key
sequences for injection into the port's `draw`/`generator` hooks (the two
packages draw different streams)."""

import functools
from pathlib import Path

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.forcefield import ForceField as JFF
from gpumd_tpu.io.xyz import XYZFrame, write_xyz
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.lj import LJ as JLJ
from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.lj import LJ
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION

A0 = 5.26
MASS = 39.948
LJ_PARAMS = (1.032e-2, 3.405, 9.0)  # the repo's lj.txt
DT = 2.0 / TIME_UNIT_CONVERSION
STEPS = 20
CELLS = (4, 2, 2)  # 64 atoms, four one-cell slabs along x
F64 = jnp.float64


def argon(cells=CELLS, seed=5, temperature=60.0, jitter=0.03):
    """fcc argon, jittered, with Maxwell velocities (natural units, no net
    momentum): (positions, velocities, box lengths, slab index along x
    with one slab a cell)."""
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    grid = np.array([[i, j, k] for i in range(cells[0])
                     for j in range(cells[1]) for k in range(cells[2])])
    pos = (grid[:, None, :] + base[None]).reshape(-1, 3) * A0
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0.0, jitter, pos.shape)
    vel = rng.normal(0.0, np.sqrt(K_B * temperature / MASS), pos.shape)
    vel -= vel.mean(axis=0)
    lengths = np.asarray(cells, float) * A0
    slab = np.minimum((pos[:, 0] / A0).astype(int), cells[0] - 1)
    return pos, vel, lengths, slab


def write_slabs(d: Path, cells=CELLS, **kw):
    """argon()'s start as model.xyz with velocities and the slabs as
    grouping method 0, and the repo's LJ line as lj.txt, in d."""
    d.mkdir(parents=True, exist_ok=True)
    pos, vel, lengths, slab = argon(cells, **kw)
    n = len(pos)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar"] * n, positions=pos, lattice=np.diag(lengths),
        pbc=(True, True, True), velocities=vel / TIME_UNIT_CONVERSION,
        masses=np.full(n, MASS), groups=slab[:, None]),
        with_velocities=True, with_groups=True)
    (d / "lj.txt").write_text("lj 1 Ar\n{} {} {}\n".format(*LJ_PARAMS))


def deck_pair(tmp: Path, deck: str, patches=(), make=write_slabs):
    """The same run.in through the JAX app (float64) and the port's
    (float64 on the CPU; `patches` (attribute, value) apply to the port's
    app module): (directories, JAX session, port session)."""
    import gpumd_tpu_torch.app.gpumd as tapp
    from gpumd_tpu.app import gpumd as japp

    dirs = {}
    for pkg in ("jax", "torch"):
        d = tmp / pkg
        make(d)
        (d / "run.in").write_text(deck)
        dirs[pkg] = d
    js = japp.Session(str(dirs["jax"]), quiet=True)
    js.execute()
    with pytest.MonkeyPatch.context() as mp:
        for attr, value in patches:
            mp.setattr(tapp, attr, value)
        ts = tapp.Session(str(dirs["torch"]), quiet=True, device="cpu",
                          dtype=torch.float64)
        ts.execute()
    return dirs, js, ts


def rows_close(path_got, path_want, tol, shape=None):
    """Two numeric output files, row for row (a .csv's header line equal):
    the largest difference over each column's largest magnitude within
    tol."""
    csv = str(path_want).endswith(".csv")
    if csv:
        assert (Path(path_got).read_text().splitlines()[0]
                == Path(path_want).read_text().splitlines()[0])
    got, want = (np.atleast_2d(np.loadtxt(p, comments="#",
                                          delimiter="," if csv else None,
                                          skiprows=int(csv)))
                 for p in (path_got, path_want))
    assert got.shape == want.shape, (got.shape, want.shape)
    if shape is not None:
        assert got.shape == shape, (got.shape, shape)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    err = (np.abs(got - want).max(axis=0) / scale).max()
    assert err <= tol, (str(path_got), err)
    return got


@functools.lru_cache(maxsize=None)
def _jax_compute(cells):
    """The JAX force pass for `cells`, jitted once a process."""
    lengths = np.asarray(cells, float) * A0
    n = 4 * int(np.prod(cells))
    ff = JFF.create([JLJ.from_params(*LJ_PARAMS)], JBox.orthogonal(lengths),
                    n, mn=160)
    return jax.jit(ff.compute)


def states(cells=CELLS, **kw):
    """(JAX state, port state, JAX force pass, port ForceField), forces of
    the start computed in each package."""
    pos, vel, lengths, _ = argon(cells, **kw)
    n = len(pos)
    js = jmake_state(pos, np.full(n, MASS), np.zeros(n, int),
                     JBox.orthogonal(lengths), velocity=vel)
    js = js._replace(unwrapped_position=js.position)
    ts = make_state(pos, np.full(n, MASS), np.zeros(n, int),
                    Box.orthogonal(lengths, device="cpu"), velocity=vel)
    ts = ts._replace(unwrapped_position=ts.position.clone())
    ff = ForceField.create([LJ.from_params(*LJ_PARAMS, device="cpu")],
                           ts.box, n, mn=160)
    jcompute = _jax_compute(tuple(cells))
    with torch.no_grad():
        ts = ff.compute(ts)
    return jcompute(js), ts, jcompute, ff


def run_jax(ens, state, jcompute, n=STEPS, dt=DT, observe=None, jit=True):
    """n steps of the JAX class, its halves jitted (or op by op, where
    that is cheaper than the compile): (state, aux, observations)."""
    aux = ens.init(state)

    def s1(s, a):
        return ens.step1(s, a, dt)

    def s2(s, a):
        return ens.step2(s, a, dt)

    if jit:
        s1, s2 = jax.jit(s1), jax.jit(s2)
    obs = []
    for _ in range(n):
        state, aux = s1(state, aux)
        state, aux = s2(jcompute(state), aux)
        if observe is not None:
            obs.append(observe(state, aux))
    return state, aux, obs


def run_torch(ens, state, ff, n=STEPS, dt=DT, observe=None):
    """n steps of the port's class: (state, aux, observations)."""
    obs = []
    with torch.no_grad():
        aux = ens.init(state)
        for _ in range(n):
            state, aux = ens.step1(state, aux, dt)
            state, aux = ens.step2(ff.compute(state), aux, dt)
            if observe is not None:
                obs.append(observe(state, aux))
    return state, aux, obs


def np64(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def assert_states(ts, js, atol=1e-9, what="", box_atol=1e-12):
    """Positions (under the minimum image: one run's force pass may wrap
    an atom the other's does not), velocities and the box of two runs'
    states."""
    dx = ts.box.minimum_image(torch.as_tensor(
        np64(ts.position) - np64(js.position), dtype=ts.position.dtype))
    err = float(dx.abs().max())
    assert err <= atol, (what, "position", err)
    got, want = np64(ts.velocity), np64(js.velocity)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= atol, (what, "velocity", err)
    np.testing.assert_allclose(np64(ts.box.h), np64(js.box.h), rtol=1e-12,
                               atol=box_atol, err_msg=what)


# ---- JAX's draws, from its key sequences --------------------------------


def normals(n_draws, shape, seed, per_split=1):
    """`key, sub = split(key)` a draw from PRNGKey(seed), then
    `per_split` (N, 3) normals from sub: one (NVTLangevin, TI, the hybrid's
    Langevin baths) or two from split(sub) (HeatLangevin's source and
    sink)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_draws):
        key, sub = jax.random.split(key)
        keys = [sub] if per_split == 1 else list(jax.random.split(sub))
        out += [np.asarray(jax.random.normal(k, shape, F64)) for k in keys]
    return out


def bdp_pairs(n_steps, dns, seed=12345):
    """HeatBDP's draws a step: split(key, 3), then for each bath a normal
    and a Gamma((dN - 1) / 2) from split(k)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_steps):
        key, *subs = jax.random.split(key, 3)
        for k, dn in zip(subs, dns):
            k1, k2 = jax.random.split(k)
            out.append(float(jax.random.normal(k1, (), F64)))
            out.append(float(jax.random.gamma(k2, 0.5 * (dn - 1.0),
                                              dtype=F64)))
    return out


def qtb_draws(n_refresh, n, n_f, seed=615461):
    """NVTQTB's history at init, then an (N, 1, 3) column a refresh."""
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    out = [np.asarray(jax.random.normal(sub, (n, 2 * n_f, 3), F64))]
    for _ in range(n_refresh):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (n, 1, 3), F64)))
    return out


def uniforms(n_draws, shape, seed=777):
    """TTM's u a step: `key, sub = split(key)`, uniform(sub)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_draws):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, shape, F64)))
    return out


def popping(arrays):
    """draw(shape, dtype, device) handing out `arrays` in order."""
    queue = list(arrays)

    def draw(shape, dtype, device):
        a = queue.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    draw.queue = queue
    return draw


class Numbers:
    """A numpy-generator stand-in handing out `values` in order for
    standard_normal() and gamma(shape)."""

    def __init__(self, values):
        self.queue = list(values)

    def standard_normal(self, size=None):
        return self.queue.pop(0)

    def gamma(self, shape):
        return self.queue.pop(0)


def fields_match(got, want):
    """Each field of the JAX dataclass `want` equals the port's (nested
    dataclasses field by field; masks by value); the port's own fields
    are only its noise hooks."""
    if isinstance(want, tuple) and len(want) and not isinstance(
            want[0], (int, float, bool, str, tuple)):  # a tuple of masks
        return len(got) == len(want) and all(
            fields_match(g, w) for g, w in zip(got, want))
    if not dataclasses.is_dataclass(want):
        if hasattr(want, "shape") or torch.is_tensor(got):
            return np.array_equal(np64(got), np64(want))
        return got == want
    names = {f.name for f in dataclasses.fields(want)}
    extra = {f.name for f in dataclasses.fields(got)} - names
    assert extra <= {"draw", "generator"}, extra
    return all(fields_match(getattr(got, k), getattr(want, k))
               for k in names)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """A JAX and a port session on write_slabs' deck, potential and time
    step read: the parsers' test bench."""
    import gpumd_tpu_torch.app.gpumd as tapp
    from gpumd_tpu.app import gpumd as japp

    d = tmp_path_factory.mktemp("parse")
    write_slabs(d)
    js = japp.Session(str(d), quiet=True)
    ts = tapp.Session(str(d), quiet=True, device="cpu", dtype=torch.float64)
    for s in (js, ts):
        s.kw_potential(["lj.txt"])
        s.kw_time_step(["2"])
    return js, ts
