"""The port's LSQT (gpumd_tpu_torch/measure/lsqt.py) against the JAX
package's on the CPU in float64, on a periodic graphene sheet of 96 atoms
with the pi-orbital and the sp3 models: H applied to a state, the KPM
moments, the Chebyshev summation and the Bessel evolution within 1e-9 of
JAX's, and the three output rows over three samples (positions moved
between them, so sigma's evolution runs) within 1e-9 of each row's
largest magnitude.  On 216-atom diamond at the sp3 cutoff, JAX's list
keeps 10 of 16 neighbours and its H is not symmetric; the port keeps all
16 and its H is (ROADMAP queue 3)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.measure.lsqt import LSQT as JLSQT
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.box import num_replicas_for_cutoff as jreps
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.neighbor.neighbor import neighbor_brute as jbrute
from gpumd_tpu_torch.measure.lsqt import LSQT, neighbor_rows
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

DT = 1.0 / TIME_UNIT_CONVERSION
REL = 1e-9
# compute_lsqt x Nm Ne E_start E_end E_max, the pi and the sp3 model
ARGS = {"graphene": ("x", 64, 51, -8.0, 8.0, 9.0, 2.1),
        "sp3": ("x", 96, 61, -20.0, 20.0, 25.0, 2.6)}


def graphene(nx=6, ny=4, seed=None):
    """Periodic graphene (armchair cell, 1.42 A bonds), vacuum along z:
    (positions, lattice rows, pbc)."""
    a = 1.42
    cell = np.array([[0, 0, 0], [a, 0, 0], [1.5 * a, np.sqrt(3) / 2 * a, 0],
                     [2.5 * a, np.sqrt(3) / 2 * a, 0]])
    lx, ly = 3 * a, np.sqrt(3) * a
    pos = np.concatenate([cell + np.array([i * lx, j * ly, 0.0])
                          for i in range(nx) for j in range(ny)])
    if seed is not None:
        pos = pos + np.random.default_rng(seed).normal(0, 0.03, pos.shape)
    return pos, np.diag([nx * lx, ny * ly, 10.0]), (True, True, False)


def states(pos, lattice, pbc):
    n = len(pos)
    js = jmake_state(pos, np.full(n, 12.011), np.zeros(n, int),
                     JBox.from_lattice(lattice, pbc=pbc))
    ts = make_state(pos, np.full(n, 12.011), np.zeros(n, int),
                    Box.from_lattice(lattice, pbc=pbc, device="cpu"))
    return js, ts


def pair(model):
    d, nm, ne, e0, e1, em, rc = ARGS[model]
    return (JLSQT(d, nm, ne, e0, e1, em, DT, rc=rc, model=model),
            LSQT(d, nm, ne, e0, e1, em, DT, rc=rc, model=model))


def random_state(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n) + 1j * rng.normal(size=n)


def close(got, want, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


@pytest.mark.parametrize("model", ["graphene", "sp3"])
def test_operators_and_series_match_jax(model):
    jl, tl = pair(model)
    js, ts = states(*graphene(seed=2))
    jh, th = jl._build_h(js), tl._build_h(ts)
    n = th[0].shape[0]
    a, b = random_state(n, 1), random_state(n, 2)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ju, jhop, jxx, jidx = jh
    tu, thop, txx, tidx = th
    close(tl._h_apply(ta, tu, thop, tidx, 1.0 / tl.em),
          jl._h_apply(ja, ju, jhop, jidx, 1.0 / jl.em))
    close(tl._j_apply(ta, thop, txx, tidx), jl._j_apply(ja, jhop, jxx, jidx))
    jmom = jax.jit(lambda x, y: jl._moments(x, y, ju, jhop, jidx))(ja, jb)
    close(tl._moments(ta, tb, tu, thop, tidx), jmom)
    close(tl._summation(torch.as_tensor(np.array(jmom))),
          jl._summation(jmom))
    close(tl._evolve(ta, tu, thop, tidx, -1.0),
          jax.jit(lambda x: jl._evolve(x, ju, jhop, jidx, -1.0))(ja))


@pytest.mark.parametrize("model", ["graphene", "sp3"])
def test_output_rows_match_jax_over_three_samples(tmp_path, model):
    jl, tl = pair(model)
    for pkg, lsqt in (("jax", jl), ("torch", tl)):
        d = tmp_path / pkg
        d.mkdir()
        session = types.SimpleNamespace(workdir=str(d))
        for k in range(3):
            js, ts = states(*graphene(seed=10 + k))
            st = js if pkg == "jax" else ts
            lsqt.sample_state(session, st, k + 1)
    for name in ("lsqt_dos.out", "lsqt_velocity.out", "lsqt_sigma.out"):
        want = np.loadtxt(tmp_path / "jax" / name)
        got = np.loadtxt(tmp_path / "torch" / name)
        assert got.shape == want.shape == (3, ARGS[model][2])
        assert np.isfinite(got).all()
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= REL * np.abs(w).max(), name


def diamond(nc=3, a0=3.567):
    base = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    base = np.concatenate([base, base + 0.25])
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    return pos, np.diag([nc * a0] * 3), (True, True, True)


def symmetry_gap(apply_h, n, seed=5):
    """|<a|Hb> - <Ha|b>| over |<a|Hb>| for random states a, b."""
    a, b = random_state(n, seed), random_state(n, seed + 1)
    hb, ha = apply_h(b), apply_h(a)
    return abs(np.vdot(a, hb) - np.vdot(ha, b)) / abs(np.vdot(a, hb))


def test_sp3_on_diamond_keeps_every_neighbour():
    """Queue 3's LSQT item: at rc 2.6 A diamond has 4 + 12 neighbours;
    the JAX list keeps the first 10 of each row (count 16) and its H is
    not symmetric; the port's list holds all 16 and H = H^T.  Its list
    grows past its first build's capacity (28 a row at 3 A)."""
    pos, lattice, pbc = diamond()
    js, ts = states(pos, lattice, pbc)
    n = len(pos)
    jbox = js.box
    jn = jbrute(jnp.asarray(pos), jbox, jnp.ones(n), rc=2.6, mn=10,
                reps=jreps(jbox, 2.6))
    assert int(jnp.max(jn.count)) == 16 and jn.idx.shape[1] == 10
    idx, r12, mask = neighbor_rows(ts.position, ts.box, 2.6)
    assert idx.shape[1] == 16 and bool((mask.sum(1) == 16).all())
    # past the first build's capacity: the third shell, 28 a row
    mask3 = neighbor_rows(ts.position, ts.box, 3.0)[2]
    assert mask3.shape[1] == 28 and bool((mask3.sum(1) == 28).all())
    jl, tl = pair("sp3")
    u, hop, xx, tidx = tl._build_h(ts)
    gap = symmetry_gap(lambda s: tl._h_apply(
        torch.as_tensor(s), u, hop, tidx, 1.0).numpy(), 4 * n)
    assert gap <= 1e-12, gap
    ju, jhop, jxx, jidx = jl._build_h(js)
    jgap = symmetry_gap(lambda s: np.asarray(jl._h_apply(
        jnp.asarray(s), ju, jhop, jidx, 1.0)), 4 * n)
    assert jgap > 1e-3, jgap  # the JAX package's truncated rows
