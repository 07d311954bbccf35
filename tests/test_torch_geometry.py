"""Port vs JAX package: box, state, binning, ghost/window packing and the
neighbour-index build, on random orthogonal and triclinic boxes (f64).

The same numpy inputs go through gpumd_tpu and gpumd_tpu_torch.  Packing
is pure data movement plus the exact lattice shift, so those compare to
1e-12 absolute; integer outputs (perm, idx) must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.engine import grid as JG
from gpumd_tpu.engine import nep_compact as JC
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.model.box import Box as TBox
from gpumd_tpu_torch.model.state import make_state as tmake_state

LATTICES = {
    "orthogonal": np.diag([27.5, 28.5, 30.0]),
    "triclinic": np.array([[27.0, 0.0, 0.0], [3.0, 28.0, 0.0],
                           [2.0, -1.5, 29.0]]),
}


def _boxes(name, pbc=(True, True, True)):
    lat = LATTICES[name]
    return (JBox.from_lattice(jnp.asarray(lat), pbc=pbc),
            TBox.from_lattice(lat, pbc=pbc))


def _positions(rng, n, lat):
    s = rng.uniform(-0.2, 1.2, (n, 3))  # some atoms outside the cell
    return s @ lat


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("name", list(LATTICES))
def test_box_ops(name):
    rng = np.random.default_rng(1)
    jb, tb = _boxes(name, pbc=(True, True, False))
    pos = _positions(rng, 64, LATTICES[name])
    r12 = rng.normal(0, 20.0, (64, 3))
    tp, tr = torch.as_tensor(pos), torch.as_tensor(r12)
    pairs = [
        (jb.h_inv, tb.h_inv), (jb.volume, tb.volume),
        (jb.thickness(), tb.thickness()),
        (jb.wrap(jnp.asarray(pos)), tb.wrap(tp)),
        (jb.fractional(jnp.asarray(pos)), tb.fractional(tp)),
        (jb.cartesian(jnp.asarray(pos)), tb.cartesian(tp)),
        (jb.minimum_image(jnp.asarray(r12)), tb.minimum_image(tr)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-12, atol=1e-12)


def test_make_state_padding():
    rng = np.random.default_rng(2)
    jb, tb = _boxes("triclinic")
    pos = _positions(rng, 10, LATTICES["triclinic"])
    mass = rng.uniform(1.0, 200.0, 10)
    types = rng.integers(0, 3, 10)
    vel = rng.normal(size=(10, 3))
    js = jmake_state(pos, mass, types, jb, velocity=vel, n_pad=13,
                     compensated=True)
    ts = tmake_state(pos, mass, types, tb, velocity=vel, n_pad=13,
                     compensated=True)
    for f in ("position", "velocity", "force", "mass", "type",
              "potential_energy", "virial", "heat_current", "mask",
              "position_c", "velocity_c"):
        np.testing.assert_array_equal(_np(getattr(ts, f)),
                                      _np(getattr(js, f)), err_msg=f)
    assert ts.type.dtype == torch.int32


def _grid_setup(name, n=300, seed=3):
    rng = np.random.default_rng(seed)
    jb, tb = _boxes(name)
    pos = np.array(jb.wrap(jnp.asarray(_positions(rng, n, LATTICES[name]))))
    types = rng.integers(0, 2, n)
    plan = JG.plan_grid(jb, 8.0, 0.5, n, position=pos)
    tplan = TG.plan_grid(tb, 8.0, 0.5, n, position=pos)
    assert dataclasses.astuple(plan) == dataclasses.astuple(tplan)
    return rng, jb, tb, pos, types, plan, tplan


@pytest.mark.parametrize("name", list(LATTICES))
def test_bin_and_pack(name):
    rng, jb, tb, pos, types, plan, tplan = _grid_setup(name)
    n = len(pos)
    mask = np.ones(n)
    mask[-5:] = 0.0  # padding rows go to the sink
    jperm, jsm, jov = jax.jit(lambda p, m: JG.bin_dense(p, jb, m, plan))(
        jnp.asarray(pos), jnp.asarray(mask))
    tperm, tsm, tov = TG.bin_dense(torch.as_tensor(pos), tb,
                                   torch.as_tensor(mask), tplan)
    np.testing.assert_array_equal(_np(tperm), _np(jperm))
    np.testing.assert_array_equal(_np(tsm), _np(jsm))
    assert bool(tov) == bool(jov)

    jps = JG.apply_perm(jnp.asarray(pos), jperm, fill=1e5)
    jts = JG.apply_perm(jnp.asarray(types, jnp.int32), jperm, fill=0)
    tps = TG.apply_perm(torch.as_tensor(pos), tperm, fill=1e5)
    tts = TG.apply_perm(torch.as_tensor(types, dtype=torch.int32), tperm, 0)
    jg = jax.jit(lambda *a: JG.pack_ghost(*a, jb, plan))(jps, jts, jsm)
    tg = TG.pack_ghost(tps, tts, tsm, tb, tplan)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=0, atol=1e-12)

    rows = rng.normal(size=(plan.grid[2], plan.grid[1], 5,
                            plan.grid[0] * plan.cap))
    np.testing.assert_array_equal(
        _np(TG.pack_ghost_rows(torch.as_tensor(rows), tplan)),
        _np(JG.pack_ghost_rows(jnp.asarray(rows), plan)))

    for bx in sorted({1, plan.grid[0]}):
        wl = JG.round_up(9 * (bx + 2) * plan.cap, 128)
        np.testing.assert_array_equal(
            _np(TG.pack_block_windows(tg, tplan, bx, wl)),
            _np(JG.pack_block_windows(jg, plan, bx, wl)))


@pytest.mark.parametrize("name", list(LATTICES))
def test_build_indices_equal(name):
    _, jb, tb, pos, types, plan, tplan = _grid_setup(name, seed=4)
    n = len(pos)
    jcp = JC.make_compact_plan(plan, position=pos, box=jb, rc_angular=4.0,
                               compact_lists=False)
    tcp = TC.make_compact_plan(tplan, position=pos, box=tb, rc_angular=4.0)
    assert (jcp.bx, jcp.mn_r, jcp.mn_a, jcp.cl) == (tcp.bx, tcp.mn_r,
                                                    tcp.mn_a, tcp.cl)
    assert (jcp.a_pad, jcp.wl) == (tcp.a_pad, tcp.wl)
    mask = np.ones(n)
    jperm, jsm, _ = jax.jit(lambda p, m: JG.bin_dense(p, jb, m, plan))(
        jnp.asarray(pos), jnp.asarray(mask))
    tperm, tsm, _ = TG.bin_dense(torch.as_tensor(pos), tb,
                                 torch.as_tensor(mask), tplan)
    jg = jax.jit(lambda *a: JG.pack_ghost(*a, jb, plan))(
        JG.apply_perm(jnp.asarray(pos), jperm, 1e5),
        JG.apply_perm(jnp.asarray(types, jnp.int32), jperm, 0), jsm)
    tg = TG.pack_ghost(TG.apply_perm(torch.as_tensor(pos), tperm, 1e5),
                       TG.apply_perm(torch.as_tensor(types,
                                                     dtype=torch.int32),
                                     tperm, 0), tsm, tb, tplan)
    jcen = JC.block_centers(jg, jcp)
    tcen = TC.block_centers(tg, tcp)
    np.testing.assert_allclose(_np(tcen), _np(jcen), rtol=0, atol=1e-12)
    jidx, jok = jax.jit(lambda c, g: JC.build_indices(
        c, JG.pack_block_windows(g, plan, jcp.bx, jcp.wl), jcp, 4.0))(jcen, jg)
    tidx, tok = TC.build_indices(
        tcen, TG.pack_block_windows(tg, tplan, tcp.bx, tcp.wl), tcp, 4.0)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(_np(tidx), _np(jidx))
    assert bool(tok) == bool(jok)


def test_compact_lists_not_ported():
    _, _, tb, pos, _, _, tplan = _grid_setup("orthogonal")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        TC.make_compact_plan(tplan, position=pos, box=tb, rc_angular=4.0,
                             compact_lists=True)
