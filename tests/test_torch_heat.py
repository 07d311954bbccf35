"""The port's NEMD heat baths (gpumd_tpu_torch/integrate/ensembles/heat.py)
against the JAX package's, float64 on the CPU.

Class level: HeatLangevin, HeatNHC, HeatBDP and HeatHybrid (an NHC
source, a Langevin sink; and the other way round) drive 64 LJ argon
atoms (four one-cell slabs along x: slab 0 the source, slab 2 the sink)
for 20 steps of 2 fs from the same start, JAX's draws injected
(tests/torch_ensemble_parity.py); positions within 1e-9 A, velocities
within 1e-9 of their largest magnitude, the cumulative bath energies
e_transfer within 1e-9 of theirs.  nhc_scalar against JAX's on random
chains within 1e-12.  App level: a heat_nhc deck (no draws) with
`compute 0 5 10 temperature` through both apps, float64: compute.out row
for row within 1e-8 of each column's largest magnitude, its two bath
columns nonzero (closes ROADMAP queue 3, item 12); the parsers' fields
(the group masks by value) against JAX's on tests/test_nemd.py's token
streams.  The JAX halves run op
by op around a jitted nhc_scalar (monkeypatched in its module for the
test), cheaper than compiling each half step.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.app import gpumd as japp
from gpumd_tpu.integrate.ensembles import heat as jheat
from gpumd_tpu_torch.integrate.ensembles import heat as theat
from torch_ensemble_parity import (
    CELLS,
    STEPS,
    Numbers,
    argon,
    assert_states,
    bdp_pairs,
    fields_match,
    normals,
    np64,
    popping,
    run_jax,
    run_torch,
    sessions,  # noqa: F401
    states,
    write_slabs,
)
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

SRC, SNK = 0, 2
COMMON = dict(temperature=60.0, coupling=20.0, delta_t=15.0)


def _masks():
    slab = argon()[3]
    return (slab == SRC).astype(float), (slab == SNK).astype(float)


def _close(got, want, tol, what):
    got, want = np64(got), np64(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _pair(name):
    """(JAX class, port class) of `name` with JAX's draws for the port."""
    src, snk = _masks()
    shape = (4 * int(np.prod(CELLS)), 3)
    if name == "lan":
        kw = dict(COMMON, source_mask=src, sink_mask=snk)
        return (jheat.HeatLangevin(**kw), theat.HeatLangevin(
            **kw, draw=popping(normals(2 * STEPS, shape, 12345, 2))))
    if name == "nhc":
        kw = dict(COMMON, source_mask=src, sink_mask=snk)
        return jheat.HeatNHC(**kw), theat.HeatNHC(**kw)
    if name == "bdp":
        kw = dict(COMMON, source_mask=src, sink_mask=snk)
        dns = (3.0 * (src.sum() - 1), 3.0 * (snk.sum() - 1))
        return (jheat.HeatBDP(**kw), theat.HeatBDP(
            **kw, generator=Numbers(bdp_pairs(STEPS, dns))))
    kinds = ("nhc", "lan") if name == "hybrid" else ("lan", "nhc", "lan")
    masks = (src, snk) if name == "hybrid" else (
        src, snk, (argon()[3] == 3).astype(float))
    kw = dict(kinds=kinds, temperature=60.0, delta_t=15.0, masks=masks,
              couplings=tuple(20.0 + 10 * i for i in range(len(kinds))))
    n_lan = kinds.count("lan")
    draws = normals(2 * STEPS * n_lan, shape, 12345)
    return jheat.HeatHybrid(**kw), theat.HeatHybrid(
        **kw, draw=popping(draws))


@pytest.fixture(scope="module")
def jitted_chain():
    """JAX's nhc_scalar jitted: its halves then run op by op around one
    compiled chain (the whole jitted half step compiles for seconds)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jheat, "nhc_scalar", jax.jit(jheat.nhc_scalar,
                                                static_argnums=(7,)))
        yield


@pytest.mark.parametrize("name", ["lan", "nhc", "bdp", "hybrid", "hybrid3"])
def test_heat_bath_matches_jax(name, jitted_chain):
    jens, tens = _pair(name)
    js, ts, jcompute, ff = states()
    js, jaux, _ = run_jax(jens, js, jcompute, jit=False)
    ts, taux, _ = run_torch(tens, ts, ff)
    assert_states(ts, js, what=name)
    _close(taux["e_transfer"], jaux["e_transfer"], 1e-9, name)
    assert taux["e_transfer"].dtype == torch.float64
    assert np.abs(np64(taux["e_transfer"])).min() > 0.0
    for key in ("draw", "generator"):
        hook = getattr(tens, key, None)
        queue = getattr(hook, "queue", [])
        assert not queue, (name, len(queue))


def test_nhc_scalar_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(3):
        pos = rng.normal(size=4)
        vel = rng.normal(size=4)
        mas = rng.uniform(0.5, 3.0, 4) * 1e-2
        ek2, kt, dn = rng.uniform(0.5, 1.5), 5e-3, 192.0
        f, p, v = theat.nhc_scalar(list(pos), list(vel), list(mas), ek2, kt,
                                   dn, 0.05)
        jf, jp, jv = jheat.nhc_scalar(jnp.asarray(pos), jnp.asarray(vel),
                                      jnp.asarray(mas), jnp.asarray(ek2), kt,
                                      dn, 0.05)
        assert f == pytest.approx(float(jf), rel=1e-12)
        np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-12, atol=1e-14)


def test_heat_nhc_deck_compute_out_matches_jax(tmp_path):
    deck = ("potential lj.txt\ntime_step 2\n"
            f"ensemble heat_nhc 60 20 15 {SRC} {SNK}\n"
            "compute 0 5 10 temperature\nrun 40\n")
    dirs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        shutil.rmtree(d, ignore_errors=True)
        write_slabs(d)
        (d / "run.in").write_text(deck)
        dirs[pkg] = d
    japp.Session(str(dirs["jax"]), quiet=True).execute()
    ts = tapp.Session(str(dirs["torch"]), quiet=True, device="cpu",
                      dtype=torch.float64)
    ts.execute()
    assert ts.route_reason.startswith("CPU device")
    got, want = (np.atleast_2d(np.loadtxt(dirs[k] / "compute.out"))
                 for k in ("torch", "jax"))
    assert got.shape == want.shape == (4, 6)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    assert (np.abs(got - want).max(axis=0) / scale).max() <= 1e-8
    assert (np.abs(got[:, 4:]) > 0).all(), got[:, 4:]


@pytest.mark.parametrize("toks", [
    "heat_lan 30 50 15 0 2", "heat_nhc 30 50 15 0 2",
    "heat_bdp 30 50 15 1 3", "heat_hybrid nhc lan 30 100 100 15 0 2",
    "heat_hybrid lan nhc lan 30 10 20 30 15 0 1 3"])
def test_parsers_match_jax(sessions, toks):  # noqa: F811
    js, ts = sessions
    for s in sessions:
        s.kw_ensemble(toks.split())
    assert type(ts.ensemble).__name__ == type(js.ensemble).__name__
    assert fields_match(ts.ensemble, js.ensemble)
