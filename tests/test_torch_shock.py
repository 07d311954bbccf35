"""The port's shock ensembles and keywords against the JAX package's,
float64 on the CPU: MSST (gpumd_tpu_torch/integrate/ensembles/msst.py),
the walls (walls.py), DeformWrapper (deform.py) and dump_shock_nemd.

Class level: MSST (with and without tscale), wall_piston, wall_mirror,
wall_harmonic and an NVT-Berendsen run under deform drive 64 LJ argon
atoms for 20 steps of 2 fs from the same start
(tests/torch_ensemble_parity.py): positions within 1e-9 A, velocities
within 1e-9 of their largest magnitude, the cell within 1e-12; MSST's
omega, Lagrangian and conserved quantities within 1e-9 of their size;
tests/test_msst.py's 800-step run at its 108 atoms, as a deck through
both apps: the cell within 1e-9 of JAX's, compressed past that test's 0.5%.
App level: a wall_piston deck under deform with dump_shock_nemd
through both apps (float64): the six _hist.txt files within 1e-8 of
each file's largest magnitude, thermo.out within 1e-8 of each column's;
the parsers' fields against JAX's on the JAX tests' token streams.
"""

import functools

import numpy as np
import pytest
import torch

from gpumd_tpu.integrate.ensembles import deform as jdeform
from gpumd_tpu.integrate.ensembles import msst as jmsst
from gpumd_tpu.integrate.ensembles import walls as jwalls
from gpumd_tpu.integrate.ensembles.nvt import NVTBerendsen as JBer
from gpumd_tpu_torch.integrate.ensembles import deform as tdeform
from gpumd_tpu_torch.integrate.ensembles import msst as tmsst
from gpumd_tpu_torch.integrate.ensembles import walls as twalls
from gpumd_tpu_torch.integrate.ensembles.nvt import NVTBerendsen as TBer
from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION
from torch_ensemble_parity import (
    assert_states,
    deck_pair,
    fields_match,
    np64,
    rows_close,
    run_jax,
    run_torch,
    sessions,  # noqa: F401
    states,
    write_slabs,
)
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

VP = 5.0 / 100.0 * TIME_UNIT_CONVERSION  # 5 km/s, as the parser converts
CASES = {
    "msst": lambda m: m.MSST(shock_direction=0, vs=1.5, qmass=1.0e4,
                             mu=1.0),
    "msst_tscale": lambda m: m.MSST(shock_direction=2, vs=2.0, qmass=5e3,
                                    mu=0.5, tscale=0.01),
    "wall_piston": lambda m: m.WallPiston(vp=VP, thickness=6.0),
    "wall_mirror": lambda m: m.WallMirror(vp=VP, thickness=6.0),
    "wall_harmonic": lambda m: m.WallHarmonic(vp=VP, k=2.0, thickness=6.0),
}
MODULES = {"msst": (jmsst, tmsst), "wall": (jwalls, twalls)}


@pytest.mark.parametrize("name", list(CASES))
def test_shock_ensemble_matches_jax(name):
    jm, tm = MODULES[name.split("_")[0]]
    js, ts, jcompute, ff = states()
    jens, tens = CASES[name](jm), CASES[name](tm)
    js, jaux, _ = run_jax(jens, js, jcompute)
    ts, taux, _ = run_torch(tens, ts, ff)
    assert_states(ts, js, what=name)
    if name.startswith("msst"):
        for key in ("omega", "lagrangian"):
            assert taux[key] == pytest.approx(float(jaux[key]), rel=1e-9)
        with torch.no_grad():
            got = tens.conserved(ts, taux)
        want = jens.conserved(js, jaux)
        np.testing.assert_allclose(got, [float(w) for w in want],
                                   rtol=1e-9)
        assert taux["omega"] != 0.0
    else:
        assert float(ts.position[:, 0].abs().max()) > 0



def test_msst_run_of_the_jax_test_matches_jax(tmp_path):
    """tests/test_msst.py's run at its size (fcc argon 108 at 40 K, 3 km/s
    along x, qmass 200, mu 5, tscale 0.05, 800 steps of 2 fs) as a deck
    through both apps from one start: the cell within 1e-9 of JAX's, x
    compressed past that test's 0.5% and y untouched."""
    deck = ("potential lj.txt\ntime_step 2\n"
            "ensemble msst x 3 qmass 200 mu 5 tscale 0.05\nrun 800\n")
    make = functools.partial(write_slabs, cells=(3, 3, 3), temperature=40.0,
                             jitter=0.0)
    _, js, ts = deck_pair(tmp_path, deck, make=make)
    h0, h1 = np64(ts.box.h), np64(ts.state.box.h)
    np.testing.assert_allclose(h1, np64(js.state.box.h), rtol=1e-9,
                               atol=1e-12)
    assert h1[0, 0] < 0.995 * h0[0, 0], (h0[0, 0], h1[0, 0])
    assert abs(h1[1, 1] - h0[1, 1]) < 1e-9


def test_deform_matches_jax():
    js, ts, jcompute, ff = states()
    rate = (0.01, 0.0, -0.005)
    jens = jdeform.DeformWrapper(inner=JBer(t0=60.0, t1=60.0,
                                            coupling=50.0), rate=rate)
    tens = tdeform.DeformWrapper(inner=TBer(t0=60.0, t1=60.0,
                                            coupling=50.0), rate=rate)
    h0 = np64(ts.box.h)
    js, _, _ = run_jax(jens, js, jcompute)
    ts, _, _ = run_torch(tens, ts, ff)
    assert_states(ts, js, what="deform")
    np.testing.assert_allclose(np.diagonal(np64(ts.box.h)),
                               np.diagonal(h0) + 20 * np.asarray(rate),
                               rtol=1e-12)


def _hist_close(got, want, tol=1e-8):
    a, b = np.atleast_2d(np.loadtxt(got)), np.atleast_2d(np.loadtxt(want))
    assert a.shape == b.shape, (got, a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), got


def test_wall_piston_deform_dump_shock_nemd_deck_matches_jax(tmp_path):
    deck = ("potential lj.txt\ntime_step 2\ndeform 0.002 1 0 1\n"
            "ensemble wall_piston vp 5 thickness 6\n"
            "dump_shock_nemd interval 5 bin_size 5.0\ndump_thermo 5\n"
            "run 20\n")
    dirs, js, ts = deck_pair(tmp_path, deck)
    for name in ("temperature", "pxx", "pyy", "pzz", "density", "vp"):
        f = f"{name}_hist.txt"
        _hist_close(dirs["torch"] / f, dirs["jax"] / f)
        assert np.atleast_2d(np.loadtxt(dirs["torch"] / f)).shape == (4, 5)
    rows_close(dirs["torch"] / "thermo.out", dirs["jax"] / "thermo.out",
               1e-8, (4, 18))
    assert ts.deform == js.deform == (0.002, 0.0, 0.002)


@pytest.mark.parametrize("name, toks", [
    ("msst", "x 1.5 qmass 10000 mu 1"),
    ("msst", "z 3 tscale 0.01 p0 1 v0 1500 e0 -10"),
    ("wall_piston", "vp 10 thickness 6"),
    ("wall_mirror", "vp 10 thickness 6"),
    ("wall_harmonic", "vp 5 k 2.0 thickness 6"),
])
def test_parsers_match_jax(sessions, name, toks):  # noqa: F811
    js, ts = sessions
    for s in sessions:
        s.kw_ensemble([name] + toks.split())
    assert type(ts.ensemble).__name__ == type(js.ensemble).__name__
    assert fields_match(ts.ensemble, js.ensemble)
