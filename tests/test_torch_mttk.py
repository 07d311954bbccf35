"""The port's MTTK family (gpumd_tpu_torch/integrate/ensembles/mttk.py:
MTTK, NPHug) and npt_qtb's barostat against the JAX package's, float64
on the CPU.

Class level: nvt_mttk (constant and ramped), npt_mttk iso, aniso, tri and
per axis (x, y, z and xy: non-hydrostatic, the reference cell reset
every 5 steps), nph_mttk and nphug drive 64 LJ argon atoms for 20 steps
of 2 fs from the same start (tests/torch_ensemble_parity.py): positions
within 1e-9 A, velocities within 1e-9 of their largest magnitude, the
cell within 1e-12, the chains' and the cell's velocities (eta_dot,
eta_p_dot, omega_dot, and the thermostat chain's positions eta) within
5e-8 of their largest magnitude (ramped runs: see below).  The JAX
package computes its target temperature and chain masses in float32; the
port's host chains keep those roundings, which the constant and the
ramped runs test.  XLA's float32 division is not always correctly
rounded: at step 8 of the ramp its chain mass is an ulp off numpy's
(6e-8), which moves eta_dot by 4e-9 of its size, eta by 1.2e-8 and the
positions by up to 9e-9 A over 20 steps, hence 1e-8 for the ramped runs'
positions, velocities and cell and 5e-7 for their chain variables.
_baro_config against JAX's for every mode, exactly.  Under npt_mttk tri
the Verlet cache (ForceField.compute_cached, skin 0.3 A) rebuilds
mid-run as the cell moves, and the run equals the one that rebuilds its
lists every step (1e-9 A).  App level: an `npt_mttk tri` deck through
both apps (float64; thermo.out within 1e-8 of each column's largest
magnitude), the parsers' fields against JAX's on the JAX tests' token
streams.
"""

import numpy as np
import pytest
import torch

from gpumd_tpu.integrate.ensembles import mttk as jmttk
from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.integrate.ensembles import mttk as tmttk
from torch_ensemble_parity import (
    DT,
    assert_states,
    deck_pair,
    fields_match,
    np64,
    run_jax,
    run_torch,
    rows_close,
    sessions,  # noqa: F401
    states,
)
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

PER_AXIS = {"x": (0.1, 0.15), "y": (0.2, 0.2), "z": (0.0, 0.0),
            "xy": (0.05, 0.05)}
CASES = {
    "nvt": lambda m: m.MTTK.nvt(60.0, 60.0, t_period=30.0),
    "nvt_ramp": lambda m: m.MTTK.nvt(60.0, 75.0, t_period=30.0, n_steps=20),
    "npt_iso": lambda m: m.MTTK.npt(60.0, 60.0, 0.3, 0.3, "iso",
                                    t_period=30.0, p_period=60.0),
    "npt_aniso": lambda m: m.MTTK.npt(60.0, 70.0, 0.3, 0.1, "aniso",
                                      t_period=30.0, p_period=60.0,
                                      n_steps=20),
    "npt_tri": lambda m: m.MTTK.npt(60.0, 60.0, 0.3, 0.3, "tri",
                                    t_period=30.0, p_period=60.0),
    "npt_axes": lambda m: m.MTTK.npt(60.0, 60.0, PER_AXIS, PER_AXIS,
                                     t_period=30.0, p_period=60.0,
                                     n_steps=20, h0_reset_interval=5),
    "nph": lambda m: m.MTTK.nph(0.2, 0.2, "iso", p_period=60.0),
    "nphug": lambda m: m.NPHug(use_thermostat=True, use_barostat=True,
                               uniaxial=0, t_period=30.0, p_period=60.0,
                               **m.NPHug._baro_config(
                                   {"x": (0.5, 0.5)}, {"x": (0.5, 0.5)},
                                   None)),
}


def _rel(got, want):
    got, want = np64(got), np64(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_mttk_matches_jax(name):
    js, ts, jcompute, ff = states()
    jens = CASES[name](jmttk)
    js, jaux, _ = run_jax(jens, js, jcompute)
    ts, taux, _ = run_torch(CASES[name](tmttk), ts, ff)
    # a ramp's XLA float32 chain masses (see the module docstring)
    tol = 1e-8 if jens.n_steps else 1e-9
    assert_states(ts, js, atol=tol, box_atol=tol if jens.n_steps else 1e-12,
                  what=name)
    for key in ("eta_dot", "eta_p_dot", "omega_dot", "eta"):
        want = np64(jaux[key])
        if np.abs(want).max() > 0:
            assert _rel(taux[key], want) <= 50 * tol, (name, key)
    assert taux["i"] == int(jaux["i"]) == 20
    if name == "nphug":
        assert taux["t_hug"] == pytest.approx(float(jaux["t_hug"]),
                                              rel=1e-9)
    if name.startswith(("npt", "nph")):
        assert np.abs(np64(ts.box.h) - np64(states()[1].box.h)).max() > 1e-6


@pytest.mark.parametrize("p1, p2, mode", [
    (0.3, 0.1, "iso"), (0.3, 0.1, "aniso"), (0.3, 0.1, "tri"),
    (PER_AXIS, PER_AXIS, None), ({"y": (1.0, 2.0)}, {"y": (1.0, 2.0)}, None)])
def test_baro_config_matches_jax(p1, p2, mode):
    assert tmttk.MTTK._baro_config(p1, p2, mode) == \
        jmttk.MTTK._baro_config(p1, p2, mode)


def test_verlet_cache_rebuilds_under_npt_tri():
    """npt_mttk tri at 1 GPa with a short pperiod: the cell moves atoms
    past skin/2 within 20 steps; the cached run rebuilds and matches the
    run that rebuilds every step."""
    ens = tmttk.MTTK.npt(60.0, 60.0, 1.0, 1.0, "tri", t_period=30.0,
                         p_period=20.0)
    _, ts, _, ff = states()
    plain, _, _ = run_torch(ens, ts, ff, n=30)
    cff = ForceField.create(list(ff.potentials), ts.box,
                            ts.position.shape[0], mn=160, skin=0.3)
    rebuilds = 0
    with torch.no_grad():
        state, aux = ts, ens.init(ts)
        cache = cff.refresh_cache(state)
        for _ in range(30):
            state, aux = ens.step1(state, aux, DT)
            state, new = cff.compute_cached(state, cache)
            rebuilds += new is not cache
            cache = new
            state, aux = ens.step2(state, aux, DT)
    assert rebuilds >= 1
    assert_states(state, plain, what="cached vs plain")


def test_npt_mttk_tri_deck_matches_jax(tmp_path):
    line = "ensemble npt_mttk temp 60 60 tperiod 30 tri 0.3 0.3 pperiod 60"
    dirs, _, _ = deck_pair(tmp_path, f"potential lj.txt\ntime_step 2\n{line}"
                           "\ndump_thermo 5\nrun 20\n")
    rows_close(dirs["torch"] / "thermo.out", dirs["jax"] / "thermo.out",
               1e-8, (4, 18))


PARSE = [
    ("npt_mttk", "temp 40 40 iso 0.1 0.2 tperiod 50 pperiod 400"),
    ("npt_mttk", "temp 40 40 x 0.1 0.1 y 0 0 z 0 0 xy 0.01 0.01"),
    ("npt_mttk", "temp 40 50 tri 0.2 0.2"),
    ("nvt_mttk", "temp 40 60 tperiod 80"),
    ("nph_mttk", "aniso 0 0.1 pperiod 700"),
    ("nphug", "tperiod 100 pperiod 500 x 0.05 0.05"),
    ("nphug", "iso 1 1 p0 0.5 v0 1200 e0 -5"),
    ("npt_qtb", "temp 20 20 tperiod 50 f_max 10 N_f 30 iso 0.5 0.5 "
                "pperiod 300"),
    ("npt_qtb", "temp 20 20 z 0.1 0.2"),
]


@pytest.mark.parametrize("name, toks", PARSE)
def test_parsers_match_jax(sessions, name, toks):  # noqa: F811
    js, ts = sessions
    for s in sessions:
        s.kw_ensemble([name] + toks.split())
    assert type(ts.ensemble).__name__ == type(js.ensemble).__name__
    assert fields_match(ts.ensemble, js.ensemble)
