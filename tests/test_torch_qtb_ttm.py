"""The port's quantum thermal bath (gpumd_tpu_torch/integrate/ensembles/
qtb.py: qtb_time_filter, NVTQTB, NPTQTB) and two-temperature model
(ttm.py: TTM) against the JAX package's, float64 on the CPU.

qtb_time_filter against JAX's within 1e-12.  Class level: NVTQTB (its
noise history a ring of 2 N_f columns: N_f 4 with a refresh every 2
steps, so the ring wraps, and N_f 8 every 5 steps), NPTQTB with an iso
MTTK barostat, and TTM on a 2 x 2 x 1 electron grid (25 diffusion
substeps a step) for ttm's group and for every atom, 20 steps of 2 fs of
64 LJ argon atoms from the same start with JAX's draws injected
(tests/torch_ensemble_parity.py): positions within 1e-9 A, velocities
within 1e-9 of their largest magnitude, the cell within 1e-12, T_e and
the bath force within 1e-9 of their largest magnitude.  App level: a
ttm deck through both apps (float64, JAX's draws injected): thermo.out
within 1e-8 of each column's largest magnitude and
ttm_electron_temperature.out within 1e-8 of its largest T_e; the parsers'
fields against JAX's.
"""

import functools

import numpy as np
import pytest

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.integrate.ensembles import mttk as jmttk
from gpumd_tpu.integrate.ensembles import qtb as jqtb
from gpumd_tpu.integrate.ensembles import ttm as jttm
from gpumd_tpu_torch.integrate.ensembles import mttk as tmttk
from gpumd_tpu_torch.integrate.ensembles import qtb as tqtb
from gpumd_tpu_torch.integrate.ensembles import ttm as tttm
from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION
from torch_ensemble_parity import (
    CELLS,
    DT,
    STEPS,
    argon,
    assert_states,
    deck_pair,
    fields_match,
    np64,
    popping,
    qtb_draws,
    rows_close,
    run_jax,
    run_torch,
    sessions,  # noqa: F401
    states,
    uniforms,
)
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

N = 4 * int(np.prod(CELLS))


def _rel(got, want):
    got, want = np64(got), np64(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_time_filter_matches_jax():
    for args in ((60.0, DT, 100.0, 4, 2), (300.0, 0.05, 50.0, 100, 3),
                 (5.0, DT, 10.0, 32, 25)):
        np.testing.assert_allclose(tqtb.qtb_time_filter(*args),
                                   jqtb.qtb_time_filter(*args), rtol=1e-12,
                                   atol=1e-15)


def _qtb(m, f_max, n_f, draw=None):
    kw = dict(temperature=60.0, coupling=20.0, dt=DT, f_max=f_max, n_f=n_f)
    return m.NVTQTB(**kw) if draw is None else m.NVTQTB(**kw, draw=draw)


def _qtb_draw(f_max, n_f):
    alpha = _qtb(jqtb, f_max, n_f)._alpha()
    return popping(qtb_draws(-(-STEPS // alpha), N, n_f))


@pytest.mark.parametrize("f_max, n_f", [(100.0, 4), (50.0, 8)])
def test_nvt_qtb_matches_jax(f_max, n_f):
    draw = _qtb_draw(f_max, n_f)
    js, ts, jcompute, ff = states()
    js, jaux, _ = run_jax(_qtb(jqtb, f_max, n_f), js, jcompute)
    ts, taux, _ = run_torch(_qtb(tqtb, f_max, n_f, draw), ts, ff)
    assert_states(ts, js, what="nvt_qtb")
    assert _rel(taux["fran"], jaux["fran"]) <= 1e-9
    assert not draw.queue and taux["counter"] == int(jaux["counter"])


def test_npt_qtb_matches_jax():
    draw = _qtb_draw(100.0, 4)
    cfg = jmttk.MTTK._baro_config(0.3, 0.3, "iso")
    jens = jqtb.NPTQTB(qtb=_qtb(jqtb, 100.0, 4), baro=jmttk.MTTK(
        use_barostat=True, p_period=60.0, **cfg))
    tens = tqtb.NPTQTB(qtb=_qtb(tqtb, 100.0, 4, draw), baro=tmttk.MTTK(
        use_barostat=True, p_period=60.0, **cfg))
    js, ts, jcompute, ff = states()
    js, jaux, _ = run_jax(jens, js, jcompute)
    ts, taux, _ = run_torch(tens, ts, ff)
    assert_states(ts, js, what="npt_qtb")
    assert _rel(taux["omega_dot"], jaux["omega_dot"]) <= 1e-9


def _ttm(m, gmask, draw=None):
    lengths = argon()[2]
    kw = dict(gmask=gmask, c_vol=1.0e-5, kappa_e=1.0e-3,
              gamma_p=5.0 * TIME_UNIT_CONVERSION / 1000.0,
              gamma_s=1.0 * TIME_UNIT_CONVERSION / 1000.0,
              v0_sq=(0.5 * TIME_UNIT_CONVERSION / 1000.0) ** 2,
              grid=(2, 2, 1), t_e_init=600.0, source=1e-6,
              dcell_static=(lengths[0] / 2, lengths[1] / 2, lengths[2]))
    return m.TTM(**kw) if draw is None else m.TTM(**kw, draw=draw)


@pytest.mark.parametrize("group", ["slab1", "all"])
def test_ttm_matches_jax(group):
    slab = argon()[3]
    gmask = (slab == 1).astype(float) if group == "slab1" else np.ones(N)
    draw = popping(uniforms(STEPS, (N, 3)))
    tens = _ttm(tttm, gmask, draw)
    assert tens.substeps(DT * TIME_UNIT_CONVERSION) == 25
    js, ts, jcompute, ff = states()
    js, jaux, _ = run_jax(_ttm(jttm, gmask), js, jcompute)
    ts, taux, _ = run_torch(tens, ts, ff)
    assert_states(ts, js, what=group)
    for key in ("t_e", "ttm_force", "net_power"):
        assert _rel(taux[key], jaux[key]) <= 1e-9, key
    assert np64(taux["t_e"]).std() > 0 and not draw.queue


def test_ttm_deck_matches_jax(tmp_path):
    deck = ("potential lj.txt\ntime_step 2\n"
            "ensemble ttm 0 1 1.0e-5 1.0 1.0 5.0 1.0 0.5 2 2 1 600 "
            "ttm_out_interval 5 ttm_source 0.001\ndump_thermo 5\nrun 20\n")
    draw = popping(uniforms(STEPS, (N, 3)))
    dirs, _, ts = deck_pair(tmp_path, deck, patches=(
        ("TTM", functools.partial(tapp.TTM, draw=draw)),))
    rows_close(dirs["torch"] / "thermo.out", dirs["jax"] / "thermo.out",
               1e-8, (4, 18))
    name = "ttm_electron_temperature.out"
    got, want = ((dirs[k] / name).read_text().splitlines()
                 for k in ("torch", "jax"))
    assert got[:5] == want[:5] and len(got) == len(want) == 5 + 4
    a, b = (np.loadtxt(dirs[k] / name) for k in ("torch", "jax"))
    np.testing.assert_array_equal(a[:, :3], b[:, :3])
    assert np.abs(a[:, 3] - b[:, 3]).max() <= 1e-8 * np.abs(b[:, 3]).max()
    assert not draw.queue


@pytest.mark.parametrize("name, toks", [
    ("nvt_qtb", "10 10 100 f_max 10 N_f 32"),
    ("nvt_qtb", "300 300 50"),
    ("ttm", "0 0 1.0e-5 1.0 1.0 5.0 0 100 2 2 2 600"),
    ("heat_ttm", "0 1 2e-5 0.5 2.0 4.0 1.0 50 3 1 1 500 "
                 "ttm_out_interval 10 ttm_source 0.01"),
])
def test_parsers_match_jax(sessions, name, toks):  # noqa: F811
    js, ts = sessions
    for s in sessions:
        s.kw_ensemble([name] + toks.split())
    assert type(ts.ensemble).__name__ == type(js.ensemble).__name__
    assert fields_match(ts.ensemble, js.ensemble)
