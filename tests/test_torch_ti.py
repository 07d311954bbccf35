"""The port's thermodynamic-integration family (gpumd_tpu_torch/integrate/
ensembles/ti.py: TISpring, TI, TIRS, TIAS, TILiquid) against the JAX
package's, float64 on the CPU.

The port's uf_spline.npz is a byte-for-byte copy of the JAX package's.
The Uhlenbeck-Ford pair sum (uf_pair, row blocks of 512; here of 24 to
cross block edges) against TILiquid._uf_pair on a jittered argon state
within 1e-12.  Class level: ti_spring (given springs, and springs from
the equilibration MSD), ti at lambda 0.4, ti_rs, ti_as and ti_liquid,
20 steps of 2 fs of 64 LJ argon atoms (t_equil 2, t_switch 8: both
switching legs inside the run) from the same start, JAX's draws injected
(tests/torch_ensemble_parity.py): positions within 1e-9 A, velocities
within 1e-9 of their largest magnitude, the cell within 1e-12 (1e-8 and
5e-7 for ti_rs and ti_as's ramped MTTK chains, as in
tests/test_torch_mttk.py), the spring constants, E_diff, the per-step
observations the .csv rows print and the .yaml entries within 1e-9 of
their size, and as many .csv rows.  App level: a
ti_spring deck through both apps (float64, JAX's draws injected): the
.csv and .yaml files within 1e-8; the parsers' fields against JAX's on
the JAX tests' token streams.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.integrate.ensembles import ti as jti
from gpumd_tpu_torch.integrate.ensembles import ti as tti
from torch_ensemble_parity import (
    CELLS,
    STEPS,
    assert_states,
    deck_pair,
    fields_match,
    normals,
    np64,
    popping,
    rows_close,
    run_jax,
    run_torch,
    sessions,  # noqa: F401
    states,
)
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
N = 4 * int(np.prod(CELLS))
SCHED = dict(t_switch=8, t_equil=2, n_steps=STEPS)
MTTK_KW = dict(use_thermostat=True, use_barostat=True, t_period=30.0,
               p_period=60.0, n_steps=STEPS, t_switch=8, t_equil=2)
CASES = {
    "ti_spring": lambda m: m.TISpring(temperature=60.0, coupling=30.0,
                                      spring_k=(0.5,), **SCHED),
    "ti_spring_msd": lambda m: m.TISpring(temperature=60.0, coupling=30.0,
                                          **SCHED),
    "ti": lambda m: m.TI(temperature=60.0, coupling=30.0, spring_k=(0.5,),
                         lam=0.4, n_steps=STEPS),
    "ti_liquid": lambda m: m.TILiquid(temperature=60.0, coupling=30.0,
                                      sigma_sqrd=2.0, p_uf=25.0,
                                      target_pressure=1e-3, **SCHED),
    "ti_rs": lambda m: m.TIRS(t_start=60.0, t_stop=60.0, t_max=90.0,
                              **m.TIRS._baro_config(0.0, 0.0, "iso"),
                              **MTTK_KW),
    "ti_as": lambda m: m.TIAS(t_start=60.0, t_stop=60.0, p_min=0.0,
                              p_max=0.2,
                              **m.TIAS._baro_config(0.0, 0.0, "iso"),
                              **MTTK_KW),
}
LANGEVIN = ("ti_spring", "ti_spring_msd", "ti", "ti_liquid")


def _rel(got, want):
    got, want = np64(got), np64(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_uf_spline_is_the_jax_packages():
    ours = ROOT / "gpumd_tpu_torch" / "assets" / "uf_spline.npz"
    assert tti.UF_SPLINE == ours
    assert ours.read_bytes() == (ROOT / "gpumd_tpu" / "assets"
                                 / "uf_spline.npz").read_bytes()


def test_uf_pair_matches_jax():
    js, ts, _, _ = states(temperature=90.0, jitter=0.4)
    jens = CASES["ti_liquid"](jti)
    je, jf = jens._uf_pair(js)
    for block in (24, 512):
        e, f = tti.uf_pair(ts, 60.0, 2.0, 25.0, block=block)
        np.testing.assert_allclose(np64(e), np.asarray(je), rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(np64(f), np.asarray(jf), rtol=1e-12,
                                   atol=1e-15)
    assert float(np.abs(np.asarray(jf)).max()) > 0


def _run(name):
    jens, tens = CASES[name](jti), CASES[name](tti)
    if name in LANGEVIN:
        draw = popping(normals(2 * STEPS, (N, 3), 12345))
        tens = CASES[name](_with_draw(draw))
    js, ts, jcompute, ff = states()
    js, jaux, jobs = run_jax(jens, js, jcompute, observe=jens.observe)
    ts, taux, tobs = run_torch(tens, ts, ff, observe=tens.observe)
    return jens, tens, js, jaux, jobs, ts, taux, tobs


class _with_draw:
    """The port's ti module, its classes given `draw`."""

    def __init__(self, draw):
        self.draw = draw

    def __getattr__(self, name):
        cls = getattr(tti, name)
        if name in ("TISpring", "TI", "TILiquid"):
            return functools.partial(cls, draw=self.draw)
        return cls


def _stack(obs):
    """Per-step observations as the runner stacks them: one array a
    field."""
    return tuple(np.asarray([np64(o[k]) for o in obs])
                 for k in range(len(obs[0])))


@pytest.mark.parametrize("name", list(CASES))
def test_ti_matches_jax(name):
    jens, tens, js, jaux, jobs, ts, taux, tobs = _run(name)
    ramped = name in ("ti_rs", "ti_as")
    tol = 1e-8 if ramped else 1e-9
    assert_states(ts, js, atol=tol, box_atol=tol if ramped else 1e-12,
                  what=name)
    for key in ("k", "e_diff", "lambda", "dlambda", "pe", "espring", "euf",
                "vol"):
        if key in jaux:
            assert _rel(taux[key], jaux[key]) <= tol, (name, key)
    tcols, jcols = _stack(tobs), _stack(jobs)
    for a, b in zip(tcols, jcols):
        assert _rel(a, b) <= tol, (name, "observation")
    got = list(tens.csv_rows(tcols, N))
    assert len(got) == len(list(jens.csv_rows(jcols, N))) > 0
    if tens.yaml_name:
        fa, fb = tens.free_energy(ts, taux), jens.free_energy(js, jaux)
        assert sorted(fa) == sorted(fb)
        for k in fb:
            assert fa[k] == pytest.approx(float(fb[k]), rel=1e-9), k
    if name in LANGEVIN:
        assert not tens.draw.queue


def test_ti_spring_deck_matches_jax(tmp_path):
    deck = ("potential lj.txt\ntime_step 2\n"
            "ensemble ti_spring temp 60 tperiod 30 tswitch 8 tequil 2 "
            "spring Ar 0.5\nrun 20\n")
    draw = popping(normals(2 * STEPS, (N, 3), 12345))
    dirs, _, _ = deck_pair(tmp_path, deck, patches=(
        ("TISpring", functools.partial(tapp.TISpring, draw=draw)),))
    rows_close(dirs["torch"] / "ti_spring.csv",
               dirs["jax"] / "ti_spring.csv", 1e-8)
    got, want = ((dirs[k] / "ti_spring.yaml").read_text().splitlines()
                 for k in ("torch", "jax"))
    assert [g.split(":")[0] for g in got] == [w.split(":")[0] for w in want]
    np.testing.assert_allclose([float(g.split(":")[1]) for g in got],
                               [float(w.split(":")[1]) for w in want],
                               rtol=1e-8, atol=1e-6)
    assert not draw.queue


@pytest.mark.parametrize("name, toks", [
    ("ti_spring", "temp 20 tperiod 100 tswitch 400 tequil 100 spring Ar 0.5"),
    ("ti_spring", "temp 20 tperiod 100 tswitch 400 tequil 200 press 1"),
    ("ti", "lambda 0.5 temp 20 tperiod 100 spring Ar 0.5"),
    ("ti_rs", "temp 20 40 iso 0 tperiod 100 pperiod 1000 tswitch 80 "
              "tequil 20"),
    ("ti_as", "temp 20 press 0 0.2 tperiod 100 pperiod 500 tswitch 80 "
              "tequil 20"),
    ("ti_liquid", "temp 90 tperiod 100 tswitch 300 tequil 100 sigmasqrd 2.0 "
                  "p 25 press 0"),
])
def test_parsers_match_jax(sessions, name, toks):  # noqa: F811
    js, ts = sessions
    for s in sessions:
        s.kw_ensemble([name] + toks.split())
    assert type(ts.ensemble).__name__ == type(js.ensemble).__name__
    assert fields_match(ts.ensemble, js.ensemble)


def test_ti_refuses_what_jax_refuses(sessions):  # noqa: F811
    _, ts = sessions
    with pytest.raises(ValueError, match="p must be"):
        ts.kw_ensemble("ti_liquid temp 90 p 30".split())
    with pytest.raises(ValueError, match="unknown ti token"):
        ts.kw_ensemble("ti lambda 0.5 tswitch 4 spring Ar 1".split())
    with pytest.raises(ValueError, match="spring constants"):
        ts.kw_ensemble("ti lambda 0.5 temp 20".split())
    with torch.no_grad(), pytest.raises(ValueError, match="required"):
        tti.TI(temperature=60.0).init(states()[1])
