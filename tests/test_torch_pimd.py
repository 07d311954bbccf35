"""The port's path integrals (gpumd_tpu_torch/integrate/pimd.py) and the
app's path-integral surface against the JAX package's, float64 on the
CPU.

Runner level: 32 LJ argon atoms (2 x 2 x 2 fcc cells, jittered; a 5 A
cutoff, LJ_SHORT), 4 beads, 50 steps of 2 fs from the same start under
a ramped pimd (T1 40 -> T2 80 K), trpmd and rpmd, JAX's draws (init,
then two PILE half steps a step, each `key, sub = split(key)` from
PRNGKey(7)) injected into the port's `draw`: bead positions within 1e-9 A,
velocities within 1e-9 A/fs, forces and the per-step bead temperature
and energy within 1e-9 of their largest magnitude.
transformation_matrix equals JAX's for P = 1 to 8 (orthogonal for
P = 1 and even P only, in both packages).  rpmd with one bead
is NVE velocity Verlet: the port's runner against its own md_run, 20
steps, within 1e-12.

App level: a pimd deck (T1 = T2) with dump_beads through both apps
(tests/torch_ensemble_parity.py's deck_pair, JAX's draws injected):
every beads_dump_<k>.xyz equal in its headers and within 1e-8 of each
column's largest magnitude, and no other output file.  The ramped pimd
through the port's app against the runner driven directly, across
dump_beads chunks; an interval that does not divide the run raises.  A
pimd deck under `engine dense` runs the path-integral runner; rpmd and
trpmd take the last `velocity` keyword's temperature.  The list path's
neighbour-capacity check raises at a chunk's end inside a run whose box
`deform` compresses (the list capacity patched to the start's deepest
row plus 4); NeighborConfig.build's cell bins grow with the fullest
cell, where the plan's cell_cap would flag an overflow.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.forcefield import ForceField as JFF
from gpumd_tpu.integrate import pimd as jpimd
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.lj import LJ as JLJ
from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.integrate import pimd as tpimd
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.integrate.run import md_run
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.lj import LJ
from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION
from torch_ensemble_parity import (
    DT,
    LJ_PARAMS,
    MASS,
    argon,
    deck_pair,
    normals,
    np64,
    popping,
    write_slabs,
)
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

CELLS = (2, 2, 2)
# argon with a 5 A cutoff: no periodic image in the 10.5 A box, and the
# JAX runner's compile about half of the repo's 9 A lj.txt's
LJ_SHORT = (LJ_PARAMS[0], LJ_PARAMS[1], 5.0)
MN = 48
P = 4
STEPS = 50
SEED = 7  # the app's runner seed in both packages
# the JAX runner compiles once a mode: pimd runs ramped only (the app
# deck below runs it unramped through both apps)
MODES = {"pimd_ramp": ("pimd", 40.0, 80.0), "trpmd": ("trpmd", 40.0, None),
         "rpmd": ("rpmd", 40.0, None)}


def n_draws(mode, steps):
    """init's draw, then two PILE half steps a step (none for rpmd)."""
    return 1 + (0 if mode == "rpmd" else 2 * steps)


def bases(cells=CELLS):
    pos, vel, lengths, _ = argon(cells, temperature=40.0)
    n = len(pos)
    jff = JFF.create([JLJ.from_params(*LJ_SHORT)], JBox.orthogonal(lengths),
                     n, mn=MN)
    js = jmake_state(pos, np.full(n, MASS), np.zeros(n, int),
                     JBox.orthogonal(lengths), velocity=vel)
    ts = make_state(pos, np.full(n, MASS), np.zeros(n, int),
                    Box.orthogonal(lengths, device="cpu"), velocity=vel)
    ff = ForceField.create([LJ.from_params(*LJ_SHORT, device="cpu")],
                           ts.box, n, mn=MN)
    return jff, js, ff, ts


@pytest.fixture(scope="module")
def runs():
    """Each mode through both runners: {mode: (JAX (state, obs), port
    (state, obs))}."""
    jff, js, ff, ts = bases()
    shape = (P, js.position.shape[0], 3)
    out = {}
    for key, (mode, t1, t2) in MODES.items():
        jr = jpimd.PIMDRunner(ff=jff, base=js, n_beads=P, temperature=t1,
                              coupling=100.0, mode=mode)
        jst = jr.init(seed=SEED)
        jst, jobs = jr.run(jst, DT, STEPS, t_end=t2)
        draw = popping(normals(n_draws(mode, STEPS), shape, SEED))
        tr = tpimd.PIMDRunner(ff=ff, base=ts, n_beads=P, temperature=t1,
                              coupling=100.0, mode=mode, draw=draw)
        tst = tr.init(seed=SEED)
        tst, tobs = tr.run(tst, DT, STEPS, t_end=t2)
        assert not draw.queue
        out[key] = ((jst, jobs), (tst, tobs))
    return out


def _close(got, want, tol, what):
    got, want = np64(got), np64(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("p", range(1, 9))
def test_transformation_matrix_matches_jax(p):
    np.testing.assert_array_equal(tpimd.transformation_matrix(p),
                                  jpimd.transformation_matrix(p))
    c = tpimd.transformation_matrix(p)
    # orthogonal for one bead and even P; for odd P > 1 the k == P // 2
    # column takes the alternating branch in both packages (ROADMAP queue
    # 3), and the port keeps it
    orthogonal = np.allclose(c @ c.T, np.eye(p), atol=1e-14)
    assert orthogonal == (p == 1 or p % 2 == 0), p


@pytest.mark.parametrize("key", list(MODES))
def test_runner_matches_jax(runs, key):
    (jst, jobs), (tst, tobs) = runs[key]
    dx = np.abs(np64(tst.position) - np64(jst.position)).max()
    assert dx <= 1e-9, (key, "position", dx)
    dv = np.abs(np64(tst.velocity) - np64(jst.velocity)).max()
    assert dv / TIME_UNIT_CONVERSION <= 1e-9, (key, "velocity", dv)
    _close(tst.force, jst.force, 1e-9, (key, "force"))
    _close(tst.potential, jst.potential, 1e-9, (key, "potential"))
    for name in ("t_beads", "pe"):
        assert tobs[name].shape == (STEPS,)
        _close(tobs[name], jobs[name], 1e-9, (key, name))
    # the beads spread: a ring polymer, not P copies
    spread = np64(tst.position).std(axis=0).max()
    assert spread > 1e-4, (key, spread)


def test_ramp_changes_the_run(runs):
    """The port's pimd without the ramp, on the same draws, ends apart
    from the ramped run."""
    _, _, ff, ts = bases()
    draw = popping(normals(n_draws("pimd", STEPS), (P, ts.position.shape[0],
                                                     3), SEED))
    tr = tpimd.PIMDRunner(ff=ff, base=ts, n_beads=P, temperature=40.0,
                          coupling=100.0, draw=draw)
    plain, _ = tr.run(tr.init(seed=SEED), DT, STEPS)
    ramped = runs["pimd_ramp"][1][0]
    assert np.abs(np64(plain.position) - np64(ramped.position)).max() > 1e-6


def test_one_bead_rpmd_is_velocity_verlet():
    _, _, ff, ts = bases()
    with torch.no_grad():
        ts = ff.compute(ts)
    runner = tpimd.PIMDRunner(ff=ff, base=ts, n_beads=1, temperature=40.0,
                              coupling=100.0, mode="rpmd")
    runner.init(seed=SEED)  # seeds the runner; the start is set below
    st = tpimd.PIMDState(position=ts.position[None].clone(),
                         velocity=ts.velocity[None].clone(),
                         force=ts.force[None].clone(),
                         potential=ts.potential_energy[None].clone(),
                         max_count=torch.zeros((), dtype=torch.int64))
    st, _ = runner.run(st, DT, 20)
    final, _, _ = md_run(ts, ff, NVE(), DT, 20)
    dx = ts.box.minimum_image(st.position[0] - final.position)
    assert float(dx.abs().max()) <= 1e-12
    assert float((st.velocity[0] - final.velocity).abs().max()) <= 1e-12 \
        * float(final.velocity.abs().max())


# ---- the app ---------------------------------------------------------------

PIMD_DECK = """potential lj.txt
time_step 2
ensemble pimd 4 60 60 100
dump_beads 5 1 1
run 20
"""


def read_beads(path):
    """(header lines, numeric columns) of a beads_dump file."""
    headers, rows = [], []
    for line in Path(path).read_text().splitlines():
        toks = line.split()
        if len(toks) == 1 or line.startswith("Time="):
            headers.append(line)
        else:
            rows.append([float(x) for x in toks[1:]])
    return headers, np.array(rows)


def write_short(d, cells=CELLS):
    """write_slabs' argon with LJ_SHORT as lj.txt."""
    write_slabs(d, cells=cells)
    (d / "lj.txt").write_text("lj 1 Ar\n{} {} {}\n".format(*LJ_SHORT))


def test_pimd_deck_with_dump_beads_matches_jax(tmp_path):
    n = 4 * int(np.prod(CELLS))
    draw = popping(normals(n_draws("pimd", 20), (4, n, 3), SEED))
    patched = functools.partial(tpimd.PIMDRunner, draw=draw)
    dirs, js, ts = deck_pair(tmp_path, PIMD_DECK,
                             patches=[("PIMDRunner", patched)],
                             make=write_short)
    assert not draw.queue
    names = {p.name for p in dirs["jax"].iterdir()}
    assert {p.name for p in dirs["torch"].iterdir()} == names
    beads = sorted(x for x in names if x.startswith("beads_dump_"))
    assert beads == [f"beads_dump_{k}.xyz" for k in range(4)]
    for name in beads:
        jh, jrows = read_beads(dirs["jax"] / name)
        th, trows = read_beads(dirs["torch"] / name)
        assert th == jh and len(jh) == 8  # 4 frames
        assert trows.shape == jrows.shape == (4 * n, 9)
        err = (np.abs(trows - jrows).max(axis=0)
               / np.abs(jrows).max(axis=0)).max()
        assert err <= 1e-8, (name, err)
    assert ts.global_step == js.global_step == 20
    np.testing.assert_allclose(np64(ts.state.position),
                               np.asarray(js.state.position), atol=1e-9)
    np.testing.assert_allclose(ts._pimd_obs["t_beads"][-5:],
                               np.asarray(js._pimd_obs["t_beads"]),
                               rtol=1e-9)


def _port_session(d, deck, **kw):
    write_short(d)
    (d / "run.in").write_text(deck)
    s = tapp.Session(str(d), quiet=True, device="cpu", dtype=torch.float64,
                     **kw)
    s.execute()
    return s


def test_ramped_pimd_ramps_across_dump_chunks(tmp_path, monkeypatch):
    """The app's ramped pimd with dump_beads every 5 steps equals the
    runner driven in one block over the run (the ramp is the run's, not a
    chunk's)."""
    n = 4 * int(np.prod(CELLS))
    draws = normals(n_draws("pimd", 20), (2, n, 3), SEED)
    monkeypatch.setattr(tapp, "PIMDRunner", functools.partial(
        tpimd.PIMDRunner, draw=popping(draws)))
    s = _port_session(tmp_path / "app", "potential lj.txt\ntime_step 2\n"
                      "ensemble pimd 2 40 120 100\ndump_beads 5 0 0\n"
                      "run 20\n")
    base = _port_session(tmp_path / "ref", "potential lj.txt\n").state
    runner = tpimd.PIMDRunner(ff=s.ff, base=base, n_beads=2,
                              temperature=40.0, coupling=100.0,
                              draw=popping(draws))
    st, obs = runner.run(runner.init(SEED), s.dt, 20, t_end=120.0)
    np.testing.assert_allclose(np64(s.state.position),
                               np64(runner.centroid(st).position),
                               atol=1e-12)
    np.testing.assert_allclose(s._pimd_obs["t_beads"], np64(obs["t_beads"]),
                               rtol=1e-12)
    headers, rows = read_beads(tmp_path / "app" / "beads_dump_1.xyz")
    assert rows.shape == (4 * n, 3) and "Properties=species:S:1:pos:R:3" \
        in headers[1]


def test_dump_beads_interval_must_divide_the_run(tmp_path):
    with pytest.raises(ValueError, match="does not divide"):
        _port_session(tmp_path, "potential lj.txt\nensemble pimd 2 40 40 "
                      "100\ndump_beads 3 0 0\nrun 10\n")


def test_engine_dense_runs_the_path_integrals(tmp_path):
    s = _port_session(tmp_path, "potential lj.txt\nengine dense\n"
                      "ensemble trpmd 2\nrun 4\n")
    assert s.route_reason == "path integrals" and s.md is None
    assert s._pimd_obs["t_beads"].shape == (4,) and s.global_step == 4


@pytest.mark.parametrize("line, t", [("velocity 77\n", 77.0), ("", 300.0)])
def test_rpmd_takes_the_last_velocity_temperature(tmp_path, line, t):
    write_short(tmp_path)
    (tmp_path / "run.in").write_text(f"potential lj.txt\n{line}"
                                     "ensemble rpmd 3\n")
    s = tapp.Session(str(tmp_path), quiet=True, device="cpu")
    s.execute()
    assert s.ensemble == ("rpmd", 3, t, 100.0, t)


def test_capacity_check_raises_inside_a_deformed_run(tmp_path, monkeypatch):
    """An LJ deck whose box deform shrinks along x: the start's rows fit
    the capacity (its deepest row plus 4), a rebuild inside the run
    outgrows it, and the chunk's end raises naming the step."""
    d = tmp_path / "deform"
    write_slabs(d, cells=(4, 2, 2))
    s0 = tapp.Session(str(d), quiet=True, device="cpu")
    s0.kw_potential(["lj.txt"])
    st = s0.state
    nbr = s0.ff.neighbor.build(st.box.wrap(st.position), st.box, st.mask)
    cap = int(nbr.count.max()) + 4
    monkeypatch.setattr(tapp, "_auto_mn", lambda *a, **k: cap)
    (d / "run.in").write_text("potential lj.txt\ntime_step 1\n"
                              "deform -0.05 1 0 0\ndump_thermo 10\n"
                              "run 200\n")
    s = tapp.Session(str(d), quiet=True, device="cpu")
    with pytest.raises(RuntimeError, match=r"neighbor overflow by step "
                       r"\d+: an atom has \d+ neighbors but the list "
                       rf"capacity is {cap + (cap & 1)}"):
        s.execute()
    assert 0 < s.global_step < 200


def test_cell_bins_grow_with_the_fullest_cell():
    """A cell holding more atoms than the plan's cell_cap (a compressed
    region): the plan's own cell list flags an overflow (every count MN +
    1), and NeighborConfig.build, whose bins hold the fullest cell, gives
    brute force's neighbours row for row."""
    from gpumd_tpu_torch.forcefield import NeighborConfig
    from gpumd_tpu_torch.neighbor.neighbor import (
        neighbor_brute,
        neighbor_cell_dense,
    )

    pos, _, lengths, _ = argon((6, 6, 6), temperature=40.0)
    # 24 atoms squeezed into a 2 A cube: one cell far past the cap of 8
    pos[:24] = 20.0 + np.random.default_rng(2).uniform(0.0, 2.0, (24, 3))
    box = Box.orthogonal(lengths, device="cpu")
    p = box.wrap(torch.as_tensor(pos))
    mask = torch.ones(len(pos), dtype=torch.float64)
    cfg = NeighborConfig(rc=6.0, mn=160, method="cell", grid=(5, 5, 5),
                         cell_cap=8)
    plain = neighbor_cell_dense(p, box, mask, rc=6.0, mn=160, grid=(5, 5, 5),
                                cell_cap=8)
    assert bool((plain.count == 161).all())
    got = cfg.build(p, box, mask)
    want = neighbor_brute(p, box, mask, rc=6.0, mn=160, reps=(0, 0, 0))
    torch.testing.assert_close(got.count, want.count)
    assert int(got.count.max()) <= 160
    for i in range(len(pos)):
        c = int(want.count[i])
        assert sorted(got.idx[i, :c].tolist()) == sorted(
            want.idx[i, :c].tolist()), i
