"""The port's `gpumd` app (gpumd_tpu_torch/app/gpumd.py) against the JAX
app on the CPU, on the list path.

LJ argon: a 36-atom model.xyz (3 x 3 x 1 fcc cells, jittered, with
velocities and two grouping methods) replicated to 108 atoms, one deck a
ensemble (nve, nvt_ber, nvt_nhc, nvt_bdp, npt_ber, npt_scr) with every
ported dump keyword, correct_velocity and fix, 20 steps of 2 fs.  Each
output file is compared with the JAX app's: the header and row count
exactly, positions within 1e-4 A, thermo columns within 1e-5 of each
column's largest magnitude (1e-4 for the six stress columns, whose shear
parts sit near zero), velocities within 1e-4 and forces within 3e-4 of
the column's largest magnitude (FORCE_TOL).  The port runs float32, the
JAX app float64 (the suite's x64).  The two packages draw different
random streams, so the decks start from model.xyz's velocities (no
`velocity` keyword), and the stochastic ensembles get JAX's own draws:
the test recomputes them with JAX's key sequence and injects them into
the port.  The JAX sessions run once a module (module fixture).
"""

import functools
import shutil
from pathlib import Path

import numpy as np
import pytest

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.app import gpumd as japp
from gpumd_tpu.io.xyz import XYZFrame, read_xyz_frames, write_xyz
from gpumd_tpu.units import K_B, TIME_UNIT_CONVERSION
from torch_jax_draws import (
    FixedDraws,
    jax_bdp_draws,
    jax_half_kick_draws,
    popping_draw,
)
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
A0 = 5.26
ENSEMBLES = {
    "nve": "nve",
    "nvt_ber": "nvt_ber 60 60 100",
    "nvt_nhc": "nvt_nhc 60 60 100",
    "nvt_bdp": "nvt_bdp 60 60 100",
    "npt_ber": "npt_ber 60 60 100 0 40 1000",
    "npt_scr": "npt_scr 60 60 100 0 0 0 40 40 40 1000",
}
BLOCK = """dump_thermo 5
dump_position 10
dump_velocity 10
dump_force 10
dump_exyz 10 1 1
dump_xyz 1 2 10 grp.xyz velocity force potential unwrapped_position
dump_restart 20
correct_velocity 5
run 20
"""
# An argon force is a sum of ~130 pair terms that cancel to ~1% of their
# size, so float32 keeps ~5 digits of it: 3e-4 of the largest force
FORCE_TOL = 3e-4
FILES = ("thermo.out", "movie.xyz", "dump.xyz", "grp.xyz", "velocity.out",
         "force.out", "restart.xyz", "neighbor.out")


def write_argon(d: Path, cells=(3, 3, 1), seed=1, temperature=60.0):
    """fcc argon with jitter, velocities at `temperature` (A/fs, no net
    momentum) and two grouping methods (x < a0; atom index mod 3); the repo's LJ line."""
    d.mkdir(parents=True, exist_ok=True)
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    grid = np.array([[i, j, k] for i in range(cells[0])
                     for j in range(cells[1]) for k in range(cells[2])])
    pos = (grid[:, None, :] + base[None]).reshape(-1, 3) * A0
    n = len(pos)
    rng = np.random.default_rng(seed)
    vel = rng.normal(0.0, np.sqrt(K_B * temperature / 39.948), (n, 3))
    vel -= vel.mean(axis=0)  # no net momentum
    groups = np.stack([(pos[:, 0] < A0).astype(int), np.arange(n) % 3], 1)
    frame = XYZFrame(symbols=["Ar"] * n,
                     positions=pos + rng.normal(0.0, 0.02, pos.shape),
                     lattice=np.diag(np.asarray(cells, float) * A0),
                     pbc=(True, True, True),
                     velocities=vel / TIME_UNIT_CONVERSION, groups=groups)
    write_xyz(str(d / "model.xyz"), frame, with_velocities=True,
              with_groups=True)
    (d / "lj.txt").write_text("lj 1 Ar\n1.032e-2 3.405 9.0\n")
    return n


def run_pair(tmp: Path, name: str, deck: str, make=write_argon,
             patches=()):
    """The same deck in two directories, the JAX app's then the port's;
    `patches` (attribute, value) apply to the port's app module."""
    dirs = {}
    for pkg in ("jax", "torch"):
        d = tmp / f"{name}_{pkg}"
        shutil.rmtree(d, ignore_errors=True)
        make(d)
        (d / "run.in").write_text(deck)
        dirs[pkg] = d
    js = japp.Session(str(dirs["jax"]), quiet=True)
    js.execute()
    with pytest.MonkeyPatch.context() as mp:
        for attr, value in patches:
            mp.setattr(tapp, attr, value)
        ts = tapp.Session(str(dirs["torch"]), quiet=True, device="cpu")
        ts.execute()
    return dirs, js, ts


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """Each ensemble's deck through both apps."""
    tmp = tmp_path_factory.mktemp("app")
    out = {}
    for name, line in ENSEMBLES.items():
        deck = ("replicate 1 1 3\npotential lj.txt\ntime_step 2\nfix 0 1\n"
                f"ensemble {line}\n{BLOCK}")
        patches = ()
        if name in ("nvt_bdp", "npt_scr"):
            cls = tapp.NVTBDP if name == "nvt_bdp" else tapp.NPTSCR
            draws = jax_bdp_draws(20, 3 * 108, name == "npt_scr")
            patches = ((cls.__name__, functools.partial(
                cls, generator=FixedDraws(draws))),)
        out[name] = run_pair(tmp, name, deck, patches=patches)
    return out


def _numeric_rows(path: Path):
    return np.atleast_2d(np.loadtxt(path, comments="#"))


def _header(path: Path):
    return [ln for ln in path.read_text().splitlines() if ln.startswith("#")]


def _close(got, want, tol, what):
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    worst = (np.abs(got - want).max(axis=0) / scale).max()
    assert worst <= tol, (what, worst)


@pytest.mark.parametrize("fname", FILES)
@pytest.mark.parametrize("ens", list(ENSEMBLES))
def test_outputs_match_jax(decks, ens, fname):
    dirs, js, ts = decks[ens]
    got, want = dirs["torch"] / fname, dirs["jax"] / fname
    assert got.exists() and want.exists()
    assert ts.global_step == js.global_step == 20
    assert ts.route_reason.startswith("CPU device")
    if fname == "neighbor.out":
        assert got.read_text() == want.read_text()
    elif fname.endswith(".out"):
        assert _header(got) == _header(want)
        a, b = _numeric_rows(got), _numeric_rows(want)
        assert a.shape == b.shape and a.shape[0] == {
            "thermo.out": 4, "velocity.out": 2 * 108,
            "force.out": 2 * 108}[fname]
        if fname == "thermo.out":
            _close(a[:, :3], b[:, :3], 1e-5, "T KE PE")
            _close(a[:, 3:9], b[:, 3:9], 1e-4, "stress")
            _close(a[:, 9:], b[:, 9:], 1e-5, "box")
        else:
            _close(a, b, FORCE_TOL if fname == "force.out" else 1e-4, fname)
    else:
        fa, fb = read_xyz_frames(str(got)), read_xyz_frames(str(want))
        assert len(fa) == len(fb) == {"movie.xyz": 2, "dump.xyz": 2,
                                      "grp.xyz": 2, "restart.xyz": 1}[fname]
        for a, b in zip(fa, fb):
            assert a.symbols == b.symbols
            assert sorted(a.arrays) == sorted(b.arrays)
            np.testing.assert_allclose(a.lattice, b.lattice, rtol=1e-6)
            d = a.positions - b.positions
            d -= np.round(d / np.diag(b.lattice)) * np.diag(b.lattice)
            assert np.abs(d).max() <= 1e-4
            for key in a.arrays:
                if key in ("pos", "species"):
                    continue
                _close(np.atleast_2d(a.arrays[key].T).T,
                       np.atleast_2d(b.arrays[key].T).T,
                       FORCE_TOL if key.startswith("force") else 1e-4, key)


def test_fix_freezes_the_group(decks):
    """fix 0 1: the atoms of group 1 (x < a0) keep their positions."""
    dirs, js, ts = decks["nve"]
    first = read_xyz_frames(str(dirs["torch"] / "movie.xyz"))
    grp = np.asarray(ts.groups.labels[:108, 0]) == 1
    v = np.loadtxt(dirs["torch"] / "velocity.out")[:108]
    assert grp.sum() > 0 and np.abs(v[grp]).max() == 0.0
    assert np.abs(v[~grp]).max() > 0.0 and len(first) == 2


def test_two_runs_and_restart(tmp_path):
    """Two run blocks in one deck, NVE then Langevin (JAX's draws
    injected), with dump_restart (JAX tests/test_app_gpumd.py:62)."""
    n = 32
    deck = ("potential lj.txt\ntime_step 5\nensemble nve\ndump_restart 10\n"
            "run 10\nensemble nvt_lan 50 50 50\ndump_restart 10\nrun 20\n")
    draw = popping_draw(jax_half_kick_draws(2 * 20, (n, 3)))
    dirs, js, ts = run_pair(
        tmp_path, "two", deck,
        make=functools.partial(write_argon, cells=(2, 2, 2), temperature=30),
        patches=(("NVTLangevin", functools.partial(tapp.NVTLangevin,
                                                   draw=draw)),))
    assert ts.global_step == js.global_step == 30 and not draw.queue
    (a,), (b,) = (read_xyz_frames(str(dirs[k] / "restart.xyz"))
                  for k in ("torch", "jax"))
    assert a.velocities is not None and a.masses is not None
    np.testing.assert_allclose(a.positions, b.positions, rtol=0, atol=1e-4)
    _close(a.velocities, b.velocities, 1e-4, "velocities")


def test_parse_run_in_matches_jax():
    for d in sorted((ROOT / "examples").glob("0[123]_*")):
        path = str(d / "run.in")
        assert tapp.parse_run_in(path) == japp.parse_run_in(path), d


def _deck_dir(tmp_path, run_in, extra=None):
    write_argon(tmp_path)
    (tmp_path / "run.in").write_text(run_in)
    for name, text in (extra or {}).items():
        (tmp_path / name).write_text(text)
    return tmp_path


def test_unknown_keyword_raises_value_error(tmp_path):
    d = _deck_dir(tmp_path, "potential lj.txt\nfrobnicate 3\n")
    with pytest.raises(ValueError, match="frobnicate"):
        tapp.Session(str(d), quiet=True, device="cpu").execute()


@pytest.mark.parametrize("example, item", [
    ("potential lj.txt\nminimize sd 1e-6 100\nrun 10\n", 10),
    ("potential lj.txt\nmc canonical 10 10 300 300\nrun 10\n", 10),
    ("potential lj.txt\ncompute_lsqt x 10 100 -5 5 6\nrun 10\n", 8)])
def test_unported_keywords_name_their_item(tmp_path, example, item):
    """The keywords ROADMAP queue 1 items 8 (`compute_lsqt`) and 10
    (`minimize`, `mc`) ported run their decks to the end, and so does
    each deck under item 11's `engine auto 2` (the several-device engine
    parses; on the CPU auto takes the list path for these LJ decks, and
    tests/test_torch_sharded_app.py runs `engine dense N` decks); no
    keyword is left to raise (every potential header is ported: a `dp`
    file without deepmd-kit raises its RuntimeError,
    tests/test_torch_fcp_dp.py)."""
    assert item in (8, 10) and not tapp.UNPORTED
    d = _deck_dir(tmp_path, example, {"dp.txt": "dp 1 Si\n"})
    s = tapp.Session(str(d), quiet=True, device="cpu")
    s.execute()
    assert s.global_step == 10
    d = _deck_dir(tmp_path / "sharded", "engine auto 2\n" + example)
    s = tapp.Session(str(d), quiet=True, device="cpu")
    s.execute()
    assert s.global_step == 10 and s.engine_devices == 2


def test_every_jax_keyword_is_ported_or_raises():
    """The JAX app's 62 keywords: all 62 ported (the LSQT solver, item 8;
    minimize, mc and compute_phonon, item 10, the last), so no keyword is
    left to raise with its item."""
    jk, tk = set(japp.Session.KEYWORDS), set(tapp.Session.KEYWORDS)
    assert len(jk) == 62 and len(tk) == 62 and tk == jk
    assert set(tapp.UNPORTED) == jk - tk == set()
    assert {"dftd3", "kspace", "compute_dpdt", "compute_es",
            "dump_observer", "active", "plumed", "deposit", "compute_lsqt",
            "minimize", "mc", "compute_phonon"} <= tk


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="a card is present")
def test_refuses_without_a_card(tmp_path):
    d = _deck_dir(tmp_path, "potential lj.txt\nrun 1\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main([str(d)])
    assert not (d / "neighbor.out").exists()
