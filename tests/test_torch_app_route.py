"""The port's `engine auto` route and its compact-engine runs through the
app, on the CPU.

`dense_route_reason(session, ens, "cuda")` is asked on the CPU, with
nothing launched: a NEP or Tersoff-1989 deck under each of the compact
engine's ensembles goes to the compact engine; LJ, drivers, fix, move
and a box under 3 cells an axis go to the list path with their reason,
HNEMDEC too (a second potential raises at its keyword: not ported); on
the CPU device every deck takes the list path.  Then decks run under `engine dense` (the port's compact engine on
its kernels' plain versions) against the JAX app's `engine list` (the
JAX package holds its list path against its compact engine in its own
tests; its compact engine on the CPU runs the Pallas kernels in
interpret mode, minutes a deck): NEP PbTe 216 atoms with a narrow random
NEP (cutoffs 5/4 A, 3 cells of rc + skin an axis) under npt_ber, and the
same under nve with compute_hnemd, compute_shc and compute_hac; Tersoff
Si 216 atoms under nvt_ber.  After 20 steps: positions within 1e-4 A,
energies within 1e-5 eV/atom, the box within 1e-5 relative, kappa.out,
shc.out and hac.out within 1e-4 of each column's largest magnitude.  The
Tersoff deck off the compact engine, which raised until the list path
had a Tersoff force, runs under `engine list` and `engine auto` within
1e-4 A of the JAX app's list path, and a heat-bath Tersoff deck takes
the list path.  Each ensemble the compact engine does not integrate (the heat baths, MTTK, NPHug, QTB, MSST, the walls,
TTM, the TI family) and `deform` take the list path on the card with
their reason, and `engine dense` refuses each ensemble by name before
any step (ROADMAP queue 3, item 14).
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.app import gpumd as japp
from gpumd_tpu.io.xyz import XYZFrame, read_xyz_frames, write_xyz
from gpumd_tpu.units import K_B, TIME_UNIT_CONVERSION
from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.integrate.ensembles import npt as tnpt
from gpumd_tpu_torch.integrate.ensembles import nve as tnve
from gpumd_tpu_torch.integrate.ensembles import nvt as tnvt
from gpumd_tpu_torch.io.nep_input import NepTrainConfig, model_from_config
from gpumd_tpu_torch.potentials.nep.params import num_trainable, write_nep_txt
from gpumd_tpu_torch.potentials.tersoff import SI_TERSOFF
from test_torch_app_gpumd import write_argon
from torch_one_thread import one_torch_thread  # noqa: F401

DENSE = [tnve.NVE(), tnvt.NVTBerendsen(), tnvt.NVTLangevin(), tnvt.NVTBDP(),
         tnvt.NVTBAOAB(), tnvt.NVTNoseHooverChain(), tnpt.NPTBerendsen(),
         tnpt.NPTSCR()]


def write_nep(path):
    """A narrow random NEP4 of Te Pb, cutoffs 5 / 4 A."""
    cfg = NepTrainConfig(num_types=2, symbols=("Te", "Pb"), rc_radial=5.0,
                         rc_angular=4.0, n_max_radial=3, n_max_angular=3,
                         basis_size_radial=3, basis_size_angular=3,
                         neurons=8)
    model = model_from_config(cfg)
    rng = np.random.default_rng(4)
    write_nep_txt(str(path), model, rng.normal(0, 0.3, num_trainable(model)),
                  rng.uniform(0.5, 2.0, model.dim))


def _write(d, symbols, pos, mass, edge, temperature, seed):
    rng = np.random.default_rng(seed)
    n = len(pos)
    v = rng.normal(size=(n, 3)) * np.sqrt(K_B * temperature / mass)[:, None]
    v -= (mass[:, None] * v).sum(0) / mass.sum()
    d.mkdir(parents=True, exist_ok=True)
    groups = (pos[:, :1] < edge / 3).astype(int)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=symbols, positions=pos + rng.normal(0, 0.05, pos.shape),
        lattice=np.eye(3) * edge, pbc=(True, True, True),
        velocities=v / TIME_UNIT_CONVERSION, groups=groups),
        with_velocities=True, with_groups=True)


FCC = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])


def write_pbte(d: Path, nc=3, a0=6.46):
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    te = (cells[:, None] + FCC[None]).reshape(-1, 3) * a0
    pos = np.concatenate([te, te + [0.5 * a0, 0, 0]])
    symbols = ["Te"] * len(te) + ["Pb"] * len(te)
    mass = np.where(np.array(symbols) == "Pb", 207.2, 127.6)
    _write(d, symbols, pos, mass, nc * a0, 300.0, 2)
    write_nep(d / "nep.txt")


def write_si(d: Path, nc=3, a0=5.431):
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    base = np.concatenate([FCC, FCC + 0.25])
    pos = (cells[:, None] + base[None]).reshape(-1, 3) * a0
    _write(d, ["Si"] * len(pos), pos, np.full(len(pos), 28.085), nc * a0,
           300.0, 2)
    (d / "si.txt").write_text(SI_TERSOFF)


def _session(tmp_path, make, deck):
    make(tmp_path)
    (tmp_path / "run.in").write_text(deck)
    s = tapp.Session(str(tmp_path), quiet=True, device="cpu")
    s.execute()
    return s


@pytest.fixture
def no_launches():
    cuda_build.reset_launches()
    yield
    assert not any(cuda_build.launches.values())


@pytest.mark.parametrize("make, pot", [(write_pbte, "nep.txt"),
                                       (write_si, "si.txt")],
                         ids=["nep", "tersoff"])
def test_compact_route_on_the_card(tmp_path, make, pot, no_launches):
    s = _session(tmp_path, make, f"potential {pot}\n")
    for ens in DENSE:
        assert tapp.dense_route_reason(s, ens, "cuda") is None, ens
        assert tapp.dense_route_reason(s, ens, "cpu").startswith(
            "CPU device")


@pytest.mark.parametrize("deck, reason", [
    ("add_force 0 0 0.01 0 0\n", "drivers"),
    ("add_random_force 0.01\n", "drivers"),
    ("fix 0 1\n", "fix groups"),
    ("move 0 1 0.001 0 0\n", "move groups"),
])
def test_list_route_reasons(tmp_path, deck, reason, no_launches):
    s = _session(tmp_path, write_pbte, "potential nep.txt\n" + deck)
    assert reason in tapp.dense_route_reason(s, tnve.NVE(), "cuda")


def test_list_route_for_lj_hnemdec_two_potentials_thin_box(tmp_path,
                                                           no_launches):
    lj = _session(tmp_path / "lj", write_argon, "potential lj.txt\n")
    assert "potential LJ has no compact engine" in tapp.dense_route_reason(
        lj, tnve.NVE(), "cuda")
    thin = _session(tmp_path / "thin", lambda d: write_pbte(d, nc=2),
                    "potential nep.txt\n")
    assert "box too thin" in tapp.dense_route_reason(thin, tnve.NVE(),
                                                     "cuda")
    hnemdec = _session(tmp_path / "hnemdec", write_pbte,
                       "potential nep.txt\ncompute_hnemdec 1 1 1e-4 0 0\n")
    assert tapp.dense_route_reason(hnemdec, tnve.NVE(),
                                   "cuda") == "compute_hnemdec"
    # a second potential line (dump_observer's observe/average modes,
    # ROADMAP queue 1, item 6) is not ported: its keyword raises before
    # any route is asked
    write_pbte(tmp_path / "two")
    (tmp_path / "two" / "run.in").write_text("potential nep.txt\n" * 2)
    with pytest.raises(NotImplementedError, match="item 6"):
        tapp.Session(str(tmp_path / "two"), quiet=True,
                     device="cpu").execute()


def test_engine_dense_refuses_what_it_cannot_carry(tmp_path):
    write_pbte(tmp_path)
    (tmp_path / "run.in").write_text(
        "potential nep.txt\nengine dense\nfix 0 1\nrun 2\n")
    with pytest.raises(ValueError, match="fix groups"):
        tapp.Session(str(tmp_path), quiet=True, device="cpu").execute()
    (tmp_path / "run.in").write_text("potential nep.txt\nengine dense 2\n")
    with pytest.raises(NotImplementedError, match="item 11"):
        tapp.Session(str(tmp_path), quiet=True, device="cpu").execute()


DECKS = {
    "nep_npt": (write_pbte, "potential nep.txt\ntime_step 1\n"
                "ensemble npt_ber 300 300 100 0 40 1000\nENGINE\n"
                "dump_thermo 5\ndump_position 20\ndump_restart 20\nrun 20\n"),
    "nep_hnemd": (write_pbte, "potential nep.txt\ntime_step 1\n"
                  "ensemble nve\nENGINE\ndump_thermo 5\ndump_position 20\n"
                  "compute_hnemd 5 1e-4 0 0\ncompute_shc 2 5 0 10 40\n"
                  "compute_hac 1 10 2\nrun 20\n"),
    "tersoff": (write_si, "potential si.txt\ntime_step 1\n"
                "ensemble nvt_ber 300 300 100\nENGINE\ndump_thermo 5\n"
                "dump_position 20\nrun 20\n"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each deck: the JAX app on its list path, the port on its compact
    engine (plain versions on the CPU)."""
    tmp = tmp_path_factory.mktemp("route")
    out = {}
    for name, (make, deck) in DECKS.items():
        dirs, sessions = {}, {}
        for pkg, engine in (("jax", "engine list"), ("torch", "engine dense")):
            d = tmp / f"{name}_{pkg}"
            shutil.rmtree(d, ignore_errors=True)
            make(d)
            (d / "run.in").write_text(deck.replace("ENGINE", engine))
            dirs[pkg] = d
        sessions["jax"] = japp.Session(str(dirs["jax"]), quiet=True)
        sessions["jax"].execute()
        cuda_build.reset_launches()
        sessions["torch"] = tapp.Session(str(dirs["torch"]), quiet=True,
                                         device="cpu")
        sessions["torch"].execute()
        out[name] = dirs, sessions
    return out


def _rows(path):
    return np.atleast_2d(np.loadtxt(path, comments="#"))


def _col_close(a, b, tol, what):
    assert a.shape == b.shape, what
    worst = (np.abs(a - b).max(0) / np.maximum(np.abs(b).max(0), 1e-30)).max()
    assert worst <= tol, (what, worst)


@pytest.mark.parametrize("name", list(DECKS))
def test_compact_deck_matches_jax(runs, name):
    dirs, ss = runs[name]
    ts, js = ss["torch"], ss["jax"]
    n = ts._n
    assert ts.global_step == js.global_step == 20
    assert ts.route_reason is None and not os.path.exists(
        dirs["torch"] / "neighbor.out")
    a, b = _rows(dirs["torch"] / "thermo.out"), _rows(dirs["jax"] / "thermo.out")
    assert a.shape == b.shape == (4, 18)
    # energies per atom, the box
    assert np.abs(a[:, 1:3] - b[:, 1:3]).max() / n <= 1e-5
    _col_close(a[:, 9:], b[:, 9:], 1e-5, "box")
    fa = read_xyz_frames(str(dirs["torch"] / "movie.xyz"))[-1]
    fb = read_xyz_frames(str(dirs["jax"] / "movie.xyz"))[-1]
    lengths = np.diag(fb.lattice)
    d = fa.positions - fb.positions
    d -= np.round(d / lengths) * lengths
    assert np.abs(d).max() <= 1e-4, np.abs(d).max()
    if name == "nep_npt":
        assert abs(a[-1, 9] - a[0, 9]) > 1e-6  # the barostat moved the box
        assert ts.ff.hnemd_fe is None
    if name == "nep_hnemd":
        for f, shape in (("kappa.out", (4, 5)), ("shc.out", (19, 3)),
                         ("hac.out", (5, 11))):
            got, want = _rows(dirs["torch"] / f), _rows(dirs["jax"] / f)
            assert got.shape == want.shape == shape, f
            _col_close(got, want, 1e-4, f)
        assert ts.ff.hnemd_fe is None  # reset after the run


def test_tersoff_on_the_list_path_raises(runs, tmp_path, no_launches):
    """The Tersoff deck off the compact engine, which raised (ROADMAP queue
    1, item 9) until the list path had a Tersoff force: under `engine
    list` and `engine auto` (on the CPU) it runs, its movie.xyz within
    1e-4 A of the JAX app's list-path run after 20 steps; a heat-bath
    Tersoff deck takes the list path on the card too, with its reason."""
    dirs, ss = runs["tersoff"]
    want = read_xyz_frames(str(dirs["jax"] / "movie.xyz"))[-1]
    lengths = np.diag(want.lattice)
    for engine in ("list", "auto"):
        d = tmp_path / engine
        write_si(d)
        (d / "run.in").write_text(DECKS["tersoff"][1].replace(
            "ENGINE", f"engine {engine}"))
        s = tapp.Session(str(d), quiet=True, device="cpu")
        s.execute()
        assert s.global_step == 20 and s.md is None
        assert s.route_reason.startswith(
            "engine list" if engine == "list" else "CPU device")
        got = read_xyz_frames(str(d / "movie.xyz"))[-1]
        dx = got.positions - want.positions
        dx -= np.round(dx / lengths) * lengths
        assert np.abs(dx).max() <= 1e-4, (engine, np.abs(dx).max())
    s = _session(tmp_path / "heat", write_si, "potential si.txt\n"
                 "ensemble heat_lan 300 100 20 0 1\nrun 2\n")
    assert s.global_step == 2 and s.md is None
    assert tapp.dense_route_reason(s, s.ensemble, "cuda") == \
        "ensemble HeatLangevin"


# the ensembles the compact engine does not integrate (they hold group
# masks in input order or move the cell): each takes the list path under
# `engine auto` on the card, and `engine dense` refuses it by name
LIST_ENSEMBLES = {
    "heat_lan 300 100 20 0 1": "HeatLangevin",
    "heat_nhc 300 100 20 0 1": "HeatNHC",
    "heat_bdp 300 100 20 0 1": "HeatBDP",
    "heat_hybrid nhc lan 300 100 100 20 0 1": "HeatHybrid",
    "nvt_mttk temp 300 300": "MTTK",
    "npt_mttk temp 300 300 iso 0 0": "MTTK",
    "npt_mttk temp 300 300 tri 0 0": "MTTK",
    "npt_mttk temp 300 300 x 0 0 y 0 0 z 0 0": "MTTK",
    "nph_mttk aniso 0 0": "MTTK",
    "nphug x 1 1": "NPHug",
    "nvt_qtb 300 300 100": "NVTQTB",
    "npt_qtb temp 300 300 iso 0 0": "NPTQTB",
    "msst x 1.5": "MSST",
    "wall_piston vp 1 thickness 4": "WallPiston",
    "wall_mirror vp 1": "WallMirror",
    "wall_harmonic vp 1 k 2": "WallHarmonic",
    "ttm 0 1 1e-5 1 1 5 0 100 2 2 2 600": "TTM",
    "heat_ttm 0 1 1e-5 1 1 5 0 100 2 2 2 600": "TTM",
    "ti_spring temp 300 spring Te 1 Pb 1": "TISpring",
    "ti lambda 0.5 temp 300 spring Te 1 Pb 1": "TI",
    "ti_rs temp 300 600 iso 0": "TIRS",
    "ti_as temp 300 press 0 1": "TIAS",
    "ti_liquid temp 300": "TILiquid",
}


@pytest.mark.parametrize("line, cls", LIST_ENSEMBLES.items(),
                         ids=list(LIST_ENSEMBLES))
def test_list_only_ensembles_take_the_list_path(tmp_path, line, cls,
                                                no_launches):
    deck = f"potential nep.txt\ntime_step 1\nensemble {line}\n"
    s = _session(tmp_path, write_pbte, deck)
    assert type(s.ensemble).__name__ == cls
    assert tapp.dense_route_reason(s, s.ensemble, "cuda") == f"ensemble {cls}"
    (tmp_path / "run.in").write_text(deck + "engine dense\nrun 1\n")
    t = tapp.Session(str(tmp_path), quiet=True, device="cpu")
    with pytest.raises(ValueError, match=f"ensemble {cls}"):
        t.execute()
    assert t.global_step == 0


def test_deform_takes_the_list_path(tmp_path, no_launches):
    s = _session(tmp_path, write_pbte,
                 "potential nep.txt\ndeform 0.001 1 1 1\n")
    assert s.deform == (0.001,) * 3
    assert tapp.dense_route_reason(s, tnve.NVE(), "cuda") == "deform run"
