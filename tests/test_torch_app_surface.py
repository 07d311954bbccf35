"""The rest of the port's `gpumd` app surface against the JAX app on the
CPU: several `potential` lines, dump_observer (observe and average),
active, compute_extrapolation, dump_dipole, dump_polarizability,
compute_cohesive, compute_elastic, change_box, deposit, dump_cg,
dump_netcdf and plumed.

The NEP decks run PbTe 216 (3^3 rocksalt cells, a0 6.46 A, 300 K) with
narrow random NEP4 models of Te Pb (cutoffs 5 / 4 A), 10 steps of 1 fs
on the list path; the box tools and the deposition, CG and NetCDF decks
run LJ argon.  The port runs float32, the JAX app float64.  Each output
file is compared with the JAX app's (the TNEP deck's, whose sums cancel
to ~1/100 of their terms, from a float64 session, to 1e-9): row counts
and headers exactly,
thermo-like columns within 1e-4 of each column's largest magnitude
(positions 1e-4 A), gamma and the committee uncertainty within 1e-4 of
their largest.  Then: the observe deck under `engine dense` (the compact
engine on its kernels' plain versions, the observers on its plan and
lists) equals its `engine list` run and counts its compact evaluations;
compute_cohesive on a sheared cell of a crystal gives the curve of the
same crystal's orthogonal cell, where the JAX app's differ (its values
pinned); compute_extrapolation's gamma_high ends the run; plumed raises
"PLUMED not installed!" without libplumed.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.app import gpumd as japp
from gpumd_tpu.io.xyz import XYZFrame, read_xyz_frames, write_xyz
from gpumd_tpu.units import K_B, TIME_UNIT_CONVERSION
from gpumd_tpu_torch.io.nep_input import NepTrainConfig, model_from_config
from gpumd_tpu_torch.potentials.nep.params import num_trainable, write_nep_txt
from test_torch_app_gpumd import write_argon
from test_torch_app_route import write_pbte
from torch_one_thread import one_torch_thread  # noqa: F401

A0 = 5.26
COL_TOL = 1e-4


def write_model(path, seed, model_type=0, rc=(5.0, 4.0)):
    """A narrow random NEP4 of Te Pb (cutoffs `rc`, 5 / 4 A by default):
    energy, dipole (model_type 1) or polarizability (2) heads."""
    cfg = NepTrainConfig(num_types=2, symbols=("Te", "Pb"), rc_radial=rc[0],
                         rc_angular=rc[1], n_max_radial=3, n_max_angular=3,
                         basis_size_radial=3, basis_size_angular=3,
                         neurons=8, model_type=model_type)
    model = model_from_config(cfg)
    rng = np.random.default_rng(seed)
    write_nep_txt(str(path), model, rng.normal(0, 0.3, num_trainable(model)),
                  rng.uniform(0.5, 2.0, model.dim))
    return model


def write_committee(d: Path):
    """PbTe 216 with the route tests' model (nep.txt), a committee member
    (nep_b.txt: the same architecture, other weights), the TNEP models and
    an identity ASI (extrapolation's gamma = max |B|)."""
    write_pbte(d)
    write_model(d / "nep_b.txt", 5)
    write_model(d / "dipole.txt", 6, model_type=1)
    write_model(d / "pol.txt", 7, model_type=2)
    model = model_from_config(NepTrainConfig(
        num_types=2, symbols=("Te", "Pb"), rc_radial=5.0, rc_angular=4.0,
        n_max_radial=3, n_max_angular=3, basis_size_radial=3,
        basis_size_angular=3, neurons=8))
    b = model.neurons * (model.dim + 2)
    eye = " ".join(f"{x:g}" for x in np.eye(b).ravel())
    (d / "asi.txt").write_text(f"Te {b} {b} {eye}\nPb {b} {b} {eye}\n")


def write_slab(d: Path):
    """fcc argon 3 x 3 x 2 cells under 3 cells of vacuum along z, with
    velocities at 40 K: a surface to deposit on."""
    d.mkdir(parents=True, exist_ok=True)
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    grid = np.array([[i, j, k] for i in range(3) for j in range(3)
                     for k in range(2)])
    pos = (grid[:, None, :] + base[None]).reshape(-1, 3) * A0
    rng = np.random.default_rng(3)
    vel = rng.normal(0.0, np.sqrt(K_B * 40.0 / 39.948), pos.shape)
    vel -= vel.mean(0)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar"] * len(pos), positions=pos + rng.normal(0, .02,
                                                              pos.shape),
        lattice=np.diag([3 * A0, 3 * A0, 5 * A0]), pbc=(True, True, True),
        velocities=vel / TIME_UNIT_CONVERSION), with_velocities=True)
    (d / "lj.txt").write_text("lj 1 Ar\n1.032e-2 3.405 9.0\n")


def write_crystal(d: Path, sheared=False):
    """fcc argon 3^3 cells (108 atoms, no velocities), its cell orthogonal
    or written with the rows (L,0,0), (L,L,0), (0,0,L): the same
    lattice."""
    d.mkdir(parents=True, exist_ok=True)
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    grid = np.array([[i, j, k] for i in range(3) for j in range(3)
                     for k in range(3)])
    pos = (grid[:, None, :] + base[None]).reshape(-1, 3) * A0
    L = 3 * A0
    lat = (np.array([[L, 0, 0], [L, L, 0], [0, 0, L]]) if sheared
           else np.eye(3) * L)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar"] * len(pos), positions=pos, lattice=lat,
        pbc=(True, True, True)))
    (d / "lj.txt").write_text("lj 1 Ar\n1.032e-2 3.405 9.0\n")


DECKS = {
    "observe": (write_committee, """potential nep.txt
potential nep_b.txt
time_step 1
ensemble nve
dump_observer observe 5 10 1 1
active 5 1 1 0 0.0
compute_extrapolation asi_file asi.txt gamma_low 0 check_interval 5 dump_interval 5
run 10
"""),
    "average": (write_committee, """potential nep.txt
potential nep_b.txt
dump_observer average 5 10 0 0
time_step 1
ensemble nve
dump_thermo 5
dump_position 10
run 10
"""),
    "tnep": (write_committee, """potential nep.txt
potential dipole.txt
potential pol.txt
time_step 1
ensemble nve
dump_dipole 5
dump_polarizability 5
run 5
"""),
    "box": (write_argon, """replicate 1 1 3
potential lj.txt
compute_cohesive 0.99 1.01 0
compute_cohesive 0.99 1.01 3
compute_elastic 0.01 cubic
change_box 0.3 -0.2 0.1 0.01 0.02 -0.01
time_step 2
ensemble nve
dump_thermo 5
dump_netcdf -1 0 5 1 all.nc
dump_netcdf 1 2 10 0 grp.nc precision single
dump_cg 5 1
run 20
"""),
    "deposit": (write_slab, """potential lj.txt
time_step 2
ensemble nve
deposit 10 2 15.8 18.4 atom 0 1 -0.02
dump_thermo 5
dump_restart 30
run 30
"""),
}
FILES = {
    "observe": ("observer0.out", "observer1.out", "observer0.xyz",
                "observer1.xyz", "active.out", "active.xyz",
                "extrapolation_dump.xyz"),
    "average": ("thermo.out", "movie.xyz"),
    "tnep": ("dipole.out", "polarizability.out"),
    "box": ("cohesive.out", "elastic.out", "thermo.out", "train.xyz"),
    "deposit": ("thermo.out", "restart.xyz"),
}


def _run(d: Path, pkg: str, deck: str, make, dtype=None):
    shutil.rmtree(d, ignore_errors=True)
    make(d)
    (d / "run.in").write_text(deck)
    s = (japp.Session(str(d), quiet=True) if pkg == "jax"
         else tapp.Session(str(d), quiet=True, device="cpu", dtype=dtype))
    s.execute()
    return s


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """Each deck through both apps."""
    tmp = tmp_path_factory.mktemp("surface")
    out = {}
    for name, (make, deck) in DECKS.items():
        # the TNEP sums cancel to ~1/100 of their terms: float64 there
        dtype = torch.float64 if name == "tnep" else None
        out[name] = {pkg: (tmp / f"{name}_{pkg}",
                           _run(tmp / f"{name}_{pkg}", pkg, deck, make,
                                dtype))
                     for pkg in ("jax", "torch")}
    return out


def _rows(path):
    return np.atleast_2d(np.loadtxt(path, comments="#"))


def _col_close(a, b, tol, what):
    assert a.shape == b.shape, (what, a.shape, b.shape)
    worst = (np.abs(a - b).max(0) / np.maximum(np.abs(b).max(0), 1e-30)).max()
    assert worst <= tol, (what, worst)


def _frames_close(pa, pb, what):
    fa, fb = read_xyz_frames(str(pa)), read_xyz_frames(str(pb))
    assert len(fa) == len(fb) > 0, what
    for a, b in zip(fa, fb):
        assert a.symbols == b.symbols, what
        np.testing.assert_allclose(a.lattice, b.lattice, atol=1e-9)
        assert set(a.info) == set(b.info), what
        d = a.positions - b.positions
        d -= np.round(d @ np.linalg.inv(b.lattice)) @ b.lattice
        assert np.abs(d).max() <= 1e-4, (what, np.abs(d).max())
        for k in set(b.arrays) - {"pos", "species"}:
            _col_close(np.atleast_2d(a.arrays[k].T).T,
                       np.atleast_2d(b.arrays[k].T).T, COL_TOL, f"{what} {k}")
        for k in set(b.info) - {"lattice", "properties", "pbc"}:
            x, y = (np.array(v.split(), float) for v in (a.info[k],
                                                          b.info[k]))
            np.testing.assert_allclose(x, y, rtol=COL_TOL,
                                       atol=COL_TOL * np.abs(y).max())


@pytest.mark.parametrize("name, fname", [(n, f) for n in FILES
                                         for f in FILES[n]])
def test_outputs_match_jax(decks, name, fname):
    (dj, _), (dt, _) = decks[name]["jax"], decks[name]["torch"]
    if fname.endswith(".xyz"):
        _frames_close(dt / fname, dj / fname, fname)
        return
    got, want = _rows(dt / fname), _rows(dj / fname)
    assert got.size and got.shape == want.shape, fname
    if fname == "thermo.out":  # stress: 1e-4 of the largest component
        scale = np.abs(want[:, 3:9]).max()
        assert np.abs(got[:, 3:9] - want[:, 3:9]).max() <= COL_TOL * scale
        got, want = np.delete(got, range(3, 9), 1), np.delete(
            want, range(3, 9), 1)
    if fname.startswith("observer"):  # the same for the observer's stress
        scale = np.abs(want[:, 3:9]).max()
        assert np.abs(got[:, 3:9] - want[:, 3:9]).max() <= COL_TOL * scale
        got, want = np.delete(got, range(3, 9), 1), np.delete(
            want, range(3, 9), 1)
    if fname == "elastic.out":  # differences of energies: 1e-3 GPa of C
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.05)
        return
    if name == "tnep":  # both float64
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
        return
    _col_close(got, want, COL_TOL, fname)


def test_surface_runs_as_decks(decks):
    """What the outputs show of each deck: the observers differ, average
    mode averages, the netcdf trajectories equal the JAX app's, the
    deposited atoms are in and the route of each deck."""
    (dj, js), (dt, ts) = decks["observe"]["jax"], decks["observe"]["torch"]
    o0, o1 = _rows(dt / "observer0.out"), _rows(dt / "observer1.out")
    assert o0.shape == (2, 18) and abs(o0[0, 2] - o1[0, 2]) > 1e-3
    assert ts.route_reason.startswith("CPU device")
    assert ts.observer_compact_evals == 0  # the list path
    # average mode drives with both models: its PE is their mean
    (_, _), (da, sa) = decks["average"]["jax"], decks["average"]["torch"]
    assert sa.ff.average and len(sa.ff.potentials) == 2
    # netcdf: AMBER frames of every atom (velocities in A/ps) and of a group
    for name, n_frames in (("all.nc", 4), ("grp.nc", 2)):
        files = [netcdf_file(str(d / name), "r", mmap=False)
                 for d in (decks["box"]["torch"][0], decks["box"]["jax"][0])]
        a, b = files
        assert a.dimensions == b.dimensions
        assert a.variables["coordinates"].shape[0] == n_frames
        for k in b.variables:
            x, y = a.variables[k].data, b.variables[k].data
            if x.dtype.kind in "fd":
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-4)
            else:
                np.testing.assert_array_equal(x, y)
        assert a.variables["coordinates"].data.dtype.itemsize == (
            4 if name == "grp.nc" else 8)
    # deposit: 3 atoms switched on at steps 10, 20 and 30, 72 + 3 rows
    (_, jd), (_, td) = decks["deposit"]["jax"], decks["deposit"]["torch"]
    assert td._n == jd._n == 72 + 3
    assert float(td.state.mask.sum()) == float(jd.state.mask.sum()) == 75
    assert td.route_reason.startswith("CPU device")
    assert tapp._dense_blocker(td, tapp.NVE()) == "deposition source"


def test_observe_deck_on_the_compact_engine(tmp_path):
    """The observe deck under `engine dense` (the kernels' plain versions
    on the CPU): the observers ride the driving model's plan and lists
    (3 compact passes a model: thermo at 5 and 10, exyz at 10) and their
    rows
    and frames equal the deck's `engine list` run; active and the
    extrapolation grade evaluate on the list path and agree too."""
    deck = DECKS["observe"][1]
    runs = {}
    for engine in ("list", "dense"):
        d = tmp_path / engine
        s = _run(d, "torch", deck.replace("ensemble nve",
                                          f"ensemble nve\nengine {engine}"),
                 write_committee)
        runs[engine] = (d, s)
    (dl, sl), (dd, sd) = runs["list"], runs["dense"]
    assert sd.route_reason is None and sd.md is not None
    assert sd.observer_compact_evals == 2 * 3 and sl.observer_compact_evals == 0
    for f in ("observer0.out", "observer1.out", "active.out"):
        got, want = _rows(dd / f), _rows(dl / f)
        scale = np.abs(want[:, 3:9]).max() if f != "active.out" else 1.0
        if f != "active.out":
            assert np.abs(got[:, 3:9] - want[:, 3:9]).max() <= COL_TOL * scale
            got, want = np.delete(got, range(3, 9), 1), np.delete(
                want, range(3, 9), 1)
        _col_close(got, want, COL_TOL, f)
    for f in ("observer0.xyz", "observer1.xyz", "extrapolation_dump.xyz"):
        _frames_close(dd / f, dl / f, f)
    # engine auto on the card takes the compact route in observe mode
    assert tapp.dense_route_reason(sl, tapp.NVE(), "cuda") is None
    sl.observer_mode = "average"
    sl._rebuild_ff()
    assert tapp.dense_route_reason(sl, tapp.NVE(), "cuda") == (
        "2 potentials averaged (the compact engine drives one)")


def test_wider_observer_gets_a_list_at_its_own_cutoff(tmp_path):
    """A committee member whose radial cutoff (7 A) lies past the driving
    model's 5 A + 1 A skin: its observer1.out energy, observer1.xyz forces
    and active.out's uncertainty at the last step equal a pass on a list
    built at its own cutoff (float32, 1e-5 of the largest), which the
    driving model's 6 A list misses by far more.  The JAX app evaluates it
    on that 6 A list (its observer1 energy pinned there)."""
    from gpumd_tpu_torch.forcefield import ForceField

    deck = ("potential nep.txt\npotential nep_w.txt\ntime_step 1\n"
            "ensemble nve\ndump_observer observe 5 10 0 1\n"
            "active 5 0 0 0 0.0\nrun 10\n")

    def make(d):
        write_pbte(d)
        write_model(d / "nep_w.txt", 5, rc=(7.0, 4.0))

    s = _run(tmp_path / "torch", "torch", deck, make)
    n, st = s._n, s.state
    drv, wide = s.observer_models()
    assert s.ff.neighbor.rc == 6.0 and wide.rc == 7.0
    with torch.no_grad():
        ref = ForceField.create([wide], st.box, n, mn=400).compute(st)
        short = ForceField(potentials=(wide,),
                           neighbor=s.ff.neighbor).compute(st)
        f0 = s.ff._evaluate_with(st, drv).force[:n]
    pe_ref = float(ref.potential_energy[:n].double().sum())
    pe_short = float(short.potential_energy[:n].double().sum())
    tol = 1e-5 * abs(pe_ref)
    assert abs(pe_short - pe_ref) > 100 * tol  # the 6 A list misses pairs
    assert abs(_rows(tmp_path / "torch" / "observer1.out")[-1, 2]
               - pe_ref) <= tol
    fr = read_xyz_frames(str(tmp_path / "torch" / "observer1.xyz"))[-1]
    f_ref = ref.force[:n].double().numpy()
    assert np.abs(fr.forces - f_ref).max() <= 1e-5 * np.abs(f_ref).max()
    unc = torch.sqrt(torch.sum(torch.var(torch.stack(
        [f0, ref.force[:n]]).double(), 0, unbiased=False), -1)).max()
    got = _rows(tmp_path / "torch" / "active.out")[-1]
    assert got[0] == 10 and abs(got[1] - float(unc)) <= 1e-5 * float(unc)
    _run(tmp_path / "jax", "jax", deck, make)
    pe_jax = _rows(tmp_path / "jax" / "observer1.out")[-1, 2]
    assert abs(pe_jax - pe_short) <= tol < abs(pe_jax - pe_ref) / 100


def test_cohesive_on_a_sheared_cell(tmp_path):
    """compute_cohesive 0.98 1.02 2 on 108-atom fcc argon written with an
    orthogonal cell and with the rows (L,0,0), (L,L,0), (0,0,L): the port
    gives one curve (1e-5 eV), the JAX app two, which meet at factor 1
    (its lattice vectors scaled against the positions' components)."""
    deck = "potential lj.txt\ncompute_cohesive 0.98 1.02 2\n"
    curves = {}
    for pkg in ("jax", "torch"):
        for sheared in (False, True):
            d = tmp_path / f"{pkg}{int(sheared)}"
            _run(d, pkg, deck, lambda p, s=sheared: write_crystal(p, s))
            curves[pkg, sheared] = _rows(d / "cohesive.out")
    t0, t1 = curves["torch", False], curves["torch", True]
    assert t0.shape == (41, 2)
    np.testing.assert_allclose(t1, t0, rtol=0, atol=1e-5)
    j0, j1 = curves["jax", False], curves["jax", True]
    np.testing.assert_allclose(j0, t0, rtol=0, atol=1e-5)
    mid = 20  # factor 1
    assert abs(j1[mid, 1] - j0[mid, 1]) < 1e-9
    for i in (0, 40):  # factors 0.98 and 1.02: the JAX app's cells differ
        assert abs(j1[i, 1] - j0[i, 1]) > 1e-2, (i, j1[i], j0[i])


def test_extrapolation_gamma_high_ends_the_run(tmp_path):
    deck = ("potential nep.txt\ntime_step 1\ncompute_extrapolation asi_file "
            "asi.txt gamma_high 1e-6 check_interval 5\nrun 10\n")
    for pkg in ("jax", "torch"):
        with pytest.raises(RuntimeError, match="exceeds gamma_high at step 5"):
            _run(tmp_path / pkg, pkg, deck, write_committee)
        frames = read_xyz_frames(str(tmp_path / pkg /
                                     "extrapolation_dump.xyz"))
        assert len(frames) == 2  # the dump_interval's and the abort's
    _frames_close(tmp_path / "torch" / "extrapolation_dump.xyz",
                  tmp_path / "jax" / "extrapolation_dump.xyz", "gamma")


def test_plumed_without_libplumed(tmp_path):
    write_argon(tmp_path)
    (tmp_path / "plumed.dat").write_text("")
    (tmp_path / "run.in").write_text(
        "potential lj.txt\nplumed plumed.dat 1 0\nrun 2\n")
    with pytest.raises(RuntimeError, match="PLUMED not installed!"):
        tapp.Session(str(tmp_path), quiet=True, device="cpu").execute()


def test_native_reader_equals_python_rows(tmp_path, monkeypatch):
    """A 5,000-atom frame with velocities and two group columns: the C++
    rows equal the Python rows; a frame with a bad token falls through to
    the Python rows, which report it."""
    import gpumd_tpu_torch.io.xyz as txyz

    rng = np.random.default_rng(1)
    n = 5000
    write_xyz(str(tmp_path / "big.xyz"), XYZFrame(
        symbols=["Pb", "Te"] * (n // 2), positions=rng.random((n, 3)) * 40,
        lattice=np.eye(3) * 40, pbc=(True, True, False),
        velocities=rng.normal(size=(n, 3)),
        groups=rng.integers(0, 4, (n, 2))), with_velocities=True,
        with_groups=True)
    native = txyz.read_xyz(str(tmp_path / "big.xyz"))
    monkeypatch.setattr(txyz, "NATIVE_MIN_ROWS", 10 ** 9)
    plain = txyz.read_xyz(str(tmp_path / "big.xyz"))
    assert native.symbols == plain.symbols and native.pbc == plain.pbc
    assert set(native.arrays) == set(plain.arrays) == {"pos", "vel", "group"}
    for k, v in plain.arrays.items():
        assert native.arrays[k].dtype == v.dtype
        np.testing.assert_array_equal(native.arrays[k], v)
    monkeypatch.setattr(txyz, "NATIVE_MIN_ROWS", 4096)
    text = (tmp_path / "big.xyz").read_text().splitlines()
    text[100] = text[100].replace(text[100].split()[2], "x1", 1)
    (tmp_path / "bad.xyz").write_text("\n".join(text) + "\n")
    with pytest.raises(ValueError, match="x1"):
        txyz.read_xyz(str(tmp_path / "bad.xyz"))
