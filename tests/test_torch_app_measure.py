"""The measure keywords of the port's `gpumd` app against the JAX app on
the CPU, and their route on the card asked on the CPU.

One two-type LJ deck, the 108-atom Ar/Kr fcc crystal of
tests/test_hnemdec.py with velocities in model.xyz and a grouping method
(x below half the box), goes through both apps with every measure keyword
and compute / compute_chunk (list path, nvt_ber, 20 steps of 2 fs); a
second deck drives HNEMDEC (heat then colour flow) and HNEMA.  Every
output file is compared with the JAX app's as tests/test_torch_app_gpumd.py
does: the header lines exactly, the numbers within TOLS[file] of each
column's largest magnitude, plus one unit of the last printed decimal
for the fixed-point files (g(r): 1e-5, q_l and w_l: 1e-6); neighbor.out
as text.  The port runs float32, the JAX app float64, so after 20 steps
positions differ by ~1e-6 A; read on this deck, most files then agree to
their printed digits (~1e-6 of a column's largest value) and the worst
columns are sums that cancel: the shear stresses and their integrals in
viscosity.out (4.2e-4: shear fluctuations ~1e-2 of the diagonal) and jp
in compute.out (1.1e-4).  The bounds: 1e-4 (the thermo files' scale),
3e-4 for compute.out's group sums of forces, virials and currents
(FORCE_TOL of the app's tests), 1e-3 for viscosity.out and 2e-3 for g(r)
and the angle histograms, where a pair crossing a bin edge moves a count
by one (1.4e-3 of the largest ADF bin here; none crossed).  Then `dense_route_reason(session, ens, "cuda")` on the
CPU: the compact route for the card decks' keywords, JAX's three list-path
reasons for viscosity, HNEMDEC and the Onsager observer, and `compute
virial` running the compact engine with per-atom virials.
"""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.app import gpumd as japp
from gpumd_tpu.io.xyz import XYZFrame, write_xyz
from gpumd_tpu.units import K_B, TIME_UNIT_CONVERSION
from gpumd_tpu_torch.integrate.ensembles import nve as tnve
from gpumd_tpu_torch.model.box import Box
from test_torch_app_route import write_pbte
from test_torch_measure import _split, write_eigenvectors
from torch_one_thread import one_torch_thread  # noqa: F401

A0 = 5.26
MEASURE_DECK = """potential lj.txt
time_step 2
ensemble nvt_ber 60 60 100
compute_msd 5 4
compute_sdc 5 4
compute_dos 5 4 30 num_dos_points 8
compute_ic 5 3 1 1.0
compute_rdf 6.0 30 10
compute_adf 10 30 0.1 4.5
compute_angular_rdf 6.0 10 8 10 0 1
compute_orientorder 10 cutoff 4.5 2 4 6 1 1 1
compute 0 5 10 temperature potential force virial jp jk momentum
compute_chunk 5 2 bin/1d x lower 5.26 temperature density/number density/mass vx fy
compute_viscosity 1 10
compute_gkma 10 1 324 bin_size 4
run 20
"""
DRIVE_DECK = """potential lj.txt
time_step 2
ensemble nvt_ber 60 60 100
compute_hnemdec 0 5 1e-4 0 0
run 10
compute_hnemdec 1 5 1e-4 0 0
run 10
compute_hnema 5 10 1e-4 0 0 1 324 f_bin_size 0.5
run 20
"""
# (relative to the column's largest magnitude, printed resolution)
TOLS = {
    "msd.out": (1e-4, 0), "sdc.out": (1e-4, 0), "dos.out": (1e-4, 0),
    "mvac.out": (1e-4, 0), "ic.out": (1e-4, 0), "heatmode.out": (1e-4, 0),
    "kappamode.out": (1e-4, 0), "onsager.out": (1e-4, 0),
    "compute.out": (3e-4, 0), "compute_chunk.out": (3e-4, 0),
    "viscosity.out": (1e-3, 0), "orientorder.out": (1e-4, 1e-6),
    "rdf.out": (2e-3, 1e-5), "angular_rdf.out": (2e-3, 1e-5),
    "adf.out": (2e-3, 0),
}


def write_binary(d: Path, nc=3, seed=1, temperature=60.0):
    """tests/test_hnemdec.py's Ar/Kr crystal with velocities (no net
    momentum), a grouping method and eigenvector.in (random modes)."""
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    pos = (cells[:, None] + base[None]).reshape(-1, 3) * A0
    n = len(pos)
    sym = (["Ar", "Kr"] * (n // 2 + 1))[:n]
    mass = np.where(np.array(sym) == "Ar", 39.948, 83.798)
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)) * np.sqrt(K_B * temperature / mass)[:, None]
    v -= (mass[:, None] * v).sum(0) / mass.sum()
    d.mkdir(parents=True, exist_ok=True)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=sym, positions=pos + rng.normal(0, 0.05, pos.shape),
        lattice=np.diag([nc * A0] * 3), pbc=(True, True, True),
        velocities=v / TIME_UNIT_CONVERSION,
        groups=(pos[:, :1] < nc * A0 / 2).astype(int)),
        with_velocities=True, with_groups=True)
    (d / "lj.txt").write_text(
        "lj 2 Ar Kr\n"
        "1.032e-2 3.405 9.0\n1.2e-2 3.5 9.0\n1.2e-2 3.5 9.0\n1.4e-2 3.6 9.0\n")
    write_eigenvectors(d / "eigenvector.in", n, identity=False)


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """Both decks through both apps: {deck: (dirs, jax session, port
    session)}."""
    tmp = tmp_path_factory.mktemp("measure")
    out = {}
    for name, deck in (("measure", MEASURE_DECK), ("drive", DRIVE_DECK)):
        dirs = {}
        for pkg in ("jax", "torch"):
            d = tmp / f"{name}_{pkg}"
            shutil.rmtree(d, ignore_errors=True)
            write_binary(d)
            (d / "run.in").write_text(deck)
            dirs[pkg] = d
        js = japp.Session(str(dirs["jax"]), quiet=True)
        js.execute()
        ts = tapp.Session(str(dirs["torch"]), quiet=True, device="cpu")
        ts.execute()
        out[name] = (dirs, js, ts)
    return out


FILES = {"measure": ("msd.out", "sdc.out", "dos.out", "mvac.out", "ic.out",
                     "rdf.out", "adf.out", "angular_rdf.out",
                     "orientorder.out", "compute.out", "compute_chunk.out",
                     "viscosity.out", "heatmode.out", "neighbor.out"),
         "drive": ("onsager.out", "kappamode.out", "neighbor.out")}


@pytest.mark.parametrize("deck, fname", [(d, f) for d, fs in FILES.items()
                                         for f in fs])
def test_outputs_match_jax(decks, deck, fname):
    dirs, js, ts = decks[deck]
    assert ts.global_step == js.global_step == (20 if deck == "measure"
                                                else 40)
    assert sorted(p.name for p in dirs["torch"].glob("*.out")) == sorted(
        FILES[deck])
    if fname == "neighbor.out":
        assert (dirs["torch"] / fname).read_text() == (
            dirs["jax"] / fname).read_text()
        return
    (hj, rj), (ht, rt) = (_split(dirs[k] / fname) for k in ("jax", "torch"))
    assert ht == hj
    assert rt.shape == rj.shape and rj.size
    rel, floor = TOLS[fname]
    bound = rel * np.abs(rj).max(axis=0) + floor
    assert (np.abs(rt - rj) <= bound).all(), (
        np.abs(rt - rj).max(axis=0) / np.maximum(bound, 1e-300)).max()


def test_driving_forces_end_with_their_run(decks):
    _, js, ts = decks["drive"]
    for s in (js, ts):
        assert s.ff.hnemd_fe is None and s.ff.hnemdec_mode is None
        assert s.ff.hnemdec_fe is None and s.ff.hnemdec_coef is None


def _pbte_session(tmp_path, deck):
    write_pbte(tmp_path)
    write_eigenvectors(tmp_path / "eigenvector.in", 216, identity=True)
    (tmp_path / "run.in").write_text("potential nep.txt\n" + deck)
    s = tapp.Session(str(tmp_path), quiet=True, device="cpu")
    s.execute()
    return s


# the keywords of the card's compact decks (chip_smoke.py's measure phase)
COMPACT_DECKS = {
    "a": ("compute_msd 10 50\ncompute_sdc 5 100\ncompute_dos 5 100 40\n"
          "compute_ic 10 50 1 2.0\ncompute_rdf 8.0 160 100\n"
          "compute_adf 100 90 2.5 4.0\ncompute_angular_rdf 6.0 60 36 100\n"
          "compute_orientorder 100 cutoff 4.0 2 4 6\n"
          "compute 0 10 100 temperature potential force jk momentum\n"
          "compute_chunk 10 100 bin/1d x lower 6.57 temperature "
          "density/number vx\n"),
    "b": "compute_gkma 10 1 648 bin_size 1\ncompute 0 10 10 virial jp\n",
    "hnema": "compute_hnema 10 20 1e-4 0 0 1 648 bin_size 1\n",
}


@pytest.mark.parametrize("deck", list(COMPACT_DECKS))
def test_card_decks_take_the_compact_route(tmp_path, deck):
    s = _pbte_session(tmp_path, COMPACT_DECKS[deck])
    assert tapp.dense_route_reason(s, tnve.NVE(), "cuda") is None


@pytest.mark.parametrize("deck, reason", [
    ("compute_viscosity 1 50\n", "per-step stress observer"),
    ("compute_hnemdec 1 20 1e-4 0 0\n", "compute_hnemdec"),
])
def test_list_route_reasons(tmp_path, deck, reason):
    s = _pbte_session(tmp_path, deck)
    assert tapp.dense_route_reason(s, tnve.NVE(), "cuda") == reason


def test_onsager_observer_reason(tmp_path):
    """An Onsager measure without the HNEMDEC driving force (JAX's third
    reason, after compute_hnemdec in its order)."""
    s = _pbte_session(tmp_path, "compute_hnemdec 0 20 1e-4 0 0\n")
    s.ff = dataclasses.replace(s.ff, hnemdec_mode=None)
    assert tapp.dense_route_reason(s, tnve.NVE(), "cuda") == \
        "onsager flux observer"


@pytest.mark.parametrize("quantity, pav", [("virial", True), ("jp", True),
                                           ("temperature momentum", False)])
def test_compute_virial_runs_with_per_atom_virials(tmp_path, quantity, pav):
    s = _pbte_session(tmp_path, f"engine dense\ncompute 0 1 2 {quantity}\n"
                      "run 2\n")
    assert s.route_reason is None and s.md.per_atom_virial is pav
    rows = np.atleast_2d(np.loadtxt(tmp_path / "compute.out"))
    assert rows.shape[0] == 1 and np.isfinite(rows).all()


def test_compute_chunk_bins_float32_positions_as_float64(tmp_path):
    """An atom of a float32 run that float32 arithmetic bins across an
    edge (the wrap's round trip x -> x / L -> (x / L) L moves it by an
    ulp) lands in the bin float64 gives it: a float32 session's
    compute_chunk.out equals the one of the same snapshot in float64
    (chip_smoke's recomputation of the card's snapshots; the reference
    bins its doubles)."""
    delta = 2.0
    sessions = []
    for name in ("f32", "f64"):
        d = tmp_path / name
        d.mkdir()
        write_pbte(d)
        s = tapp.Session(str(d), quiet=True, device="cpu")
        s.kw_potential(["nep.txt"])
        s.kw_compute_chunk(["1", "1", "bin/1d", "x", "lower", str(delta),
                            "density/number"])
        sessions.append(s)
    st = sessions[0].state
    assert st.position.dtype == torch.float32
    # float32 values around the inner edges: the first that float32
    # arithmetic (the state's box) and float64 bin apart
    nl = int(np.ceil(float(st.box.thickness()[0]) / delta))
    cand = []
    for k in range(1, nl):
        x = torch.tensor(np.float32(k * delta))
        for toward in (0.0, 1e9):
            y = x
            for _ in range(8):
                cand.append(y)
                y = torch.nextafter(y, torch.tensor(toward))
    cand = torch.stack(cand)
    xyz = torch.zeros((len(cand), 3))
    xyz[:, 0] = cand
    apart = ((st.box.wrap(xyz)[:, 0] / delta).to(torch.int64)
             != (cand.double() / delta).to(torch.int64))
    assert bool(apart.any())
    pos = st.position.clone()
    pos[0, 0] = cand[int(torch.nonzero(apart)[0])]
    st = st._replace(position=pos)
    f64 = torch.float64
    st64 = st._replace(
        box=Box.from_lattice(st.box.h.to(f64).T.numpy(), dtype=f64,
                                  device="cpu"),
        **{k: getattr(st, k).to(f64) for k in ("position", "velocity",
                                               "mass", "force", "mask")})
    for s, state in zip(sessions, (st, st64)):
        s.properties[-1].process(s, state, 1)
    f32_rows, f64_rows = (np.loadtxt(tmp_path / name / "compute_chunk.out")
                          for name in ("f32", "f64"))
    assert len(f32_rows) == nl
    assert np.array_equal(f32_rows, f64_rows)
