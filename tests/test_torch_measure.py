"""The port's measure classes (gpumd_tpu_torch/measure/properties.py)
against the JAX package's on the CPU, in float64.

The same seeded numpy snapshots (a two-type rocksalt box of 216 atoms and
an fcc argon box of 108, jittered, with random velocities, forces,
per-atom virials and energies, and unwrapped positions on a random walk)
go through each JAX class and its port counterpart, each with a
duck-typed session writing to its own directory, and the output files are
compared: the header lines exactly, the numbers within 1e-5 of each
column's largest magnitude (TOL).  The values agree to ~1e-12 in float64
(the port correlates frames through Gram matrices where the JAX package
loops over lags); the bound is the printed digits, six significant (%g)
or five or six decimals (g(r), q_l), one of which flips where a value sits
on a rounding boundary.  The per-step observers `stress_6` and
`onsager_flux` agree to 1e-12 relative.  Then what the JAX package's own
tests check, on the port alone: the cell lists against brute force bin
for bin, exact fcc q_l and w_l-hat, and the modal heat currents of an
identity eigenbasis summing to the total.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import gpumd_tpu.measure.properties as jprops
import gpumd_tpu_torch.measure.properties as tprops
from gpumd_tpu.model import Box as JBox
from gpumd_tpu.model import make_state as jmake_state
from gpumd_tpu_torch.model.box import Box as TBox
from gpumd_tpu_torch.model.state import make_state as tmake_state
from gpumd_tpu_torch.neighbor import neighbor as tnbr
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5
DT = 2.0 / 10.18051
FCC = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])


def lattice(kind, nc=3):
    """(positions, masses, types, edge) of the test boxes."""
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    if kind == "argon":
        a0 = 5.26
        pos = (cells[:, None] + FCC[None]).reshape(-1, 3) * a0
        return pos, np.full(len(pos), 39.948), np.zeros(len(pos), int), \
            nc * a0
    a0 = 5.8  # rocksalt: type 0 on fcc, type 1 shifted by a0 / 2 along x
    te = (cells[:, None] + FCC[None]).reshape(-1, 3) * a0
    pos = np.concatenate([te, te + [0.5 * a0, 0, 0]])
    types = np.repeat([0, 1], len(te))
    return pos, np.where(types == 1, 207.2, 127.6), types, nc * a0


def snapshots(kind, n_frames, seed=0, jitter=0.1):
    """n_frames seeded snapshots of one box: dicts of numpy arrays."""
    pos0, mass, types, edge = lattice(kind)
    rng = np.random.default_rng(seed)
    n = len(pos0)
    unwrapped = pos0 + rng.normal(0, jitter, pos0.shape)
    out = []
    for _ in range(n_frames):
        unwrapped = unwrapped + rng.normal(0, 0.05, (n, 3))
        out.append(dict(
            position=np.mod(unwrapped, edge), unwrapped=unwrapped.copy(),
            velocity=rng.normal(0, 0.01, (n, 3)),
            force=rng.normal(0, 0.5, (n, 3)),
            virial=rng.normal(0, 0.3, (n, 3, 3)),
            potential_energy=rng.normal(-2.0, 0.1, n),
            mass=mass, type=types, edge=edge))
    return out


def jax_state(s):
    import jax.numpy as jnp

    st = jmake_state(s["position"], s["mass"], s["type"],
                     JBox.orthogonal([s["edge"]] * 3))
    return st._replace(**{k: jnp.asarray(s[k]) for k in (
        "velocity", "force", "virial", "potential_energy")},
        unwrapped_position=jnp.asarray(s["unwrapped"]))


def torch_state(s):
    st = tmake_state(s["position"], s["mass"], s["type"],
                     TBox.orthogonal([s["edge"]] * 3, device="cpu"))
    return st._replace(**{k: torch.as_tensor(s[k]) for k in (
        "velocity", "force", "virial", "potential_energy")},
        unwrapped_position=torch.as_tensor(s["unwrapped"]))


STATES = {"jax": jax_state, "torch": torch_state}
MODULES = {"jax": jprops, "torch": tprops}


class Sess:
    """The session's surface the measures use: workdir, _n, state and
    _file."""

    def __init__(self, workdir, n, state):
        self.workdir, self._n, self.state = str(workdir), n, state
        self._files = {}

    def _file(self, name):
        if name not in self._files:
            self._files[name] = open(os.path.join(self.workdir, name), "w")
        return self._files[name]

    def close(self):
        for f in self._files.values():
            f.close()


def run_both(tmp_path, make, snaps, interval=1):
    """make(module) -> a measure of that package; every snapshot sampled
    at steps interval, 2 interval, ...; the directory of each package."""
    dirs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        states = [STATES[pkg](s) for s in snaps]
        m = make(MODULES[pkg])
        sess = Sess(d, len(snaps[0]["mass"]), states[-1])
        for k, st in enumerate(states):
            m.sample_state(sess, st, (k + 1) * interval)
        m.postprocess(sess)
        sess.close()
        dirs[pkg] = d
    return dirs


def _split(path: Path):
    heads, rows = [], []
    for line in path.read_text().splitlines():
        try:
            rows.append([float(x) for x in line.split()])
        except ValueError:
            heads.append(line)
    return heads, np.array(rows)


def assert_files_match(dirs, names):
    """Every output file of both packages: the same names, header lines
    equal, the numbers within TOL of each column's largest magnitude."""
    assert sorted(p.name for p in dirs["torch"].iterdir()) == sorted(
        p.name for p in dirs["jax"].iterdir()) == sorted(names)
    for name in names:
        (hj, rj), (ht, rt) = (_split(dirs[k] / name) for k in ("jax",
                                                               "torch"))
        assert ht == hj, name
        assert rt.shape == rj.shape and rj.size, name
        scale = np.maximum(np.abs(rj).max(axis=0), 1e-300)
        worst = (np.abs(rt - rj).max(axis=0) / scale).max()
        assert worst <= TOL, (name, worst)


# ---- frame correlations ------------------------------------------------------

FRAME_CASES = {
    "msd": (lambda p: p.MSD(5, 6, DT), ["msd.out"]),
    "sdc": (lambda p: p.SDC(5, 6, DT), ["sdc.out"]),
    "dos": (lambda p: p.DOS(5, 6, 30.0, DT), ["mvac.out", "dos.out"]),
    "dos_points": (lambda p: p.DOS(5, 8, 40.0, DT, num_points=13),
                   ["mvac.out", "dos.out"]),
    "ic": (lambda p: p.IonicConductivity(5, 6, 1, 2.0, DT, 300.0),
           ["ic.out"]),
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_frame_correlations_match_jax(tmp_path, case):
    make, names = FRAME_CASES[case]
    dirs = run_both(tmp_path, make, snapshots("rocksalt", 9), interval=5)
    assert_files_match(dirs, names)


def test_ionic_conductivity_volume_in_float64(tmp_path):
    """compute_ic takes the cell volume in float64 from a float32 state:
    the float32 product is ~1e-7 off, enough to flip a printed digit of
    ic.out against a float64 recomputation (chip_smoke measure (a))."""
    s = snapshots("rocksalt", 1)[0]
    edge = 105.12
    st = tmake_state(s["position"], s["mass"], s["type"],
                     TBox.orthogonal([edge] * 3, dtype=torch.float32,
                                     device="cpu"))
    st = st._replace(unwrapped_position=st.position)
    m = tprops.IonicConductivity(5, 6, 1, 2.0, DT, 300.0)
    m.sample_state(Sess(tmp_path, len(s["position"]), st), st, 5)
    want = float(np.float32(edge)) ** 3
    assert m._volume == want
    assert float(st.box.volume) != want  # the float32 product


def test_squared_displacements_equal_the_loop():
    """The Gram-matrix sums of the port against the direct loop over lags,
    on positions 100 A from the origin (the centring keeps the digits)."""
    rng = np.random.default_rng(3)
    x = 100.0 + np.cumsum(rng.normal(0, 0.1, (12, 40, 3)), axis=0)
    got = tprops._squared_displacements(x, 12)
    want = np.array([np.sum((x[lag:] - x[:12 - lag]) ** 2, axis=(0, 1))
                     for lag in range(12)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


# ---- per-step observers and their measures --------------------------------------


@pytest.mark.parametrize("kind", ["rocksalt", "argon"])
def test_stress_6_and_onsager_flux_match_jax(kind):
    s = snapshots(kind, 1, seed=2)[0]
    js, ts = jax_state(s), torch_state(s)
    np.testing.assert_allclose(tprops.stress_6(ts).numpy(),
                               np.asarray(jprops.stress_6(js)), rtol=1e-12)
    mass_type, nt = (127.6, 207.2), 2
    np.testing.assert_allclose(
        tprops.onsager_flux(ts, mass_type, nt).numpy(),
        np.asarray(jprops.onsager_flux(js, mass_type, nt)), rtol=1e-12,
        atol=1e-14)


def _consume_both(tmp_path, make, consume, width, n_rows, chunk):
    rows = np.random.default_rng(7).normal(0, 1.0, (n_rows, width))
    box = snapshots("rocksalt", 1)[0]
    dirs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        sess = Sess(d, 216, STATES[pkg](box))
        m = make(MODULES[pkg])
        for k in range(0, n_rows, chunk):
            block = rows[k:k + chunk]
            getattr(m, consume)(torch.as_tensor(block) if pkg == "torch"
                                else block, k)
            if hasattr(m, "maybe_output"):
                m.maybe_output(sess)
        m.postprocess(sess)
        dirs[pkg] = d
    return dirs


def test_viscosity_matches_jax(tmp_path):
    dirs = _consume_both(tmp_path, lambda p: p.Viscosity(2, 15, DT, 300.0),
                         "consume_stress", 6, 60, 5)
    assert_files_match(dirs, ["viscosity.out"])


@pytest.mark.parametrize("mode", [0, 1])
def test_hnemdec_onsager_matches_jax(tmp_path, mode):
    def make(p):
        m = p.HNEMDECOnsager(mode, 10, (1e-4, 0, 0), 300.0, 2, 0.37)
        m.mass_type = (127.6, 207.2)
        return m

    dirs = _consume_both(tmp_path, make, "consume_onsager", 9, 50, 5)
    assert_files_match(dirs, ["onsager.out"])


# ---- neighbour-based measures --------------------------------------------------

NEIGHBOR_CASES = {
    "rdf_one_type": ("argon", lambda p: p.RDF(6.0, 40, 10), ["rdf.out"]),
    "rdf_two_types": ("rocksalt", lambda p: p.RDF(
        7.0, 50, 10, num_types=2, type_names=["Te", "Pb"]), ["rdf.out"]),
    "angular_rdf_pairs": ("rocksalt", lambda p: p.AngularRDF(
        6.0, 12, 10, 10, pairs=[(0, 1), (1, 1)]), ["angular_rdf.out"]),
    "adf_global": ("argon", lambda p: p.ADF(10, 45, rc_min=0.5,
                                            rc_max=4.4), ["adf.out"]),
    "adf_triples": ("rocksalt", lambda p: p.ADF(10, 36, triples=[
        (0, 1, 1, 0.5, 3.5, 0.5, 3.5), (1, 0, 1, 0.5, 3.5, 2.0, 4.6)]),
        ["adf.out"]),
    "orientorder_cutoff": ("argon", lambda p: p.OrientOrder(
        10, "cutoff", 4.4, [4, 6], average=True, wl=True, wlhat=True),
        ["orientorder.out"]),
    "orientorder_nnn": ("rocksalt", lambda p: p.OrientOrder(
        10, "nnn", 6, [2, 4, 6], wlhat=True), ["orientorder.out"]),
}


@pytest.mark.parametrize("case", list(NEIGHBOR_CASES))
def test_neighbor_measures_match_jax(tmp_path, case):
    kind, make, names = NEIGHBOR_CASES[case]
    dirs = run_both(tmp_path, make, snapshots(kind, 2, seed=1), interval=10)
    assert_files_match(dirs, names)


def test_cell_list_matches_brute(monkeypatch):
    """Above 2,048 atoms the samplers take the cell list; the histograms
    equal the brute-force (with images) ones bin for bin
    (tests/test_adf_rdf.py's check)."""
    a0, nc = 5.26, 9  # 2,916 atoms
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    pos = (cells[:, None] + FCC[None]).reshape(-1, 3) * a0
    pos += np.random.default_rng(5).uniform(-0.15, 0.15, pos.shape)
    n = len(pos)
    state = tmake_state(pos, np.ones(n), np.arange(n) % 2,
                        TBox.orthogonal([nc * a0] * 3, device="cpu"))
    sess = Sess(".", n, state)
    cases = ((tprops.RDF, dict(r_cut=6.0, num_bins=60, sample_interval=1,
                               num_types=2)),
             (tprops.ADF, dict(sample_interval=1, num_bins=30, rc_min=0.5,
                               rc_max=4.2)),
             (tprops.AngularRDF, dict(r_cut=6.0, r_bins=20, theta_bins=12,
                                      sample_interval=1, pairs=[(0, 1)])))
    for cls, kw in cases:
        cell = cls(**kw)
        cell.sample_state(sess, state, 0)
        with monkeypatch.context() as mp:
            mp.setattr(tnbr, "choose_grid", lambda *a, **k: None)
            brute = cls(**kw)
            brute.sample_state(sess, state, 0)
        assert cell.hist.sum() > 0
        np.testing.assert_array_equal(cell.hist, brute.hist)
        if hasattr(cell, "hist_pair"):
            np.testing.assert_array_equal(cell.hist_pair, brute.hist_pair)


@pytest.mark.parametrize("mode, param", [("cutoff", 4.4), ("nnn", 12)])
def test_orientorder_fcc_values(tmp_path, mode, param):
    """Perfect fcc, 12 nearest neighbours: q4 0.190941, q6 0.574524,
    w4-hat -0.159317, w6-hat -0.013161 (tests/test_orientorder.py)."""
    pos, mass, types, edge = lattice("argon")
    state = tmake_state(pos, mass, types,
                        TBox.orthogonal([edge] * 3, device="cpu"))
    m = tprops.OrientOrder(5, mode, param, [4, 6], wl=True, wlhat=True)
    m.sample_state(Sess(tmp_path, len(pos), state), state, 5)
    cols = m.blocks[0][1]
    np.testing.assert_allclose(cols[:, 0], 0.190941, atol=2e-6)
    np.testing.assert_allclose(cols[:, 1], 0.574524, atol=2e-6)
    np.testing.assert_allclose(cols[:, 4], -0.159317, atol=2e-6)
    np.testing.assert_allclose(cols[:, 5], -0.013161, atol=2e-6)


# ---- modal analysis ------------------------------------------------------------


def write_eigenvectors(path, n, identity, seed=0):
    """eigenvector.in for n atoms: 3n ascending omega^2 values (some
    negative), then 3n modes of [ex(n), ey(n), ez(n)], float32."""
    nm = 3 * n
    om2 = np.linspace(-2.0, 600.0, nm)
    if identity:  # mode m: e_c[i] = delta(3i + c == m)
        modes = np.zeros((nm, 3, n))
        modes[np.arange(nm), np.arange(nm) % 3, np.arange(nm) // 3] = 1.0
    else:
        modes = np.random.default_rng(seed).normal(size=(nm, 3 * n))
        modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    np.concatenate([om2, modes.reshape(-1)]).astype(np.float32).tofile(path)
    return nm


@pytest.mark.parametrize("method", ["gkma", "hnema"])
@pytest.mark.parametrize("binning", [{"bin_size": 7},
                                     {"f_bin_size": 0.5}])
def test_modal_analysis_matches_jax(tmp_path, method, binning):
    eig = tmp_path / "eigenvector.in"
    nm = write_eigenvectors(eig, 216, identity=False)
    extra = ({"output_interval": 20, "fe": 1e-4, "temperature": 300.0}
             if method == "hnema" else {})
    name = "heatmode.out" if method == "gkma" else "kappamode.out"
    dirs = run_both(tmp_path, lambda p: p.ModalAnalysis(
        method, 10, 3, nm - 5, eig_path=str(eig), **binning, **extra),
        snapshots("rocksalt", 4, seed=4), interval=10)
    assert_files_match(dirs, [name])


def test_gkma_identity_modes_sum_to_the_heat_current(tmp_path):
    """A complete orthonormal basis: the modal currents sum to the total
    heat current (tests/test_measure.py's completeness check)."""
    s = snapshots("rocksalt", 1, seed=6)[0]
    nm = write_eigenvectors(tmp_path / "eigenvector.in", 216, identity=True)
    st = torch_state(s)
    sess = Sess(tmp_path, 216, st)
    m = tprops.ModalAnalysis("gkma", 10, 1, nm, bin_size=1,
                             eig_path=str(tmp_path / "eigenvector.in"))
    m.sample_state(sess, st, 10)
    sess.close()
    jm = np.loadtxt(tmp_path / "heatmode.out")
    assert jm.shape == (nm, 5)
    j5 = tprops.heat_current_5(st).numpy()
    np.testing.assert_allclose(jm.sum(axis=0), j5, rtol=1e-4,
                               atol=1e-4 * np.abs(j5).max())


@pytest.mark.parametrize("l", [2, 4, 6])
def test_spherical_harmonics_match_jax(l):
    """_ylm_complex (numpy) and _ylm_complex_torch against the JAX
    package's _ylm_complex and _ylm_complex_jnp, m = -l..l, and the
    Wigner 3j table."""
    import jax.numpy as jnp

    rng = np.random.default_rng(l)
    ct, phi = rng.uniform(-1, 1, 50), rng.uniform(-np.pi, np.pi, 50)
    host = tprops._ylm_complex(l, ct, phi)
    dev = tprops._ylm_complex_torch(l, torch.as_tensor(ct),
                                    torch.as_tensor(phi))
    ref = jprops._ylm_complex(l, ct, phi)
    ref_j = jprops._ylm_complex_jnp(l, jnp.asarray(ct), jnp.asarray(phi))
    for m in range(-l, l + 1):
        np.testing.assert_allclose(host[m], ref[m], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(dev[m].numpy(), np.asarray(ref_j[m]),
                                   rtol=1e-12, atol=1e-14)
        for m2 in range(-l, l + 1):
            assert tprops._wigner3j(l, l, l, m, m2, -m - m2) == \
                jprops._wigner3j(l, l, l, m, m2, -m - m2)
