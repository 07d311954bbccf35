"""The port's classical many-body potentials against the JAX package's,
float64 on the CPU: Tersoff-1989 on the list path, Tersoff-1988,
Tersoff-mini, Stillinger-Weber and the EAM family (Zhou 2004, eam/alloy,
ADP, Dai 2006).

Each file is written in tmp_path from gpumd_tpu_torch/potentials/
sets.py: published sets where they can be written down (Tersoff-1989 Si
and SiC, Phys. Rev. B 39, 5566 (1989); SW Si as examples/02_silicon_
thermal/make_model.py writes it), synthetic sets in the other formats
(a bound lattice checked: negative energy, forces on).

Every potential computes on the same rattled lattice (64-216 atoms), on
the same neighbour list (the JAX builder's, at an explicit small MN, the
port's builder's slots checked equal) in both packages: per-atom
energies, forces and per-atom virials within 1e-9 of each quantity's
largest magnitude, two types where the format has them.  The JAX
oracles go through jax.jit, one compile a potential.  Tersoff-1989's
list path is also held against the port's compact engine (its kernels'
plain versions) on the same 216-atom box.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.box import num_replicas_for_cutoff as jreps
from gpumd_tpu.neighbor.neighbor import neighbor_brute as jbrute
from gpumd_tpu.potentials import eam as jeam
from gpumd_tpu.potentials import sw as jsw
from gpumd_tpu.potentials import tersoff as jters
from gpumd_tpu_torch.engine import tersoff_compact as TT
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.neighbor.neighbor import neighbor_brute as tbrute
from gpumd_tpu_torch.potentials import base as tbase
from gpumd_tpu_torch.potentials import eam as team
from gpumd_tpu_torch.potentials import sets
from gpumd_tpu_torch.potentials import sw as tsw
from gpumd_tpu_torch.potentials import tersoff as tters
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

FCC = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
DIAMOND = np.concatenate([FCC, FCC + 0.25])


def lattice(basis, a0, nc, jitter, seed=3):
    cells = np.array([[i, j, k] for i in range(nc) for j in range(nc)
                      for k in range(nc)])
    pos = (cells[:, None] + basis[None]).reshape(-1, 3) * a0
    rng = np.random.default_rng(seed)
    return pos + rng.normal(0.0, jitter, pos.shape), np.full(3, nc * a0)


def write_files(d: Path):
    """Every format's file of potentials/sets.py, plus the two-type
    Tersoff-1989 SiC and SW sets: {case: path}."""
    files = dict(sets.files())
    files["tersoff_1989_sic"] = ("sic_1989.txt", sets.TERSOFF_SIC)
    files["sw_1985_2"] = ("sw_two.txt", sets.SW_TWO)
    for name, text in files.values():
        (d / name).write_text(text)
    return {k: str(d / v[0]) for k, v in files.items()}


# (JAX class, port class, lattice basis, a0, cells, jitter, two types, mn)
CASES = {
    "tersoff_1989": (jters.Tersoff1989, tters.Tersoff1989, DIAMOND, 5.431,
                     3, 0.08, False, 24),
    "tersoff_1989_sic": (jters.Tersoff1989, tters.Tersoff1989, DIAMOND,
                         4.36, 2, 0.06, True, 24),
    "tersoff_1988": (jters.Tersoff1988, tters.Tersoff1988, DIAMOND, 4.36, 2,
                     0.06, True, 24),
    "tersoff_mini": (jters.TersoffMini, tters.TersoffMini, DIAMOND, 4.36, 2,
                     0.06, True, 24),
    "sw_1985": (jsw.SW, tsw.SW, DIAMOND, 5.431, 2, 0.25, False, 24),
    "sw_1985_2": (jsw.SW, tsw.SW, DIAMOND, 5.5, 2, 0.2, True, 24),
    "eam_zhou_2004": (jeam.EAMZhou2004, team.EAMZhou2004, FCC, 3.7, 3,
                      0.08, True, 96),
    "eam/alloy": (jeam.EAMAlloy, team.EAMAlloy, FCC, 3.7, 3, 0.08, True,
                  96),
    "adp": (jeam.ADP, team.ADP, FCC, 3.7, 3, 0.08, True, 96),
    "eam_dai_2006": (jeam.EAMDai2006, team.EAMDai2006, FCC, 3.8, 3, 0.06,
                     False, 96),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(tmp_path_factory.mktemp("pots"))


def lists(pos, lengths, rc, mn):
    """(JAX list, the port's list with JAX's slots) at rc, MN; the port's
    own builder gives the same slots."""
    jbox = JBox.orthogonal(lengths)
    mask = np.ones(len(pos))
    reps = jreps(jbox, rc)
    jn = jbrute(jnp.asarray(pos), jbox, jnp.asarray(mask), rc=rc, mn=mn,
                reps=reps)
    assert int(jnp.max(jn.count)) <= mn
    tn = NeighborList(idx=torch.as_tensor(np.array(jn.idx)),
                      r12=torch.as_tensor(np.array(jn.r12)),
                      mask=torch.as_tensor(np.array(jn.mask)),
                      count=torch.as_tensor(np.array(jn.count)))
    own = tbrute(torch.as_tensor(pos), Box.orthogonal(lengths, device="cpu"),
                 torch.ones(len(pos), dtype=torch.float64), rc=rc, mn=mn,
                 reps=reps)
    assert torch.equal(own.idx.long(), tn.idx.long())
    return jn, tn


def setup(files, name):
    jcls, tcls, basis, a0, nc, jitter, two, mn = CASES[name]
    path = files[name]
    jpot = jcls.from_file(path)
    tpot = tcls.from_file(path, dtype=torch.float64, device="cpu")
    pos, lengths = lattice(basis, a0, nc, jitter)
    n = len(pos)
    types = (np.random.default_rng(7).integers(0, 2, n) if two
             else np.zeros(n, int))
    return jpot, tpot, pos, lengths, types, mn


def close(got, want, what):
    got = got.detach().numpy()
    want = np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err <= 1e-9, (what, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(files, name):
    jpot, tpot, pos, lengths, types, mn = setup(files, name)
    jn, tn = lists(pos, lengths, tpot.rc, mn)
    n = len(pos)
    mask = np.ones(n)
    want = jax.jit(lambda t, nb, m: jpot.compute(t, nb, m))(
        jnp.asarray(types), jn, jnp.asarray(mask))
    got = tpot.compute(torch.as_tensor(types), tn,
                       torch.ones(n, dtype=torch.float64))
    for field in ("energy", "force", "virial"):
        close(getattr(got, field), getattr(want, field), (name, field))
    # a bound, non-trivial configuration: energy below zero, forces on
    assert float(got.energy.sum()) < 0.0, name
    assert float(got.force.abs().max()) > 1e-3, name


def test_blocks_leave_the_result(files, monkeypatch):
    """The energy and its gradient taken 50 centres a block equal the
    single-block result (the block loop recomputes nothing it shares)."""
    jpot, tpot, pos, lengths, types, mn = setup(files, "tersoff_1988")
    _, tn = lists(pos, lengths, tpot.rc, mn)
    args = (torch.as_tensor(types), tn, torch.ones(len(pos),
                                                   dtype=torch.float64))
    whole = tpot.compute(*args)
    monkeypatch.setattr(tbase, "MANY_BODY_BLOCK", 50)
    cut = tpot.compute(*args)
    for a, b in zip(whole, cut):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


def test_tersoff_list_path_matches_compact_engine(files):
    """Tersoff-1989 Si on the list path (ForceField's force) against the
    port's compact engine (CompactTersoffMD on its kernels' plain
    versions), 216 rattled atoms."""
    from gpumd_tpu_torch.forcefield import ForceField

    pot = tters.Tersoff1989.from_file(files["tersoff_1989"], device="cpu")
    pos, lengths = lattice(DIAMOND, 5.431, 3, 0.08)
    n = len(pos)
    box = Box.orthogonal(lengths, device="cpu")
    types = np.zeros(n, int)
    state = make_state(pos, np.full(n, 28.085), types, box)
    ff = ForceField.create([pot], box, n, mn=24)
    listed = ff.compute(state)
    md = TT.CompactTersoffMD(pot, box, n, position=pos, skin=0.2)
    carry = md.init_carry(state)
    packed = md.to_input_order(carry._replace(
        state=md.compute(carry.state, carry.idx)), n)
    torch.testing.assert_close(packed.potential_energy,
                               listed.potential_energy, rtol=0, atol=1e-10)
    torch.testing.assert_close(packed.force, listed.force, rtol=0,
                               atol=1e-9)
    # perfect diamond Si: the published set's -4.6296 eV/atom
    st = make_state(lattice(DIAMOND, 5.432, 3, 0.0)[0], np.full(n, 28.085),
                    types, Box.orthogonal(np.full(3, 3 * 5.432),
                                          device="cpu"))
    e = ForceField.create([pot], st.box, n, mn=24).compute(st)
    assert float(e.potential_energy.sum()) / n == pytest.approx(-4.6296,
                                                                abs=1e-4)


def test_sw_diamond_cohesive_energy(files):
    """Perfect diamond Si at a0 5.431 A under the published SW set: -2
    epsilon = -4.3366 eV/atom (to 1e-6) and zero forces (every bond angle
    at cos0, inside the taper window of the JAX package's form)."""
    from gpumd_tpu_torch.forcefield import ForceField

    pot = tsw.SW.from_file(files["sw_1985"], device="cpu")
    pos, lengths = lattice(DIAMOND, 5.431, 3, 0.0)
    n = len(pos)
    box = Box.orthogonal(lengths, device="cpu")
    out = ForceField.create([pot], box, n, mn=32).compute(
        make_state(pos, np.full(n, 28.085), np.zeros(n, int), box))
    assert float(out.potential_energy.sum()) / n == pytest.approx(
        -2 * 2.1683, abs=1e-6)  # A, B given to 10 digits
    assert float(out.force.abs().max()) < 1e-10


def test_tersoff_1988_reduces_to_1989(files, tmp_path):
    """A one-type Tersoff-1988 table with alpha 0 and gamma 1 is the
    Tersoff-1989 Si potential."""
    (tmp_path / "t88si.txt").write_text(
        f"tersoff_1988 1 Si\n{sets.SI_ROW} 3.0 0.0 1.0\n")
    p88 = tters.Tersoff1988.from_file(str(tmp_path / "t88si.txt"),
                                      device="cpu")
    p89 = tters.Tersoff1989.from_file(files["tersoff_1989"], device="cpu")
    pos, lengths = lattice(DIAMOND, 5.431, 2, 0.1)
    _, tn = lists(pos, lengths, 3.0, 24)
    args = (torch.zeros(len(pos), dtype=torch.int64), tn,
            torch.ones(len(pos), dtype=torch.float64))
    for a, b in zip(p88.compute(*args), p89.compute(*args)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["tersoff_mini", "sw_1985_2", "eam/alloy",
                                  "adp", "eam_dai_2006"])
def test_tables_on_the_callers_device_and_dtype(files, name):
    tcls = CASES[name][1]
    pot = tcls.from_file(files[name], dtype=torch.float32, device="cpu")
    tens = [v for v in pot if torch.is_tensor(v)]
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in tens)
    if tens:
        assert any(t.dim() for t in tens)


# ---- through the app ------------------------------------------------------

SYMBOLS = {"tersoff_1988": ("Si", "C"), "tersoff_mini": ("Si", "C"),
           "eam_zhou_2004": ("Cu", "Ag"), "eam/alloy": ("Cu", "Ag"),
           "adp": ("Cu", "Ag"), "eam_dai_2006": ("Fe", "Fe")}


def write_model(d: Path, pos, lengths, symbols, seed=11):
    """model.xyz with velocities (~300 K for the masses of `symbols`)."""
    from gpumd_tpu_torch.elements import mass_of
    from gpumd_tpu_torch.io.xyz import XYZFrame, write_xyz
    from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION

    rng = np.random.default_rng(seed)
    mass = np.array([mass_of(s) for s in symbols])
    vel = rng.normal(size=pos.shape) * np.sqrt(K_B * 300.0 / mass)[:, None]
    vel -= (mass[:, None] * vel).sum(0) / mass.sum()
    d.mkdir(parents=True, exist_ok=True)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=list(symbols), positions=pos, lattice=np.diag(lengths),
        velocities=vel / TIME_UNIT_CONVERSION), with_velocities=True)


@pytest.mark.parametrize("name", list(SYMBOLS))
def test_app_header_matches_a_direct_run(files, name, tmp_path):
    """`potential <file>` of each new header through the port's app (f64
    on the CPU, 10 NVE steps, its list capacity and skin) against
    ForceField + md_run from the app's own start: positions within 1e-10
    A, thermo's last potential energy within 1e-10 relative."""
    from gpumd_tpu_torch.forcefield import ForceField
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.integrate.run import md_run
    import gpumd_tpu_torch.app.gpumd as tapp

    _, tcls, basis, a0, nc, jitter, two, _ = CASES[name]
    pos, lengths = lattice(basis, a0, nc, jitter)
    types = (np.random.default_rng(7).integers(0, 2, len(pos)) if two
             else np.zeros(len(pos), int))
    write_model(tmp_path, pos, lengths, [SYMBOLS[name][t] for t in types])
    (tmp_path / "pot.txt").write_text(Path(files[name]).read_text())
    start = tapp.Session(str(tmp_path), quiet=True, device="cpu",
                         dtype=torch.float64)
    start.kw_potential(["pot.txt"])
    assert isinstance(start.potentials[0], tcls)
    (tmp_path / "run.in").write_text("potential pot.txt\ntime_step 1\n"
                                     "ensemble nve\ndump_thermo 5\nrun 10\n")
    s = tapp.Session(str(tmp_path), quiet=True, device="cpu",
                     dtype=torch.float64)
    s.execute()
    assert s.route_reason.startswith("CPU device")
    ff = ForceField.create(start.potentials, start.box, len(pos),
                           mn=s.ff.neighbor.mn, skin=1.0)
    with torch.no_grad():
        direct, _, _ = md_run(ff.compute(start.state), ff, NVE(), s.dt, 10)
    dx = s.state.box.minimum_image(s.state.position - direct.position)
    assert float(dx.abs().max()) <= 1e-10
    pe = np.loadtxt(tmp_path / "thermo.out")[-1, 2]
    want = float(torch.sum(direct.potential_energy))
    assert abs(pe - want) <= 1e-10 * abs(want)


def test_examples_02_silicon_thermal_matches_jax(tmp_path, monkeypatch):
    """examples/02_silicon_thermal (its make_model.py's 512-atom diamond
    Si and published SW file) on a copy of its run.in cut to 20 + 20
    steps, through both apps in float64.  The decks start from
    model.xyz's velocities (the two packages' `velocity` draws differ),
    and the JAX app takes the port's list capacity (its own 256 makes
    (512, 256, 256) angle tensors): the final positions within 1e-9 A and
    kappa.out within 1e-8 of each column's largest magnitude (tighter
    than PR 17's float32 tolerances, 1e-4; chip_smoke holds the card's
    float32 run against the CPU's float64)."""
    import runpy

    import gpumd_tpu_torch.app.gpumd as tapp
    from gpumd_tpu.app import gpumd as japp
    from gpumd_tpu_torch.io.xyz import read_xyz

    ex = Path(__file__).resolve().parent.parent / "examples" \
        / "02_silicon_thermal"
    run_in = (ex / "run.in").read_text()
    deck = "".join(line + "\n" for line in run_in.splitlines()
                   if not line.startswith("velocity"))
    for full in ("run           20000", "run           2000"):
        assert full in deck
        deck = deck.replace(full, "run 20")
    deck = deck.replace("compute_hnemd 1000", "compute_hnemd 10")
    assert deck.count("run 20\n") == 2 and "compute_hnemd 10 " in deck
    dirs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        runpy.run_path(str(ex / "make_model.py"))
        frame = read_xyz(str(d / "model.xyz"))
        write_model(d, frame.positions, np.diag(frame.lattice),
                    frame.symbols)
        (d / "run.in").write_text(deck)
        dirs[pkg] = d
    monkeypatch.chdir(tmp_path)
    n = 512
    probe = tapp.Session(str(dirs["torch"]), quiet=True, device="cpu")
    probe.kw_potential(["sw.txt"])
    mn = probe.ff.neighbor.mn
    assert mn < 64
    monkeypatch.setattr(japp, "_auto_mn", lambda *a, **k: mn)
    js = japp.Session(str(dirs["jax"]), quiet=True)
    js.execute()
    ts = tapp.Session(str(dirs["torch"]), quiet=True, device="cpu",
                      dtype=torch.float64)
    ts.execute()
    assert ts.global_step == js.global_step == 40 and ts._n == n
    lengths = np.diag(np.asarray(js.box.h))
    dx = (ts.state.position.double().numpy()
          - np.asarray(js.state.position))
    dx -= np.round(dx / lengths) * lengths
    assert np.abs(dx).max() <= 1e-9, np.abs(dx).max()
    got, want = (np.atleast_2d(np.loadtxt(dirs[p] / "kappa.out"))
                 for p in ("torch", "jax"))
    assert got.shape == want.shape == (2, 5)
    err = (np.abs(got - want).max(0)
           / np.maximum(np.abs(want).max(0), 1e-30)).max()
    assert err <= 1e-8, err
