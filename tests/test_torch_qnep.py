"""The port's qNEP (gpumd_tpu_torch/potentials/nep/charge.py, pppm.py and
the charge layout of nep/params.py) against the JAX package's, float64 on
the CPU.

The models are potentials/sets.py's seeded random nep4_zbl_charge1/2 at
small widths, written by the port's write_nep_txt and read by both
packages.  On a rattled NaCl-like lattice and the same neighbour rows:
energies, forces and per-atom virials within 1e-10 of each quantity's
largest magnitude for charge_mode 1 and 2 under Ewald and PPPM, the Born
effective charges and the charges too; the flat-vector layout both ways;
the Ewald k-vectors (the JAX package's set and order, kept until the box
changes); Ewald against PPPM; the Madelung energy of point-charge NaCl;
and the app decks: PPPM with compute_es and compute_dpdt through both
apps, and Ewald with add_efield bec (the JAX app cannot trace Ewald: its
k-vectors need a concrete box, ROADMAP queue 3, item 24) against a direct
run of the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.nep import charge as jq
from gpumd_tpu.potentials.nep import params as jparams
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials import sets
from gpumd_tpu_torch.potentials.nep import charge as tq
from gpumd_tpu_torch.potentials.nep import params as tparams
from gpumd_tpu_torch.potentials.nep import pppm as tpppm
from gpumd_tpu_torch.units import K_C, TIME_UNIT_CONVERSION
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_potential_decks import app_outputs_close, app_pair, close, lists
from torch_potential_decks import outputs_close
from torch_one_thread import one_torch_thread  # noqa: F401

WIDTHS = (3, 2, 4, 3, 2, 8)
RC = (5.0, 3.5)
MESH = (16, 16, 16)


def write_model(path, mode, seed=0):
    model, theta, qs = sets.random_nep(mode, rc=RC, widths=WIDTHS,
                                       seed=seed)
    tparams.write_nep_txt(str(path), model, theta, qs)
    return model, theta, qs


def nacl(nc=2, jitter=0.1, seed=1):
    pos, sym, lengths = sets.rocksalt(nc, 5.64, ("Na", "Cl"))
    pos = pos + np.random.default_rng(seed).normal(0.0, jitter, pos.shape)
    return pos, np.array([("Na", "Cl").index(s) for s in sym]), lengths


def states(pos, types, lengths):
    n = len(pos)
    return (jmake_state(pos, np.ones(n), types, JBox.orthogonal(lengths)),
            make_state(pos, np.ones(n), types,
                       Box.orthogonal(lengths, device="cpu")))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("qnep")
    out = {}
    for mode in (1, 2):
        path = d / f"q{mode}.txt"
        write_model(path, mode)
        out[mode] = (jq.NEPCharge.from_file(str(path)),
                     tq.NEPCharge.from_file(str(path), dtype=torch.float64,
                                            device="cpu"))
    return out


@pytest.mark.parametrize("mode, method", [(1, "ewald"), (2, "pppm")])
def test_matches_jax(models, mode, method):
    """Both modes and both k-space methods (charge_mode 1 under PPPM also
    runs through both apps below).  The JAX oracle is jitted around the
    state, whose box its Ewald k-vectors read on the host."""
    jpot, tpot = models[mode]
    pos, types, lengths = nacl()
    jn, tn = lists(pos, lengths, tpot.rc, 120)
    js, ts = states(pos, types, lengths)
    jpot = jpot._replace(kspace_method=method, pppm_mesh=MESH)
    tpot = tpot._replace(kspace_method=method, pppm_mesh=MESH)
    want, bec, q = jax.jit(lambda nb: (
        jpot.compute_with_state(js, nb), jpot.born_effective_charges(js, nb),
        jpot.charges(js, nb)))(jn)
    got = tpot.compute_with_state(ts, tn)
    outputs_close(got, want, (mode, method))
    close(tpot.born_effective_charges(ts, tn), bec, "bec")
    close(tpot.charges(ts, tn), q, "charges")
    assert abs(float(tpot.charges(ts, tn).sum())) < 1e-12


def test_flat_vector_layout_both_ways(tmp_path):
    """The file's parameters (the port's loader) equal the JAX package's
    params_from_vector of the same vector, and the port's
    params_from_vector; write_nep_txt writes the JAX writer's bytes."""
    model, theta, qs = write_model(tmp_path / "q.txt", 1)
    jmodel = jparams.NepModel(**{f.name: getattr(model, f.name)
                                 for f in dataclasses.fields(model)})
    want = jparams.params_from_vector(jmodel, jnp.asarray(theta),
                                      jnp.asarray(qs))
    _, loaded = tparams.load_nep_txt(str(tmp_path / "q.txt"),
                                     device="cpu")
    got = tparams.params_from_vector(model, torch.as_tensor(theta),
                                     torch.as_tensor(qs))
    for field in ("w0", "b0", "w1", "b1", "w1_charge", "sqrt_epsilon_inf",
                  "c_radial", "c_angular"):
        w = np.asarray(getattr(want, field))
        np.testing.assert_array_equal(getattr(got, field).numpy(), w)
        # the file holds 8 significant digits
        np.testing.assert_allclose(getattr(loaded, field).numpy(), w,
                                   rtol=1e-7, atol=1e-7)
    assert tparams.global_bias_index(model) == jparams.global_bias_index(
        jmodel)
    jparams.write_nep_txt(str(tmp_path / "j.txt"), jmodel, theta, qs)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "q.txt"
                                                 ).read_bytes()


def test_kvectors_are_the_jax_set_and_cached(models):
    _, tpot = models[1]
    jpot, _ = models[1]
    _, _, lengths = nacl()
    box = Box.orthogonal(lengths, device="cpu")
    k, g = tpot.kvectors(box)
    jk, jg = jpot.kvectors(JBox.orthogonal(lengths))
    np.testing.assert_allclose(k.numpy(), jk, rtol=0, atol=1e-13)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-13, atol=0)
    assert tpot.kvectors(box)[0] is k  # kept for the same cell
    k2, _ = tpot.kvectors(Box.orthogonal(lengths * 1.01, device="cpu"))
    assert k2 is not k and k2.shape[0] >= k.shape[0]


def test_madelung_energy_of_point_charges(models):
    """Point charges +-1 on rocksalt (r0 = 2.82 A): real space + self +
    reciprocal (Ewald and PPPM) give -1.747565 K_C / r0 an ion pair."""
    _, tpot = models[1]
    pos, types, lengths = nacl(nc=2, jitter=0.0)
    q = torch.as_tensor(np.where(types == 0, 1.0, -1.0))
    _, tn = lists(pos, lengths, tpot.rc, 120)
    e_real = tpot.real_space_energy(q, tn.r12, tn.idx, tn.mask).sum()
    box = Box.orthogonal(lengths, device="cpu")
    k, g = tpot.kvectors(box)
    pos_t = torch.as_tensor(pos)
    e_ew = float(e_real + tpot.reciprocal_energy(q, pos_t, k, g))
    e_pp = float(e_real + tpppm.pppm_reciprocal_energy(
        q, pos_t, box, tpot._alpha(), tpppm.best_mesh(box))[0])
    want = -1.747565 * K_C / 2.82 * len(pos) / 2
    assert e_ew == pytest.approx(want, rel=1e-5)
    assert e_pp == pytest.approx(want, rel=1e-4)


def test_ewald_and_pppm_agree(models):
    """The two k-space methods on the same charges: the reciprocal
    energies within 1e-3 of the Ewald value (16^3 mesh on 11.3 A,
    order-5 splines, alpha pi/5)."""
    _, tpot = models[1]
    pos, types, lengths = nacl()
    q = torch.as_tensor(np.random.default_rng(5).normal(0, 0.5, len(pos)))
    q = q - q.mean()
    box = Box.orthogonal(lengths, device="cpu")
    k, g = tpot.kvectors(box)
    pos_t = torch.as_tensor(pos)
    e_ew = float(tpot.reciprocal_energy(q, pos_t, k, g))
    e_pp = float(tpppm.pppm_reciprocal_energy(q, pos_t, box, tpot._alpha(),
                                              MESH)[0])
    assert abs(e_pp - e_ew) <= 1e-3 * abs(e_ew)


def _deck(src, method, extra=""):
    src.mkdir(parents=True, exist_ok=True)
    pos, types, lengths = nacl(jitter=0.03)
    sets.model_xyz(src, np.array(["Na", "Cl"])[types], pos,
                   np.diag(lengths), 300.0, 3, (True, True, True),
                   groups=np.zeros(len(pos), int))
    write_model(src / "qnep.txt", 1)
    (src / "run.in").write_text(
        f"kspace {method}\npotential qnep.txt\ntime_step 1\nensemble nve\n"
        f"{extra}dump_thermo 2\nrun 6\n")


def test_app_qnep_pppm_matches_jax(tmp_path, monkeypatch):
    """`kspace pppm` (before `potential`), compute_dpdt and compute_es
    through both apps, 6 NVE steps: positions, the last per-atom outputs,
    thermo.out, dpdt.out and the two electrostatic files within 1e-9."""
    src = tmp_path / "src"
    _deck(src, "pppm", "compute_dpdt 2\ncompute_es 3\n")
    dirs, js, ts = app_pair(tmp_path, src, monkeypatch)
    assert isinstance(ts.potentials[0], tq.NEPCharge)
    assert ts.potentials[0].kspace_method == "pppm"
    app_outputs_close(dirs, js, ts, [
        "thermo.out", "dpdt.out", "elactrostatic_energy.out",
        "elactrostatic_force.out"])
    dp = np.loadtxt(dirs["torch"] / "dpdt.out")
    # dpdt.out integrates to its P columns
    np.testing.assert_allclose(
        np.cumsum(dp[:, 1:4], 0) * 2.0 / TIME_UNIT_CONVERSION, dp[:, 4:],
        rtol=1e-9, atol=1e-14)


def test_app_ewald_matches_a_direct_run(tmp_path):
    """`kspace ewald` after `potential`, with `add_efield ... bec`: the
    app's run against ForceField + MDRunner with AddEfield on the Born
    charges of a fresh list from the app's start, 6 NVE steps, within
    1e-10 (the driver's F += Z* E against the JAX driver's:
    tests/test_torch_drivers.py)."""
    import gpumd_tpu_torch.app.gpumd as tapp
    from gpumd_tpu_torch.forcefield import ForceField
    from gpumd_tpu_torch.integrate.drivers import AddEfield
    from gpumd_tpu_torch.integrate.ensembles.nve import NVE
    from gpumd_tpu_torch.integrate.run import MDRunner

    _deck(tmp_path, "ewald", "add_efield 0 0 0.2 -0.1 0.05 bec\n")
    text = (tmp_path / "run.in").read_text()
    (tmp_path / "run.in").write_text(
        text.replace("kspace ewald\npotential qnep.txt\n",
                     "potential qnep.txt\nkspace ewald\n"))
    s = tapp.Session(str(tmp_path), quiet=True, device="cpu",
                     dtype=torch.float64)
    s.execute()
    pot = s.potentials[0]
    assert pot.kspace_method == "ewald" and s.ff.potentials[0] is pot
    start = tapp.Session(str(tmp_path), quiet=True, device="cpu",
                         dtype=torch.float64)
    start.kw_potential(["qnep.txt"])
    ff = ForceField.create([pot], start.box, s._n, mn=s.ff.neighbor.mn,
                           skin=1.0)

    def bec_fn(st):
        pos = st.box.wrap(st.position)
        return pot.born_effective_charges(
            st, ff.neighbor.build(pos, st.box, st.mask))

    drv = AddEfield(gmask=torch.ones(s._n, dtype=torch.float64),
                    table=np.array([[0.2, -0.1, 0.05]]), use_bec=True,
                    bec_fn=bec_fn)
    with torch.no_grad():
        direct, _, _ = MDRunner(ff, NVE(), s.dt, 6, drivers=(drv,))(
            ff.compute(start.state))
    dx = s.state.box.minimum_image(s.state.position - direct.position)
    assert float(dx.abs().max()) <= 1e-10
    pe = np.loadtxt(tmp_path / "thermo.out")[-1, 2]
    want = float(torch.sum(direct.potential_energy))
    assert abs(pe - want) <= 1e-10 * abs(want)
