"""The port's phonon module (gpumd_tpu_torch/phonon/hessian.py) against the
JAX package's on the CPU in float64, on LJ argon: kpoints.in parsing and
the k-path equal; the force constants of a 2x2x2 conventional supercell
within 1e-8 eV/A^2; through both apps, `replicate` then `compute_phonon`
on a primitive fcc cell: the dynamical matrices and the returned omega^2
within 1e-8 of their largest magnitude, omega2.out's header byte for
byte, and both files' numbers alike to the digits they print."""

import numpy as np
import pytest
import torch

from gpumd_tpu.forcefield import ForceField as JFF
from gpumd_tpu.io.xyz import XYZFrame, write_xyz
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.phonon import hessian as jhess
from gpumd_tpu.potentials.lj import LJ as JLJ
from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.phonon import hessian as thess
from gpumd_tpu_torch.potentials.lj import LJ
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

LJ_PARAMS = (1.032e-2, 3.405, 9.0)  # the repo's lj.txt
A0 = 5.26
MASS = 39.948
REL = 1e-8
KPOINTS = ("0 0 0 G\n0.5 0 0.5 X\n0.375 0.375 0.75 K\n\n"
           "0 0 0 G\n0.5 0.5 0.5 L\n")


def _fcc_primitive():
    return 0.5 * A0 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])


def test_kpath_equals_jax(tmp_path):
    p = tmp_path / "kpoints.in"
    p.write_text("# a comment\n" + KPOINTS)
    jseg, jnames = jhess.parse_kpoints_in(str(p))
    seg, names = thess.parse_kpoints_in(str(p))
    assert names == jnames == ["G X K", "G L"]
    assert [len(s) for s in seg] == [len(s) for s in jseg]
    for a, b in zip(sum(seg, []), sum(jseg, [])):
        np.testing.assert_array_equal(a, b)
    rows = _fcc_primitive() * 4
    for got, want in zip(thess.build_kpath(seg, rows),
                         jhess.build_kpath(jseg, rows)):
        np.testing.assert_array_equal(got, want)


def test_force_constants_match_jax():
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.array([[i, j, k] for i in range(2) for j in range(2)
                      for k in range(2)])
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * A0
    pos = pos + np.random.default_rng(4).normal(0, 0.02, pos.shape)
    n, lengths = len(pos), np.full(3, 2 * A0)
    jbox = JBox.orthogonal(lengths)
    jff = JFF.create([JLJ.from_params(*LJ_PARAMS)], jbox, n, mn=160)
    jst = jmake_state(pos, np.full(n, MASS), np.zeros(n, int), jbox)
    box = Box.orthogonal(lengths, device="cpu")
    ff = ForceField.create([LJ.from_params(*LJ_PARAMS, device="cpu")], box,
                           n, mn=160)
    st = make_state(pos, np.full(n, MASS), np.zeros(n, int), box)
    want = jhess.force_constants(jff, jst, [0, 1, 2, 3], 0.01)
    got = thess.force_constants(ff, st, [0, 1, 2, 3], 0.01).numpy()
    assert got.shape == want.shape == (4, 3, n, 3)
    assert np.abs(got - want).max() <= 1e-8


def _primitive_deck(d):
    d.mkdir()
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar"], positions=np.zeros((1, 3)), lattice=_fcc_primitive(),
        pbc=(True, True, True)))
    (d / "lj.txt").write_text("lj 1 Ar\n{} {} {}\n".format(*LJ_PARAMS))
    (d / "kpoints.in").write_text(KPOINTS)
    (d / "run.in").write_text(
        "potential lj.txt\nreplicate 4 4 4\ncompute_phonon 0.01\n")


def _numbers(path, comments=None):
    return np.loadtxt(path, comments=comments)


def test_compute_phonon_after_replicate_matches_jax(tmp_path):
    import gpumd_tpu_torch.app.gpumd as tapp
    from gpumd_tpu.app import gpumd as japp

    for pkg in ("jax", "torch"):
        _primitive_deck(tmp_path / pkg)
    jd = []
    eigvalsh = np.linalg.eigvalsh

    def record(d):
        jd.append(np.array(d))
        return eigvalsh(d)

    returned = {}

    def keep_return(fn, key):
        def wrapped(*a, **k):
            returned[key] = fn(*a, **k)
            return returned[key]
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np.linalg, "eigvalsh", record)
        mp.setattr(jhess, "compute_phonon_dispersion", keep_return(
            jhess.compute_phonon_dispersion, "jax"))
        js = japp.Session(str(tmp_path / "jax"), quiet=True)
        js.execute()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thess, "dynamical_matrices", keep_return(
            thess.dynamical_matrices, "d"))
        mp.setattr(tapp, "compute_phonon_dispersion", keep_return(
            tapp.compute_phonon_dispersion, "torch"))
        ts = tapp.Session(str(tmp_path / "torch"), quiet=True, device="cpu",
                          dtype=torch.float64)
        ts.execute()
    assert ts.replicate_cxyz == js.replicate_cxyz == (4, 4, 4)
    want_d, got_d = np.stack(jd), returned["d"].numpy()
    assert got_d.shape == want_d.shape == (301, 3, 3)
    assert np.abs(got_d - want_d).max() <= REL * np.abs(want_d).max()
    (jk, jw), (tk, tw) = returned["jax"], returned["torch"]
    np.testing.assert_array_equal(tk, jk)
    assert np.abs(tw - jw).max() <= REL * np.abs(jw).max()
    # omega2.out: the header byte for byte, omega^2 at the digits printed
    jo, to = (tmp_path / p / "omega2.out" for p in ("jax", "torch"))
    assert to.read_text().splitlines()[0] == jo.read_text().splitlines()[0]
    want, got = _numbers(jo, "#"), _numbers(to, "#")
    assert got.shape == want.shape == (301, 4)
    # the acoustic branches vanish at Gamma, and rise away from it
    assert np.abs(got[0, 1:]).max() < 1e-3 and got[50, 1] > 1.0
    scale = np.abs(want[:, 1:]).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    jdf, tdf = (tmp_path / p / "D.out" for p in ("jax", "torch"))
    want, got = _numbers(jdf), _numbers(tdf)
    assert got.shape == want.shape == (301 * 3, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())

