"""Shared harness of the tests of the last potentials (tests/
test_torch_ilp.py, test_torch_fcp_dp.py, test_torch_dftd3.py,
test_torch_qnep.py): the JAX package's neighbour list handed to both
packages, the comparison of outputs relative to their largest magnitude,
and one run.in through both apps in float64 on the CPU (the JAX app at
the port's list capacity, so neither truncates a row and both lists keep
the same slot order)."""

import shutil
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.box import num_replicas_for_cutoff as jreps
from gpumd_tpu.neighbor.neighbor import neighbor_brute as jbrute
from gpumd_tpu_torch.neighbor.neighbor import NeighborList

# module-level parity: relative to each quantity's largest magnitude
TOL = 1e-10
# the app decks: positions (A) and every output column, relative
APP_TOL = 1e-9


def lists(pos, lengths, rc, mn, pbc=(True, True, True)):
    """(JAX list, the port's NeighborList with the same slots) at rc from
    the JAX package's brute-force builder, MN cut to the fullest row
    (rounded up to even) when `mn` has room to spare: the JAX many-body
    oracles' (N, MN, MN) tensors stay small."""
    jbox = JBox.orthogonal(np.asarray(lengths, float), pbc=pbc)

    def build(m):
        return jbrute(jnp.asarray(pos), jbox, jnp.ones(len(pos)), rc=rc,
                      mn=m, reps=jreps(jbox, rc))

    jn = build(mn)
    fullest = int(jnp.max(jn.count))
    assert fullest <= mn
    if fullest + (fullest & 1) < mn:
        jn = build(fullest + (fullest & 1))
    tn = NeighborList(idx=torch.as_tensor(np.array(jn.idx)),
                      r12=torch.as_tensor(np.array(jn.r12)),
                      mask=torch.as_tensor(np.array(jn.mask)),
                      count=torch.as_tensor(np.array(jn.count)))
    return jn, tn


def close(got, want, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err, scale)


def outputs_close(got, want, what, tol=TOL):
    for field in ("energy", "force", "virial"):
        close(getattr(got, field), getattr(want, field), (what, field), tol)


def app_pair(tmp: Path, src: Path, monkeypatch, runfile="run.in"):
    """src's deck (model.xyz, run.in and the potential files) through the
    JAX app and the port's (float64 on the CPU) in copies of it: (dirs,
    JAX session, port session).  The JAX app takes the port's MN."""
    import gpumd_tpu_torch.app.gpumd as tapp
    from gpumd_tpu.app import gpumd as japp

    dirs = {}
    for pkg in ("torch", "jax"):
        dirs[pkg] = tmp / pkg
        shutil.copytree(src, dirs[pkg])
    ts = tapp.Session(str(dirs["torch"]), quiet=True, device="cpu",
                      dtype=torch.float64)
    ts.execute(runfile)
    # the JAX app at the port's capacity, or at the fullest row of the
    # port's last state + 16 where that is less (its many-body tensors
    # grow with MN^2); the port's run raises if a row outgrew its own
    # capacity, and the JAX app's last rows are checked against its own
    st = ts.state
    nbr = ts.ff.neighbor.build(st.box.wrap(st.position), st.box, st.mask)
    mn = min(ts.ff.neighbor.mn, int(nbr.count.max()) + 16)
    monkeypatch.setattr(japp, "_auto_mn", lambda *a, **k: mn)
    js = japp.Session(str(dirs["jax"]), quiet=True)
    js.execute(runfile)
    assert ts.global_step == js.global_step > 0
    jst = js.state
    jn = js.ff.neighbor.build(jst.box.wrap(jst.position), jst.box, jst.mask)
    assert int(jnp.max(jn.count)) <= js.ff.neighbor.mn
    return dirs, js, ts


def app_outputs_close(dirs, js, ts, files, tol=APP_TOL):
    """The final positions (minimum image), the last force pass's per-atom
    energies, forces and virials, and each file's columns within tol of
    the JAX app's, relative to each one's largest magnitude."""
    for field in ("potential_energy", "force", "virial"):
        close(getattr(ts.state, field), getattr(js.state, field), field,
              tol)
    lengths = np.diag(np.asarray(js.box.h))
    dx = ts.state.position.double().numpy() - np.asarray(js.state.position)
    pbc = np.asarray(js.box.pbc, bool)
    dx[:, pbc] -= np.round(dx[:, pbc] / lengths[pbc]) * lengths[pbc]
    assert np.abs(dx).max() <= tol, np.abs(dx).max()
    for name in files:
        got, want = (np.atleast_2d(np.loadtxt(dirs[p] / name))
                     for p in ("torch", "jax"))
        assert got.shape == want.shape and got.size, name
        err = (np.abs(got - want).max(0)
               / np.maximum(np.abs(want).max(0), 1e-30)).max()
        assert err <= tol, (name, err)


class StubDeepPot:
    """Lennard-Jones argon on the host in numpy (all pairs, minimum
    image), with a type map in another order than the files'."""

    def __init__(self, path):
        self.path = path

    def get_rcut(self):
        return 6.0

    def get_type_map(self):
        return ["Xe", "Ar"]

    def eval(self, coords, cell, atype, atomic=False):
        c = coords.reshape(-1, 3)
        h = np.asarray(cell).reshape(3, 3).T
        r = c[None, :, :] - c[:, None, :]
        s = r @ np.linalg.inv(h).T
        r = (s - np.round(s)) @ h.T
        d2 = np.sum(r * r, -1) + np.eye(len(c))
        eps = np.where(np.asarray(atype) == 1, 1.032e-2, 2.0e-2)
        e_ij = np.sqrt(eps[:, None] * eps[None, :])
        sr6 = (3.405 ** 2 / d2) ** 3
        off = 1.0 - np.eye(len(c))
        ae = 0.5 * np.sum(4 * e_ij * (sr6 * sr6 - sr6) * off, 1)
        g = 24 * e_ij * (2 * sr6 * sr6 - sr6) / d2 * off  # -dE/dr / r
        f = -np.sum(g[..., None] * r, 1)
        av = -0.5 * np.einsum("ija,ijb->iab", r, g[..., None] * r)
        return (np.array([[ae.sum()]]), f.reshape(1, -1),
                av.sum(0).reshape(1, 9), ae.reshape(1, -1),
                av.reshape(1, -1))


@pytest.fixture()
def stub_deepmd(monkeypatch):
    """StubDeepPot as `deepmd.infer.DeepPot` in sys.modules (deepmd-kit is
    on neither machine; the stub lives in the tests, never the package)."""
    mod = types.ModuleType("deepmd")
    infer = types.ModuleType("deepmd.infer")
    infer.DeepPot = StubDeepPot
    mod.infer = infer
    monkeypatch.setitem(sys.modules, "deepmd", mod)
    monkeypatch.setitem(sys.modules, "deepmd.infer", infer)
