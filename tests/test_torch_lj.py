"""The port's LJ potential, potentials/base.py and md_run vs the JAX
package, f64 on the CPU.

BASELINE config 1's potential (the repo's lj.txt: Ar, eps 1.032e-2 eV,
sigma 3.405 A, cutoff 9 A) on jittered fcc argon: energy, force and virial
of `LJ.compute` through both reductions of `forces_virial_from_partials`
(the gather through the reverse map and the scatter) and the total-only
virial; 50-step `md_run` trajectories under NVE and NVT-Berendsen from the
same injected velocities (positions and velocities within atol 1e-9).
Energies rtol 1e-9 / atol 1e-10, forces and virials rtol 1e-8 / atol 1e-9
(tests/test_torch_nep_slice.py's).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.forcefield import ForceField as JFF
from gpumd_tpu.integrate.ensembles.nve import NVE as JNVE
from gpumd_tpu.integrate.ensembles.nvt import NVTBerendsen as JBer
from gpumd_tpu.integrate.run import md_run as jmd_run
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.base import forces_virial_from_partials as jfvp
from gpumd_tpu.potentials.lj import LJ as JLJ
from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.integrate.ensembles.nvt import NVTBerendsen
from gpumd_tpu_torch.integrate.run import md_run
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.neighbor.neighbor import NeighborList
from gpumd_tpu_torch.potentials.base import forces_virial_from_partials
from gpumd_tpu_torch.potentials.lj import LJ
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION
from torch_one_thread import one_torch_thread  # noqa: F401

LJ_FILE = str(Path(__file__).resolve().parent.parent / "lj.txt")
E_TOL = dict(rtol=1e-9, atol=1e-10)
F_TOL = dict(rtol=1e-8, atol=1e-9)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _argon(nc=4, a0=5.26, jitter=0.08, seed=0):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0, jitter, pos.shape)
    vel = rng.normal(0, np.sqrt(K_B * 80.0 / 39.948), pos.shape)
    return pos, vel - vel.mean(0), np.full(3, nc * a0)


@pytest.fixture(scope="module")
def pair():
    """Both packages' force fields and initial states (skin 1.0, MN 160:
    rc + skin = 10 A takes the first seven fcc shells, 134 neighbours)."""
    pos, vel, lengths = _argon()
    n = len(pos)
    with jax.enable_x64(True):
        jbox = JBox.orthogonal(lengths)
        jff = JFF.create([JLJ.from_file(LJ_FILE)], jbox, n, mn=160, skin=1.0)
        js = jax.jit(jff.compute)(jmake_state(
            pos, np.full(n, 39.948), np.zeros(n, int), jbox, velocity=vel))
    box = Box.orthogonal(lengths, device="cpu")
    ff = ForceField.create([LJ.from_file(LJ_FILE, device="cpu")], box, n,
                           mn=160, skin=1.0)
    ts = ff.compute(make_state(pos, np.full(n, 39.948), np.zeros(n, int),
                               box, velocity=vel))
    return jff, js, ff, ts


def test_lj_from_file_and_params():
    lj = LJ.from_file(LJ_FILE, device="cpu")
    jlj = JLJ.from_file(LJ_FILE)
    assert lj.rc == jlj.rc == 9.0
    for f in ("s6e4", "s12e4", "cutoff_sq"):
        np.testing.assert_array_equal(_np(getattr(lj, f)),
                                      np.asarray(getattr(jlj, f)))
    eps = np.array([[1e-2, 2e-2], [2e-2, 3e-2]])
    sig = np.array([[3.0, 3.2], [3.2, 3.4]])
    cut = np.array([[8.0, 8.5], [8.5, 9.0]])
    two, jtwo = LJ.from_params(eps, sig, cut, device="cpu"), JLJ.from_params(
        eps, sig, cut)
    assert two.rc == jtwo.rc == 9.0
    np.testing.assert_array_equal(_np(two.s12e4), np.asarray(jtwo.s12e4))
    with pytest.raises(ValueError):
        LJ.from_file(str(Path(__file__).resolve().parent.parent / "model.xyz"),
                     device="cpu")


def test_lj_compute_matches(pair):
    jff, js, ff, ts = pair
    assert dataclasses.astuple(ff.neighbor) == dataclasses.astuple(
        jff.neighbor)
    np.testing.assert_allclose(_np(ts.potential_energy),
                               np.asarray(js.potential_energy), **E_TOL)
    np.testing.assert_allclose(_np(ts.force), np.asarray(js.force), **F_TOL)
    np.testing.assert_allclose(_np(ts.virial), np.asarray(js.virial), **F_TOL)
    np.testing.assert_allclose(_np(ts.heat_current),
                               np.asarray(js.heat_current), **F_TOL)
    np.testing.assert_allclose(_np(ts.position), np.asarray(js.position),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("per_atom_virial", [True, False])
def test_lj_two_types_total_virial(per_atom_virial):
    """Two types on a brute-force list without a reverse map: the scatter
    reduction, and with per_atom_virial False the total spread evenly."""
    pos, _, lengths = _argon(nc=3, seed=1)
    n = len(pos)
    types = np.arange(n) % 2
    eps = np.array([[1e-2, 1.5e-2], [1.5e-2, 2e-2]])
    sig = np.array([[3.3, 3.4], [3.4, 3.5]])
    cut = np.array([[7.0, 7.5], [7.5, 8.0]])
    with jax.enable_x64(True):
        jbox = JBox.orthogonal(lengths)
        jff = JFF.create([JLJ.from_params(eps, sig, cut)], jbox, n, mn=200,
                         per_atom_virial=per_atom_virial)
        js = jax.jit(jff.compute)(jmake_state(pos, np.ones(n), types, jbox))
    box = Box.orthogonal(lengths, device="cpu")
    ff = ForceField.create([LJ.from_params(eps, sig, cut, device="cpu")], box,
                           n, mn=200, per_atom_virial=per_atom_virial)
    assert ff.neighbor.method == "brute" and ff.neighbor.reps != (0, 0, 0)
    ts = ff.compute(make_state(pos, np.ones(n), types, box))
    np.testing.assert_allclose(_np(ts.potential_energy),
                               np.asarray(js.potential_energy), **E_TOL)
    np.testing.assert_allclose(_np(ts.force), np.asarray(js.force), **F_TOL)
    np.testing.assert_allclose(_np(ts.virial), np.asarray(js.virial), **F_TOL)


def test_forces_virial_from_partials_both_paths(pair):
    """The gather through rev and the scatter on the same partials agree
    with the JAX package's two paths, and with each other."""
    _, _, ff, ts = pair
    cache = ff.refresh_cache(ts)
    nbr = ff.cache_r12(ts, cache)
    rng = np.random.default_rng(3)
    p = rng.normal(0, 1, tuple(nbr.r12.shape)) * _np(nbr.mask)[..., None]
    tp = torch.as_tensor(p)
    from gpumd_tpu.neighbor.neighbor import NeighborList as JNL

    with jax.enable_x64(True):
        jn = JNL(*(jnp.asarray(_np(x)) for x in nbr[:4]),
                 rev=jnp.asarray(_np(nbr.rev)))
        jg = jfvp(jnp.asarray(p), jn)
        js = jfvp(jnp.asarray(p), jn._replace(rev=None))
    g = forces_virial_from_partials(tp, nbr)
    s = forces_virial_from_partials(tp, NeighborList(*nbr[:4]))
    for got, want in ((g, jg), (s, js)):
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **F_TOL)
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), **F_TOL)
    # a mirror-symmetric partial (p_ji = -p_ij) makes the two agree
    sym = 0.5 * (tp - tp.reshape(-1, 3)[nbr.rev.long()]
                 * nbr.mask[..., None])
    a = forces_virial_from_partials(sym, nbr)
    b = forces_virial_from_partials(sym, NeighborList(*nbr[:4]))
    np.testing.assert_allclose(_np(a[0]), _np(b[0]), **F_TOL)


@pytest.mark.parametrize("ens", ["nve", "nvt_ber"])
def test_lj_md_run_matches(pair, ens):
    """50 steps of 2 fs: positions, velocities and thermo as the JAX
    package's md_run (the Verlet cache rebuilt on the same steps)."""
    jff, js, ff, ts = pair
    dt = 2.0 / TIME_UNIT_CONVERSION
    jens, tens = ((JNVE(), NVE()) if ens == "nve" else
                  (JBer(t0=60.0, coupling=20.0),
                   NVTBerendsen(t0=60.0, coupling=20.0)))
    with jax.enable_x64(True):
        jf, _, jth = jmd_run(js, jff, jens, dt, 50)
    tf, (_, cache), th = md_run(ts, ff, tens, dt, 50)
    np.testing.assert_allclose(_np(tf.position), np.asarray(jf.position),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(tf.velocity), np.asarray(jf.velocity),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(th.potential_energy),
                               np.asarray(jth.potential_energy), **E_TOL)
    np.testing.assert_allclose(_np(th.pressure), np.asarray(jth.pressure),
                               **F_TOL)
    assert th.temperature.shape == (50,)
    assert int(cache.count.max()) <= ff.neighbor.mn
