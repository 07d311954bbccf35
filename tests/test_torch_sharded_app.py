"""The port's multi-device surface beside the slab engine, f64 on the CPU:
the atom-sharded list path (gpumd_tpu_torch/parallel/domain.py), SNES
over devices (train/snes.py) and the app's `engine dense N`.

(g) ShardedMD on 8 CPU entries against JAX ShardedMD on the conftest
8-device mesh at tests/test_sharded.py's sizes: LJ argon, 128 random
atoms in 22 A, MN 128 (brute force with images; 1e-12), and the tiny NEP
of tests/test_torch_sharded.py on 128 atoms with 32 padding rows (1e-10),
and rtol 1e-12 (random atoms come close: energies reach 2e7 eV); the
cell-list build (4,096 LJ atoms in 48 A, as that file's cell test)
against the port's single-device ForceField (1e-11).  The JAX oracles
run through jax.jit (op by op they take ~24 s each).  (h) SNES: a
population of 10 becomes 16 on 8 devices, as in the JAX test, and one
generation with the same injected draws gives the single-device
trainer's mu, sigma and loss.out row.  (i) JAX tests/test_sharded_dense
.py's Ar deck (325 atoms, a random NEP, `velocity 50`, NVE, 6 steps of 2
fs) under `engine dense 4` writes the same thermo.out as under `engine
dense` on one device (1e-9 of each column's largest value), and logs its
placement; `engine dense 2 x` runs too.  A deck whose 12-step chunk
outruns skin/2 takes the retry in one-step blocks, which rebins before
each, and still writes the one-device thermo.out.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpumd_tpu_torch.app.gpumd as tapp
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.parallel.domain import ShardedMD as JShardedMD
from gpumd_tpu.parallel.domain import make_mesh as jmake_mesh
from gpumd_tpu.potentials.lj import LJ as JLJ
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu.potentials.nep.params import NepModel as JModel
from gpumd_tpu.potentials.nep.params import random_params as jrandom_params
from gpumd_tpu_torch.forcefield import ForceField
from gpumd_tpu_torch.io.nep_input import NepTrainConfig, model_from_config
from gpumd_tpu_torch.io.xyz import XYZFrame, write_xyz
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.parallel.domain import ShardedMD, make_mesh, sort_by_slab
from gpumd_tpu_torch.potentials.lj import LJ
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import (
    NepModel,
    num_trainable,
    params_from_numpy,
    write_nep_txt,
)
from gpumd_tpu_torch.train.dataset import batch_structures
from gpumd_tpu_torch.train.snes import SNESTrainer
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
LJ_ARGS = (1.032e-2, 3.405, 8.0)
TINY = dict(
    version=4, model_type=0, num_types=2, symbols=("Te", "Pb"),
    atomic_numbers=(52, 82), rc_radial=(4.0, 4.0), rc_angular=(2.5, 2.5),
    mn_radial=48, mn_angular=16, n_max_radial=2, n_max_angular=2,
    basis_size_radial=2, basis_size_angular=2, l_max=2, has_q=(0,) * 6,
    neurons=4)


def _np(x):
    return x.detach().cpu().numpy()


def _states(pos, types, lengths, n_pad=None):
    mass = np.full(len(pos), 39.948)
    tbox = Box.orthogonal(lengths, dtype=torch.float64, device=CPU)
    jbox = JBox.orthogonal(lengths)
    return (make_state(pos, mass, types, tbox, n_pad=n_pad), tbox,
            jmake_state(pos, mass, types, jbox, n_pad=n_pad,
                        dtype=jnp.float64), jbox)


def _jax_sharded(pots, jstate, jbox, n, mn):
    smd = JShardedMD.create(pots, jbox, n, jmake_mesh(8), mn=mn)
    return jax.jit(smd.compute_forces)(smd.shard_state(jstate))


@pytest.mark.parametrize("pot", ["lj", "nep"])
def test_sharded_md_matches_jax_sharded_md(pot):
    rng = np.random.default_rng(0)
    n, lengths = 128, [22.0] * 3
    pos = rng.uniform(0, 1, (n, 3)) * 22.0
    if pot == "lj":
        types, n_pad, mn, tol = np.zeros(n, int), None, 128, 1e-12
        tpots = [LJ.from_params(*LJ_ARGS, device=CPU)]
        jpots = [JLJ.from_params(*LJ_ARGS)]
    else:
        # sorted into slabs along x, padded to 160 rows (8 x 20)
        pos = pos[sort_by_slab(pos, Box.orthogonal(lengths, device=CPU))]
        types, n_pad, mn, tol = rng.integers(0, 2, n), 160, 64, 1e-10
        jm = JModel(**TINY)
        jp = jrandom_params(jm, seed=7, dtype=jnp.float64)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device=CPU)
        tpots = [NEP(model=NepModel(**TINY), params=tp)]
        jpots = [JNEP(model=jm, params=jp)]
    st, tbox, jst, jbox = _states(pos, types, lengths, n_pad)
    ref = _jax_sharded(jpots, jst, jbox, n, mn)
    smd = ShardedMD.create(tpots, tbox, n, [CPU] * 8, mn=mn)
    assert smd.neighbor.method == "brute"
    out = smd.compute_forces(smd.shard_state(st))
    for k in ("potential_energy", "force", "virial", "heat_current"):
        np.testing.assert_allclose(_np(getattr(out, k)),
                                   np.asarray(getattr(ref, k)), rtol=1e-12,
                                   atol=tol)
    if n_pad:
        assert float(out.force[n:].abs().max()) == 0.0


def test_sharded_cell_list_matches_force_field():
    rng = np.random.default_rng(1)
    n, lengths = 4096, [48.0] * 3
    pos = rng.uniform(0, 1, (n, 3)) * 48.0
    st, tbox, _, _ = _states(pos, np.zeros(n, int), lengths)
    lj = LJ.from_params(*LJ_ARGS, device=CPU)
    ref = ForceField.create([lj], tbox, n, mn=128).compute(st)
    smd = ShardedMD.create([lj], tbox, n, make_mesh(4, device="cpu"),
                           mn=128)
    assert smd.neighbor.method == "cell" and len(smd.devices) == 4
    out = smd.compute_forces(st)
    for k in ("potential_energy", "force", "virial"):
        np.testing.assert_allclose(_np(getattr(out, k)),
                                   _np(getattr(ref, k)), rtol=1e-12,
                                   atol=1e-11)


# --------------------------------------------------------------------------
# (h) SNES over devices
# --------------------------------------------------------------------------


def _snes_setup():
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(4):
        frames.append(XYZFrame(
            symbols=["Si"] * 4, positions=rng.random((4, 3)) * 4 + 0.5,
            lattice=np.diag([6.0, 6.0, 6.0]), pbc=(True,) * 3,
            info={"energy": str(rng.normal())},
            forces=rng.normal(size=(4, 3)) * 0.1))
    cfg = NepTrainConfig(
        num_types=1, symbols=("Si",), rc_radial=5.0, rc_angular=4.0,
        n_max_radial=2, n_max_angular=2, basis_size_radial=2,
        basis_size_angular=2, l_max=4, l_max_4body=0, neurons=4,
        population_size=10, maximum_generation=1, output_interval=1)
    model = model_from_config(cfg)
    batch = batch_structures(frames, cfg.symbols, rc=5.0, mn=16,
                             dtype=torch.float64, device=CPU)
    return model, cfg, batch


def test_snes_population_over_devices(tmp_path):
    model, cfg, batch = _snes_setup()
    multi = SNESTrainer(model, cfg, [batch], workdir=str(tmp_path / "m"),
                        dtype=torch.float64, devices=[CPU] * 8)
    assert multi.cfg.population_size == 16 and len(multi.devices) == 8
    single = SNESTrainer(model, dataclasses.replace(cfg, population_size=16),
                         [batch], workdir=str(tmp_path / "s"),
                         dtype=torch.float64)
    assert single.devices == [CPU]
    d = num_trainable(model)
    z = torch.as_tensor(np.random.default_rng(3).normal(size=(16, d)))

    def draws(state):
        return z, state.mu[None, :] + state.sigma[None, :] * z

    for tr in (multi, single):
        (tmp_path / Path(tr.workdir).name).mkdir()
        tr._sample = draws
        tr.train(generations=1, log=lambda *a: None)
    np.testing.assert_allclose(_np(multi.state.mu), _np(single.state.mu),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(_np(multi.state.sigma),
                               _np(single.state.sigma), rtol=1e-12,
                               atol=1e-14)
    rows = [np.loadtxt(tmp_path / w / "loss.out") for w in ("m", "s")]
    np.testing.assert_allclose(rows[0], rows[1], rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------------------
# (i) the app's `engine dense N`
# --------------------------------------------------------------------------


def _ar_deck(d: Path, engine: str, velocity=50, steps=6, every=2):
    """JAX tests/test_sharded_dense.py::test_engine_dense_sharded_keyword's
    deck: 5 x 5 x 13 argon sites at 3.2 A, jittered 0.2 A, in 16 x 16 x
    41.6 A, a random NEP (rc 4/2.5, n_max 2/2, l_max 4, 4 neurons);
    `every` is dump_thermo's interval, and so the chunk."""
    d.mkdir()
    cfg = NepTrainConfig(
        num_types=1, symbols=("Ar",), rc_radial=4.0, rc_angular=2.5,
        n_max_radial=2, n_max_angular=2, basis_size_radial=2,
        basis_size_angular=2, l_max=4, l_max_4body=0, neurons=4)
    model = model_from_config(cfg)
    theta = np.random.default_rng(0).normal(0, 0.2, num_trainable(model))
    write_nep_txt(str(d / "nep.txt"), model, theta, np.ones(model.dim))
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5), np.arange(13),
                             indexing="ij"), -1).reshape(-1, 3)
    pos = g * 3.2 + np.random.default_rng(1).uniform(-0.2, 0.2, g.shape)
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar"] * len(pos), positions=pos,
        lattice=np.diag([16.0, 16.0, 41.6]), pbc=(True, True, True)))
    (d / "run.in").write_text(
        f"potential nep.txt\nvelocity {velocity}\ntime_step 2\n"
        f"ensemble nve\nengine {engine}\ndump_thermo {every}\n"
        f"run {steps}\n")
    return d


def _run_deck(d: Path):
    logs = []
    s = tapp.Session(str(d), quiet=True, device="cpu", dtype=torch.float64)
    s.log = logs.append
    s.execute()
    return s, np.loadtxt(d / "thermo.out"), logs


def test_engine_dense_n_matches_one_device(tmp_path):
    s1, one, _ = _run_deck(_ar_deck(tmp_path / "one", "dense"))
    s4, four, logs = _run_deck(_ar_deck(tmp_path / "four", "dense 4"))
    assert s4.md.ndev == 4 and s4.md.engine == "compact"
    assert s1.md.plan.grid == s4.md.plan.grid
    assert any("4 slabs on 1 device(s): 4 on cpu (slabs share a device)"
               in line for line in logs)
    assert one.shape == four.shape == (3, 18)
    assert np.all(np.abs(four - one) <= 1e-9 * np.abs(one).max(axis=0))
    s2, two, _ = _run_deck(_ar_deck(tmp_path / "x", "dense 2 x"))
    assert s2.md.axis == "x" and s2.md.ndev == 2
    np.testing.assert_allclose(two[:, :3], one[:, :3], rtol=1e-9)


def _crossing_deck(d: Path, engine: str):
    """_ar_deck's lattice (cells 5.2 A thick in z) at rest but for two
    atoms of neighbouring columns, binned two cell layers apart (z 9.6 and
    16.0), that close in along z at 0.1 A/fs each: 0.2 A a 2 fs step,
    past skin/2 in a 12-step chunk, and within rc (4 A) of each other
    after ~10 steps.  The two lattice atoms in their way are taken out."""
    base = _ar_deck(d, engine, steps=12, every=12)
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5), np.arange(13),
                             indexing="ij"), -1).reshape(-1, 3)
    pos = g * 3.2 + np.random.default_rng(1).uniform(-0.2, 0.2, g.shape)
    site = {tuple(x): i for i, x in enumerate(g)}
    vel = np.zeros_like(pos)
    vel[site[(2, 2, 3)], 2] = 0.1
    vel[site[(3, 2, 5)], 2] = -0.1
    keep = np.ones(len(g), bool)
    keep[[site[(2, 2, 4)], site[(3, 2, 4)]]] = False
    write_xyz(str(d / "model.xyz"), XYZFrame(
        symbols=["Ar"] * int(keep.sum()), positions=pos[keep],
        velocities=vel[keep], lattice=np.diag([16.0, 16.0, 41.6]),
        pbc=(True, True, True)), with_velocities=True)
    run = (d / "run.in").read_text().replace("velocity 50\n", "")
    (d / "run.in").write_text(run)
    return base


def test_engine_dense_n_retry_rebins_each_step(tmp_path):
    """_crossing_deck's chunk outruns skin/2, so its block reports `ok`
    False and the retry runs one-step blocks with a global rebin before
    each; thermo.out equals the single-domain run (which rebuilds its
    own lists).  Without the rebins the two atoms' cells stay two layers
    apart and their pair is lost."""
    _, one, _ = _run_deck(_crossing_deck(tmp_path / "one", "dense"))
    _, two, logs = _run_deck(_crossing_deck(tmp_path / "two", "dense 2"))
    assert any("retrying" in line for line in logs)
    assert one.shape == two.shape == (18,)
    assert np.all(np.abs(two - one) <= 1e-9 * np.abs(one))
