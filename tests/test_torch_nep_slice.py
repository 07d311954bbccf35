"""The port's NEP MD slice vs the JAX package's list path, f64 on the CPU.

Both packages read the trained NEP4 Te/Pb model in
artifacts/trainer_parity_r5_nep.txt (the bench architecture at full
width).  The force pass is compared on 1,000 jittered PbTe atoms at the
tolerances of tests/test_nep_compact.py; a 20-step NVE trajectory of
DenseNEPMD is compared with JAX md_run from the same injected velocities.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.forcefield import ForceField
from gpumd_tpu.integrate.ensembles.nve import NVE as JNVE
from gpumd_tpu.integrate.run import md_run
from gpumd_tpu.integrate.thermo import compute_thermo as jthermo
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu.potentials.nep.params import load_nep_txt as jload
from gpumd_tpu.potentials.nep.params import random_params as jrandom_params
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.integrate.thermo import compute_thermo
from gpumd_tpu_torch.integrate.velocity import initialize_velocity
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import (
    NepParams,
    load_nep_txt,
    params_from_numpy,
    random_params,
)
from gpumd_tpu_torch.units import K_B, TIME_UNIT_CONVERSION

ROOT = Path(__file__).resolve().parent.parent
MODEL = str(ROOT / "artifacts" / "trainer_parity_r5_nep.txt")


def _pbte(nc, jitter, seed, a0=6.57):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + np.random.default_rng(seed).normal(0, jitter, pos.shape)
    types = np.tile([1, 1, 1, 1, 0, 0, 0, 0], len(cells))
    return pos, types, np.full(3, nc * a0)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def force_pass():
    pos, types, lengths = _pbte(5, 0.15, 0)
    n = len(pos)
    jbox = JBox.orthogonal(lengths)
    jnep = JNEP.from_file(MODEL, dtype=jnp.float64)
    ff = ForceField.create([jnep], jbox, n, mn=128)
    ref = ff.compute(jmake_state(pos, np.ones(n), types, jbox))

    box = Box.orthogonal(lengths)
    nep = NEP.from_file(MODEL, dtype=torch.float64)
    pos_w = box.wrap(torch.as_tensor(pos))
    plan = TC.plan_grid_compact(box, nep.rc, 1.0, n, position=_np(pos_w))
    cplan = TC.make_compact_plan(plan, position=_np(pos_w), box=box,
                                 rc_angular=nep.model.rc_angular_max)
    perm, smask, ov = TG.bin_dense(pos_w, box, torch.ones(n,
                                                          dtype=torch.float64),
                                   plan)
    assert not bool(ov)
    pos_s = TG.apply_perm(pos_w, perm, fill=1e5)
    typ_s = TG.apply_perm(torch.as_tensor(types, dtype=torch.int32), perm, 0)
    garr = TG.pack_ghost(pos_s, typ_s, smask, box, plan)
    idx, ok = TC.build_indices(
        TC.block_centers(garr, cplan),
        TG.pack_block_windows(garr, plan, cplan.bx, cplan.wl), cplan,
        nep.model.rc_angular_max)
    assert bool(ok)
    inv = np.full(n, -1)
    pa = _np(perm)
    inv[pa[pa < n]] = np.nonzero(pa < n)[0]
    outs = {pav: TC.compact_nep_compute(pos_s, typ_s, smask, box, cplan, idx,
                                        nep.model, nep.params,
                                        per_atom_virial=pav)
            for pav in (False, True)}
    return ref, outs, inv


def test_force_pass_matches_list_path(force_pass):
    ref, outs, inv = force_pass
    out = outs[True]
    np.testing.assert_allclose(_np(out.energy)[inv],
                               np.asarray(ref.potential_energy),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_np(out.force)[inv], np.asarray(ref.force),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(_np(out.virial_atom)[inv],
                               np.asarray(ref.virial), rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("pav", [False, True], ids=["total", "per_atom"])
def test_force_pass_total_virial(force_pass, pav):
    ref, outs, _ = force_pass
    np.testing.assert_allclose(_np(outs[pav].virial_total),
                               np.asarray(ref.virial).sum(axis=0),
                               rtol=1e-8, atol=1e-8)


def test_nve_trajectory_matches_md_run():
    """20 NVE steps at 1 fs from the same velocities; positions compared
    through orig_id (to_input_order).  f64 force differences of ~1e-14
    grow little over 20 fs: positions to 1e-8 A, velocities to 1e-9."""
    pos, types, lengths = _pbte(4, 0.1, 1)
    n = len(pos)
    mass = np.where(types == 1, 207.2, 127.6)
    rng = np.random.default_rng(5)
    vel = rng.normal(size=(n, 3)) * np.sqrt(K_B * 300.0 / mass)[:, None]
    vel -= (mass[:, None] * vel).sum(0) / mass.sum()
    dt, steps = 1.0 / TIME_UNIT_CONVERSION, 20

    jbox = JBox.orthogonal(lengths)
    jnep = JNEP.from_file(MODEL, dtype=jnp.float64)
    ff = ForceField.create([jnep], jbox, n, mn=128)
    jstate = ff.compute(jmake_state(pos, mass, types, jbox, velocity=vel))
    jfinal, _, _ = md_run(jstate, ff, JNVE(), dt, steps)

    box = Box.orthogonal(lengths)
    nep = NEP.from_file(MODEL, dtype=torch.float64)
    md = DenseNEPMD(nep, box, n, position=pos, skin=0.5)
    carry, _ = md.run(make_state(pos, mass, types, box, velocity=vel), NVE(),
                      dt, steps)
    assert not bool(carry.overflow)
    final = md.to_input_order(carry, n)
    dpos = box.minimum_image(final.position - torch.as_tensor(
        np.array(jfinal.position)))
    assert float(dpos.abs().max()) < 1e-8
    np.testing.assert_allclose(_np(final.velocity),
                               np.asarray(jfinal.velocity), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(_np(final.potential_energy),
                               np.asarray(jfinal.potential_energy),
                               rtol=1e-8, atol=1e-9)
    jt, tt = jthermo(jfinal), compute_thermo(final)
    for j, t in zip(jt, tt):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-7,
                                   atol=1e-9)


def test_initialize_velocity_injected():
    pos, types, lengths = _pbte(2, 0.0, 0)
    n = len(pos)
    mass = np.where(types == 1, 207.2, 127.6)
    state = make_state(pos, mass, types, Box.orthogonal(lengths))
    raw = np.random.default_rng(2).normal(size=(n, 3))
    v = _np(initialize_velocity(state, 450.0, velocity=raw).velocity)
    assert np.abs((mass[:, None] * v).sum(0)).max() < 1e-12
    temp = (mass[:, None] * v * v).sum() / (3 * n * K_B)
    assert temp == pytest.approx(450.0, rel=1e-12)
    w = raw - (mass[:, None] * raw).sum(0) / mass.sum()
    np.testing.assert_allclose(v, w * np.sqrt(450.0 / ((mass[:, None] * w
                                                        * w).sum()
                                                       / (3 * n * K_B))),
                               rtol=1e-12)


def test_v2_engine_not_ported():
    pos, types, lengths = _pbte(4, 0.0, 0)
    nep = NEP.from_file(MODEL, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DenseNEPMD(nep, Box.orthogonal(lengths), len(pos), position=pos,
                   skin=0.5, engine="v2")


def test_params_from_numpy_roundtrip():
    jmodel, _ = jload(MODEL)
    jparams = jrandom_params(jmodel, seed=4, dtype=jnp.float64)
    leaves = {k: None if v is None else np.asarray(v)
              for k, v in jparams._asdict().items()}
    tparams = params_from_numpy(leaves, dtype=torch.float64)
    assert isinstance(tparams, NepParams)
    for k in NepParams._fields:
        if leaves.get(k) is None:
            assert getattr(tparams, k) is None
        else:
            np.testing.assert_array_equal(_np(getattr(tparams, k)), leaves[k])
    # random_params draws the same numpy stream as the JAX package
    tmodel, _ = load_nep_txt(MODEL)
    mine = random_params(tmodel, seed=4, dtype=torch.float64)
    for k in NepParams._fields:
        if leaves.get(k) is not None:
            np.testing.assert_array_equal(_np(getattr(mine, k)), leaves[k])


def test_load_nep_txt_parity():
    jmodel, jparams = jload(MODEL, dtype=jnp.float64)
    tmodel, tparams = load_nep_txt(MODEL, dtype=torch.float64)
    assert dataclasses.asdict(tmodel) == dataclasses.asdict(jmodel)
    for k in NepParams._fields:
        j = getattr(jparams, k)
        if j is None:
            assert getattr(tparams, k) is None
        else:
            np.testing.assert_array_equal(_np(getattr(tparams, k)),
                                          np.asarray(j))


def test_port_imports_no_jax():
    """The port runs where JAX is absent: no file of gpumd_tpu_torch may
    import jax or the JAX package."""
    bad = re.compile(r"import jax|from jax|gpumd_tpu\.")
    files = [p for p in (ROOT / "gpumd_tpu_torch").rglob("*")
             if p.is_file() and p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 10
    hits = [f"{p}:{i + 1}" for p in files
            for i, line in enumerate(p.read_text().splitlines())
            if bad.search(line)]
    assert hits == []
