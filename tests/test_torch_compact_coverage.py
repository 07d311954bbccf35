"""The compact force pass over the model and box variants, against JAX.

The plain compact pipeline (every kernel's plain version, f64 on the CPU)
is held against the JAX package's list path (ForceField) on the variants
the K1/K2 instances serve and the other port tests leave out: typewise and
flexible ZBL, l_max 3, the five-body q1111 invariant, NEP3, a temperature
model (model_type 3), three species and a triclinic box.  Each case is a
jittered rocksalt solid of 1,000 atoms (a0 4.3 A, 0.15 A, so that pairs
reach into the ZBL switch) with random parameters made from one seed and
handed to both packages.  Tolerances: per-atom energy 1e-10 eV, forces
1e-9 eV/A, per-atom virials 1e-8 eV (the f64 sums agree to ~1e-13).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.forcefield import ForceField
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu.potentials.nep.params import NepModel as JModel
from gpumd_tpu.potentials.nep.params import random_params as jrandom_params
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.potentials.nep.params import NepModel, params_from_numpy
from torch_first_trig import warm_torch_transcendentals  # noqa: F401


BASE = dict(
    version=4, model_type=0, num_types=2, symbols=("Te", "Pb"),
    atomic_numbers=(52, 82), rc_radial=(5.0, 5.0), rc_angular=(4.0, 4.0),
    mn_radial=96, mn_angular=48, n_max_radial=3, n_max_angular=3,
    basis_size_radial=4, basis_size_angular=4, l_max=4, neurons=12)
ZBL = dict(zbl=True, zbl_rc_inner=1.0, zbl_rc_outer=2.2)
# case: (model changes, triclinic, compact lists)
CASES = {
    "typewise-zbl": (dict(**ZBL, zbl_typewise_factor=0.6), False, True),
    "flexible-zbl": (dict(**ZBL, zbl_flexible=True), False, False),
    "l_max3": (dict(l_max=3), False, True),
    "q1111": (dict(has_q=(0, 1, 0, 0, 0, 0)), False, False),
    "nep3": (dict(version=3), False, True),
    "temperature": (dict(model_type=3), False, False),
    "three-species": (dict(num_types=3, symbols=("Te", "Pb", "Ge"),
                           atomic_numbers=(52, 82, 32),
                           rc_radial=(5.0, 4.8, 4.6),
                           rc_angular=(4.0, 3.8, 3.6)), False, True),
    "triclinic": (dict(), True, False),
}
TEMPERATURE = 300.0


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _system(num_types, triclinic, seed=2, nc=5, a0=4.3):
    """Jittered rocksalt, nc^3 cubic cells (8 atoms each), random types;
    the triclinic box shears the cell by 0.4 a0 along x and 0.2 along y."""
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    frac = ((cells[:, None, :] + base[None]).reshape(-1, 3)) / nc
    lat = np.eye(3) * nc * a0
    if triclinic:
        lat[2, 0], lat[2, 1] = 0.4 * a0 * nc, 0.2 * a0 * nc
    rng = np.random.default_rng(seed)
    pos = frac @ lat + rng.normal(0, 0.15, frac.shape)
    return pos, rng.integers(0, num_types, len(pos)), lat


@pytest.mark.parametrize("case", list(CASES))
def test_plain_compact_pass_matches_list_path(case):
    change, triclinic, lists = CASES[case]
    kw = {**BASE, **change}
    jmodel = JModel(**kw)
    jparams = jrandom_params(jmodel, seed=11, dtype=jnp.float64)
    leaves = {k: None if v is None else np.asarray(v)
              for k, v in jparams._asdict().items()}
    model = NepModel(**kw)
    params = params_from_numpy(leaves, dtype=torch.float64, device="cpu")
    temp = TEMPERATURE if model.model_type == 3 else None

    pos, types, lat = _system(model.num_types, triclinic)
    n = len(pos)
    jbox = JBox.from_lattice(lat)
    jnep = JNEP(model=jmodel, params=jparams,
                temperature=None if temp is None else jnp.float64(temp))
    ff = ForceField.create([jnep], jbox, n, mn=160)
    ref = ff.compute(jmake_state(pos, np.ones(n), types, jbox))

    box = Box.from_lattice(lat, device="cpu")
    p = box.wrap(torch.as_tensor(pos))
    plan = TC.plan_grid_compact(box, model.rc_radial_max, 1.0, n,
                                position=_np(p))
    cplan = TC.make_compact_plan(plan, position=_np(p), box=box,
                                 rc_angular=model.rc_angular_max,
                                 compact_lists=lists)
    assert bool(cplan.cl) == lists
    perm, smask, ov = TG.bin_dense(p, box, torch.ones(n, dtype=p.dtype),
                                   plan)
    assert not bool(ov)
    pos_s = TG.apply_perm(p, perm, fill=1e5)
    typ_s = TG.apply_perm(torch.as_tensor(types, dtype=torch.int32), perm, 0)
    garr = TG.pack_ghost(pos_s, typ_s, smask, box, plan)
    if lists:
        idx, ok = TC.build_compact_neighbors(garr, box, cplan,
                                             model.rc_angular_max, plain=True)
    else:
        idx, ok = TC.build_indices(
            TC.block_centers(garr, cplan),
            TG.pack_block_windows(garr, plan, cplan.bx, cplan.wl), cplan,
            model.rc_angular_max)
    assert bool(ok)
    out = TC.compact_nep_compute(pos_s, typ_s, smask, box, cplan, idx, model,
                                 params, per_atom_virial=True,
                                 temperature=temp, plain=True)
    inv = np.full(n, -1)
    pa = _np(perm)
    inv[pa[pa < n]] = np.nonzero(pa < n)[0]
    if model.zbl:  # the case reaches into the ZBL switch
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        assert (d[np.triu_indices(n, 1)] < kw["zbl_rc_outer"]).any()

    def worst(got, want):
        return float(np.max(np.abs(_np(got)[inv] - np.asarray(want))))

    assert worst(out.energy, ref.potential_energy) <= 1e-10
    assert worst(out.force, ref.force) <= 1e-9
    assert worst(out.virial_atom, ref.virial) <= 1e-8

