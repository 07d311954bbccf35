"""The port's z-slab sharded NEP engine (gpumd_tpu_torch/engine/sharded.py)
and the fold's z-halo mode, f64 on the CPU.

The system is JAX tests/test_sharded_dense.py::test_sharded_compact_smoke_
fast's: 11^3 = 1,331 atoms of a two-type solid (a0 3.3 A, jittered 0.2 A)
with its tiny model (rc 4/2.5, n_max 2/2, l_max 2, 4 neurons), skin 0.5,
a grid of 8 z layers.  No pair there lies within 2.5 A, so the angular
pair cotangents (the only ones the scatter and fold carry) vanish; the
same system with rc_angular 3.6 ("wide") has them across every slab seam,
and holds the ghost-row cotangents' return.  The slabs run on repeated
CPU entries of the `devices` list, as the JAX tests put 8 slabs on 8
virtual devices of one host.

(a) the exchanged ghost rows equal a single-domain pack_ghost's rows at
the slab boundaries (N 2, 4, 8; z periodic or open; a triclinic box);
(b) the halo mode's plain version equals JAX fold_block_windows and the
x/y fold with z kept; (c) one sharded pass at N = 8 equals JAX
ShardedDenseMD's compute_oneshot on the conftest 8-device mesh (one
module-scoped JAX compile, its kernels in interpret mode); (d) a 4-step
NVE block at N 2, 4, 8 equals the port's single-domain
DenseNEPMD(compact_lists=False), and `ok` turns False past skin/2; (e)
partition axis x equals the single-domain run; (f) the v2 branch equals
the port's single-domain v2.  Tolerances as in the JAX package's own
tests: energy rtol 1e-9 atol 1e-11, forces and virials rtol 1e-7 atol
1e-9, positions after 4 steps rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gpumd_tpu.engine import grid as JG
from gpumd_tpu.engine.sharded import ShardedDenseMD as JShardedDenseMD
from gpumd_tpu.integrate.ensembles.nve import NVE as JNVE
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu.potentials.nep.params import NepModel as JModel
from gpumd_tpu.potentials.nep.params import random_params as jrandom_params
from gpumd_tpu_torch.engine import sharded as TS
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.engine.fold_kernel import fold_windows_to_halo_rows
from gpumd_tpu_torch.engine.grid import DenseGridPlan, pack_ghost
from gpumd_tpu_torch.integrate.ensembles.nve import NVE
from gpumd_tpu_torch.integrate.velocity import initialize_velocity
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import NepModel, params_from_numpy
from gpumd_tpu_torch.units import TIME_UNIT_CONVERSION
from torch_first_trig import warm_torch_transcendentals  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

TINY = dict(
    version=4, model_type=0, num_types=2, symbols=("Te", "Pb"),
    atomic_numbers=(52, 82), rc_radial=(4.0, 4.0), rc_angular=(2.5, 2.5),
    mn_radial=48, mn_angular=16, n_max_radial=2, n_max_angular=2,
    basis_size_radial=2, basis_size_angular=2, l_max=2, has_q=(0,) * 6,
    neurons=4)
WIDE = dict(TINY, rc_angular=(3.6, 3.6))
SKIN, A0, NC = 0.5, 3.3, 11
DT = 1.0 / TIME_UNIT_CONVERSION
CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy()


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _lattice(cells=(NC, NC, NC), a0=A0):
    rng = np.random.default_rng(5)
    g = np.stack(np.meshgrid(*[np.arange(c) for c in cells], indexing="ij"),
                 -1).reshape(-1, 3)
    pos = (g + 0.5) * a0 + rng.uniform(-0.2, 0.2, g.shape)
    return pos, rng.integers(0, 2, len(pos)), list(np.asarray(cells) * a0)


def _models(kw):
    jm = JModel(**kw)
    jp = jrandom_params(jm, seed=7, dtype=jnp.float64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device=CPU)
    return JNEP(model=jm, params=jp), NEP(model=NepModel(**kw), params=tp)


class System:
    """The smoke test's system in the port (f64, CPU) with velocities."""

    def __init__(self, kw, **lattice):
        self.jnep, self.nep = _models(kw)
        self.pos, self.types, self.lengths = _lattice(**lattice)
        self.n = len(self.pos)
        self.box = Box.orthogonal(self.lengths, dtype=torch.float64,
                                  device=CPU)
        self.mass = np.where(self.types == 1, 207.2, 127.6)
        st = make_state(self.pos, self.mass, self.types, self.box)
        self.state = initialize_velocity(st, 300.0, seed=5)

    def sharded(self, nd, **kw):
        return TS.ShardedDenseMD(self.nep, self.box, self.n, [CPU] * nd,
                                 position=self.pos, skin=SKIN, **kw)

    def single(self, smd, **kw):
        """The single-domain full-window engine on the sharded plan's caps
        (the same grid, cap, mn_r and mn_a: the same slot layout)."""
        kw.setdefault("compact_lists", False)
        if smd.cplan_local is not None:
            kw.update(mn_r=smd.cplan_local.mn_r, mn_a=smd.cplan_local.mn_a)
        md = DenseNEPMD(self.nep, self.box, self.n, position=self.pos,
                        skin=SKIN, **kw)
        assert md.plan.grid == smd.plan.grid and md.plan.cap == smd.plan.cap
        return md


@pytest.fixture(scope="module")
def tiny():
    return System(TINY)


@pytest.fixture(scope="module")
def wide():
    return System(WIDE)


def _oneshot(smd, state):
    ss, oid, overflow = smd.bin_state(state, with_id=True)
    assert not bool(overflow)
    _, compute = smd.make_block(NVE(), DT, 1)
    return smd.gather_input_order(compute(ss), oid, state.position.shape[0])


def _single_pass(md, state):
    carry = md.init_carry(state)
    assert not bool(carry.overflow)
    out = md.compute(carry.state, carry.idx)
    return md.to_input_order(carry._replace(state=out),
                             state.position.shape[0])


# --------------------------------------------------------------------------
# (a) the exchanges
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pbc_z", [True, False])
@pytest.mark.parametrize("nd", [2, 4, 8])
def test_exchanged_ghost_rows_equal_single_domain(nd, pbc_z):
    """Each slab's ghost array after exchange_pos_rows equals rows
    j*nz_l .. j*nz_l + nz_l + 1 of the single-domain pack_ghost, on a
    triclinic box: the seam rows carry the third lattice vector (tilt
    included); an open z keeps FAR and type -1 there."""
    rng = np.random.default_rng(nd)
    lat = np.array([[14.0, 0, 0], [3.1, 15.0, 0], [1.7, 2.3, 40.0]])
    box = Box.from_lattice(lat, pbc=(True, True, pbc_z),
                           dtype=torch.float64, device=CPU)
    plan = DenseGridPlan(grid=(3, 3, 8), cap=4, rc=4.0, skin=0.5,
                         pbc=(True, True, pbc_z))
    ns = plan.n_slots
    pos = torch.as_tensor(rng.uniform(0, 1, (ns, 3)) @ lat)
    typ = torch.as_tensor(rng.integers(0, 2, ns), dtype=torch.int32)
    mask = torch.as_tensor((rng.uniform(size=ns) < 0.8).astype(float))
    ref = pack_ghost(pos, typ, mask, box, plan)
    nz_l = 8 // nd
    local = DenseGridPlan(grid=(3, 3, nz_l), cap=4, rc=4.0, skin=0.5,
                          pbc=(True, True, False))
    per = ns // nd
    garrs = [pack_ghost(pos[j * per:(j + 1) * per],
                        typ[j * per:(j + 1) * per],
                        mask[j * per:(j + 1) * per], box, local)
             for j in range(nd)]
    TS.exchange_pos_rows(garrs, box, pbc_z)
    for j, g in enumerate(garrs):
        want = ref[j * nz_l:j * nz_l + nz_l + 2]
        np.testing.assert_allclose(_np(g), _np(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("pbc", [(True, True, False), (False, True, False)])
def test_fold_halo_plain_equals_jax(pbc):
    """(b) The z-halo fold's plain version (the CPU path of
    fold_windows_to_halo_rows) equals JAX fold_block_windows followed by
    the x/y fold with the z rows kept (JAX fold_ghost_grad_c on the
    ghost grid padded by an empty z row a side, a plan of nz + 2 open
    rows)."""
    rng = np.random.default_rng(1)
    nx, ny, nz, cap, bx, c = 4, 3, 2, 8, 2, 5
    wl = -(-9 * (bx + 2) * cap // 128) * 128
    dw = rng.normal(size=(nz, ny, c, nx // bx, wl))
    tplan = DenseGridPlan(grid=(nx, ny, nz), cap=cap, rc=4.0, skin=0.5,
                          pbc=pbc)
    got = fold_windows_to_halo_rows(torch.as_tensor(dw), tplan, bx)
    jplan = JG.DenseGridPlan(grid=(nx, ny, nz), cap=cap, rc=4.0, skin=0.5,
                             pbc=pbc)
    dg = np.asarray(JG.fold_block_windows(jnp.asarray(dw), jplan, bx))
    dg = np.pad(dg, ((1, 1), (0, 0), (0, 0), (0, 0)))
    kept = JG.DenseGridPlan(grid=(nx, ny, nz + 2), cap=cap, rc=4.0,
                            skin=0.5, pbc=pbc)
    slots = np.asarray(JG.fold_ghost_grad_c(jnp.asarray(dg), kept))
    want = slots.T.reshape(c, nz + 2, ny, nx * cap).transpose(1, 2, 0, 3)
    assert got.shape == (nz + 2, ny, c, nx * cap)
    _close(got, want, 1e-12, 1e-12)
    assert float(got[0].abs().max()) > 0 and float(got[-1].abs().max()) > 0


# --------------------------------------------------------------------------
# (c) against the JAX package's sharded engine
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_oneshot(tiny):
    """JAX ShardedDenseMD.compute_oneshot on the conftest 8-device mesh
    (per-atom virials), in input order."""
    devs = jax.devices()[:8]
    if len(devs) < 8:
        pytest.skip("needs the conftest's 8 CPU devices")
    mesh = Mesh(np.array(devs), ("slab",))
    jbox = JBox.orthogonal(tiny.lengths)
    st = jmake_state(tiny.pos, tiny.mass, tiny.types, jbox,
                     dtype=jnp.float64)
    smd = JShardedDenseMD(tiny.jnep, jbox, tiny.n, mesh, position=tiny.pos,
                          skin=SKIN, interpret=True, per_atom_virial=True)
    ss, oid, overflow = smd.bin_state(st, with_id=True)
    assert not bool(overflow)
    _, compute = smd.make_block(JNVE(), DT, steps=1)
    snap = smd.gather_input_order(jax.jit(compute)(ss), oid, tiny.n)
    return smd, snap


def test_sharded_pass_matches_jax_sharded(tiny, jax_oneshot):
    jsmd, jsnap = jax_oneshot
    smd = tiny.sharded(8, per_atom_virial=True)
    assert smd.engine == "compact"
    assert smd.plan.grid == jsmd.plan.grid and smd.plan.cap == jsmd.plan.cap
    assert (smd.cplan_local.mn_r, smd.cplan_local.mn_a, smd.cplan_local.bx) \
        == (jsmd.cplan_local.mn_r, jsmd.cplan_local.mn_a,
            jsmd.cplan_local.bx)
    st = make_state(tiny.pos, tiny.mass, tiny.types, tiny.box)
    snap = _oneshot(smd, st)
    _close(snap.potential_energy, jsnap.potential_energy, 1e-9, 1e-11)
    # the port removes the net force, JAX's ShardedDenseMD keeps it
    jforce = np.asarray(jsnap.force)
    _close(snap.force, jforce - jforce.mean(0), 1e-7, 1e-9)
    _close(snap.virial, jsnap.virial, 1e-7, 1e-9)
    _close(snap.virial.sum(0), np.asarray(jsnap.virial).sum(0), 1e-7, 1e-9)
    # the pass's total is the slabs' totals summed
    ss, _ = smd.bin_state(st)
    out = smd.force_pass(ss, smd.build_idx(ss)[0])
    _close(out.virial_total, np.asarray(jsnap.virial).sum(0), 1e-7, 1e-9)


# --------------------------------------------------------------------------
# (d)-(f) against the port's single-domain engines
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_block(wide):
    """4 NVE steps of the single-domain full-window engine."""
    md = wide.single(wide.sharded(2))
    carry, _ = md.run(wide.state, NVE(), DT, 4)
    return md.to_input_order(carry, wide.n)


@pytest.mark.parametrize("nd", [2, 4, 8])
def test_sharded_nve_block_matches_single_domain(wide, single_block, nd):
    smd = wide.sharded(nd)
    ss, oid, overflow = smd.bin_state(wide.state, with_id=True)
    assert not bool(overflow)
    block, _ = smd.make_block(NVE(), DT, 4)
    out, _, ok, ys = block(ss)
    assert bool(ok) and ys is None
    snap = smd.gather_input_order(out, oid, wide.n)
    _close(snap.position, single_block.position, 1e-9, 1e-9)
    _close(snap.velocity, single_block.velocity, 1e-7, 1e-10)
    _close(snap.potential_energy, single_block.potential_energy, 1e-9,
           1e-11)
    _close(snap.force, single_block.force, 1e-7, 1e-9)


def test_ghost_cotangents_matter_and_ok_trips(wide):
    """Without the ghost-row cotangents' return the wide model's forces
    are wrong (the test above holds that path); an atom moved past
    skin/2 within a block turns `ok` False."""
    smd = wide.sharded(4, per_atom_virial=True)
    md = wide.single(smd, per_atom_virial=True)
    ref = _single_pass(md, wide.state)
    snap = _oneshot(smd, wide.state)
    _close(snap.force, ref.force, 1e-7, 1e-9)
    _close(snap.virial, ref.virial, 1e-7, 1e-9)
    keep = TS.return_ghost_cots
    try:
        TS.return_ghost_cots = lambda dgs, pbc_z: dgs
        bad = _oneshot(smd, wide.state)
    finally:
        TS.return_ghost_cots = keep
    assert float((bad.force - ref.force).abs().max()) > 1e-5
    v = wide.state.velocity.clone()
    v[17] = torch.tensor([0.3, 0.0, 0.0]) / DT  # 0.3 A in one step
    ss, _ = smd.bin_state(wide.state._replace(velocity=v))
    block, _ = smd.make_block(NVE(), DT, 1)
    assert not bool(block(ss)[2])


def test_partition_axis_x_matches_single_domain(tiny):
    smd = tiny.sharded(4, axis="x", per_atom_virial=True)
    assert smd.box.h[2, 2] == tiny.box.h[0, 0]
    ref = _single_pass(DenseNEPMD(tiny.nep, tiny.box, tiny.n,
                                  position=tiny.pos, skin=SKIN,
                                  per_atom_virial=True), tiny.state)
    snap = _oneshot(smd, tiny.state)
    _close(snap.potential_energy, ref.potential_energy, 1e-9, 1e-11)
    _close(snap.force, ref.force, 1e-7, 1e-9)
    _close(snap.virial, ref.virial, 1e-7, 1e-9)
    _close(snap.position, tiny.box.wrap(tiny.state.position), 1e-12, 1e-12)


def test_v2_branch_matches_single_domain_v2():
    """The wide model on 4 x 4 x 6 sites (a0 3.4 A, a 3 x 3 x 4 grid):
    the plain K1b/K2b cost grows with the cells' candidate lanes."""
    wide = System(WIDE, cells=(4, 4, 6), a0=3.4)
    smd = wide.sharded(2, engine="v2")
    assert smd.engine == "v2" and smd.cplan_local is None
    assert smd.plan.grid == (3, 3, 4)
    md = wide.single(smd, engine="v2")
    ref = _single_pass(md, wide.state)
    snap = _oneshot(smd, wide.state)
    _close(snap.potential_energy, ref.potential_energy, 1e-9, 1e-11)
    _close(snap.force, ref.force, 1e-7, 1e-9)
    _close(snap.virial.sum(0), ref.virial.sum(0), 1e-7, 1e-9)


def test_placement_is_logged_and_devices_round_robin():
    devs = TS.round_robin_devices(3, "cpu")
    assert devs == [CPU] * 3
    assert TS.placement(devs) == ("3 slabs on 1 device(s): 3 on cpu "
                                  "(slabs share a device)")
