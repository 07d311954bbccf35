"""The port's CUDA kernels vs their plain torch versions, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip.  They do
not import JAX (the GPU machine has none), so run them there with:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

They cover what chip_smoke.py does not: every ZBL variant, K1 and K2 on
every class of their template instances (l_max 1 to 8, kr1/ka1/na1 up to
20, 2, 3 and 8 types, both rungs, blocks without a live centre, centres
that fill mn_a, equal bits from two calls), fold plans with bx = 1, odd
caps, free axes, an unaligned base and the PbTe 262k and Si 1M plans,
the compact-list rung on both compactions at CPU-test sizes, the
scatter's cut of the channels over CTAs (pch 4 and 12, with and without
cidx, the widest window the wrapper admits, 4-byte units, a window past
shared memory refused), both modes
of the Tersoff kernel (contract, and fused with the scatter) on the
512-atom CPU-test plan, with two types (SiC), at 32k atoms and
compressed so that every centre takes the general path past the live
cap, Newton's third law of the fused pass, the shapes, unaligned bases
and windows the Tersoff wrappers refuse, and the four dense-window
kernels (K1b, K2b, round-1 K1 and K2) on random solids with close pairs
inside the ZBL switch, empty slots and an open axis, a denser one whose
live-pair queues take several pieces, a model at the edge of the shared
memory of the kernels without queues (l_max 6, 20 angular basis
functions, cap 24), a cap (300) whose cut of a cell takes several groups
of centres and, backward, several windows of candidates, small cuts
forced in both directions,
equal bits from two calls, a pass's net gradient zero to rounding and the
inputs the wrappers refuse; and the six probe
kernels of csrc/probes.cu (the one-hot dot in TF32 and f32 on tiles
across b boundaries, part-full tiles, n 16 to 128, k 100 and ksplit 4,
the f32 path's error against f64 within twice f32 torch.matmul's and its
exact row sums bit for bit, the feature matmul at ch 24, 168 and 200, nb
1 to 300, equal bits from two calls, the shapes the TF32 kernels refuse;
both pair-reduce orders at chunks 1 to 13, part-full lane tiles, nb 1
and 9 and up to 1024 lanes, the tiled order equal to the spill order bit
for bit, the shapes it refuses; the blocked gather at nblk 11 and 18
with indices out of range, the gather bit for bit, the transcendental
gate).
Tolerances are relative to max|plain| in f32: 1e-5 for the
K1s and the fold (summation order), 1e-4 for the K2s, the scatter and the
Tersoff kernel (op order, hand-derived vs autograd gradients, shared-memory
atomics, CUDA's own transcendentals); the two compactions copy, so they
must match bit for bit.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine import fold_kernel as TF
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.engine import nep_dense as TD
from gpumd_tpu_torch.engine import tersoff_compact as TT
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.model.state import make_state
from gpumd_tpu_torch.potentials.nep.model import NEP
from gpumd_tpu_torch.potentials.nep.params import NepModel, random_params
from gpumd_tpu_torch.potentials.tersoff import Tersoff1989
from gpumd_tpu_torch.probes import bench_gather as PG
from gpumd_tpu_torch.probes import bench_mxu_probes as PM
from gpumd_tpu_torch.probes import probe_transcendentals as PT

pytestmark = pytest.mark.cuda

MODEL = str(Path(__file__).resolve().parent.parent / "artifacts"
            / "trainer_parity_r5_nep.txt")

TOL = {"k1": 1e-5, "fold": 1e-5, "k2": 1e-4, "scatter": 1e-4,
       "tersoff": 1e-4, "tersoff_scatter": 1e-4, "k1b": 1e-5, "k2b": 1e-4,
       "dense_k1": 1e-5, "dense_k2": 1e-4}
# Tersoff-1989 Si and SiC (Phys. Rev. B 39, 5566 (1989), Table I)
SIC = """tersoff_1989 2 Si C
1830.8 471.18 2.4799 1.7322 1.1e-6 0.78734 1.0039e5 16.217 -0.59825 2.7 3.0
1393.6 346.74 3.4879 2.2119 1.5724e-7 0.72751 38049 4.3484 -0.57058 1.8 2.1
0.9776
"""


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_build.library()
    return torch.device("cuda")


def _rel(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def _model(zbl, l_max):
    return NepModel(
        version=4, model_type=0, num_types=2, symbols=("Te", "Pb"),
        atomic_numbers=(52, 82), rc_radial=(6.0, 6.5), rc_angular=(4.0, 3.5),
        mn_radial=96, mn_angular=24, n_max_radial=4, n_max_angular=3,
        basis_size_radial=5, basis_size_angular=4, l_max=l_max,
        has_q=(1, 0, 0, 0, 0, 0), neurons=16, zbl=zbl != "none",
        zbl_rc_inner=1.0 if zbl == "universal" else 0.0,
        zbl_rc_outer=2.0 if zbl != "none" else 0.0,
        zbl_flexible=zbl == "flexible",
        zbl_typewise_factor=0.65 if zbl == "typewise" else 0.0)


@pytest.mark.parametrize("zbl,l_max", [("none", 4), ("universal", 2),
                                       ("typewise", 4), ("flexible", 3)])
def test_kernels_match_plain(dev, zbl, l_max):
    rng = np.random.default_rng(3)
    n, lengths = 600, np.array([24.0, 25.0, 26.0])
    pos = rng.uniform(0, 1, (n, 3)) * lengths
    types = rng.integers(0, 2, n)
    model = _model(zbl, l_max)
    params = random_params(model, seed=5, dtype=torch.float32, device=dev)
    box = Box.orthogonal(lengths, dtype=torch.float32, device=dev)
    plan = TC.plan_grid_compact(box, 6.5, 1.0, n, position=pos)
    cplan = TC.make_compact_plan(plan, position=pos, box=box,
                                 rc_angular=4.0, compact_lists=False)
    p = box.wrap(torch.as_tensor(pos, dtype=torch.float32, device=dev))
    perm, smask, _ = TG.bin_dense(p, box, torch.ones(n, device=dev), plan)
    ps = TG.apply_perm(p, perm, 1e5)
    ts = TG.apply_perm(torch.as_tensor(types, dtype=torch.int32,
                                       device=dev), perm, 0)
    garr = TG.pack_ghost(ps, ts, smask, box, plan)
    idx, ok = TC.build_indices(
        TC.block_centers(garr, cplan),
        TG.pack_block_windows(garr, plan, cplan.bx, cplan.wl), cplan, 4.0)
    assert bool(ok)
    spec = TC.CompactSpec.from_model(model, params)
    for pav in (False, True):
        keep = {}
        TC.compact_pipeline(garr, ts, smask, cplan, idx, model, params, pav,
                            spec=spec, keep=keep)
        k = keep
        pairs = {
            "k1": (TC.k1_call(k["centers"], k["cand"], k["idx"], cplan,
                              spec),
                   TC.k1_plain(k["centers"], k["cand"], k["idx"], cplan,
                               spec)),
            "k2": (TC.k2_call(k["centers"], k["tiles"], k["idx"], k["cotc"],
                              k["cotw"], cplan, spec, pav),
                   TC.k2_plain(k["centers"], k["tiles"], k["idx"], k["cotc"],
                               k["cotw"], cplan, spec, pav)),
            "scatter": ((TC.scatter_call(k["pvals"], k["idx_a"], cplan),),
                        (TC.scatter_plain(k["pvals"], k["idx_a"], cplan),)),
            "fold": ((TF.fold_windows_to_rows(k["dcand"], plan, cplan.bx),),
                     (TF.fold_windows_to_rows_plain(k["dcand"], plan,
                                                    cplan.bx),)),
        }
        for name, (got, ref) in pairs.items():
            for g, r in zip(got, ref):
                assert torch.isfinite(g).all()
                assert _rel(g, r) <= TOL[name], (name, pav, _rel(g, r))


ELEMENTS = (("Te", 52), ("Pb", 82), ("Ge", 32), ("Si", 14), ("C", 6),
            ("O", 8), ("N", 7), ("Sn", 50))
# case: (types, l_max, ZBL, n_max = basis, compact lists, special)
INSTANCES = {
    "trained-lists": (None, None, None, None, True, None),
    "trained-windows": (None, None, None, None, False, None),
    "l1-universal": (2, 1, "universal", 3, False, None),
    "l6-typewise": (2, 6, "typewise", 3, True, None),
    "l8-flexible": (2, 8, "flexible", 4, False, None),
    "t3": (3, 4, "none", 4, True, None),
    "t8": (8, 2, "universal", 3, False, None),
    "n20": (2, 4, "none", 19, True, None),
    "empty-blocks": (2, 3, "none", 3, True, "slab"),
    "mn_a-full": (2, 4, "typewise", 3, False, "mn_a"),
}


def _instance(dev, case):
    """One K1/K2 input set: the trained model on jittered PbTe, or a
    random NEP4 model (n_max = basis = `nb`) on jittered rocksalt (a0 5.2
    A, random types, 0.25 A: pairs reach into the ZBL switch), planned on
    either
    rung.  "slab" keeps the atoms below z = 0.45 L, so whole blocks hold
    no live centre; "mn_a" caps mn_a at 8 on the distance-sorted
    full-window rung, so centres fill every angular slot."""
    t, l_max, zbl, nb, lists, special = INSTANCES[case]
    a0, jitter = 5.2, 0.25
    if t is None:  # the PbTe lattice of tests/test_torch_compact_lists.py
        nep = NEP.from_file(MODEL, device=dev)
        model, params = nep.model, nep.params
        t, a0, jitter = model.num_types, 6.57, 0.1
    else:
        model = NepModel(
            version=4, model_type=0, num_types=t,
            symbols=tuple(e for e, _ in ELEMENTS[:t]),
            atomic_numbers=tuple(z for _, z in ELEMENTS[:t]),
            rc_radial=tuple(6.0 + 0.1 * i for i in range(t)),
            rc_angular=tuple(4.0 - 0.1 * i for i in range(t)),
            mn_radial=96, mn_angular=24, n_max_radial=nb, n_max_angular=nb,
            basis_size_radial=nb, basis_size_angular=nb, l_max=l_max,
            neurons=8, zbl=zbl != "none",
            zbl_rc_inner=1.0 if zbl == "universal" else 0.0,
            zbl_rc_outer=2.5 if zbl != "none" else 0.0,
            zbl_flexible=zbl == "flexible",
            zbl_typewise_factor=0.8 if zbl == "typewise" else 0.0)
        params = random_params(model, seed=5, dtype=torch.float32,
                               device=dev)
    pos, _, lengths = _pbte(6, jitter, seed=1, a0=a0)
    types = np.random.default_rng(2).integers(0, t, len(pos))
    if special == "slab":
        keep = pos[:, 2] % lengths[2] < 0.45 * lengths[2]
        pos, types = pos[keep], types[keep]
    box = Box.orthogonal(lengths, dtype=torch.float32, device=dev)
    p = box.wrap(torch.as_tensor(pos, dtype=torch.float32, device=dev))
    pw = p.cpu().numpy()
    n = len(pos)
    plan = TC.plan_grid_compact(box, model.rc_radial_max, 1.0, n,
                                position=pw)
    cplan = TC.make_compact_plan(plan, position=pw, box=box,
                                 rc_angular=model.rc_angular_max,
                                 mn_a=8 if special == "mn_a" else None,
                                 compact_lists=lists)
    assert bool(cplan.cl) == lists
    perm, smask, _ = TG.bin_dense(p, box, torch.ones(n, device=dev), plan)
    ps = TG.apply_perm(p, perm, 1e5)
    ts = TG.apply_perm(torch.as_tensor(types, dtype=torch.int32,
                                       device=dev), perm, 0)
    garr = TG.pack_ghost(ps, ts, smask, box, plan)
    if lists:
        idx, _ = TC.build_compact_neighbors(garr, box, cplan,
                                            model.rc_angular_max)
    else:
        idx, _ = TC.build_indices(
            TC.block_centers(garr, cplan),
            TG.pack_block_windows(garr, plan, cplan.bx, cplan.wl), cplan,
            model.rc_angular_max)
    return garr, ts, smask, cplan, idx, model, params


@pytest.mark.parametrize("case", list(INSTANCES))
def test_k1_k2_instances_match_plain(dev, case):
    """K1 and K2 against their plain versions on every template instance
    class (l_max 1-8, the size bound 8 and 20, 2/3/8 types, every ZBL
    mode), both rungs, both per-atom virial settings, blocks without a
    live centre and centres that fill mn_a; two calls give equal bits."""
    garr, ts, smask, cp, idx, model, params = _instance(dev, case)
    spec = TC.CompactSpec.from_model(model, params)
    for pav in (False, True):
        k = {}
        TC.compact_pipeline(garr, ts, smask, cp, idx, model, params, pav,
                            spec=spec, keep=k)
        before = dict(cuda_build.launches)
        got = {"k1": (TC.k1_call(k["centers"], k["cand"], k["idx"], cp,
                                 spec),
                      TC.k1_call(k["centers"], k["cand"], k["idx"], cp,
                                 spec)),
               "k2": tuple(TC.k2_call(k["centers"], k["tiles"], k["idx"],
                                      k["cotc"], k["cotw"], cp, spec, pav)
                           for _ in range(2))}
        assert cuda_build.launches["k1"] == before["k1"] + 2
        assert cuda_build.launches["k2"] == before["k2"] + 2
        ref = {"k1": TC.k1_plain(k["centers"], k["cand"], k["idx"], cp,
                                 spec),
               "k2": TC.k2_plain(k["centers"], k["tiles"], k["idx"],
                                 k["cotc"], k["cotw"], cp, spec, pav)}
        for name in ("k1", "k2"):
            first, second = got[name]
            for g, g2, r in zip(first, second, ref[name]):
                assert g.shape == r.shape
                assert torch.isfinite(g).all()
                assert torch.equal(g, g2), (name, "two calls differ")
                assert _rel(g, r) <= TOL[name], (case, name, pav,
                                                 _rel(g, r))
    if INSTANCES[case][5] == "slab":
        live = (k["centers"][..., 3, :] > -0.5).reshape(cp.nb, -1).any(1)
        assert not bool(live.all())
    if INSTANCES[case][5] == "mn_a":
        # some centre has a non-zero pair cotangent in every angular slot
        p = ref["k2"][1].reshape(cp.nb, -1, cp.mn_a, cp.a_pad)[:, :3]
        full = (p.abs().sum(1) > 0).sum(1) == cp.mn_a
        assert bool(full.any())


# The fold on every kind of plan: bx 1 and 3, free y or z, the PbTe 262k
# default rung's plan (bx 2, cap 64, C 4, wl 2304) and the Si 1M plan (bx
# 14, cap 8, C 4, wl 1152), both with 16-byte units; caps 6 and 10 (not a
# multiple of 4) and an unaligned base take 4-byte units.  Each call
# moves the counter by one; two calls give equal bits; the plan's kernel
# instance has a resident block an SM.
@pytest.mark.parametrize("bx,cap,grid,pbc,c,wl,offset", [
    (1, 40, (3, 4, 3), (True, True, True), 5, None, 0),
    (3, 24, (3, 3, 4), (True, False, True), 5, None, 0),
    (2, 48, (4, 3, 1), (True, True, False), 5, None, 0),
    (2, 64, (6, 5, 4), (True, True, True), 5, None, 0),
    (2, 64, (16, 22, 22), (True, True, True), 4, 2304, 0),
    (14, 8, (56, 67, 67), (True, True, True), 4, 1152, 0),
    (2, 6, (4, 3, 3), (True, False, True), 3, None, 0),
    (1, 10, (2, 3, 2), (True, True, True), 2, 9 * 3 * 10, 0),
    (2, 64, (6, 5, 4), (False, True, True), 5, None, 1),
])
def test_fold_matches_plain_every_plan(dev, bx, cap, grid, pbc, c, wl,
                                       offset):
    plan = TG.DenseGridPlan(grid=grid, cap=cap, rc=4.0, skin=1.0, pbc=pbc)
    nx, ny, nz = grid
    wl = wl or TG.round_up(9 * (bx + 2) * cap, 128)
    shape = (nz, ny, c, nx // bx, wl)
    flat = torch.randn(offset + int(np.prod(shape)), device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    dw = flat[offset:].view(shape)
    fp = TF.fold_plan(plan, bx, c, wl, aligned=dw.data_ptr() % 16 == 0)
    assert fp.vec == (4 if cap % 4 == 0 and offset == 0 else 1)
    assert TF.fold_occupancy(fp) >= 1
    before = cuda_build.launches["fold"]
    got = TF.fold_windows_to_rows(dw, plan, bx)
    assert cuda_build.launches["fold"] == before + 1
    assert _rel(got, TF.fold_windows_to_rows_plain(dw, plan, bx)) <= 1e-5
    assert torch.equal(TF.fold_windows_to_rows(dw, plan, bx), got)


# The fold's z-halo mode (a slab of the sharded engine): x and y folded as
# above, z never wrapped, nz + 2 rows; 4- and 12-channel PbTe slab plans
# and odd caps.
@pytest.mark.parametrize("bx,cap,grid,pbc,c,offset", [
    (2, 64, (16, 22, 6), (True, True, False), 4, 0),
    (2, 64, (16, 22, 6), (True, True, False), 12, 0),
    (1, 40, (3, 4, 1), (True, False, False), 5, 0),
    (2, 6, (4, 3, 2), (False, True, False), 3, 1),
])
def test_fold_halo_matches_plain(dev, bx, cap, grid, pbc, c, offset):
    plan = TG.DenseGridPlan(grid=grid, cap=cap, rc=4.0, skin=1.0, pbc=pbc)
    nx, ny, nz = grid
    wl = TG.round_up(9 * (bx + 2) * cap, 128)
    shape = (nz, ny, c, nx // bx, wl)
    flat = torch.randn(offset + int(np.prod(shape)), device=dev,
                       generator=torch.Generator(dev).manual_seed(1))
    dw = flat[offset:].view(shape)
    fp = TF.fold_plan(plan, bx, c, wl, aligned=dw.data_ptr() % 16 == 0,
                      halo=True)
    assert fp.blocks == (nz + 2) * ny * c
    before = cuda_build.launches["fold_halo"]
    got = TF.fold_windows_to_halo_rows(dw, plan, bx)
    assert cuda_build.launches["fold_halo"] == before + 1
    assert got.shape == (nz + 2, ny, c, nx * cap)
    assert _rel(got, TF.fold_windows_to_halo_rows_plain(dw, plan, bx)) \
        <= 1e-5
    assert torch.equal(TF.fold_windows_to_halo_rows(dw, plan, bx), got)


def test_wrappers_reject_wrong_dtype(dev):
    plan = TG.DenseGridPlan(grid=(3, 3, 3), cap=16, rc=4.0, skin=1.0,
                            pbc=(True, True, True))
    dw = torch.zeros((3, 3, 4, 1, 768), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        TF.fold_windows_to_rows(dw, plan, 3)


def _pbte(nc, jitter, seed=0, a0=6.57):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + np.random.default_rng(seed).normal(0, jitter, pos.shape)
    return pos, np.tile([1, 1, 1, 1, 0, 0, 0, 0], len(cells)), \
        np.full(3, nc * a0)


@pytest.mark.parametrize("nc,jitter,cap", [(5, 0.15, None), (6, 0.1, 64)],
                         ids=["windows", "rows"])
def test_compact_lists_match_plain(dev, nc, jitter, cap):
    """The compact-list rung on the systems of test_torch_compact_lists.py:
    both compactions (bit for bit), the scatter through cidx, and K1/K2 at
    source width cl, each against its plain version."""
    pos, types, lengths = _pbte(nc, jitter)
    nep = NEP.from_file(MODEL, device=dev)
    box = Box.orthogonal(lengths, dtype=torch.float32, device=dev)
    md = DenseNEPMD(nep, box, len(pos), position=pos, skin=1.0, cap=cap)
    cp = md.cplan
    rows = TC.rows_compact_eligible(cp)
    assert cp.cl > 0 and rows == (cap is not None)
    carry = md.init_carry(make_state(pos, np.where(types == 1, 207.2, 127.6),
                                     types, box))
    assert not bool(carry.overflow)
    s = carry.state
    garr = TG.pack_ghost(s.position, s.type, s.mask, s.box, md.plan)
    cidx = carry.idx.cidx
    for pav in (False, True):
        k = {}
        before = dict(cuda_build.launches)
        TC.compact_pipeline(garr, s.type, s.mask, cp, carry.idx, nep.model,
                            nep.params, pav, spec=md.spec, keep=k)
        name = "compact_rows" if rows else "compact_windows"
        assert cuda_build.launches[name] == before[name] + 2
        if rows:
            for src in (k["garr"], k["rows_p"]):
                got = TC.compact_rows_call(src, cidx, cp)
                assert torch.equal(got, TC.compact_rows_plain(src, cidx, cp))
                win = TG.pack_block_windows(src, md.plan, cp.bx, cp.wl,
                                            far_channels=0)
                assert torch.equal(got, TC.compact_windows_call(win, cidx,
                                                                cp))
        for src in ([k["cand_win"], k["cotw_win"]] if not rows else []):
            assert torch.equal(TC.compact_windows_call(src, cidx, cp),
                               TC.compact_windows_plain(src, cidx, cp))
        pairs = {
            "k1": (TC.k1_call(k["centers"], k["cand"], k["idx"], cp,
                              md.spec),
                   TC.k1_plain(k["centers"], k["cand"], k["idx"], cp,
                               md.spec)),
            "k2": (TC.k2_call(k["centers"], k["tiles"], k["idx"], k["cotc"],
                              k["cotw"], cp, md.spec, pav),
                   TC.k2_plain(k["centers"], k["tiles"], k["idx"], k["cotc"],
                               k["cotw"], cp, md.spec, pav)),
            "scatter": ((TC.scatter_call(k["pvals"], k["idx_a"], cp,
                                         cidx),),
                        (TC.scatter_plain(k["pvals"], k["idx_a"], cp,
                                          cidx),)),
        }
        for name, (got, ref) in pairs.items():
            for g, r in zip(got, ref):
                assert torch.isfinite(g).all()
                assert _rel(g, r) <= TOL[name], (name, pav, _rel(g, r))


def _scatter_inputs(dev, cap, bx, pch, cl, a_extra=0, offset=0, mnp=8,
                    seed=0):
    """Scatter inputs on a plan of `cap` slots a cell and `bx` cells a
    block: pvals nine tenths exact zeros (K2's dead slots), lanes drawn
    over the window, or over a compact list of cl lanes with cidx drawn
    over the window; idx_pairs the mnp prefix view of a wider idx, as the
    pipeline passes it.  a_extra widens the lane axis past a_pad, offset
    moves pvals' base off a 16-byte boundary (both: 4-byte units).  Two
    x-blocks, two z rows: four blocks."""
    grid = (2 * bx, 1, 2)
    plan = TG.DenseGridPlan(grid=grid, cap=cap, rc=4.0, skin=1.0,
                            pbc=(True, True, True))
    cp = TC.CompactPlan(base=plan, bx=bx, mn_r=mnp + 8, mn_a=mnp, cl=cl)
    nx, ny, nz = grid
    nxb, a = nx // bx, cp.a_pad + a_extra
    g = torch.Generator(dev).manual_seed(seed)
    shape = (nz, ny, nxb, pch, mnp, a)
    flat = torch.randn(offset + int(np.prod(shape)), device=dev, generator=g)
    dead = torch.rand(flat.shape, device=dev, generator=g) < 0.9
    pvals = torch.where(dead, torch.zeros_like(flat), flat)[offset:].view(
        shape)
    idx = torch.randint(0, cl or cp.wl, (nz, ny, nxb, mnp + 8, a),
                        dtype=torch.int32, device=dev, generator=g)
    cidx = (torch.randint(0, cp.wl, (nz, ny, nxb, cl), dtype=torch.int32,
                          device=dev, generator=g) if cl else None)
    return pvals, idx[:, :, :, :mnp], cidx, cp


# (cap, bx, a_extra, offset, channels a CTA): PbTe's default plan (wl
# 2304: 2 channels a CTA), the widest window the wrapper admits (cap 2152
# at bx 1: wl 58,112, 1 channel a CTA in 232,448 B); each also at 4-byte
# units (a lane axis of a_pad + 2, pvals' base 4 bytes off a 16-byte
# boundary): every instance of the kernel
_SCATTER_SHAPES = {"pbte": (64, 2, 0, 0, 2), "widest": (2152, 1, 0, 0, 1),
                   "pbte_vec1": (64, 2, 2, 1, 2),
                   "widest_vec1": (2152, 1, 2, 1, 1)}


@pytest.mark.parametrize("shape", list(_SCATTER_SHAPES))
@pytest.mark.parametrize("cl", [0, 1024], ids=["windows", "cidx"])
@pytest.mark.parametrize("pch", [4, 12])
def test_scatter_cut_matches_plain(dev, pch, cl, shape):
    """The scatter with its channels cut over CTAs, against its plain
    version: pch 4 and 12, with and without cidx, on PbTe's plan and the
    widest window, at 16- and 4-byte units; one launch counted a call."""
    cap, bx, a_extra, offset, group = _SCATTER_SHAPES[shape]
    pvals, idx, cidx, cp = _scatter_inputs(dev, cap, bx, pch, cl, a_extra,
                                           offset)
    sp = TC.scatter_plan(cp.nb, pch, cp.wl, pvals.shape[5],
                         aligned=offset == 0)
    assert (sp.vec, sp.group) == (1 if offset else 4, group)
    assert sp.groups * sp.group == pch and sp.smem <= TC._SMEM_LIMIT
    # 8 CTAs an SM (32 registers) where the accumulator leaves room
    assert TC.scatter_occupancy(sp) == (1 if cap == 2152 else 8)
    before = dict(cuda_build.launches)
    got = TC.scatter_call(pvals, idx, cp, cidx)
    after = dict(cuda_build.launches)
    assert after["scatter"] == before["scatter"] + 1
    assert {k: v for k, v in after.items() if k != "scatter"} == \
        {k: v for k, v in before.items() if k != "scatter"}
    ref = TC.scatter_plain(pvals, idx, cp, cidx)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel(got, ref) <= TOL["scatter"], _rel(got, ref)


def test_scatter_refuses_a_window_past_shared_memory(dev):
    """One 128-lane group past the widest window (cap 2153 at bx 1: wl
    58,240): the wrapper raises and launches nothing."""
    pvals, idx, _, cp = _scatter_inputs(dev, 2153, 1, 4, 0)
    assert cp.wl == 58240
    before = cuda_build.launches["scatter"]
    with pytest.raises(ValueError, match="exceeds shared memory"):
        TC.scatter_call(pvals, idx, cp)
    assert cuda_build.launches["scatter"] == before


def _tersoff_inputs(dev, tmp_path, nc, c_frac, skin, a0=5.431,
                    with_md=False):
    """Diamond lattice of nc^3 cells (lattice constant a0) jittered by 0.1
    A, c_frac of its sites C (two types) or Si alone (the first line of
    SIC): the tersoff kernel's inputs from CompactTersoffMD's own plan
    (and, with_md, the engine and its carry)."""
    text = SIC if c_frac else "\n".join(SIC.splitlines()[:2]).replace(
        "2 Si C", "1 Si") + "\n"
    path = tmp_path / "tersoff.txt"
    path.write_text(text)
    pot = Tersoff1989.from_file(str(path), device=dev)
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.25, .25, .25], [.75, .75, .25], [.75, .25, .75],
                     [.25, .75, .75]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    rng = np.random.default_rng(1)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + rng.uniform(-0.1, 0.1, pos.shape)
    types = (rng.uniform(size=len(pos)) < c_frac).astype(int)
    box = Box.orthogonal([nc * a0] * 3, dtype=torch.float32, device=dev)
    md = TT.CompactTersoffMD(pot, box, len(pos), position=pos, skin=skin)
    carry = md.init_carry(make_state(pos, np.where(types, 12.011, 28.085),
                                     types, box))
    assert not bool(carry.overflow)
    s = carry.state
    garr = TG.pack_ghost(s.position, s.type, s.mask, s.box, md.plan)
    cp = md.cplan
    out = (TC.block_centers(garr, cp),
           TG.pack_block_windows(garr, cp.base, cp.bx, cp.wl), carry.idx,
           cp, md.spec)
    return out + (md, carry) if with_md else out


@pytest.mark.parametrize("nc,c_frac,skin", [(4, 0.0, 0.5), (4, 0.3, 0.5),
                                            (16, 0.0, 1.0)],
                         ids=["si512", "sic512", "si32k"])
def test_tersoff_matches_plain(dev, tmp_path, nc, c_frac, skin):
    centers, cand, idx, cp, spec = _tersoff_inputs(dev, tmp_path, nc, c_frac,
                                                   skin)
    for pav in (False, True):
        before = cuda_build.launches["tersoff"]
        got = TT.tersoff_kernel_call(centers, cand, idx, cp, spec, pav)
        assert cuda_build.launches["tersoff"] == before + 1
        ref = TT.tersoff_kernel_plain(centers, cand, idx, cp, spec, pav)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert torch.isfinite(g).all()
            assert _rel(g, r) <= TOL["tersoff"], (pav, _rel(g, r))


@pytest.mark.parametrize("nc,c_frac,skin", [(4, 0.0, 0.5), (4, 0.3, 0.5),
                                            (16, 0.0, 1.0)],
                         ids=["si512", "sic512", "si32k"])
def test_tersoff_scatter_matches_plain(dev, tmp_path, nc, c_frac, skin):
    """The fused mode against the composition of the tersoff kernel's and
    the scatter's plain versions, pch 4 and 12; one launch of its own
    counter, none of the two kernels it replaces."""
    centers, cand, idx, cp, spec = _tersoff_inputs(dev, tmp_path, nc, c_frac,
                                                   skin)
    for pav in (False, True):
        before = dict(cuda_build.launches)
        got = TT.tersoff_scatter_call(centers, cand, idx, cp, spec, pav)
        after = dict(cuda_build.launches)
        assert after["tersoff_scatter"] == before["tersoff_scatter"] + 1
        assert {k: v for k, v in after.items() if k != "tersoff_scatter"} \
            == {k: v for k, v in before.items() if k != "tersoff_scatter"}
        ref = TT.tersoff_scatter_plain(centers, cand, idx, cp, spec, pav)
        assert got[1].shape == (cp.base.grid[2], cp.base.grid[1],
                                12 if pav else 4, cp.nxb, cp.wl)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert torch.isfinite(g).all()
            assert _rel(g, r) <= TOL["tersoff_scatter"], (pav, _rel(g, r))


@pytest.mark.parametrize("fused", [False, True], ids=["contract", "fused"])
def test_tersoff_general_path_matches_plain(dev, tmp_path, fused):
    """Diamond Si compressed to a0 4.1 A (first shell 1.78 A, second 2.90 A,
    inside R2 = 3.0): 16 live bonds a centre, past the kernel's live cap,
    so every centre takes the general path; mn lands past 32 (the mn-64
    instance)."""
    centers, cand, idx, cp, spec = _tersoff_inputs(dev, tmp_path, 4, 0.0,
                                                   0.5, a0=4.1)
    assert 32 < cp.mn_r <= 64
    nb, a_pad = cp.nb, cp.a_pad
    g = TC._gather_lanes(cand.reshape(nb, 4, -1),
                         idx.reshape(nb, cp.mn_r, a_pad))
    c = centers.reshape(nb, 4, 1, a_pad)
    d2 = sum((g[:, q] - c[:, q]) ** 2 for q in range(3))
    live = ((d2 > 1e-6) & (d2 < 9.0) & (g[:, 3] > -0.5)).sum(dim=1)
    assert int(live[c[:, 3, 0] > -0.5].min()) > TT.tersoff_live_cap()
    call = TT.tersoff_scatter_call if fused else TT.tersoff_kernel_call
    plain = TT.tersoff_scatter_plain if fused else TT.tersoff_kernel_plain
    for pav in (False, True):
        got = call(centers, cand, idx, cp, spec, pav)
        ref = plain(centers, cand, idx, cp, spec, pav)
        for gg, r in zip(got, ref):
            assert torch.isfinite(gg).all()
            assert _rel(gg, r) <= TOL["tersoff"], (pav, _rel(gg, r))


def test_tersoff_fused_pass_keeps_newtons_third_law(dev, tmp_path):
    """The fused pass adds at each neighbour the very f32 p_ij it sums at
    the centre: the net force of compact_tersoff_compute (no net-force
    zeroing) is f32 rounding (each atom's force sums pair terms larger
    than itself): at most 64 sqrt(n) eps max|F|, 1.4e-3 max|F| at 32k
    atoms, where one lost or doubled channel would leave O(max|F|)."""
    *_, md, carry = _tersoff_inputs(dev, tmp_path, 16, 0.0, 1.0,
                                    with_md=True)
    s = carry.state
    before = cuda_build.launches["tersoff_scatter"]
    out = TT.compact_tersoff_compute(s.position, s.type, s.mask, s.box,
                                     md.cplan, carry.idx, md.spec)
    assert cuda_build.launches["tersoff_scatter"] == before + 1
    n = int(s.mask.sum())
    fmax = float(out.force.abs().max())
    net = float(out.force.double().sum(dim=0).abs().max())
    assert fmax > 0.1
    assert net <= 64 * n ** 0.5 * 2.0 ** -23 * fmax, (net, fmax)


@pytest.mark.parametrize("call", [TT.tersoff_kernel_call,
                                  TT.tersoff_scatter_call],
                         ids=["contract", "fused"])
def test_tersoff_wrapper_rejects_wrong_inputs(dev, tmp_path, call):
    centers, cand, idx, cp, spec = _tersoff_inputs(dev, tmp_path, 4, 0.0,
                                                   0.5)
    with pytest.raises(ValueError, match="dtype"):
        call(centers.double(), cand, idx, cp, spec, False)
    with pytest.raises(ValueError, match="shape"):
        call(centers, cand[..., :-128].contiguous(), idx, cp, spec, False)
    with pytest.raises(ValueError, match="dtype"):
        call(centers, cand, idx.long(), cp, spec, False)
    with pytest.raises(ValueError, match="CUDA"):
        call(centers, cand.cpu(), idx, cp, spec, False)
    with pytest.raises(ValueError, match="contiguous"):
        call(centers, cand, idx.transpose(3, 4).contiguous().transpose(3, 4),
             cp, spec, False)
    # contiguous, but 4 bytes past an aligned base: the kernel reads the
    # window in 16-byte pieces
    buf = torch.empty(cand.numel() + 1, device=dev)
    buf[1:].copy_(cand.reshape(-1))
    before = dict(cuda_build.launches)
    with pytest.raises(ValueError, match="16-byte boundary"):
        call(centers, buf[1:].view(cand.shape), idx, cp, spec, False)
    assert cuda_build.launches == before


def test_tersoff_wrappers_refuse_windows_past_shared_memory(dev):
    """A plan whose window (cap 64, bx 14: wl 9,216) fits the contract
    mode's shared memory (16 wl bytes and the lane tile) but not the fused
    mode's accumulator with per-atom virials (48 wl more): the fused
    wrapper raises before launching."""
    plan = TG.DenseGridPlan(grid=(14, 3, 3), cap=64, rc=3.0, skin=1.0,
                            pbc=(True, True, True))
    cp = TC.CompactPlan(base=plan, bx=14, mn_r=32, mn_a=32)
    assert cp.wl == 9216
    spec = TT.TersoffSpec(num_types=1, **{k: (1.0,) for k in (
        "a", "b", "lam", "mu", "r1", "r2", "beta", "n", "c2", "d2", "h")})
    nz, ny, nxb = 3, 3, 1
    centers = torch.zeros((nz, ny, nxb, 4, cp.a_pad), device=dev)
    cand = torch.zeros((nz, ny, nxb, 4, cp.wl), device=dev)
    idx = torch.zeros((nz, ny, nxb, 32, cp.a_pad), dtype=torch.int32,
                      device=dev)
    assert TT.tersoff_smem(False, cp.wl, 32, True) <= TC._SMEM_LIMIT
    assert TT.tersoff_smem(True, cp.wl, 32, True) > TC._SMEM_LIMIT
    before = dict(cuda_build.launches)
    with pytest.raises(ValueError, match="shared memory"):
        TT.tersoff_scatter_call(centers, cand, idx, cp, spec, True)
    assert cuda_build.launches == before


def _dense_state(dev, model, n, lengths, pbc, seed, cap=None):
    """Random solid (uniform positions: pairs far inside the ZBL switch)
    binned on the v2 engine's plan_grid plan (or at `cap` slots a cell), in
    f32 on the card."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3)) * lengths
    if not pbc[2]:
        pos[:, 2] = pos[:, 2] * 0.9 + 0.05 * lengths[2]
    types = rng.integers(0, model.num_types, n)
    box = Box.orthogonal(lengths, pbc=pbc, dtype=torch.float32, device=dev)
    p = box.wrap(torch.as_tensor(pos, dtype=torch.float32, device=dev))
    plan = TG.plan_grid(box, model.rc_radial_max, 1.0, n,
                        position=p.cpu().numpy(), cap=cap)
    perm, smask, ov = TG.bin_dense(p, box, torch.ones(n, device=dev), plan)
    assert not bool(ov)
    return (TG.apply_perm(p, perm, 1e5),
            TG.apply_perm(torch.as_tensor(types, dtype=torch.int32,
                                          device=dev), perm, 0),
            smask, box, plan)


def _edge_model():
    """l_max 6 and 20 angular basis functions: at cap 24 the backward
    without queues took 189 KB of shared memory, near the 227 KB limit."""
    return dataclasses.replace(_model("universal", 6),
                               basis_size_angular=19, n_max_angular=5)


# (model, atoms, box lengths, pbc, cap): "dense" packs ~3x the other
# systems' atoms into the box, so each cell's radial and angular queues
# take several pieces of each kernel; "edge" is _edge_model at cap 24;
# "wide" is the "dense" packing at cap 300 (8,192 lanes), where both
# kernels cut a cell into groups of centres and the backward also into
# windows of candidates
_DENSE_CASES = {
    "universal-l2": ("universal-l2", 700, (27.5, 28.0, 29.0), True, None),
    "none-l4": ("none-l4", 700, (27.5, 28.0, 29.0), True, None),
    "trained": ("trained", 700, (27.5, 28.0, 29.0), True, None),
    "open-z": ("universal-l2", 700, (27.5, 28.0, 29.0), False, None),
    "dense": ("trained", 2100, (27.5, 28.0, 29.0), True, None),
    "edge": ("edge", 330, (27.5, 28.0, 29.0), True, 24),
    "wide": ("universal-l2", 2100, (27.5, 28.0, 29.0), True, 300),
}


def _dense_model(dev, which):
    if which == "trained":
        nep = NEP.from_file(MODEL, device=dev)
        return nep.model, nep.params
    model = (_edge_model() if which == "edge" else
             _model("none" if which == "none-l4" else "universal",
                    4 if which == "none-l4" else 2))
    return model, random_params(model, seed=5, dtype=torch.float32,
                                device=dev)


def _dense_passes(dev, case):
    """The kernels' inputs of one dense_nep_compute_v2 pass (k2) and one
    dense_nep_compute pass (k1) on a _DENSE_CASES system."""
    which, n, lengths, pbc_z, cap = _DENSE_CASES[case]
    model, params = _dense_model(dev, which)
    ps, ts, smask, box, plan = _dense_state(
        dev, model, n, np.array(lengths), (True, True, pbc_z), 4, cap)
    spec = TD.DenseNepSpec.from_model(model)
    k2, k1 = {}, {}
    TD.dense_nep_compute_v2(ps, ts, smask, box, plan, model, params, keep=k2)
    TD.dense_nep_compute(ps, ts, smask, box, plan, model, params, keep=k1)
    assert bool((smask == 0).any())  # empty slots in the cells
    return k2, k1, plan, spec


def _dense_calls(k2, k1, plan, spec):
    """name -> (kernel call, plain call) of the four dense kernels."""
    c, w = k2["centers"], k2["cand"]
    g, cs1, ca1 = k1["garr"], k1["cot_s"], k1["cot_a"]
    return {
        "k1b": (lambda: TD.k1b_call(c, w, plan, spec),
                lambda: TD.k1b_plain(c, w, plan, spec)),
        "k2b": (lambda: TD.k2b_call(c, w, k2["cot_s"], k2["cot_a"], plan,
                                    spec),
                lambda: TD.k2b_plain(c, w, k2["cot_s"], k2["cot_a"], plan,
                                     spec)),
        "dense_k1": (lambda: TD.k1_call(g, plan, spec),
                     lambda: TD.k1_plain(g, plan, spec)),
        "dense_k2": (lambda: (TD.k2_call(g, cs1, ca1, plan, spec),),
                     lambda: (TD.k2_plain(g, cs1, ca1, plan, spec),)),
    }


def _check_dense_calls(k2, k1, plan, spec, case):
    """Each dense kernel once against its plain version: one launch each,
    finite, within its tolerance."""
    for name, (kern, plain) in _dense_calls(k2, k1, plan, spec).items():
        n0 = cuda_build.launches[name]
        got = kern()
        assert cuda_build.launches[name] == n0 + 1, name
        for g, r in zip(got, plain()):
            assert g.shape == r.shape
            assert torch.isfinite(g).all()
            assert _rel(g, r) <= TOL[name], (name, case, _rel(g, r))


def _queueless_smem_bytes(spec, cap, lanes, backward):
    """Shared memory of the dense kernels without live-pair queues (a warp
    a centre forward, a thread a candidate backward), whose size checks
    the queues' cut of a cell must accept: a warp's accumulators and 32
    staged pair rows forward, the cell's cotangents backward."""
    zt = TD.z_tables_flat(spec.l_max).size
    if backward:
        return 4 * (cap * (4 + spec.s_width + spec.a_width) + zt + 24 * cap)
    stride = (2 + spec.kr1 + spec.ka1 + spec.nlm) | 1
    return 4 * (4 * lanes + zt
                + 8 * (spec.a_width + spec.s_width + 32 * stride))


@pytest.mark.parametrize("case", list(_DENSE_CASES))
def test_dense_kernels_match_plain(dev, case):
    """K1b, K2b (one dense_nep_compute_v2 pass) and the round-1 K1, K2 (one
    dense_nep_compute pass), each against its plain version on the tensors
    of its pass; each call moves its launch counter by one."""
    before = dict(cuda_build.launches)
    k2, k1, plan, spec = _dense_passes(dev, case)
    for name in ("k1b", "k2b", "dense_k1", "dense_k2"):
        assert cuda_build.launches[name] == before[name] + 1, name
    if case == "dense":
        # more queue positions a cell than one piece of either kernel holds
        cap, lanes = plan.cap, k2["cand"].shape[-1]
        fwd = TD.dense_tiling(spec, cap, lanes, False)
        bwd = TD.dense_tiling(spec, cap, lanes, True)
        rad, ang = _dense_cell_queues(k2, plan, spec)
        assert rad > max(fwd.qr, bwd.qr) and ang > max(fwd.qa, bwd.qa), (
            rad, ang)
    if case == "wide":
        # the queueless kernels took this plan; the cut has more than one
        # group a cell in both directions and more than one window in the
        # backward, for both rounds' lanes
        live = _dense_live_centres(k2, plan)
        for ln in (k2["cand"].shape[-1], 27 * plan.cap):
            for bwd in (False, True):
                assert _queueless_smem_bytes(spec, plan.cap, ln, bwd) <= \
                    TD._SMEM_LIMIT
                tile = TD.dense_tiling(spec, plan.cap, ln, bwd)
                assert tile.gc < live, (ln, bwd, tile, live)
                assert (tile.cw < ln) == bwd, (ln, bwd, tile)
    if case == "dense":
        assert TD.dense_tiling(spec, plan.cap, k2["cand"].shape[-1],
                               True).gc < _dense_live_centres(k2, plan)
    if case == "edge":
        lanes = k2["cand"].shape[-1]
        for bwd, ln in ((True, lanes), (False, lanes), (True, 27 * plan.cap),
                        (False, 27 * plan.cap)):
            assert _queueless_smem_bytes(spec, plan.cap, ln, bwd) <= \
                TD._SMEM_LIMIT
        assert _queueless_smem_bytes(spec, plan.cap, lanes, True) > \
            0.8 * TD._SMEM_LIMIT
    _check_dense_calls(k2, k1, plan, spec, case)


def _dense_live_centres(k2, plan):
    """The most live centres of one cell (an empty slot is at FAR, type
    -1)."""
    c = k2["centers"].reshape(-1, 4, plan.cap)
    dead = (c[:, 3] <= -0.5) & (c[:, 0] >= 5.0e4)
    return int((~dead).sum(dim=1).max())


def _dense_cell_queues(k2, plan, spec):
    """The largest radial and angular live-pair counts of one cell."""
    cap = plan.cap
    c = k2["centers"].reshape(-1, 4, cap, 1)
    w = k2["cand"].reshape(c.shape[0], 4, 1, -1)
    d = torch.sqrt(sum((w[:, q] - c[:, q]) ** 2 for q in range(3)))
    ok = (d > 1e-3) & (w[:, 3] > -0.5) & (c[:, 3] > -0.5)
    rad = (ok & (d < max(spec.rc_radial))).sum(dim=(1, 2)).max()
    ang = (ok & (d < min(spec.rc_angular))).sum(dim=(1, 2)).max()
    return int(rad), int(ang)


@pytest.mark.parametrize("case", ["trained", "dense"])
@pytest.mark.parametrize("cw,gc,q", [(64, 5, 32), (96, 1, 64)])
def test_dense_kernels_small_cuts_match_plain(dev, monkeypatch, case, cw, gc,
                                              q):
    """The four kernels with a cell cut into windows of cw lanes, groups of
    gc centres and queue pieces of q pairs, in both directions, against
    their plain versions: the sums a centre carries from window to window
    and group to group, and the candidate sums a window keeps."""
    k2, k1, plan, spec = _dense_passes(dev, case)
    live = _dense_live_centres(k2, plan)
    assert gc < live and cw < 27 * plan.cap, (live, plan.cap)

    def cut(spec_, cap, lanes, backward):
        words = TD._dense_smem_words(spec_, cap, cw, gc, q, q, backward)
        return TD.DenseTile(cw, gc, q, q, 4 * words)

    monkeypatch.setattr(TD, "dense_tiling", cut)
    _check_dense_calls(k2, k1, plan, spec, case)


@pytest.mark.parametrize("case", ["trained", "dense", "wide"])
def test_dense_kernels_equal_bits_and_newton(dev, case):
    """Two launches of each dense kernel give the same bits; every pair's
    p_ij goes to its centre and its candidate alike, so the net gradient of
    a pass (dcenter plus dcand, or the round-1 tiles, over every cell) is
    zero to f32 rounding."""
    k2, k1, plan, spec = _dense_passes(dev, case)
    calls = _dense_calls(k2, k1, plan, spec)
    for name, (kern, _) in calls.items():
        a, b = kern(), kern()
        for x, y in zip(a, b):
            assert torch.equal(x, y), name
    dcen, dcand = calls["k2b"][0]()
    tiles = calls["dense_k2"][0]()[0]
    nx, ny, nz = plan.grid
    for parts in ((dcen.transpose(3, 4).reshape(-1, 3),
                   dcand.transpose(3, 4).reshape(-1, 3)),
                  (tiles.reshape(nz, ny, nx, 9, 3, -1).transpose(4, 5)
                   .reshape(-1, 3),)):
        net = sum(p.double().sum(dim=0) for p in parts)
        scale = sum(p.double().abs().sum(dim=0) for p in parts)
        assert bool((net.abs() <= 1e-5 * scale).all()), (net, scale)


def test_dense_wrappers_reject_wrong_inputs(dev):
    model = _model("universal", 2)
    params = random_params(model, seed=5, dtype=torch.float32, device=dev)
    ps, ts, smask, box, plan = _dense_state(
        dev, model, 300, np.array([23.0, 23.0, 23.0]), (True,) * 3, 1)
    spec = TD.DenseNepSpec.from_model(model)
    k = {}
    TD.dense_nep_compute_v2(ps, ts, smask, box, plan, model, params, keep=k)
    c, w = k["centers"], k["cand"]
    with pytest.raises(ValueError, match="dtype"):
        TD.k1b_call(c.double(), w, plan, spec)
    with pytest.raises(ValueError, match="shape"):
        TD.k1b_call(c, w[..., :27 * plan.cap - 1].contiguous(), plan, spec)
    with pytest.raises(ValueError, match="contiguous"):
        TD.k2b_call(c, w, k["cot_s"], k["cot_a"].transpose(3, 4), plan, spec)
    with pytest.raises(ValueError, match="dtype"):
        TD.k1_call(k["garr"].double(), plan, spec)
    with pytest.raises(ValueError, match="shape"):
        TD.k2_call(k["garr"], k["cot_s"], k["cot_a"], plan, spec)
    with pytest.raises(ValueError, match="CUDA"):
        TD.k2b_call(c, w.cpu(), k["cot_s"], k["cot_a"], plan, spec)
    with pytest.raises(ValueError, match="contiguous"):
        TD.k1_call(k["garr"].transpose(0, 1), plan, spec)
    # the kernels read their inputs by 4-byte element: a base 4 bytes off a
    # 16-byte boundary is taken, and gives the same results
    buf = torch.empty(w.numel() + 1, device=dev)
    w4 = buf[1:].view(w.shape)
    w4.copy_(w)
    assert w4.data_ptr() % 16 == 4
    for x, y in zip(TD.k1b_call(c, w4, plan, spec),
                    TD.k1b_call(c, w, plan, spec)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The probe kernels (csrc/probes.cu) against their plain versions.  TF32
# products keep 10 mantissa bits of each input: 2e-3 of max|plain|; the
# f32 FFMA path, the pair reduce and the blocked gather add f32 terms in
# another order: 1e-5; the gather copies: bit for bit.
# ---------------------------------------------------------------------------


def _gen(dev, seed):
    return torch.Generator(dev).manual_seed(seed)


# The TF32 one-hot dot tiles the (nb m, k) matrix in 128 rows across b
# boundaries (nb 3 x m 88 and 72, 108, 96: tiles that straddle b; nb 1 x m
# 20: one part-full tile), at wgmma N 16, 64 and 128 (n 16, 48, 64, 96,
# 128), each with and without a k split, with k past the last whole stage
# (k 100) and ksplit 4 on k 3072 and 4096; at nb 300 the 132 persistent
# blocks walk two or three tiles each.  The launcher's shared memory is
# the plan's.  The f32 path runs the same cases.
@pytest.mark.parametrize("prec", PM.PRECISIONS)
@pytest.mark.parametrize("nb,m,k,n,ksplit", [
    (3, 144, 4096, 128, 1), (3, 144, 4096, 128, 4), (3, 72, 4096, 128, 1),
    (3, 88, 3072, 128, 1), (3, 108, 4096, 128, 1), (3, 96, 3072, 128, 4),
    (1, 20, 100, 64, 1), (1, 20, 100, 16, 1), (3, 88, 3072, 16, 1),
    (7, 144, 3072, 128, 4), (7, 88, 256, 48, 1), (2, 40, 512, 96, 2),
    (300, 144, 256, 128, 1), (300, 96, 512, 128, 4), (3, 88, 3072, 16, 4),
    (1, 20, 256, 64, 2)])
def test_probe_onehot_matches_plain(dev, prec, nb, m, k, n, ksplit):
    vals = torch.randn((nb, m, k), device=dev, generator=_gen(dev, m + k))
    plan = (PM.onehot_plan if prec == "default" else PM.onehot_f32_plan)(
        nb, m, k, n, ksplit)
    smem, blocks = PM.wgmma_occupancy(plan)
    assert smem == plan.smem and blocks >= 1
    before = cuda_build.launches["probe_onehot_dot"]
    got = PM.onehot_dot(vals, n, ksplit, prec)
    assert cuda_build.launches["probe_onehot_dot"] == before + 1
    ref = PM.onehot_dot_plain(vals, n, ksplit)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel(got, ref) <= (2e-3 if prec == "default" else 1e-5)
    assert torch.equal(PM.onehot_dot(vals, n, ksplit, prec), got)
    assert cuda_build.launches["probe_onehot_dot"] == before + 2


# The f32 path against the product in f64 on random normal inputs (with
# ones, mid and lo would be zero and a dropped term would pass): its error
# at most twice that of f32 torch.matmul (TF32 off) on the same inputs, at
# the timed m, k, n and at odd shapes: m 72, 88, 108; n 16, 96, 128; k 96
# in 3 parts of 32 columns (parts that are not whole 64-column stages, on
# the ring); k 98, which the ring cannot take (no TMA row stride), so the
# FFMA kernel does, chosen from the shape.
@pytest.mark.parametrize("nb,m,k,n,ksplit", [
    (40, 144, 4096, 128, 1), (40, 144, 4096, 128, 4), (9, 72, 4096, 128, 1),
    (9, 88, 3072, 96, 1), (9, 108, 4096, 16, 1), (9, 88, 96, 128, 3),
    (9, 72, 96, 16, 3), (9, 108, 98, 96, 1), (9, 72, 98, 128, 1)])
def test_probe_onehot_f32_error_against_f64(dev, nb, m, k, n, ksplit):
    vals = torch.randn((nb, m, k), device=dev, generator=_gen(dev, 3 * k + m))
    assert PM.onehot_f32_on_ring(k, vals.data_ptr()) == (k % 4 == 0)
    before = cuda_build.launches["probe_onehot_dot"]
    got = PM.onehot_dot(vals, n, ksplit, "highest")
    assert cuda_build.launches["probe_onehot_dot"] == before + 1
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = PM.onehot_dot_plain(vals, n, ksplit)
    exact = PM.onehot_dot_plain(vals.double(), n, ksplit)
    err = float((got.double() - exact).abs().max())
    err_lib = float((lib.double() - exact).abs().max())
    assert err <= 2 * err_lib, (err, err_lib)


# The f32 path on rows of one random normal value each, at a random
# column: every row sum is exact in f32, so the result must be the f64
# product bit for bit.  This catches a kernel that drops the split's mid or
# lo term, which the error check above cannot see (a lo term is below
# 2^-21 of its value).  The ring at ksplit 1 and 4, parts that are not
# whole stages, n 16 and 96; the FFMA kernel at k 98 and on a base 4 bytes
# past 16-byte alignment, chosen from the shape.
@pytest.mark.parametrize("nb,m,k,n,ksplit,offset", [
    (9, 144, 4096, 128, 1, 0), (9, 144, 4096, 128, 4, 0),
    (9, 88, 96, 128, 3, 0), (9, 72, 4096, 16, 1, 0), (9, 108, 3072, 96, 1, 0),
    (9, 108, 98, 96, 1, 0), (9, 144, 4096, 128, 1, 1)])
def test_probe_onehot_f32_exact_row_sums(dev, nb, m, k, n, ksplit, offset):
    gen = _gen(dev, 5 * k + m + offset)
    vals = torch.zeros(nb * m * k + offset, device=dev)[offset:]
    vals = vals.view(nb, m, k)
    col = torch.randint(0, k, (nb, m, 1), device=dev, generator=gen)
    one = torch.randn((nb, m, 1), device=dev, generator=gen)
    vals.scatter_(2, col, one)
    # about half the values have a lo term, so a kernel without it fails
    assert int((PM.tf32_split(one)[2] != 0).sum()) > nb * m // 4
    assert PM.onehot_f32_on_ring(k, vals.data_ptr()) == (
        k % 4 == 0 and offset == 0)
    got = PM.onehot_dot(vals, n, ksplit, "highest")
    exact = PM.onehot_dot_plain(vals.double(), n, ksplit)
    assert torch.equal(got, exact.float())


# The feature matmul at wgmma N 32, 192 and 256 (ch 24, 168, 200), at nb 1
# and 7 (a block a b) and nb 300, where each of the 132 persistent blocks
# walks two or three b through the ring.  The launcher's shared memory is
# the plan's.
@pytest.mark.parametrize("nb,ch", [(5, 24), (5, 168), (5, 200), (1, 168),
                                   (7, 200), (7, 24), (300, 168)])
def test_probe_feature_matches_plain(dev, nb, ch):
    vals = torch.randn((nb, 32 * 8, 128), device=dev,
                       generator=_gen(dev, ch + nb))
    plan = PM.feature_plan(nb, 32, 8, ch)
    smem, blocks = PM.wgmma_occupancy(plan)
    assert smem == plan.smem and blocks >= 1
    before = cuda_build.launches["probe_feature_matmul"]
    got = PM.feature_matmul(vals, ch)
    assert cuda_build.launches["probe_feature_matmul"] == before + 1
    ref = PM.feature_matmul_plain(vals, ch)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel(got, ref) <= 2e-3
    assert torch.equal(PM.feature_matmul(vals, ch), got)


# The pair reduce, both orders against the plain version at chunks 1, 2,
# 4 and 13 (the most one lane tile's slab holds), nb 1 and 9, 128 lanes,
# 100 and 36 (a part-full last tile of 16 lanes), 1024 and 300 (the spill
# order's 168 accumulators take 254 registers a thread, so it runs 4 and 2
# tiles of 256 lanes a b).  Each call moves the counter by one, two calls
# give equal bits, and the tiled order equals the spill order bit for bit:
# both sum a channel in chunk, then row order with fmaf.  The tiled
# launcher's shared memory, threads, tile and blocks are the plan's.
REDUCE_CASES = [(9, 4, 128), (1, 4, 128), (9, 1, 128), (9, 2, 128),
                (1, 13, 128), (9, 4, 100), (3, 3, 36), (2, 4, 1024),
                (3, 2, 300)]


@pytest.mark.parametrize(
    "order,nb,chunks,lanes",
    [(o, *c) for o in PM.ORDERS for c in REDUCE_CASES])
def test_probe_pair_reduce_matches_plain(dev, order, nb, chunks, lanes):
    gen = _gen(dev, 7 + chunks)
    g = torch.randn((nb, chunks * 8 * 7, lanes), device=dev, generator=gen)
    y = torch.randn((nb, chunks * 8 * 24, lanes), device=dev, generator=gen)
    if order == "tiled":
        plan = PM.reduce_plan(nb, chunks, lanes)
        occ = PM.reduce_occupancy(nb, chunks, lanes)
        assert occ == dict(smem=plan.smem, threads=plan.threads,
                           tile=plan.tile, units=plan.units,
                           blocks_per_sm=plan.blocks_per_sm)
    before = cuda_build.launches["probe_pair_reduce"]
    got = PM.pair_reduce(g, y, order=order)
    assert cuda_build.launches["probe_pair_reduce"] == before + 1
    ref = PM.pair_reduce_plain(g, y)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel(got, ref) <= 1e-5
    assert torch.equal(PM.pair_reduce(g, y, order=order), got)
    if order == "tiled":
        assert torch.equal(got, PM.pair_reduce(g, y, order="spill"))
    assert cuda_build.launches["probe_pair_reduce"] == before + (
        3 if order == "tiled" else 2)


@pytest.mark.parametrize("nblk,chunks,zeros", [
    (18, 14, False), (11, 14, False), (11, 12, False), (3, 2, False),
    (18, 14, True), (27, 14, False), (1, 14, False), (1, 2, True),
    (120, 2, False)])
def test_probe_bgather_matches_plain(dev, nblk, chunks, zeros):
    # the script's zero indices, nblk 27 (past what a block's shared
    # memory held when the whole window was staged), one block of columns,
    # and a window cut into many chunks
    gen = _gen(dev, nblk)
    width = 128 * nblk
    src = torch.randn((6, 17, width), device=dev, generator=gen)
    shape = (6, 8 * chunks, 128)
    if zeros:
        idx = torch.zeros(shape, device=dev, dtype=torch.int32)
    else:
        idx = torch.randint(-50, width + 50, shape, device=dev,
                            generator=gen, dtype=torch.int32)
        assert (idx < 0).any() and (idx >= width).any()
    plan = PM.bgather_plan(6, 17, 8 * chunks, width)
    assert plan.stage and PM.bgather_occupancy(plan) >= 1
    before = cuda_build.launches["probe_bgather"]
    got = PM.bgather(src, idx)
    assert cuda_build.launches["probe_bgather"] == before + 1
    assert _rel(got, PM.bgather_plain(src, idx)) <= 1e-5
    assert torch.equal(PM.bgather(src, idx), got)  # no atomics


@pytest.mark.parametrize("lv,stage,bps,chunk,lanes,nq", [
    (4, True, 2, None, 128, 16), (1, True, 2, None, 128, 16),
    (4, True, 1, None, 128, 16), (1, True, 1, 8, 128, 16),
    (4, True, 2, 64, 128, 16), (4, False, 2, None, 128, 16),
    (1, False, 2, None, 128, 16), (1, True, 2, None, 6, 3),
    (1, False, 2, None, 5, 3), (4, True, 2, 16, 100, 8)])
def test_probe_bgather_every_instance_matches_plain(dev, lv, stage, bps,
                                                    chunk, lanes, nq):
    # both sums (4 lanes a thread, 1), staged or read from src, chunks of
    # 8 to all columns, lanes and index rows whose slab is not whole
    # 16-byte pieces (6 x 3, 5 x 3: copied and read one index at a time)
    gen = _gen(dev, 10 * lv + bps)
    width = 128 * 3 - 4  # the last sector half full
    src = torch.randn((5, 17, width), device=dev, generator=gen)
    idx = torch.randint(-50, width + 50, (5, nq, lanes), device=dev,
                        generator=gen, dtype=torch.int32)
    plan = PM.bgather_plan(5, 17, nq, width, lanes, bps=bps, lv=lv)
    if chunk:
        plan = dataclasses.replace(
            plan, chunk=chunk,
            smem=PM.bgather_smem(nq, lanes, 17, width, chunk))
    if not stage:
        plan = dataclasses.replace(plan, stage=False, chunk=0, smem=0)
    assert PM.bgather_occupancy(plan) >= 1
    got = PM.bgather(src, idx, plan)
    assert _rel(got, PM.bgather_plain(src, idx)) <= 1e-5


def test_probe_bgather_reads_src_where_the_indices_fill_shared_memory(dev):
    gen = _gen(dev, 11)
    src = torch.randn((3, 17, 256), device=dev, generator=gen)
    idx = torch.randint(-50, 306, (3, 120, 512), device=dev, generator=gen,
                        dtype=torch.int32)
    assert not PM.bgather_plan(3, 17, 120, 256, 512).stage
    assert _rel(PM.bgather(src, idx), PM.bgather_plain(src, idx)) <= 1e-5


def test_wrappers_follow_the_current_stream_and_graph_capture(dev):
    # cuda_build.stream() is read at each call: a launch on a caller's
    # stream and one captured in a CUDA graph give the default stream's
    # result
    x = torch.linspace(0.5, 120.0, 8192, device=dev).reshape(8, 1024)
    gen = _gen(dev, 7)
    src = torch.randn((4, 17, 128 * 18), device=dev, generator=gen)
    idx = torch.randint(-50, 128 * 18 + 50, (4, 16, 128), device=dev,
                        generator=gen, dtype=torch.int32)
    ref = (*PT.run(x), PM.bgather(src, idx))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = (*PT.run(x), PM.bgather(src, idx))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = (*PT.run(x), PM.bgather(src, idx))
    graph.replay()
    torch.cuda.synchronize()
    for r, s, c in zip(ref, on_side, captured):
        assert torch.equal(r, s) and torch.equal(r, c)


def test_probe_gather_bit_for_bit(dev):
    table, idx = PG.make_inputs(w=11200, s=1024, g=4, device=dev, seed=2)
    got = PG.gather_call(table, idx)
    assert torch.equal(got, PG.gather_plain(table, idx))


def test_probe_transcendentals_within_gate(dev):
    for key, v in PT.measure(dev).items():
        assert v["kernel_max_rel"] <= 1e-6, (key, v)
    x = torch.linspace(0.5, 120.0, 4096, device=dev)
    for got, ref in zip(PT.run(x), PT.run_plain(x)):
        assert _rel(got, ref) <= 1e-6


def test_probe_wrappers_reject_wrong_inputs(dev):
    # the blocked gather takes a window past shared memory (nblk 27), and
    # refuses a width that is not whole 16-byte pieces and int64 indices
    src27 = torch.randn((2, 17, 128 * 27), device=dev)
    idx27 = torch.randint(0, 128 * 27, (2, 8, 128), device=dev,
                          dtype=torch.int32)
    assert _rel(PM.bgather(src27, idx27),
                PM.bgather_plain(src27, idx27)) <= 1e-5
    before = dict(cuda_build.launches)
    with pytest.raises(ValueError, match="multiple of 4"):
        PM.bgather(torch.zeros((1, 17, 130), device=dev),
                   torch.zeros((1, 8, 128), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="dtype"):
        PM.bgather(src27, idx27.long())
    assert cuda_build.launches == before
    with pytest.raises(ValueError, match="dtype"):
        PM.onehot_dot(torch.zeros((1, 16, 32), dtype=torch.float64,
                                  device=dev), 128)
    with pytest.raises(ValueError, match="multiple of 16"):
        PM.onehot_dot(torch.zeros((1, 16, 32), device=dev), 100)
    with pytest.raises(ValueError, match="na 7"):
        PM.pair_reduce(torch.zeros((1, 48, 128), device=dev),
                       torch.zeros((1, 96, 128), device=dev), na=6, nlm=12)
    # what the tiled reduce cannot take: a slab past shared memory (14
    # chunks), lanes that are not whole 16-byte pieces, an unaligned base;
    # the spill order takes the first two
    before = dict(cuda_build.launches)
    g14 = torch.randn((1, 14 * 56, 128), device=dev)
    y14 = torch.randn((1, 14 * 192, 128), device=dev)
    with pytest.raises(ValueError, match="1 to 13 chunks"):
        PM.pair_reduce(g14, y14, order="tiled")
    g98 = torch.randn((2, 4 * 56, 98), device=dev)
    y98 = torch.randn((2, 4 * 192, 98), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        PM.pair_reduce(g98, y98, order="tiled")
    gf = torch.zeros(4 * 56 * 128 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        PM.pair_reduce(gf[1:].view(1, 4 * 56, 128),
                       torch.zeros((1, 4 * 192, 128), device=dev),
                       order="tiled")
    assert cuda_build.launches == before
    for gg, yy in ((g14, y14), (g98, y98)):
        assert _rel(PM.pair_reduce(gg, yy, order="spill"),
                    PM.pair_reduce_plain(gg, yy)) <= 1e-5
    # what the TF32 kernels cannot take: a TMA row stride that is no
    # multiple of 16 bytes, k-split parts that are not whole stages, a
    # table wider than one wgmma N, an unaligned base; the f32 path takes
    # the first two (k 98 on the FFMA kernel, the parts on the ring)
    before = dict(cuda_build.launches)
    odd = torch.randn((2, 16, 98), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        PM.onehot_dot(odd, 128)
    with pytest.raises(ValueError, match="parts"):
        PM.onehot_dot(torch.zeros((1, 16, 256), device=dev), 128, 8)
    with pytest.raises(ValueError, match="at most 256"):
        PM.feature_matmul(torch.zeros((1, 256, 128), device=dev), 300)
    flat = torch.zeros(16 * 64 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        PM.onehot_dot(flat[1:].view(1, 16, 64), 128)
    assert cuda_build.launches == before
    assert _rel(PM.onehot_dot(odd, 128, 1, "highest"),
                PM.onehot_dot_plain(odd, 128)) <= 1e-5
    assert _rel(PM.onehot_dot(odd[:, :, :96].contiguous(), 128, 3,
                              "highest"),
                PM.onehot_dot_plain(odd[:, :, :96].contiguous(), 128,
                                    3)) <= 1e-5


def test_trainer_forward_and_gnep_step_match_cpu_f64(dev):
    """The trainers' path on the card (plain torch, f32, TF32 off) at the
    artifacts model's width against the CPU in f64: batched_forward on two
    64-atom PbTe frames with random labels, and one gnep step's loss,
    gradient norm and Adam moments (m = 0.1 g, v = 0.001 g^2: the
    gradients through the forces).  Bounds: f32 rounding, relative to each
    quantity's largest value: 1e-5 (energies), 1e-4 (forces, virials,
    losses), 1e-3 (the second-order gradients).  No kernel launches."""
    from gpumd_tpu_torch.engine.nep_compact import pin_fp32_matmul
    from gpumd_tpu_torch.io.xyz import XYZFrame
    from gpumd_tpu_torch.potentials.nep.params import load_nep_txt
    from gpumd_tpu_torch.scripts.pbte_train_set import pbte_frames
    from gpumd_tpu_torch.train import nep_train as TT
    from gpumd_tpu_torch.train.dataset import batch_structures

    pin_fp32_matmul()
    rng = np.random.default_rng(14)
    frames = [XYZFrame(symbols=["Pb" if t else "Te" for t in ty],
                       positions=pos, lattice=np.diag([edge] * 3),
                       forces=rng.normal(0, 0.5, (len(pos), 3)),
                       info={"energy": f"{-3.5 * len(pos):.6f}",
                             "virial": " ".join(f"{x:.6f}" for x in
                                                rng.normal(0, 2.0, 9))})
              for pos, ty, edge in pbte_frames(2, 2, seed=15)]
    out, steps = {}, {}
    for where, dtype in ((dev, torch.float32),
                         (torch.device("cpu"), torch.float64)):
        model, params = load_nep_txt(MODEL, dtype=dtype, device=where)
        batch = batch_structures(frames, model.symbols, rc=8.0, mn=200,
                                 dtype=dtype, device=where)
        before = dict(cuda_build.launches)
        out[where.type] = TT.batched_forward(model, params, batch)
        zeros = TT.with_leaves(params, [torch.zeros_like(x) for x in
                                        TT.param_leaves(params)])
        state = TT.GnepState(
            params=params, m=zeros, v=zeros,
            step=torch.zeros((), dtype=torch.int32, device=where),
            avg_norm=torch.tensor(-1.0, device=where))
        steps[where.type] = TT.make_gnep_step(
            model, TT.LossWeights(), 0.0)(state, batch, 1e-3)
        assert cuda_build.launches == before
    g, c = out["cuda"], out["cpu"]
    assert _rel(g.energy.cpu().double(), c.energy) <= 1e-5
    assert _rel(g.force.cpu().double(), c.force) <= 1e-4
    assert _rel(g.virial.cpu().double(), c.virial) <= 1e-4
    (gs, gm), (cs, cm) = steps["cuda"], steps["cpu"]
    for k in ("loss", "mse_e", "mse_f", "mse_v"):
        assert _rel(gm[k].cpu().double(), cm[k]) <= 1e-4, k
    assert _rel(gs.avg_norm.cpu().double(), cs.avg_norm) <= 1e-3
    for a, b in zip(TT.param_leaves(gs.m), TT.param_leaves(cs.m)):
        assert _rel(a.cpu().double(), b) <= 1e-3
