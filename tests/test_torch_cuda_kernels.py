"""The port's CUDA kernels vs their plain torch versions, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip.  They do
not import JAX (the GPU machine has none), so run them there with:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

They cover what chip_smoke.py does not: every ZBL variant, two l_max
template instances, and fold plans with bx = 1, odd caps and free axes.
Tolerances are relative to max|plain| in f32: 1e-5 for K1 and the fold
(summation order), 1e-4 for K2 and the scatter (op order and
shared-memory atomics).
"""

import numpy as np
import pytest
import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine import fold_kernel as TF
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.potentials.nep.params import NepModel, random_params

pytestmark = pytest.mark.cuda

TOL = {"k1": 1e-5, "fold": 1e-5, "k2": 1e-4, "scatter": 1e-4}


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
                                 rc_angular=4.0)
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


@pytest.mark.parametrize("bx,cap,grid,pbc", [
    (1, 40, (3, 4, 3), (True, True, True)),
    (3, 24, (3, 3, 4), (True, False, True)),
    (2, 48, (4, 3, 1), (True, True, False)),
    (2, 64, (6, 5, 4), (True, True, True)),
])
def test_fold_matches_plain_every_plan(dev, bx, cap, grid, pbc):
    plan = TG.DenseGridPlan(grid=grid, cap=cap, rc=4.0, skin=1.0, pbc=pbc)
    nx, ny, nz = grid
    wl = TG.round_up(9 * (bx + 2) * cap, 128)
    dw = torch.randn((nz, ny, 5, nx // bx, wl), device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    before = cuda_build.launches["fold"]
    got = TF.fold_windows_to_rows(dw, plan, bx)
    assert cuda_build.launches["fold"] == before + 1
    assert _rel(got, TF.fold_windows_to_rows_plain(dw, plan, bx)) <= 1e-5


def test_wrappers_reject_wrong_dtype(dev):
    plan = TG.DenseGridPlan(grid=(3, 3, 3), cap=16, rc=4.0, skin=1.0,
                            pbc=(True, True, True))
    dw = torch.zeros((3, 3, 4, 1, 768), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        TF.fold_windows_to_rows(dw, plan, 3)
