"""Plain versions of the port's four kernels vs the JAX package's Pallas
kernels (interpret mode), f64 on the CPU.

The system is 160 atoms of a random two-species solid with the small NEP
model of tests/test_nep_compact.py (n_max 2, basis 2, l_max 2, universal
ZBL).  The JAX oracle runs once per module: K1, the middle and its VJP,
then K2 and the scatter with per-atom virials off and on.  Each port
function gets the JAX kernel's own numpy inputs.  Sums are taken in
another order, so outputs agree to f64 rounding: rtol 1e-9 with an
absolute floor of 1e-12 (values are O(1e-3 .. 1e2)).

The JAX side runs under a pinned process state (`jax_oracle_state`): x64
on and matmul precision "highest", restored on exit.  Test files that ran
earlier on the same worker can leave other settings behind
(gpumd_tpu/app/nep.py sets the matmul precision to "high" for the whole
process), and the oracle must not depend on them.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.engine import fold_kernel as JF
from gpumd_tpu.engine import grid as JG
from gpumd_tpu.engine import nep_compact as JC
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.potentials.nep.params import NepModel as JModel
from gpumd_tpu.potentials.nep.params import random_params as jrandom_params
from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine import fold_kernel as TF
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.potentials.nep.params import NepModel, random_params
from torch_first_trig import warm_torch_transcendentals  # noqa: F401


RTOL, ATOL = 1e-9, 1e-12

MODEL_KW = dict(
    version=4, model_type=0, num_types=2, symbols=("Te", "Pb"),
    atomic_numbers=(52, 82), rc_radial=(8.0, 8.0), rc_angular=(4.0, 4.0),
    mn_radial=96, mn_angular=24, n_max_radial=2, n_max_angular=2,
    basis_size_radial=2, basis_size_angular=2, l_max=2, neurons=30,
    zbl=True, zbl_rc_inner=1.0, zbl_rc_outer=2.0)


@contextlib.contextmanager
def jax_oracle_state():
    """x64 on and full-precision matmuls for the JAX reference, whatever
    the process-wide settings; both restored on exit."""
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        yield


def _assert_f64(arrays):
    """Every floating reference array is float64."""
    for name, v in arrays.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            assert v.dtype == np.float64, (name, v.dtype)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, ref):
    """|got - ref| <= ATOL + RTOL |ref| everywhere; a failure names the
    worst element, its index, how many elements fail, and the process
    state that could change either side (JAX's x64 and matmul precision,
    torch's default dtype and threads)."""
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    with np.errstate(invalid="ignore"):
        excess = np.abs(got - ref) - (ATOL + RTOL * np.abs(ref))
    bad = ~(excess <= 0)  # NaN fails too
    if bad.any():
        worst = tuple(int(i) for i in np.unravel_index(
            np.argmax(np.where(np.isnan(excess), np.inf, excess)),
            got.shape))
        raise AssertionError(
            f"{int(bad.sum())} of {got.size} elements outside rtol {RTOL}, "
            f"atol {ATOL}; worst at {worst}: got {got[worst]!r}, ref "
            f"{ref[worst]!r}, |diff| {abs(got[worst] - ref[worst]):.3e}; "
            f"max|ref| {np.nanmax(np.abs(ref)):.3e}; jax x64 "
            f"{jax.config.jax_enable_x64}, matmul precision "
            f"{jax.config.jax_default_matmul_precision}, ref dtype "
            f"{ref.dtype}; torch default dtype {torch.get_default_dtype()}, "
            f"threads {torch.get_num_threads()}")


@pytest.fixture(scope="module")
def oracle():
    with jax_oracle_state():
        return _oracle()


def _oracle():
    rng = np.random.default_rng(11)
    n, lengths = 160, [27.5, 28.5, 30.0]
    nx = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(nx)] * 3, indexing="ij"), -1)
    pos = grid.reshape(-1, 3)[:n] * 3.3 + rng.uniform(-0.35, 0.35, (n, 3))
    pos = pos * (np.asarray(lengths) / (nx * 3.3))
    types = rng.integers(0, 2, n)
    jmodel = JModel(**MODEL_KW)
    jparams = jrandom_params(jmodel, seed=7, dtype=jnp.float64)
    box = JBox.orthogonal(lengths)
    pos = np.array(box.wrap(jnp.asarray(pos)))
    plan = JG.plan_grid(box, 8.0, 0.5, n, position=pos)
    # the smallest caps the kernels take (4 radial, 1 angular 8-row chunk)
    # keep the interpret-mode Pallas calls short; build_indices checks them
    cplan = JC.make_compact_plan(plan, position=pos, box=box, rc_angular=4.0,
                                 mn_r=32, mn_a=8)
    # eager JAX compiles every op on its own; one jit per stage is faster
    @jax.jit
    def setup(pos, types):
        perm, smask, _ = JG.bin_dense(pos, box, jnp.ones(n), plan)
        pos_s = JG.apply_perm(pos, perm, fill=1e5)
        typ_s = JG.apply_perm(types, perm, fill=0)
        garr = JG.pack_ghost(pos_s, typ_s, smask, box, plan)
        centers = JC.block_centers(garr, cplan)
        cand = JG.pack_block_windows(garr, plan, cplan.bx, cplan.wl)
        idx, ok = JC.build_indices(centers, cand, cplan, 4.0)
        return typ_s, smask, centers, cand, idx, ok

    typ_s, smask, centers, cand, idx, ok = setup(
        jnp.asarray(pos), jnp.asarray(types, jnp.int32))
    assert bool(ok)
    spec = JC.CompactSpec.from_model(jmodel, jparams)
    k1, tiles = JC.k1_call(centers, cand, idx, cplan, spec, True)

    @jax.jit
    def middle(k1, typ_s, smask):
        """The middle and its VJP, as compact_pipeline runs them."""
        sr, nsd = spec.sr, spec.na1 * spec.nlm
        nz, ny = plan.grid[2], plan.grid[1]
        n_flat = nz * ny * cplan.nxb * cplan.a_pad
        ti_f = JC._slots_to_lane_blocks(typ_s, cplan, 0).reshape(n_flat)
        mask_f = JC._slots_to_lane_blocks(smask, cplan, 0.0).reshape(n_flat)
        e_flat, vjp = jax.vjp(
            lambda a, b, c: JC.middle_compact_flat(a, b, c, ti_f, mask_f,
                                                   jmodel, jparams),
            k1[:sr], k1[sr], k1[sr + 1:sr + 1 + nsd])
        cot_sr, cot_z, cot_s = vjp(jnp.ones_like(e_flat))
        cotc = jnp.concatenate([cot_sr, cot_z[None], cot_s, jnp.zeros(
            (spec.ch - (sr + 1 + nsd), n_flat))], axis=0)
        rows = jnp.concatenate([cot_sr, cot_z[None], jnp.zeros(
            (spec.wch - sr - 1, n_flat))], axis=0).reshape(
                spec.wch, nz, ny, cplan.nxb, cplan.a_pad)[..., :cplan.a]
        rows = jnp.moveaxis(rows, 0, 2).reshape(nz, ny, spec.wch,
                                                cplan.nxb * cplan.a)
        cotw = JG.pack_block_windows(JG.pack_ghost_rows(rows, plan), plan,
                                     cplan.bx, cplan.wl, far_channels=0)
        return (ti_f, mask_f, e_flat, cot_sr, cot_z, cot_s, cotc, cotw)

    ti_f, mask_f, e_flat, cot_sr, cot_z, cot_s, cotc, cotw = middle(
        k1, typ_s, smask)
    k2 = {}
    for pav in (False, True):
        outf, pvals = JC.k2_call(centers, tiles, idx, cotc, cotw, cplan,
                                 spec, pav, True)
        dcand = JC.scatter_call(pvals, idx[:, :, :, :cplan.mn_a, :], cplan,
                                True)
        k2[pav] = tuple(np.asarray(v) for v in (outf, pvals, dcand))
        _assert_f64(dict(zip(("outf", "pvals", "dcand"), k2[pav])))

    tmodel = NepModel(**MODEL_KW)
    tparams = random_params(tmodel, seed=7, dtype=torch.float64,
                            device="cpu")
    tplan = TG.DenseGridPlan(*dataclasses.astuple(plan))
    tcplan = TC.CompactPlan(base=tplan, bx=cplan.bx, mn_r=cplan.mn_r,
                            mn_a=cplan.mn_a)
    np_ = {k: np.asarray(v) for k, v in dict(
        centers=centers, cand=cand, idx=idx, k1=k1, tiles=tiles,
        e_flat=e_flat, cot_sr=cot_sr, cot_z=cot_z, cot_s=cot_s, cotc=cotc,
        cotw=cotw, ti_f=ti_f, mask_f=mask_f).items()}
    _assert_f64(np_)
    return dict(np=np_, k2=k2, jmodel=jmodel, tmodel=tmodel,
                tparams=tparams, tcplan=tcplan,
                tspec=TC.CompactSpec.from_model(tmodel, tparams))


def test_k1_plain_matches_pallas(oracle):
    o = oracle["np"]
    out, tiles = TC.k1_plain(_t(o["centers"]), _t(o["cand"]),
                             _t(o["idx"], torch.int32), oracle["tcplan"],
                             oracle["tspec"])
    _close(out, o["k1"])
    _close(tiles, o["tiles"])


def test_k1_call_takes_plain_version_on_cpu(oracle):
    o = oracle["np"]
    args = (_t(o["centers"]), _t(o["cand"]), _t(o["idx"], torch.int32),
            oracle["tcplan"], oracle["tspec"])
    before = dict(cuda_build.launches)
    got = TC.k1_call(*args)
    ref = TC.k1_plain(*args)
    assert cuda_build.launches == before  # no kernel launched on the CPU
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_middle_and_vjp_match(oracle):
    o = oracle["np"]
    spec = oracle["tspec"]
    sr, nsd = spec.sr, spec.na1 * spec.nlm
    srad = _t(o["k1"][:sr]).requires_grad_(True)
    ez = _t(o["k1"][sr]).requires_grad_(True)
    sf = _t(o["k1"][sr + 1:sr + 1 + nsd]).requires_grad_(True)
    e = TC.middle_compact_flat(srad, ez, sf, _t(o["ti_f"], torch.int64),
                               _t(o["mask_f"]), oracle["tmodel"],
                               oracle["tparams"])
    g = torch.autograd.grad(e.sum(), (srad, ez, sf))
    _close(e, o["e_flat"])
    for got, name in zip(g, ("cot_sr", "cot_z", "cot_s")):
        _close(got, o[name])


@pytest.mark.parametrize("pav", [False, True], ids=["pch4", "pch12"])
def test_k2_plain_matches_pallas(oracle, pav):
    o = oracle["np"]
    outf, pvals = TC.k2_plain(_t(o["centers"]), _t(o["tiles"]),
                              _t(o["idx"], torch.int32), _t(o["cotc"]),
                              _t(o["cotw"]), oracle["tcplan"],
                              oracle["tspec"], pav)
    assert pvals.shape[3] == (12 if pav else 4)
    _close(outf, oracle["k2"][pav][0])
    _close(pvals, oracle["k2"][pav][1])


@pytest.mark.parametrize("pav", [False, True], ids=["pch4", "pch12"])
def test_scatter_plain_matches_pallas(oracle, pav):
    cp = oracle["tcplan"]
    idx = _t(oracle["np"]["idx"], torch.int32)
    got = TC.scatter_plain(_t(oracle["k2"][pav][1]),
                           idx[:, :, :, :cp.mn_a, :], cp)
    _close(got, oracle["k2"][pav][2])


def _random_dw(plan, bx, c, seed):
    nx, ny, nz = plan.grid
    wl = JG.round_up(9 * (bx + 2) * plan.cap, 128)
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nz, ny, c, nx // bx, wl))


def _xla_fold(dw, plan, bx):
    """The JAX package's XLA fold pair, jitted (one compile, not one per
    op), under the pinned state."""
    with jax_oracle_state():
        out = jax.jit(lambda d: JG.fold_ghost_grad_c(
            JG.fold_block_windows(d, plan, bx), plan))(dw)
    _assert_f64({"fold": out})
    return out


def test_fold_plain_matches_pallas():
    """Hand-made plan the Pallas fold accepts (cap 64, bx 2)."""
    plan = JG.DenseGridPlan(grid=(4, 3, 3), cap=64, rc=4.0, skin=1.0,
                            pbc=(True, True, True))
    dw = _random_dw(plan, 2, 4, 0)
    assert JF.fold_windows_eligible(plan, 2, dw.shape[4])
    tplan = TG.DenseGridPlan(*dataclasses.astuple(plan))
    got = TF.rows_to_slots(TF.fold_windows_to_rows_plain(_t(dw), tplan, 2))
    with jax_oracle_state():
        pallas = JF.fold_windows_to_slots(jnp.asarray(dw), plan, 2,
                                          interpret=True)
    _assert_f64({"pallas": pallas})
    xla = _xla_fold(jnp.asarray(dw), plan, 2)
    _close(got, pallas)
    _close(got, xla)


@pytest.mark.parametrize("bx,cap,grid,pbc", [
    (1, 40, (3, 4, 3), (True, True, True)),
    (3, 24, (3, 3, 4), (True, False, True)),
    (2, 48, (4, 3, 1), (True, True, False)),
])
def test_fold_plain_serves_every_plan(bx, cap, grid, pbc):
    """Plans the Pallas fold rejects (lane alignment) or that have free
    axes: the plain fold equals the JAX XLA fold pair."""
    plan = JG.DenseGridPlan(grid=grid, cap=cap, rc=4.0, skin=1.0, pbc=pbc)
    dw = _random_dw(plan, bx, 3, 1)
    tplan = TG.DenseGridPlan(*dataclasses.astuple(plan))
    got = TF.fold_windows_to_slots(_t(dw), tplan, bx)
    ref = _xla_fold(jnp.asarray(dw), plan, bx)
    _close(got, ref)


# The fold's launch: the PbTe 262k default rung (bx 2, cap 64), the
# jittered rung (cap 56), 1M PbTe, Si 32k (bx 8, cap 16) and 1M (bx 14,
# cap 8), the card test's plans, caps that are not multiples of 4 and the
# shapes it refuses (nx not whole x-blocks, a window narrower than 9
# groups).
@pytest.mark.parametrize("bx,cap,grid,c,wl", [
    (2, 64, (16, 22, 22), 4, 2304), (2, 56, (16, 22, 22), 4, 2048),
    (2, 64, (24, 34, 34), 4, 2304), (8, 16, (16, 21, 21), 4, 1536),
    (14, 8, (56, 67, 67), 4, 1152), (1, 40, (3, 4, 3), 5, 1152),
    (3, 24, (3, 3, 4), 5, 1152), (2, 6, (4, 3, 3), 3, 256),
    (1, 10, (2, 3, 2), 2, 270), (3, 8, (4, 3, 3), 2, 1152),
    (2, 16, (4, 3, 3), 2, 500)])
def test_fold_plan_covers_the_row_or_is_refused(bx, cap, grid, c, wl):
    plan = TG.DenseGridPlan(grid=grid, cap=cap, rc=4.0, skin=1.0,
                            pbc=(True, True, True))
    nx, ny, nz = grid
    if nx % bx or wl < 9 * (bx + 2) * cap:
        with pytest.raises(ValueError):
            TF.fold_plan(plan, bx, c, wl)
        return
    for aligned in (True, False):
        fp = TF.fold_plan(plan, bx, c, wl, aligned)
        vec = 4 if cap % 4 == 0 and wl % 4 == 0 and aligned else 1
        assert fp.vec == vec and fp.units * vec == nx * cap
        assert fp.threads % 32 == 0 and 32 <= fp.threads <= 128
        # one pass covers a row where it fits a block
        assert fp.threads >= min(fp.units, 128) > fp.threads - 32
        assert fp.blocks == nz * ny * c
        assert fp.entry == f"fold_rows_kernelILi{vec}E"
    if (bx, cap, grid) == (2, 64, (16, 22, 22)):
        # PbTe 262k: 1,936 rows of 256 float4 units, 128 threads a row
        fp = TF.fold_plan(plan, bx, c, wl)
        assert (fp.blocks, fp.units, fp.threads) == (1936, 256, 128)

