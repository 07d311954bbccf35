"""The port's compact-candidate-list rung vs the JAX package, f64 on the CPU.

Two PbTe systems read the trained NEP4 Te/Pb model in
artifacts/trainer_parity_r5_nep.txt (cutoffs 8/4 A):

  windows  1,000 atoms (5^3 cells, jitter 0.15 A, skin 1.0): grid (3,3,3),
           cap 64, bx 1, cl 896; rows_compact_eligible rejects it, so the
           kept lanes are gathered from packed windows;
  rows     1,728 atoms (6^3 cells, jitter 0.1 A, skin 1.0, plan_grid with
           cap 64): grid (4,4,4), bx 2, cl 896; gathered from ghost rows.

The planner is also held to the JAX package's on the 32,768-atom plans of
chip_smoke.py and on the 300-atom system of tests/test_nep_compact.py.
For each system the JAX rebuild runs once, jitted, with its Pallas
compaction kernels in interpret mode: compact_select, the compaction,
mask_compact_pads and build_indices_compact.  Each port function gets the
JAX stage's own numpy inputs.  Selection, compaction and index building
are integer or copy operations, so they must agree exactly; the scatter
sums the same terms in another order (rtol 1e-9, atol 1e-12); the force
pass is held to the JAX list path at the tolerances of
tests/test_nep_compact.py.  The JAX rebuild and scatter run with x64 on
and matmul precision "highest", pinned and restored (`jax_oracle_state`).
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumd_tpu.engine import grid as JG
from gpumd_tpu.engine import nep_compact as JC
from gpumd_tpu.forcefield import ForceField
from gpumd_tpu.model.box import Box as JBox
from gpumd_tpu.model.state import make_state as jmake_state
from gpumd_tpu.potentials.nep.model import NEP as JNEP
from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine import grid as TG
from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.engine.dense_md import DenseNEPMD
from gpumd_tpu_torch.model.box import Box
from gpumd_tpu_torch.potentials.nep.model import NEP
from torch_first_trig import warm_torch_transcendentals  # noqa: F401


ROOT = Path(__file__).resolve().parent.parent
MODEL = str(ROOT / "artifacts" / "trainer_parity_r5_nep.txt")
RC, RC_A = 8.0, 4.0
SYSTEMS = {"windows": (5, 0.15, None), "rows": (6, 0.1, 64)}


def _pbte(nc, jitter, seed=0, a0=6.57):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                     [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + base[None]).reshape(-1, 3) * a0
    pos = pos + np.random.default_rng(seed).normal(0, jitter, pos.shape)
    types = np.tile([1, 1, 1, 1, 0, 0, 0, 0], len(cells))
    return pos, types, np.full(3, nc * a0)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _plans(name, jbox, box, pos):
    nc, _, cap = SYSTEMS[name]
    n = len(pos)
    if cap is None:
        jp = JC.plan_grid_compact(jbox, RC, 1.0, n, position=pos)
        tp = TC.plan_grid_compact(box, RC, 1.0, n, position=pos)
    else:
        jp = JG.plan_grid(jbox, RC, 1.0, n, position=pos, cap=cap)
        tp = TG.plan_grid(box, RC, 1.0, n, position=pos, cap=cap)
    jc = JC.make_compact_plan(jp, position=pos, box=jbox, rc_angular=RC_A,
                              compact_lists=True)
    tc = TC.make_compact_plan(tp, position=pos, box=box, rc_angular=RC_A)
    return jc, tc


def _oracle(name):
    nc, jitter, _ = SYSTEMS[name]
    pos, types, lengths = _pbte(nc, jitter)
    n = len(pos)
    jbox = JBox.orthogonal(lengths)
    box = Box.orthogonal(lengths, device="cpu")
    pos = np.array(jbox.wrap(jnp.asarray(pos)))
    jc, tc = _plans(name, jbox, box, pos)
    plan = jc.base
    rows = JC.rows_compact_eligible(jc)
    assert rows == (name == "rows") and jc.cl > 0
    rng = np.random.default_rng(1)
    cot = rng.normal(size=(plan.grid[2], plan.grid[1], 8,
                           plan.grid[0] * plan.cap))

    # eager JAX compiles every op on its own; one jit per stage is faster
    @jax.jit
    def rebuild(pos, types, cot):
        perm, smask, _ = JG.bin_dense(pos, jbox, jnp.ones(n), plan)
        pos_s = JG.apply_perm(pos, perm, fill=1e5)
        typ_s = JG.apply_perm(types, perm, fill=0)
        garr = JG.pack_ghost(pos_s, typ_s, smask, jbox, plan)
        centers = JC.block_centers(garr, jc)
        cand = JG.pack_block_windows(garr, plan, jc.bx, jc.wl)
        cidx, cnt, ok_cl = JC.compact_select(cand, jbox, jc)
        cot_g = JG.pack_ghost_rows(cot, plan)
        cot_w = JG.pack_block_windows(cot_g, plan, jc.bx, jc.wl,
                                      far_channels=0)
        out = dict(perm=perm, smask=smask, pos_s=pos_s, typ_s=typ_s,
                   garr=garr, centers=centers, cand=cand, cidx=cidx,
                   cnt=cnt, ok_cl=ok_cl, cot_g=cot_g, cot_w=cot_w,
                   win_c=JC.compact_windows_call(cand, cidx, jc, True),
                   cot_win_c=JC.compact_windows_call(cot_w, cidx, jc, True))
        if rows:
            out["rows_c"] = JC.compact_rows_call(garr, cidx, jc, True)
            out["cot_rows_c"] = JC.compact_rows_call(cot_g, cidx, jc, True)
        cand_c = JC.mask_compact_pads(out["win_c"], cnt)
        idx, ok = JC.build_indices_compact(centers, cand_c, jc, RC_A)
        out.update(cand_c=cand_c, idx=idx, ok=ok)
        return out

    o = {k: np.asarray(v) for k, v in rebuild(
        jnp.asarray(pos), jnp.asarray(types, jnp.int32), jnp.asarray(cot)
    ).items()}
    assert bool(o["ok"]) and bool(o["ok_cl"])
    return dict(np=o, jc=jc, tc=tc, jbox=jbox, box=box, pos=pos,
                types=types, lengths=lengths)


@contextlib.contextmanager
def jax_oracle_state():
    """x64 on and full-precision matmuls for the JAX reference, whatever
    the process-wide settings (test files that ran earlier on the same
    worker may leave others: gpumd_tpu/app/nep.py sets the matmul
    precision to "high"); both restored on exit."""
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module", params=list(SYSTEMS))
def oracle(request):
    with jax_oracle_state():
        out = _oracle(request.param)
    for k, v in out["np"].items():
        if np.issubdtype(v.dtype, np.floating):
            assert v.dtype == np.float64, (k, v.dtype)
    return out


def test_make_compact_plan_matches(oracle):
    jc, tc = oracle["jc"], oracle["tc"]
    assert (tc.bx, tc.mn_r, tc.mn_a, tc.wl, tc.a_pad, tc.cl) == (
        jc.bx, jc.mn_r, jc.mn_a, jc.wl, jc.a_pad, jc.cl)
    assert tc.cl > 0 and tc.src_lanes == tc.cl
    assert TC.rows_compact_eligible(tc) == JC.rows_compact_eligible(jc)


def test_make_compact_plan_matches_random_system():
    """The 300-atom random two-species system of tests/test_nep_compact.py
    (test_compact_candidate_lists_match), skin 0.5."""
    rng = np.random.default_rng(17)
    n, lengths = 300, [27.5, 28.5, 30.0]
    nx = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(nx)] * 3, indexing="ij"), -1)
    pos = grid.reshape(-1, 3)[:n] * 3.3 + rng.uniform(-0.35, 0.35, (n, 3))
    pos = pos * (np.asarray(lengths) / (nx * 3.3))
    jbox = JBox.orthogonal(lengths)
    box = Box.orthogonal(lengths, device="cpu")
    pos = np.array(jbox.wrap(jnp.asarray(pos)))
    jp = JG.plan_grid(jbox, RC, 0.5, n, position=pos)
    tp = TG.plan_grid(box, RC, 0.5, n, position=pos)
    jc = JC.make_compact_plan(jp, position=pos, box=jbox, rc_angular=RC_A,
                              compact_lists=True)
    tc = TC.make_compact_plan(tp, position=pos, box=box, rc_angular=RC_A)
    assert (tc.bx, tc.mn_r, tc.mn_a, tc.wl, tc.a_pad, tc.cl) == (
        jc.bx, jc.mn_r, jc.mn_a, jc.wl, jc.a_pad, jc.cl)


@pytest.mark.parametrize("jitter,expect", [
    (0.1, ((8, 11, 11), 56, 2, 136, 32, 2048, 1280, False)),
    (0.0, ((8, 11, 11), 64, 2, 112, 32, 2304, 1280, True)),
], ids=["jittered", "lattice"])
def test_make_compact_plan_matches_at_32k(jitter, expect):
    """The 32,768-atom plans chip_smoke.py runs (skin 1.5): planning is
    host-side, so both packages plan them here."""
    lattice, types, lengths = _pbte(16, 0.0)
    pos = lattice + np.random.default_rng(3).normal(0, jitter, lattice.shape)
    jbox = JBox.orthogonal(lengths)
    box = Box.orthogonal(lengths, device="cpu")
    pos = np.array(jbox.wrap(jnp.asarray(pos)))
    got = []
    for mod, b in ((JC, jbox), (TC, box)):
        p = mod.plan_grid_compact(b, RC, 1.5, len(pos), position=pos)
        c = mod.make_compact_plan(p, position=pos, box=b, rc_angular=RC_A,
                                  compact_lists=True)
        got.append((p.grid, p.cap, c.bx, c.mn_r, c.mn_a, c.wl, c.cl,
                    mod.rows_compact_eligible(c)))
    assert got[0] == got[1] == expect


def test_compact_select_matches(oracle):
    o = oracle["np"]
    cidx, cnt, ok = TC.compact_select(_t(o["cand"]), oracle["box"],
                                      oracle["tc"])
    assert cidx.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(_np(cidx), o["cidx"])
    np.testing.assert_array_equal(_np(cnt), o["cnt"])
    assert bool(ok) == bool(o["ok_cl"])


@pytest.mark.parametrize("what", ["positions", "cot_rows"])
def test_compact_windows_plain_matches_pallas(oracle, what):
    o, tc = oracle["np"], oracle["tc"]
    src, ref = (("cand", "win_c") if what == "positions"
                else ("cot_w", "cot_win_c"))
    cidx = _t(o["cidx"], torch.int32)
    before = dict(cuda_build.launches)
    got = TC.compact_windows_call(_t(o[src]), cidx, tc)
    assert cuda_build.launches == before  # no kernel launched on the CPU
    np.testing.assert_array_equal(_np(got), o[ref])
    np.testing.assert_array_equal(
        _np(TC.compact_windows_plain(_t(o[src]), cidx, tc)), o[ref])


@pytest.mark.parametrize("what", ["positions", "cot_rows"])
def test_compact_rows_plain_matches_pallas(oracle, what):
    o, tc = oracle["np"], oracle["tc"]
    cidx = _t(o["cidx"], torch.int32)
    src = "garr" if what == "positions" else "cot_g"
    if not TC.rows_compact_eligible(tc):
        with pytest.raises(ValueError, match="rows_compact_eligible"):
            TC.compact_rows_call(_t(o[src]), cidx, tc)
        return
    got = TC.compact_rows_call(_t(o[src]), cidx, tc)
    ref = o["rows_c" if what == "positions" else "cot_rows_c"]
    np.testing.assert_array_equal(_np(got), ref)
    # rows and windows give the same compact source bit for bit
    win = o["win_c" if what == "positions" else "cot_win_c"]
    np.testing.assert_array_equal(_np(got), win)


def test_mask_and_build_indices_compact_match(oracle):
    o, tc = oracle["np"], oracle["tc"]
    cand_c = TC.mask_compact_pads(_t(o["win_c"]), _t(o["cnt"], torch.int32))
    np.testing.assert_array_equal(_np(cand_c), o["cand_c"])
    idx, ok = TC.build_indices_compact(_t(o["centers"]), cand_c, tc, RC_A)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(_np(idx), o["idx"])
    assert bool(ok) == bool(o["ok"])


def test_build_compact_neighbors_end_to_end(oracle):
    """The port's own chain from numpy positions: binning, ghost packing
    and the whole rebuild give the JAX package's products."""
    o, tc, box = oracle["np"], oracle["tc"], oracle["box"]
    n = len(oracle["pos"])
    pos = torch.as_tensor(oracle["pos"])
    perm, smask, _ = TG.bin_dense(pos, box, torch.ones(n, dtype=pos.dtype),
                                  tc.base)
    np.testing.assert_array_equal(_np(perm), o["perm"])
    garr = TG.pack_ghost(
        TG.apply_perm(pos, perm, fill=1e5),
        TG.apply_perm(torch.as_tensor(oracle["types"], dtype=torch.int32),
                      perm, 0), smask, box, tc.base)
    neigh, ok = TC.build_compact_neighbors(garr, box, tc, RC_A)
    assert isinstance(neigh, TC.CompactNeighbors) and bool(ok)
    for f in ("idx", "cidx", "cnt"):
        np.testing.assert_array_equal(_np(getattr(neigh, f)), o[f],
                                      err_msg=f)


@pytest.mark.parametrize("pav", [False, True], ids=["pch4", "pch12"])
def test_scatter_cidx_matches_pallas(oracle, pav):
    """Random pair cotangents on the JAX idx (compact lanes, parked entries
    included) through JAX scatter_call(cidx=...) in interpret mode."""
    o, jc, tc = oracle["np"], oracle["jc"], oracle["tc"]
    pch = 12 if pav else 4
    idx_a = o["idx"][:, :, :, :jc.mn_a, :]
    pvals = np.random.default_rng(2).normal(
        size=idx_a.shape[:3] + (pch,) + idx_a.shape[3:])
    with jax_oracle_state():
        ref = jax.jit(lambda p, i, c: JC.scatter_call(p, i, jc, True,
                                                      cidx=c))(
            jnp.asarray(pvals), jnp.asarray(idx_a), jnp.asarray(o["cidx"]))
    assert ref.dtype == jnp.float64
    got = TC.scatter_call(_t(pvals), _t(idx_a, torch.int32), tc,
                          _t(o["cidx"], torch.int32))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-9,
                               atol=1e-12)
    with pytest.raises(ValueError, match="cidx"):
        TC.scatter_call(_t(pvals), _t(idx_a, torch.int32), tc)


def test_overflow_when_cl_too_small(oracle):
    """cl at the largest count leaves no dead parking lane: both packages
    flag the rebuild."""
    o = oracle["np"]
    cl = int(o["cnt"].max())
    jc = oracle["jc"]._replace(cl=cl)
    tc = oracle["tc"]._replace(cl=cl)
    _, _, jok = jax.jit(lambda c: JC.compact_select(c, oracle["jbox"], jc))(
        jnp.asarray(o["cand"]))
    _, _, tok = TC.compact_select(_t(o["cand"]), oracle["box"], tc)
    assert not bool(jok) and not bool(tok)


@pytest.fixture(scope="module")
def force_pass(oracle):
    """The JAX list path (ForceField) and the port's compact-list force pass
    with per-atom virials off and on, on one system."""
    pos, types, lengths = oracle["pos"], oracle["types"], oracle["lengths"]
    n = len(pos)
    jnep = JNEP.from_file(MODEL, dtype=jnp.float64)
    ff = ForceField.create([jnep], oracle["jbox"], n, mn=128)
    ref = ff.compute(jmake_state(pos, np.ones(n), types, oracle["jbox"]))

    box, tc = oracle["box"], oracle["tc"]
    nep = NEP.from_file(MODEL, dtype=torch.float64, device="cpu")
    p = torch.as_tensor(pos)
    perm, smask, ov = TG.bin_dense(p, box, torch.ones(n, dtype=p.dtype),
                                   tc.base)
    assert not bool(ov)
    pos_s = TG.apply_perm(p, perm, fill=1e5)
    typ_s = TG.apply_perm(torch.as_tensor(types, dtype=torch.int32), perm, 0)
    garr = TG.pack_ghost(pos_s, typ_s, smask, box, tc.base)
    neigh, ok = TC.build_compact_neighbors(garr, box, tc,
                                           nep.model.rc_angular_max)
    assert bool(ok)
    inv = np.full(n, -1)
    pa = _np(perm)
    inv[pa[pa < n]] = np.nonzero(pa < n)[0]
    outs = {pav: TC.compact_nep_compute(pos_s, typ_s, smask, box, tc, neigh,
                                        nep.model, nep.params,
                                        per_atom_virial=pav)
            for pav in (False, True)}
    return ref, outs, inv


@pytest.mark.parametrize("pav", [False, True], ids=["total", "per_atom"])
def test_force_pass_matches_list_path(force_pass, pav):
    ref, outs, inv = force_pass
    out = outs[pav]
    np.testing.assert_allclose(_np(out.energy)[inv],
                               np.asarray(ref.potential_energy),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_np(out.force)[inv], np.asarray(ref.force),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(_np(out.virial_total),
                               np.asarray(ref.virial).sum(axis=0),
                               rtol=1e-8, atol=1e-8)
    if pav:
        np.testing.assert_allclose(_np(out.virial_atom)[inv],
                                   np.asarray(ref.virial), rtol=1e-8,
                                   atol=1e-9)
    else:
        assert out.virial_atom is None


def test_dense_md_defaults_to_compact_lists(oracle):
    nep = NEP.from_file(MODEL, dtype=torch.float64, device="cpu")
    cap = SYSTEMS["rows"][2] if TC.rows_compact_eligible(oracle["tc"]) \
        else None
    md = DenseNEPMD(nep, oracle["box"], len(oracle["pos"]),
                    position=oracle["pos"], skin=1.0, cap=cap)
    assert md.cplan.cl == oracle["tc"].cl > 0
    assert md.cplan == oracle["tc"]


def test_entry_points_default_to_the_card():
    """Without device=, the entry points put their tensors on the card;
    on a machine without one they raise instead of falling back."""
    calls = [lambda: Box.orthogonal([20.0, 20.0, 20.0]).h,
             lambda: NEP.from_file(MODEL).params.w0]
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
