"""The probe kernels' plain versions vs the probe scripts' Pallas kernels.

Each plain torch version in gpumd_tpu_torch/probes is held against the
kernel body of its script (scripts/bench_gather.py,
scripts/probe_transcendentals.py, scripts/bench_mxu_probes.py), run through
pl.pallas_call(..., interpret=True) with the script's BlockSpecs, on the
same inputs made from a numpy seed, at small shapes (nb 2, k 256, nblk 2-3).
Everything is f32.  Tolerances, relative to max|reference|: the gather
copies (exact); the blocked gather and the pair reduce add the same terms in
another order (1e-6); the one-hot dot and the feature matmul add up to 256
products in another order (1e-5).  Transcendentals: torch against XLA:CPU
within 1e-6 on the script's scale, |a - b| / max(|b|, 1e-3).

The scripts are loaded from their paths.  bench_mxu_probes.py points JAX's
compile cache at .jax_cache when it is imported; the import here runs with
jax.config.update made a no-op, so the worker keeps its own cache.
"""

import functools
import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.probes import ab_bgather as ABG
from gpumd_tpu_torch.probes import ab_onehot_f32 as AB
from gpumd_tpu_torch.probes import bench_gather as BG
from gpumd_tpu_torch.probes import bench_mxu_probes as MX
from gpumd_tpu_torch.probes import host_cost as HC
from gpumd_tpu_torch.probes import probe_transcendentals as PT
from torch_first_trig import warm_torch_transcendentals  # noqa: F401

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"probe_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script_mods():
    cache_dir = jax.config.jax_compilation_cache_dir
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *a, **k: calls.append(a[0]))
        mods = {n: _load(n) for n in ("bench_gather", "probe_transcendentals",
                                      "bench_mxu_probes")}
    assert jax.config.jax_compilation_cache_dir == cache_dir
    return mods, calls, cache_dir


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.astype(np.float64) - ref)
    worst = np.unravel_index(np.argmax(err), err.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert err[worst] <= rtol * scale, (
        f"max |got - ref| {err[worst]:.3e} at {worst} (got {got[worst]}, "
        f"ref {ref[worst]}) above {rtol} x max|ref| {scale:.3e}")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture
def scripts(script_mods):
    return script_mods[0]


def test_script_import_keeps_the_worker_cache(script_mods):
    mods, calls, cache_dir = script_mods
    assert "jax_compilation_cache_dir" in calls  # what was neutralised
    assert jax.config.jax_compilation_cache_dir == cache_dir
    assert mods["bench_mxu_probes"].NB_FULL == MX.NB_FULL


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------


def test_gather_plain_matches_pallas(scripts):
    """The script's body takes along axis 0 of its block.  With the
    script's (1, W, 128) blocks that axis has length 1 and the take fails
    to broadcast (its main catches the error and prints PALLAS FAILED);
    on squeezed (W, 128) blocks it is the gather of the script's XLA
    baseline, take_along_axis(table, idx, axis=1), which is what the port
    computes."""
    g, w, s = 2, 40, 16
    rng = _rng(0)
    table = rng.normal(size=(g, w, 128)).astype(np.float32)
    idx = rng.integers(0, w, (g, s, 128)).astype(np.int32)
    f = pl.pallas_call(
        scripts["bench_gather"].kern, grid=(g,),
        in_specs=[pl.BlockSpec((None, w, 128), lambda i: (i, 0, 0)),
                  pl.BlockSpec((None, s, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((None, s, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((g, s, 128), jnp.float32),
        interpret=True)
    ref = np.asarray(f(jnp.asarray(table), jnp.asarray(idx)))
    got = BG.gather_call(_t(table), _t(idx)).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.take_along_axis(table, idx, axis=1))


# ---------------------------------------------------------------------------
# transcendentals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,lo,hi", PT.RANGES, ids=[r[0] for r in
                                                       PT.RANGES])
def test_transcendentals_match_xla(scripts, name, lo, hi):
    xs = np.linspace(lo, hi, 8 * 1024, dtype=np.float32).reshape(8, -1)
    got = [v.numpy() for v in PT.run(_t(xs))]
    x = jnp.asarray(xs)
    xla = [np.asarray(jax.jit(f)(x)) for f in (jax.lax.rsqrt, jnp.cos,
                                              jnp.sin)]
    pallas = [np.asarray(v) for v in scripts["probe_transcendentals"].run(x)]
    for op, g, xv, pv in zip(PT.OPS, got, xla, pallas):
        assert float(np.max(PT.rel_error(g, xv.astype(np.float64)))) <= \
            1e-6, op
        assert float(np.max(PT.rel_error(g, pv.astype(np.float64)))) <= \
            1e-6, op


def test_transcendental_errors_are_small_on_cpu():
    res = PT.measure("cpu")
    assert set(res) == {f"{r[0]}.{op}" for r in PT.RANGES for op in PT.OPS}
    for key, v in res.items():
        assert set(v) == {"kernel_max_rel", "kernel_rms_rel",
                          "torch_max_rel"}
        assert np.isfinite(v["kernel_max_rel"]), key  # rsqrt(0) counts 0
        assert v["kernel_max_rel"] <= 1e-6, key


# ---------------------------------------------------------------------------
# one-hot dot and feature matmul
# ---------------------------------------------------------------------------


def _pallas_onehot(script, vals, n, ksplit):
    nb, m, k = vals.shape
    f = pl.pallas_call(
        functools.partial(script._dot_kernel, m, k, n, ksplit,
                          prec=jax.lax.Precision.DEFAULT),
        grid=(nb,),
        in_specs=[pl.BlockSpec((1, m, k), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, m, n), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nb, m, n), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(vals)))


@pytest.mark.parametrize("m,k,n,ksplit", [(72, 256, 128, 1),
                                          (88, 256, 128, 4),
                                          (108, 256, 128, 1),
                                          (144, 256, 96, 4)])
def test_onehot_plain_matches_pallas(scripts, m, k, n, ksplit):
    vals = _rng(1).normal(size=(2, m, k)).astype(np.float32)
    ref = _pallas_onehot(scripts["bench_mxu_probes"], vals, n, ksplit)
    _close(MX.onehot_dot_plain(_t(vals), n, ksplit), ref, 1e-5)
    # the column mask: columns 0 and 64 of 128 hold the row sums
    if n == 128:
        cols = np.flatnonzero(np.abs(ref).max(axis=(0, 1)) > 0)
        assert list(cols) == [0, 64]


def test_feature_plain_matches_pallas(scripts):
    script = scripts["bench_mxu_probes"]
    mn, k = 32, 8
    vals = _rng(2).normal(size=(2, mn * k, 128)).astype(np.float32)
    for ch in (24, 168):
        f = pl.pallas_call(
            functools.partial(script._feat_kernel, mn, k, ch), grid=(2,),
            in_specs=[pl.BlockSpec((1, mn * k, 128), lambda b: (b, 0, 0))],
            out_specs=pl.BlockSpec((1, ch, 128), lambda b: (b, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((2, ch, 128), jnp.float32),
            interpret=True)
        ref = np.asarray(f(jnp.asarray(vals)))
        _close(MX.feature_matmul_plain(_t(vals), ch, k), ref, 1e-5)


# ---------------------------------------------------------------------------
# launch plans of the TF32 kernels: every shape of the probes' path and of
# the card tests fits the card (232,448 B of shared memory a block, legal
# wgmma shapes, the TMA stride rule) or is refused by the wrapper's rule
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448
NB = MX.NB_FULL // 8
ONEHOT_SHAPES = sorted(
    {(NB, p["m"], p["k"], p["n"], p.get("ksplit", 1))
     for kind, p in MX.CASES.values() if kind == "onehot"}
    | {(3, 144, 4096, 128, 1), (3, 144, 4096, 128, 4), (3, 72, 4096, 128, 1),
       (3, 88, 3072, 128, 1), (3, 108, 4096, 128, 1), (3, 96, 3072, 128, 4),
       (1, 20, 100, 64, 1), (1, 20, 100, 16, 1), (3, 88, 3072, 16, 1),
       (7, 144, 3072, 128, 4), (7, 88, 256, 48, 1), (2, 40, 512, 96, 2),
       (300, 144, 256, 128, 1), (300, 96, 512, 128, 4), (3, 88, 3072, 16, 4),
       (1, 20, 256, 64, 2)}
    # refused: TMA stride, parts not whole stages, n, k % ksplit
    | {(2, 16, 98, 128, 1), (1, 16, 256, 128, 8), (1, 16, 64, 100, 1),
       (1, 16, 100, 128, 3)})
FEATURE_SHAPES = sorted(
    {(NB, p["mn"], p["k"], p["ch"], MX.A)
     for kind, p in MX.CASES.values() if kind == "feature"}
    | {(5, 32, 8, 24, 128), (5, 32, 8, 168, 128), (5, 32, 8, 200, 128),
       (1, 32, 8, 168, 128), (7, 32, 8, 200, 128), (300, 32, 8, 168, 128),
       (2, 8, 8, 64, 64)}
    # refused: ch past one wgmma N, k not whole 32-column blocks, lanes,
    # part chunks, a chunk too large for a ring of two stages
    | {(1, 32, 8, 300, 128), (1, 32, 2, 24, 128), (1, 32, 8, 24, 136),
       (1, 12, 8, 24, 128), (1, 8, 64, 24, 128)})


def _legal_mma(plan, width):
    m, n, k = plan.mma
    return m == 64 and k == 8 and n % 8 == 0 and width <= n <= 256


@pytest.mark.parametrize("nb,m,k,n,ksplit", ONEHOT_SHAPES)
def test_onehot_plan_fits_the_card_or_is_refused(nb, m, k, n, ksplit):
    stage_k = MX.ONEHOT_BOXES * MX.ONEHOT_KC
    takes = (n % 16 == 0 and 0 < n <= 128 and k % ksplit == 0
             and 4 * k % 16 == 0
             and (ksplit == 1 or (k // ksplit) % stage_k == 0))
    if not takes:
        with pytest.raises(ValueError):
            MX.onehot_plan(nb, m, k, n, ksplit)
        return
    plan = MX.onehot_plan(nb, m, k, n, ksplit)
    assert _legal_mma(plan, n) and plan.mma[1] in MX.ONEHOT_N
    assert plan.split == (ksplit > 1)
    assert plan.stage_bytes == MX.TILE_M * plan.stage_k * 4
    assert plan.stage_k % MX.ONEHOT_KC == 0
    assert 2 <= plan.stages <= MX.MAX_STAGES["onehot"]
    # ring, R^T (N rows of 128 B), two mbarriers a stage, alignment slack
    need = (plan.stages * (plan.stage_bytes + 16) + plan.mma[1] * 128
            + MX.ALIGN)
    assert need <= plan.smem <= SMEM_LIMIT
    assert plan.units * MX.TILE_M >= nb * m > (plan.units - 1) * MX.TILE_M
    assert plan.blocks == min(plan.units, 132)
    assert plan.entry == (f"probe_onehot_tf32_kernelILi{plan.mma[1]}ELb"
                          f"{int(ksplit > 1)}E")


@pytest.mark.parametrize("nb,m,k,n,ksplit", ONEHOT_SHAPES)
def test_onehot_f32_plan_fits_the_card_or_is_refused(nb, m, k, n, ksplit):
    """The f32 path's ring plan: the TF32 kernel's ring and shared memory,
    k-split parts of any width; it refuses k that is not a multiple of 4
    (no TMA row stride), which the FFMA kernel then takes."""
    takes = (n % 16 == 0 and 0 < n <= 128 and k % ksplit == 0
             and k % 4 == 0)
    on_ring = MX.onehot_f32_on_ring(k, 0)
    assert on_ring == (k % 4 == 0)
    assert not MX.onehot_f32_on_ring(k, 4)  # an unaligned base: FFMA
    if not takes:
        with pytest.raises(ValueError):
            MX.onehot_f32_plan(nb, m, k, n, ksplit)
        return
    plan = MX.onehot_f32_plan(nb, m, k, n, ksplit)
    assert _legal_mma(plan, n) and plan.mma[1] in MX.ONEHOT_N
    assert plan.kernel == "onehot_f32" and plan.split == (ksplit > 1)
    assert plan.stage_k == MX.ONEHOT_BOXES * MX.ONEHOT_KC
    assert plan.stage_bytes == MX.TILE_M * plan.stage_k * 4
    assert 2 <= plan.stages <= MX.MAX_STAGES["onehot"]
    need = (plan.stages * (plan.stage_bytes + 16) + plan.mma[1] * 128
            + MX.ALIGN)
    assert need <= plan.smem <= SMEM_LIMIT
    assert plan.units * MX.TILE_M >= nb * m > (plan.units - 1) * MX.TILE_M
    assert plan.blocks == min(plan.units, 132)
    assert plan.entry == f"probe_onehot_f32_kernelILi{plan.mma[1]}E"
    if (nb, m, k, n, ksplit) == (NB, 144, 4096, 128, 1):
        # the timed shape: the same ring as the TF32 kernel's
        tf32 = MX.onehot_plan(nb, m, k, n, ksplit)
        assert (plan.stages, plan.smem, plan.units) == (
            tf32.stages, tf32.smem, tf32.units)


def _tf32_exact(t):
    """Whether every element is a TF32 value: its low 13 mantissa bits 0."""
    return bool(((t.view(torch.int32) & 0x1FFF) == 0).all())


def test_tf32_split_is_exact():
    """hi + mid + lo == a bit for bit on random f32 across the whole
    exponent range (subnormals, zeros, both signs, the largest finite);
    every term is a TF32 value (at most 10 explicit mantissa bits) for
    |a| >= 2^-103, where all three terms are normal; below, hi and mid
    are, and lo keeps a's bits under 2^-136, TF32's smallest step, which
    no sum of TF32 values can hold."""
    rng = _rng(11)
    bits = rng.integers(0, 2 ** 32, size=200_000, dtype=np.uint64)
    a = bits.astype(np.uint32).view(np.float32)
    a = a[np.isfinite(a)]
    extra = np.array([0.0, -0.0, 1.0, -1.5, np.finfo(np.float32).max,
                      np.finfo(np.float32).tiny, 1e-45, -3e-39, 2.0 ** -103,
                      np.nextafter(np.float32(2.0 ** -103), np.float32(0))],
                     dtype=np.float32)
    sub = (rng.integers(1, 2 ** 23, size=5000).astype(np.uint32)
           .view(np.float32))
    normal = rng.normal(size=50_000).astype(np.float32)
    t = _t(np.concatenate([a, extra, sub, -sub, normal]))
    assert bool((t.abs() < 2.0 ** -126).sum() > 5000)  # subnormals in
    hi, mid, lo = MX.tf32_split(t)
    # the sum is exact in f64 and equals a, and so is the f32 sum
    assert torch.equal(hi.double() + mid.double() + lo.double(), t.double())
    assert torch.equal((hi + mid) + lo, t)
    big = t.abs() >= 2.0 ** -103
    assert _tf32_exact(hi) and _tf32_exact(mid)
    assert _tf32_exact(lo[big])
    # each term's magnitude: hi carries a's top bits, mid and lo the rest
    assert bool((hi.abs() <= t.abs()).all())
    assert bool((mid.abs() <= 2.0 ** -10 * t.abs() + 2.0 ** -149).all())


# The pair reduce's shape check, which decides whether either order
# launches: na 7, nlm 24, whole 8-row chunks, 1 to 1024 lanes (the spill
# order runs lane tiles of at most 256 threads, so it takes every width
# the tiled order takes, and widths the tiled order refuses: 98 lanes, 14
# chunks).
@pytest.mark.parametrize("na,nlm,rows,lanes", [
    (7, 24, 4 * 56, 128), (7, 24, 56, 1024), (7, 24, 3 * 56, 300),
    (7, 24, 14 * 56, 98), (7, 24, 4 * 56, 1), (7, 24, 4 * 56, 0),
    (7, 24, 4 * 56, 1025), (7, 24, 4 * 56 + 8, 128), (6, 12, 48, 128)])
def test_pair_reduce_shape_is_checked(na, nlm, rows, lanes):
    takes = ((na, nlm) == (7, 24) and rows % 56 == 0
             and 0 < lanes <= 1024)
    if not takes:
        with pytest.raises(ValueError, match="1 to 1024 lanes"):
            MX.reduce_chunks(na, nlm, rows, lanes)
        return
    assert MX.reduce_chunks(na, nlm, rows, lanes) == rows // 56


@pytest.mark.parametrize("nb,mn,k,ch,lanes", FEATURE_SHAPES)
def test_feature_plan_fits_the_card_or_is_refused(nb, mn, k, ch, lanes):
    stage = 8 * k * MX.FEATURE_LD * 4
    table = 8 * k * 4 * next((n for n in MX.FEATURE_N if n >= ch), 0)
    takes = (mn % 8 == 0 and lanes % 16 == 0 and 0 < lanes <= 128
             and k % 4 == 0 and 0 < ch <= 256
             and MX.ALIGN + table + 2 * (stage + 16) <= SMEM_LIMIT)
    if not takes:
        with pytest.raises(ValueError):
            MX.feature_plan(nb, mn, k, ch, lanes)
        return
    plan = MX.feature_plan(nb, mn, k, ch, lanes)
    assert _legal_mma(plan, ch) and plan.mma[1] in MX.FEATURE_N
    assert (plan.stage_k, plan.stage_bytes) == (8 * k, stage)
    assert 2 <= plan.stages <= MX.MAX_STAGES["feature"]
    # each staged row is one bulk copy: 16-byte sizes and offsets
    assert lanes * 4 % 16 == 0 and MX.FEATURE_LD * 4 % 16 == 0
    need = plan.stages * (stage + 16) + table + MX.ALIGN
    assert need <= plan.smem <= SMEM_LIMIT
    assert (plan.units, plan.blocks) == (nb, min(nb, 132))
    assert plan.entry == f"probe_feature_tf32_kernelILi{plan.mma[1]}E"


# The tiled pair reduce: the probes' timed shape, every card-test shape,
# and the shapes it refuses (a slab past shared memory at 14 chunks, no
# chunk, lanes that are not whole 16-byte pieces or past 1024).
REDUCE_SHAPES = sorted(
    {(NB, 4, MX.A), (9, 4, 128), (1, 4, 128), (9, 1, 128), (9, 2, 128),
     (1, 13, 128), (9, 4, 100), (3, 3, 36), (2, 4, 1024)}
    | {(1, 14, 128), (1, 0, 128), (2, 4, 98), (1, 4, 1028)})


@pytest.mark.parametrize("nb,chunks,lanes", REDUCE_SHAPES)
def test_reduce_plan_fits_the_card_or_is_refused(nb, chunks, lanes):
    slab = 4 * (7 + 24) * chunks * 9 * 16
    takes = (lanes % 4 == 0 and 0 < lanes <= 1024 and chunks > 0
             and slab <= SMEM_LIMIT)
    if not takes:
        with pytest.raises(ValueError):
            MX.reduce_plan(nb, chunks, lanes)
        return
    plan = MX.reduce_plan(nb, chunks, lanes)
    assert plan.smem == slab <= SMEM_LIMIT
    assert plan.threads == 24 * plan.tile <= 1024
    # 16-byte copies: a device row, a slab row and an 8-row group each
    # start on 16 bytes
    assert lanes * 4 % 16 == 0 and plan.tile * 4 % 16 == 0
    assert plan.group * 4 % 16 == 0
    # the y rows a warp reads (m and m + 1, one group apart) fall in the
    # two halves of the 32 banks
    assert plan.group % 32 == plan.tile == 16
    assert plan.units == nb * -(-lanes // plan.tile)
    assert plan.blocks_per_sm >= 1
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 233472
    assert plan.blocks_per_sm * plan.threads <= 2048
    if (nb, chunks, lanes) == (NB, 4, MX.A):
        # the timed shape: 71,424 B a block, 3 blocks an SM
        assert (plan.smem, plan.blocks_per_sm) == (71424, 3)
        assert plan.waves == pytest.approx(NB * 8 / (132 * 3))


# ---------------------------------------------------------------------------
# pair reduce and blocked gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", MX.ORDERS)
def test_pair_reduce_plain_matches_pallas(scripts, order):
    script = scripts["bench_mxu_probes"]
    body = {"spill": script._reduce_spill_kernel,
            "tiled": script._reduce_tiled_kernel}[order]
    na, nlm, chunks, nb = 7, 24, 2, 2  # the script has 4 chunks
    rng = _rng(3)
    g = rng.normal(size=(nb, chunks * 8 * na, 128)).astype(np.float32)
    y = rng.normal(size=(nb, chunks * 8 * nlm, 128)).astype(np.float32)
    f = pl.pallas_call(
        functools.partial(body, na, nlm, chunks), grid=(nb,),
        in_specs=[pl.BlockSpec((1, chunks * 8 * na, 128),
                               lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, chunks * 8 * nlm, 128),
                               lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, na * nlm, 128), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nb, na * nlm, 128), jnp.float32),
        interpret=True)
    ref = np.asarray(f(jnp.asarray(g), jnp.asarray(y)))
    _close(MX.pair_reduce(_t(g), _t(y), order=order), ref, 1e-6)


@pytest.mark.parametrize("nblk,chunks", [(2, 3), (3, 2)])
def test_bgather_plain_matches_pallas(scripts, nblk, chunks):
    script = scripts["bench_mxu_probes"]
    nch, nb, width = 17, 2, 128 * nblk
    rng = _rng(4 + nblk)
    src = rng.normal(size=(nb, nch, width)).astype(np.float32)
    # in range, negative, and at or past the window's end
    idx = rng.integers(-40, width + 40, (nb, 8 * chunks, 128)).astype(
        np.int32)
    assert (idx < 0).any() and (idx >= width).any()
    f = pl.pallas_call(
        functools.partial(script._bgather_kernel, nch, chunks, nblk),
        grid=(nb,),
        in_specs=[pl.BlockSpec((1, nch, width), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, 8 * chunks, 128), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, nch, 128), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nb, nch, 128), jnp.float32),
        interpret=True)
    ref = np.asarray(f(jnp.asarray(src), jnp.asarray(idx)))
    _close(MX.bgather(_t(src), _t(idx)), ref, 1e-6)


@pytest.mark.parametrize("nblk", [1, 11, 18, 27, 110, 200, 1000])
def test_bgather_plan_fits_the_card(nblk):
    # chunks of whole sectors that cover the window beside b's indices in
    # shared memory, at two blocks an SM where they fit, else one
    width, nq = 128 * nblk, 112
    plan = MX.bgather_plan(1734, 17, nq, width)
    assert plan.stage and plan.lv == 4 and plan.threads == 160
    assert plan.chunk % 8 == 0 and plan.chunk >= 8
    assert plan.chunks == -(-width // plan.chunk)
    assert plan.chunk < width or plan.chunks == 1
    assert plan.smem == MX.bgather_smem(nq, 128, 17, width, plan.chunk)
    assert plan.smem <= MX._SMEM_LIMIT
    assert plan.blocks_per_sm >= plan.bps == (1 if nblk == 1000 else 2)
    assert plan.units == 1734
    assert MX.bgather_plan(2, 17, nq, width, lanes=6).lv == 1
    with pytest.raises(ValueError, match="multiple of 4"):
        MX.bgather_plan(1734, 17, nq, width + 2)


def test_bgather_plan_reads_src_where_the_indices_fill_shared_memory():
    plan = MX.bgather_plan(3, 17, 120, 256, 512)
    assert not plan.stage and plan.smem == 0 and plan.chunks == 0
    assert MX.bgather_smem(120, 512, 17, 256, 0) > MX._SMEM_LIMIT


def test_bgather_sector_bytes_count_what_the_indices_touch():
    src = torch.zeros((2, 3, 64))
    idx = torch.tensor([[[0, 7], [8, -1]], [[63, 64], [63, 40]]],
                       dtype=torch.int32)
    # b 0: sectors 0 and 1; b 1: sectors 7 and 5 (64 is past the window)
    assert ABG.sector_bytes(src, idx) == (idx.numel() * 4 + 4 * 2 * 3 * 2
                                          + 32 * 3 * 4)


# ---------------------------------------------------------------------------
# the launch path: cuda_build's helpers and the host-time probe
# ---------------------------------------------------------------------------


def test_ptr_is_the_data_pointer():
    x = torch.zeros(5)
    assert cuda_build.ptr(x) == x.data_ptr()
    assert isinstance(cuda_build.ptr(x), int)
    assert cuda_build.ptr(x[2:]) == x.data_ptr() + 8


class _CudaLike:
    """What cuda_build.require reads of a tensor, as a card's tensor
    would give it."""

    is_cuda = True

    def __init__(self, dtype=torch.float32, contiguous=True, shape=(2, 3),
                 device="cuda:0", ptr=256):
        self.dtype, self.shape = dtype, torch.Size(shape)
        self.device, self._c, self._p = torch.device(device), contiguous, ptr

    def is_contiguous(self):
        return self._c

    def data_ptr(self):
        return self._p


@pytest.mark.parametrize("kw,match", [
    ({}, None), ({"dtype": torch.float64}, "dtype"),
    ({"contiguous": False}, "contiguous"), ({"shape": (3, 2)}, "shape"),
    ({"device": "cuda:1"}, "on cuda:1"), ({"ptr": 260}, "16-byte")])
def test_require_names_the_check_that_fails(kw, match):
    t = _CudaLike(**kw)

    def call():
        cuda_build.require(t, "t", torch.float32, (2, 3),
                           torch.device("cuda:0"), align=16)
    if match is None:
        call()
    else:
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        cuda_build.require(torch.zeros(3), "x", torch.float32)


def test_transcendental_wrapper_fills_three_outputs(monkeypatch):
    # the card wrapper's host side on a CPU tensor, the library replaced
    calls = []

    class Lib:
        def probe_trans_launch(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(cuda_build, "library", Lib)
    monkeypatch.setattr(cuda_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(cuda_build, "stream", lambda: 7)
    monkeypatch.setitem(cuda_build.launches, "probe_transcendentals", 0)
    x = torch.linspace(1, 2, 24).reshape(4, 6)
    outs = PT._run_cuda(x)
    assert len(outs) == 3 and all(o.shape == x.shape for o in outs)
    (args,) = calls
    ptrs = [o.data_ptr() for o in outs]
    assert args == (x.data_ptr(), *ptrs, x.numel(), 7)
    # three separate outputs: disjoint ranges of x's size
    assert all(b - a >= 4 * x.numel() for a, b in zip(sorted(ptrs),
                                                      sorted(ptrs)[1:]))
    assert cuda_build.launches["probe_transcendentals"] == 1


def test_host_cost_times_each_part_and_restores_the_path():
    lib = types.SimpleNamespace(launch=lambda *args: 0)
    cb = types.SimpleNamespace(
        library=lambda: lib, require=lambda t, *a, **k: None,
        ptr=lambda t: t.data_ptr(), stream=lambda: 0,
        check=lambda rc, name: None)
    saved = dict(vars(cb)), torch.empty_like

    def wrapper(x):
        cb.require(x, "x", torch.float32)
        out = torch.empty_like(x)
        rc = cb.library().launch(cb.ptr(x), cb.ptr(out), cb.stream())
        cb.check(rc, "launch")
        return out
    x = torch.zeros(8)
    res = HC.measure(lambda: wrapper(x), cb, 50, sync=lambda: None)
    assert set(res) == set(HC.PARTS) | {"whole", "rest"}
    assert res["whole"] > 0 and res["alloc"] > 0
    assert abs(res["whole"] - sum(res[p] for p in HC.PARTS)
               - res["rest"]) < 1e-9
    assert vars(cb) == saved[0] and torch.empty_like is saved[1]
    # the helpers as they were and as they are, in turns, then restored
    seen = []
    ab = HC.helpers_ab({"w": (lambda: seen.append(cb.ptr(x)),
                              lambda: seen.append(cb.ptr(x)))}, cb, 20,
                       sync=lambda: None)
    assert set(ab["w"]) == {"before", "now"} and ab["w"]["now"] > 0
    assert vars(cb) == saved[0]
    assert {type(v) for v in seen} == {int, type(HC._before_ptr(x))}


# ---------------------------------------------------------------------------
# wrappers and entry points on the CPU
# ---------------------------------------------------------------------------


def test_wrappers_take_plain_versions_on_cpu():
    rng = _rng(5)
    vals = _t(rng.normal(size=(2, 72, 64)).astype(np.float32))
    feats = _t(rng.normal(size=(2, 64, 128)).astype(np.float32))
    g = _t(rng.normal(size=(1, 56, 128)).astype(np.float32))
    y = _t(rng.normal(size=(1, 192, 128)).astype(np.float32))
    before = dict(cuda_build.launches)
    for prec in MX.PRECISIONS:
        assert torch.equal(MX.onehot_dot(vals, 128, 2, prec),
                           MX.onehot_dot_plain(vals, 128, 2))
    assert torch.equal(MX.feature_matmul(feats, 24),
                       MX.feature_matmul_plain(feats, 24))
    for order in MX.ORDERS:
        assert torch.equal(MX.pair_reduce(g, y, order=order),
                           MX.pair_reduce_plain(g, y))
    x = _t(np.linspace(1, 2, 64, dtype=np.float32))
    for a, b in zip(PT.run(x), PT.run_plain(x)):
        assert torch.equal(a, b)
    assert cuda_build.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="prec"):
        MX.onehot_dot(vals, 128, prec="fast")
    with pytest.raises(ValueError, match="order"):
        MX.pair_reduce(g, y, order="rows")


@pytest.mark.parametrize("module,argv,keys", [
    (PT, [], [f"{r[0]}.{op}" for r in PT.RANGES for op in PT.OPS]),
    (BG, ["--w", "64", "--s", "16", "--g", "2"],
     ["kernel", "take_along_dim", "flat_gather"]),
    (MX, ["--scale", str(MX.NB_FULL)], list(MX.CASES)),
], ids=["probe_transcendentals", "bench_gather", "bench_mxu_probes"])
def test_main_prints_the_script_keys_on_cpu(capsys, module, argv, keys):
    before = dict(cuda_build.launches)
    res = module.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert list(res) == keys
    assert out.startswith("device: cpu")
    assert all(np.isfinite(v) for v in (
        res.values() if module is not PT else
        [x for r in res.values() for x in r.values()]))
    if module is MX:
        assert len(keys) == 14
        assert set(json.loads(out.strip().splitlines()[-1])) == set(keys)
        for key in keys:
            assert f"{key}: " in out
    if module is BG:
        for label in ("kernel banded:", "torch take_along_dim:",
                      "torch flat gather:"):
            assert label in out and "G elem/s" in out
    if module is PT:
        assert set(json.loads(out[out.index("{"):])) == set(keys)
    assert cuda_build.launches == before


@pytest.mark.parametrize("call", [
    lambda: PT.main([]), lambda: BG.main(["--g", "1"]),
    lambda: MX.main(["--scale", str(MX.NB_FULL)]),
    lambda: PT.measure(), lambda: BG.make_inputs(64, 16, 1),
    lambda: MX.case_inputs("pair_reduce_spill", 1),
    lambda: AB.main(["a.so:f", "b.so:g"]), lambda: ABG.main([]),
    lambda: HC.main([]),
], ids=["transcendentals-main", "gather-main", "mxu-main",
        "transcendentals-measure", "gather-inputs", "mxu-inputs",
        "ab-onehot-f32-main", "ab-bgather-main", "host-cost-main"])
def test_entry_points_raise_without_a_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
