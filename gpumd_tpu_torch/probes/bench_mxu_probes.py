"""The tensor-core and gather envelope for the NEP pair math on the card.

Counterpart of scripts/bench_mxu_probes.py, which measured on the TPU how
the compact engine's pair math would run as matrix-unit products, at the
1M-atom tile geometry (nb 13,872 blocks, 128 atom lanes).  The probes:

  onehot_dot      out[b] = vals[b] (m x k) @ R (k x n), R a 0/1 column
                  mask: the scatter's one-hot dot in its current shape and
                  variants (k split in 4, 72 rows, k 3072, 88, 108 and 96
                  rows), on the tensor cores in TF32 (the MXU's
                  Precision.DEFAULT) or f32-exact in three TF32 passes
                  (Precision.HIGHEST)
  feature_matmul  per 8-slot chunk (ch x 8k) @ (8k x 128) with the table
                  [eye(ch, k)] x 8, summed over the chunks, in TF32
  pair_reduce     out[n nlm + m] = sum over chunks and 8 rows of g[n] y[m]
                  for 7 x 24 channels, with all accumulators live across the
                  chunks ("spill") or channel-outer ("tiled")
  bgather         out[i] = sum over q of src[i, idx[q]] over a block's
                  window (17 channels, 18 or 11 blocks of 128), the indices
                  and the window's touched sectors staged in shared memory

Each has a plain torch version beside it.  `main` times every probe at
nb = 13872 / scale blocks (the script's GPUMD_PROBE_SCALE, here `--scale`,
8 by default: the worst input is then 4.09 GB) and prints each of the
script's keys in ms scaled to the full 13,872 blocks (the work is linear in
nb), then the same as one JSON line.

Run on the card:  python -m gpumd_tpu_torch.probes.bench_mxu_probes
On the CPU:       ... --device cpu --scale 13872  (plain versions)
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
from dataclasses import dataclass

import torch

from gpumd_tpu_torch.engine import cuda_build
from gpumd_tpu_torch.engine.nep_compact import _SMEM_LIMIT
from gpumd_tpu_torch.probes import best_ms, device_name, probe_device

NB_FULL = 13872  # blocks at 1M atoms (grid 24x34x34, bx 2)
A = 128          # atom lanes a block
PRECISIONS = ("default", "highest")  # TF32 tensor cores, f32 FFMA
ORDERS = ("spill", "tiled")

# ---------------------------------------------------------------------------
# one-hot dot
# ---------------------------------------------------------------------------


def onehot_mask(k, n, dtype=torch.float32, device=None):
    """R (k, n): R[i, j] = 1 where (7919 j) mod n == j, for every row i."""
    j = torch.arange(n, device=device)
    return ((j * 7919) % n == j).to(dtype).expand(k, n)


def onehot_dot_plain(vals, n, ksplit=1):
    """vals (nb, m, k) @ R, k summed in `ksplit` parts; in f32 unless the
    caller has turned TF32 on."""
    k = vals.shape[2]
    r = onehot_mask(k, n, vals.dtype, vals.device)
    kc = k // ksplit
    out = None
    for i in range(ksplit):
        part = torch.matmul(vals[:, :, i * kc:(i + 1) * kc],
                            r[i * kc:(i + 1) * kc])
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# launch plans of the TF32 kernels (csrc/probes.cu): two consumer
# warpgroups, each issuing wgmma m64nNk8, fed by one producer warp through
# a ring of stages in shared memory; a persistent block an SM
# ---------------------------------------------------------------------------

# wgmma N instances of the one-hot dot and of the feature matmul
# (GK_ONEHOT_N, GK_FEATURE_N in probes.cu); a width takes the smallest not
# below it
ONEHOT_N = (16, 64, 128)
FEATURE_N = (32, 192, 256)
TILE_M = 128        # output rows (lanes) a unit: two warpgroups of m64
ONEHOT_KC = 32      # k columns a TMA box: 128 B of f32, the swizzle's width
ONEHOT_BOXES = 2    # TMA boxes a stage (kOhBoxes in probes.cu)
FEATURE_LD = 136    # floats a staged row of vals (128 lanes + 8)
MAX_STAGES = {"onehot": 4, "feature": 6}
ALIGN = 1024        # the 128-byte swizzle's atom; dynamic smem is padded to it
# The shared-memory layout below is the one onehot_smem / feature_smem in
# probes.cu compute at launch; a card test holds the two equal.


@dataclass(frozen=True)
class WgmmaPlan:
    """How a wgmma probe kernel runs a call (`kernel` "onehot", "onehot_f32"
    or "feature"): `mma` is the wgmma shape (M, N, K); a unit is a 128-row
    tile of the (nb m, k) matrix (one-hot) or one b (feature); each of
    `blocks` blocks walks units blockIdx.x, + blocks, ...; a stage holds
    `stage_k` k columns (one-hot: in TMA boxes of 32) or chunk rows
    (feature) of vals, `stage_bytes` bytes, `stages` of them in the ring;
    `smem` is the block's dynamic shared memory (the launcher computes the
    same from N, k and stages)."""

    kernel: str
    mma: tuple
    split: bool
    stage_k: int
    stage_bytes: int
    stages: int
    smem: int
    units: int
    blocks: int

    @property
    def warps(self) -> int:
        """Warps a block: two consumer warpgroups and a producer warp; the
        f32 path's thread 0 is its producer (kF32Threads)."""
        return 8 if self.kernel == "onehot_f32" else 9

    @property
    def entry(self) -> str:
        """The kernel instance's (mangled) name, as ptxas reports it."""
        n = self.mma[1]
        if self.kernel == "onehot":
            return f"probe_onehot_tf32_kernelILi{n}ELb{int(self.split)}E"
        if self.kernel == "onehot_f32":
            return f"probe_onehot_f32_kernelILi{n}E"
        return f"probe_feature_tf32_kernelILi{n}E"


def _mma_n(width, choices):
    return next(n for n in choices if n >= width)


def _ring(kind, fixed, stage_bytes):
    """Stages that fit beside `fixed` bytes (with two 8-byte mbarriers a
    stage), at most MAX_STAGES[kind]; raises below two."""
    stages = min(MAX_STAGES[kind],
                 (_SMEM_LIMIT - ALIGN - fixed) // (stage_bytes + 16))
    if stages < 2:
        raise ValueError(f"{kind}: a stage of {stage_bytes} B beside "
                         f"{fixed} B leaves no ring of two stages in "
                         f"{_SMEM_LIMIT} B of shared memory")
    return stages, ALIGN + fixed + stages * (stage_bytes + 16)


def _check_onehot(n, k, ksplit):
    """What both one-hot kernels take."""
    if n % 16 or not 0 < n <= 128 or ksplit < 1 or k % ksplit:
        raise ValueError(f"onehot_dot: n {n} must be a multiple of 16 up to "
                         f"128, and k {k} a multiple of ksplit {ksplit}")


def onehot_plan(nb, m, k, n, ksplit=1, sms=132) -> WgmmaPlan:
    """The TF32 one-hot dot's plan, or ValueError for a shape it does not
    take: n a multiple of 16 up to 128, k a multiple of ksplit and of 4 (the
    TMA row stride, 4k bytes, is a multiple of 16), and with ksplit > 1 the
    part k / ksplit a multiple of the stage's k columns (parts are whole
    stages)."""
    _check_onehot(n, k, ksplit)
    stage_k = ONEHOT_BOXES * ONEHOT_KC
    if k % 4 or (ksplit > 1 and (k // ksplit) % stage_k):
        raise ValueError(f"onehot_dot: TF32 needs k {k} a multiple of 4 and "
                         f"each of the {ksplit} parts a multiple of "
                         f"{stage_k}")
    return _onehot_ring("onehot", nb, m, n, ksplit, sms)


def onehot_f32_plan(nb, m, k, n, ksplit=1, sms=132) -> WgmmaPlan:
    """The f32 path's plan on the TF32 kernel's ring (three TF32 passes on
    the tensor cores), or ValueError for a shape it does not take: n a
    multiple of 16 up to 128, k a multiple of ksplit and of 4 (the TMA row
    stride).  Parts need not be whole stages: each starts a stage of its
    own."""
    _check_onehot(n, k, ksplit)
    if k % 4:
        raise ValueError(f"onehot_dot: the f32 ring needs k {k} a multiple "
                         f"of 4")
    return _onehot_ring("onehot_f32", nb, m, n, ksplit, sms)


def _onehot_ring(kernel, nb, m, n, ksplit, sms):
    """The one-hot kernels' ring: 128-row tiles of (nb m) rows, stages of
    two TMA boxes of 32 k columns, R^T (N x 32) beside them."""
    nn = _mma_n(n, ONEHOT_N)
    stage_k = ONEHOT_BOXES * ONEHOT_KC
    stage = TILE_M * stage_k * 4
    stages, smem = _ring("onehot", nn * ONEHOT_KC * 4, stage)
    units = -(-nb * m // TILE_M)
    return WgmmaPlan(kernel, (64, nn, 8), ksplit > 1, stage_k, stage,
                     stages, smem, units, max(1, min(units, sms)))


def onehot_f32_on_ring(k, base) -> bool:
    """Whether the f32 path runs on the ring (probe_onehot_f32_kernel) for
    k columns at base address `base`: k a multiple of 4 and a 16-byte
    aligned base, as TMA needs; else the FFMA kernel takes the call."""
    return k % 4 == 0 and base % 16 == 0


def tf32_split(a):
    """f32 a -> (hi, mid, lo), the f32 path's exact split into three TF32
    terms (tf32_split in probes.cu): hi is a with its low 13 mantissa bits
    cleared, mid the same of a - hi, lo = a - hi - mid; hi + mid + lo == a
    for every finite a, and each term is a TF32 value for |a| >= 2^-103
    (below, lo holds bits under TF32's smallest step)."""
    mask = torch.tensor(-8192, dtype=torch.int32)  # 0xFFFFE000
    hi = (a.view(torch.int32) & mask).view(torch.float32)
    r = a - hi
    mid = (r.view(torch.int32) & mask).view(torch.float32)
    return hi, mid, r - mid


def feature_plan(nb, mn, k, ch, lanes=A, sms=132) -> WgmmaPlan:
    """The feature matmul's plan, or ValueError: mn whole 8-slot chunks,
    lanes a multiple of 16 up to 128, k a multiple of 4 (big^T is laid in
    32-column blocks) and ch at most 256 (one wgmma N)."""
    if mn % 8 or lanes % 16 or not 0 < lanes <= 128:
        raise ValueError(f"feature_matmul: rows {mn * k} must be whole "
                         f"8-slot chunks of {8 * k}, lanes {lanes} a "
                         f"multiple of 16 up to 128")
    if k % 4 or not 0 < ch <= FEATURE_N[-1]:
        raise ValueError(f"feature_matmul: k {k} must be a multiple of 4 "
                         f"and ch {ch} at most {FEATURE_N[-1]}")
    nn = _mma_n(ch, FEATURE_N)
    stage = 8 * k * FEATURE_LD * 4
    stages, smem = _ring("feature", 8 * k * nn * 4, stage)
    return WgmmaPlan("feature", (64, nn, 8), False, 8 * k, stage, stages,
                     smem, nb, max(1, min(nb, sms)))


def wgmma_occupancy(plan: WgmmaPlan) -> tuple:
    """(shared memory, resident blocks an SM) of the plan's kernel
    instance, the shared memory as its launcher sizes it and the blocks
    from cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    feature = plan.kernel == "feature"
    which = {"onehot": 0, "feature": 1, "onehot_f32": 2}[plan.kernel]
    rc = cuda_build.library().probe_wgmma_occupancy(
        which, plan.mma[1], int(plan.split),
        plan.stage_k // 8 if feature else 0, plan.stages,
        ctypes.addressof(smem), ctypes.addressof(blocks))
    cuda_build.check(rc, "probe_wgmma_occupancy")
    return smem.value, blocks.value


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _aligned(t, name):
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel's 16-byte copies need a "
                         f"16-byte aligned base")


def _onehot_cuda(vals, n, ksplit, prec):
    nb, m, k = vals.shape
    cuda_build.require(vals, "vals", torch.float32)
    _check_onehot(n, k, ksplit)
    out = torch.empty((nb, m, n), dtype=vals.dtype, device=vals.device)
    lib = cuda_build.library()
    if prec == "default":
        plan = onehot_plan(nb, m, k, n, ksplit, _sms(vals.device))
        _aligned(vals, "vals")
        rc = lib.probe_onehot_tf32_launch(
            cuda_build.ptr(vals), cuda_build.ptr(out), nb * m, k, n, ksplit,
            plan.mma[1], plan.stages, plan.blocks, cuda_build.stream())
        cuda_build.check(rc, "probe_onehot_tf32_launch")
    elif onehot_f32_on_ring(k, vals.data_ptr()):
        plan = onehot_f32_plan(nb, m, k, n, ksplit, _sms(vals.device))
        rc = lib.probe_onehot_f32_launch(
            cuda_build.ptr(vals), cuda_build.ptr(out), nb, m, k, n, ksplit,
            plan.mma[1], plan.stages, plan.blocks, cuda_build.stream())
        cuda_build.check(rc, "probe_onehot_f32_launch")
    else:
        rc = lib.probe_onehot_ffma_launch(
            cuda_build.ptr(vals), cuda_build.ptr(out), nb, m, k, n, ksplit,
            cuda_build.stream())
        cuda_build.check(rc, "probe_onehot_ffma_launch")
    cuda_build.launches["probe_onehot_dot"] += 1
    return out


def onehot_dot(vals, n, ksplit=1, prec="default"):
    """vals (nb, m, k) f32 -> (nb, m, n).  prec "default": TF32 tensor
    cores, f32 accumulation; "highest": f32-exact products, on the tensor
    cores in three TF32 passes (k a multiple of 4, 16-byte aligned base) or
    in f32 FFMA (other k or bases)."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec {prec!r} not in {PRECISIONS}")
    if vals.is_cuda:
        return _onehot_cuda(vals, n, ksplit, prec)
    return onehot_dot_plain(vals, n, ksplit)


# ---------------------------------------------------------------------------
# feature matmul
# ---------------------------------------------------------------------------


def feature_table(ch, k, dtype=torch.float32, device=None):
    """The chunk table (ch, 8k): eye(ch, k) repeated 8 times along k."""
    return torch.eye(ch, k, dtype=dtype, device=device).repeat(1, 8)


def feature_matmul_plain(vals, ch, k=8):
    """einsum of the chunk table over the chunked view of vals."""
    nb, mk, a = vals.shape
    v = vals.reshape(nb, mk // (8 * k), 8 * k, a)
    big = feature_table(ch, k, vals.dtype, vals.device)
    return torch.einsum("cq,bjqa->bca", big, v)


def _feature_cuda(vals, ch, k):
    nb, mk, a = vals.shape
    cuda_build.require(vals, "vals", torch.float32)
    if mk % k:
        raise ValueError(f"feature_matmul: rows {mk} must be whole 8-slot "
                         f"chunks of {8 * k}")
    plan = feature_plan(nb, mk // k, k, ch, a, _sms(vals.device))
    _aligned(vals, "vals")
    out = torch.empty((nb, ch, a), dtype=vals.dtype, device=vals.device)
    lib = cuda_build.library()
    rc = lib.probe_feature_launch(cuda_build.ptr(vals), cuda_build.ptr(out),
                                  nb, mk // k, k, ch, a, plan.mma[1],
                                  plan.stages, plan.blocks,
                                  cuda_build.stream())
    cuda_build.check(rc, "probe_feature_launch")
    cuda_build.launches["probe_feature_matmul"] += 1
    return out


def feature_matmul(vals, ch, k=8):
    """vals (nb, mn*k, A) f32 -> (nb, ch, A), TF32 on the card."""
    if vals.is_cuda:
        return _feature_cuda(vals, ch, k)
    return feature_matmul_plain(vals, ch, k)


# ---------------------------------------------------------------------------
# pair reduce
# ---------------------------------------------------------------------------


# The tiled order's launch (csrc/probes.cu, probe_reduce_tiled_kernel): a
# block a (b, tile of lanes), thread (m, lane), the tile's g and y slab in
# shared memory in 8-row groups; the launcher sizes the same, and a card
# test holds the two equal.
REDUCE_TILE = 16                 # lanes a tile (kRtL)
REDUCE_GROUP = 9 * REDUCE_TILE   # floats an 8-row group in the slab (kRtGS)
SM_SMEM = 233472                 # shared memory an H100 SM gives its blocks
SM_THREADS = 2048
BLOCK_RESERVE = 1024             # shared memory the system keeps a block


@dataclass(frozen=True)
class ReducePlan:
    """How the tiled order runs a call: `units` blocks of `threads`, one a
    (b, tile of `tile` lanes), each with `smem` bytes of dynamic shared
    memory (the slab, 8-row groups `group` floats apart); `blocks_per_sm`
    fit an SM by shared memory and threads, so `units` take `waves` rounds
    of `sms` SMs."""

    tile: int
    threads: int
    group: int
    smem: int
    blocks_per_sm: int
    units: int
    waves: float


def reduce_plan(nb, chunks, lanes=A, sms=132) -> ReducePlan:
    """The tiled order's plan, or ValueError for a shape it does not take:
    lanes a multiple of 4 up to 1024 (a slab row is 16-byte pieces), chunks
    from 1 to as many as one tile's slab holds in shared memory (13)."""
    if lanes % 4 or not 0 < lanes <= 1024:
        raise ValueError(f"pair_reduce: the tiled order needs lanes {lanes} "
                         f"a multiple of 4 up to 1024")
    per_chunk = 4 * (7 + 24) * REDUCE_GROUP
    if not 0 < chunks <= _SMEM_LIMIT // per_chunk:
        raise ValueError(f"pair_reduce: the tiled order's slab of "
                         f"{chunks} chunks ({chunks * per_chunk} B) must "
                         f"fit {_SMEM_LIMIT} B of shared memory: 1 to "
                         f"{_SMEM_LIMIT // per_chunk} chunks")
    smem = chunks * per_chunk
    threads = 24 * REDUCE_TILE
    per_sm = min(SM_SMEM // (smem + BLOCK_RESERVE), SM_THREADS // threads)
    units = nb * -(-lanes // REDUCE_TILE)
    return ReducePlan(REDUCE_TILE, threads, REDUCE_GROUP, smem, per_sm,
                      units, units / (sms * per_sm))


def reduce_occupancy(nb, chunks, lanes=A) -> dict:
    """The tiled order's launch as its launcher sizes it (smem, threads,
    tile, units) and its resident blocks an SM there (blocks_per_sm, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    vals = [ctypes.c_int(0) for _ in range(5)]
    rc = cuda_build.library().probe_reduce_occupancy(
        nb, chunks, lanes, *(ctypes.addressof(v) for v in vals))
    cuda_build.check(rc, "probe_reduce_occupancy")
    return dict(zip(("smem", "threads", "tile", "units", "blocks_per_sm"),
                    (v.value for v in vals)))


def pair_reduce_plain(g, y, na=7, nlm=24):
    """The broadcast product summed over (chunk, row)."""
    nb, rows, a = g.shape
    chunks = rows // (8 * na)
    gv = g.reshape(nb, chunks, na, 1, 8, a)
    yv = y.reshape(nb, chunks, 1, nlm, 8, a)
    return (gv * yv).sum(dim=(1, 4)).reshape(nb, na * nlm, a)


def reduce_chunks(na, nlm, rows, lanes) -> int:
    """The chunks of a pair-reduce call on the card, or ValueError for a
    shape neither order takes: the kernels are built for na 7 and nlm 24,
    whole 8-row chunks and 1 to 1024 lanes (the spill order runs lane tiles
    of at most 256 threads, kSpillThreads, since its 168 accumulators take
    254 registers a thread)."""
    chunks = rows // (8 * na)
    if ((na, nlm) != (7, 24) or rows != 8 * na * chunks
            or not 0 < lanes <= 1024):
        raise ValueError("pair_reduce: the kernel is built for na 7, nlm 24, "
                         "whole 8-row chunks and 1 to 1024 lanes")
    return chunks


def _reduce_cuda(g, y, na, nlm, order):
    nb, rows, a = g.shape
    chunks = reduce_chunks(na, nlm, rows, a)
    cuda_build.require(g, "g", torch.float32)
    cuda_build.require(y, "y", torch.float32, (nb, 8 * nlm * chunks, a),
                       device=g.device)
    if order == "tiled":
        reduce_plan(nb, chunks, a)
        _aligned(g, "g")
        _aligned(y, "y")
    out = torch.empty((nb, na * nlm, a), dtype=g.dtype, device=g.device)
    lib = cuda_build.library()
    rc = lib.probe_reduce_launch(cuda_build.ptr(g), cuda_build.ptr(y),
                                 cuda_build.ptr(out), nb, na, nlm, chunks, a,
                                 int(order == "spill"), cuda_build.stream())
    cuda_build.check(rc, "probe_reduce_launch")
    cuda_build.launches["probe_pair_reduce"] += 1
    return out


def pair_reduce(g, y, na=7, nlm=24, order="spill"):
    """g (nb, 8 na chunks, A), y (nb, 8 nlm chunks, A) -> (nb, na nlm, A).
    order "spill": all channels' sums live across the chunks; "tiled":
    channel-outer from a shared-memory slab.  Both give the same bits."""
    if order not in ORDERS:
        raise ValueError(f"order {order!r} not in {ORDERS}")
    if g.is_cuda:
        return _reduce_cuda(g, y, na, nlm, order)
    return pair_reduce_plain(g, y, na, nlm)


# ---------------------------------------------------------------------------
# blocked gather
# ---------------------------------------------------------------------------


def bgather_plain(src, idx):
    """gather with the out-of-range terms masked, then the sum over q."""
    nb, nch, width = src.shape
    nq, a = idx.shape[1:]
    ok = (idx >= 0) & (idx < width)
    j = torch.where(ok, idx, 0).long().reshape(nb, 1, nq * a)
    got = torch.gather(src, 2, j.expand(nb, nch, nq * a))
    got = torch.where(ok.reshape(nb, 1, nq * a), got, 0.0)
    return got.reshape(nb, nch, nq, a).sum(dim=2)


# The blocked gather's launch (csrc/probes.cu, probe_bgather_kernel): a
# block a b, its indices and chunks of its window's touched sectors in
# shared memory, thread (lane quad, channel quad) in the sums.
BG_BLOCKS_PER_SM = 2   # the chunks are sized for this many blocks an SM
BG_MAX_THREADS = 512   # kBgMaxThreads


@dataclass(frozen=True)
class BgatherPlan:
    """How the blocked gather runs a call: `units` blocks (one a b) of
    `threads`, each summing `lv` lanes of a channel quad a thread;
    with `stage`, the b's indices and its window in `chunks` chunks of
    `chunk` columns in `smem` bytes of shared memory (the chunks sized for
    `bps` blocks an SM), else indices and terms read from device memory;
    `blocks_per_sm` fit an SM by shared memory and threads, so `units` take
    `waves` rounds of `sms` SMs."""

    lv: int
    stage: bool
    bps: int
    chunk: int
    chunks: int
    threads: int
    smem: int
    blocks_per_sm: int
    units: int
    waves: float


def _round4(x):
    return -(-x // 4) * 4


def bgather_smem(nq, lanes, nch, width, chunk) -> int:
    """The indices, a flag word a sector of 8 columns and a chunk of
    `chunk` columns x the channels rounded up to 4 (transposed)."""
    return 4 * (_round4(nq * lanes) + _round4(-(-width // 8))
                + chunk * _round4(nch))


@functools.lru_cache(maxsize=64)
def bgather_plan(nb, nch, nq, width, lanes=A, sms=132, bps=None,
                 lv=None) -> BgatherPlan:
    """The blocked gather's plan for width a multiple of 4: chunks of the
    window (multiples of 8 columns) as wide as fit beside the indices at
    `bps` (BG_BLOCKS_PER_SM) blocks an SM, or at fewer where none would,
    or no staging where not even 8 columns fit at one; 4 lanes a thread
    where lanes is a multiple of 4, else one.  `bps` and `lv` override the
    choice."""
    if width % 4 or width < 4:
        raise ValueError(f"bgather: width {width} must be a positive "
                         f"multiple of 4")
    lv = lv or (4 if lanes % 4 == 0 else 1)
    if lv not in (1, 4) or lanes % lv:
        raise ValueError(f"bgather: lv {lv} must be 1 or 4 and divide "
                         f"lanes {lanes}")
    fixed = bgather_smem(nq, lanes, nch, width, 0)
    for bps in range(bps or BG_BLOCKS_PER_SM, 0, -1):
        budget = min(_SMEM_LIMIT, SM_SMEM // bps - BLOCK_RESERVE)
        chunk = min(-(-width // 8) * 8,
                    (budget - fixed) // (4 * _round4(nch)) // 8 * 8)
        if chunk >= 8:
            break
    stage = chunk >= 8
    chunk = chunk if stage else 0
    smem = bgather_smem(nq, lanes, nch, width, chunk) if stage else 0
    units = (lanes // lv) * (_round4(nch) // 4)
    threads = min(BG_MAX_THREADS, max(128, -(-units // 32) * 32))
    per_sm = min(SM_SMEM // (smem + BLOCK_RESERVE), SM_THREADS // threads,
                 32)
    return BgatherPlan(lv, stage, bps, chunk,
                       -(-width // chunk) if stage else 0, threads, smem,
                       per_sm, nb, nb / (sms * per_sm))


def bgather_occupancy(plan: BgatherPlan) -> int:
    """Resident blocks an SM of the plan's kernel instance
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    rc = cuda_build.library().probe_bgather_occupancy(
        plan.lv, int(plan.stage), plan.threads, plan.smem,
        ctypes.addressof(blocks))
    cuda_build.check(rc, "probe_bgather_occupancy")
    return blocks.value


def _bgather_cuda(src, idx, plan=None):
    nb, nch, width = src.shape
    nq, a = idx.shape[1:]
    # the kernel reads all three in 16-byte pieces
    cuda_build.require(src, "src", torch.float32, align=16)
    cuda_build.require(idx, "idx", torch.int32, (nb, nq, a),
                       device=src.device, align=16)
    plan = plan or bgather_plan(nb, nch, nq, width, a)
    out = torch.empty((nb, nch, a), dtype=src.dtype, device=src.device)
    lib = cuda_build.library()
    rc = lib.probe_bgather_launch(
        cuda_build.ptr(src), cuda_build.ptr(idx), cuda_build.ptr(out), nb,
        nch, nq, width, a, plan.lv, int(plan.stage), plan.chunk,
        plan.threads, plan.smem, cuda_build.stream())
    cuda_build.check(rc, "probe_bgather_launch")
    cuda_build.launches["probe_bgather"] += 1
    return out


def bgather(src, idx, plan=None):
    """src (nb, nch, 128 nblk) f32, idx (nb, 8 chunks, A) int32 ->
    out[b, i, a] = sum over q of src[b, i, idx[b, q, a]], a term 0 where
    idx < 0 or idx >= 128 nblk.  On the card any width that is a multiple
    of 4 runs; `plan` (bgather_plan) overrides the launch's."""
    if src.is_cuda:
        return _bgather_cuda(src, idx, plan)
    return bgather_plain(src, idx)


# ---------------------------------------------------------------------------
# the script's probes
# ---------------------------------------------------------------------------

# key -> (probe, parameters), in the script's order
CASES = {
    "onehot_current_144x4096x128": ("onehot", dict(m=144, k=4096, n=128)),
    "onehot_ksplit4": ("onehot", dict(m=144, k=4096, n=128, ksplit=4)),
    "onehot_single_prec_72rows": ("onehot", dict(m=72, k=4096, n=128)),
    "onehot_mna24_144x3072x128": ("onehot", dict(m=144, k=3072, n=128)),
    "onehot_compact_88x3072x128": ("onehot", dict(m=88, k=3072, n=128)),
    # one M-tile vs two: the scatter's 144 rows are 108 useful plus padding
    "onehot_packed_108x4096x128": ("onehot", dict(m=108, k=4096, n=128)),
    "onehot_packed_96x3072x128": ("onehot", dict(m=96, k=3072, n=128)),
    "feature_matmul_mn32_k8_ch24": ("feature", dict(mn=32, k=8, ch=24)),
    "feature_matmul_mn32_k8_ch168": ("feature", dict(mn=32, k=8, ch=168)),
    "pair_reduce_spill": ("reduce", dict(order="spill")),
    "pair_reduce_tiled": ("reduce", dict(order="tiled")),
    "bgather_17ch_nblk18": ("bgather", dict(nch=17, chunks=14, nblk=18)),
    "bgather_17ch_nblk11": ("bgather", dict(nch=17, chunks=14, nblk=11)),
    "bgather_17ch_nblk11_mnr96": ("bgather", dict(nch=17, chunks=12,
                                                  nblk=11)),
}


def case_inputs(key, nb, device=None):
    """The script's inputs for a case: ones, and all-zero bgather indices."""
    dev = probe_device(device)
    kind, p = CASES[key]
    if kind == "onehot":
        return (torch.ones((nb, p["m"], p["k"]), device=dev),)
    if kind == "feature":
        return (torch.ones((nb, p["mn"] * p["k"], A), device=dev),)
    if kind == "reduce":
        return (torch.ones((nb, 4 * 8 * 7, A), device=dev),
                torch.ones((nb, 4 * 8 * 24, A), device=dev))
    return (torch.ones((nb, p["nch"], 128 * p["nblk"]), device=dev),
            torch.zeros((nb, 8 * p["chunks"], A), dtype=torch.int32,
                        device=dev))


def case_call(key):
    """The probe function of a case, as f(*case_inputs(key, ...))."""
    kind, p = CASES[key]
    if kind == "onehot":
        return lambda v: onehot_dot(v, p["n"], p.get("ksplit", 1))
    if kind == "feature":
        return lambda v: feature_matmul(v, p["ch"], p["k"])
    if kind == "reduce":
        return lambda g, y: pair_reduce(g, y, order=p["order"])
    return bgather


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=8,
                    help="probe at 13872 / scale blocks, report x scale")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = probe_device(args.device)
    nb = NB_FULL // args.scale
    print(f"device: {device_name(dev)}; nb {nb} blocks, times x "
          f"{args.scale}")
    res = {}
    for key in CASES:
        inputs = case_inputs(key, nb, dev)
        fn = case_call(key)
        res[key] = args.scale * best_ms(lambda: fn(*inputs), dev, 3)
        del inputs
    for key, ms in res.items():
        print(f"{key}: {ms:.1f} ms")
    print(json.dumps({k: round(v, 2) for k, v in res.items()}))
    return res


if __name__ == "__main__":
    main()
