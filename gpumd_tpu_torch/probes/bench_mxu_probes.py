"""The tensor-core and gather envelope for the NEP pair math on the card.

Counterpart of scripts/bench_mxu_probes.py, which measured on the TPU how
the compact engine's pair math would run as matrix-unit products, at the
1M-atom tile geometry (nb 13,872 blocks, 128 atom lanes).  The probes:

  onehot_dot      out[b] = vals[b] (m x k) @ R (k x n), R a 0/1 column
                  mask: the scatter's one-hot dot in its current shape and
                  variants (k split in 4, 72 rows, k 3072, 88, 108 and 96
                  rows), on the tensor cores in TF32 (the MXU's
                  Precision.DEFAULT) or in f32 FFMA (Precision.HIGHEST)
  feature_matmul  per 8-slot chunk (ch x 8k) @ (8k x 128) with the table
                  [eye(ch, k)] x 8, summed over the chunks, in TF32
  pair_reduce     out[n nlm + m] = sum over chunks and 8 rows of g[n] y[m]
                  for 7 x 24 channels, with all accumulators live across the
                  chunks ("spill") or channel-outer ("tiled")
  bgather         out[i] = sum over q of src[i, idx[q]] from a block's
                  shared-memory window (17 channels, 18 or 11 blocks of 128)

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
import json

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


def _onehot_cuda(vals, n, ksplit, prec):
    nb, m, k = vals.shape
    cuda_build.require(vals, "vals", torch.float32)
    if n % 16 or not 0 < n <= 128 or ksplit < 1 or k % ksplit:
        raise ValueError(f"onehot_dot: n {n} must be a multiple of 16 up to "
                         f"128, and k {k} a multiple of ksplit {ksplit}")
    out = torch.empty((nb, m, n), dtype=vals.dtype, device=vals.device)
    lib = cuda_build.library()
    rc = lib.probe_onehot_launch(cuda_build.ptr(vals), cuda_build.ptr(out),
                                 nb, m, k, n, ksplit,
                                 int(prec == "default"), cuda_build.stream())
    cuda_build.check(rc, "probe_onehot_launch")
    cuda_build.launches["probe_onehot_dot"] += 1
    return out


def onehot_dot(vals, n, ksplit=1, prec="default"):
    """vals (nb, m, k) f32 -> (nb, m, n).  prec "default": TF32 tensor
    cores, f32 accumulation; "highest": f32 FFMA."""
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
    if mk % (8 * k) or a % 16 or a > 128:
        raise ValueError(f"feature_matmul: rows {mk} must be whole 8-slot "
                         f"chunks of {8 * k}, lanes {a} a multiple of 16 "
                         f"up to 128")
    out = torch.empty((nb, ch, a), dtype=vals.dtype, device=vals.device)
    lib = cuda_build.library()
    rc = lib.probe_feature_launch(cuda_build.ptr(vals), cuda_build.ptr(out),
                                  nb, mk // k, k, ch, a, cuda_build.stream())
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


def pair_reduce_plain(g, y, na=7, nlm=24):
    """The broadcast product summed over (chunk, row)."""
    nb, rows, a = g.shape
    chunks = rows // (8 * na)
    gv = g.reshape(nb, chunks, na, 1, 8, a)
    yv = y.reshape(nb, chunks, 1, nlm, 8, a)
    return (gv * yv).sum(dim=(1, 4)).reshape(nb, na * nlm, a)


def _reduce_cuda(g, y, na, nlm, order):
    nb, rows, a = g.shape
    chunks = rows // (8 * na)
    if (na, nlm) != (7, 24) or rows != 8 * na * chunks or a > 1024:
        raise ValueError("pair_reduce: the kernel is built for na 7, nlm 24, "
                         "whole 8-row chunks and at most 1024 lanes")
    cuda_build.require(g, "g", torch.float32)
    cuda_build.require(y, "y", torch.float32, (nb, 8 * nlm * chunks, a),
                       device=g.device)
    out = torch.empty((nb, na * nlm, a), dtype=g.dtype, device=g.device)
    lib = cuda_build.library()
    rc = lib.probe_reduce_launch(cuda_build.ptr(g), cuda_build.ptr(y),
                                 cuda_build.ptr(out), nb, na, nlm, chunks, a,
                                 int(order == "spill"), cuda_build.stream())
    cuda_build.check(rc, "probe_reduce_launch")
    cuda_build.launches["probe_pair_reduce"] += 1
    return out


def pair_reduce(g, y, na=7, nlm=24, order="spill"):
    """g (nb, 8 na chunks, A), y (nb, 8 nlm chunks, A) -> (nb, na nlm, A)."""
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


def _bgather_cuda(src, idx):
    nb, nch, width = src.shape
    nq, a = idx.shape[1:]
    cuda_build.require(src, "src", torch.float32)
    cuda_build.require(idx, "idx", torch.int32, (nb, nq, a),
                       device=src.device)
    smem = 4 * nch * width
    if width % 4 or a > 512 or smem > _SMEM_LIMIT:
        raise ValueError(f"bgather: width {width} must be a multiple of 4, "
                         f"lanes {a} at most 512, and the window "
                         f"{smem} B at most {_SMEM_LIMIT} B of shared memory")
    out = torch.empty((nb, nch, a), dtype=src.dtype, device=src.device)
    lib = cuda_build.library()
    rc = lib.probe_bgather_launch(cuda_build.ptr(src), cuda_build.ptr(idx),
                                  cuda_build.ptr(out), nb, nch, nq, width, a,
                                  cuda_build.stream())
    cuda_build.check(rc, "probe_bgather_launch")
    cuda_build.launches["probe_bgather"] += 1
    return out


def bgather(src, idx):
    """src (nb, nch, 128 nblk) f32, idx (nb, 8 chunks, A) int32 ->
    out[b, i, a] = sum over q of src[b, i, idx[b, q, a]], a term 0 where
    idx < 0 or idx >= 128 nblk."""
    if src.is_cuda:
        return _bgather_cuda(src, idx)
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
