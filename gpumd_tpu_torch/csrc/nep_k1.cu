// K1: NEP descriptor sums on the compact engine's neighbour tiles.
//
// Replaces the TPU kernel gpumd_tpu/engine/nep_compact.py:_k1_kernel
// (called through k1_call).  Per centre, over its mn_r window-relative
// neighbours: Chebyshev radial sums S[t_j, k], the ZBL pair energy, and on
// the mn_a angular prefix s_{n,lm} = sum_j g_n(r_ij) Y_lm(u_ij).  Outputs
// the flat (ch, NB*a_pad) sums and the displacement/type tiles
// (NB, 4, mn_r, a_pad) that K2 reads back.
//
// What bounds it on the H100: bytes (the tiles written, idx read, the
// output rows: ~0.47 ms at PbTe 262k); the live pairs' arithmetic is a
// fraction of that.  Between a kernel and that bound stand a lane's ~180
// sums (in shared memory, 114 KB a block: one 4-warp block an SM, and a
// read-modify-write of 7 x 24 of them per angular slot), the empty lanes
// (about half), the angular slots outside rc_a (12 of a PbTe centre's
// 18) and the latency of dependent loads.  Design:
//   - 256 threads a block, two blocks (16 warps) an SM; the window is
//     staged in shared memory (cp.async), so every neighbour gather reads
//     it;
//   - one pass over the slots, two threads a lane (coalesced), writes the
//     (4, mn_r, a_pad) tile of every slot, marks the live angular pairs
//     (nep_common.cuh) and sums the radial terms of the live centres with
//     the S[t, :] of two types in registers (a further pass per two types
//     beyond two); pairs outside the cutoff are skipped (exact zeros), the
//     two threads' sums added in a fixed order.  The pass reads each index
//     once: a stage over the live-centre list would read idx again, once
//     a type, and cost more than the tile pass (PERF.md section 6);
//   - angular stage, chunk by chunk: one thread per queued pair writes its
//     g_n and Y_lm to a shared buffer; then threads own (centre, channel)
//     outputs, each the sum of g_n Y_lm over the centre's own queue segment
//     in slot order, stored coalesced: no accumulator array, no atomics;
//   - l_max and a bound NMAX on kr1, ka1, na1 are template arguments, so
//     every per-pair array is indexed by unrolled constants (registers).
#include <cuda_pipeline.h>

#include "nep_common.cuh"

struct K1Args {
  const float* centers;  // (NB, 4, a_pad)
  const float* cand;     // (NB, 4, wl)
  const int* idx;        // (NB, mn_r, a_pad)
  float* out;            // (ch, NB*a_pad)
  float* tiles;          // (NB, 4, mn_r, a_pad) or null
  int a_pad, wl, mn_r, mn_a, ch, ztab_n, mw, qcap, fstride;
  float zcut;            // ZBL pairs at d >= zcut add exact zeros
};

template <int LMAX, int NMAX>
__global__ void __launch_bounds__(GK_BLOCK, 2)
    k1_kernel(const K1Args k, const NepConsts c) {
  constexpr int NLM = LMAX * (LMAX + 2);
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, b = blockIdx.x, a_pad = k.a_pad, wl = k.wl;
  const int sr = c.T * c.kr1, nang = c.na1 * NLM, ch_used = sr + 1 + nang;
  // shared memory: window (4, wl) | centres (4, a_pad) | ztab |
  // bookkeeping | pairs (qcap + mn_a, fstride): g_n then Y_lm
  float* win = sm;
  float* cpos = win + 4 * wl;
  float* zt = cpos + 4 * a_pad;
  const GkLive s = gk_live_views(reinterpret_cast<int*>(zt + k.ztab_n),
                                 a_pad, k.mw);
  float* buf = reinterpret_cast<float*>(s.counts + 2);

  const size_t nflat = (size_t)gridDim.x * a_pad;
  const size_t tile_c = (size_t)k.mn_r * a_pad;
  const float* cb = k.centers + (size_t)b * 4 * a_pad;
  const float* wsrc = k.cand + (size_t)b * 4 * wl;
  const int* ib = k.idx + (size_t)b * tile_c;
  float* tb = k.tiles ? k.tiles + (size_t)b * 4 * tile_c : nullptr;
  const size_t col0 = (size_t)b * a_pad;

  // window and centres by 16-byte cp.async (wl and a_pad are multiples of
  // 128), every copy in flight at once
  for (int i = tid; i < wl; i += GK_BLOCK)
    __pipeline_memcpy_async(win + 4 * i, wsrc + 4 * i, 16);
  for (int i = tid; i < a_pad; i += GK_BLOCK)
    __pipeline_memcpy_async(cpos + 4 * i, cb + 4 * i, 16);
  __pipeline_commit();
  for (int i = tid; i < k.ztab_n; i += GK_BLOCK) zt[i] = c.ztab[i];
  for (int i = tid; i < a_pad * k.mw; i += GK_BLOCK) s.mask[i] = 0u;
  if (tid < 32) gk_live_lanes(cb, a_pad, s);
  __pipeline_wait_prior(0);
  __syncthreads();

  // dead lanes and the padding rows are zero
  for (int o = tid; o < k.ch * a_pad; o += GK_BLOCK) {
    const int row = o / a_pad, a = o - row * a_pad;
    if (row >= ch_used || s.c_of[a] < 0)
      k.out[(size_t)row * nflat + col0 + a] = 0.0f;
  }

  // 1. one pass over the slots writes every tile, marks the live angular
  // pairs, and sums the radial terms of types tp, tp + 1 and the ZBL
  // energy of the live centres in registers (more passes, without the
  // tiles, only for more than two types).  Thread tid owns the lanes
  // a = tid (mod L) and the slots m = ph (mod R) of each: coalesced over
  // the lanes, and R = 2 phases of one lane added in a fixed order.
  // GK_BATCH slots' indices are loaded before any is used: 16 warps an SM
  // alone do not hide a load's latency.
  const int L = a_pad < GK_BLOCK ? a_pad : GK_BLOCK;
  const int R = GK_BLOCK / L, ph = tid / L;
  float* red = buf;  // (2 NMAX + 1, L): phase 1's sums (R = 2)
  for (int tp = 0; tp < c.T; tp += 2) {
    const bool first = tp == 0, two = tp + 1 < c.T;
    for (int a = tid % L; a < a_pad; a += L) {
      const int ci = s.c_of[a];
      const bool live = ci >= 0;
      const float cx = cpos[a], cy = cpos[a_pad + a], cz = cpos[2 * a_pad + a];
      const float ct = cpos[3 * a_pad + a];
      const int ti = gk_type_index(ct, c.T);
      const bool ti_ok = gk_type_valid(ct, c.T);
      const float rcp0 = 0.5f * (c.rc_r[ti] + c.rc_r[tp]);
      const float rcp1 = two ? 0.5f * (c.rc_r[ti] + c.rc_r[tp + 1]) : 1.0f;
      float acc0[NMAX], acc1[NMAX], ez = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NMAX; ++kk) acc0[kk] = acc1[kk] = 0.0f;
      if (first || live) {
        for (int m0 = ph; m0 < k.mn_r; m0 += GK_BATCH * R) {
          int jv[GK_BATCH];
#pragma unroll
          for (int v = 0; v < GK_BATCH; ++v) {
            const int m = m0 + v * R;
            jv[v] = m < k.mn_r ? ib[(size_t)m * a_pad + a] : 0;
          }
#pragma unroll
          for (int v = 0; v < GK_BATCH; ++v) {
            const int m = m0 + v * R;
            if (m >= k.mn_r) break;
            const int j = jv[v];
            const float dx = win[j] - cx, dy = win[wl + j] - cy;
            const float dz = win[2 * wl + j] - cz, tj = win[3 * wl + j];
            if (first) {
              const size_t i = (size_t)m * a_pad + a;
              if (tb) {
                tb[i] = dx;
                tb[tile_c + i] = dy;
                tb[2 * tile_c + i] = dz;
                tb[3 * tile_c + i] = tj;
              }
              if (m < k.mn_a && live &&
                  gk_ang_live(c, dx, dy, dz, tj, ti, ti_ok))
                atomicOr(&s.mask[ci * k.mw + (m >> 5)], 1u << (m & 31));
            }
            if (!live) continue;
            const float d2 = dx * dx + dy * dy + dz * dz;
            // a dead pair (self, empty slot, FAR ghost) adds exact zeros
            if (!(d2 > GK_EPS2 && tj > -0.5f)) continue;
            const float inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
            const float d = d2 * inv_d;
            if (first && c.zbl_mode && d < k.zcut) {
              float e;
              gk_zbl(c, d, inv_d, ct, tj, &e, nullptr);
              ez += e;
            }
            const int tjx = gk_type_index(tj, c.T);
            if (!gk_type_valid(tj, c.T) || (tjx != tp && tjx != tp + 1))
              continue;
            const float rcp = tjx == tp ? rcp0 : rcp1;
            if (!(d / rcp < 1.0f)) continue;
            float f[NMAX];
            gk_cheb<NMAX>(d, rcp, c.kr1, f, nullptr);
            if (tjx == tp) {
#pragma unroll
              for (int kk = 0; kk < NMAX; ++kk)
                if (kk < c.kr1) acc0[kk] += f[kk];
            } else {
#pragma unroll
              for (int kk = 0; kk < NMAX; ++kk)
                if (kk < c.kr1) acc1[kk] += f[kk];
            }
          }
        }
      }
      if (R == 2) {  // phase 0 adds phase 1's sums
        const int ra = a % L;
        if (ph == 1 && live) {
#pragma unroll
          for (int kk = 0; kk < NMAX; ++kk) {
            red[kk * L + ra] = acc0[kk];
            red[(NMAX + kk) * L + ra] = acc1[kk];
          }
          red[2 * NMAX * L + ra] = ez;
        }
        __syncthreads();
        if (ph == 0 && live) {
#pragma unroll
          for (int kk = 0; kk < NMAX; ++kk) {
            acc0[kk] += red[kk * L + ra];
            acc1[kk] += red[(NMAX + kk) * L + ra];
          }
          ez += red[2 * NMAX * L + ra];
        }
        __syncthreads();
      }
      if (ph == 0 && live) {
        const size_t col = col0 + a;
#pragma unroll
        for (int kk = 0; kk < NMAX; ++kk) {
          if (kk < c.kr1) {
            k.out[(size_t)(tp * c.kr1 + kk) * nflat + col] = acc0[kk];
            if (two) k.out[(size_t)((tp + 1) * c.kr1 + kk) * nflat + col] = acc1[kk];
          }
        }
        if (first) k.out[(size_t)sr * nflat + col] = ez;
      }
    }
  }
  __syncthreads();
  if (tid < 32) gk_queue_offsets(s, k.mw, k.qcap, a_pad);
  __syncthreads();

  // 3. angular sums, one chunk of whole centres at a time
  const int nch = s.counts[1], F = k.fstride;
  for (int kc = 0; kc < nch; ++kc) {
    const int c_lo = s.chunk[kc], c_hi = s.chunk[kc + 1];
    const int q0 = s.off[c_lo], q1 = s.off[c_hi];
    for (int q = q0 + tid; q < q1; q += GK_BLOCK) {
      const int ci = gk_owner(s.off, c_lo, c_hi, q);
      const int m = gk_nth_slot(s.mask + ci * k.mw, q - s.off[ci]);
      const int a = s.lane_of[ci];
      const int j = ib[(size_t)m * a_pad + a];
      const float dx = win[j] - cpos[a], dy = win[wl + j] - cpos[a_pad + a];
      const float dz = win[2 * wl + j] - cpos[2 * a_pad + a];
      const float tj = win[3 * wl + j];
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
      const float d = d2 * inv_d;
      const int ti = gk_type_index(cpos[3 * a_pad + a], c.T);
      const int tjx = gk_type_index(tj, c.T);
      float gn[NMAX];
      gk_cheb_gn<NMAX>(d, 0.5f * (c.rc_a[ti] + c.rc_a[tjx]), c.ka1,
                       c.c_ang + (size_t)(ti * c.T + tjx) * c.na1 * c.ka1,
                       c.na1, gn, nullptr);
      float* e = buf + (size_t)(q - q0) * F;
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
        if (n < c.na1) e[n] = gn[n];
      gk_ylm<LMAX>(dx * inv_d, dy * inv_d, dz * inv_d, zt, e + c.na1);
    }
    __syncthreads();
    // (centre, n) threads: s[n, lm] for every lm in registers, each the
    // sum over the centre's segment in slot order
    const int ncc = c_hi - c_lo;
    for (int o = tid; o < c.na1 * ncc; o += GK_BLOCK) {
      const int n = o / ncc, ci = c_lo + (o - n * ncc);
      float v[NLM];
#pragma unroll
      for (int lm = 0; lm < NLM; ++lm) v[lm] = 0.0f;
      for (int q = s.off[ci]; q < s.off[ci + 1]; ++q) {
        const float* e = buf + (size_t)(q - q0) * F;
        const float g = e[n];
#pragma unroll
        for (int lm = 0; lm < NLM; ++lm) v[lm] += g * e[c.na1 + lm];
      }
      float* op = k.out + (size_t)(sr + 1 + n * NLM) * nflat + col0 +
                  s.lane_of[ci];
#pragma unroll
      for (int lm = 0; lm < NLM; ++lm) op[lm * nflat] = v[lm];
    }
    __syncthreads();
  }
}

// Launch (occ == nullptr) or report resident blocks an SM into *occ.
template <int LMAX, int NMAX>
static int k1_go(const K1Args& k, const NepConsts& c, int nb, int smem,
                 cudaStream_t stream, int* occ) {
  void (*fn)(const K1Args, const NepConsts) = k1_kernel<LMAX, NMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, fn,
                                                              GK_BLOCK, smem);
  fn<<<nb, GK_BLOCK, smem, stream>>>(k, c);
  return (int)cudaGetLastError();
}

template <int NMAX>
static int k1_lmax(int l_max, const K1Args& k, const NepConsts& c, int nb,
                   int smem, cudaStream_t stream, int* occ) {
  switch (l_max) {
    case 1: return k1_go<1, NMAX>(k, c, nb, smem, stream, occ);
    case 2: return k1_go<2, NMAX>(k, c, nb, smem, stream, occ);
    case 3: return k1_go<3, NMAX>(k, c, nb, smem, stream, occ);
    case 4: return k1_go<4, NMAX>(k, c, nb, smem, stream, occ);
    case 5: return k1_go<5, NMAX>(k, c, nb, smem, stream, occ);
    case 6: return k1_go<6, NMAX>(k, c, nb, smem, stream, occ);
    case 7: return k1_go<7, NMAX>(k, c, nb, smem, stream, occ);
    case 8: return k1_go<8, NMAX>(k, c, nb, smem, stream, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The library build compiles this file once a part, all parts at once,
// with GK_PART set (engine/cuda_build.py's PARTS): part 0 holds the NMAX
// = 8 instances and the entry points, part 1 the NMAX = 20 instances.  A
// build without GK_PART takes the whole file.
int k1_nmax20(int l_max, const K1Args& k, const NepConsts& c, int nb,
              int smem, cudaStream_t stream, int* occ);

#if !defined(GK_PART) || GK_PART == 1
int k1_nmax20(int l_max, const K1Args& k, const NepConsts& c, int nb,
              int smem, cudaStream_t stream, int* occ) {
  return k1_lmax<20>(l_max, k, c, nb, smem, stream, occ);
}
#endif

#if !defined(GK_PART) || GK_PART == 0
static int k1_dispatch(int l_max, int nmax, const K1Args& k,
                       const NepConsts& c, int nb, int smem,
                       cudaStream_t stream, int* occ) {
  if (nmax == 8) return k1_lmax<8>(l_max, k, c, nb, smem, stream, occ);
  if (nmax == 20) return k1_nmax20(l_max, k, c, nb, smem, stream, occ);
  return (int)cudaErrorInvalidValue;
}

extern "C" int k1_launch(const float* centers, const float* cand,
                         const int* idx, float* out, float* tiles,
                         const float* rc_r, const float* rc_a,
                         const float* c_ang, const float* znum,
                         const float* rcov, const float* flex,
                         const float* ztab, int nb, int a_pad, int wl,
                         int mn_r, int mn_a, int ch, int T, int kr1, int na1,
                         int ka1, int l_max, int zbl_mode, int ztab_n, int mw,
                         int qcap, int fstride, int nmax, int smem,
                         float rc_inner, float rc_outer, float factor,
                         float zcut, void* stream) {
  const NepConsts c = gk_consts(rc_r, rc_a, c_ang, znum, rcov, flex, ztab, T,
                                kr1, na1, ka1, l_max, zbl_mode, rc_inner,
                                rc_outer, factor);
  K1Args k;
  k.centers = centers; k.cand = cand; k.idx = idx; k.out = out;
  k.tiles = tiles; k.a_pad = a_pad; k.wl = wl; k.mn_r = mn_r;
  k.mn_a = mn_a; k.ch = ch; k.ztab_n = ztab_n; k.mw = mw; k.qcap = qcap;
  k.fstride = fstride; k.zcut = zcut;
  return k1_dispatch(l_max, nmax, k, c, nb, smem, (cudaStream_t)stream,
                     nullptr);
}

extern "C" int k1_occupancy(int l_max, int nmax, int smem, int* blocks) {
  const K1Args k{};
  const NepConsts c{};
  return k1_dispatch(l_max, nmax, k, c, 0, smem, nullptr, blocks);
}
#endif  // GK_PART 0
