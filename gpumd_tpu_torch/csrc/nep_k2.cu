// K2: NEP forces, virials and angular pair cotangents on the compact tiles.
//
// Replaces the TPU kernel gpumd_tpu/engine/nep_compact.py:_k2_kernel
// (called through k2_call).  Per centre, over its mn_r neighbours:
// two-sided radial pair forces (sigma_i + sigma_j) u, with sigma_j from the
// neighbour's cotangent rows of the window (ref find_force_radial), ZBL
// dE/dd, and on the mn_a prefix the angular VJP p_ij = dE_i/dr_ij.  Outputs
// the flat (16, NB*a_pad) centre gradient + 9 virial rows and the pair
// cotangents (NB, pch, mn_a, a_pad), pch = 4, or 12 with per-atom virial.
//
// The TPU kernel took the angular VJP with jax.grad inside the kernel.
// Here it is derived by hand: with b_lm = sum_n cot[n,lm] g_n(d),
// b'_lm = sum_n cot[n,lm] g_n'(d) and G = sum_lm b_lm dY_lm/du,
//   p = u sum_lm b'_lm Y_lm + (G - u (u.G)) / d,
// because du/dr = (1 - u u^T)/d.  The plain torch version in
// nep_compact.py uses the same formula and the CPU tests hold it against
// the JAX kernel's jax.grad.
//
// What bounds it on the H100: bytes (the tiles, idx and pvals streams,
// ~0.6 ms at PbTe 262k); the arithmetic of the live pairs is a few tenths
// of that at the f32 rate.  Between a kernel and that bound stands
// latency: about half of a block's lanes are empty slots, 12 of the 18
// angular slots of a PbTe centre lie outside rc_a, and every slot is a
// chain of dependent loads.  Design:
//   - 256 threads a block and ~108 KB of shared memory at that plan: two
//     blocks, 16 warps, an SM;
//   - the block lists its live centres and queues its live angular pairs
//     (nep_common.cuh); every skipped slot of pvals is written as zero;
//   - radial stage: P = 256 / (live centres) adjacent threads per live
//     centre split its slots and skip pairs outside the radial and ZBL
//     cutoffs (exact zeros); the block's cot rows 0..sr of cotw (the
//     j-side gathers) and of cotc (the centre side) are staged in shared
//     memory by cp.async while the angular slots are sorted (when they
//     fit; else read through the caches); the parts' 12 sums are added in
//     part order;
//   - angular stage, chunk by chunk: the chunk's centre cotangent columns
//     are staged in shared memory (cp.async), one thread takes one queued
//     pair and forms g_n, g'_n, b_lm on the fly and the Y_lm VJP, writes
//     its p (and -r (x) p) to pvals and to a pair buffer, and each centre
//     then sums its own segment in slot order: no atomics, two calls give
//     the same bits;
//   - l_max and a bound NMAX on kr1, ka1, na1 are template arguments, so
//     every per-pair array is indexed by unrolled constants (registers).
#include <cuda_pipeline.h>

#include "nep_common.cuh"

struct K2Args {
  const float* centers;  // (NB, 4, a_pad)
  const float* tiles;    // (NB, 4, mn_r, a_pad)
  const int* idx;        // (NB, mn_r, a_pad)
  const float* cotc;     // (ch, NB*a_pad)
  const float* cotw;     // (NB, wch, wl)
  float* out;            // (16, NB*a_pad)
  float* pvals;          // (NB, pch, mn_a, a_pad)
  int a_pad, wl, mn_r, mn_a, wch, pch, pav, ztab_n, mw, qcap, ccap;
  int region;            // words of the staging region (multiple of 4)
  int stage_w;           // 1: the radial stage reads cot rows from the region
  float zcut;            // ZBL pairs at d >= zcut add exact zeros
};

template <int LMAX, int NMAX>
__global__ void __launch_bounds__(GK_BLOCK, 2)
    k2_kernel(const K2Args k, const NepConsts c) {
  constexpr int NLM = LMAX * (LMAX + 2);
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, b = blockIdx.x, a_pad = k.a_pad;
  const int sr = c.T * c.kr1, nang = c.na1 * NLM;
  // shared memory: region (during the radial stage the block's rows
  // 0..sr of cotw (wl wide) and of cotc (a_pad wide), then the chunk's
  // cotangent columns (nang, ccap)) | pairs
  // (qcap + mn_a, 6) | radial sums (12, a_pad) | centre types | ztab |
  // bookkeeping
  float* region = sm;
  float* cot = region;
  float* pbuf = region + k.region;
  float* rad = pbuf + (size_t)(k.qcap + k.mn_a) * 6;
  float* ctype = rad + 12 * a_pad;
  float* zt = ctype + a_pad;
  const GkLive s = gk_live_views(reinterpret_cast<int*>(zt + k.ztab_n),
                                 a_pad, k.mw);

  const size_t nflat = (size_t)gridDim.x * a_pad;
  const size_t tile_c = (size_t)k.mn_r * a_pad;
  const size_t pc = (size_t)k.mn_a * a_pad;
  const float* cb = k.centers + (size_t)b * 4 * a_pad;
  const float* tb = k.tiles + (size_t)b * 4 * tile_c;
  const int* ib = k.idx + (size_t)b * tile_c;
  const float* cw = k.cotw + (size_t)b * k.wch * k.wl;
  float* pb = k.pvals + (size_t)b * k.pch * pc;
  const size_t col0 = (size_t)b * a_pad;

  // the cot rows the radial stage reads, copied while the angular slots
  // are sorted (16-byte cp.async; wl, a_pad and nflat are multiples of 128)
  float* ccs = region + (size_t)(sr + 1) * k.wl;
  if (k.stage_w) {
    for (int i = tid; i < (sr + 1) * k.wl / 4; i += GK_BLOCK)
      __pipeline_memcpy_async(region + 4 * i, cw + 4 * i, 16);
    for (int i = tid; i < (sr + 1) * a_pad / 4; i += GK_BLOCK) {
      const int row = 4 * i / a_pad, a4 = 4 * i - row * a_pad;
      __pipeline_memcpy_async(ccs + 4 * i,
                              k.cotc + (size_t)row * nflat + col0 + a4, 16);
    }
  }
  __pipeline_commit();
  for (int i = tid; i < k.ztab_n; i += GK_BLOCK) zt[i] = c.ztab[i];
  for (int i = tid; i < a_pad; i += GK_BLOCK) ctype[i] = cb[3 * a_pad + i];
  for (int i = tid; i < a_pad * k.mw; i += GK_BLOCK) s.mask[i] = 0u;
  if (tid < 32) gk_live_lanes(cb, a_pad, s);
  __syncthreads();

  // 1. angular slots: mark the live pairs, write exact zeros elsewhere
  // (GK_BATCH slots' tiles loaded before any is used)
  const int nslot = k.mn_a * a_pad;
  for (int i0 = tid; i0 < nslot; i0 += GK_BATCH * GK_BLOCK) {
    float tv[GK_BATCH][4];
#pragma unroll
    for (int v = 0; v < GK_BATCH; ++v) {
      const int i = min(i0 + v * GK_BLOCK, nslot - 1);
#pragma unroll
      for (int q = 0; q < 4; ++q) tv[v][q] = tb[q * tile_c + i];
    }
#pragma unroll
    for (int v = 0; v < GK_BATCH; ++v) {
      const int i = i0 + v * GK_BLOCK;
      if (i >= nslot) break;
      const int m = i / a_pad, a = i - m * a_pad;
      const int ci = s.c_of[a];
      const float ct = ctype[a];
      if (ci >= 0 && gk_ang_live(c, tv[v][0], tv[v][1], tv[v][2], tv[v][3],
                                 gk_type_index(ct, c.T),
                                 gk_type_valid(ct, c.T))) {
        atomicOr(&s.mask[ci * k.mw + (m >> 5)], 1u << (m & 31));
      } else {
        for (int q = 0; q < k.pch; ++q) pb[q * pc + i] = 0.0f;
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (tid < 32) gk_queue_offsets(s, k.mw, k.qcap, k.ccap);
  const float* cwr = k.stage_w ? region : cw;
  const float* ccr = k.stage_w ? ccs : k.cotc + col0;
  const int cst = k.stage_w ? a_pad : (int)nflat;

  // 2. radial stage: P threads a live centre, each summing every P-th slot
  const int nlive = s.counts[0];
  const int P = gk_parts(nlive), units = nlive * P;
  float* red = pbuf;  // (9, GK_BLOCK) the units' partial sums
  for (int u0 = 0; u0 < units; u0 += GK_BLOCK) {
    const int u = u0 + tid;
    const bool act = u < units;
    const int ci = act ? u / P : 0, part = u - (u / P) * P;
    const int a = s.lane_of[ci];
    const float ct = ctype[a];
    const int ti = gk_type_index(ct, c.T);
    const bool ti_ok = gk_type_valid(ct, c.T);
    const float rci = c.rc_r[ti];
    // g, and the radial virial r (x) (-sig_j u) = -sig_j r (x) r / d, which
    // is symmetric: its 6 upper entries xx, xy, xz, yy, yz, zz
    float g[3] = {0.0f, 0.0f, 0.0f};
    float w[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (act) {
      // one slot in flight a thread: K2 sits at its 128-register cap, and
      // loading a second slot ahead spilled registers
      for (int m = part; m < k.mn_r; m += P) {
        const size_t o = (size_t)m * a_pad + a;
        const float dx = tb[o], dy = tb[tile_c + o], dz = tb[2 * tile_c + o];
        const float tj = tb[3 * tile_c + o];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (!(d2 > GK_EPS2 && tj > -0.5f)) continue;
        const int tjx = gk_type_index(tj, c.T);
        const bool tj_ok = gk_type_valid(tj, c.T);
        const float inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
        const float d = d2 * inv_d;
        const float rcp = 0.5f * (rci + c.rc_r[tjx]);
        const bool in_r = d / rcp < 1.0f;
        const bool in_z = c.zbl_mode && d < k.zcut;
        if (!in_r && !in_z) continue;
        const int j = ib[o];
        float sig_i = 0.0f, sig_j = 0.0f;
        if (in_r) {
          // sig_i = sum_k f'_k cot_S_i[t_j, k],
          // sig_j = sum_k f'_k cot_S_j[t_i, k]
          float f[NMAX], fp[NMAX];
          gk_cheb<NMAX>(d, rcp, c.kr1, f, fp);
#pragma unroll
          for (int kk = 0; kk < NMAX; ++kk) {
            if (kk < c.kr1) {
              const float vi =
                  tj_ok ? ccr[(tjx * c.kr1 + kk) * cst + a] : 0.0f;
              const float vj =
                  ti_ok ? cwr[(ti * c.kr1 + kk) * k.wl + j] : 0.0f;
              sig_i += vi * fp[kk];
              sig_j += vj * fp[kk];
            }
          }
        }
        if (in_z) {
          float e, dedd;
          gk_zbl(c, d, inv_d, ct, tj, &e, &dedd);
          sig_i += ccr[sr * cst + a] * dedd;
          sig_j += cwr[sr * k.wl + j] * dedd;
        }
        const float sig = sig_i + sig_j;
        const float uu[3] = {dx * inv_d, dy * inv_d, dz * inv_d};
#pragma unroll
        for (int q = 0; q < 3; ++q) g[q] -= sig * uu[q];
        // per-atom virial, radial part: W_i += r12 (x) p_ji, p_ji = -sig_j u
        const float sx = -sig_j * uu[0], sy = -sig_j * uu[1];
        const float sz = -sig_j * uu[2];
        w[0] += dx * sx;
        w[1] += dx * sy;
        w[2] += dx * sz;
        w[3] += dy * sy;
        w[4] += dy * sz;
        w[5] += dz * sz;
      }
    }
    // a centre's P units are adjacent threads of this round: part 0 adds
    // the parts' sums in part order
#pragma unroll
    for (int q = 0; q < 3; ++q) red[q * GK_BLOCK + tid] = g[q];
#pragma unroll
    for (int q = 0; q < 6; ++q) red[(3 + q) * GK_BLOCK + tid] = w[q];
    __syncthreads();
    if (act && part == 0) {
      // rows 0-2 gradient, 3-11 virial xx xy xz yx yy yz zx zy zz
#pragma unroll
      for (int q = 0; q < 12; ++q) {
        const int src = q < 6 ? q : q == 6 ? 4 : q == 7 ? 6 : q == 8 ? 7
                      : q == 9 ? 5 : q == 10 ? 7 : 8;
        float v = 0.0f;
        for (int pp = 0; pp < P; ++pp) v += red[src * GK_BLOCK + tid + pp];
        rad[q * a_pad + ci] = v;
      }
    }
    __syncthreads();
  }
  __syncthreads();

  // 3. angular stage, one chunk of whole centres at a time
  const int nch = s.counts[1];
  for (int kc = 0; kc < nch; ++kc) {
    const int c_lo = s.chunk[kc], c_hi = s.chunk[kc + 1];
    const int ncc = c_hi - c_lo;
    const int q0 = s.off[c_lo], q1 = s.off[c_hi];
    for (int o = tid; o < nang * ncc; o += GK_BLOCK) {
      const int kk = o / ncc, cc = o - kk * ncc;
      __pipeline_memcpy_async(
          cot + kk * k.ccap + cc,
          k.cotc + (size_t)(sr + 1 + kk) * nflat + col0 + s.lane_of[c_lo + cc],
          4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int q = q0 + tid; q < q1; q += GK_BLOCK) {
      const int ci = gk_owner(s.off, c_lo, c_hi, q);
      const int m = gk_nth_slot(s.mask + ci * k.mw, q - s.off[ci]);
      const int a = s.lane_of[ci];
      const float* tp = tb + (size_t)m * a_pad + a;
      const float dx = tp[0], dy = tp[tile_c], dz = tp[2 * tile_c];
      const float tj = tp[3 * tile_c];
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
      const float d = d2 * inv_d;
      const float uu[3] = {dx * inv_d, dy * inv_d, dz * inv_d};
      const int ti = gk_type_index(ctype[a], c.T);
      const int tjx = gk_type_index(tj, c.T);
      float gn[NMAX], gnp[NMAX];
      gk_cheb_gn<NMAX>(d, 0.5f * (c.rc_a[ti] + c.rc_a[tjx]), c.ka1,
                       c.c_ang + (size_t)(ti * c.T + tjx) * c.na1 * c.ka1,
                       c.na1, gn, gnp);
      float sval, gx, gy, gz;
      gk_ylm_vjp_cot<LMAX, NMAX>(uu[0], uu[1], uu[2], zt, cot + (ci - c_lo),
                                 NLM * k.ccap, k.ccap, gn, gnp, c.na1, &sval,
                                 &gx, &gy, &gz);
      const float ug = uu[0] * gx + uu[1] * gy + uu[2] * gz;
      const float p[3] = {sval * uu[0] + (gx - uu[0] * ug) * inv_d,
                          sval * uu[1] + (gy - uu[1] * ug) * inv_d,
                          sval * uu[2] + (gz - uu[2] * ug) * inv_d};
      const float r[3] = {dx, dy, dz};
      float* pm = pb + (size_t)m * a_pad + a;
#pragma unroll
      for (int qq = 0; qq < 3; ++qq) pm[qq * pc] = p[qq];
      if (k.pav) {
        // angular virial of atom j: W_j += (-r12) (x) p_ij, via the scatter
#pragma unroll
        for (int av = 0; av < 3; ++av)
#pragma unroll
          for (int bv = 0; bv < 3; ++bv)
            pm[(3 + av * 3 + bv) * pc] = -r[av] * p[bv];
        for (int qq = 12; qq < k.pch; ++qq) pm[qq * pc] = 0.0f;
      } else {
        for (int qq = 3; qq < k.pch; ++qq) pm[qq * pc] = 0.0f;
      }
      float* e = pbuf + (size_t)(q - q0) * 6;
#pragma unroll
      for (int qq = 0; qq < 3; ++qq) {
        e[qq] = p[qq];
        e[3 + qq] = r[qq];
      }
    }
    __syncthreads();
    // each centre sums its own queue segment in slot order
    for (int cc = tid; cc < ncc; cc += GK_BLOCK) {
      const int ci = c_lo + cc;
      float g[3] = {0.0f, 0.0f, 0.0f};
      float w[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int q = s.off[ci]; q < s.off[ci + 1]; ++q) {
        const float* e = pbuf + (size_t)(q - q0) * 6;
        // centre side: dE/dx_i = -sum_m p_ij
#pragma unroll
        for (int qq = 0; qq < 3; ++qq) g[qq] -= e[qq];
        if (!k.pav) {
          // total-virial mode keeps the pair term local
#pragma unroll
          for (int av = 0; av < 3; ++av)
#pragma unroll
            for (int bv = 0; bv < 3; ++bv) w[av * 3 + bv] += -e[3 + av] * e[bv];
        }
      }
#pragma unroll
      for (int qq = 0; qq < 3; ++qq) rad[qq * a_pad + ci] += g[qq];
#pragma unroll
      for (int qq = 0; qq < 9; ++qq) rad[(3 + qq) * a_pad + ci] += w[qq];
    }
    __syncthreads();
  }

  // 4. the 16 output rows of every lane (dead lanes and rows 12-15: zero)
  for (int o = tid; o < 16 * a_pad; o += GK_BLOCK) {
    const int row = o / a_pad, a = o - row * a_pad;
    const int ci = s.c_of[a];
    k.out[(size_t)row * nflat + col0 + a] =
        (ci >= 0 && row < 12) ? rad[row * a_pad + ci] : 0.0f;
  }
}

// Launch (occ == nullptr) or report resident blocks an SM into *occ.
template <int LMAX, int NMAX>
static int k2_go(const K2Args& k, const NepConsts& c, int nb, int smem,
                 cudaStream_t stream, int* occ) {
  void (*fn)(const K2Args, const NepConsts) = k2_kernel<LMAX, NMAX>;
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
static int k2_lmax(int l_max, const K2Args& k, const NepConsts& c, int nb,
                   int smem, cudaStream_t stream, int* occ) {
  switch (l_max) {
    case 1: return k2_go<1, NMAX>(k, c, nb, smem, stream, occ);
    case 2: return k2_go<2, NMAX>(k, c, nb, smem, stream, occ);
    case 3: return k2_go<3, NMAX>(k, c, nb, smem, stream, occ);
    case 4: return k2_go<4, NMAX>(k, c, nb, smem, stream, occ);
    case 5: return k2_go<5, NMAX>(k, c, nb, smem, stream, occ);
    case 6: return k2_go<6, NMAX>(k, c, nb, smem, stream, occ);
    case 7: return k2_go<7, NMAX>(k, c, nb, smem, stream, occ);
    case 8: return k2_go<8, NMAX>(k, c, nb, smem, stream, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The library build compiles this file once a part, all parts at once,
// with GK_PART set (engine/cuda_build.py's PARTS): part 0 holds the NMAX
// = 8 instances and the entry points, parts 1 and 2 the NMAX = 20
// instances of odd and of even l_max.  A build without GK_PART takes the
// whole file.
int k2_nmax20_odd(int l_max, const K2Args& k, const NepConsts& c, int nb,
                  int smem, cudaStream_t stream, int* occ);
int k2_nmax20_even(int l_max, const K2Args& k, const NepConsts& c, int nb,
                   int smem, cudaStream_t stream, int* occ);

#if !defined(GK_PART) || GK_PART == 1
int k2_nmax20_odd(int l_max, const K2Args& k, const NepConsts& c, int nb,
                  int smem, cudaStream_t stream, int* occ) {
  switch (l_max) {
    case 1: return k2_go<1, 20>(k, c, nb, smem, stream, occ);
    case 3: return k2_go<3, 20>(k, c, nb, smem, stream, occ);
    case 5: return k2_go<5, 20>(k, c, nb, smem, stream, occ);
    case 7: return k2_go<7, 20>(k, c, nb, smem, stream, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if !defined(GK_PART) || GK_PART == 2
int k2_nmax20_even(int l_max, const K2Args& k, const NepConsts& c, int nb,
                   int smem, cudaStream_t stream, int* occ) {
  switch (l_max) {
    case 2: return k2_go<2, 20>(k, c, nb, smem, stream, occ);
    case 4: return k2_go<4, 20>(k, c, nb, smem, stream, occ);
    case 6: return k2_go<6, 20>(k, c, nb, smem, stream, occ);
    case 8: return k2_go<8, 20>(k, c, nb, smem, stream, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if !defined(GK_PART) || GK_PART == 0
static int k2_dispatch(int l_max, int nmax, const K2Args& k,
                       const NepConsts& c, int nb, int smem,
                       cudaStream_t stream, int* occ) {
  if (nmax == 8) return k2_lmax<8>(l_max, k, c, nb, smem, stream, occ);
  if (nmax == 20)
    return (l_max & 1 ? k2_nmax20_odd : k2_nmax20_even)(l_max, k, c, nb,
                                                        smem, stream, occ);
  return (int)cudaErrorInvalidValue;
}

extern "C" int k2_launch(const float* centers, const float* tiles,
                         const int* idx, const float* cotc, const float* cotw,
                         float* out, float* pvals, const float* rc_r,
                         const float* rc_a, const float* c_ang,
                         const float* znum, const float* rcov,
                         const float* flex, const float* ztab, int nb,
                         int a_pad, int wl, int mn_r, int mn_a, int wch,
                         int pch, int per_atom_virial, int T, int kr1,
                         int na1, int ka1, int l_max, int zbl_mode,
                         int ztab_n, int mw, int qcap, int ccap, int region,
                         int stage_w, int nmax, int smem, float rc_inner,
                         float rc_outer, float factor, float zcut,
                         void* stream) {
  const NepConsts c = gk_consts(rc_r, rc_a, c_ang, znum, rcov, flex, ztab, T,
                                kr1, na1, ka1, l_max, zbl_mode, rc_inner,
                                rc_outer, factor);
  K2Args k;
  k.centers = centers; k.tiles = tiles; k.idx = idx; k.cotc = cotc;
  k.cotw = cotw; k.out = out; k.pvals = pvals;
  k.a_pad = a_pad; k.wl = wl; k.mn_r = mn_r; k.mn_a = mn_a; k.wch = wch;
  k.pch = pch; k.pav = per_atom_virial; k.ztab_n = ztab_n; k.mw = mw;
  k.qcap = qcap; k.ccap = ccap; k.region = region; k.stage_w = stage_w;
  k.zcut = zcut;
  return k2_dispatch(l_max, nmax, k, c, nb, smem, (cudaStream_t)stream,
                     nullptr);
}

extern "C" int k2_occupancy(int l_max, int nmax, int smem, int* blocks) {
  const K2Args k{};
  const NepConsts c{};
  return k2_dispatch(l_max, nmax, k, c, 0, smem, nullptr, blocks);
}
#endif  // GK_PART 0
