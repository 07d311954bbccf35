// K1: NEP descriptor sums on the compact engine's neighbour tiles.
//
// Replaces the TPU kernel gpumd_tpu/engine/nep_compact.py:_k1_kernel
// (called through k1_call).  Per centre lane, over its mn_r window-relative
// neighbours: Chebyshev radial sums S[t_j, k], the ZBL pair energy, and on
// the mn_a angular prefix s_{n,lm} = sum_j g_n(r_ij) Y_lm(u_ij).  Outputs
// the flat (ch, NB*a_pad) sums and the displacement/type tiles
// (NB, 4, mn_r, a_pad) that K2 reads back.
//
// What bounds it on the H100: arithmetic.  Each angular pair costs ~
// na1*(ka1 + nlm) FMAs plus the Y_lm polynomials (~400 FLOP at the PbTe
// model) and each radial pair ~40 FLOP plus a cos; the bytes are the idx
// tile (4 B/pair), the tiles output (16 B/pair) and one window per block.
// Design: one block per grid block (z, y, xb), one thread per centre lane.
// The block's candidate window (4 x wl floats) is staged once in shared
// memory, so the neighbour gather is a shared-memory read.  idx and the
// tiles are addressed [m][lane], so consecutive threads touch consecutive
// words.  The ~180 per-lane accumulators would spill registers; they live
// in shared memory laid out [channel][lane] (bank-conflict free, each
// thread owns one column) and are written to the output once at the end.
#include "nep_common.cuh"

template <int LMAX>
__global__ void k1_kernel(const float* __restrict__ centers,
                          const float* __restrict__ cand,
                          const int* __restrict__ idx,
                          float* __restrict__ out, float* __restrict__ tiles,
                          NepConsts c, int a_pad, int wl, int mn_r, int mn_a,
                          int ch, int ztab_n) {
  constexpr int NLM = LMAX * (LMAX + 2);
  extern __shared__ float sm[];
  const int sr = c.T * c.kr1;
  const int ch_used = sr + 1 + c.na1 * NLM;
  float* win = sm;                      // (4, wl)
  float* acc = sm + 4 * wl;             // (ch_used, a_pad)
  float* zt = acc + ch_used * a_pad;    // Y_lm z-coefficients
  const int b = blockIdx.x, a = threadIdx.x;
  const size_t nflat = (size_t)gridDim.x * a_pad;

  const float* wsrc = cand + (size_t)b * 4 * wl;
  for (int i = a; i < 4 * wl; i += blockDim.x) win[i] = wsrc[i];
  for (int i = a; i < ztab_n; i += blockDim.x) zt[i] = c.ztab[i];
  for (int k = 0; k < ch_used; ++k) acc[k * a_pad + a] = 0.0f;
  __syncthreads();

  const float* cb = centers + (size_t)b * 4 * a_pad;
  const float cx = cb[a], cy = cb[a_pad + a], cz = cb[2 * a_pad + a];
  const float ct = cb[3 * a_pad + a];
  const int ti = gk_type_index(ct, c.T);
  const bool ti_ok = gk_type_valid(ct, c.T);
  const size_t tile_c = (size_t)mn_r * a_pad;
  float f[GK_MAXK], gn[GK_MAXN], y[NLM];

  for (int m = 0; m < mn_r; ++m) {
    const int j = idx[((size_t)b * mn_r + m) * a_pad + a];
    const float dx = win[j] - cx, dy = win[wl + j] - cy;
    const float dz = win[2 * wl + j] - cz, tj = win[3 * wl + j];
    if (tiles) {
      float* tp = tiles + (size_t)b * 4 * tile_c + (size_t)m * a_pad + a;
      tp[0] = dx;
      tp[tile_c] = dy;
      tp[2 * tile_c] = dz;
      tp[3 * tile_c] = tj;
    }
    const float d2 = dx * dx + dy * dy + dz * dz;
    // a dead pair (self, empty slot, FAR ghost) adds exact zeros
    if (!(d2 > GK_EPS2 && tj > -0.5f)) continue;
    const int tjx = gk_type_index(tj, c.T);
    const bool tj_ok = gk_type_valid(tj, c.T);
    const float inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
    const float d = d2 * inv_d;

    gk_cheb(d, 0.5f * (c.rc_r[ti] + c.rc_r[tjx]), c.kr1, f, nullptr);
    if (tj_ok) {
      for (int k = 0; k < c.kr1; ++k) acc[(tjx * c.kr1 + k) * a_pad + a] += f[k];
    }
    if (c.zbl_mode) {
      float e;
      gk_zbl(c, d, inv_d, ct, tj, &e, nullptr);
      acc[sr * a_pad + a] += e;
    }
    if (m < mn_a && ti_ok && tj_ok) {
      gk_cheb(d, 0.5f * (c.rc_a[ti] + c.rc_a[tjx]), c.ka1, f, nullptr);
      const float* cp = c.c_ang + (size_t)(ti * c.T + tjx) * c.na1 * c.ka1;
      for (int n = 0; n < c.na1; ++n) {
        float g = 0.0f;
        for (int k = 0; k < c.ka1; ++k) g += cp[n * c.ka1 + k] * f[k];
        gn[n] = g;
      }
      gk_ylm<LMAX>(dx * inv_d, dy * inv_d, dz * inv_d, zt, y);
      float* as = acc + (sr + 1) * a_pad + a;
      for (int n = 0; n < c.na1; ++n) {
#pragma unroll
        for (int lm = 0; lm < NLM; ++lm) as[(n * NLM + lm) * a_pad] += gn[n] * y[lm];
      }
    }
  }
  for (int k = 0; k < ch; ++k)
    out[(size_t)k * nflat + (size_t)b * a_pad + a] =
        k < ch_used ? acc[k * a_pad + a] : 0.0f;
}

template <int LMAX>
static int k1_run(const float* centers, const float* cand, const int* idx,
                  float* out, float* tiles, NepConsts c, int nb, int a_pad,
                  int wl, int mn_r, int mn_a, int ch, int ztab_n,
                  cudaStream_t stream) {
  constexpr int NLM = LMAX * (LMAX + 2);
  const size_t smem =
      sizeof(float) * ((size_t)4 * wl +
                       (size_t)(c.T * c.kr1 + 1 + c.na1 * NLM) * a_pad + ztab_n);
  cudaFuncSetAttribute(k1_kernel<LMAX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k1_kernel<LMAX><<<nb, a_pad, smem, stream>>>(centers, cand, idx, out, tiles,
                                               c, a_pad, wl, mn_r, mn_a, ch,
                                               ztab_n);
  return (int)cudaGetLastError();
}

extern "C" int k1_launch(const float* centers, const float* cand,
                         const int* idx, float* out, float* tiles,
                         const float* rc_r, const float* rc_a,
                         const float* c_ang, const float* znum,
                         const float* rcov, const float* flex,
                         const float* ztab, int nb, int a_pad, int wl,
                         int mn_r, int mn_a, int ch, int T, int kr1, int na1,
                         int ka1, int l_max, int zbl_mode, int ztab_n,
                         float rc_inner, float rc_outer, float factor,
                         void* stream) {
  NepConsts c = gk_consts(rc_r, rc_a, c_ang, znum, rcov, flex, ztab, T, kr1,
                          na1, ka1, l_max, zbl_mode, rc_inner, rc_outer,
                          factor);
  cudaStream_t s = (cudaStream_t)stream;
  switch (l_max) {
    case 1: return k1_run<1>(centers, cand, idx, out, tiles, c, nb, a_pad, wl, mn_r, mn_a, ch, ztab_n, s);
    case 2: return k1_run<2>(centers, cand, idx, out, tiles, c, nb, a_pad, wl, mn_r, mn_a, ch, ztab_n, s);
    case 3: return k1_run<3>(centers, cand, idx, out, tiles, c, nb, a_pad, wl, mn_r, mn_a, ch, ztab_n, s);
    case 4: return k1_run<4>(centers, cand, idx, out, tiles, c, nb, a_pad, wl, mn_r, mn_a, ch, ztab_n, s);
    case 5: return k1_run<5>(centers, cand, idx, out, tiles, c, nb, a_pad, wl, mn_r, mn_a, ch, ztab_n, s);
    case 6: return k1_run<6>(centers, cand, idx, out, tiles, c, nb, a_pad, wl, mn_r, mn_a, ch, ztab_n, s);
    case 7: return k1_run<7>(centers, cand, idx, out, tiles, c, nb, a_pad, wl, mn_r, mn_a, ch, ztab_n, s);
    case 8: return k1_run<8>(centers, cand, idx, out, tiles, c, nb, a_pad, wl, mn_r, mn_a, ch, ztab_n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
