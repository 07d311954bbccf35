// K2: NEP forces, virials and angular pair cotangents on the compact tiles.
//
// Replaces the TPU kernel gpumd_tpu/engine/nep_compact.py:_k2_kernel
// (called through k2_call).  Per centre lane, over its mn_r neighbours:
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
// What bounds it on the H100: arithmetic, as in K1 (plus the derivative
// chain), and the j-side cotangent reads (kr1 + 1 scattered 4-byte loads
// per pair).  Design: one block per grid block, one thread per centre
// lane; the centre's own ~180 cotangent channels are staged in shared
// memory [channel][lane]; the j-side rows (16 x wl floats per block, 147 KB
// at the PbTe plan) are read through the read-only cache rather than
// staged.  Tiles and idx are addressed [m][lane] (coalesced).
#include "nep_common.cuh"

template <int LMAX>
__global__ void k2_kernel(const float* __restrict__ centers,
                          const float* __restrict__ tiles,
                          const int* __restrict__ idx,
                          const float* __restrict__ cotc,
                          const float* __restrict__ cotw,
                          float* __restrict__ out, float* __restrict__ pvals,
                          NepConsts c, int a_pad, int wl, int mn_r, int mn_a,
                          int wch, int pch, int per_atom_virial, int ztab_n) {
  constexpr int NLM = LMAX * (LMAX + 2);
  extern __shared__ float sm[];
  const int sr = c.T * c.kr1;
  const int ch_used = sr + 1 + c.na1 * NLM;
  float* cot = sm;                     // (ch_used, a_pad)
  float* zt = cot + ch_used * a_pad;
  const int b = blockIdx.x, a = threadIdx.x;
  const size_t nflat = (size_t)gridDim.x * a_pad;

  for (int k = 0; k < ch_used; ++k)
    cot[k * a_pad + a] = cotc[(size_t)k * nflat + (size_t)b * a_pad + a];
  for (int i = a; i < ztab_n; i += blockDim.x) zt[i] = c.ztab[i];
  __syncthreads();

  const float ct = centers[(size_t)b * 4 * a_pad + 3 * a_pad + a];
  const int ti = gk_type_index(ct, c.T);
  const bool ti_ok = gk_type_valid(ct, c.T);
  const float* cw = cotw + (size_t)b * wch * wl;
  const size_t tile_c = (size_t)mn_r * a_pad;
  const size_t pc = (size_t)mn_a * a_pad;
  float* pb = pvals + (size_t)b * pch * pc + a;

  float g[3] = {0.0f, 0.0f, 0.0f};
  float w[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float f[GK_MAXK], fp[GK_MAXK], gn[GK_MAXN], gnp[GK_MAXN];
  float bl[NLM], bpl[NLM];

  for (int m = 0; m < mn_r; ++m) {
    const float* tp = tiles + (size_t)b * 4 * tile_c + (size_t)m * a_pad + a;
    const float dx = tp[0], dy = tp[tile_c], dz = tp[2 * tile_c];
    const float tj = tp[3 * tile_c];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool ok = d2 > GK_EPS2 && tj > -0.5f;
    float p[3] = {0.0f, 0.0f, 0.0f};
    if (ok) {
      const int j = idx[((size_t)b * mn_r + m) * a_pad + a];
      const int tjx = gk_type_index(tj, c.T);
      const bool tj_ok = gk_type_valid(tj, c.T);
      const float inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
      const float d = d2 * inv_d;
      const float u[3] = {dx * inv_d, dy * inv_d, dz * inv_d};
      const float r[3] = {dx, dy, dz};

      // radial, two-sided: sig_i = sum_k f'_k cot_S_i[t_j, k],
      // sig_j = sum_k f'_k cot_S_j[t_i, k]
      gk_cheb(d, 0.5f * (c.rc_r[ti] + c.rc_r[tjx]), c.kr1, f, fp);
      float sig_i = 0.0f, sig_j = 0.0f;
      for (int k = 0; k < c.kr1; ++k) {
        const float ci = tj_ok ? cot[(tjx * c.kr1 + k) * a_pad + a] : 0.0f;
        const float cj = ti_ok ? __ldg(cw + (size_t)(ti * c.kr1 + k) * wl + j)
                               : 0.0f;
        sig_i += ci * fp[k];
        sig_j += cj * fp[k];
      }
      if (c.zbl_mode) {
        float e, dedd;
        gk_zbl(c, d, inv_d, ct, tj, &e, &dedd);
        sig_i += cot[sr * a_pad + a] * dedd;
        sig_j += __ldg(cw + (size_t)sr * wl + j) * dedd;
      }
      const float sig = sig_i + sig_j;
#pragma unroll
      for (int q = 0; q < 3; ++q) g[q] -= sig * u[q];
      // per-atom virial, radial part: W_i += r12 (x) p_ji, p_ji = -sig_j u
#pragma unroll
      for (int av = 0; av < 3; ++av)
#pragma unroll
        for (int bv = 0; bv < 3; ++bv) w[av * 3 + bv] += r[av] * (-sig_j * u[bv]);

      if (m < mn_a && ti_ok && tj_ok) {
        gk_cheb(d, 0.5f * (c.rc_a[ti] + c.rc_a[tjx]), c.ka1, f, fp);
        const float* cp = c.c_ang + (size_t)(ti * c.T + tjx) * c.na1 * c.ka1;
        for (int n = 0; n < c.na1; ++n) {
          float v = 0.0f, vp = 0.0f;
          for (int k = 0; k < c.ka1; ++k) {
            v += cp[n * c.ka1 + k] * f[k];
            vp += cp[n * c.ka1 + k] * fp[k];
          }
          gn[n] = v;
          gnp[n] = vp;
        }
        const float* cs = cot + (sr + 1) * a_pad + a;
#pragma unroll
        for (int lm = 0; lm < NLM; ++lm) {
          float v = 0.0f, vp = 0.0f;
          for (int n = 0; n < c.na1; ++n) {
            const float cc = cs[(n * NLM + lm) * a_pad];
            v += cc * gn[n];
            vp += cc * gnp[n];
          }
          bl[lm] = v;
          bpl[lm] = vp;
        }
        float sval, gx, gy, gz;
        gk_ylm_vjp<LMAX>(u[0], u[1], u[2], zt, bl, bpl, &sval, &gx, &gy, &gz);
        const float ug = u[0] * gx + u[1] * gy + u[2] * gz;
        p[0] = sval * u[0] + (gx - u[0] * ug) * inv_d;
        p[1] = sval * u[1] + (gy - u[1] * ug) * inv_d;
        p[2] = sval * u[2] + (gz - u[2] * ug) * inv_d;
        // centre side: dE/dx_i = -sum_m p_ij
#pragma unroll
        for (int q = 0; q < 3; ++q) g[q] -= p[q];
        if (!per_atom_virial) {
          // total-virial mode keeps the pair term local
#pragma unroll
          for (int av = 0; av < 3; ++av)
#pragma unroll
            for (int bv = 0; bv < 3; ++bv) w[av * 3 + bv] += -r[av] * p[bv];
        }
      }
    }
    if (m < mn_a) {
      float* pm = pb + (size_t)m * a_pad;
#pragma unroll
      for (int q = 0; q < 3; ++q) pm[q * pc] = p[q];
      if (per_atom_virial) {
        // angular virial of atom j: W_j += (-r12) (x) p_ij, via the scatter
        const float r[3] = {dx, dy, dz};
#pragma unroll
        for (int av = 0; av < 3; ++av)
#pragma unroll
          for (int bv = 0; bv < 3; ++bv)
            pm[(3 + av * 3 + bv) * pc] = ok ? -r[av] * p[bv] : 0.0f;
        for (int q = 12; q < pch; ++q) pm[q * pc] = 0.0f;
      } else {
        for (int q = 3; q < pch; ++q) pm[q * pc] = 0.0f;
      }
    }
  }
  const size_t col = (size_t)b * a_pad + a;
#pragma unroll
  for (int q = 0; q < 3; ++q) out[q * nflat + col] = g[q];
#pragma unroll
  for (int q = 0; q < 9; ++q) out[(3 + q) * nflat + col] = w[q];
  for (int q = 12; q < 16; ++q) out[q * nflat + col] = 0.0f;
}

template <int LMAX>
static int k2_run(const float* centers, const float* tiles, const int* idx,
                  const float* cotc, const float* cotw, float* out,
                  float* pvals, NepConsts c, int nb, int a_pad, int wl,
                  int mn_r, int mn_a, int wch, int pch, int pav, int ztab_n,
                  cudaStream_t stream) {
  constexpr int NLM = LMAX * (LMAX + 2);
  const size_t smem =
      sizeof(float) *
      ((size_t)(c.T * c.kr1 + 1 + c.na1 * NLM) * a_pad + ztab_n);
  cudaFuncSetAttribute(k2_kernel<LMAX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k2_kernel<LMAX><<<nb, a_pad, smem, stream>>>(centers, tiles, idx, cotc, cotw,
                                               out, pvals, c, a_pad, wl, mn_r,
                                               mn_a, wch, pch, pav, ztab_n);
  return (int)cudaGetLastError();
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
                         int ztab_n, float rc_inner, float rc_outer,
                         float factor, void* stream) {
  NepConsts c = gk_consts(rc_r, rc_a, c_ang, znum, rcov, flex, ztab, T, kr1,
                          na1, ka1, l_max, zbl_mode, rc_inner, rc_outer,
                          factor);
  cudaStream_t s = (cudaStream_t)stream;
#define GK_K2(L) \
  return k2_run<L>(centers, tiles, idx, cotc, cotw, out, pvals, c, nb, a_pad, \
                   wl, mn_r, mn_a, wch, pch, per_atom_virial, ztab_n, s)
  switch (l_max) {
    case 1: GK_K2(1);
    case 2: GK_K2(2);
    case 3: GK_K2(3);
    case 4: GK_K2(4);
    case 5: GK_K2(5);
    case 6: GK_K2(6);
    case 7: GK_K2(7);
    case 8: GK_K2(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GK_K2
}
