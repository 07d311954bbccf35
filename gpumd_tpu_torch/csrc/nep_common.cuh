// Device helpers shared by the NEP compact kernels (K1, K2).
//
// They mirror, operation for operation, the tile math of
// gpumd_tpu/engine/nep_compact.py (_by_type, _type_masks, _cheb,
// _zbl_pair) and gpumd_tpu/engine/nep_dense.py (_ylm_tile), one pair per
// call instead of an (8, 128) tile.  The plain torch versions in
// gpumd_tpu_torch/engine/nep_compact.py follow the same steps.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GK_EPS2 1.0e-6f
#define GK_PI 3.14159265358979f
#define GK_KC 14.399645f
#define GK_MAXK 20  // basis_size + 1
#define GK_MAXN 20  // n_max + 1

// Model constants, read from device memory (no baked tables).
struct NepConsts {
  const float* rc_r;   // (T,) radial cutoffs
  const float* rc_a;   // (T,) angular cutoffs
  const float* c_ang;  // (T, T, na1, ka1)
  const float* znum;   // (T,) atomic numbers as floats
  const float* rcov;   // (T,) covalent radii (typewise ZBL)
  const float* flex;   // (T(T+1)/2, 10) flexible ZBL rows
  const float* ztab;   // Y_lm z-polynomials: per L, (L+1) x (L+1)
  int T, kr1, na1, ka1, l_max;
  int zbl_mode;        // 0 none, 1 universal, 2 typewise, 3 flexible
  float zbl_rc_inner, zbl_rc_outer, zbl_factor;
};

// _by_type: a float code within 0.5 of t in 1..T-1 selects t, else 0.
__device__ __forceinline__ int gk_type_index(float code, int T) {
  int t = __float2int_rn(code);
  return (t >= 1 && t < T && fabsf(code - (float)t) < 0.5f) ? t : 0;
}

// _type_masks: true when the code names one of the T types.
__device__ __forceinline__ bool gk_type_valid(float code, int T) {
  int t = __float2int_rn(code);
  return t >= 0 && t < T && fabsf(code - (float)t) < 0.5f;
}

// _cheb: f_0 = fc, f_k = (T_k(x) + 1)/2 fc, and optionally df_k/dd.
__device__ __forceinline__ void gk_cheb(float d, float rcp, int k1, float* f,
                                        float* fp) {
  const float x_rc = d / rcp;
  const bool in = x_rc < 1.0f;
  const float fc = in ? 0.5f * cosf(GK_PI * x_rc) + 0.5f : 0.0f;
  const float x = fminf(fmaxf(2.0f * (x_rc - 1.0f) * (x_rc - 1.0f) - 1.0f,
                              -1.0f), 1.0f);
  float fcp = 0.0f, dxdd = 0.0f;
  f[0] = fc;
  if (fp) {
    fcp = in ? -0.5f * GK_PI / rcp * sinf(GK_PI * x_rc) : 0.0f;
    dxdd = 4.0f * (x_rc - 1.0f) / rcp;
    fp[0] = fcp;
  }
  float t_prev = 1.0f, t_cur = x, tp_prev = 0.0f, tp_cur = 1.0f;
  if (k1 > 1) {
    f[1] = 0.5f * (t_cur + 1.0f) * fc;
    if (fp) fp[1] = 0.5f * ((t_cur + 1.0f) * fcp + tp_cur * dxdd * fc);
  }
#pragma unroll
  for (int k = 2; k < GK_MAXK; ++k) {
    if (k < k1) {
      const float t_new = 2.0f * x * t_cur - t_prev;
      const float tp_new = 2.0f * t_cur + 2.0f * x * tp_cur - tp_prev;
      t_prev = t_cur;
      t_cur = t_new;
      tp_prev = tp_cur;
      tp_cur = tp_new;
      f[k] = 0.5f * (t_cur + 1.0f) * fc;
      if (fp) fp[k] = 0.5f * ((t_cur + 1.0f) * fcp + tp_cur * dxdd * fc);
    }
  }
}

// _zbl_pair: pair energy (halved per ordered pair) and dE/dd.
__device__ __forceinline__ void gk_zbl(const NepConsts& c, float d,
                                       float inv_d, float ct, float tj,
                                       float* e_out, float* dedd_out) {
  const int ti = gk_type_index(ct, c.T), tjx = gk_type_index(tj, c.T);
  const float zi = c.znum[ti], zj = c.znum[tjx];
  const float a_inv = (powf(zi, 0.23f) + powf(zj, 0.23f)) * 2.134563f;
  const float x = d * a_inv;
  const float pref = 0.5f * GK_KC * zi * zj;
  float rc1, rc2, phi = 0.0f, phip = 0.0f;
  if (c.zbl_mode == 3) {
    // symmetric pair rows; a code outside the types selects nothing
    const bool both = gk_type_valid(ct, c.T) && gk_type_valid(tj, c.T);
    const int ta = min(ti, tjx), tb = max(ti, tjx);
    const float* row = c.flex + (ta * c.T - (ta * (ta - 1)) / 2 + (tb - ta)) * 10;
    const float m = both ? 1.0f : 0.0f;
    rc1 = m * row[0];
    rc2 = m * row[1];
    for (int j = 0; j < 4; ++j) {
      const float cj = m * row[2 + 2 * j], dj = m * row[3 + 2 * j];
      const float ej = cj * expf(-dj * x);
      phi += ej;
      phip -= dj * ej;
    }
  } else {
    if (c.zbl_mode == 2) {
      rc2 = fminf((c.rcov[ti] + c.rcov[tjx]) * c.zbl_factor, c.zbl_rc_outer);
      rc1 = 0.0f;
    } else {
      rc1 = c.zbl_rc_inner;
      rc2 = c.zbl_rc_outer;
    }
    const float zp[8] = {0.18175f, 3.1998f, 0.50986f, 0.94229f,
                         0.28022f, 0.4029f, 0.02817f, 0.20162f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ej = zp[2 * j] * expf(-zp[2 * j + 1] * x);
      phi += ej;
      phip -= zp[2 * j + 1] * ej;
    }
  }
  const float span = fmaxf(rc2 - rc1, 1e-30f);
  const float frac = (d - rc1) / span;
  const float sw = d < rc1 ? 1.0f
                 : (d < rc2 ? 0.5f * cosf(GK_PI * frac) + 0.5f : 0.0f);
  *e_out = pref * inv_d * phi * sw;
  if (dedd_out) {
    const float swp = (d >= rc1 && d < rc2)
                          ? -0.5f * GK_PI / span * sinf(GK_PI * frac) : 0.0f;
    *dedd_out = pref * ((-inv_d * inv_d) * phi * sw +
                        inv_d * phip * a_inv * sw + inv_d * phi * swp);
  }
}

// _ylm_tile: real solid harmonics of a unit vector, reference s order:
// per L = 1..LMAX -> [m=0, m=1 re, m=1 im, ...].
template <int LMAX>
__device__ __forceinline__ void gk_ylm(float ux, float uy, float uz,
                                       const float* ztab, float* y) {
  float zp[LMAX + 1], cr[LMAX + 1], ci[LMAX + 1];
  zp[0] = 1.0f;
  cr[0] = 1.0f;
  ci[0] = 0.0f;
#pragma unroll
  for (int k = 1; k <= LMAX; ++k) {
    zp[k] = zp[k - 1] * uz;
    cr[k] = cr[k - 1] * ux - ci[k - 1] * uy;
    ci[k] = cr[k - 1] * uy + ci[k - 1] * ux;
  }
  int idx = 0, off = 0;
#pragma unroll
  for (int L = 1; L <= LMAX; ++L) {
#pragma unroll
    for (int m = 0; m <= L; ++m) {
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k <= L; ++k) q += ztab[off + m * (L + 1) + k] * zp[k];
      if (m == 0) {
        y[idx++] = q;
      } else {
        y[idx++] = q * cr[m];
        y[idx++] = q * ci[m];
      }
    }
    off += (L + 1) * (L + 1);
  }
}

// VJP helper: sval = sum_lm bp[lm] Y_lm(u) and G = sum_lm b[lm] dY_lm/du,
// with Y_lm a polynomial in (ux, uy, uz): d(ux + i uy)^m/dux =
// m (ux + i uy)^(m-1), d/duy = i m (ux + i uy)^(m-1).
template <int LMAX>
__device__ __forceinline__ void gk_ylm_vjp(float ux, float uy, float uz,
                                           const float* ztab, const float* b,
                                           const float* bp, float* sval,
                                           float* gx, float* gy, float* gz) {
  float zp[LMAX + 1], cr[LMAX + 1], ci[LMAX + 1];
  zp[0] = 1.0f;
  cr[0] = 1.0f;
  ci[0] = 0.0f;
#pragma unroll
  for (int k = 1; k <= LMAX; ++k) {
    zp[k] = zp[k - 1] * uz;
    cr[k] = cr[k - 1] * ux - ci[k - 1] * uy;
    ci[k] = cr[k - 1] * uy + ci[k - 1] * ux;
  }
  float s = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f;
  int idx = 0, off = 0;
#pragma unroll
  for (int L = 1; L <= LMAX; ++L) {
#pragma unroll
    for (int m = 0; m <= L; ++m) {
      float q = 0.0f, qd = 0.0f;
#pragma unroll
      for (int k = 0; k <= L; ++k) {
        const float cc = ztab[off + m * (L + 1) + k];
        q += cc * zp[k];
        if (k > 0) qd += cc * (float)k * zp[k - 1];
      }
      if (m == 0) {
        s += bp[idx] * q;
        az += b[idx] * qd;
        ++idx;
      } else {
        const float mf = (float)m;
        s += bp[idx] * q * cr[m];
        ax += b[idx] * q * mf * cr[m - 1];
        ay -= b[idx] * q * mf * ci[m - 1];
        az += b[idx] * qd * cr[m];
        ++idx;
        s += bp[idx] * q * ci[m];
        ax += b[idx] * q * mf * ci[m - 1];
        ay += b[idx] * q * mf * cr[m - 1];
        az += b[idx] * qd * ci[m];
        ++idx;
      }
    }
    off += (L + 1) * (L + 1);
  }
  *sval = s;
  *gx = ax;
  *gy = ay;
  *gz = az;
}

static inline NepConsts gk_consts(const float* rc_r, const float* rc_a,
                                  const float* c_ang, const float* znum,
                                  const float* rcov, const float* flex,
                                  const float* ztab, int T, int kr1, int na1,
                                  int ka1, int l_max, int zbl_mode,
                                  float rc_inner, float rc_outer,
                                  float factor) {
  NepConsts c;
  c.rc_r = rc_r; c.rc_a = rc_a; c.c_ang = c_ang; c.znum = znum;
  c.rcov = rcov; c.flex = flex; c.ztab = ztab;
  c.T = T; c.kr1 = kr1; c.na1 = na1; c.ka1 = ka1; c.l_max = l_max;
  c.zbl_mode = zbl_mode;
  c.zbl_rc_inner = rc_inner; c.zbl_rc_outer = rc_outer;
  c.zbl_factor = factor;
  return c;
}
