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

// _cheb: f_0 = fc, f_k = (T_k(x) + 1)/2 fc, and optionally df_k/dd.  KMAX
// bounds k1 at compile time: with it the caller's f/fp arrays, indexed by
// unrolled constants, stay in registers.  cos(pi x) and sin(pi x) are
// cospif/sinpif here and in gk_zbl: their range reduction is exact, where
// cosf's slow path for huge arguments keeps a 28-byte array on the stack.
template <int KMAX = GK_MAXK>
__device__ __forceinline__ void gk_cheb(float d, float rcp, int k1, float* f,
                                        float* fp) {
  const float x_rc = d / rcp;
  const bool in = x_rc < 1.0f;
  float sn = 0.0f, cs;
  if (fp) sincospif(x_rc, &sn, &cs);
  else cs = cospif(x_rc);
  const float fc = in ? 0.5f * cs + 0.5f : 0.0f;
  const float x = fminf(fmaxf(2.0f * (x_rc - 1.0f) * (x_rc - 1.0f) - 1.0f,
                              -1.0f), 1.0f);
  float fcp = 0.0f, dxdd = 0.0f;
  f[0] = fc;
  if (fp) {
    fcp = in ? -0.5f * GK_PI / rcp * sn : 0.0f;
    dxdd = 4.0f * (x_rc - 1.0f) / rcp;
    fp[0] = fcp;
  }
  float t_prev = 1.0f, t_cur = x, tp_prev = 0.0f, tp_cur = 1.0f;
  if (k1 > 1) {
    f[1] = 0.5f * (t_cur + 1.0f) * fc;
    if (fp) fp[1] = 0.5f * ((t_cur + 1.0f) * fcp + tp_cur * dxdd * fc);
  }
#pragma unroll
  for (int k = 2; k < KMAX; ++k) {
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

// g_n = sum_k cp[n k1 + k] f_k (and g'_n from f'_k when gnp is given), the
// basis of gk_cheb formed term by term in the same order, so no per-k array
// is live.  NMAX bounds k1 and n1 at compile time.
template <int NMAX>
__device__ __forceinline__ void gk_cheb_gn(float d, float rcp, int k1,
                                           const float* __restrict__ cp,
                                           int n1, float* gn, float* gnp) {
  const float x_rc = d / rcp;
  const bool in = x_rc < 1.0f;
  float sn = 0.0f, cs;
  if (gnp) sincospif(x_rc, &sn, &cs);
  else cs = cospif(x_rc);
  const float fc = in ? 0.5f * cs + 0.5f : 0.0f;
  const float x = fminf(fmaxf(2.0f * (x_rc - 1.0f) * (x_rc - 1.0f) - 1.0f,
                              -1.0f), 1.0f);
  float fcp = 0.0f, dxdd = 0.0f;
  if (gnp) {
    fcp = in ? -0.5f * GK_PI / rcp * sn : 0.0f;
    dxdd = 4.0f * (x_rc - 1.0f) / rcp;
  }
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    gn[n] = 0.0f;
    if (gnp) gnp[n] = 0.0f;
  }
  float t_prev = 1.0f, t_cur = x, tp_prev = 0.0f, tp_cur = 1.0f;
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < k1) {
      float fk = fc, fpk = fcp;
      if (k >= 2) {
        const float t_new = 2.0f * x * t_cur - t_prev;
        const float tp_new = 2.0f * t_cur + 2.0f * x * tp_cur - tp_prev;
        t_prev = t_cur;
        t_cur = t_new;
        tp_prev = tp_cur;
        tp_cur = tp_new;
      }
      if (k >= 1) {
        fk = 0.5f * (t_cur + 1.0f) * fc;
        if (gnp) fpk = 0.5f * ((t_cur + 1.0f) * fcp + tp_cur * dxdd * fc);
      }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < n1) {
          const float cc = __ldg(cp + n * k1 + k);
          gn[n] += cc * fk;
          if (gnp) gnp[n] += cc * fpk;
        }
      }
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
                 : (d < rc2 ? 0.5f * cospif(frac) + 0.5f : 0.0f);
  *e_out = pref * inv_d * phi * sw;
  if (dedd_out) {
    const float swp = (d >= rc1 && d < rc2)
                          ? -0.5f * GK_PI / span * sinpif(frac) : 0.0f;
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

// gk_ylm_vjp with b_lm = sum_n cot[n, lm] g_n and b'_lm = sum_n cot[n, lm]
// g'_n formed as each lm is reached (no b/b' arrays): cot[n sn + lm sl] is
// the centre's cotangent channel n at lm, in shared memory (K2: a column,
// sn = NLM ld, sl = ld) or in device memory (the dense K2s: a row, sl 1).
template <int LMAX, int NMAX>
__device__ __forceinline__ void gk_ylm_vjp_cot(
    float ux, float uy, float uz, const float* ztab, const float* cot, int sn,
    int sl, const float* gn, const float* gnp, int n1, float* sval,
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
  auto contract = [&](int lm, float* b, float* bp) {
    float v = 0.0f, vp = 0.0f;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < n1) {
        const float cc = cot[n * sn + lm * sl];
        v += cc * gn[n];
        vp += cc * gnp[n];
      }
    }
    *b = v;
    *bp = vp;
  };
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
      float b, bp;
      contract(idx, &b, &bp);
      if (m == 0) {
        s += bp * q;
        az += b * qd;
        ++idx;
      } else {
        const float mf = (float)m;
        s += bp * q * cr[m];
        ax += b * q * mf * cr[m - 1];
        ay -= b * q * mf * ci[m - 1];
        az += b * qd * cr[m];
        ++idx;
        contract(idx, &b, &bp);
        s += bp * q * ci[m];
        ax += b * q * mf * ci[m - 1];
        ay += b * q * mf * cr[m - 1];
        az += b * qd * ci[m];
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

// ---------------------------------------------------------------------------
// Live centres and the live-pair queue of one grid block (K1, K2).
//
// A block's a_pad centre lanes hold ~half real atoms (the rest are empty
// cell slots and lane padding at FAR with type -1), and of each live
// centre's mn_a angular slots only the pairs inside 0.5 (rc_a[ti] +
// rc_a[tj]) add non-zero terms.  The kernels list the live centres, mark
// the live angular slots of each in a bit mask, and lay the marked pairs
// out as one queue ordered by (centre, slot): centre c owns positions
// off[c] .. off[c+1] - 1.  The queue is cut into chunks of whole centres
// whose pair count and centre count fit the kernel's shared buffers; each
// chunk is processed one pair a thread, then each centre sums its own
// contiguous segment in slot order.  Every step is a prefix sum or a fixed
// order, so two calls give the same bits.
// ---------------------------------------------------------------------------

#define GK_FULL 0xffffffffu
#define GK_BLOCK 256          // threads a block of K1 and K2
#define GK_BATCH 4            // slots whose loads a thread issues together
#define GK_FAR_HALF 5.0e4f    // half of grid.FAR, where empty slots sit

// Bookkeeping words in shared memory (int32), laid out by gk_live_views.
struct GkLive {
  int* lane_of;    // (a_pad) lane of live centre c
  int* c_of;       // (a_pad) live index of lane a, -1 for a dead lane
  unsigned* mask;  // (a_pad, mw) bit m: slot m of centre c is queued
  int* off;        // (a_pad + 1) first queue position of centre c
  int* chunk;      // (a_pad + 1) first centre of chunk k, then nlive
  int* counts;     // [0] live centres, [1] chunks
};

__device__ __forceinline__ GkLive gk_live_views(int* base, int a_pad,
                                                int mw) {
  GkLive s;
  s.lane_of = base;
  s.c_of = base + a_pad;
  s.mask = reinterpret_cast<unsigned*>(base + 2 * a_pad);
  s.off = base + 2 * a_pad + a_pad * mw;
  s.chunk = s.off + a_pad + 1;
  s.counts = s.chunk + a_pad + 1;
  return s;
}

// A dead centre lane (empty slot, lane padding) is at FAR with type -1;
// every pair of it adds exact zeros.
__device__ __forceinline__ bool gk_centre_live(float cx, float ct) {
  return !(ct <= -0.5f && cx >= GK_FAR_HALF);
}

// Warp 0: the live centre list of the block's centres cb (4, a_pad).
__device__ __forceinline__ void gk_live_lanes(const float* cb, int a_pad,
                                              GkLive s) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int a0 = 0; a0 < a_pad; a0 += 32) {
    const int a = a0 + lane;
    const bool live = gk_centre_live(cb[a], cb[3 * a_pad + a]);
    const unsigned bal = __ballot_sync(GK_FULL, live);
    const int pos = carry + __popc(bal & ((1u << lane) - 1u));
    s.c_of[a] = live ? pos : -1;
    if (live) s.lane_of[pos] = a;
    carry += __popc(bal);
  }
  if (lane == 0) s.counts[0] = carry;
}

// An angular slot that adds non-zero terms: a live pair (d^2 > eps, type
// code not -1) of valid types inside its cutoff, tested as gk_cheb tests
// it (every other slot gives fc = f' = 0 exactly).
__device__ __forceinline__ bool gk_ang_live(const NepConsts& c, float dx,
                                            float dy, float dz, float tj,
                                            int ti, bool ti_ok) {
  const float d2 = dx * dx + dy * dy + dz * dz;
  if (!(d2 > GK_EPS2 && tj > -0.5f) || !ti_ok || !gk_type_valid(tj, c.T))
    return false;
  const float inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
  const float d = d2 * inv_d;
  const int tjx = gk_type_index(tj, c.T);
  return d / (0.5f * (c.rc_a[ti] + c.rc_a[tjx])) < 1.0f;
}

// One warp, once the masks are complete: off[c] = the set bits of the mw
// mask words of centres 0 .. c - 1, for c in [0, n].
__device__ __forceinline__ void gk_offsets(const unsigned* mask, int mw,
                                           int n, int* off) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    int cnt = 0;
    if (c < n)
      for (int w = 0; w < mw; ++w) cnt += __popc(mask[c * mw + w]);
    int incl = cnt;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int v = __shfl_up_sync(GK_FULL, incl, sh);
      if (lane >= sh) incl += v;
    }
    if (c < n) off[c] = carry + incl - cnt;
    carry += __shfl_sync(GK_FULL, incl, 31);
  }
  if (lane == 0) off[n] = carry;
  __syncwarp();
}

// Warp 0, once the masks are complete: queue offsets and chunks.  A centre
// starts a chunk when its first queue position crosses a multiple of qcap
// or its index a multiple of ccap, so a chunk holds at most ccap centres
// and fewer than qcap + mn_a pairs.
__device__ __forceinline__ void gk_queue_offsets(GkLive s, int mw, int qcap,
                                                 int ccap) {
  const int lane = threadIdx.x & 31;
  const int nlive = s.counts[0];
  gk_offsets(s.mask, mw, nlive, s.off);
  int nch = 0, prev_q = -1, prev_c = -1;
  for (int c0 = 0; c0 < nlive; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < nlive;
    const int kq = in ? s.off[c] / qcap : 0, kc = c / ccap;
    int pq = __shfl_up_sync(GK_FULL, kq, 1);
    int pc = __shfl_up_sync(GK_FULL, kc, 1);
    if (lane == 0) {
      pq = prev_q;
      pc = prev_c;
    }
    const bool first = in && (kq != pq || kc != pc);
    const unsigned bal = __ballot_sync(GK_FULL, first);
    if (first) s.chunk[nch + __popc(bal & ((1u << lane) - 1u))] = c;
    nch += __popc(bal);
    prev_q = __shfl_sync(GK_FULL, kq, 31);
    prev_c = __shfl_sync(GK_FULL, kc, 31);
  }
  if (lane == 0) {
    s.chunk[nch] = nlive;
    s.counts[1] = nch;
  }
}

// The centre that owns queue position q: the largest c in [lo, hi) with
// off[c] <= q.
__device__ __forceinline__ int gk_owner(const int* off, int lo, int hi,
                                        int q) {
  hi -= 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= q) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The slot of a centre's r-th queued pair: the r-th set bit of its mask.
__device__ __forceinline__ int gk_nth_slot(const unsigned* mk, int r) {
  int w = 0;
  unsigned bits = mk[0];
  for (int pc = __popc(bits); r >= pc; pc = __popc(bits)) {
    r -= pc;
    bits = mk[++w];
  }
  for (int i = 0; i < r; ++i) bits &= bits - 1u;
  return w * 32 + __ffs(bits) - 1;
}

// Threads a live centre in K2's radial stage: P adjacent threads split its
// slots (m = part, part + P, ...), so short live lists still fill the
// block; with nlive <= GK_BLOCK every unit runs in one round.
__device__ __forceinline__ int gk_parts(int nlive) {
  return nlive > 0 ? max(1, min(32, GK_BLOCK / nlive)) : 1;
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
