// K1b, K2b, K1, K2: the dense-window NEP engines' pair kernels.
//
// Replace the TPU kernels of gpumd_tpu/engine/nep_dense.py:
//   _k1b_kernel (k1b_call)  round 2: per cell, the descriptor sums of its
//                           cap centres against its packed candidates
//   _k2b_kernel (k2b_call)  its VJP: centre and candidate cotangents
//   _k1_kernel  (k1_call)   round 1: the same sums, candidates read from
//                           the nine (dz, dy) ghost rows of the cell
//   _k2_kernel  (k2_call)   its VJP as the (27, 3cap) tiles of the cell
// Both rounds evaluate the same pair (the TPU's _tile_chunk): the 27 cap
// candidates of round 1 are round 2's first 27 cap lanes, in order, so one
// forward and one backward kernel serve both, DenseGeom.v1 choosing where
// they read and write.  Per centre i and candidate j, with u = r/d:
//   S[i, t_j k]      += f_k(d; (rc_r[t_i] + rc_r[t_j])/2)
//   S[i, zbl]        += universal ZBL pair energy (halved), d < rc_outer
//   A[i, t_j k, lm]  += f_k(d; (rc_a[t_i] + rc_a[t_j])/2) Y_lm(u)
// A is not contracted with c_angular here (the middle does it).  A pair
// adds exact zeros when d^2 <= 1e-6 (self, parked slot), when the
// candidate's type code names no type (parked: -1), or beyond every
// cutoff, so the kernels skip such pairs; the plain versions evaluate them.
//
// The gradient (the TPU kernels took jax.vjp / jax.grad in the kernel) is
// derived by hand: p_ij = dL/dr_ij =
//   u (sum_k cot_S[t_j k] f'_k + cot_S[zbl] dE_zbl/dd)
//   + u sum_lm b'_lm Y_lm + (G - u (u.G)) / d,
// b_lm = sum_k cot_A[t_j k, lm] f_k, b'_lm likewise with f'_k,
// G = sum_lm b_lm dY_lm/du; dcand_j = sum_i p_ij, dcenter_i = -sum_j p_ij.
// The plain versions differentiate the tile forward with torch.autograd.
//
// What bounds them on the H100: bytes, if the pair test were free.  A
// cell's candidates are ~19x the pairs inside the radial cutoff (27 cells
// of >= rc + skin around a sphere of rc), ~200x those inside the angular
// one, so each kernel spends most of its time testing dead pairs.  Design:
// one block of 256 threads per cell.
//   forward: the cell's 4 x C candidates staged in shared memory; one
//   warp per centre walks them 32 at a time; the live lanes stage f_k,
//   the ZBL energy and Y_lm in a per-lane row, and the warp adds the rows
//   into the centre's accumulators (lane-owned columns, ascending source
//   lane: deterministic, no atomics), written once per centre.
//   backward: the cell's centres and cotangents staged in shared memory;
//   one thread per candidate lane owns its dcand (registers, no atomics)
//   and walks the cap centres; the centre gradients are warp-reduced into
//   per-warp shared partials and summed in a fixed order.
#include "nep_common.cuh"

#define DK_THREADS 256
#define DK_WARPS (DK_THREADS / 32)
#define DK_FULL 0xffffffffu

struct DenseGeom {
  int nx, ny, nz, cap;
  int C;    // candidate lanes of a cell (round 1: 27 cap)
  bool v1;  // round-1 layouts
};

// Candidate lane q of cell (x, y, z), channel ch.  Round 2: packed
// (cell, 4, C); round 1: lane q = r 3cap + l of ghost row r = 3 dz + dy.
__device__ __forceinline__ float dk_cand(const float* src, const DenseGeom& g,
                                         int cell, int x, int y, int z,
                                         int ch, int q) {
  if (!g.v1) return src[((size_t)cell * 4 + ch) * g.C + q];
  const int c3 = 3 * g.cap;
  const int r = q / c3, l = q - r * c3;
  const int dz = r / 3, dy = r - 3 * dz;
  const size_t row = ((size_t)(z + dz) * (g.ny + 2) + (y + dy)) * 4 + ch;
  return src[row * (size_t)((g.nx + 2) * g.cap) + (size_t)x * g.cap + l];
}

// Centre slot i, channel ch: (cell, 4, cap), or the middle ghost row.
__device__ __forceinline__ float dk_center(const float* src,
                                           const DenseGeom& g, int cell,
                                           int x, int y, int z, int ch,
                                           int i) {
  if (!g.v1) return src[((size_t)cell * 4 + ch) * g.cap + i];
  const size_t row = ((size_t)(z + 1) * (g.ny + 2) + (y + 1)) * 4 + ch;
  return src[row * (size_t)((g.nx + 2) * g.cap) + (size_t)(x + 1) * g.cap + i];
}

// Element (channel ch, slot i, lm) of A or its cotangent: round 2
// channel-leading (cell, ch_a, cap, nlm), round 1 (cell, cap, ch_a nlm).
__device__ __forceinline__ size_t dk_aidx(const DenseGeom& g, int cell,
                                          int ch_a, int nlm, int ch, int i,
                                          int lm) {
  return g.v1 ? (((size_t)cell * g.cap + i) * ch_a + ch) * nlm + lm
              : (((size_t)cell * ch_a + ch) * g.cap + i) * nlm + lm;
}

struct DkPair {
  float d, inv_d, rcp_r, rcp_a;
  int tjx;
  bool lr, la;  // inside the radial (or ZBL) / the angular cutoff
};

// The dense tile's pair: false when it adds exact zeros.
__device__ __forceinline__ bool dk_pair(const NepConsts& c, float dx,
                                        float dy, float dz, float rc_ri,
                                        float rc_ai, float tj, DkPair* p) {
  const float d2 = dx * dx + dy * dy + dz * dz;
  if (!(d2 > GK_EPS2) || !gk_type_valid(tj, c.T)) return false;
  p->tjx = gk_type_index(tj, c.T);
  p->inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
  p->d = d2 * p->inv_d;
  p->rcp_r = 0.5f * (rc_ri + c.rc_r[p->tjx]);
  p->rcp_a = 0.5f * (rc_ai + c.rc_a[p->tjx]);
  p->lr = p->d < p->rcp_r || (c.zbl_mode && p->d < c.zbl_rc_outer);
  p->la = p->d < p->rcp_a;
  return p->lr || p->la;
}

// Forward: s_out (cell, cap, s_width); a_out channel-leading (round 2) or
// (cell, cap, ch_a nlm) (round 1).  Round 1 passes the ghost rows as both
// `centers` and `cand`.
template <int LMAX>
__global__ void __launch_bounds__(DK_THREADS)
dense_fwd_kernel(const float* __restrict__ centers,
                 const float* __restrict__ cand, float* __restrict__ s_out,
                 float* __restrict__ a_out, NepConsts c, DenseGeom g,
                 int ztab_n) {
  constexpr int NLM = LMAX * (LMAX + 2);
  extern __shared__ float sm[];
  const int T = c.T, kr1 = c.kr1, ka1 = c.ka1;
  const int sr = T * kr1, sw = sr + 1, na = T * ka1 * NLM;
  const int stride = (2 + kr1 + ka1 + NLM) | 1;
  const int C = g.C, cap = g.cap;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = sm;                // (4, C) candidates
  float* zt = cs + 4 * C;        // Y_lm z-coefficients
  float* acc_a = zt + ztab_n + warp * (na + sw + 32 * stride);  // (ch_a, NLM)
  float* acc_s = acc_a + na;     // (s_width)
  float* st = acc_s + sw;        // (32, stride) staged pair rows
  const int cell = blockIdx.x;
  const int x = cell % g.nx, y = (cell / g.nx) % g.ny;
  const int z = cell / (g.nx * g.ny);

  for (int e = threadIdx.x; e < 4 * C; e += blockDim.x) {
    const int ch = e / C;
    cs[e] = dk_cand(cand, g, cell, x, y, z, ch, e - ch * C);
  }
  for (int e = threadIdx.x; e < ztab_n; e += blockDim.x) zt[e] = c.ztab[e];
  __syncthreads();

  // staged row: [t_j, ez, f_r (kr1), f_a (ka1), Y (NLM)]
  float* my = st + lane * stride;
  for (int i = warp; i < cap; i += DK_WARPS) {
    const float cx = dk_center(centers, g, cell, x, y, z, 0, i);
    const float cy = dk_center(centers, g, cell, x, y, z, 1, i);
    const float cz = dk_center(centers, g, cell, x, y, z, 2, i);
    const float ct = dk_center(centers, g, cell, x, y, z, 3, i);
    const int ti = gk_type_index(ct, T);
    const float rc_ri = c.rc_r[ti], rc_ai = c.rc_a[ti];
    for (int e = lane; e < na; e += 32) acc_a[e] = 0.0f;
    for (int e = lane; e < sw; e += 32) acc_s[e] = 0.0f;
    for (int j0 = 0; j0 < C; j0 += 32) {
      const int j = j0 + lane;
      bool lr = false, la = false;
      if (j < C) {
        const float dx = cs[j] - cx, dy = cs[C + j] - cy;
        const float dz = cs[2 * C + j] - cz, tj = cs[3 * C + j];
        DkPair p;
        if (dk_pair(c, dx, dy, dz, rc_ri, rc_ai, tj, &p)) {
          lr = p.lr;
          la = p.la;
          my[0] = (float)p.tjx;
          if (lr) {
            gk_cheb(p.d, p.rcp_r, kr1, my + 2, nullptr);
            float ez = 0.0f;
            if (c.zbl_mode) gk_zbl(c, p.d, p.inv_d, ct, tj, &ez, nullptr);
            my[1] = ez;
          }
          if (la) {
            gk_cheb(p.d, p.rcp_a, ka1, my + 2 + kr1, nullptr);
            gk_ylm<LMAX>(dx * p.inv_d, dy * p.inv_d, dz * p.inv_d, zt,
                         my + 2 + kr1 + ka1);
          }
        }
      }
      unsigned mr = __ballot_sync(DK_FULL, lr);
      unsigned ma = __ballot_sync(DK_FULL, la);
      __syncwarp();
      while (mr) {
        const float* sp = st + (__ffs(mr) - 1) * stride;
        mr &= mr - 1;
        const int ts = (int)sp[0];
        for (int e = lane; e < sw; e += 32) {
          const int t = e / kr1;
          acc_s[e] += e == sr ? sp[1] : (t == ts ? sp[2 + e - t * kr1] : 0.0f);
        }
      }
      while (ma) {
        const float* sp = st + (__ffs(ma) - 1) * stride;
        ma &= ma - 1;
        const float* fa = sp + 2 + kr1;
        float* ap = acc_a + (int)sp[0] * ka1 * NLM;
        for (int lm = lane; lm < NLM; lm += 32) {
          const float yv = fa[ka1 + lm];
          for (int k = 0; k < ka1; ++k) ap[k * NLM + lm] += fa[k] * yv;
        }
      }
      __syncwarp();
    }
    float* so = s_out + ((size_t)cell * cap + i) * sw;
    for (int e = lane; e < sw; e += 32) so[e] = acc_s[e];
    for (int e = lane; e < na; e += 32) {
      const int ch = e / NLM;
      a_out[dk_aidx(g, cell, T * ka1, NLM, ch, i, e - ch * NLM)] = acc_a[e];
    }
    __syncwarp();
  }
}

// Backward: cot_s as s, cot_a as a.  Round 2: dcen_out (cell, 3, cap),
// dcand_out (cell, 3, C).  Round 1: dcand_out the (cell, 27, 3cap) tiles,
// the centre gradients added into rows 12 + k, lanes cap + i.
template <int LMAX>
__global__ void __launch_bounds__(DK_THREADS)
dense_bwd_kernel(const float* __restrict__ centers,
                 const float* __restrict__ cand,
                 const float* __restrict__ cot_s,
                 const float* __restrict__ cot_a, float* __restrict__ dcen_out,
                 float* __restrict__ dcand_out, NepConsts c, DenseGeom g,
                 int ztab_n) {
  constexpr int NLM = LMAX * (LMAX + 2);
  extern __shared__ float sm[];
  const int T = c.T, kr1 = c.kr1, ka1 = c.ka1, ch_a = T * ka1;
  const int sr = T * kr1, sw = sr + 1;
  const int C = g.C, cap = g.cap, c3 = 3 * cap;
  const size_t chs = (size_t)cap * NLM;  // channel stride of ca
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cen = sm;                     // (4, cap)
  float* cs = cen + 4 * cap;           // (cap, s_width)
  float* ca = cs + cap * sw;           // (ch_a, cap, NLM)
  float* zt = ca + ch_a * chs;
  float* dc = zt + ztab_n;             // (warps, 3, cap) centre partials
  const int cell = blockIdx.x;
  const int x = cell % g.nx, y = (cell / g.nx) % g.ny;
  const int z = cell / (g.nx * g.ny);

  for (int e = threadIdx.x; e < 4 * cap; e += blockDim.x) {
    const int ch = e / cap;
    cen[e] = dk_center(centers, g, cell, x, y, z, ch, e - ch * cap);
  }
  for (int e = threadIdx.x; e < cap * sw; e += blockDim.x)
    cs[e] = cot_s[(size_t)cell * cap * sw + e];
  for (int e = threadIdx.x; e < ch_a * (int)chs; e += blockDim.x) {
    const int ch = e / (int)chs, rem = e - ch * (int)chs;
    const int i = rem / NLM;
    ca[e] = cot_a[dk_aidx(g, cell, ch_a, NLM, ch, i, rem - i * NLM)];
  }
  for (int e = threadIdx.x; e < ztab_n; e += blockDim.x) zt[e] = c.ztab[e];
  for (int e = threadIdx.x; e < DK_WARPS * 3 * cap; e += blockDim.x)
    dc[e] = 0.0f;
  __syncthreads();

  float f[GK_MAXK], fp[GK_MAXK], bl[NLM], bpl[NLM];
  const int n_iter = (C + blockDim.x - 1) / blockDim.x;
  for (int it = 0; it < n_iter; ++it) {
    const int j = it * blockDim.x + threadIdx.x;
    const bool valid = j < C;
    float wx = 0.0f, wy = 0.0f, wz = 0.0f, tj = -1.0f;
    if (valid) {
      wx = dk_cand(cand, g, cell, x, y, z, 0, j);
      wy = dk_cand(cand, g, cell, x, y, z, 1, j);
      wz = dk_cand(cand, g, cell, x, y, z, 2, j);
      tj = dk_cand(cand, g, cell, x, y, z, 3, j);
    }
    float gj[3] = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < cap; ++i) {
      float p[3] = {0.0f, 0.0f, 0.0f};
      const float ct = cen[3 * cap + i];
      const int ti = gk_type_index(ct, T);
      const float dx = wx - cen[i], dy = wy - cen[cap + i];
      const float dz = wz - cen[2 * cap + i];
      DkPair pr;
      const bool live =
          valid && dk_pair(c, dx, dy, dz, c.rc_r[ti], c.rc_a[ti], tj, &pr);
      if (live) {
        const float u[3] = {dx * pr.inv_d, dy * pr.inv_d, dz * pr.inv_d};
        if (pr.lr) {
          gk_cheb(pr.d, pr.rcp_r, kr1, f, fp);
          const float* cr = cs + i * sw + pr.tjx * kr1;
          float sig = 0.0f;
          for (int k = 0; k < kr1; ++k) sig += cr[k] * fp[k];
          if (c.zbl_mode) {
            float e, dedd;
            gk_zbl(c, pr.d, pr.inv_d, ct, tj, &e, &dedd);
            sig += cs[i * sw + sr] * dedd;
          }
#pragma unroll
          for (int q = 0; q < 3; ++q) p[q] += sig * u[q];
        }
        if (pr.la) {
          gk_cheb(pr.d, pr.rcp_a, ka1, f, fp);
          const float* cp = ca + (size_t)pr.tjx * ka1 * chs + (size_t)i * NLM;
#pragma unroll
          for (int lm = 0; lm < NLM; ++lm) {
            float b = 0.0f, bp = 0.0f;
            for (int k = 0; k < ka1; ++k) {
              const float v = cp[k * chs + lm];
              b += v * f[k];
              bp += v * fp[k];
            }
            bl[lm] = b;
            bpl[lm] = bp;
          }
          float sval, gx, gy, gz;
          gk_ylm_vjp<LMAX>(u[0], u[1], u[2], zt, bl, bpl, &sval, &gx, &gy,
                           &gz);
          const float gv[3] = {gx, gy, gz};
          const float ug = u[0] * gx + u[1] * gy + u[2] * gz;
#pragma unroll
          for (int q = 0; q < 3; ++q)
            p[q] += sval * u[q] + (gv[q] - u[q] * ug) * pr.inv_d;
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) gj[q] += p[q];
      if (__any_sync(DK_FULL, live)) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float v = p[q];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(DK_FULL, v, o);
          if (lane == 0) dc[(warp * 3 + q) * cap + i] -= v;
        }
      }
    }
    if (valid) {
      if (g.v1) {
        const int r = j / c3, l = j - r * c3;
        float* gp = dcand_out + ((size_t)cell * 27 + r * 3) * c3 + l;
#pragma unroll
        for (int q = 0; q < 3; ++q) gp[q * c3] = gj[q];
      } else {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          dcand_out[((size_t)cell * 3 + q) * C + j] = gj[q];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * cap; e += blockDim.x) {
    const int q = e / cap, i = e - q * cap;
    float v = 0.0f;
    for (int w = 0; w < DK_WARPS; ++w) v += dc[(w * 3 + q) * cap + i];
    if (g.v1)
      dcand_out[((size_t)cell * 27 + 12 + q) * c3 + cap + i] += v;
    else
      dcen_out[((size_t)cell * 3 + q) * cap + i] = v;
  }
}

template <int LMAX>
static int fwd_run(const float* centers, const float* cand, float* s,
                   float* a, NepConsts c, DenseGeom g, int ztab_n,
                   cudaStream_t stream) {
  constexpr int NLM = LMAX * (LMAX + 2);
  const int stride = (2 + c.kr1 + c.ka1 + NLM) | 1;
  const size_t smem =
      sizeof(float) * ((size_t)4 * g.C + ztab_n +
                       (size_t)DK_WARPS * (c.T * c.ka1 * NLM + c.T * c.kr1 +
                                           1 + 32 * stride));
  cudaFuncSetAttribute(dense_fwd_kernel<LMAX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dense_fwd_kernel<LMAX><<<g.nx * g.ny * g.nz, DK_THREADS, smem, stream>>>(
      centers, cand, s, a, c, g, ztab_n);
  return (int)cudaGetLastError();
}

template <int LMAX>
static int bwd_run(const float* centers, const float* cand, const float* cot_s,
                   const float* cot_a, float* dcen, float* dcand, NepConsts c,
                   DenseGeom g, int ztab_n, cudaStream_t stream) {
  constexpr int NLM = LMAX * (LMAX + 2);
  const size_t smem =
      sizeof(float) *
      ((size_t)g.cap * (4 + c.T * c.kr1 + 1 + c.T * c.ka1 * NLM) + ztab_n +
       (size_t)DK_WARPS * 3 * g.cap);
  cudaFuncSetAttribute(dense_bwd_kernel<LMAX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dense_bwd_kernel<LMAX><<<g.nx * g.ny * g.nz, DK_THREADS, smem, stream>>>(
      centers, cand, cot_s, cot_a, dcen, dcand, c, g, ztab_n);
  return (int)cudaGetLastError();
}

static int fwd(const float* centers, const float* cand, float* s, float* a,
               NepConsts c, DenseGeom g, int ztab_n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define DK_FWD(L) return fwd_run<L>(centers, cand, s, a, c, g, ztab_n, st)
  switch (c.l_max) {
    case 1: DK_FWD(1);
    case 2: DK_FWD(2);
    case 3: DK_FWD(3);
    case 4: DK_FWD(4);
    case 5: DK_FWD(5);
    case 6: DK_FWD(6);
    case 7: DK_FWD(7);
    case 8: DK_FWD(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DK_FWD
}

static int bwd(const float* centers, const float* cand, const float* cot_s,
               const float* cot_a, float* dcen, float* dcand, NepConsts c,
               DenseGeom g, int ztab_n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define DK_BWD(L) \
  return bwd_run<L>(centers, cand, cot_s, cot_a, dcen, dcand, c, g, ztab_n, st)
  switch (c.l_max) {
    case 1: DK_BWD(1);
    case 2: DK_BWD(2);
    case 3: DK_BWD(3);
    case 4: DK_BWD(4);
    case 5: DK_BWD(5);
    case 6: DK_BWD(6);
    case 7: DK_BWD(7);
    case 8: DK_BWD(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DK_BWD
}

static NepConsts dk_consts(const float* rc_r, const float* rc_a,
                           const float* znum, const float* ztab, int T,
                           int kr1, int ka1, int l_max, int zbl,
                           float rc_inner, float rc_outer) {
  return gk_consts(rc_r, rc_a, nullptr, znum, nullptr, nullptr, ztab, T, kr1,
                   0, ka1, l_max, zbl ? 1 : 0, rc_inner, rc_outer, 0.0f);
}

static DenseGeom dk_geom(int nx, int ny, int nz, int cap, int C, bool v1) {
  DenseGeom g;
  g.nx = nx; g.ny = ny; g.nz = nz; g.cap = cap; g.C = C; g.v1 = v1;
  return g;
}

extern "C" int dense_k1b_launch(const float* centers, const float* cand,
                                float* s, float* a, const float* rc_r,
                                const float* rc_a, const float* znum,
                                const float* ztab, int nx, int ny, int nz,
                                int cap, int C, int T, int kr1, int ka1,
                                int l_max, int zbl, int ztab_n,
                                float rc_inner, float rc_outer,
                                void* stream) {
  return fwd(centers, cand, s, a,
             dk_consts(rc_r, rc_a, znum, ztab, T, kr1, ka1, l_max, zbl,
                       rc_inner, rc_outer),
             dk_geom(nx, ny, nz, cap, C, false), ztab_n, stream);
}

extern "C" int dense_k2b_launch(const float* centers, const float* cand,
                                const float* cot_s, const float* cot_a,
                                float* dcen, float* dcand, const float* rc_r,
                                const float* rc_a, const float* znum,
                                const float* ztab, int nx, int ny, int nz,
                                int cap, int C, int T, int kr1, int ka1,
                                int l_max, int zbl, int ztab_n,
                                float rc_inner, float rc_outer,
                                void* stream) {
  return bwd(centers, cand, cot_s, cot_a, dcen, dcand,
             dk_consts(rc_r, rc_a, znum, ztab, T, kr1, ka1, l_max, zbl,
                       rc_inner, rc_outer),
             dk_geom(nx, ny, nz, cap, C, false), ztab_n, stream);
}

extern "C" int dense_k1_launch(const float* garr, float* s, float* a,
                               const float* rc_r, const float* rc_a,
                               const float* znum, const float* ztab, int nx,
                               int ny, int nz, int cap, int T, int kr1,
                               int ka1, int l_max, int zbl, int ztab_n,
                               float rc_inner, float rc_outer, void* stream) {
  return fwd(garr, garr, s, a,
             dk_consts(rc_r, rc_a, znum, ztab, T, kr1, ka1, l_max, zbl,
                       rc_inner, rc_outer),
             dk_geom(nx, ny, nz, cap, 27 * cap, true), ztab_n, stream);
}

extern "C" int dense_k2_launch(const float* garr, const float* cot_s,
                               const float* cot_a, float* tiles,
                               const float* rc_r, const float* rc_a,
                               const float* znum, const float* ztab, int nx,
                               int ny, int nz, int cap, int T, int kr1,
                               int ka1, int l_max, int zbl, int ztab_n,
                               float rc_inner, float rc_outer, void* stream) {
  return bwd(garr, garr, cot_s, cot_a, nullptr, tiles,
             dk_consts(rc_r, rc_a, znum, ztab, T, kr1, ka1, l_max, zbl,
                       rc_inner, rc_outer),
             dk_geom(nx, ny, nz, cap, 27 * cap, true), ztab_n, stream);
}
