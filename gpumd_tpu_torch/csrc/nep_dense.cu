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
// What bounds them on the H100: bytes (~0.24 / 0.28 ms at PbTe 262k on
// the v2 plan), if the pair test were free.  It is not: a cell's 40 x 1,152
// slots hold ~25 x 64 pairs inside the radial cutoff (5.5%) and ~25 x 6
// inside the angular one (0.5%).  A thread a slot that evaluates its pair
// when live leaves ~1 lane of 32 at work, so the design separates the
// cheap test from the costly pair, as K1/K2 do (nep_k2.cu).  What holds
// it back then is latency: ~a dozen phases a cell between barriers, with
// 3 blocks (24 warps) an SM (80 registers, ~75 KB), at 13-14% of the byte
// bound on an H100 at 700 W (PERF.md §6, probes/ab_dense.py).
//   - one block of 256 threads a cell; the cell's live centres (an empty
//     slot sits at FAR with type -1) and its candidates whose type code
//     names a type are packed, in slot order, into shared memory;
//   - the slot test: a warp tests four centres against 32 packed
//     candidates (d^2, rsqrt, the pair cutoffs: exactly the live set of
//     the tile math) and ballots radial and angular bit mask words;
//   - each mask becomes a queue ordered by (centre, slot): the centres'
//     segment offsets (gk_offsets) and, a centre's words, the set
//     bits before each word; each piece of the queue is expanded into a
//     list of its (centre, candidate) pairs;
//   - the queue runs in pieces, one live pair a thread with full warps:
//     forward, f_k and the ZBL energy (radial) or f_k and Y_lm (angular)
//     into a row of shared memory; backward, p_ij (b_lm and b'_lm formed
//     on the fly from the centre's cot_A row, gk_ylm_vjp_cot);
//   - fixed-order sums, no atomics, so two launches give the same bits:
//     forward, each centre adds its segment's rows in slot order;
//     backward, a warp a centre reduces its
//     segment into dcenter, and a thread a candidate walks the piece's
//     centres in order, finding p_ij's place from the masks; the same f32
//     p_ij goes to both sides;
//   - l_max and a bound KMAX (8 or 20) on kr1/ka1 are template arguments,
//     so every per-pair array is indexed by unrolled constants.
// A window of candidates, a group of centres and a piece of the queue are
// sized by the wrapper (nep_dense.dense_tiling) to fit shared memory: at
// the PbTe plans a cell is one window and one group; wider plans take more
// windows or groups, in a fixed order, and never fail for size.
#include "nep_common.cuh"

#define DK_THREADS 256
#define DK_WARPS (DK_THREADS / 32)
#define DK_FULL 0xffffffffu

struct DenseGeom {
  int nx, ny, nz, cap;
  int C;    // candidate lanes of a cell (round 1: 27 cap)
  bool v1;  // round-1 layouts
};

// How a cell's work is cut (nep_dense.dense_tiling).
struct DkTile {
  int cw;      // candidate lanes a window, a multiple of 32
  int gc;      // live centres a group
  int qr, qa;  // queue positions a piece: radial, angular
  int ztab_n;
};

// Pair rows of the forward pieces, odd strides: [t_j, ez, f_r (kr1)] and
// [t_j, f_a (ka1), Y (NLM)].
__host__ __device__ inline int dk_rowr(int kr1) { return (2 + kr1) | 1; }
__host__ __device__ inline int dk_rowa(int ka1, int nlm) {
  return (1 + ka1 + nlm) | 1;
}

// Shared memory, in 4-byte words (nep_dense._dense_smem_words mirrors it).
struct DkLayout {
  int cl, cen, lane_of, c_of, flag, cjx, dacc, mask, wpre, off, misc, rcp,
      zt, list, buf, words;
};

__host__ __device__ inline DkLayout dk_layout(int cap, int T, int kr1,
                                              int ka1, int nlm,
                                              const DkTile& t, bool bwd) {
  const int capr = (cap + 31) / 32 * 32, nw = t.cw / 32;
  DkLayout L;
  int o = 0;
  L.cl = o;       o += 4 * t.cw;          // float4: packed candidates
  L.cen = o;      o += 4 * capr;          // float4: live centres
  L.lane_of = o;  o += capr;              // slot of live centre c
  L.c_of = o;     o += capr;              // live index of slot i, or -1
  L.flag = o;     o += (bwd ? 3 : 2) * capr;  // fwd: s/a started; bwd: dcen
  L.cjx = o;      o += bwd ? t.cw : 0;    // packed index of a window lane
  L.dacc = o;     o += bwd ? 3 * t.cw : 0;  // (3, cw) candidate sums
  L.mask = o;     o += 2 * t.gc * nw;     // radial, angular bit masks
  L.wpre = o;     o += t.gc * nw;         // 2 x (gc, nw) u16 word prefixes
  L.off = o;      o += 2 * (t.gc + 1);    // radial, angular queue offsets
  L.misc = o;     o += DK_WARPS + 2;
  L.rcp = o;      o += 2 * T * T;         // pair cutoffs, radial, angular
  L.zt = o;       o += t.ztab_n;
  // a piece's pairs: backward, a radial and an angular piece together
  L.list = o;     o += bwd ? t.qr + t.qa : (t.qr > t.qa ? t.qr : t.qa);
  L.buf = o;      // backward: (qr + qa, 3) p_ij; forward: pair rows
  o += bwd ? 3 * (t.qr + t.qa)
           : (t.qr * dk_rowr(kr1) > t.qa * dk_rowa(ka1, nlm)
                  ? t.qr * dk_rowr(kr1) : t.qa * dk_rowa(ka1, nlm));
  L.words = o;
  return L;
}

struct DkShared {
  float4* cl;
  float4* cen;
  int* lane_of;
  int* c_of;
  int* flag;    // forward: [0, capr) s started, [capr, 2 capr) a started
  float* dcen;  // backward: (capr, 3)
  int* cjx;
  float* dacc;
  unsigned* mask_r;
  unsigned* mask_a;
  unsigned short* wpre_r;
  unsigned short* wpre_a;
  int* off_r;  // (gc + 1) radial queue offsets of the group's centres
  int* off_a;  // angular ones
  int* misc;
  float* rcp;
  float* zt;
  int* list;
  float* buf;
};

__device__ __forceinline__ DkShared dk_views(float* sm, const DkLayout& L,
                                             const DkTile& t) {
  int* w = reinterpret_cast<int*>(sm);
  const int gn = t.gc * (t.cw / 32);
  DkShared s;
  s.cl = reinterpret_cast<float4*>(sm + L.cl);
  s.cen = reinterpret_cast<float4*>(sm + L.cen);
  s.lane_of = w + L.lane_of;
  s.c_of = w + L.c_of;
  s.flag = w + L.flag;
  s.dcen = sm + L.flag;
  s.cjx = w + L.cjx;
  s.dacc = sm + L.dacc;
  s.mask_r = reinterpret_cast<unsigned*>(w + L.mask);
  s.mask_a = s.mask_r + gn;
  s.wpre_r = reinterpret_cast<unsigned short*>(w + L.wpre);
  s.wpre_a = s.wpre_r + gn;
  s.off_r = w + L.off;
  s.off_a = s.off_r + t.gc + 1;
  s.misc = w + L.misc;
  s.rcp = sm + L.rcp;
  s.zt = sm + L.zt;
  s.list = w + L.list;
  s.buf = sm + L.buf;
  return s;
}

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
  float dx, dy, dz, d, inv_d, rcp_r, rcp_a;
  int tjx;
  bool lr, la;  // inside the radial (or ZBL) / the angular cutoff
};

// The pair cutoffs of a centre of type index ti: (rc[ti] + rc[tj]) / 2 for
// every tj, radial then angular rows of the table dk_stage_cell fills.
__device__ __forceinline__ const float* dk_rcp_r(const NepConsts& c,
                                                 const float* rcp, int ti) {
  return rcp + ti * c.T;
}
__device__ __forceinline__ const float* dk_rcp_a(const NepConsts& c,
                                                 const float* rcp, int ti) {
  return rcp + (c.T + ti) * c.T;
}

// The tile math's pair of centre ce and packed candidate cd, each (x, y, z,
// type index as int bits), with the centre's cutoff rows rr, ra: lr / la
// false when its radial / angular terms are exact zeros.  The slot test
// and the pieces evaluate the same expressions, so a queued pair is live.
__device__ __forceinline__ void dk_pair(const NepConsts& c, const float* rr,
                                        const float* ra, float4 ce, float4 cd,
                                        DkPair* p) {
  p->dx = cd.x - ce.x;
  p->dy = cd.y - ce.y;
  p->dz = cd.z - ce.z;
  const float d2 = p->dx * p->dx + p->dy * p->dy + p->dz * p->dz;
  p->tjx = __float_as_int(cd.w);
  p->inv_d = rsqrtf(fmaxf(d2, GK_EPS2));
  p->d = d2 * p->inv_d;
  p->rcp_r = rr[p->tjx];
  p->rcp_a = ra[p->tjx];
  const bool ok = d2 > GK_EPS2;
  p->lr = ok && (p->d < p->rcp_r || (c.zbl_mode && p->d < c.zbl_rc_outer));
  p->la = ok && p->d < p->rcp_a;
}

// The live centres of the cell in slot order (warp 0) as (x, y, z, type
// index), the pair cutoff and Y_lm tables (all threads).
static  // one definition a build part (cuda_build.PARTS)
__device__ void dk_stage_cell(const float* centers, const NepConsts& c,
                              const DenseGeom& g, int cell, int x, int y,
                              int z, const DkTile& t, DkShared& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < t.ztab_n; e += DK_THREADS) s.zt[e] = c.ztab[e];
  for (int e = tid; e < c.T * c.T; e += DK_THREADS) {
    const int ti = e / c.T, tj = e - ti * c.T;
    s.rcp[e] = 0.5f * (c.rc_r[ti] + c.rc_r[tj]);
    s.rcp[c.T * c.T + e] = 0.5f * (c.rc_a[ti] + c.rc_a[tj]);
  }
  if (tid >= 32) return;
  int carry = 0;
  for (int i0 = 0; i0 < g.cap; i0 += 32) {
    const int i = i0 + lane;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    bool live = false;
    if (i < g.cap) {
      v.x = dk_center(centers, g, cell, x, y, z, 0, i);
      v.y = dk_center(centers, g, cell, x, y, z, 1, i);
      v.z = dk_center(centers, g, cell, x, y, z, 2, i);
      v.w = dk_center(centers, g, cell, x, y, z, 3, i);
      live = gk_centre_live(v.x, v.w);
      v.w = __int_as_float(gk_type_index(v.w, c.T));
    }
    const unsigned bal = __ballot_sync(DK_FULL, live);
    const int pos = carry + __popc(bal & ((1u << lane) - 1u));
    if (i < g.cap) s.c_of[i] = live ? pos : -1;
    if (live) {
      s.cen[pos] = v;
      s.lane_of[pos] = i;
    }
    carry += __popc(bal);
  }
  if (lane == 0) s.misc[DK_WARPS] = carry;
}

// The window's lanes [w0, w0 + cw) whose type code names a type, packed in
// lane order into cl as (x, y, z, type index); with cjx, the packed index
// of each window lane (-1: adds exact zeros).  Each warp counts, then
// packs, a range of 32-lane groups, DK_BATCH groups' loads at a time.
#define DK_BATCH 4
static  // one definition a build part (cuda_build.PARTS)
__device__ int dk_stage_window(const float* cand, const NepConsts& c,
                               const DenseGeom& g, int cell, int x, int y,
                               int z, int w0, int cw, DkShared& s,
                               bool with_cjx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int ng = cw / 32, per = (ng + DK_WARPS - 1) / DK_WARPS;
  const int g0 = min(warp * per, ng), g1 = min(g0 + per, ng);
  int cnt = 0;
  for (int b0 = g0; b0 < g1; b0 += DK_BATCH) {
    float tv[DK_BATCH];
#pragma unroll
    for (int v = 0; v < DK_BATCH; ++v) {
      const int j = w0 + (b0 + v) * 32 + lane;
      tv[v] = (b0 + v < g1 && j < g.C)
                  ? dk_cand(cand, g, cell, x, y, z, 3, j) : -1.0f;
    }
#pragma unroll
    for (int v = 0; v < DK_BATCH; ++v)
      cnt += __popc(__ballot_sync(DK_FULL, gk_type_valid(tv[v], c.T)));
  }
  if (lane == 0) s.misc[warp] = cnt;
  __syncthreads();
  int base = 0, nc = 0;
  for (int w = 0; w < DK_WARPS; ++w) {
    const int v = s.misc[w];
    base += w < warp ? v : 0;
    nc += v;
  }
  for (int b0 = g0; b0 < g1; b0 += DK_BATCH) {
    float4 cv[DK_BATCH];
#pragma unroll
    for (int v = 0; v < DK_BATCH; ++v) {
      const int j = w0 + (b0 + v) * 32 + lane;
      cv[v] = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
      if (b0 + v < g1 && j < g.C) {
        cv[v].x = dk_cand(cand, g, cell, x, y, z, 0, j);
        cv[v].y = dk_cand(cand, g, cell, x, y, z, 1, j);
        cv[v].z = dk_cand(cand, g, cell, x, y, z, 2, j);
        cv[v].w = dk_cand(cand, g, cell, x, y, z, 3, j);
      }
    }
#pragma unroll
    for (int v = 0; v < DK_BATCH; ++v) {
      const bool ok = gk_type_valid(cv[v].w, c.T);
      const unsigned bal = __ballot_sync(DK_FULL, ok);
      const int pos = base + __popc(bal & below);
      if (ok) {
        cv[v].w = __int_as_float(gk_type_index(cv[v].w, c.T));
        s.cl[pos] = cv[v];
      }
      if (with_cjx && b0 + v < g1) s.cjx[(b0 + v) * 32 + lane] = ok ? pos : -1;
      base += __popc(bal);
    }
  }
  return nc;
}

// The slot test of the group's centres [c0, c0 + ng) against the window's
// nc packed candidates, a warp a (DK_QUAD centres, 32-candidate word) unit
// (independent tests in flight): bit b of mask[ci nwc + w] is set when
// pair (c0 + ci, 32 w + b) is live.
#define DK_QUAD 4
static  // one definition a build part (cuda_build.PARTS)
__device__ void dk_slot_test(const NepConsts& c, DkShared& s, int c0, int ng,
                             int nc, int nwc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (nwc == 0) return;
  const int nq = (ng + DK_QUAD - 1) / DK_QUAD;
  int cq = warp / nwc, w = warp - cq * nwc;
  for (int u = warp; u < nq * nwc; u += DK_WARPS) {
    const int cj = w * 32 + lane;
    const float4 cd = s.cl[min(cj, nc - 1)];
    unsigned br[DK_QUAD], ba[DK_QUAD];
#pragma unroll
    for (int k = 0; k < DK_QUAD; ++k) {
      const int ci = min(DK_QUAD * cq + k, ng - 1);
      const float4 ce = s.cen[c0 + ci];
      const int ti = __float_as_int(ce.w);
      DkPair p;
      dk_pair(c, dk_rcp_r(c, s.rcp, ti), dk_rcp_a(c, s.rcp, ti), ce, cd, &p);
      br[k] = __ballot_sync(DK_FULL, cj < nc && p.lr);
      ba[k] = __ballot_sync(DK_FULL, cj < nc && p.la);
    }
    if (lane < DK_QUAD && DK_QUAD * cq + lane < ng) {
      unsigned r = br[0], a = ba[0];
#pragma unroll
      for (int k = 1; k < DK_QUAD; ++k)
        if (lane == k) {
          r = br[k];
          a = ba[k];
        }
      const int m = (DK_QUAD * cq + lane) * nwc + w;
      s.mask_r[m] = r;
      s.mask_a[m] = a;
    }
    for (w += DK_WARPS; w >= nwc; w -= nwc) ++cq;
  }
}

// The queues: warps 0 and 1 the centres' radial and angular segment
// offsets (gk_offsets), the other warps a centre each its words' prefixes,
// the set bits before each word.
static  // one definition a build part (cuda_build.PARTS)
__device__ void dk_queues(DkShared& s, int ng, int nwc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) gk_offsets(s.mask_r, nwc, ng, s.off_r);
  if (warp == 1) gk_offsets(s.mask_a, nwc, ng, s.off_a);
  if (warp < 2) return;
  for (int u = warp - 2; u < 2 * ng; u += DK_WARPS - 2) {
    const int ci = u >> 1;
    const unsigned* mk = ((u & 1) ? s.mask_a : s.mask_r) + ci * nwc;
    unsigned short* wp = ((u & 1) ? s.wpre_a : s.wpre_r) + ci * nwc;
    int carry = 0;
    for (int w0 = 0; w0 < nwc; w0 += 32) {
      const int w = w0 + lane;
      const int n = w < nwc ? __popc(mk[w]) : 0;
      int incl = n;
#pragma unroll
      for (int sh = 1; sh < 32; sh <<= 1) {
        const int v = __shfl_up_sync(DK_FULL, incl, sh);
        if (lane >= sh) incl += v;
      }
      if (w < nwc) wp[w] = (unsigned short)(carry + incl - n);
      carry += __shfl_sync(DK_FULL, incl, 31);
    }
  }
}

// A piece [q0, q1) of a queue: the centres [c_lo, c_hi) it touches, and
// its pairs as (centre << 16 | packed candidate) by position, a warp a
// (centre, word), each set bit placed by its centre's offset, its word's
// prefix and the bits below it.
struct DkPiece {
  int q0, q1, c_lo, c_hi;
};

static  // one definition a build part (cuda_build.PARTS)
__device__ DkPiece dk_expand(const unsigned* mask, const int* off,
                             const unsigned short* wpre, int ng, int nwc,
                             int q0, int qcap, int* list) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  DkPiece pc;
  pc.q0 = q0;
  pc.q1 = min(q0 + qcap, off[ng]);
  pc.c_lo = gk_owner(off, 0, ng, q0);
  pc.c_hi = gk_owner(off, pc.c_lo, ng, pc.q1 - 1) + 1;
  // a warp a centre, DK_QUAD of its words' loads at a time
  for (int ci = pc.c_lo + warp; ci < pc.c_hi; ci += DK_WARPS) {
    const int base = off[ci];
    const unsigned* mk = mask + ci * nwc;
    const unsigned short* wp = wpre + ci * nwc;
    for (int w0 = 0; w0 < nwc; w0 += DK_QUAD) {
      unsigned m[DK_QUAD];
      int pre[DK_QUAD];
#pragma unroll
      for (int k = 0; k < DK_QUAD; ++k) {
        const bool in = w0 + k < nwc;
        m[k] = in ? mk[w0 + k] : 0u;
        pre[k] = in ? wp[w0 + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < DK_QUAD; ++k) {
        const int pos = base + pre[k] + __popc(m[k] & below);
        if (((m[k] >> lane) & 1u) && pos >= pc.q0 && pos < pc.q1)
          list[pos - pc.q0] = (ci << 16) | (32 * (w0 + k) + lane);
      }
    }
  }
  return pc;
}

// Forward: s_out (cell, cap, s_width); a_out channel-leading (round 2) or
// (cell, cap, ch_a nlm) (round 1).  Round 1 passes the ghost rows as both
// `centers` and `cand`.  A centre's sums go to device memory as its pieces
// close and are read back by the next piece that continues its segment.
template <int LMAX, int KMAX>
__global__ void __launch_bounds__(DK_THREADS, 3)
dense_fwd_kernel(const float* __restrict__ centers,
                 const float* __restrict__ cand, float* __restrict__ s_out,
                 float* __restrict__ a_out, NepConsts c, DenseGeom g,
                 DkTile t) {
  constexpr int NLM = LMAX * (LMAX + 2);
  extern __shared__ __align__(16) float sm[];
  const int T = c.T, kr1 = c.kr1, ka1 = c.ka1, ch_a = T * ka1;
  const int sr = T * kr1, sw = sr + 1, cap = g.cap;
  const int capr = (cap + 31) / 32 * 32;
  const int rowr = dk_rowr(kr1), rowa = dk_rowa(ka1, NLM);
  const DkLayout L = dk_layout(cap, T, kr1, ka1, NLM, t, false);
  DkShared s = dk_views(sm, L, t);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cell = blockIdx.x;
  const int x = cell % g.nx, y = (cell / g.nx) % g.ny;
  const int z = cell / (g.nx * g.ny);
  int* s_started = s.flag;
  int* a_started = s.flag + capr;

  dk_stage_cell(centers, c, g, cell, x, y, z, t, s);
  for (int e = tid; e < 2 * capr; e += DK_THREADS) s.flag[e] = 0;
  for (int w0 = 0; w0 < g.C; w0 += t.cw) {
    const int nc = dk_stage_window(cand, c, g, cell, x, y, z, w0, t.cw, s,
                                   false);
    const int nwc = (nc + 31) / 32, nl = s.misc[DK_WARPS];
    for (int c0 = 0; c0 < nl; c0 += t.gc) {
      const int ng = min(t.gc, nl - c0);
      __syncthreads();
      dk_slot_test(c, s, c0, ng, nc, nwc);
      __syncthreads();
      dk_queues(s, ng, nwc);
      __syncthreads();
      // the live pairs: radial pieces, then the angular ones
      for (int q0 = 0; q0 < s.off_r[ng]; q0 += t.qr) {
        const DkPiece pc = dk_expand(s.mask_r, s.off_r, s.wpre_r, ng, nwc,
                                     q0, t.qr, s.list);
        __syncthreads();
        for (int q = q0 + tid; q < pc.q1; q += DK_THREADS) {
          const int e = s.list[q - q0], ci = e >> 16;
          const float4 ce = s.cen[c0 + ci];
          const int ti = __float_as_int(ce.w);
          DkPair p;
          dk_pair(c, dk_rcp_r(c, s.rcp, ti), dk_rcp_a(c, s.rcp, ti), ce,
                  s.cl[e & 0xffff], &p);
          float* row = s.buf + (q - q0) * rowr;
          row[0] = (float)p.tjx;
          gk_cheb<KMAX>(p.d, p.rcp_r, kr1, row + 2, nullptr);
          // beyond rc_outer the ZBL term is an exact zero
          float ez = 0.0f;
          if (c.zbl_mode && p.d < c.zbl_rc_outer)
            gk_zbl(c, p.d, p.inv_d, (float)ti, (float)p.tjx, &ez, nullptr);
          row[1] = ez;
        }
        __syncthreads();
        // radial sums: (centre, column), the segment's rows in slot order
        for (int u = tid; u < (pc.c_hi - pc.c_lo) * sw; u += DK_THREADS) {
          const int cc = u / sw, col = u - cc * sw, ci = pc.c_lo + cc;
          const int lo = max(s.off_r[ci], q0);
          const int hi = min(s.off_r[ci + 1], pc.q1);
          float* so = s_out + ((size_t)cell * cap + s.lane_of[c0 + ci]) * sw +
                      col;
          float v = (s_started[c0 + ci] || s.off_r[ci] < q0) ? *so : 0.0f;
          if (col == sr) {
            for (int q = lo; q < hi; ++q) v += s.buf[(q - q0) * rowr + 1];
          } else {
            const int ts = col / kr1, k = col - ts * kr1;
            for (int q = lo; q < hi; ++q) {
              const float* row = s.buf + (q - q0) * rowr;
              if ((int)row[0] == ts) v += row[2 + k];
            }
          }
          *so = v;
        }
        __syncthreads();
      }
      // angular pieces
      for (int q0 = 0; q0 < s.off_a[ng]; q0 += t.qa) {
        const DkPiece pc = dk_expand(s.mask_a, s.off_a, s.wpre_a, ng, nwc,
                                     q0, t.qa, s.list);
        __syncthreads();
        for (int q = q0 + tid; q < pc.q1; q += DK_THREADS) {
          const int e = s.list[q - q0], ci = e >> 16;
          const float4 ce = s.cen[c0 + ci];
          const int ti = __float_as_int(ce.w);
          DkPair p;
          dk_pair(c, dk_rcp_r(c, s.rcp, ti), dk_rcp_a(c, s.rcp, ti), ce,
                  s.cl[e & 0xffff], &p);
          float* row = s.buf + (q - q0) * rowa;
          row[0] = (float)p.tjx;
          gk_cheb<KMAX>(p.d, p.rcp_a, ka1, row + 1, nullptr);
          gk_ylm<LMAX>(p.dx * p.inv_d, p.dy * p.inv_d, p.dz * p.inv_d, s.zt,
                       row + 1 + ka1);
        }
        __syncthreads();
        const int ncen = pc.c_hi - pc.c_lo;
        for (int ts = 0; ts < T; ++ts)
          // angular sums: (type, centre, lm), ka1 channels in registers
          for (int u = tid; u < ncen * NLM; u += DK_THREADS) {
            const int lm = u % NLM, ci = pc.c_lo + u / NLM;
            const int lo = max(s.off_a[ci], q0);
            const int hi = min(s.off_a[ci + 1], pc.q1);
            const int i = s.lane_of[c0 + ci];
            const bool cont = a_started[c0 + ci] || s.off_a[ci] < q0;
            float acc[KMAX];
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
              if (k < ka1)
                acc[k] = cont ? a_out[dk_aidx(g, cell, ch_a, NLM,
                                              ts * ka1 + k, i, lm)]
                              : 0.0f;
            for (int q = lo; q < hi; ++q) {
              const float* row = s.buf + (q - q0) * rowa;
              if ((int)row[0] != ts) continue;
              const float yv = row[1 + ka1 + lm];
#pragma unroll
              for (int k = 0; k < KMAX; ++k)
                if (k < ka1) acc[k] += row[1 + k] * yv;
            }
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
              if (k < ka1)
                a_out[dk_aidx(g, cell, ch_a, NLM, ts * ka1 + k, i, lm)] =
                    acc[k];
          }
        __syncthreads();
      }
      for (int ci = tid; ci < ng; ci += DK_THREADS) {
        s_started[c0 + ci] |= s.off_r[ci + 1] > s.off_r[ci];
        a_started[c0 + ci] |= s.off_a[ci + 1] > s.off_a[ci];
      }
    }
    __syncthreads();
  }
  // every slot no piece wrote: exact zeros (A a warp a row of NLM)
  for (int e = tid; e < cap * sw; e += DK_THREADS) {
    const int ci = s.c_of[e / sw];
    if (ci < 0 || !s_started[ci]) s_out[(size_t)cell * cap * sw + e] = 0.0f;
  }
  // rows in the output's own order: round 2 (ch, i), round 1 (i, ch)
  for (int r = warp; r < ch_a * cap; r += DK_WARPS) {
    const int ci = s.c_of[g.v1 ? r / ch_a : r % cap];
    if (ci >= 0 && a_started[ci]) continue;
    float* ap = a_out + ((size_t)cell * ch_a * cap + r) * NLM;
    for (int lm = lane; lm < NLM; lm += 32) ap[lm] = 0.0f;
  }
}

// Backward: cot_s as s, cot_a as a.  Round 2: dcen_out (cell, 3, cap),
// dcand_out (cell, 3, C).  Round 1: dcand_out the (cell, 27, 3cap) tiles,
// the centre gradients added into rows 12 + k, lanes cap + i.  The k-th
// radial piece and the k-th angular piece run together, so the costly
// angular pairs share a phase with the radial ones.
template <int LMAX, int KMAX>
__global__ void __launch_bounds__(DK_THREADS, 3)
dense_bwd_kernel(const float* __restrict__ centers,
                 const float* __restrict__ cand,
                 const float* __restrict__ cot_s,
                 const float* __restrict__ cot_a, float* __restrict__ dcen_out,
                 float* __restrict__ dcand_out, NepConsts c, DenseGeom g,
                 DkTile t) {
  constexpr int NLM = LMAX * (LMAX + 2);
  extern __shared__ __align__(16) float sm[];
  const int T = c.T, kr1 = c.kr1, ka1 = c.ka1, ch_a = T * ka1;
  const int sr = T * kr1, sw = sr + 1, cap = g.cap, c3 = 3 * cap;
  const int capr = (cap + 31) / 32 * 32;
  const DkLayout L = dk_layout(cap, T, kr1, ka1, NLM, t, true);
  DkShared s = dk_views(sm, L, t);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cell = blockIdx.x;
  const int x = cell % g.nx, y = (cell / g.nx) % g.ny;
  const int z = cell / (g.nx * g.ny);
  // the stride between channels of one centre's cot_A row
  const int a_sn = g.v1 ? NLM : cap * NLM;
  int* list_r = s.list;
  int* list_a = s.list + t.qr;
  float* pb_r = s.buf;          // (qr, 3) radial pair cotangents
  float* pb_a = s.buf + 3 * t.qr;  // (qa, 3) angular ones

  dk_stage_cell(centers, c, g, cell, x, y, z, t, s);
  for (int e = tid; e < 3 * capr; e += DK_THREADS) s.dcen[e] = 0.0f;
  for (int w0 = 0; w0 < g.C; w0 += t.cw) {
    for (int e = tid; e < 3 * t.cw; e += DK_THREADS) s.dacc[e] = 0.0f;
    const int nc = dk_stage_window(cand, c, g, cell, x, y, z, w0, t.cw, s,
                                   true);
    const int nwc = (nc + 31) / 32, nl = s.misc[DK_WARPS];
    for (int c0 = 0; c0 < nl; c0 += t.gc) {
      const int ng = min(t.gc, nl - c0);
      __syncthreads();
      dk_slot_test(c, s, c0, ng, nc, nwc);
      __syncthreads();
      dk_queues(s, ng, nwc);
      __syncthreads();
      const int nr = s.off_r[ng], na = s.off_a[ng];
      // the live pairs: radial pieces, with the angular ones
      for (int k0 = 0; k0 * t.qr < nr || k0 * t.qa < na; ++k0) {
        DkPiece pr = {0, 0, 0, 0}, pa = {0, 0, 0, 0};
        if (k0 * t.qr < nr)
          pr = dk_expand(s.mask_r, s.off_r, s.wpre_r, ng, nwc, k0 * t.qr,
                         t.qr, list_r);
        if (k0 * t.qa < na)
          pa = dk_expand(s.mask_a, s.off_a, s.wpre_a, ng, nwc, k0 * t.qa,
                         t.qa, list_a);
        __syncthreads();
        // pair evaluation: the angular pairs first, then the radial ones
        const int n_a = pa.q1 - pa.q0, n_all = n_a + pr.q1 - pr.q0;
        for (int it = tid; it < n_all; it += DK_THREADS) {
          const bool ang = it < n_a;
          const int slot = ang ? it : it - n_a;
          const int e = (ang ? list_a : list_r)[slot], ci = e >> 16;
          const float4 ce = s.cen[c0 + ci];
          const int ti = __float_as_int(ce.w), i = s.lane_of[c0 + ci];
          DkPair p;
          dk_pair(c, dk_rcp_r(c, s.rcp, ti), dk_rcp_a(c, s.rcp, ti), ce,
                  s.cl[e & 0xffff], &p);
          const float u[3] = {p.dx * p.inv_d, p.dy * p.inv_d,
                              p.dz * p.inv_d};
          float f[KMAX], fp[KMAX], pv[3];
          if (!ang) {
            gk_cheb<KMAX>(p.d, p.rcp_r, kr1, f, fp);
            const float* cr = cot_s + ((size_t)cell * cap + i) * sw;
            float sig = 0.0f;
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
              if (k < kr1) sig += __ldg(cr + p.tjx * kr1 + k) * fp[k];
            // beyond rc_outer the ZBL term is an exact zero
            if (c.zbl_mode && p.d < c.zbl_rc_outer) {
              float ez, dedd;
              gk_zbl(c, p.d, p.inv_d, (float)ti, (float)p.tjx, &ez, &dedd);
              sig += __ldg(cr + sr) * dedd;
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) pv[k] = sig * u[k];
          } else {
            gk_cheb<KMAX>(p.d, p.rcp_a, ka1, f, fp);
            const float* ca =
                cot_a + dk_aidx(g, cell, ch_a, NLM, p.tjx * ka1, i, 0);
            float sval, gx, gy, gz;
            gk_ylm_vjp_cot<LMAX, KMAX>(u[0], u[1], u[2], s.zt, ca, a_sn, 1,
                                       f, fp, ka1, &sval, &gx, &gy, &gz);
            const float gv[3] = {gx, gy, gz};
            const float ug = u[0] * gx + u[1] * gy + u[2] * gz;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              pv[k] = sval * u[k] + (gv[k] - u[k] * ug) * p.inv_d;
          }
          float* pb = (ang ? pb_a : pb_r) + 3 * slot;
#pragma unroll
          for (int k = 0; k < 3; ++k) pb[k] = pv[k];
        }
        __syncthreads();
        for (int side = 0; side < 2; ++side) {
          // copies, not references: a reference to one of two locals would
          // put them in local memory
          const unsigned* mask = side ? s.mask_a : s.mask_r;
          const int* off = side ? s.off_a : s.off_r;
          const unsigned short* wpre = side ? s.wpre_a : s.wpre_r;
          const int pq0 = side ? pa.q0 : pr.q0, pq1 = side ? pa.q1 : pr.q1;
          const int p_lo = side ? pa.c_lo : pr.c_lo;
          const int p_hi = side ? pa.c_hi : pr.c_hi;
          const float* pb = side ? pb_a : pb_r;
          // centre sums: a warp a centre, lanes strided over its segment
          for (int cc = warp; cc < p_hi - p_lo; cc += DK_WARPS) {
            const int ci = p_lo + cc;
            const int lo = max(off[ci], pq0);
            const int hi = min(off[ci + 1], pq1);
            float v[3] = {0.0f, 0.0f, 0.0f};
            for (int q = lo + lane; q < hi; q += 32)
#pragma unroll
              for (int k = 0; k < 3; ++k) v[k] += pb[3 * (q - pq0) + k];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
#pragma unroll
              for (int o = 16; o > 0; o >>= 1)
                v[k] += __shfl_xor_sync(DK_FULL, v[k], o);
            }
            if (lane < 3)
              s.dcen[3 * (c0 + ci) + lane] -=
                  lane == 0 ? v[0] : (lane == 1 ? v[1] : v[2]);
          }
          // candidate sums: a warp a word of packed candidates, each lane
          // walking the piece's centres in order, DK_QUAD centres' loads
          // at a time
          for (int w = warp; w < nwc && pq1 > pq0; w += DK_WARPS) {
            const int cj = 32 * w + lane;
            const unsigned below = (1u << lane) - 1u;
            float v[3] = {0.0f, 0.0f, 0.0f};
            if (cj < nc)
#pragma unroll
              for (int k = 0; k < 3; ++k) v[k] = s.dacc[k * t.cw + cj];
            for (int c4 = p_lo; c4 < p_hi; c4 += DK_QUAD) {
              unsigned m[DK_QUAD];
              int at[DK_QUAD];
#pragma unroll
              for (int k = 0; k < DK_QUAD; ++k) {
                const int ci = c4 + k;
                const bool in = ci < p_hi;
                m[k] = in ? mask[ci * nwc + w] : 0u;
                at[k] = in ? off[ci] + wpre[ci * nwc + w] : 0;
              }
#pragma unroll
              for (int k = 0; k < DK_QUAD; ++k) {
                const int pos = at[k] + __popc(m[k] & below);
                if (((m[k] >> lane) & 1u) && pos >= pq0 && pos < pq1)
#pragma unroll
                  for (int kk = 0; kk < 3; ++kk)
                    v[kk] += pb[3 * (pos - pq0) + kk];
              }
            }
            if (cj < nc)
#pragma unroll
              for (int k = 0; k < 3; ++k) s.dacc[k * t.cw + cj] = v[k];
          }
          __syncthreads();
        }
      }
    }
    __syncthreads();
    for (int l = tid; l < t.cw && w0 + l < g.C; l += DK_THREADS) {
      const int j = w0 + l, cj = s.cjx[l];
      float v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[k] = cj >= 0 ? s.dacc[k * t.cw + cj] : 0.0f;
      if (g.v1) {
        const int r = j / c3, ll = j - r * c3;
        float* gp = dcand_out + ((size_t)cell * 27 + r * 3) * c3 + ll;
#pragma unroll
        for (int k = 0; k < 3; ++k) gp[k * c3] = v[k];
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          dcand_out[((size_t)cell * 3 + k) * g.C + j] = v[k];
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < 3 * cap; e += DK_THREADS) {
    const int k = e / cap, i = e - k * cap, ci = s.c_of[i];
    const float v = ci >= 0 ? s.dcen[3 * ci + k] : 0.0f;
    if (g.v1)
      dcand_out[((size_t)cell * 27 + 12 + k) * c3 + cap + i] += v;
    else
      dcen_out[((size_t)cell * 3 + k) * cap + i] = v;
  }
}

// Launch (occ == nullptr) or report resident blocks an SM into *occ.
template <typename K>
static int dk_go(K fn, int nblocks, int smem, cudaStream_t stream, int* occ,
                 void** args) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, fn, DK_THREADS, smem);
  e = cudaLaunchKernel((const void*)fn, dim3(nblocks), dim3(DK_THREADS), args,
                       (size_t)smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

struct DkCall {
  const float* centers;
  const float* cand;
  const float* cot_s;
  const float* cot_a;
  float* out0;  // fwd: s; bwd: dcen
  float* out1;  // fwd: a; bwd: dcand
  NepConsts c;
  DenseGeom g;
  DkTile t;
};

template <int LMAX, int KMAX>
static int dk_run(DkCall& k, bool bwd, int smem, cudaStream_t stream,
                  int* occ) {
  const int nb = k.g.nx * k.g.ny * k.g.nz;
  if (bwd) {
    void* args[] = {&k.centers, &k.cand, &k.cot_s, &k.cot_a, &k.out0,
                    &k.out1,    &k.c,    &k.g,     &k.t};
    return dk_go(dense_bwd_kernel<LMAX, KMAX>, nb, smem, stream, occ, args);
  }
  void* args[] = {&k.centers, &k.cand, &k.out0, &k.out1, &k.c, &k.g, &k.t};
  return dk_go(dense_fwd_kernel<LMAX, KMAX>, nb, smem, stream, occ, args);
}

template <int KMAX>
static int dk_lmax(DkCall& k, bool bwd, int smem, cudaStream_t stream,
                   int* occ) {
  switch (k.c.l_max) {
    case 1: return dk_run<1, KMAX>(k, bwd, smem, stream, occ);
    case 2: return dk_run<2, KMAX>(k, bwd, smem, stream, occ);
    case 3: return dk_run<3, KMAX>(k, bwd, smem, stream, occ);
    case 4: return dk_run<4, KMAX>(k, bwd, smem, stream, occ);
    case 5: return dk_run<5, KMAX>(k, bwd, smem, stream, occ);
    case 6: return dk_run<6, KMAX>(k, bwd, smem, stream, occ);
    case 7: return dk_run<7, KMAX>(k, bwd, smem, stream, occ);
    case 8: return dk_run<8, KMAX>(k, bwd, smem, stream, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The library build compiles this file once a part, all parts at once,
// with GK_PART set (engine/cuda_build.py's PARTS): part 0 holds the KMAX
// = 8 instances and the entry points, parts 1 and 2 the KMAX = GK_MAXK
// instances of odd and of even l_max.  A build without GK_PART (the
// probes' single-source builds) takes the whole file.
int dk_kmax_odd(DkCall& k, bool bwd, int smem, cudaStream_t stream,
                int* occ);
int dk_kmax_even(DkCall& k, bool bwd, int smem, cudaStream_t stream,
                 int* occ);

#if !defined(GK_PART) || GK_PART == 1
int dk_kmax_odd(DkCall& k, bool bwd, int smem, cudaStream_t stream,
                int* occ) {
  switch (k.c.l_max) {
    case 1: return dk_run<1, GK_MAXK>(k, bwd, smem, stream, occ);
    case 3: return dk_run<3, GK_MAXK>(k, bwd, smem, stream, occ);
    case 5: return dk_run<5, GK_MAXK>(k, bwd, smem, stream, occ);
    case 7: return dk_run<7, GK_MAXK>(k, bwd, smem, stream, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if !defined(GK_PART) || GK_PART == 2
int dk_kmax_even(DkCall& k, bool bwd, int smem, cudaStream_t stream,
                 int* occ) {
  switch (k.c.l_max) {
    case 2: return dk_run<2, GK_MAXK>(k, bwd, smem, stream, occ);
    case 4: return dk_run<4, GK_MAXK>(k, bwd, smem, stream, occ);
    case 6: return dk_run<6, GK_MAXK>(k, bwd, smem, stream, occ);
    case 8: return dk_run<8, GK_MAXK>(k, bwd, smem, stream, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if !defined(GK_PART) || GK_PART == 0
// The wrapper's shared-memory size must be the kernel's layout: a
// disagreement would let the kernel run past its allocation.
static int dk_dispatch(DkCall& k, bool bwd, int smem, cudaStream_t stream,
                       int* occ) {
  const int nlm = k.c.l_max * (k.c.l_max + 2);
  const DkLayout L = dk_layout(k.g.cap, k.c.T, k.c.kr1, k.c.ka1, nlm, k.t,
                               bwd);
  if (smem != 4 * L.words || k.t.cw <= 0 || k.t.cw % 32 || k.t.gc <= 0 ||
      k.t.qr <= 0 || k.t.qa <= 0)
    return (int)cudaErrorInvalidValue;
  const int kmax = k.c.kr1 > k.c.ka1 ? k.c.kr1 : k.c.ka1;
  if (kmax <= 8) return dk_lmax<8>(k, bwd, smem, stream, occ);
  if (kmax <= GK_MAXK)
    return (k.c.l_max & 1 ? dk_kmax_odd : dk_kmax_even)(k, bwd, smem, stream,
                                                        occ);
  return (int)cudaErrorInvalidValue;
}

static DkCall dk_call(const float* centers, const float* cand,
                      const float* cot_s, const float* cot_a, float* out0,
                      float* out1, const float* rc_r, const float* rc_a,
                      const float* znum, const float* ztab, int nx, int ny,
                      int nz, int cap, int C, bool v1, int T, int kr1,
                      int ka1, int l_max, int zbl, int ztab_n, int cw,
                      int gc, int qr, int qa, float rc_inner,
                      float rc_outer) {
  DkCall k;
  k.centers = centers; k.cand = cand; k.cot_s = cot_s; k.cot_a = cot_a;
  k.out0 = out0; k.out1 = out1;
  k.c = gk_consts(rc_r, rc_a, nullptr, znum, nullptr, nullptr, ztab, T, kr1,
                  0, ka1, l_max, zbl ? 1 : 0, rc_inner, rc_outer, 0.0f);
  k.g.nx = nx; k.g.ny = ny; k.g.nz = nz; k.g.cap = cap; k.g.C = C;
  k.g.v1 = v1;
  k.t.cw = cw; k.t.gc = gc; k.t.qr = qr; k.t.qa = qa; k.t.ztab_n = ztab_n;
  return k;
}

extern "C" int dense_k1b_launch(const float* centers, const float* cand,
                                float* s, float* a, const float* rc_r,
                                const float* rc_a, const float* znum,
                                const float* ztab, int nx, int ny, int nz,
                                int cap, int C, int T, int kr1, int ka1,
                                int l_max, int zbl, int ztab_n, int cw,
                                int gc, int qr, int qa, int smem,
                                float rc_inner, float rc_outer,
                                void* stream) {
  DkCall k = dk_call(centers, cand, nullptr, nullptr, s, a, rc_r, rc_a, znum,
                     ztab, nx, ny, nz, cap, C, false, T, kr1, ka1, l_max, zbl,
                     ztab_n, cw, gc, qr, qa, rc_inner, rc_outer);
  return dk_dispatch(k, false, smem, (cudaStream_t)stream, nullptr);
}

extern "C" int dense_k2b_launch(const float* centers, const float* cand,
                                const float* cot_s, const float* cot_a,
                                float* dcen, float* dcand, const float* rc_r,
                                const float* rc_a, const float* znum,
                                const float* ztab, int nx, int ny, int nz,
                                int cap, int C, int T, int kr1, int ka1,
                                int l_max, int zbl, int ztab_n, int cw,
                                int gc, int qr, int qa, int smem,
                                float rc_inner, float rc_outer,
                                void* stream) {
  DkCall k = dk_call(centers, cand, cot_s, cot_a, dcen, dcand, rc_r, rc_a,
                     znum, ztab, nx, ny, nz, cap, C, false, T, kr1, ka1,
                     l_max, zbl, ztab_n, cw, gc, qr, qa, rc_inner, rc_outer);
  return dk_dispatch(k, true, smem, (cudaStream_t)stream, nullptr);
}

extern "C" int dense_k1_launch(const float* garr, float* s, float* a,
                               const float* rc_r, const float* rc_a,
                               const float* znum, const float* ztab, int nx,
                               int ny, int nz, int cap, int T, int kr1,
                               int ka1, int l_max, int zbl, int ztab_n,
                               int cw, int gc, int qr, int qa, int smem,
                               float rc_inner, float rc_outer, void* stream) {
  DkCall k = dk_call(garr, garr, nullptr, nullptr, s, a, rc_r, rc_a, znum,
                     ztab, nx, ny, nz, cap, 27 * cap, true, T, kr1, ka1,
                     l_max, zbl, ztab_n, cw, gc, qr, qa, rc_inner, rc_outer);
  return dk_dispatch(k, false, smem, (cudaStream_t)stream, nullptr);
}

extern "C" int dense_k2_launch(const float* garr, const float* cot_s,
                               const float* cot_a, float* tiles,
                               const float* rc_r, const float* rc_a,
                               const float* znum, const float* ztab, int nx,
                               int ny, int nz, int cap, int T, int kr1,
                               int ka1, int l_max, int zbl, int ztab_n,
                               int cw, int gc, int qr, int qa, int smem,
                               float rc_inner, float rc_outer, void* stream) {
  DkCall k = dk_call(garr, garr, cot_s, cot_a, nullptr, tiles, rc_r, rc_a,
                     znum, ztab, nx, ny, nz, cap, 27 * cap, true, T, kr1,
                     ka1, l_max, zbl, ztab_n, cw, gc, qr, qa, rc_inner,
                     rc_outer);
  return dk_dispatch(k, true, smem, (cudaStream_t)stream, nullptr);
}

// Resident blocks an SM of the forward (bwd 0) or backward kernel at this
// model and tiling, into *blocks.
extern "C" int dense_occupancy(int bwd, int cap, int T, int kr1, int ka1,
                               int l_max, int ztab_n, int cw, int gc, int qr,
                               int qa, int smem, int* blocks) {
  DkCall k = dk_call(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, 1, 1, 1, cap,
                     27 * cap, false, T, kr1, ka1, l_max, 0, ztab_n, cw, gc,
                     qr, qa, 0.0f, 0.0f);
  return dk_dispatch(k, bwd != 0, smem, nullptr, blocks);
}
#endif  // GK_PART 0
