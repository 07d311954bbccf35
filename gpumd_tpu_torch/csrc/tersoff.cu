// Tersoff-1989: per-atom energy, centre gradient, virial rows and per-pair
// cotangents p_ij = dE_i/dr_ij on the compact engine's bond tiles, in two
// modes built from one body:
//
//   tersoff_kernel          (contract) writes p_ij into pvals (pch, mn,
//                           a_pad) a block, every slot, dead ones zero
//   tersoff_scatter_kernel  (fused) adds p_ij (and -r_a p_b) straight into
//                           the block's window accumulator in shared memory
//                           and writes the window cotangents (nz, ny, pch,
//                           nxb, wl) once, as csrc/scatter.cu would from
//                           pvals: the per-pair values never reach device
//                           memory
//
// Replaces the TPU kernel gpumd_tpu/engine/tersoff_compact.py:
// _tersoff_kernel (called through tersoff_kernel_call) and, in fused mode,
// the scatter after it (gpumd_tpu/engine/nep_compact.py: _scatter_kernel).
// The TPU kernel gathered all mn x A bond tiles with one-hot matmuls, ran
// the O(mn^2) zeta loop over every slot and took the gradient with
// jax.value_and_grad.  Here the gradient is derived by hand in the two
// passes of the reference (ref: src/force/tersoff1989.cu:337-520);
// engine/tersoff_compact.py states the formulas, and its
// tersoff_kernel_plain repeats them.
//
// What bounds it on the H100: bytes.  A block reads its window (4 x wl
// floats), centres (4 x a_pad) and neighbour lanes (mn x a_pad ints) and
// writes outf (16 x a_pad) and either pvals (pch x mn x a_pad, contract)
// or its window cotangents (pch x wl, fused), all once.  On a Si lattice
// about 4 of the 32 slots lie inside R2 (the first shell at 2.35 A; the
// second, at 3.84 A, lies beyond R2 = 3.0), so the pair-pair work is ~12
// terms per centre and pvals is seven parts in eight zeros: at Si 1M the
// contract mode moves 1.99 GB, 1.18 GB of it pvals; the fused mode 1.14 GB.
//
// Design: 128 threads a block, one centre a thread (tiles of 128 centres
// when a_pad > 128).  A block first puts all its global reads in flight:
// its centres and neighbour lanes (mn x 128 ints a tile) by cp.async into
// shared memory, its window by 16-byte loads that are transposed in
// registers into (x, y, z, type) float4 lanes, so that each slot gather is
// one 16-byte shared load; the slot loop then reads shared memory only.
// A thread first finds its live slots (d < R2: distance and type only)
// and then computes their bond terms, the q-th live bond of every thread
// of a warp at once, so that the exponentials and the cutoff run
// converged, not once for each slot that any thread finds live.  It keeps
// its live bonds in registers: at most kLiveCap of them, in fixed-size
// arrays that every loop indexes with unrolled constants (no local
// memory); the two passes run over them with warp-uniform guards on the
// live count.  A centre with more live bonds
// takes the general path of the same kernel (the bonds in per-thread
// arrays of MN entries, local memory), which no diamond-lattice centre
// reaches.  Each p_j is emitted as soon as pass 2 makes it: added to the
// centre's sums and, in fused mode, to lane idx[m, a] of the accumulator
// with a shared-memory atomic -- the very f32 value summed at the centre,
// so Newton's third law stays exact -- or, in contract mode, written over
// the zeros already stored in its slot.  Parked centre lanes (type -1)
// write zeros.  Divisions are the fast ones (__fdividef, 2 ulp), well
// inside the 1e-4 the plain version holds the kernel to.
// g(c) = 1 + c^2/d^2 - c^2/(d^2 + (c - h)^2) is computed as
// 1 + c^2 (c - h)^2 / (d^2 (d^2 + (c - h)^2)): the same function without
// the f32 cancellation of two ~3.8e7 terms (Si), as in the plain version.
#include <cuda_runtime.h>

namespace {

constexpr float kEps2 = 1.0e-6f;
constexpr float kPi = 3.14159265358979323846f;
constexpr int kThreads = 128;
// live bonds a centre kept in registers (tersoff_live_cap below): a
// diamond lattice has 4 inside R2
constexpr int kLiveCap = 6;
// resident blocks an SM the fused mode asks ptxas to fit in registers (128
// a thread, no spill); the contract mode, which spills at 128, is left to
// ptxas (~166: 3 blocks an SM)
constexpr int kFusedBlocks = 4;

// pair tables (T x T, padded to 4) and centre tables (T, padded to 2);
// the order of TersoffSpec.kernel_consts
struct TersoffConsts {
  float a[4], b[4], lam[4], mu[4], r1[4], r2[4];
  float beta[2], n[2], c2[2], d2[2], h[2];
};

// one live bond: unit vector, distance, fc, fc', fa (then w), the radial
// terms R = (fc' fr + fc fr')/2 (then S = R - b Q) and Q = (fc' fa +
// fc fa')/2, and its tag (window lane in fused mode, slot in contract)
struct Bond {
  float ux, uy, uz, d, fc, fcp, fa, rr, qq;
  int tag;
};

__device__ __forceinline__ int type_index(float code, int t) {
  return min(max(__float2int_rn(code), 0), t - 1);
}

// whether the slot holds a live bond: a real neighbour, not the centre
// itself, closer than R2 (d in bond_terms' ops)
__device__ __forceinline__ bool is_live(const TersoffConsts& k, int T,
                                        int ti, float4 w, float cx, float cy,
                                        float cz) {
  const float dx = w.x - cx, dy = w.y - cy, dz = w.z - cz;
  const float d2 = dx * dx + dy * dy + dz * dz;
  if (!(d2 > kEps2) || !(w.w > -0.5f)) return false;
  return d2 * rsqrtf(d2) < k.r2[ti * T + type_index(w.w, T)];
}

// the bond terms of a live slot.  e_half: fc fr / 2, the bond's repulsive
// energy
__device__ __forceinline__ void bond_terms(const TersoffConsts& k, int T,
                                           int ti, float4 w, float cx,
                                           float cy, float cz, Bond& bd,
                                           float& e_half) {
  const float dx = w.x - cx, dy = w.y - cy, dz = w.z - cz;
  const float d2 = dx * dx + dy * dy + dz * dz;
  const int pk = ti * T + type_index(w.w, T);
  const float r1 = k.r1[pk], r2 = k.r2[pk];
  const float inv_d = rsqrtf(d2);
  const float d = d2 * inv_d;
  const float span = fmaxf(r2 - r1, 1e-30f);
  const float x = fminf(fmaxf(__fdividef(d - r1, span), 0.0f), 1.0f);
  float sx, cxp;
  sincospif(x, &sx, &cxp);
  const float fcj = 0.5f * (1.0f + cxp);
  const float fcpj = d > r1 ? __fdividef(-0.5f * kPi * sx, span) : 0.0f;
  const float frj = k.a[pk] * expf(-k.lam[pk] * d);
  const float faj = k.b[pk] * expf(-k.mu[pk] * d);
  bd.ux = dx * inv_d;
  bd.uy = dy * inv_d;
  bd.uz = dz * inv_d;
  bd.d = d;
  bd.fc = fcj;
  bd.fcp = fcpj;
  bd.fa = faj;
  bd.rr = 0.5f * (fcpj - fcj * k.lam[pk]) * frj;
  bd.qq = 0.5f * (fcpj - fcj * k.mu[pk]) * faj;
  e_half = 0.5f * fcj * frj;
}

// the angular constants of the centre's type
struct Angle {
  float c2, d2c, hh, beta, nn;
};

// pass 1, bond q on bond j: fc_q g(c_jq)
__device__ __forceinline__ float zeta_term(const Bond& j, const Bond& q,
                                           const Angle& an) {
  const float cs = j.ux * q.ux + j.uy * q.uy + j.uz * q.uz;
  const float dh = cs - an.hh;
  const float dh2 = dh * dh;
  return q.fc * (1.0f + __fdividef(an.c2 * dh2, an.d2c * (an.d2c + dh2)));
}

// the end of pass 1 on bond j: b_j and b'_j from zeta_j, the attractive
// energy into e_i, S_j = R_j - b_j Q_j into rr, w_j = -fc_j fa_j b'_j / 2
// into fa
__device__ __forceinline__ void bond_order(Bond& j, float zeta,
                                           const Angle& an, float& e_i) {
  float bj = 1.0f, bpj = 0.0f;
  if (zeta > 1e-16f) {
    const float xz = powf(an.beta * zeta, an.nn);
    bj = powf(1.0f + xz, __fdividef(-0.5f, an.nn));
    bpj = __fdividef(-0.5f * bj * xz, zeta * (1.0f + xz));
  }
  e_i -= 0.5f * j.fc * bj * j.fa;
  j.rr -= bj * j.qq;
  j.fa *= -0.5f * j.fc * bpj;
}

// pass 2, bond q on bond j: w_q g(c_jq) into swg, the angular gradient
// (w_j fc_q + w_q fc_j) g'(c_jq) (u_q - c_jq u_j) into g
__device__ __forceinline__ void grad_term(const Bond& j, const Bond& q,
                                          const Angle& an, float& swg,
                                          float g[3]) {
  const float cs = j.ux * q.ux + j.uy * q.uy + j.uz * q.uz;
  const float dh = cs - an.hh;
  const float den = an.d2c + dh * dh;
  swg += q.fa * (1.0f + __fdividef(an.c2 * dh * dh, an.d2c * den));
  const float coef = (j.fa * q.fc + q.fa * j.fc) *
                     __fdividef(2.0f * an.c2 * dh, den * den);
  g[0] += coef * (q.ux - cs * j.ux);
  g[1] += coef * (q.uy - cs * j.uy);
  g[2] += coef * (q.uz - cs * j.uz);
}

// the end of pass 2 on bond j: p_j and r_j
__device__ __forceinline__ void bond_p(const Bond& j, float swg,
                                       const float g[3], float p[3],
                                       float r[3]) {
  const float rad = j.rr + j.fcp * swg;
  const float inv = __frcp_rn(j.d);
  p[0] = rad * j.ux + inv * g[0];
  p[1] = rad * j.uy + inv * g[1];
  p[2] = rad * j.uz + inv * g[2];
  r[0] = j.ux * j.d;
  r[1] = j.uy * j.d;
  r[2] = j.uz * j.d;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// where each p_j goes, and the centre's sums
template <bool FUSED, bool PAV>
struct Sink {
  float* acc;  // fused: (used, wl) accumulator in shared memory
  int wl;
  float* pv;   // contract: this centre's pvals column
  size_t pc;   // contract: channel stride (mn x a_pad)
  int a_pad;
  float sp[3];
  float vir[9];

  __device__ __forceinline__ void emit(const float p[3], const float r[3],
                                       int tag) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sp[c] += p[c];
    if (!PAV) {
#pragma unroll
      for (int av = 0; av < 3; ++av)
#pragma unroll
        for (int bv = 0; bv < 3; ++bv) vir[av * 3 + bv] -= r[av] * p[bv];
    }
    if (FUSED) {
      float* ac = acc + tag;
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(ac + c * wl, p[c]);
      if (PAV) {
#pragma unroll
        for (int av = 0; av < 3; ++av)
#pragma unroll
          for (int bv = 0; bv < 3; ++bv)
            atomicAdd(ac + (3 + av * 3 + bv) * wl, -r[av] * p[bv]);
      }
    } else {
      float* o = pv + (size_t)tag * a_pad;
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c * pc] = p[c];
      if (PAV) {
#pragma unroll
        for (int av = 0; av < 3; ++av)
#pragma unroll
          for (int bv = 0; bv < 3; ++bv)
            o[(3 + av * 3 + bv) * pc] = -r[av] * p[bv];
      }
    }
  }
};

// A centre with more than kLiveCap live bonds: the same two passes over
// per-thread arrays of MN entries (local memory).
template <int MN, bool FUSED, bool PAV>
__device__ __forceinline__ void centre_general(
    const float4* win4, const int* il, int mn, float4 ce, int ti,
    const TersoffConsts& k, int T, const Angle& an, Sink<FUSED, PAV>& sink,
    float& e_i) {
  Bond bd[MN];
  int L = 0;
  e_i = 0.0f;
  for (int m = 0; m < mn; ++m) {
    const int lane = il[m * kThreads];
    const float4 w = win4[lane];
    if (!is_live(k, T, ti, w, ce.x, ce.y, ce.z)) continue;
    float e_half;
    bond_terms(k, T, ti, w, ce.x, ce.y, ce.z, bd[L], e_half);
    bd[L].tag = FUSED ? lane : m;
    e_i += e_half;
    ++L;
  }
  for (int j = 0; j < L; ++j) {
    float zeta = 0.0f;
    for (int q = 0; q < L; ++q)
      if (q != j) zeta += zeta_term(bd[j], bd[q], an);
    bond_order(bd[j], zeta, an, e_i);
  }
  for (int j = 0; j < L; ++j) {
    float swg = 0.0f, g[3] = {0.0f, 0.0f, 0.0f}, p[3], r[3];
    for (int q = 0; q < L; ++q)
      if (q != j) grad_term(bd[j], bd[q], an, swg, g);
    bond_p(bd[j], swg, g, p, r);
    sink.emit(p, r, bd[j].tag);
  }
}

// one centre: gather its slots from the staged window through its lanes
// il (stride kThreads in shared memory), keep the live bonds, run both
// passes, emit every p_j, write its outf column.
template <int MN, bool FUSED, bool PAV>
__device__ __forceinline__ void centre(const float4* win4, const int* il,
                                       float4 ce, int a_pad, int mn,
                                       const TersoffConsts& k, int T,
                                       float* of, Sink<FUSED, PAV>& sink) {
  if (!FUSED) {  // every slot zero first; pass 2 writes over the live ones
    constexpr int pch = PAV ? 12 : 4;
    for (int m = 0; m < mn; ++m)
#pragma unroll
      for (int c = 0; c < pch; ++c)
        sink.pv[c * sink.pc + (size_t)m * a_pad] = 0.0f;
  }
  if (!(ce.w > -0.5f)) {  // parked centre lane
#pragma unroll
    for (int r = 0; r < 16; ++r) of[r * a_pad] = 0.0f;
    return;
  }
  const int ti = type_index(ce.w, T);
  const Angle an = {k.c2[ti], k.d2[ti], k.h[ti], k.beta[ti], k.n[ti]};

  // the live slots first (distance and type only), their bond terms
  // after, all threads of a warp on their q-th live bond together
  int live[kLiveCap];
  int L = 0;
#pragma unroll 4
  for (int m = 0; m < mn; ++m) {
    const float4 w = win4[il[m * kThreads]];
    if (!is_live(k, T, ti, w, ce.x, ce.y, ce.z)) continue;
#pragma unroll
    for (int q = 0; q < kLiveCap; ++q)
      if (q == L) live[q] = m;
    ++L;
  }
  Bond bd[kLiveCap];
  float e_i = 0.0f;
#pragma unroll
  for (int q = 0; q < kLiveCap; ++q) {
    if (q >= L) break;
    const int lane = il[live[q] * kThreads];
    float e_half;
    bond_terms(k, T, ti, win4[lane], ce.x, ce.y, ce.z, bd[q], e_half);
    bd[q].tag = FUSED ? lane : live[q];
    e_i += e_half;
  }

#pragma unroll
  for (int c = 0; c < 3; ++c) sink.sp[c] = 0.0f;
#pragma unroll
  for (int c = 0; c < 9; ++c) sink.vir[c] = 0.0f;

  if (L > kLiveCap) {
    centre_general<MN, FUSED, PAV>(win4, il, mn, ce, ti, k, T, an, sink,
                                   e_i);
  } else {
#pragma unroll
    for (int j = 0; j < kLiveCap; ++j) {  // pass 1
      if (j >= L) break;
      float zeta = 0.0f;
#pragma unroll
      for (int q = 0; q < kLiveCap; ++q) {
        if (q >= L) break;
        if (q != j) zeta += zeta_term(bd[j], bd[q], an);
      }
      bond_order(bd[j], zeta, an, e_i);
    }
#pragma unroll
    for (int j = 0; j < kLiveCap; ++j) {  // pass 2: p_j, emitted at once
      if (j >= L) break;
      float swg = 0.0f, g[3] = {0.0f, 0.0f, 0.0f}, p[3], r[3];
#pragma unroll
      for (int q = 0; q < kLiveCap; ++q) {
        if (q >= L) break;
        if (q != j) grad_term(bd[j], bd[q], an, swg, g);
      }
      bond_p(bd[j], swg, g, p, r);
      sink.emit(p, r, bd[j].tag);
    }
  }

#pragma unroll
  for (int c = 0; c < 3; ++c) of[c * a_pad] = -sink.sp[c];
#pragma unroll
  for (int c = 0; c < 9; ++c) of[(3 + c) * a_pad] = sink.vir[c];
  of[12 * a_pad] = e_i;
#pragma unroll
  for (int c = 13; c < 16; ++c) of[c * a_pad] = 0.0f;
}

// a tile of kThreads centres: their coordinates (4, kThreads) and their
// neighbour lanes (mn, kThreads) by cp.async into shared memory (the
// commit is the caller's)
__device__ __forceinline__ void stage_tile(float* sctr, int* sidx,
                                           const float* ctr, const int* ib,
                                           int a_pad, int a0, int mn,
                                           int tid) {
  constexpr int row = kThreads / 4;  // 16-byte pieces a row
  for (int i = tid; i < 4 * row; i += kThreads) {
    const int c = i / row, u = i - c * row;
    if (a0 + 4 * u < a_pad)
      cp_async16(sctr + c * kThreads + 4 * u, ctr + c * a_pad + a0 + 4 * u);
  }
  for (int i = tid; i < mn * row; i += kThreads) {
    const int m = i / row, u = i - m * row;
    if (a0 + 4 * u < a_pad)
      cp_async16(sidx + m * kThreads + 4 * u,
                 ib + (size_t)m * a_pad + a0 + 4 * u);
  }
}

template <int MN, bool FUSED, bool PAV>
__device__ __forceinline__ void tersoff_body(
    const float* __restrict__ centers, const float* __restrict__ cand,
    const int* __restrict__ idx, float* __restrict__ outf,
    float* __restrict__ pvals, float* __restrict__ dcand,
    const TersoffConsts& k, int T, int a_pad, int wl, int mn, int pch,
    int nxb) {
  // shared memory: the window (wl float4 lanes), a tile's centres (4,
  // kThreads) and lanes (mn, kThreads), fused: the accumulator (used, wl)
  extern __shared__ float4 smem[];
  float4* win4 = smem;
  float* sctr = reinterpret_cast<float*>(smem + wl);
  int* sidx = reinterpret_cast<int*>(sctr + 4 * kThreads);
  float* acc = reinterpret_cast<float*>(sidx + mn * kThreads);
  constexpr int used = PAV ? 12 : 3;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ctr = centers + (size_t)b * 4 * a_pad;
  const size_t pc = (size_t)mn * a_pad;
  const int* ibase = idx + (size_t)b * pc;

  stage_tile(sctr, sidx, ctr, ibase, a_pad, 0, mn, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  const float4* cb = reinterpret_cast<const float4*>(cand + (size_t)b * 4 * wl);
  const int w4 = wl / 4;
  for (int u = tid; u < w4; u += kThreads) {
    const float4 x = cb[u], y = cb[w4 + u], z = cb[2 * w4 + u],
                 t = cb[3 * w4 + u];
    win4[4 * u] = make_float4(x.x, y.x, z.x, t.x);
    win4[4 * u + 1] = make_float4(x.y, y.y, z.y, t.y);
    win4[4 * u + 2] = make_float4(x.z, y.z, z.z, t.z);
    win4[4 * u + 3] = make_float4(x.w, y.w, z.w, t.w);
  }
  if (FUSED) {
    float4* a4 = reinterpret_cast<float4*>(acc);
    for (int i = tid; i < used * w4; i += kThreads)
      a4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  Sink<FUSED, PAV> sink;
  sink.acc = acc;
  sink.wl = wl;
  sink.pc = pc;
  sink.a_pad = a_pad;
  for (int a0 = 0; a0 < a_pad; a0 += kThreads) {
    if (a0) {  // the next tile, once every thread is done with this one
      __syncthreads();
      stage_tile(sctr, sidx, ctr, ibase, a_pad, a0, mn, tid);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    const int a = a0 + tid;
    if (a < a_pad) {
      const float4 ce = make_float4(sctr[tid], sctr[kThreads + tid],
                                    sctr[2 * kThreads + tid],
                                    sctr[3 * kThreads + tid]);
      sink.pv = FUSED ? nullptr : pvals + (size_t)b * pch * pc + a;
      centre<MN, FUSED, PAV>(win4, sidx + tid, ce, a_pad, mn, k, T,
                             outf + (size_t)b * 16 * a_pad + a, sink);
    }
  }

  if (FUSED) {
    __syncthreads();
    const int zy = b / nxb, xb = b - zy * nxb;
    const float4* a4 = reinterpret_cast<const float4*>(acc);
    for (int i = tid; i < pch * w4; i += kThreads) {
      const int c = i / w4, l = i - c * w4;
      float4* o = reinterpret_cast<float4*>(
          dcand + (((size_t)zy * pch + c) * nxb + xb) * wl);
      o[l] = c < used ? a4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

template <int MN, bool PAV>
__global__ void __launch_bounds__(kThreads)
    tersoff_kernel(const float* __restrict__ centers,
                   const float* __restrict__ cand,
                   const int* __restrict__ idx, float* __restrict__ outf,
                   float* __restrict__ pvals, const TersoffConsts k, int T,
                   int a_pad, int wl, int mn, int pch) {
  tersoff_body<MN, false, PAV>(centers, cand, idx, outf, pvals, nullptr, k,
                               T, a_pad, wl, mn, pch, 1);
}

template <int MN, bool PAV>
__global__ void __launch_bounds__(kThreads, kFusedBlocks)
    tersoff_scatter_kernel(const float* __restrict__ centers,
                           const float* __restrict__ cand,
                           const int* __restrict__ idx,
                           float* __restrict__ outf,
                           float* __restrict__ dcand, const TersoffConsts k,
                           int T, int a_pad, int wl, int mn, int pch,
                           int nxb) {
  tersoff_body<MN, true, PAV>(centers, cand, idx, outf, nullptr, dcand, k, T,
                              a_pad, wl, mn, pch, nxb);
}

size_t smem_bytes(bool fused, int pav, int wl, int mn) {
  return sizeof(float) * ((size_t)wl * (4 + (fused ? (pav ? 12 : 3) : 0)) +
                          (size_t)(4 + mn) * kThreads);
}

TersoffConsts read_consts(const float* consts) {
  TersoffConsts k;
  const float* src = consts;
  float* dst[] = {k.a, k.b, k.lam, k.mu, k.r1, k.r2};
  for (float* t : dst)
    for (int i = 0; i < 4; ++i) t[i] = *src++;
  float* dst_c[] = {k.beta, k.n, k.c2, k.d2, k.h};
  for (float* t : dst_c)
    for (int i = 0; i < 2; ++i) t[i] = *src++;
  return k;
}

// the kernel instance for (fused, mn, pav), or nullptr past mn 128
const void* entry(bool fused, int mn, int pav) {
#define GK_TERSOFF_ENTRY(MN)                                              \
  if (mn <= MN) {                                                         \
    if (fused)                                                            \
      return pav ? (const void*)tersoff_scatter_kernel<MN, true>          \
                 : (const void*)tersoff_scatter_kernel<MN, false>;        \
    return pav ? (const void*)tersoff_kernel<MN, true>                    \
               : (const void*)tersoff_kernel<MN, false>;                  \
  }
  GK_TERSOFF_ENTRY(32)
  GK_TERSOFF_ENTRY(64)
  GK_TERSOFF_ENTRY(128)
#undef GK_TERSOFF_ENTRY
  return nullptr;
}

int launch(bool fused, const float* centers, const float* cand,
           const int* idx, float* outf, float* out, const float* consts,
           int nb, int a_pad, int wl, int mn, int pch, int pav,
           int num_types, int nxb, cudaStream_t stream) {
  const void* fn = entry(fused, mn, pav);
  if (fn == nullptr || wl % 4 || a_pad % 4 || num_types < 1 ||
      num_types > 2 || pch != (pav ? 12 : 4))
    return (int)cudaErrorInvalidValue;
  const TersoffConsts k = read_consts(consts);
  const size_t smem = smem_bytes(fused, pav, wl, mn);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int T = num_types;
  void* args_c[] = {&centers, &cand, &idx, &outf, &out, (void*)&k, &T,
                    &a_pad, &wl, &mn, &pch};
  void* args_f[] = {&centers, &cand, &idx, &outf, &out, (void*)&k, &T,
                    &a_pad, &wl, &mn, &pch, &nxb};
  err = cudaLaunchKernel(fn, dim3(nb), dim3(kThreads),
                         fused ? args_f : args_c, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// consts: 34 host floats in TersoffConsts order; 128 threads a block, one
// centre lane a thread (a_pad > 128 loops).  wl and a_pad multiples of 4
// (16-byte copies), at most 2 types, mn <= 128, pch 4 (pav 0) or 12.
extern "C" int tersoff_launch(const float* centers, const float* cand,
                              const int* idx, float* outf, float* pvals,
                              const float* consts, int nb, int a_pad, int wl,
                              int mn, int pch, int pav, int num_types,
                              void* stream) {
  return launch(false, centers, cand, idx, outf, pvals, consts, nb, a_pad,
                wl, mn, pch, pav, num_types, 1, (cudaStream_t)stream);
}

// the fused mode: dcand (nz, ny, pch, nxb, wl), the layout scatter_launch
// writes
extern "C" int tersoff_scatter_launch(const float* centers,
                                      const float* cand, const int* idx,
                                      float* outf, float* dcand,
                                      const float* consts, int nb, int a_pad,
                                      int wl, int mn, int pch, int pav,
                                      int num_types, int nxb, void* stream) {
  return launch(true, centers, cand, idx, outf, dcand, consts, nb, a_pad, wl,
                mn, pch, pav, num_types, nxb, (cudaStream_t)stream);
}

// resident blocks an SM of the instance (fused, mn, pav) at window wl, by
// the occupancy query; its shared memory a block in *smem
extern "C" int tersoff_occupancy(int fused, int mn, int pav, int wl,
                                 int* blocks, int* smem) {
  const void* fn = entry(fused != 0, mn, pav);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(fused != 0, pav, wl, mn);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *smem = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            kThreads, bytes);
}

// the live bonds a centre keeps in registers; a centre with more takes the
// general path
extern "C" int tersoff_live_cap() { return kLiveCap; }
