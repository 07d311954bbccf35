// Tersoff-1989: per-atom energy, centre gradient, virial rows and per-pair
// cotangents p_ij = dE_i/dr_ij on the compact engine's bond tiles.
//
// Replaces the TPU kernel gpumd_tpu/engine/tersoff_compact.py:
// _tersoff_kernel (called through tersoff_kernel_call).  The TPU kernel
// gathered all mn x A bond tiles with one-hot matmuls, ran the O(mn^2) zeta
// loop over every slot and took the gradient with jax.value_and_grad.
// Here the gradient is derived by hand in the two passes of the reference
// (ref: src/force/tersoff1989.cu:337-520); engine/tersoff_compact.py
// states the formulas, and its tersoff_kernel_plain repeats them.
//
// What bounds it on the H100: bytes.  Per block it reads the window (4 x wl
// floats), the centres (4 x a_pad) and the neighbour lanes (mn x a_pad
// ints), and writes outf (16 x a_pad) and pvals (pch x mn x a_pad), all
// once.  The arithmetic is small: on a Si lattice about 4 of the 32 slots
// lie inside R2 (the first shell at 2.35 A; the second, at 3.84 A, lies
// beyond R2 = 3.0), so the pair-pair work is ~12 terms per centre, not
// mn^2 = 1024.
//
// Design: one block per grid block, one thread per centre lane.  The
// block's window is staged in shared memory (18 KB at wl 1152); each
// thread gathers its slots from it, keeps the live ones (d < R2) in
// per-thread arrays (local memory, cached in L1), runs both passes over
// them, and writes every slot's pvals in slot order, so that the writes of
// a warp coalesce.  A dead slot gets p = 0, as the TPU kernel's gradient
// gives it.  Parked centre lanes (type -1) write zeros.
// g(c) = 1 + c^2/d^2 - c^2/(d^2 + (c - h)^2) is computed as
// 1 + c^2 (c - h)^2 / (d^2 (d^2 + (c - h)^2)): the same function without
// the f32 cancellation of two ~3.8e7 terms (Si), as in the plain version.
#include <cuda_runtime.h>

namespace {

constexpr float kEps2 = 1.0e-6f;
constexpr float kPi = 3.14159265358979323846f;

// pair tables (T x T, padded to 4) and centre tables (T, padded to 2);
// the order of TersoffSpec.kernel_consts
struct TersoffConsts {
  float a[4], b[4], lam[4], mu[4], r1[4], r2[4];
  float beta[2], n[2], c2[2], d2[2], h[2];
};

__device__ __forceinline__ int type_index(float code, int t) {
  return min(max(__float2int_rn(code), 0), t - 1);
}

template <int MAXN>
__global__ void tersoff_kernel(const float* __restrict__ centers,
                               const float* __restrict__ cand,
                               const int* __restrict__ idx,
                               float* __restrict__ outf,
                               float* __restrict__ pvals,
                               const TersoffConsts k, int num_types,
                               int a_pad, int wl, int mn, int pch, int pav) {
  extern __shared__ float win[];  // (4, wl)
  const int b = blockIdx.x;
  const float* cb = cand + (size_t)b * 4 * wl;
  for (int i = threadIdx.x; i < 4 * wl; i += blockDim.x) win[i] = cb[i];
  __syncthreads();
  const int a = threadIdx.x;
  const float* ce = centers + (size_t)b * 4 * a_pad + a;
  const float cx = ce[0], cy = ce[a_pad], cz = ce[2 * a_pad],
              ct = ce[3 * a_pad];
  float* of = outf + (size_t)b * 16 * a_pad + a;
  const size_t pc = (size_t)mn * a_pad;
  float* pv = pvals + (size_t)b * pch * pc + a;
  const int* ib = idx + (size_t)b * pc + a;
  if (!(ct > -0.5f)) {  // parked centre lane
    for (int r = 0; r < 16; ++r) of[r * a_pad] = 0.0f;
    for (int c = 0; c < pch; ++c)
      for (int m = 0; m < mn; ++m) pv[c * pc + (size_t)m * a_pad] = 0.0f;
    return;
  }
  const int T = num_types;
  const int ti = type_index(ct, T);
  const float c2 = k.c2[ti], d2c = k.d2[ti], hh = k.h[ti];
  const float beta = k.beta[ti], nn = k.n[ti];

  // live slots: unit vector, distance, fc, fc', fa (then w), the radial
  // terms R = (fc' fr + fc fr')/2 and Q = (fc' fa + fc fa')/2 (then the
  // bond's p), and the slot index
  float ux[MAXN], uy[MAXN], uz[MAXN], dd[MAXN], fc[MAXN], fcp[MAXN];
  float fa[MAXN], rr[MAXN], qq[MAXN];
  int slot[MAXN];
  int L = 0;
  float e_i = 0.0f;
  for (int m = 0; m < mn; ++m) {
    const int lane = ib[(size_t)m * a_pad];
    const float dx = win[lane] - cx, dy = win[wl + lane] - cy,
                dz = win[2 * wl + lane] - cz, tj = win[3 * wl + lane];
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (!(d2 > kEps2) || !(tj > -0.5f)) continue;
    const int pk = ti * T + type_index(tj, T);
    const float r1 = k.r1[pk], r2 = k.r2[pk];
    const float inv_d = rsqrtf(d2);
    const float d = d2 * inv_d;
    if (!(d < r2)) continue;
    const float span = fmaxf(r2 - r1, 1e-30f);
    const float x = fminf(fmaxf((d - r1) / span, 0.0f), 1.0f);
    float sx, cxp;
    sincospif(x, &sx, &cxp);
    const float fcj = 0.5f * (1.0f + cxp);
    const float fcpj = d > r1 ? -0.5f * kPi * sx / span : 0.0f;
    const float frj = k.a[pk] * expf(-k.lam[pk] * d);
    const float faj = k.b[pk] * expf(-k.mu[pk] * d);
    ux[L] = dx * inv_d;
    uy[L] = dy * inv_d;
    uz[L] = dz * inv_d;
    dd[L] = d;
    fc[L] = fcj;
    fcp[L] = fcpj;
    fa[L] = faj;
    rr[L] = 0.5f * (fcpj - fcj * k.lam[pk]) * frj;
    qq[L] = 0.5f * (fcpj - fcj * k.mu[pk]) * faj;
    slot[L] = m;
    e_i += 0.5f * fcj * frj;
    ++L;
  }

  // pass 1: zeta_j, b_j and b'_j; E_i; S_j = R_j - b_j Q_j into rr and
  // w_j = -fc_j fa_j b'_j / 2 into fa
  for (int j = 0; j < L; ++j) {
    float zeta = 0.0f;
    for (int q = 0; q < L; ++q) {
      if (q == j) continue;
      const float dh = ux[j] * ux[q] + uy[j] * uy[q] + uz[j] * uz[q] - hh;
      const float dh2 = dh * dh;
      zeta += fc[q] * (1.0f + c2 * dh2 / (d2c * (d2c + dh2)));
    }
    float bj = 1.0f, bpj = 0.0f;
    if (zeta > 1e-16f) {
      const float xz = powf(beta * zeta, nn);
      bj = powf(1.0f + xz, -0.5f / nn);
      bpj = -0.5f * bj * xz / (zeta * (1.0f + xz));
    }
    e_i -= 0.5f * fc[j] * bj * fa[j];
    rr[j] -= bj * qq[j];
    fa[j] *= -0.5f * fc[j] * bpj;
  }

  // pass 2: p_j, stored over (qq, rr, fcp) of slot j once j is done
  float sp[3] = {0.0f, 0.0f, 0.0f};
  float vir[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < L; ++j) {
    float swg = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
    for (int q = 0; q < L; ++q) {
      if (q == j) continue;
      const float cs = ux[j] * ux[q] + uy[j] * uy[q] + uz[j] * uz[q];
      const float dh = cs - hh;
      const float den = d2c + dh * dh;
      swg += fa[q] * (1.0f + c2 * dh * dh / (d2c * den));
      const float coef =
          (fa[j] * fc[q] + fa[q] * fc[j]) * (2.0f * c2 * dh / (den * den));
      gx += coef * (ux[q] - cs * ux[j]);
      gy += coef * (uy[q] - cs * uy[j]);
      gz += coef * (uz[q] - cs * uz[j]);
    }
    const float rad = rr[j] + fcp[j] * swg;
    const float inv = 1.0f / dd[j];
    const float p[3] = {rad * ux[j] + inv * gx, rad * uy[j] + inv * gy,
                        rad * uz[j] + inv * gz};
    const float r[3] = {ux[j] * dd[j], uy[j] * dd[j], uz[j] * dd[j]};
    for (int c = 0; c < 3; ++c) sp[c] += p[c];
    if (!pav)
      for (int av = 0; av < 3; ++av)
        for (int bv = 0; bv < 3; ++bv) vir[av * 3 + bv] -= r[av] * p[bv];
    qq[j] = p[0];
    rr[j] = p[1];
    fcp[j] = p[2];
  }

  for (int c = 0; c < 3; ++c) of[c * a_pad] = -sp[c];
  for (int c = 0; c < 9; ++c) of[(3 + c) * a_pad] = vir[c];
  of[12 * a_pad] = e_i;
  for (int c = 13; c < 16; ++c) of[c * a_pad] = 0.0f;

  // every slot in order: the live ones' p (and -r_a p_b), zeros elsewhere
  int q = 0;
  const int used = pav ? 12 : 3;
  for (int m = 0; m < mn; ++m) {
    float p[3] = {0.0f, 0.0f, 0.0f}, r[3] = {0.0f, 0.0f, 0.0f};
    if (q < L && slot[q] == m) {
      p[0] = qq[q];
      p[1] = rr[q];
      p[2] = fcp[q];
      r[0] = ux[q] * dd[q];
      r[1] = uy[q] * dd[q];
      r[2] = uz[q] * dd[q];
      ++q;
    }
    float* o = pv + (size_t)m * a_pad;
    for (int c = 0; c < 3; ++c) o[c * pc] = p[c];
    if (pav)
      for (int av = 0; av < 3; ++av)
        for (int bv = 0; bv < 3; ++bv)
          o[(3 + av * 3 + bv) * pc] = -r[av] * p[bv];
    for (int c = used; c < pch; ++c) o[c * pc] = 0.0f;
  }
}

template <int MAXN>
int launch(const float* centers, const float* cand, const int* idx,
           float* outf, float* pvals, const TersoffConsts& k, int nb,
           int a_pad, int wl, int mn, int pch, int pav, int num_types,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)wl;
  cudaFuncSetAttribute(tersoff_kernel<MAXN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  tersoff_kernel<MAXN><<<nb, a_pad, smem, stream>>>(
      centers, cand, idx, outf, pvals, k, num_types, a_pad, wl, mn, pch,
      pav);
  return (int)cudaGetLastError();
}

}  // namespace

// consts: 34 host floats in TersoffConsts order.  One thread per centre
// lane: a_pad threads per block (a multiple of 32, at most 1024).
extern "C" int tersoff_launch(const float* centers, const float* cand,
                              const int* idx, float* outf, float* pvals,
                              const float* consts, int nb, int a_pad, int wl,
                              int mn, int pch, int pav, int num_types,
                              void* stream) {
  TersoffConsts k;
  const float* src = consts;
  float* dst[] = {k.a, k.b, k.lam, k.mu, k.r1, k.r2};
  for (float* t : dst)
    for (int i = 0; i < 4; ++i) t[i] = *src++;
  float* dst_c[] = {k.beta, k.n, k.c2, k.d2, k.h};
  for (float* t : dst_c)
    for (int i = 0; i < 2; ++i) t[i] = *src++;
  cudaStream_t s = (cudaStream_t)stream;
  if (mn <= 32)
    return launch<32>(centers, cand, idx, outf, pvals, k, nb, a_pad, wl, mn,
                      pch, pav, num_types, s);
  if (mn <= 64)
    return launch<64>(centers, cand, idx, outf, pvals, k, nb, a_pad, wl, mn,
                      pch, pav, num_types, s);
  if (mn <= 128)
    return launch<128>(centers, cand, idx, outf, pvals, k, nb, a_pad, wl,
                       mn, pch, pav, num_types, s);
  return (int)cudaErrorInvalidValue;
}
