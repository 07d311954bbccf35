// Probe kernels: the instruments that chose the TPU kernels' designs,
// rebuilt for Hopper.  Each replaces one Pallas kernel of the probe scripts:
//
//   probe_gather_kernel        scripts/bench_gather.py:kern (pallas_gather)
//   probe_trans_kernel         scripts/probe_transcendentals.py:kernel (run)
//   probe_onehot_kernel        scripts/bench_mxu_probes.py:_dot_kernel
//                              (onehot_dot)
//   probe_feature_kernel       scripts/bench_mxu_probes.py:_feat_kernel
//                              (feature_matmul)
//   probe_reduce_{spill,tiled} scripts/bench_mxu_probes.py:
//                              _reduce_spill_kernel, _reduce_tiled_kernel
//                              (pair_reduce)
//   probe_bgather_kernel       scripts/bench_mxu_probes.py:_bgather_kernel
//                              (bgather)
//
// Every kernel is bound by bytes on the H100 at the scripts' shapes (the
// transcendentals by its launch); each note says what its design does.
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>

using namespace nvcuda;

// ---------------------------------------------------------------------------
// gather: out[g, s, l] = table[g, idx[g, s, l], l]
//
// One thread per output element: neighbouring threads hold neighbouring
// lanes, so the idx read and the out write coalesce and the table reads of a
// warp fall in the 32-byte sectors of their rows; read-only loads.  Indices
// lie in [0, w); the guard only keeps a bad one from reading out of bounds.
// ---------------------------------------------------------------------------

__global__ void probe_gather_kernel(const float* __restrict__ table,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out, int w, int s,
                                    int lanes, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long g = i / ((long long)s * lanes);
  const int l = (int)(i % lanes);
  const int j = __ldg(idx + i);
  out[i] = (j >= 0 && j < w) ? __ldg(table + (g * w + j) * lanes + l) : 0.0f;
}

extern "C" int probe_gather_launch(const float* table, const int* idx,
                                   float* out, int g, int w, int s,
                                   int lanes, void* stream) {
  const long long total = (long long)g * s * lanes;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  probe_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, idx, out, w, s, lanes, total);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// transcendentals: rsqrt, cos, sin elementwise, with the CUDA math library
// functions the port's kernels call (rsqrtf, cosf, sinf) under the same
// nvcc flags (no --use_fast_math), so the probe measures what they get.
// ---------------------------------------------------------------------------

__global__ void probe_trans_kernel(const float* __restrict__ x,
                                   float* __restrict__ r,
                                   float* __restrict__ c,
                                   float* __restrict__ s, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  r[i] = rsqrtf(v);
  c[i] = cosf(v);
  s[i] = sinf(v);
}

extern "C" int probe_trans_launch(const float* x, float* r, float* c,
                                  float* s, int n, void* stream) {
  const int threads = 256;
  probe_trans_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(x, r, c, s, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Shared by the two matrix-product probes: eight warps, each owning one
// 16-column tile of the output; TF32 tensor-core tiles m16n16k8 with f32
// accumulation (the counterpart of the MXU's Precision.DEFAULT); leading
// dimensions padded by 4 floats (wmma's tf32 loads need multiples of 4 and
// 32-byte aligned tiles, which these offsets keep).
// ---------------------------------------------------------------------------

namespace {
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 16 * kWarps;  // output columns a block covers
constexpr int kNLd = kMaxN + 4;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                             wmma::precision::tf32, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                             wmma::precision::tf32, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

template <class Frag>
__device__ __forceinline__ void load_tf32(Frag& f, const float* p, int ld) {
  wmma::load_matrix_sync(f, p, ld);
#pragma unroll
  for (int e = 0; e < f.num_elements; ++e) f.x[e] = wmma::__float_to_tf32(f.x[e]);
}

// Store a 16x16 accumulator tile through the warp's 256-float scratch:
// rows at or past `m_valid` are padding and are not written.
__device__ __forceinline__ void store_tile(const FragC& acc, float* scratch,
                                           float* out, int ld_out,
                                           int m_valid, int lane) {
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32)
    if (e / 16 < m_valid) out[(size_t)(e / 16) * ld_out + e % 16] = scratch[e];
  __syncwarp();
}
}  // namespace

// ---------------------------------------------------------------------------
// one-hot dot: out[b] = vals[b] (m x k) @ R (k x n), R[i, j] = 1 where
// (7919 j) mod n == j, the same column mask for every row i; k is summed in
// `ksplit` parts, each in its own accumulator, added at the end.
//
// Bound: bytes (vals read once: at (144, 4096, 128) the product is 64 FLOP
// per byte read, under the TF32 ridge of ~148).  Design: a block takes
// kOhMT 16-row tiles of one b, so vals is read exactly once; each step
// stages a (48 x 32) slab of vals in shared memory, zero-filled past m and
// past the part's end, so m 72, 88, 108 and any k pad to whole tiles; R's
// (32 x n) tile is built once in shared memory (its rows are all alike).
// TF32: each warp runs its column tile against the block's row tiles.
// F32 (Precision.HIGHEST): thread (warp, lane) keeps 6 rows x 4 columns of
// FFMA accumulators fed from the same shared tiles.
// ---------------------------------------------------------------------------

namespace {
constexpr int kOhMT = 3;            // 16-row tiles a block
constexpr int kOhRows = 16 * kOhMT;
constexpr int kOhKC = 32;           // k columns staged a step
constexpr int kOhALd = kOhKC + 4;
}  // namespace

template <bool TF32>
__global__ void __launch_bounds__(kThreads)
probe_onehot_kernel(const float* __restrict__ vals, float* __restrict__ out,
                    int m, int k, int n, int ksplit, int mgroups) {
  __shared__ __align__(32) float As[kOhRows * kOhALd];
  __shared__ __align__(32) float Rs[kOhKC * kNLd];
  __shared__ __align__(32) float scratch[kWarps * 256];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / mgroups;
  const int m0 = (blockIdx.x % mgroups) * kOhRows;
  const int rows = min(kOhRows, m - m0);
  const float* vb = vals + ((size_t)b * m + m0) * k;
  for (int e = tid; e < kOhKC * kMaxN; e += kThreads) {
    const int j = e % kMaxN;
    Rs[(e / kMaxN) * kNLd + j] = (j < n && (j * 7919) % n == j) ? 1.0f : 0.0f;
  }
  const int kp = k / ksplit;

  FragC tot[kOhMT], acc[kOhMT];
  float ftot[6][4], facc[6][4];
  if (TF32) {
#pragma unroll
    for (int t = 0; t < kOhMT; ++t) wmma::fill_fragment(tot[t], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ftot[i][j] = 0.0f;
  }
  for (int p = 0; p < ksplit; ++p) {
    if (TF32) {
#pragma unroll
      for (int t = 0; t < kOhMT; ++t) wmma::fill_fragment(acc[t], 0.0f);
    } else {
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;
    }
    const int kend = (p + 1) * kp;
    for (int k0 = p * kp; k0 < kend; k0 += kOhKC) {
      __syncthreads();  // the last step's reads of As are done
#pragma unroll
      for (int s = 0; s < kOhRows * kOhKC / kThreads; ++s) {
        const int e = tid + s * kThreads;
        const int r = e / kOhKC, c = e % kOhKC;
        As[r * kOhALd + c] = (r < rows && k0 + c < kend)
                                 ? __ldg(vb + (size_t)r * k + k0 + c)
                                 : 0.0f;
      }
      __syncthreads();
      if (TF32) {
        if (warp * 16 < n) {
#pragma unroll
          for (int kk = 0; kk < kOhKC; kk += 8) {
            FragB bf;
            load_tf32(bf, Rs + kk * kNLd + warp * 16, kNLd);
#pragma unroll
            for (int t = 0; t < kOhMT; ++t) {
              if (t * 16 < rows) {
                FragA af;
                load_tf32(af, As + t * 16 * kOhALd + kk, kOhALd);
                wmma::mma_sync(acc[t], af, bf, acc[t]);
              }
            }
          }
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < kOhKC; ++kk) {
          float a[6], bv[4];
#pragma unroll
          for (int i = 0; i < 6; ++i) a[i] = As[(warp + 8 * i) * kOhALd + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Rs[kk * kNLd + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], bv[j], facc[i][j]);
        }
      }
    }
    if (TF32) {
#pragma unroll
      for (int t = 0; t < kOhMT; ++t)
#pragma unroll
        for (int e = 0; e < tot[t].num_elements; ++e) tot[t].x[e] += acc[t].x[e];
    } else {
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ftot[i][j] += facc[i][j];
    }
  }

  float* ob = out + ((size_t)b * m + m0) * n;
  if (TF32) {
    if (warp * 16 < n) {
#pragma unroll
      for (int t = 0; t < kOhMT; ++t)
        if (t * 16 < rows)
          store_tile(tot[t], scratch + warp * 256,
                     ob + (size_t)t * 16 * n + warp * 16, n, rows - t * 16,
                     lane);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = warp + 8 * i, c = lane + 32 * j;
        if (r < rows && c < n) ob[(size_t)r * n + c] = ftot[i][j];
      }
  }
}

extern "C" int probe_onehot_launch(const float* vals, float* out, int nb,
                                   int m, int k, int n, int ksplit, int tf32,
                                   void* stream) {
  if (n % 16 || n > kMaxN || ksplit < 1 || k % ksplit)
    return (int)cudaErrorInvalidValue;
  const int mgroups = (m + kOhRows - 1) / kOhRows;
  const unsigned blocks = (unsigned)nb * mgroups;
  if (tf32)
    probe_onehot_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        vals, out, m, k, n, ksplit, mgroups);
  else
    probe_onehot_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        vals, out, m, k, n, ksplit, mgroups);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// feature matmul: out[b] = sum over the mn/8 chunks c of
// big (ch x 8k) @ vals[b, 8k c : 8k (c+1), :] (8k x lanes), where big is
// eye(ch, k) repeated 8 times along its columns.
//
// Bound: bytes (vals read once, out written once; 19 GFLOP of TF32 at the
// script's shapes is far under it).  Design: a block per b holds all of its
// output rows (up to kFtMT 16-row tiles, ch 24 and 168 padded to 32 and
// 176) as TF32 accumulators; big is built once in dynamic shared memory;
// each chunk of vals (8k x lanes) is staged with 16-byte loads and every
// warp runs its 16-lane column tile against the table's row tiles.  Rows
// past ch are padding and are not stored.
// ---------------------------------------------------------------------------

namespace {
constexpr int kFtMT = 12;  // 16-row tiles a block (ch up to 192)
}  // namespace

__global__ void __launch_bounds__(kThreads)
probe_feature_kernel(const float* __restrict__ vals, float* __restrict__ out,
                     int mn, int k, int ch, int lanes, int mgroups,
                     int ts_rows) {
  extern __shared__ __align__(32) float smem[];
  const int kw = 8 * k, tld = kw + 4;
  float* Ts = smem;                     // (ts_rows, tld): big's rows
  float* Vs = Ts + (size_t)ts_rows * tld;  // (kw, kNLd): one chunk of vals
  float* scratch = Vs + (size_t)kw * kNLd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / mgroups;
  const int r0 = (blockIdx.x % mgroups) * kFtMT * 16;
  const int rows = min(kFtMT * 16, ch - r0);
  for (int e = tid; e < ts_rows * kw; e += kThreads) {
    const int rr = e / kw, q = e % kw;
    Ts[rr * tld + q] = (rr < rows && r0 + rr == q % k) ? 1.0f : 0.0f;
  }
  FragC acc[kFtMT];
#pragma unroll
  for (int t = 0; t < kFtMT; ++t) wmma::fill_fragment(acc[t], 0.0f);
  const float4* vb = reinterpret_cast<const float4*>(
      vals + (size_t)b * mn * k * lanes);
  const int l4 = lanes / 4;
  for (int c = 0; c < mn / 8; ++c) {
    __syncthreads();  // the last chunk's reads of Vs are done
    for (int e = tid; e < kw * l4; e += kThreads) {
      const float4 v = __ldg(vb + (size_t)c * kw * l4 + e);
      *reinterpret_cast<float4*>(Vs + (e / l4) * kNLd + 4 * (e % l4)) = v;
    }
    __syncthreads();
    if (warp * 16 < lanes) {
      for (int kk = 0; kk < kw; kk += 8) {
        FragB bf;
        load_tf32(bf, Vs + kk * kNLd + warp * 16, kNLd);
#pragma unroll
        for (int t = 0; t < kFtMT; ++t) {
          if (t * 16 < rows) {
            FragA af;
            load_tf32(af, Ts + t * 16 * tld + kk, tld);
            wmma::mma_sync(acc[t], af, bf, acc[t]);
          }
        }
      }
    }
  }
  if (warp * 16 < lanes) {
    float* ob = out + ((size_t)b * ch + r0) * lanes + warp * 16;
#pragma unroll
    for (int t = 0; t < kFtMT; ++t)
      if (t * 16 < rows)
        store_tile(acc[t], scratch + warp * 256, ob + (size_t)t * 16 * lanes,
                   lanes, rows - t * 16, lane);
  }
}

extern "C" int probe_feature_launch(const float* vals, float* out, int nb,
                                    int mn, int k, int ch, int lanes,
                                    void* stream) {
  if (lanes % 16 || lanes > kMaxN || mn % 8) return (int)cudaErrorInvalidValue;
  const int mgroups = (ch + kFtMT * 16 - 1) / (kFtMT * 16);
  const int ts_rows = std::min(kFtMT * 16, (ch + 15) / 16 * 16);
  const size_t smem = sizeof(float) * ((size_t)ts_rows * (8 * k + 4)
                                       + (size_t)8 * k * kNLd + kWarps * 256);
  cudaError_t err = cudaFuncSetAttribute(
      probe_feature_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_feature_kernel<<<(unsigned)nb * mgroups, kThreads, smem,
                         (cudaStream_t)stream>>>(vals, out, mn, k, ch, lanes,
                                                 mgroups, ts_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pair reduce: out[b, n nlm + m, a] =
//   sum over c < chunks, r < 8 of g[b, 8 (c na + n) + r, a] * y[b, 8 (c nlm + m) + r, a]
//
// Bound: bytes (g, y read once, out written once; 2 FLOP per 8 bytes).  A
// thread per lane a, a block per b, so every load and store coalesces
// across lanes.  Two loop orders, as the TPU probe has:
//   spill  chunk-outer: all na x nlm = 168 accumulators stay live across
//          the chunks (on the TPU they spilled to VMEM; here they are
//          registers while ptxas can hold them: see its -v report for
//          probe_reduce_spill_kernel);
//   tiled  channel-outer: one accumulator, g and y re-read per channel
//          (from L1/L2: each (n, m) pass reads 8 chunks x 2 rows).
// ---------------------------------------------------------------------------

namespace {
constexpr int kNA = 7;
constexpr int kNLM = 24;

template <bool SPILL>
__device__ __forceinline__ void reduce_body(const float* __restrict__ g,
                                            const float* __restrict__ y,
                                            float* __restrict__ out,
                                            int chunks) {
  const int b = blockIdx.x, a = threadIdx.x, lanes = blockDim.x;
  const float* gb = g + (size_t)b * chunks * 8 * kNA * lanes + a;
  const float* yb = y + (size_t)b * chunks * 8 * kNLM * lanes + a;
  float* ob = out + (size_t)b * kNA * kNLM * lanes + a;
  if (SPILL) {
    float acc[kNA][kNLM];
#pragma unroll
    for (int n = 0; n < kNA; ++n)
#pragma unroll
      for (int m = 0; m < kNLM; ++m) acc[n][m] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      for (int r = 0; r < 8; ++r) {
        float gv[kNA];
#pragma unroll
        for (int n = 0; n < kNA; ++n)
          gv[n] = __ldg(gb + (size_t)(8 * (c * kNA + n) + r) * lanes);
#pragma unroll
        for (int m = 0; m < kNLM; ++m) {
          const float yv = __ldg(yb + (size_t)(8 * (c * kNLM + m) + r) * lanes);
#pragma unroll
          for (int n = 0; n < kNA; ++n) acc[n][m] = fmaf(gv[n], yv, acc[n][m]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kNA; ++n)
#pragma unroll
      for (int m = 0; m < kNLM; ++m)
        ob[(size_t)(n * kNLM + m) * lanes] = acc[n][m];
  } else {
    for (int n = 0; n < kNA; ++n) {
      for (int m = 0; m < kNLM; ++m) {
        float acc = 0.0f;
        for (int c = 0; c < chunks; ++c)
#pragma unroll
          for (int r = 0; r < 8; ++r)
            acc = fmaf(__ldg(gb + (size_t)(8 * (c * kNA + n) + r) * lanes),
                       __ldg(yb + (size_t)(8 * (c * kNLM + m) + r) * lanes),
                       acc);
        ob[(size_t)(n * kNLM + m) * lanes] = acc;
      }
    }
  }
}
}  // namespace

extern "C" __global__ void probe_reduce_spill_kernel(const float* g,
                                                     const float* y,
                                                     float* out, int chunks) {
  reduce_body<true>(g, y, out, chunks);
}

extern "C" __global__ void probe_reduce_tiled_kernel(const float* g,
                                                     const float* y,
                                                     float* out, int chunks) {
  reduce_body<false>(g, y, out, chunks);
}

extern "C" int probe_reduce_launch(const float* g, const float* y, float* out,
                                   int nb, int na, int nlm, int chunks,
                                   int lanes, int spill, void* stream) {
  if (na != kNA || nlm != kNLM || lanes < 1 || lanes > 1024)
    return (int)cudaErrorInvalidValue;
  if (spill)
    probe_reduce_spill_kernel<<<nb, lanes, 0, (cudaStream_t)stream>>>(
        g, y, out, chunks);
  else
    probe_reduce_tiled_kernel<<<nb, lanes, 0, (cudaStream_t)stream>>>(
        g, y, out, chunks);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// blocked gather: out[b, i, a] = sum over q < nq of src[b, i, idx[b, q, a]],
// a term being 0 where idx < 0 or idx >= width (= 128 nblk), as the TPU
// kernel's blocked select gives.
//
// Bound: bytes (src, idx read once, out written once).  Design: a block per
// b stages its whole src slab (nch x width: 156.7 KB at nblk 18, 95.7 KB at
// 11) in dynamic shared memory with 16-byte loads from all 512 threads, the
// on-chip window of the TPU kernel.  Then thread (group, lane a) sums, in q
// order, the terms of lane a for its group's channels (17 channels in 4
// groups of up to 5 at 128 lanes), each valid index a shared-memory read
// per channel, with the indices loaded kBgQ at a time.  The q loop is bound
// by latency, not bytes: 4 warps an SM summing all 17 channels ran ~3x
// slower on the H100 than these 16 (PERF.md, the probes).
// ---------------------------------------------------------------------------

namespace {
constexpr int kBgCh = 8;      // channels a thread holds in registers a pass
constexpr int kBgQ = 8;       // index loads in flight a thread
constexpr int kBgThreads = 512;
}  // namespace

__global__ void __launch_bounds__(kBgThreads)
probe_bgather_kernel(const float* __restrict__ src,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int nch, int nq, int width, int lanes, int groups) {
  extern __shared__ __align__(16) float s[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float4* sb = reinterpret_cast<const float4*>(
      src + (size_t)b * nch * width);
  float4* s4 = reinterpret_cast<float4*>(s);
#pragma unroll 4
  for (int e = tid; e < nch * width / 4; e += blockDim.x) s4[e] = __ldg(sb + e);
  __syncthreads();
  if (tid >= lanes * groups) return;
  // thread (group, lane): channels [c0, c1) of lane a
  const int a = tid % lanes, per = (nch + groups - 1) / groups;
  const int c0 = (tid / lanes) * per, c1 = min(nch, c0 + per);
  const int* ib = idx + (size_t)b * nq * lanes + a;
  float* ob = out + (size_t)b * nch * lanes + a;
  for (int i0 = c0; i0 < c1; i0 += kBgCh) {
    const int nc = min(kBgCh, c1 - i0);
    const float* si = s + (size_t)i0 * width;
    float acc[kBgCh];
#pragma unroll
    for (int i = 0; i < kBgCh; ++i) acc[i] = 0.0f;
    // the indices of kBgQ terms are loaded before they are used, so their
    // latencies overlap instead of adding up term by term
    for (int q0 = 0; q0 < nq; q0 += kBgQ) {
      int jq[kBgQ];
#pragma unroll
      for (int u = 0; u < kBgQ; ++u)
        jq[u] = q0 + u < nq ? __ldg(ib + (size_t)(q0 + u) * lanes) : -1;
#pragma unroll
      for (int u = 0; u < kBgQ; ++u) {
        const int j = jq[u];
        if (j >= 0 && j < width) {
#pragma unroll
          for (int i = 0; i < kBgCh; ++i)
            if (i < nc) acc[i] += si[(size_t)i * width + j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBgCh; ++i)
      if (i < nc) ob[(size_t)(i0 + i) * lanes] = acc[i];
  }
}

extern "C" int probe_bgather_launch(const float* src, const int* idx,
                                    float* out, int nb, int nch, int nq,
                                    int width, int lanes, void* stream) {
  if (width % 4 || lanes < 1 || lanes > kBgThreads)
    return (int)cudaErrorInvalidValue;
  const int groups = kBgThreads / lanes;
  const size_t smem = sizeof(float) * (size_t)nch * width;
  cudaError_t err = cudaFuncSetAttribute(
      probe_bgather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_bgather_kernel<<<nb, kBgThreads, smem, (cudaStream_t)stream>>>(
      src, idx, out, nch, nq, width, lanes, groups);
  return (int)cudaGetLastError();
}
