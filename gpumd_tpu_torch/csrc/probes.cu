// Probe kernels: the instruments that chose the TPU kernels' designs,
// rebuilt for Hopper.  Each replaces one Pallas kernel of the probe scripts:
//
//   probe_gather_kernel        scripts/bench_gather.py:kern (pallas_gather)
//   probe_trans_kernel         scripts/probe_transcendentals.py:kernel (run)
//   probe_onehot_tf32_kernel,  scripts/bench_mxu_probes.py:_dot_kernel
//   probe_onehot_ffma_kernel   (onehot_dot: Precision.DEFAULT, HIGHEST)
//   probe_feature_tf32_kernel  scripts/bench_mxu_probes.py:_feat_kernel
//                              (feature_matmul)
//   probe_reduce_{spill,tiled} scripts/bench_mxu_probes.py:
//                              _reduce_spill_kernel, _reduce_tiled_kernel
//                              (pair_reduce)
//   probe_bgather_kernel       scripts/bench_mxu_probes.py:_bgather_kernel
//                              (bgather)
//
// Every kernel is bound by bytes on the H100 at the scripts' shapes (the
// transcendentals by its launch); each note says what its design does.
#include <cuda.h>  // CUtensorMap (the encoder is found at run time)
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tf32.cuh"

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
// one-hot dot: out[b] = vals[b] (m x k) @ R (k x n), R[i, j] = 1 where
// (7919 j) mod n == j, the same column mask for every row i; k is summed in
// `ksplit` parts, each in its own accumulator, added at the end.
//
// Bound: bytes (vals read once: at (144, 4096, 128) the product is 64 FLOP
// per byte read; the bytes set the pace while the tensor cores sustain ~42%
// of the TF32 peak, which only wgmma reaches).
//
// TF32 (Precision.DEFAULT): R is the same for every b, so vals is one
// (nb m) x k matrix and out one (nb m) x n matrix, cut into 128-row tiles
// across b boundaries (no padding of m).  A persistent block an SM walks
// the tiles.  One producer warp keeps a ring of 32 KB stages full, each two
// TMA tile loads (128 rows x 32 f32, 128-byte swizzle; rows past nb m and
// columns past k arrive as zeros), completed on `full` mbarriers; two
// consumer warpgroups each run wgmma m64nNk8 on their 64 rows of a stage,
// all eight k8 steps back to back (no step is skipped: a branch between
// them makes ptxas serialise the wgmmas), A and B read from shared memory
// by descriptor, and release the stage on its `empty` mbarrier once the
// next stage's products are issued (one wgmma group in flight).  B = R^T
// (N x 32, K-major, swizzled alike) is built once a block: R's rows are all
// alike, so one tile serves every box.  N is the smallest of 16, 64, 128
// not below n; columns past n are zero and not stored.  k-split parts
// are whole stages: a stage that starts a part waits for the products,
// adds the part into the total and starts the sum again with scale-d 0.
// The epilogue stores 8-byte pairs from the accumulators, whole 32-byte
// sectors a row, while the producer already loads the next tile.
//
// F32 (Precision.HIGHEST), the TPU's multi-pass product on the matrix unit
// in its Hopper form: f32-exact products on the TF32 tensor cores in three
// passes.  Bound: TF32 operations, 3 x 2 (nb m) k N at 495 TFLOP/s (above
// the bytes, which are the TF32 kernel's).  The TF32 kernel's TMA ring of
// 128-row tiles, persistent blocks and R^T built once a block, with A
// from registers: a thread reads its fragments from the swizzled stage
// with 16-byte loads (thread q of a fragment row takes the 16-byte chunks
// 2q and 2q + 1 of a box row, whose 128-byte swizzle puts a quarter
// warp's 8 loads in 8 distinct bank groups) and splits every element a
// exactly into three TF32 terms: hi = a with its low 13 mantissa bits
// cleared, mid = the same of a - hi, lo = a - hi - mid (exact for every
// finite a; TF32 for |a| >= 2^-103).  R is 0/1, so every product is exact
// and only the sums round.  The tensor core's adds cut (not round) at the
// accumulator's ulp, so a box (32 columns, 4 k8 steps) is summed in a
// fresh accumulator, a half box at a time (its 2 lo steps first, then
// mid, then hi: 6 wgmma m64nNk8 .tf32 against the same R^T descriptor,
// waited for before the next half's fragments take their registers), and
// added into a register sum with round-to-nearest: the small terms never
// meet the large sum inside the tensor core.  The two accumulators and
// the fragment words need more registers than the 168 a thread that 9
// warps leave, so the block is two warpgroups without a producer warp:
// thread 0 fills the ring, `stages` stages ahead, refilling each slot one
// stage after all 8 warps released it.  Which k column of a box sits at
// which k position of a fragment is the loads' order, not the natural
// one: R's rows are all alike, so any order of k gives the same product.
// k-split parts need not be whole stages: a part starts a stage of its
// own (its TMA boxes at the part's columns), columns past the part's end
// are zeroed in the fragment, and each part's sum is added into `out`
// (stored by part 0, read back and added by the next parts in the same
// thread), as the plain version adds its parts.  k not a multiple of 4
// (no TMA row stride) and an unaligned base go to probe_onehot_ffma_kernel,
// chosen by the wrapper from the shape: a block takes 48 rows of one b;
// each step stages a
// (48 x 32) slab of vals in shared memory, zero-filled past m and past the
// part's end, and thread (warp, lane) keeps 6 rows x 4 columns of FFMA
// accumulators fed from it and from R's (32 x n) tile.
// ---------------------------------------------------------------------------

namespace {
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 128;          // output columns a block covers
constexpr int kNLd = kMaxN + 4;
constexpr int kOhRows = 48;         // rows a block (f32 path)
constexpr int kOhKC = 32;           // k columns a step (f32) or TMA box (TF32)
constexpr int kOhALd = kOhKC + 4;

// the TF32 kernels: two consumer warpgroups and one producer warp; the f32
// path's: two warpgroups, thread 0 also the producer (8 warps: 255
// registers a thread, where 9 warps leave 168)
constexpr int kWgThreads = 2 * 128 + 32;
constexpr int kF32Threads = 2 * 128;
constexpr int kOhTileM = 128;                      // rows a tile
constexpr int kOhBoxBytes = kOhTileM * kOhKC * 4;  // a TMA box: 16 KB
constexpr int kOhBoxes = 2;                        // boxes a stage
// feature matmul: a staged row of vals, 128 lanes + 8 floats, so that the
// 8-byte fragment loads of a half warp fall in 32 distinct banks
constexpr int kFtLd = 136;

// Dynamic shared memory of the TF32 kernels: 1024 bytes of slack for the
// swizzle's alignment, the constant operand (R^T: N rows of 128 B; big^T:
// N x 8k f32), and the ring, each stage with two 8-byte mbarriers.  The
// wrapper's plans (bench_mxu_probes.onehot_plan / feature_plan) lay out
// the same; a card test holds them equal.
long onehot_smem(int n_mma, int stages) {
  return 1024L + (long)n_mma * kOhKC * 4 +
         (long)stages * (kOhBoxes * kOhBoxBytes + 16);
}
long feature_smem(int n_mma, int k, int stages) {
  return 1024L + 8L * k * n_mma * 4 +
         (long)stages * (8L * k * kFtLd * 4 + 16);
}
}  // namespace

// The wgmma N instances of the TF32 kernels (bench_mxu_probes.ONEHOT_N and
// FEATURE_N); a width takes the smallest not below it.
#define GK_ONEHOT_N(X) X(16) X(64) X(128)
#define GK_FEATURE_N(X) X(32) X(192) X(256)

__global__ void __launch_bounds__(kThreads)
probe_onehot_ffma_kernel(const float* __restrict__ vals,
                         float* __restrict__ out, int m, int k, int n,
                         int ksplit, int mgroups) {
  __shared__ __align__(32) float As[kOhRows * kOhALd];
  __shared__ __align__(32) float Rs[kOhKC * kNLd];
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

  float ftot[6][4], facc[6][4];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ftot[i][j] = 0.0f;
  for (int p = 0; p < ksplit; ++p) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;
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
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ftot[i][j] += facc[i][j];
  }

  float* ob = out + ((size_t)b * m + m0) * n;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp + 8 * i, c = lane + 32 * j;
      if (r < rows && c < n) ob[(size_t)r * n + c] = ftot[i][j];
    }
}

namespace {
// The dynamic shared memory of a TF32 kernel, from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 1024 bytes).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = gk::smem_u32(raw);
  return raw + ((1024u - (a & 1023u)) & 1023u);
}
}  // namespace

template <int N, bool SPLIT>
__global__ void __launch_bounds__(kWgThreads, 1)
probe_onehot_tf32_kernel(const __grid_constant__ CUtensorMap vmap,
                         float* __restrict__ out, int rows, int k, int n,
                         int kp, int stages) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kbs = kOhBoxes;
  constexpr int stage_k = kbs * kOhKC, stage_bytes = kbs * kOhBoxBytes;
  uint8_t* ring = aligned_smem(smem_raw);
  uint8_t* rt = ring + (size_t)stages * stage_bytes;  // R^T: N x 128 B
  uint64_t* full = reinterpret_cast<uint64_t*>(rt + N * 128);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (rows + kOhTileM - 1) / kOhTileM;
  const int ksteps = (k + stage_k - 1) / stage_k;

  // R^T, K-major: row j is column j of R (1 where (7919 j) mod n == j, for
  // every k), rows from n to N zero
  for (int e = tid; e < N * kOhKC; e += kWgThreads) {
    const int j = e / kOhKC, c = e % kOhKC;
    *reinterpret_cast<float*>(rt + gk::sw128_offset(j, c)) =
        (j < n && (j * 7919) % n == j) ? 1.0f : 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      gk::mbar_init(&full[s], 1);
      gk::mbar_init(&empty[s], 2 * 4);  // a lane of each consumer warp
    }
    gk::mbar_init_fence();
  }
  // R^T's stores are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        for (int ks = 0; ks < ksteps; ++ks) {
          gk::mbar_wait(&empty[s], ph ^ 1);
          gk::mbar_expect_tx(&full[s], stage_bytes);
          for (int j = 0; j < kbs; ++j)
            gk::tma_load_2d(ring + (size_t)s * stage_bytes + j * kOhBoxBytes,
                            &vmap, &full[s], (ks * kbs + j) * kOhKC,
                            t * kOhTileM);
          if (++s == stages) { s = 0; ph ^= 1; }
        }
    }
    return;
  }

  // consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of each tile
  const int wg = warp >> 2;
  const uint32_t a_base = gk::smem_u32(ring) + wg * 64 * 128;
  const uint64_t db = gk::sw128_desc(gk::smem_u32(rt));
  gk::Acc<N> acc, tot;
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (SPLIT) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) tot.d[i] = 0.0f;
    }
    int prev = -1;
    for (int ks = 0; ks < ksteps; ++ks) {
      gk::mbar_wait(&full[s], ph);
      // a stage that starts a part (parts are whole stages) starts its sum
      // with scale-d 0, after the last part is added into the total
      const bool first = ks * stage_k % kp == 0;
      if (SPLIT && first && ks > 0) {
        gk::wgmma_wait<0>();
        gk::acc_fence(acc);
#pragma unroll
        for (int e = 0; e < N / 2; ++e) tot.d[e] += acc.d[e];
      }
      const uint64_t da =
          gk::sw128_desc(a_base + (uint32_t)(s * stage_bytes));
      gk::acc_fence(acc);
      gk::wgmma_fence();
      // every k8 step of the stage, none skipped (past k the box holds
      // zeros), so the products are issued back to back: box i / 4, step
      // i % 4 of it; R^T's one tile serves every box
#pragma unroll
      for (int i = 0; i < 4 * kbs; ++i)
        gk::wgmma_ss(acc, da + (i / 4) * (kOhBoxBytes >> 4) + 2 * (i % 4),
                     db + 2 * (i % 4), (i == 0 && first) ? 0 : 1);
      gk::wgmma_commit();
      gk::wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && lane == 0) gk::mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    gk::wgmma_wait<0>();
    gk::acc_fence(acc);
    if (lane == 0) gk::mbar_arrive(&empty[prev]);
    if (SPLIT) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc.d[e] += tot.d[e];
    }
    const int g = lane >> 2, q = lane & 3;
    const int r0 = t * kOhTileM + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * q;
      if (c < n) {
        if (r0 < rows)
          *reinterpret_cast<float2*>(out + (size_t)r0 * n + c) =
              make_float2(acc.d[4 * j], acc.d[4 * j + 1]);
        if (r0 + 8 < rows)
          *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * n + c) =
              make_float2(acc.d[4 * j + 2], acc.d[4 * j + 3]);
      }
    }
  }
}

namespace {
// The f32 path's exact split of a into three TF32 terms (the plain torch
// version is bench_mxu_probes.tf32_split): hi keeps a's top 11 significant
// bits, mid those of the rest, lo what remains; both subtractions are exact.
__device__ __forceinline__ void tf32_split(float a, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xFFFFE000u;
  const float r = a - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xFFFFE000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}
}  // namespace

template <int N>
__global__ void __launch_bounds__(kF32Threads, 1)
probe_onehot_f32_kernel(const __grid_constant__ CUtensorMap vmap,
                        float* __restrict__ out, int rows, int k, int n,
                        int kp, int stages) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kbs = kOhBoxes;
  constexpr int stage_k = kbs * kOhKC, stage_bytes = kbs * kOhBoxBytes;
  uint8_t* ring = aligned_smem(smem_raw);
  uint8_t* rt = ring + (size_t)stages * stage_bytes;  // R^T: N x 128 B
  uint64_t* full = reinterpret_cast<uint64_t*>(rt + N * 128);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (rows + kOhTileM - 1) / kOhTileM;
  const int parts = k / kp;
  const int psteps = (kp + stage_k - 1) / stage_k;  // stages a part
  const int per_tile = parts * psteps;
  const int my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * per_tile;  // stages this block takes

  for (int e = tid; e < N * kOhKC; e += kF32Threads) {
    const int j = e / kOhKC, c = e % kOhKC;
    *reinterpret_cast<float*>(rt + gk::sw128_offset(j, c)) =
        (j < n && (j * 7919) % n == j) ? 1.0f : 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      gk::mbar_init(&full[s], 1);
      gk::mbar_init(&empty[s], kF32Threads / 32);  // a lane of each warp
    }
    gk::mbar_init_fence();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Thread 0 is also the producer: stage i of the block (tile, part, step
  // in that order; a part's stages start at the part's columns) goes to
  // slot i % stages once the stage that used the slot before is released.
  auto load = [&](int i) {
    const int s = i % stages, tl = i / per_tile, rem = i - tl * per_tile;
    const int p = rem / psteps, ks = rem - p * psteps;
    if (i >= stages) gk::mbar_wait(&empty[s], (uint32_t)(i / stages - 1) & 1);
    gk::mbar_expect_tx(&full[s], stage_bytes);
    for (int j = 0; j < kbs; ++j)
      gk::tma_load_2d(ring + (size_t)s * stage_bytes + j * kOhBoxBytes, &vmap,
                      &full[s], p * kp + ks * stage_k + j * kOhKC,
                      (blockIdx.x + tl * gridDim.x) * kOhTileM);
  };
  if (tid == 0)
    for (int i = 0; i < min(stages, total); ++i) load(i);

  // warpgroup wg takes rows 64 wg .. 64 wg + 63 of each tile; thread
  // (g, q) holds fragment rows fr and fr + 8 (fr % 8 == g)
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int fr = wg * 64 + (warp & 3) * 16 + g;
  const uint64_t db = gk::sw128_desc(gk::smem_u32(rt));
  gk::Acc<N> acc, sum;
  int i = 0;  // the block's stage
  for (int tl = 0; tl < my_tiles; ++tl) {
    for (int p = 0; p < parts; ++p) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) sum.d[e] = 0.0f;
      for (int ks = 0; ks < psteps; ++ks, ++i) {
        const int s = i % stages;
        gk::mbar_wait(&full[s], (uint32_t)(i / stages) & 1);
        const int lim = kp - ks * stage_k;  // live columns of the stage
        const uint8_t* st = ring + (size_t)s * stage_bytes;
#pragma unroll
        for (int box = 0; box < kbs; ++box) {
          // the box's sum in a fresh accumulator, a half box (2 k8 steps)
          // at a time, each half's small terms first: lo, mid, hi
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t a[3][2][4];  // term (lo, mid, hi), k8 step, word
            const int c = 2 * q + h;  // 16-byte chunk of the box row
            const uint32_t sw = (uint32_t)((c ^ g) << 4);
            const float4 v = *reinterpret_cast<const float4*>(
                st + box * kOhBoxBytes + fr * 128 + sw);
            const float4 w = *reinterpret_cast<const float4*>(
                st + box * kOhBoxBytes + (fr + 8) * 128 + sw);
            const float vr[4] = {v.x, v.y, v.z, v.w};
            const float wr[4] = {w.x, w.y, w.z, w.w};
            const int col = box * kOhKC + 4 * c;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // columns 4c + e of rows fr, fr + 8: k8 step 2h + e / 2,
              // fragment words (0, 1) for even e, (2, 3) for odd
              const bool live = col + e < lim;
              const int j = e / 2, f = 2 * (e % 2);
              tf32_split(live ? vr[e] : 0.0f, a[2][j][f], a[1][j][f],
                         a[0][j][f]);
              tf32_split(live ? wr[e] : 0.0f, a[2][j][f + 1],
                         a[1][j][f + 1], a[0][j][f + 1]);
            }
            if (box == kbs - 1 && h == 1) {  // the stage is in registers
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              __syncwarp();
              if (lane == 0) gk::mbar_arrive(&empty[s]);
            }
            gk::acc_fence(acc);
            gk::wgmma_fence();
#pragma unroll
            for (int t = 0; t < 3; ++t)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                gk::wgmma_rs(acc, a[t][j], db + 2 * (2 * h + j),
                             (h | t | j) ? 1 : 0);
            gk::wgmma_commit();
            gk::wgmma_wait<0>();
            gk::acc_fence(acc);
          }
#pragma unroll
          for (int e = 0; e < N / 2; ++e) sum.d[e] += acc.d[e];
        }
        // refill the slot of the stage before this one, which every warp
        // has released by now, `stages` stages ahead
        if (tid == 0 && i >= 1 && i - 1 + stages < total)
          load(i - 1 + stages);
      }
      // the part's sum into out: stored by part 0, added to by the next
      const int r0 = (blockIdx.x + tl * gridDim.x) * kOhTileM + fr;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = 8 * j + 2 * q;
        if (c < n) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + 8 * hh;
            if (r < rows) {
              float2* o = reinterpret_cast<float2*>(out + (size_t)r * n + c);
              float2 v = make_float2(sum.d[4 * j + 2 * hh],
                                     sum.d[4 * j + 2 * hh + 1]);
              if (p > 0) {
                const float2 prev = *o;
                v = make_float2(prev.x + v.x, prev.y + v.y);
              }
              *o = v;
            }
          }
        }
      }
    }
  }
}

namespace {
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time, so the library
// needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The wgmma kernel instance of (which 0: one-hot TF32, 1: feature, 2:
// one-hot f32 in three TF32 passes; N, split), or nullptr.
const void* wgmma_kernel(int which, int n_mma, bool split);

// The TMA map of vals as a (rows, k) f32 matrix in boxes of 128 rows x 32
// columns, 128-byte swizzled; past its edges the boxes read zeros.
int onehot_map(CUtensorMap* map, const float* vals, int rows, int k) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kOhKC, (cuuint32_t)kOhTileM};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)vals, dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int launch_wg(const void* kernel, int smem, int blocks, cudaStream_t stream,
              void** args, int threads = kWgThreads) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args,
                         (size_t)smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
}  // namespace

extern "C" int probe_onehot_ffma_launch(const float* vals, float* out, int nb,
                                        int m, int k, int n, int ksplit,
                                        void* stream) {
  if (n % 16 || n > kMaxN || ksplit < 1 || k % ksplit)
    return (int)cudaErrorInvalidValue;
  const int mgroups = (m + kOhRows - 1) / kOhRows;
  probe_onehot_ffma_kernel<<<(unsigned)nb * mgroups, kThreads, 0,
                             (cudaStream_t)stream>>>(vals, out, m, k, n,
                                                     ksplit, mgroups);
  return (int)cudaGetLastError();
}

// The plan (n_mma, stages, blocks) comes from the wrapper's onehot_plan;
// rows = nb m.
extern "C" int probe_onehot_tf32_launch(const float* vals, float* out,
                                        int rows, int k, int n, int ksplit,
                                        int n_mma, int stages, int blocks,
                                        void* stream) {
  int kp = k / ksplit;
  if (n % 16 || n > n_mma || ksplit < 1 || k % ksplit || k % 4 ||
      (ksplit > 1 && kp % (kOhBoxes * kOhKC)) || stages < 2 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = onehot_map(&map, vals, rows, k);
  if (err) return err;
  void* args[] = {(void*)&map, &out, &rows, &k, &n, &kp, &stages};
  return launch_wg(wgmma_kernel(0, n_mma, ksplit > 1),
                   (int)onehot_smem(n_mma, stages), blocks,
                   (cudaStream_t)stream, args);
}

// The f32 path on the ring (probe_onehot_f32_kernel); the plan (n_mma,
// stages, blocks) comes from the wrapper's onehot_f32_plan, which the
// wrapper takes for k a multiple of 4 and a 16-byte aligned base (else it
// launches probe_onehot_ffma_launch).
extern "C" int probe_onehot_f32_launch(const float* vals, float* out, int nb,
                                       int m, int k, int n, int ksplit,
                                       int n_mma, int stages, int blocks,
                                       void* stream) {
  if (n % 16 || n > n_mma || ksplit < 1 || k % ksplit || k % 4 ||
      stages < 2 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  int rows = nb * m, kp = k / ksplit;
  CUtensorMap map;
  const int err = onehot_map(&map, vals, rows, k);
  if (err) return err;
  void* args[] = {(void*)&map, &out, &rows, &k, &n, &kp, &stages};
  return launch_wg(wgmma_kernel(2, n_mma, false),
                   (int)onehot_smem(n_mma, stages), blocks,
                   (cudaStream_t)stream, args, kF32Threads);
}

// ---------------------------------------------------------------------------
// feature matmul: out[b] = sum over the mn/8 chunks c of
// big (ch x 8k) @ vals[b, 8k c : 8k (c+1), :] (8k x lanes), where big is
// eye(ch, k) repeated 8 times along its columns.
//
// Bound: bytes (vals read once, out written once; 19 GFLOP of TF32 at the
// script's shapes is far under it), so the design is about the memory
// pipeline.  A persistent block an SM walks b.  Its producer warp streams
// each chunk (8k rows of lanes f32, each row one contiguous run) into a
// ring of stages by 1-D bulk copies (cp.async.bulk, one a row, rows laid
// kFtLd floats apart), completed on `full` mbarriers, so b + 1's chunks are
// in flight while b computes and stores.  TF32 wgmma takes no MN-major
// operand from shared memory, and vals[b] is (K = 8k, lanes) with lanes
// contiguous, so the product runs transposed: out[b]^T (lanes x ch) =
// vals[b]^T @ big^T, A = vals[b]^T from registers (each consumer warpgroup
// 64 lanes; thread fragment rows g and g + 8 are the neighbouring lanes
// 2g and 2g + 1, so A's loads and out's stores are 8-byte pairs), B = big^T
// (N x 8k, K-major, 128-byte swizzled) built once a block in shared memory
// and read by descriptor.  N is the smallest of 32, 192, 256 not below
// ch; rows of big from ch to N are zero and not stored.  A consumer
// warp releases a stage once its fragments are in registers, before its
// products run.  out[b] (ch, lanes) is stored from the accumulators in
// 8-byte pairs, each warp writing whole 32-byte sectors.
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(kWgThreads, 1)
probe_feature_tf32_kernel(const float* __restrict__ vals,
                          float* __restrict__ out, int nb, int mn, int k,
                          int ch, int lanes, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const int kw = 8 * k;          // rows of a chunk: the product's K
  const int kblocks = kw / 32;   // 32-column swizzled blocks of big^T
  uint8_t* tab = aligned_smem(smem_raw);  // big^T: kblocks x (N x 128 B)
  float* ring = reinterpret_cast<float*>(tab + (size_t)kblocks * N * 128);
  const size_t stage_floats = (size_t)kw * kFtLd;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_floats);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = mn / 8;

  for (int e = tid; e < kblocks * N * 32; e += kWgThreads) {
    const int blk = e / (N * 32), c = (e / 32) % N, col = e % 32;
    const int qq = 32 * blk + col;
    *reinterpret_cast<float*>(tab + (size_t)blk * N * 128 +
                              gk::sw128_offset(c, col)) =
        (c < ch && c == qq % k) ? 1.0f : 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      gk::mbar_init(&full[s], 1);
      gk::mbar_init(&empty[s], 2 * 4);
    }
    gk::mbar_init_fence();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == 8) {  // producer: one bulk copy a row, spread over the warp
    const uint32_t row_bytes = (uint32_t)lanes * 4;
    int s = 0;
    uint32_t ph = 0;
    for (int b = blockIdx.x; b < nb; b += gridDim.x)
      for (int c = 0; c < chunks; ++c) {
        if (lane == 0) {
          gk::mbar_wait(&empty[s], ph ^ 1);
          gk::mbar_expect_tx(&full[s], row_bytes * kw);
        }
        __syncwarp();
        const float* src =
            vals + ((size_t)b * mn * k + (size_t)c * kw) * lanes;
        float* dst = ring + s * stage_floats;
        for (int r = lane; r < kw; r += 32)
          gk::bulk_load(dst + (size_t)r * kFtLd, src + (size_t)r * lanes,
                        row_bytes, &full[s]);
        if (++s == stages) { s = 0; ph ^= 1; }
      }
    return;
  }

  // consumers: warpgroup wg takes lanes 64 wg .. 64 wg + 63
  const int g = lane >> 2, q = lane & 3;
  const int l0 = (warp >> 2) * 64 + (warp & 3) * 16 + 2 * g;
  const bool live = l0 < lanes;
  const uint64_t db = gk::sw128_desc(gk::smem_u32(tab));
  gk::Acc<N> acc;
  int s = 0;
  uint32_t ph = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    for (int c = 0; c < chunks; ++c) {
      gk::mbar_wait(&full[s], ph);
      const float* S = ring + s * stage_floats + l0;
      // A fragments of kFtSteps k8 steps at a time (two at N 256, where
      // the 128 accumulators leave no room for four): rows 8i + q and
      // 8i + q + 4 of the chunk, lanes l0 and l0 + 1
      constexpr int kFtSteps = N > 192 ? 2 : 4;
      for (int i0 = 0; i0 < k; i0 += kFtSteps) {
        uint32_t a[kFtSteps][4];
#pragma unroll
        for (int i = 0; i < kFtSteps; ++i) {
          const int r = 8 * (i0 + i) + q;
          float2 lo = make_float2(0.0f, 0.0f), hi = lo;
          if (live) {
            lo = *reinterpret_cast<const float2*>(S + (size_t)r * kFtLd);
            hi = *reinterpret_cast<const float2*>(S + (size_t)(r + 4) * kFtLd);
          }
          a[i][0] = __float_as_uint(lo.x);
          a[i][1] = __float_as_uint(lo.y);
          a[i][2] = __float_as_uint(hi.x);
          a[i][3] = __float_as_uint(hi.y);
        }
        if (i0 + kFtSteps >= k) {  // the stage is in registers: release it
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) gk::mbar_arrive(&empty[s]);
        }
        gk::acc_fence(acc);
        gk::wgmma_fence();
#pragma unroll
        for (int i = 0; i < kFtSteps; ++i) {
          // k8 step i0 + i: column block (i0 + i) / 4 of big^T, step
          // (i0 + i) % 4 in it
          const int st = i0 + i;
          gk::wgmma_rs(acc, a[i],
                       db + (uint64_t)(((st >> 2) * N * 128) >> 4) +
                           2 * (st & 3),
                       (c > 0 || st > 0) ? 1 : 0);
        }
        gk::wgmma_commit();
        gk::wgmma_wait<0>();
        gk::acc_fence(acc);
      }
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    if (live) {
      float* ob = out + (size_t)b * ch * lanes + l0;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = 8 * j + 2 * q;
        if (c < ch)
          *reinterpret_cast<float2*>(ob + (size_t)c * lanes) =
              make_float2(acc.d[4 * j], acc.d[4 * j + 2]);
        if (c + 1 < ch)
          *reinterpret_cast<float2*>(ob + (size_t)(c + 1) * lanes) =
              make_float2(acc.d[4 * j + 1], acc.d[4 * j + 3]);
      }
    }
  }
}

namespace {
const void* wgmma_kernel(int which, int n_mma, bool split) {
#define GK_OH(NN)                                                    \
  if (n_mma == NN)                                                   \
    return split ? (const void*)probe_onehot_tf32_kernel<NN, true>   \
                 : (const void*)probe_onehot_tf32_kernel<NN, false>;
#define GK_FT(NN) \
  if (n_mma == NN) return (const void*)probe_feature_tf32_kernel<NN>;
#define GK_F32(NN) \
  if (n_mma == NN) return (const void*)probe_onehot_f32_kernel<NN>;
  if (which == 0) {
    GK_ONEHOT_N(GK_OH)
  } else if (which == 1 && !split) {
    GK_FEATURE_N(GK_FT)
  } else if (which == 2) {
    GK_ONEHOT_N(GK_F32)
  }
#undef GK_OH
#undef GK_FT
#undef GK_F32
  return nullptr;
}
}  // namespace

// The plan (n_mma, stages, blocks) comes from the wrapper's feature_plan.
extern "C" int probe_feature_launch(const float* vals, float* out, int nb,
                                    int mn, int k, int ch, int lanes,
                                    int n_mma, int stages, int blocks,
                                    void* stream) {
  if (lanes % 16 || lanes > 128 || mn % 8 || k % 4 || ch < 1 || ch > n_mma ||
      stages < 2 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&vals, &out, &nb, &mn, &k, &ch, &lanes, &stages};
  return launch_wg(wgmma_kernel(1, n_mma, false),
                   (int)feature_smem(n_mma, k, stages), blocks,
                   (cudaStream_t)stream, args);
}

// A wgmma kernel's dynamic shared memory at (which 0: one-hot TF32, 1:
// feature, 2: one-hot f32; N, split, k, stages) and its resident blocks an
// SM there
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int probe_wgmma_occupancy(int which, int n_mma, int split, int k,
                                     int stages, int* smem, int* blocks) {
  const void* kernel = wgmma_kernel(which, n_mma, split != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  *smem = (int)(which == 1 ? feature_smem(n_mma, k, stages)
                           : onehot_smem(n_mma, stages));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, which == 2 ? kF32Threads : kWgThreads, (size_t)*smem);
}

// ---------------------------------------------------------------------------
// pair reduce: out[b, n nlm + m, a] =
//   sum over c < chunks, r < 8 of g[b, 8 (c na + n) + r, a] * y[b, 8 (c nlm + m) + r, a]
//
// Bound: bytes (g, y read once, out written once; 2 FLOP per 8 bytes).  Two
// loop orders, as the TPU probe has.  Both sum a channel in c, then r order
// with fmaf, so they give equal bits.
//   spill  chunk-outer: a thread per lane a, a block per (b, tile of at
//          most 256 lanes), so every load and store coalesces across
//          lanes; all na x nlm = 168 accumulators stay live across the
//          chunks (on the TPU they spilled to VMEM; here they are
//          registers while ptxas can hold them: 254 a thread, see its -v
//          report for probe_reduce_spill_kernel, so 256 threads a block
//          at most: wider rows take several tiles);
//   tiled  channel-outer: a block takes one (b, tile of kRtL lanes) and
//          stages the tile's whole g and y slab in shared memory with
//          16-byte cp.async, so every device byte is read once; then
//          thread (m, lane a) computes channels (0, m) .. (6, m) one at a
//          time, one accumulator each, re-reading its g and y rows from
//          shared memory for every channel, as the TPU kernel re-reads its
//          tiles from VMEM.  The slab keeps rows in 8-row groups (one
//          (c, n) of g or (c, m) of y) kRtGS = 9 x 16 floats apart: a warp
//          holds m and m + 1, whose y rows are one group apart, and the
//          extra 16 floats put the two in different halves of the 32 banks
//          (a warp's g reads are one word a lane, broadcast to both).  At 4
//          chunks a block takes 71,424 B, 3 blocks an SM, so one block's
//          copy overlaps another's sums.  A part-full last tile (lanes a
//          multiple of 4) is masked.
// ---------------------------------------------------------------------------

namespace {
constexpr int kNA = 7;
constexpr int kNLM = 24;
constexpr int kRtL = 16;                 // lanes a tile (tiled order)
constexpr int kRtGS = 9 * kRtL;          // floats an 8-row group in the slab
constexpr int kRtThreads = kNLM * kRtL;  // thread (m, lane)
constexpr int kSpillThreads = 256;       // most lanes a spill-order block

__device__ __forceinline__ void reduce_spill_body(const float* __restrict__ g,
                                                  const float* __restrict__ y,
                                                  float* __restrict__ out,
                                                  int chunks, int b, int a,
                                                  int lanes) {
  const float* gb = g + (size_t)b * chunks * 8 * kNA * lanes + a;
  const float* yb = y + (size_t)b * chunks * 8 * kNLM * lanes + a;
  float* ob = out + (size_t)b * kNA * kNLM * lanes + a;
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
}

// The tiled order's slab and grid (bench_mxu_probes.reduce_plan computes
// the same; a card test holds them equal).
long reduce_tiled_smem(int chunks) {
  return 4L * (kNA + kNLM) * chunks * kRtGS;
}
int reduce_tiles(int lanes) { return (lanes + kRtL - 1) / kRtL; }
}  // namespace

// a block a (b, tile of blockDim.x lanes): the 168 accumulators take 254
// registers a thread, so a block holds at most kSpillThreads lanes
extern "C" __global__ void probe_reduce_spill_kernel(const float* g,
                                                     const float* y,
                                                     float* out, int chunks,
                                                     int lanes, int tiles) {
  const int b = blockIdx.x / tiles;
  const int a = (blockIdx.x - b * tiles) * blockDim.x + threadIdx.x;
  if (a < lanes) reduce_spill_body(g, y, out, chunks, b, a, lanes);
}

extern "C" __global__ void __launch_bounds__(kRtThreads)
probe_reduce_tiled_kernel(const float* __restrict__ g,
                          const float* __restrict__ y,
                          float* __restrict__ out, int chunks, int lanes,
                          int tiles) {
  extern __shared__ __align__(16) float slab[];
  float* sg = slab;                                  // 7 chunks groups
  float* sy = slab + (size_t)kNA * chunks * kRtGS;   // 24 chunks groups
  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int a0 = (blockIdx.x - b * tiles) * kRtL;
  const int width = min(kRtL, lanes - a0);  // live lanes, a multiple of 4
  const float* gb = g + (size_t)b * chunks * 8 * kNA * lanes + a0;
  const float* yb = y + (size_t)b * chunks * 8 * kNLM * lanes + a0;
  // row i of g (then of y) goes to group i / 8, row i % 8 of it; a row is
  // kRtL / 4 pieces of 16 bytes
  const int grows = 8 * kNA * chunks, rows = 8 * (kNA + kNLM) * chunks;
  for (int e = tid; e < rows * (kRtL / 4); e += kRtThreads) {
    const int row = e / (kRtL / 4), p = 4 * (e % (kRtL / 4));
    if (p < width) {
      const bool in_g = row < grows;
      const int i = in_g ? row : row - grows;
      const float* src = (in_g ? gb : yb) + (size_t)i * lanes + p;
      float* dst = (in_g ? sg : sy) + (i >> 3) * kRtGS + (i & 7) * kRtL + p;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       gk::smem_u32(dst)),
                   "l"(src)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int a = tid % kRtL, m = tid / kRtL;
  float* ob = out + (size_t)b * kNA * kNLM * lanes + a0 + a;
  for (int n = 0; n < kNA; ++n) {
    float acc = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const float* gp = sg + (c * kNA + n) * kRtGS + a;
      const float* yp = sy + (c * kNLM + m) * kRtGS + a;
#pragma unroll
      for (int r = 0; r < 8; ++r) acc = fmaf(gp[r * kRtL], yp[r * kRtL], acc);
    }
    if (a < width) ob[(size_t)(n * kNLM + m) * lanes] = acc;
  }
}

// spill 1: the spill order, a block a (b, tile of at most kSpillThreads
// lanes); 0: the tiled order.
extern "C" int probe_reduce_launch(const float* g, const float* y, float* out,
                                   int nb, int na, int nlm, int chunks,
                                   int lanes, int spill, void* stream) {
  if (na != kNA || nlm != kNLM || lanes < 1 || lanes > 1024)
    return (int)cudaErrorInvalidValue;
  if (spill) {
    const int tile = min(lanes, kSpillThreads);
    const int tiles = (lanes + tile - 1) / tile;
    probe_reduce_spill_kernel<<<(unsigned)nb * tiles, tile, 0,
                                (cudaStream_t)stream>>>(g, y, out, chunks,
                                                        lanes, tiles);
    return (int)cudaGetLastError();
  }
  // the slab's rows are 16-byte pieces of lanes
  if (lanes % 4 || chunks < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)reduce_tiled_smem(chunks);
  cudaError_t err = cudaFuncSetAttribute(
      probe_reduce_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = reduce_tiles(lanes);
  probe_reduce_tiled_kernel<<<(unsigned)nb * tiles, kRtThreads, smem,
                              (cudaStream_t)stream>>>(g, y, out, chunks,
                                                      lanes, tiles);
  return (int)cudaGetLastError();
}

// The tiled order's launch at (nb, chunks, lanes): its dynamic shared
// memory, threads, lanes a tile, blocks (units) and resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int probe_reduce_occupancy(int nb, int chunks, int lanes,
                                      int* smem, int* threads, int* tile,
                                      int* units, int* blocks) {
  *smem = (int)reduce_tiled_smem(chunks);
  *threads = kRtThreads;
  *tile = kRtL;
  *units = nb * reduce_tiles(lanes);
  cudaError_t err = cudaFuncSetAttribute(
      probe_reduce_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      *smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, probe_reduce_tiled_kernel, kRtThreads, (size_t)*smem);
}

// ---------------------------------------------------------------------------
// blocked gather: out[b, i, a] = sum over q < nq of src[b, i, idx[b, q, a]],
// a term being 0 where idx < 0 or idx >= width (= 128 nblk), as the TPU
// kernel's blocked select gives.
//
// Bound: bytes: idx read once, out written once and, of src, the 32-byte
// sectors the valid indices touch (every channel reads the same columns).
// Design: a block per b, all channels.
//   1. b's indices (nq x lanes int32) go to shared memory by 16-byte
//      cp.async, all in flight at once; a flag word for each 8-column
//      sector of the window marks the sectors a valid index touches.
//   2. The window is taken in column chunks that fit beside the indices
//      (the plan sizes them for two blocks an SM).  A chunk without a
//      marked sector is skipped (the script's zero indices mark one
//      sector); otherwise its marked sectors of every channel, and no
//      others, are copied into shared memory transposed (column j,
//      channel i at j cgp + i, cgp the channels rounded up to 4), so that
//      one 16-byte load gives four channels of a column.
//   3. Thread (lane quad or lane, channel quad) adds, in q order, the
//      terms whose index falls in the chunk, kBgU indices at a time from
//      shared memory and one 16-byte shared-memory load a term (a
//      broadcast where a warp's indices are equal).  Its sums stay in
//      registers across the chunks and are written once.
// Terms add in (chunk, q) order, the same every run (no atomics): q order
// where one chunk covers the window.  Where the indices leave no room for
// a chunk of 8 columns, STAGE false reads indices and terms from device
// memory through the read-only path.
// ---------------------------------------------------------------------------

namespace {
constexpr int kBgU = 8;  // indices a thread takes at a time in the sums
constexpr int kBgMaxThreads = 512;

int bg_round4(int x) { return (x + 3) & ~3; }
}  // namespace

__device__ __forceinline__ void bg_mark(int* flag, int j, int width) {
  if ((unsigned)j < (unsigned)width) flag[j >> 3] = 1;
}

__device__ __forceinline__ void bg_add(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// channels ch0..ch0+3 (those below nch) of column j, from src
__device__ __forceinline__ float4 bg_direct(const float* sb, int width, int j,
                                            int ch0, int nch) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = ch0 + k < nch ? __ldg(sb + (size_t)(ch0 + k) * width + j) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// the indices of lanes l0..l0+LV-1 in row q (-1 past nq)
template <int LV>
__device__ __forceinline__ void bg_row(const int* row, bool in, int* j) {
  if (LV == 4) {
    const int4 v = in ? *reinterpret_cast<const int4*>(row)
                      : make_int4(-1, -1, -1, -1);
    j[0] = v.x;
    j[LV > 1 ? 1 : 0] = v.y;
    j[LV > 2 ? 2 : 0] = v.z;
    j[LV > 3 ? 3 : 0] = v.w;
  } else {
    j[0] = in ? *row : -1;
  }
}

template <int LV, bool STAGE>
__global__ void __launch_bounds__(kBgMaxThreads)
probe_bgather_kernel(const float* __restrict__ src,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int nch, int nq, int width, int lanes, int chunk) {
  extern __shared__ __align__(16) float s[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = nq * lanes, nsec = (width + 7) >> 3;
  const int quads = (nch + 3) >> 2, cgp = 4 * quads;
  const int* ib = idx + (size_t)b * n;
  const float* sb = src + (size_t)b * nch * width;
  int* si = reinterpret_cast<int*>(s);
  int* flag = si + ((n + 3) & ~3);
  float* sl = reinterpret_cast<float*>(flag + ((nsec + 3) & ~3));
  const float4* sl4 = reinterpret_cast<const float4*>(sl);
  if (STAGE) {
    // 1. the indices, and the sectors they touch
    if (n % 4 == 0) {  // b's indices start on a 16-byte boundary
      for (int e = tid; e < n / 4; e += nt)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         gk::smem_u32(si + 4 * e)),
                     "l"(ib + 4 * e)
                     : "memory");
    } else {
      for (int e = tid; e < n; e += nt) si[e] = __ldg(ib + e);
    }
    for (int e = tid; e < nsec; e += nt) flag[e] = 0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (n % 4 == 0) {
      const int4* si4 = reinterpret_cast<const int4*>(si);
#pragma unroll 4
      for (int e = tid; e < n / 4; e += nt) {
        const int4 v = si4[e];
        bg_mark(flag, v.x, width);
        bg_mark(flag, v.y, width);
        bg_mark(flag, v.z, width);
        bg_mark(flag, v.w, width);
      }
    } else {
      for (int e = tid; e < n; e += nt) bg_mark(flag, si[e], width);
    }
    __syncthreads();
  }
  // thread unit p: lanes l0..l0+LV-1 of channel quad c4
  const int lq = lanes / LV, units = lq * quads;
  for (int p0 = 0; p0 < units; p0 += nt) {
    const int p = p0 + tid;
    const bool mine = p < units;
    const int l0 = (p % lq) * LV, c4 = p / lq;
    float4 acc[LV];
#pragma unroll
    for (int l = 0; l < LV; ++l) acc[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!STAGE) {
      for (int q0 = 0; mine && q0 < nq; q0 += kBgU) {
        int j[kBgU][LV];
#pragma unroll
        for (int u = 0; u < kBgU; ++u) {
          const int q = q0 + u;
          if (LV == 4) {
            const int4 v = q < nq ? __ldg(reinterpret_cast<const int4*>(
                                        ib + (size_t)q * lanes + l0))
                                  : make_int4(-1, -1, -1, -1);
            j[u][0] = v.x;
            j[u][LV > 1 ? 1 : 0] = v.y;
            j[u][LV > 2 ? 2 : 0] = v.z;
            j[u][LV > 3 ? 3 : 0] = v.w;
          } else {
            j[u][0] = q < nq ? __ldg(ib + (size_t)q * lanes + l0) : -1;
          }
        }
#pragma unroll
        for (int u = 0; u < kBgU; ++u)
#pragma unroll
          for (int l = 0; l < LV; ++l)
            if ((unsigned)j[u][l] < (unsigned)width)
              bg_add(acc[l], bg_direct(sb, width, j[u][l], 4 * c4, nch));
      }
    }
    for (int c0 = 0; STAGE && c0 < width; c0 += chunk) {
      const int c1 = min(width, c0 + chunk), s0 = c0 >> 3;
      const int s1 = (c1 + 7) >> 3;
      int any = 0;
      for (int e = s0 + tid; e < s1; e += nt) any |= flag[e];
      if (!__syncthreads_or(any)) continue;
      // 2. the chunk's marked sectors of every channel, transposed; item
      // (sector, channel), channel fastest, four in flight a thread
      const int items = (s1 - s0) * nch;
      for (int e0 = tid; e0 < items; e0 += 4 * nt) {
        float4 lo[4], hi[4];
        int at[4], ch[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * nt;
          const int sec = s0 + e / nch;
          ch[u] = e % nch;
          at[u] = e < items && flag[sec] ? 8 * sec : -1;
          if (at[u] >= 0) {
            const float4* g = reinterpret_cast<const float4*>(
                sb + (size_t)ch[u] * width + at[u]);
            lo[u] = __ldg(g);
            hi[u] = at[u] + 4 < width ? __ldg(g + 1)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (at[u] < 0) continue;
          float* d = sl + (size_t)(at[u] - c0) * cgp + ch[u];
          d[0] = lo[u].x;
          d[cgp] = lo[u].y;
          d[2 * cgp] = lo[u].z;
          d[3 * cgp] = lo[u].w;
          if (at[u] + 4 < width) {  // width % 4 == 0: all four or none
            d[4 * cgp] = hi[u].x;
            d[5 * cgp] = hi[u].y;
            d[6 * cgp] = hi[u].z;
            d[7 * cgp] = hi[u].w;
          }
        }
      }
      __syncthreads();
      // 3. the terms that fall in the chunk, in q order
      const unsigned span = (unsigned)(c1 - c0);
      for (int q0 = 0; mine && q0 < nq; q0 += kBgU) {
        int j[kBgU][LV];
#pragma unroll
        for (int u = 0; u < kBgU; ++u)
          bg_row<LV>(si + (size_t)(q0 + u) * lanes + l0, q0 + u < nq, j[u]);
#pragma unroll
        for (int u = 0; u < kBgU; ++u)
#pragma unroll
          for (int l = 0; l < LV; ++l) {
            const unsigned c = (unsigned)(j[u][l] - c0);
            if (c < span) bg_add(acc[l], sl4[(size_t)c * quads + c4]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = 4 * c4 + i;
      if (!mine || ch >= nch) break;
      float v[LV];
#pragma unroll
      for (int l = 0; l < LV; ++l)
        v[l] = i == 0 ? acc[l].x : i == 1 ? acc[l].y : i == 2 ? acc[l].z
                                                               : acc[l].w;
      float* ob = out + ((size_t)b * nch + ch) * lanes + l0;
      if (LV == 4)
        *reinterpret_cast<float4*>(ob) = make_float4(
            v[0], v[LV > 1 ? 1 : 0], v[LV > 2 ? 2 : 0], v[LV > 3 ? 3 : 0]);
      else
        ob[0] = v[0];
    }
  }
}

namespace {
using BgKernel = void (*)(const float*, const int*, float*, int, int, int,
                          int, int);

// the instance for lv 4 or 1 lanes a thread, staged or not; 0 for
// another lv
BgKernel bg_kernel(int lv, int stage) {
  if (lv == 4)
    return stage ? probe_bgather_kernel<4, true>
                 : probe_bgather_kernel<4, false>;
  if (lv == 1)
    return stage ? probe_bgather_kernel<1, true>
                 : probe_bgather_kernel<1, false>;
  return nullptr;
}

// the indices, the flags and a chunk of columns x the channels rounded up
// to 4 (bench_mxu_probes.bgather_smem)
int bg_smem(int nq, int lanes, int nch, int width, int chunk) {
  const size_t words = (size_t)bg_round4(nq * lanes) +
                       bg_round4((width + 7) / 8) +
                       (size_t)chunk * bg_round4(nch);
  return (int)(sizeof(float) * words);
}

// raise an instance's dynamic shared-memory limit to smem once, not at
// every launch (nor inside a graph capture that follows a first launch)
cudaError_t bg_allow_smem(int lv, int smem) {
  static int allowed[2] = {0, 0};  // the staged instances, lv 1 and 4
  int& have = allowed[lv == 4];
  if (smem <= have) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      bg_kernel(lv, 1), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) have = smem;
  return err;
}
}  // namespace

// plan (bench_mxu_probes.bgather_plan): lv lanes a thread in the sums (1,
// or 4 for lanes a multiple of 4), stage (the indices and chunks of
// `chunk` columns, a multiple of 8, in smem bytes of shared memory) and
// threads a block.
extern "C" int probe_bgather_launch(const float* src, const int* idx,
                                    float* out, int nb, int nch, int nq,
                                    int width, int lanes, int lv, int stage,
                                    int chunk, int threads, int smem,
                                    void* stream) {
  const BgKernel kern = bg_kernel(lv, stage);
  if (kern == nullptr || nb < 1 || nch < 1 || nq < 0 || width < 4 ||
      width % 4 || lanes < 1 || lanes % lv || threads < 32 ||
      threads > kBgMaxThreads ||
      (stage && (chunk < 8 || chunk % 8 ||
                 smem != bg_smem(nq, lanes, nch, width, chunk))))
    return (int)cudaErrorInvalidValue;
  if (stage) {
    const cudaError_t err = bg_allow_smem(lv, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)nb, threads, stage ? smem : 0, (cudaStream_t)stream>>>(
      src, idx, out, nch, nq, width, lanes, chunk);
  return (int)cudaGetLastError();
}

// resident blocks an SM of the plan's instance
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int probe_bgather_occupancy(int lv, int stage, int threads,
                                       int smem, int* blocks) {
  const BgKernel kern = bg_kernel(lv, stage);
  if (kern == nullptr || threads < 32 || threads > kBgMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (stage) {
    const cudaError_t err = bg_allow_smem(lv, smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, threads, stage ? (size_t)smem : 0);
}
