// Fold: window-lane cotangents back onto the interior cell rows.
//
// Replaces the TPU kernel gpumd_tpu/engine/fold_kernel.py:_fold_kernel
// (called through fold_windows_to_rows).  It equals
// fold_ghost_grad_c(fold_block_windows(dw)): window group (dz, dy) of
// block row (zb, yb) holds ghost row (zb + dz, yb + dy), and window cell wx
// of x-block xb holds ghost x-cell xb*bx + wx; ghost cells fold onto their
// periodic images, and are dropped on non-periodic axes.
//
// What bounds it on the H100: bytes.  Each dw element is read once and
// each output written once, ~ (1 + 9 (bx+2)/bx) * 4 B per output element.
//
// Design, after the TPU kernel's own structure (one unit of work an output
// row, the halo cells rolled onto their neighbours): a block takes one
// output row (z, y, c).  Each thread resolves the row's 9 source rows
// ((z - dz + 1) mod nz, (y - dy + 1) mod ny; null on a non-periodic axis
// past the edge) once, then walks units of V floats (V = 4, 16-byte
// loads and stores, where cap, wl and both bases allow it; else 1) as
// (x-block xb, lane l within bx*cap) with 32-bit indices.  For each group
// it adds the main band (window cells 1..bx, contiguous, onto the block's
// own cells), window cell 0 of the next x-block onto the last cell, and
// window cell bx+1 of the previous x-block onto the first cell, with the
// x wrap at the ends on a periodic x.  No division sits in the group
// loop: cell edges are compares on l.  The adds run in the order the
// one-thread-an-element kernel this replaces took (group (dz, dy) order;
// in a group the next block's cell 0, the main band, the previous block's
// cell bx+1, then the wrapped cell 0 and cell bx+1), so each output has
// the same bits.  Needs no 128-lane alignment, so it serves every plan.
//
// The z-halo mode (fold_halo_launch) serves a z slab of the sharded engine
// (engine/sharded.py): x and y fold as above, z never wraps, and the
// output has nz + 2 rows, ghost rows included: row g takes block row
// g - dz of group dz where that row exists, so rows 0 and nz + 1 hold what
// falls below and above the slab, for the caller to send to the
// neighbouring slabs.  It replaces the hooked branch of the JAX package's
// compact_pipeline (fold_block_windows, the ghost exchange, then
// fold_ghost_grad_c), which is plain XLA there: the x/y fold is linear and
// acts within a z row, so exchanging x/y-folded rows equals that order.
#include <cuda_runtime.h>

namespace {

constexpr int kFoldMaxThreads = 128;

template <int V>
struct FoldUnit;
template <>
struct FoldUnit<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void add(T& a, const T* p) {
    const T b = __ldcs(p);  // read once: evict first
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};
template <>
struct FoldUnit<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ void add(T& a, const T* p) {
    a += __ldcs(p);
  }
};

// source row of output row `i` for group offset d (0..2) on an axis of n
// cells: i - d + 1, wrapped where periodic, -1 where dropped
__device__ __forceinline__ int fold_source(int i, int d, int n, int pbc) {
  int s = i - d + 1;
  if (s < 0) s = pbc ? s + n : -1;
  if (s >= n) s = pbc ? s - n : -1;
  return s;
}

// source block row of output ghost row `g` (0..n+1) for group offset d in
// the z-halo mode: g - d where it lies in the slab, else -1
__device__ __forceinline__ int halo_source(int g, int d, int n) {
  const int s = g - d;
  return (s >= 0 && s < n) ? s : -1;
}

}  // namespace

template <int V>
__global__ void __launch_bounds__(kFoldMaxThreads)
fold_rows_kernel(const float* __restrict__ dw, float* __restrict__ out,
                 int nx, int ny, int nz, int cap, int bx, int C, int wl,
                 int pbcx, int pbcy, int pbcz, int zhalo) {
  using U = FoldUnit<V>;
  using T = typename U::T;
  // (z * ny + y) * C + c; z a ghost row (0..nz+1) in the z-halo mode
  const int row = blockIdx.x;
  const int c = row % C, zy = row / C;
  const int y = zy % ny, z = zy / ny;
  const int capv = cap / V, w = bx * capv, nxb = nx / bx;
  const int wlv = wl / V, wgv = (bx + 2) * capv;
  const int n = nxb * w;  // units of the output row
  const T* src[9];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    const int zb =
        zhalo ? halo_source(z, dz, nz) : fold_source(z, dz, nz, pbcz);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yb = fold_source(y, dy, ny, pbcy);
      src[dz * 3 + dy] =
          (zb < 0 || yb < 0)
              ? nullptr
              : reinterpret_cast<const T*>(dw) +
                    ((size_t)(zb * ny + yb) * C + c) * nxb * wlv +
                    (dz * 3 + dy) * wgv;
    }
  }
  T* orow = reinterpret_cast<T*>(out) + (size_t)row * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int xb = e / w, l = e - xb * w;
    const bool first = l < capv, last = l >= w - capv;
    // the next block's cell 0 lands on the last cell, the previous
    // block's cell bx+1 on the first; at the ends of x only by the wrap
    const bool next = last && xb + 1 < nxb, prev = first && xb > 0;
    const bool next_wrap = pbcx && last && xb + 1 == nxb;
    const bool prev_wrap = pbcx && first && xb == 0;
    const int o_main = xb * wlv + capv + l;
    const int o_next = (xb + 1 == nxb ? 0 : xb + 1) * wlv + l - (w - capv);
    const int o_prev = (xb == 0 ? nxb - 1 : xb - 1) * wlv + (bx + 1) * capv +
                       l;
    T acc = U::zero();
#pragma unroll
    for (int g = 0; g < 9; ++g) {
      const T* s = src[g];
      if (s == nullptr) continue;
      if (next) U::add(acc, s + o_next);
      U::add(acc, s + o_main);
      if (prev) U::add(acc, s + o_prev);
      if (next_wrap) U::add(acc, s + o_next);
      if (prev_wrap) U::add(acc, s + o_prev);
    }
    orow[e] = acc;
  }
}

namespace {

int fold_go(const float* dw, float* out, int nx, int ny, int nz, int cap,
            int bx, int C, int wl, int pbcx, int pbcy, int pbcz, int zhalo,
            int vec, int threads, void* stream) {
  if (bx < 1 || nx % bx || threads < 1 || threads > kFoldMaxThreads ||
      (vec != 1 && vec != 4) || cap % vec || wl % vec)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (((size_t)dw | (size_t)out) & 15))
    return (int)cudaErrorMisalignedAddress;
  const unsigned rows = (unsigned)(nz + 2 * zhalo) * ny * C;
  if (vec == 4)
    fold_rows_kernel<4><<<rows, threads, 0, (cudaStream_t)stream>>>(
        dw, out, nx, ny, nz, cap, bx, C, wl, pbcx, pbcy, pbcz, zhalo);
  else
    fold_rows_kernel<1><<<rows, threads, 0, (cudaStream_t)stream>>>(
        dw, out, nx, ny, nz, cap, bx, C, wl, pbcx, pbcy, pbcz, zhalo);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch comes from the wrapper's fold_plan: `vec` floats a unit (4 or
// 1) and `threads` a block; a block a row (z, y, c).
extern "C" int fold_launch(const float* dw, float* out, int nx, int ny,
                           int nz, int cap, int bx, int C, int wl, int pbcx,
                           int pbcy, int pbcz, int vec, int threads,
                           void* stream) {
  return fold_go(dw, out, nx, ny, nz, cap, bx, C, wl, pbcx, pbcy, pbcz, 0,
                 vec, threads, stream);
}

// The z-halo mode: out (nz + 2, ny, C, nx * cap), a block a row (g, y, c).
extern "C" int fold_halo_launch(const float* dw, float* out, int nx, int ny,
                                int nz, int cap, int bx, int C, int wl,
                                int pbcx, int pbcy, int vec, int threads,
                                void* stream) {
  return fold_go(dw, out, nx, ny, nz, cap, bx, C, wl, pbcx, pbcy, 0, 1, vec,
                 threads, stream);
}

// The resident blocks an SM of the fold kernel at (vec, threads)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int fold_occupancy(int vec, int threads, int* blocks) {
  const void* kernel = vec == 4 ? (const void*)fold_rows_kernel<4>
                                : (const void*)fold_rows_kernel<1>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, 0);
}
