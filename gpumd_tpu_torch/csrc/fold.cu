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
// each output written once, ~ (1 + (bx+2)/bx) * 4 B per output element.
// Design: one thread per output element, which gathers its 9 (dz, dy)
// groups and their x-halo cells with the periodic wrap in the index
// arithmetic; the (at most two) window cells that hold a ghost x-cell are
// computed, not searched over all bx + 2 (at bx 14 the search made the
// kernel bound by its integer divisions).  Neighbouring threads hold neighbouring slots of a cell, so
// reads and writes coalesce.  Unlike the TPU kernel it needs no 128-lane
// alignment, so it serves every plan.
#include <cuda_runtime.h>

__global__ void fold_kernel(const float* __restrict__ dw,
                            float* __restrict__ out, int nx, int ny, int nz,
                            int cap, int bx, int C, int wl, int pbcx,
                            int pbcy, int pbcz) {
  const size_t total = (size_t)nz * ny * C * nx * cap;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  size_t r = i;
  const int s = (int)(r % cap); r /= cap;
  const int x = (int)(r % nx); r /= nx;
  const int c = (int)(r % C); r /= C;
  const int y = (int)(r % ny);
  const int z = (int)(r / ny);
  const int nxb = nx / bx;
  // ghost x-cells that fold onto interior cell x
  int gxs[3];
  int ng = 0;
  gxs[ng++] = x + 1;
  if (pbcx && x == nx - 1) gxs[ng++] = 0;
  if (pbcx && x == 0) gxs[ng++] = nx + 1;
  float acc = 0.0f;
  for (int dz = 0; dz < 3; ++dz) {
    int zb = z - dz + 1;
    if (zb < 0 || zb >= nz) {
      if (!pbcz) continue;
      zb = (zb + nz) % nz;
    }
    for (int dy = 0; dy < 3; ++dy) {
      int yb = y - dy + 1;
      if (yb < 0 || yb >= ny) {
        if (!pbcy) continue;
        yb = (yb + ny) % ny;
      }
      const float* src = dw + (((size_t)zb * ny + yb) * C + c) * nxb * wl;
      const int grp = (dz * 3 + dy) * (bx + 2);
      // ghost x-cell g sits at window cell wx of x-block xb when
      // g = xb*bx + wx: wx = g % bx, or g % bx + bx when that is < bx + 2
      for (int q = 0; q < ng; ++q) {
        const int g = gxs[q];
        for (int wx = g % bx; wx < bx + 2; wx += bx) {
          const int xb = (g - wx) / bx;
          if (xb >= 0 && xb < nxb)
            acc += src[(size_t)xb * wl + (grp + wx) * cap + s];
        }
      }
    }
  }
  out[i] = acc;
}

extern "C" int fold_launch(const float* dw, float* out, int nx, int ny,
                           int nz, int cap, int bx, int C, int wl, int pbcx,
                           int pbcy, int pbcz, void* stream) {
  const size_t total = (size_t)nz * ny * C * nx * cap;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  fold_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      dw, out, nx, ny, nz, cap, bx, C, wl, pbcx, pbcy, pbcz);
  return (int)cudaGetLastError();
}
