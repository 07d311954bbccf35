// Compaction: gather the window lanes a block keeps (its compact candidate
// list) into the K1/K2 source layout (nz, ny, nxb, C, cl).
//
// Replaces the TPU kernels gpumd_tpu/engine/nep_compact.py:
//   _compact_rows_kernel (called through compact_rows_call), which reads the
//     kept lanes straight from the 9 ghost-row slices of a block, and
//   _compact_win_kernel (called through compact_windows_call), which reads
//     them from a packed window, for plans rows_compact_eligible rejects.
// The TPU had no vector gather: it scanned every 128-lane source block with
// a one-hot take_along per chunk and masked by block id (or by measured
// bands).  Hopper loads by index, so none of that carries over: each output
// lane reads its source once.
//
// What bounds them on the H100: bytes.  A launch reads cidx (4 B per
// compact lane) and the source (the ghost rows or the window) and writes
// C x cl floats per block; there is no arithmetic beyond index math.
// Design: one thread block per grid block (z, y, xb), threads over the cl
// compact lanes; each thread reads its cidx entry once and copies the C
// channels.  Writes are coalesced (lane-contiguous); cidx is ascending
// (compact_select), so neighbouring threads read nearby source words.  The
// kernels copy: the result equals the plain version bit for bit.  Every
// cidx entry is a window lane below wl (compact_select sorts the lanes of
// the window), and on the plans compact_rows serves wl == 9 * wgrp, so
// neither kernel range-checks it.  Pad lanes (>= cnt) copy whatever they
// index, as the TPU kernels did; mask_compact_pads parks them afterwards.
#include <cuda_runtime.h>

// Window lane L of block (z, y, xb) is ghost row (z + dz, y + dy) at lane
// xb * xstride + off, with g = L / wgrp = 3 dz + dy and off = L % wgrp
// (pack_block_windows' numbering; xstride = bx * cap, wgrp = (bx+2) * cap).
__global__ void compact_rows_kernel(const float* __restrict__ grows,
                                    const int* __restrict__ cidx,
                                    float* __restrict__ out, int ny, int nxb,
                                    int nyg, int C, int lanes, int cl,
                                    int wgrp, int xstride) {
  const int b = blockIdx.x;
  const int xb = b % nxb, zy = b / nxb;
  const int y = zy % ny, z = zy / ny;
  const int* ci = cidx + (size_t)b * cl;
  float* ob = out + (size_t)b * C * cl;
  for (int o = threadIdx.x; o < cl; o += blockDim.x) {
    const int L = ci[o];
    const int g = L / wgrp, off = L - g * wgrp;
    const int dz = g / 3, dy = g - 3 * dz;
    const float* src = grows + ((size_t)(z + dz) * nyg + (y + dy)) * C * lanes +
                       (size_t)xb * xstride + off;
    for (int c = 0; c < C; ++c) ob[(size_t)c * cl + o] = __ldg(src + (size_t)c * lanes);
  }
}

__global__ void compact_windows_kernel(const float* __restrict__ win,
                                       const int* __restrict__ cidx,
                                       float* __restrict__ out, int C, int wl,
                                       int cl) {
  const int b = blockIdx.x;
  const int* ci = cidx + (size_t)b * cl;
  const float* wb = win + (size_t)b * C * wl;
  float* ob = out + (size_t)b * C * cl;
  for (int o = threadIdx.x; o < cl; o += blockDim.x) {
    const int L = ci[o];
    for (int c = 0; c < C; ++c) ob[(size_t)c * cl + o] = __ldg(wb + (size_t)c * wl + L);
  }
}

extern "C" int compact_rows_launch(const float* grows, const int* cidx,
                                   float* out, int nb, int ny, int nxb,
                                   int nyg, int C, int lanes, int cl, int wgrp,
                                   int xstride, void* stream) {
  compact_rows_kernel<<<nb, 256, 0, (cudaStream_t)stream>>>(
      grows, cidx, out, ny, nxb, nyg, C, lanes, cl, wgrp, xstride);
  return (int)cudaGetLastError();
}

extern "C" int compact_windows_launch(const float* win, const int* cidx,
                                      float* out, int nb, int C, int wl,
                                      int cl, void* stream) {
  compact_windows_kernel<<<nb, 256, 0, (cudaStream_t)stream>>>(win, cidx, out,
                                                              C, wl, cl);
  return (int)cudaGetLastError();
}
