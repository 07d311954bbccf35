// Scatter: pair cotangents p_ij onto the neighbours' window lanes.
//
// Replaces the TPU kernel gpumd_tpu/engine/nep_compact.py:_scatter_kernel
// (called through scatter_call).  The TPU built a one-hot matrix and ran
// the scatter as an MXU matmul with a bf16 hi/lo split of the values;
// here every p_ij is added, unchanged in f32, onto lane idx[m, a] of its
// block's window, so Newton's third law stays exact: j receives the very value K2 subtracted at the centre.  With compact
// candidate lists, idx holds compact lanes and cidx (nb, cl) maps each to
// its window lane: the translation is one int load per pair before the
// atomic (the TPU carried cidx as f32 through a one-hot gather; here it
// stays int32).  cidx == nullptr leaves idx as window lanes.
//
// What bounds it on the H100: bytes and shared-memory atomics.  It reads
// pch * mn_a * a_pad values and mn_a * a_pad indices per block and writes
// pch * wl window lanes.  Design: one block per grid block; the window
// accumulator (pch x wl floats: 36 KB at pch 4, 110 KB at pch 12 on the
// PbTe plan) lives in shared memory, filled by shared-memory float
// atomics (their order varies from run to run, so results agree with the
// plain version to rounding, not bitwise), then written out once in the
// (nz, ny, pch, nxb, wl) layout the fold reads.
#include <cuda_runtime.h>

__global__ void scatter_kernel(const float* __restrict__ pvals,
                               const int* __restrict__ idx,
                               const int* __restrict__ cidx,
                               float* __restrict__ out, int pch, int mnp,
                               int a_pad, int wl, int nxb, int idx_bstride,
                               int idx_mstride, int cl) {
  extern __shared__ float acc[];  // (pch, wl)
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < pch * wl; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const float* pv = pvals + (size_t)b * pch * mnp * a_pad;
  const int* ib = idx + (size_t)b * idx_bstride;
  const int* cb = cidx ? cidx + (size_t)b * cl : nullptr;
  const size_t pc = (size_t)mnp * a_pad;
  for (int p = threadIdx.x; p < mnp * a_pad; p += blockDim.x) {
    const int m = p / a_pad, a = p - m * a_pad;
    int j = ib[(size_t)m * idx_mstride + a];
    if (cb) j = cb[j];
    for (int c = 0; c < pch; ++c) {
      const float v = pv[c * pc + p];
      if (v != 0.0f) atomicAdd(&acc[c * wl + j], v);
    }
  }
  __syncthreads();
  const int zy = b / nxb, xb = b - zy * nxb;
  for (int i = threadIdx.x; i < pch * wl; i += blockDim.x) {
    const int c = i / wl, l = i - c * wl;
    out[(((size_t)zy * pch + c) * nxb + xb) * wl + l] = acc[i];
  }
}

extern "C" int scatter_launch(const float* pvals, const int* idx,
                              const int* cidx, float* out, int nb, int pch,
                              int mnp, int a_pad, int wl, int nxb,
                              int idx_bstride, int idx_mstride, int cl,
                              void* stream) {
  const size_t smem = sizeof(float) * (size_t)pch * wl;
  cudaFuncSetAttribute(scatter_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  scatter_kernel<<<nb, 256, smem, (cudaStream_t)stream>>>(
      pvals, idx, cidx, out, pch, mnp, a_pad, wl, nxb, idx_bstride,
      idx_mstride, cl);
  return (int)cudaGetLastError();
}

extern "C" const char* gk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
