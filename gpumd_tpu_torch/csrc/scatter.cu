// Scatter: pair cotangents p_ij onto the neighbours' window lanes.
//
// Replaces the TPU kernel gpumd_tpu/engine/nep_compact.py:_scatter_kernel
// (called through scatter_call).  The TPU built a one-hot matrix and ran
// the scatter as an MXU matmul with a bf16 hi/lo split of the values;
// here every p_ij is added, unchanged in f32, onto lane idx[m, a] of its
// block's window, so Newton's third law stays exact: j receives the very
// value K2 subtracted at the centre.  With compact candidate lists, idx
// holds compact lanes and cidx (nb, cl) maps each to its window lane (an
// int load per live lane before its atomics; the TPU carried cidx as f32
// through a one-hot gather).  cidx == nullptr leaves idx as window lanes.
//
// What bounds it on the H100: bytes.  It reads pch * mnp * a_pad values
// and mnp * a_pad indices per block and writes pch * wl window lanes.
//
// Design.  The kernel before this one gave each grid block one CTA that
// held all pch channels of the window accumulator in shared memory (110
// KB at pch 12 on the PbTe plans: 2 CTAs, 16 warps an SM) and walked the
// pairs with 4-byte loads, one channel at a time: too few loads were in
// flight to cover the memory's latency (probes/ab_scatter.py: its loads
// alone reached 42% of the bound, and pch 4 at pch 12's shared memory took
// twice pch 4's time).  Here:
//  - the channels are cut over CTAs: CTA (b, g) holds channels
//    [g * G, g * G + G) of block b in a (G, wl) accumulator, G = 2 where
//    it divides pch and leaves 8 CTAs (64 warps) an SM, else 1 (the
//    wrapper's scatter_plan; 18,432 B at wl 2304).  Four channels a CTA
//    held 6 CTAs an SM at 36,864 B and 40 registers and ran 3-5% slower
//    at 12 channels.  The CTAs of one block are neighbours in the grid
//    and read its idx and cidx again from L2, not from device memory;
//  - a thread takes V = 4 lanes a along a row m: one 16-byte load of idx
//    and one of each of its G channels' pvals (read once: evict first),
//    all issued before the first atomic;
//  - a lane whose G values are all zero (a dead slot: K2 writes exact
//    zeros there) costs no cidx load and no atomic;
//  - the zero-fill and the write-out move 16-byte units, channel-major,
//    with no division;
//  - the dynamic shared-memory limit is raised once a process and device,
//    not at every launch.
// The accumulator is filled by shared-memory float atomics (a
// compare-and-swap loop on sm_90a; their order varies from run to run, so
// results agree with the plain version to rounding, not bitwise), then
// written once in the (nz, ny, pch, nxb, wl) layout the fold reads.  V = 1
// (4-byte units) serves shapes or bases that 16-byte units do not fit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // what one block may use on Hopper
constexpr int kMaxDevices = 64;

template <int V>
__device__ __forceinline__ void load_values(float (&d)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    d[0] = t.x;
    d[1] = t.y;
    d[2] = t.z;
    d[3] = t.w;
  } else {
    d[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void load_lanes(int (&d)[V], const int* p) {
  if constexpr (V == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    d[0] = t.x;
    d[1] = t.y;
    d[2] = t.z;
    d[3] = t.w;
  } else {
    d[0] = __ldg(p);
  }
}

template <int V>
struct Unit;
template <>
struct Unit<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
};
template <>
struct Unit<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
};

}  // namespace

// ptxas keeps every instance within 32 registers without spilling, so 8
// CTAs fit an SM (a bound of 8 blocks made it spill)
template <int V, int G>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ pvals, const int* __restrict__ idx,
               const int* __restrict__ cidx, float* __restrict__ out,
               int pch, int mnp, int a_pad, int wl, int nxb,
               int idx_bstride, int idx_mstride, int cl) {
  using T = typename Unit<V>::T;
  extern __shared__ float4 smem[];
  float* acc = reinterpret_cast<float*>(smem);  // (G, wl)
  T* accv = reinterpret_cast<T*>(smem);
  const int groups = pch / G;
  const int b = blockIdx.x / groups, c0 = (blockIdx.x - b * groups) * G;
  const int wlv = wl / V;
  for (int i = threadIdx.x; i < G * wlv; i += kThreads)
    accv[i] = Unit<V>::zero();
  __syncthreads();

  // offsets inside a block fit 32 bits (the launcher checks)
  const int pc = mnp * a_pad;
  const float* pv = pvals + ((size_t)b * pch + c0) * pc;
  const int* ib = idx + (size_t)b * idx_bstride;
  const int* cb = cidx ? cidx + (size_t)b * cl : nullptr;
  const int av = a_pad / V, nq = mnp * av;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int m = q / av, a = (q - m * av) * V;
    const int p = m * a_pad + a;
    float v[G][V];
#pragma unroll
    for (int c = 0; c < G; ++c) load_values<V>(v[c], pv + (c * pc + p));
    int j[V];
    load_lanes<V>(j, ib + (m * idx_mstride + a));
#pragma unroll
    for (int k = 0; k < V; ++k) {
      bool live = false;
#pragma unroll
      for (int c = 0; c < G; ++c) live |= v[c][k] != 0.0f;
      if (!live) continue;
      const int l = cb ? __ldg(cb + j[k]) : j[k];
#pragma unroll
      for (int c = 0; c < G; ++c)
        if (v[c][k] != 0.0f) atomicAdd(&acc[c * wl + l], v[c][k]);
    }
  }
  __syncthreads();

  const int zy = b / nxb, xb = b - zy * nxb;
#pragma unroll
  for (int c = 0; c < G; ++c) {
    T* orow = reinterpret_cast<T*>(
        out + (((size_t)zy * pch + c0 + c) * nxb + xb) * wl);
    const T* arow = accv + c * wlv;
    for (int i = threadIdx.x; i < wlv; i += kThreads) orow[i] = arow[i];
  }
}

namespace {

// the instance of (vec, group), or nullptr
const void* instance(int vec, int group) {
  if (vec == 4) {
    if (group == 2) return (const void*)scatter_kernel<4, 2>;
    if (group == 1) return (const void*)scatter_kernel<4, 1>;
  } else if (vec == 1) {
    if (group == 2) return (const void*)scatter_kernel<1, 2>;
    if (group == 1) return (const void*)scatter_kernel<1, 1>;
  }
  return nullptr;
}

// raise every instance's dynamic shared-memory limit once a device
int allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  const int units[] = {4, 1}, groups[] = {2, 1};
  for (int vec : units)
    for (int group : groups) {
      err = cudaFuncSetAttribute(instance(vec, group),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemLimit);
      if (err != cudaSuccess) return (int)err;
    }
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

}  // namespace

// The launch comes from the wrapper's scatter_plan: `vec` lanes a unit (4:
// 16-byte loads and stores, or 1) and `group` channels a CTA (2 or 1,
// dividing pch); pch / group CTAs a block, group * wl floats of shared
// memory each.
extern "C" int scatter_launch(const float* pvals, const int* idx,
                              const int* cidx, float* out, int nb, int pch,
                              int mnp, int a_pad, int wl, int nxb,
                              int idx_bstride, int idx_mstride, int cl,
                              int vec, int group, void* stream) {
  const void* kernel = instance(vec, group);
  if (kernel == nullptr || nb < 1 || pch < 1 || mnp < 1 || a_pad < 1 ||
      wl < 1 || pch % group || a_pad % vec || wl % vec ||
      idx_bstride % vec || idx_mstride % vec ||
      (long long)pch * mnp * a_pad > 0x7fffffffLL ||
      (long long)mnp * idx_mstride > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (((size_t)pvals | (size_t)idx | (size_t)out) & 15))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = sizeof(float) * (size_t)group * wl;
  const long long ctas = (long long)nb * (pch / group);
  if (smem > (size_t)kSmemLimit || ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rc = allow_smem();
  if (rc) return rc;
  void* args[] = {&pvals, &idx,   &cidx, &out,         &pch,        &mnp,
                  &a_pad, &wl,    &nxb,  &idx_bstride, &idx_mstride, &cl};
  const cudaError_t err =
      cudaLaunchKernel(kernel, dim3((unsigned)ctas), dim3(kThreads), args,
                       smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The resident CTAs an SM of the (vec, group) instance at `smem` bytes a
// CTA (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int scatter_occupancy(int vec, int group, int smem, int* blocks) {
  const void* kernel = instance(vec, group);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int rc = allow_smem();
  if (rc) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, (size_t)smem);
}

extern "C" const char* gk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
