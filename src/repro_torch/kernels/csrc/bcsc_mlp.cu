// Fused block-CSC MLP: out = (act(x Wg) * (x Wu)) Wd in one launch, the
// hidden rounded to bf16 before the down-projection.
//
// Replaces: src/repro/kernels/bcsc_mlp.py::bcsc_mlp_raw (Pallas bodies
// _mlp_kernel and _mlp_kernel_unrolled; the unrolled variant is a TPU
// compile artefact and the port computes the one function).
//
// Bound on Hopper: bytes of the three packed weight streams (each block read
// once per 8 activation rows), at decode widths M <= 64.
//
// Design: the TPU kernel keeps the (bm, d_ff) fp32 hidden in VMEM; at
// bm = 64, d_ff = 11008 gate plus up is 5.6 MB, far beyond one SM's 227 KB of
// shared memory. What keeps the point of that kernel (one launch, the hidden
// never making a round trip through device memory) is one cooperative launch
// with a grid-wide barrier, the hidden kept in a bf16 device workspace that
// stays in the 50 MB L2:
//   phase 1: each block owns a hidden block-column c; column-major BCSC keeps
//            its gate and up blocks contiguous; it computes
//            act(x Wg[:, c]) * (x Wu[:, c]) in fp32 and stores it as bf16;
//   barrier;
//   phase 2: each block owns an output block-column and walks its
//            down-projection segment in order over the hidden.
// Blocks at or past the layer's counts[i] are pads and are skipped. Sums run
// in a fixed order with no atomics, so the result is deterministic.
#include "common.cuh"

namespace repro {

// One-shot grid barrier on a zeroed counter. The cooperative launch
// guarantees that every block of the grid is resident.
__device__ __forceinline__ void grid_barrier(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*(volatile unsigned int*)counter < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void segment(const int* ptr, int c, int count,
                                        int* lo, int* hi) {
  *hi = min(ptr[c + 1], count);
  *lo = min(ptr[c], *hi);
}

__global__ void __launch_bounds__(kWalkThreads) bcsc_mlp_kernel(
    const bf16* __restrict__ x, int Mp, int K, const bf16* __restrict__ g_blk,
    const int* __restrict__ g_rows, const int* __restrict__ g_ptr,
    const bf16* __restrict__ u_blk, const int* __restrict__ u_rows,
    const int* __restrict__ u_ptr, const bf16* __restrict__ d_blk,
    const int* __restrict__ d_rows, const int* __restrict__ d_ptr,
    const int* __restrict__ counts, int act, int d_ff, int n_out,
    bf16* __restrict__ hidden, float* __restrict__ out,
    unsigned int* __restrict__ barrier) {
  __shared__ float red[kWalkGroups * kWalkRows * 16];
  const bool gated = u_blk != nullptr;
  const int tid = threadIdx.x;
  const int n_g = counts[0], n_u = counts[1], n_d = counts[2];

  // phase 1: hidden block-columns
  for (int c = blockIdx.x; c < d_ff / 16; c += gridDim.x) {
    int glo, ghi, ulo = 0, uhi = 0;
    segment(g_ptr, c, n_g, &glo, &ghi);
    if (gated) segment(u_ptr, c, n_u, &ulo, &uhi);
    for (int m0 = 0; m0 < Mp; m0 += kWalkRows) {
      const bf16* xm = x + (long)m0 * K;
      const float gv =
          segment_walk8<false>(xm, K, g_blk, g_rows, glo, ghi, red);
      const float uv =
          gated ? segment_walk8<false>(xm, K, u_blk, u_rows, ulo, uhi, red)
                : 1.0f;
      if (tid < kWalkRows * 16) {
        float h = epilogue(gv, 0.0f, act);
        if (gated) h *= uv;
        hidden[(long)(m0 + (tid >> 4)) * d_ff + c * 16 + (tid & 15)] =
            __float2bfloat16(h);
      }
    }
  }

  grid_barrier(barrier);

  // phase 2: output block-columns over the (L2-resident) hidden
  for (int c = blockIdx.x; c < n_out / 16; c += gridDim.x) {
    int dlo, dhi;
    segment(d_ptr, c, n_d, &dlo, &dhi);
    for (int m0 = 0; m0 < Mp; m0 += kWalkRows) {
      const float o = segment_walk8<true>(hidden + (long)m0 * d_ff, d_ff,
                                          d_blk, d_rows, dlo, dhi, red);
      if (tid < kWalkRows * 16)
        out[(long)(m0 + (tid >> 4)) * n_out + c * 16 + (tid & 15)] = o;
    }
  }
}

}  // namespace repro

// x (Mp, K) bf16 with Mp a multiple of 8; u_* null for an ungated MLP;
// counts (3,) int32 [n_g, n_u, n_d]; hidden (Mp, d_ff) bf16 workspace;
// out (Mp, n_out) fp32; barrier one zeroed uint32.
extern "C" int repro_bcsc_mlp(
    const void* x, int Mp, int K, const void* g_blk, const void* g_rows,
    const void* g_ptr, const void* u_blk, const void* u_rows,
    const void* u_ptr, const void* d_blk, const void* d_rows,
    const void* d_ptr, const void* counts, int act, int d_ff, int n_out,
    void* hidden, void* out, void* barrier, void* stream) {
  using namespace repro;
  if (Mp % kWalkRows || K % 16 || d_ff % 16 || n_out % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bcsc_mlp_kernel, kWalkThreads, 0);
  if (e != cudaSuccess) return (int)e;
  int want = max(d_ff, n_out) / 16;
  int grid = min(want, per_sm * sms);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&x,      (void*)&Mp,     (void*)&K,
                  (void*)&g_blk,  (void*)&g_rows, (void*)&g_ptr,
                  (void*)&u_blk,  (void*)&u_rows, (void*)&u_ptr,
                  (void*)&d_blk,  (void*)&d_rows, (void*)&d_ptr,
                  (void*)&counts, (void*)&act,    (void*)&d_ff,
                  (void*)&n_out,  (void*)&hidden, (void*)&out,
                  (void*)&barrier};
  e = cudaLaunchCooperativeKernel((const void*)bcsc_mlp_kernel, dim3(grid),
                                  dim3(kWalkThreads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
