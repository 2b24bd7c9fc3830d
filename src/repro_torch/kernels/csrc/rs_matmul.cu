// Dense (M, K) x (K, N) matmul with bf16 operands, an fp32 accumulator held
// across the whole K loop and the fused bias + activation epilogue at its
// flush; out fp32 or bf16.
//
// Replaces: src/repro/kernels/rs_matmul.py::rs_matmul_raw (Pallas body
// _rs_matmul_kernel), the row-stationary kernel whose (bm, bn) fp32 psum
// tile stays in VMEM while x and w tiles stream past it.
//
// Bound on Hopper: operations at prefill-sized M (512 x 2304 x 9216 is
// 2.2e10 flops, 0.022 ms at 989 TFLOP/s, against 63 MB, 0.019 ms at
// 3.35 TB/s), bytes of w at decode-sized M.
//
// Design: one thread block of 4 warps per 64 x 64 output tile; each warp
// keeps a 32 x 32 fp32 accumulator as 2 x 2 WMMA fragments for the whole K
// loop (the stationary psum tile). Per 64-deep k-step the block stages a
// 64 x 64 tile of x and of w in shared memory and issues 16 bf16 16x16x16
// tensor-core products per warp. At the end the accumulator goes through
// shared memory once so that each thread can apply common.cuh's epilogue
// (bias, then relu / silu / tanh-gelu, in fp32) and store its elements. The
// wrapper pads M and N to 64 and K to 64 with zeros. The TPU tiling rule
// (dataflow.rs_matmul_tiling, a VMEM-fit check) is not carried over.
//
// What holds it back: the tile loads are synchronous, so global-memory
// latency is exposed on every k-step, and 64 x 64 tiles reuse each loaded
// byte only 64 times; a TMA ring feeding wgmma on 128-row tiles is later
// work.
#include <mma.h>

#include "common.cuh"

namespace repro {

constexpr int kRsTile = 64;
constexpr int kRsDepth = 64;
constexpr int kRsThreads = 128;
constexpr int kRsPad = 8;          // bf16 row padding (16 bytes)

__global__ void __launch_bounds__(kRsThreads) rs_matmul_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ bias, int act, void* __restrict__ out,
    int out_bf16, int M, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 xs[kRsTile][kRsDepth + kRsPad];
  __shared__ __align__(128) bf16 ws[kRsDepth][kRsTile + kRsPad];
  __shared__ __align__(128) float cs[kRsTile][kRsTile + 4];
  const int m0 = blockIdx.y * kRsTile, n0 = blockIdx.x * kRsTile;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kRsDepth) {
    // 64 rows x 8 chunks of 16 bytes, for each of the two tiles
    for (int i = threadIdx.x; i < kRsTile * 8; i += kRsThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      *reinterpret_cast<uint4*>(&xs[r][c]) = *reinterpret_cast<const uint4*>(
          x + (long)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&ws[r][c]) = *reinterpret_cast<const uint4*>(
          w + (long)(k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRsDepth; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &xs[wm + 16 * i][kk], kRsDepth + kRsPad);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &ws[kk][wn + 16 * j], kRsTile + kRsPad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                              kRsTile + 4, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kRsTile * kRsTile; i += kRsThreads) {
    const int r = i / kRsTile, c = i % kRsTile;
    const float val =
        epilogue(cs[r][c], bias != nullptr ? bias[n0 + c] : 0.0f, act);
    const long o = (long)(m0 + r) * N + n0 + c;
    if (out_bf16)
      reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(val);
    else
      reinterpret_cast<float*>(out)[o] = val;
  }
}

}  // namespace repro

// x (M, K), w (K, N) bf16 with M and N multiples of 64 and K a multiple of
// 64; bias (N,) fp32 or null; out (M, N) fp32, or bf16 when out_bf16.
extern "C" int repro_rs_matmul(const void* x, const void* w, const void* bias,
                               int act, void* out, int out_bf16, int M, int K,
                               int N, void* stream) {
  using namespace repro;
  if (M % kRsTile || N % kRsTile || K % kRsDepth || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(N / kRsTile, M / kRsTile);
  rs_matmul_kernel<<<grid, kRsThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)bias, act, out, out_bf16,
      M, K, N);
  return (int)cudaGetLastError();
}
