// Block-CSC sparse matmuls: x (M, K) bf16 times a BCSC (K, N) weight of
// 16 x 16 bf16 blocks, fp32 out.
//
// Replaces: src/repro/kernels/bcsc_matmul.py::bcsc_matmul_raw (Pallas body
// _bcsc_kernel) with repro_bcsc_gemm, and bcsc_gemv_raw (body
// _bcsc_gemv_kernel) with repro_bcsc_gemv.
//
// The TPU kernels walk one grid step per non-zero block and revisit-
// accumulate each output tile along its column segment, which needs the
// sequential grid. Here one thread block owns an output block-column (and,
// for the GEMM, an m-tile) and walks that column's segment of the
// column-major payload in order: no cross-block reduction, no atomics, the
// same sum order on every run. Segment starts come from col_ptr, derived
// from the non-decreasing col_ids. Pad blocks repeat the last (row, col)
// with a zero payload and add nothing.
//
// GEMM (prefill, M > 8). Bound: operations at large M (each weight block is
// reused by M/16 warps), bytes below. Each warp holds one 16 x 16 fp32
// accumulator and issues one 16x16x16 bf16 tensor-core product (WMMA,
// mma.sync underneath) per block, reading A straight from x. 16 x 16 blocks
// are small for Hopper's tensor cores; wgmma/TMA tiles over several blocks
// are later work.
//
// GEMV (decode, M <= 8, rows padded to 8). Bound: bytes of the weight
// stream. 16 groups of 16 threads split a column's blocks, each thread
// keeps 8 row accumulators for its output column, partials are summed in a
// fixed order, and the fused bias + activation epilogue runs at the flush.
#include <mma.h>

#include "common.cuh"

namespace repro {

constexpr int kGemmWarps = 4;  // 64 rows of x per thread block

__global__ void __launch_bounds__(kGemmWarps * 32) bcsc_gemm_kernel(
    const bf16* __restrict__ x, int M, int K, const bf16* __restrict__ blocks,
    const int* __restrict__ row_ids, const int* __restrict__ col_ptr,
    float* __restrict__ out, int N) {
  using namespace nvcuda;
  const int c = blockIdx.x;
  const int m0 = (blockIdx.y * kGemmWarps + (threadIdx.x >> 5)) * 16;
  if (m0 >= M) return;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  wmma::fill_fragment(acc, 0.0f);
  const int lo = col_ptr[c], hi = col_ptr[c + 1];
  const bf16* xm = x + (long)m0 * K;
  for (int i = lo; i < hi; ++i) {
    wmma::load_matrix_sync(a, xm + (long)row_ids[i] * 16, K);
    wmma::load_matrix_sync(b, blocks + (long)i * 256, 16);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(out + (long)m0 * N + c * 16, acc, N,
                          wmma::mem_row_major);
}

__global__ void __launch_bounds__(kWalkThreads) bcsc_gemv_kernel(
    const bf16* __restrict__ x, int K, const bf16* __restrict__ blocks,
    const int* __restrict__ row_ids, const int* __restrict__ col_ptr,
    const float* __restrict__ bias, int act, float* __restrict__ out, int N) {
  __shared__ float red[kWalkGroups * kWalkRows * 16];
  const int c = blockIdx.x;
  const float r = segment_walk8<false>(x, K, blocks, row_ids, col_ptr[c],
                                       col_ptr[c + 1], red);
  if (threadIdx.x < kWalkRows * 16) {
    const int m = threadIdx.x >> 4;
    const int col = c * 16 + (threadIdx.x & 15);
    out[(long)m * N + col] =
        epilogue(r, bias != nullptr ? bias[col] : 0.0f, act);
  }
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) with M a multiple of 16; out (M, N) fp32.
extern "C" int repro_bcsc_gemm(const void* x, int M, int K,
                               const void* blocks, const void* row_ids,
                               const void* col_ptr, void* out, int N,
                               void* stream) {
  using namespace repro;
  if (M % 16 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  dim3 grid(N / 16, (M + 16 * kGemmWarps - 1) / (16 * kGemmWarps));
  bcsc_gemm_kernel<<<grid, kGemmWarps * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, M, K, (const bf16*)blocks, (const int*)row_ids,
      (const int*)col_ptr, (float*)out, N);
  return (int)cudaGetLastError();
}

// x (8, K); bias (N,) fp32 or null; out (8, N) fp32.
extern "C" int repro_bcsc_gemv(const void* x, int K, const void* blocks,
                               const void* row_ids, const void* col_ptr,
                               const void* bias, int act, void* out, int N,
                               void* stream) {
  using namespace repro;
  if (K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  bcsc_gemv_kernel<<<N / 16, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, K, (const bf16*)blocks, (const int*)row_ids,
      (const int*)col_ptr, (const float*)bias, act, (float*)out, N);
  return (int)cudaGetLastError();
}
