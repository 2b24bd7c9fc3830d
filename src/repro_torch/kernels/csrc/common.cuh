// Shared device code of the port's Hopper kernels: the fused bias+activation
// epilogue (counterpart of kernels/epilogue.py::fused_epilogue), cp.async
// copies and the mbarriers that guard their stages, TMA maps and loads,
// ldmatrix / mma.sync fragments, wgmma descriptors and fences, and the
// column-segment walk of the BCSC GEMV.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

typedef __nv_bfloat16 bf16;

// Activation codes; kernels/epilogue.py::ACT_CODES holds the same numbers.
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

// Bias, then the activation, in fp32 (the psum precision).
__device__ __forceinline__ float epilogue(float acc, float bias, int act) {
  float v = acc + bias;
  switch (act) {
    case ACT_RELU:
      return fmaxf(v, 0.0f);
    case ACT_SILU:
      return v / (1.0f + expf(-v));
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    default:
      return v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Asynchronous global -> shared copies (cp.async). With ``valid`` false
// nothing is read and the destination is zero-filled; ``src`` must still be
// a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers in shared memory (addresses as 32-bit shared-window offsets),
// the stage guards of the cp.async rings of the sliding-window attention
// and the BCSC GEMM.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(bar))
      : "memory");
}
// One arrival on ``bar`` once all of this thread's earlier cp.async copies
// have landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar))
               : "memory");
}
// Wait for the completion of the barrier's phase of parity ``parity``. A
// phase that never completes (copies that never land) traps after some
// seconds of retries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done;
  for (unsigned n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// One arrival on ``bar`` that also expects ``bytes`` of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box of ``map`` at (column c0, row c1) into shared memory,
// completing its bytes on ``bar``. A box that reaches past the matrix
// reads zeros there and still completes its full byte count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"((unsigned)__cvta_generic_to_shared(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A TMA map of a row-major bf16 matrix (rows x cols, ``ld`` elements from
// one row to the next, a multiple of 8) read in boxes of box_rows x
// box_cols; elements outside the matrix read as zero. The driver's encoder
// is reached through the runtime, so the library needs no link to libcuda.
static inline cudaError_t tensor_map(CUtensorMap* map, const void* base,
                                     uint64_t rows, uint64_t cols,
                                     uint64_t ld, uint32_t box_rows,
                                     uint32_t box_cols,
                                     CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Byte offset of 16-byte chunk ``c`` (0..7) of row ``r`` in an x tile of
// 128-byte rows (64 bf16 columns), as TMA's 128-byte swizzle lays it out:
// chunk c sits at c ^ (r % 8), so the 8 rows an ldmatrix reads hit 32
// distinct banks.
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Byte offset of 16-byte half ``h`` of row ``r`` in a 16-column bf16 tile
// of 32-byte rows (a [k][n] weight block, or an [m][k] slice of x): the
// halves swap on every other group of four rows, so the 8 rows an ldmatrix
// reads hit 32 distinct banks.
__device__ __forceinline__ int swz32(int r, int h) {
  return r * 32 + ((h ^ ((r >> 2) & 1)) << 4);
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i: the A fragment of a 16 x 16 operand.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p))
      : "memory");
}

// Two 8x8 matrices; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"((unsigned)__cvta_generic_to_shared(p))
      : "memory");
}

// Four, transposed: each thread gets a column pair, the B fragments of a
// [k][n] block (or the A fragment of its transpose).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p))
      : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, col).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands step
// 32 bytes per k16 inside their 128-byte rows (lbo unused); MN-major ones
// have lbo = the stride between 64-element column blocks and sbo = the
// stride between groups of 8 k rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warp's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// p[0] + p[stride] + ... + p[(n - 1) * stride], added in that order, read
// from L2 (partials other SMs wrote): the loads go out eight at a time, so a
// sum of n costs about n / 8 round trips, not n.
__device__ __forceinline__ float4 sum_in_order(const float4* p, long stride,
                                               int n) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i0 = 0; i0 < n; i0 += 8) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (i0 + q < n) v[q] = __ldcg(p + (i0 + q) * stride);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (i0 + q < n) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    }
  }
  return s;
}

// Threads and rows of one segment walk: 256 threads = 16 output columns of a
// 16-wide block-column x 16 groups that split the segment's blocks; each
// walk covers 8 activation rows.
constexpr int kWalkThreads = 256;
constexpr int kWalkRows = 8;
constexpr int kWalkGroups = kWalkThreads / 16;

// Loads 16 consecutive bf16 values (32 bytes, 16-byte aligned) as floats.
template <bool kCacheGlobal>
__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  uint4 a, b;
  if (kCacheGlobal) {
    a = __ldcg(v);
    b = __ldcg(v + 1);
  } else {
    a = v[0];
    b = v[1];
  }
  const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f0 = __bfloat1622float2(h0[i]);
    float2 f1 = __bfloat1622float2(h1[i]);
    out[2 * i] = f0.x;
    out[2 * i + 1] = f0.y;
    out[8 + 2 * i] = f1.x;
    out[8 + 2 * i + 1] = f1.y;
  }
}

// One block-column of x (8 rows, leading dimension ldx) times a BCSC column
// segment [lo, hi): out[m][n] = sum_i sum_k x[m][row_ids[i]*16 + k] * blk_i[k][n].
// Each of the 16 groups walks every 16th block of the segment and the group
// partials are summed in a fixed order, so the result is deterministic.
// Threads 0..127 return element (m = tid / 16, n = tid % 16); the rest return
// 0. ``red`` is a shared buffer of kWalkGroups * kWalkRows * 16 floats.
// Must be called by all kWalkThreads threads of the block.
template <bool kCacheGlobal>
__device__ float segment_walk8(const bf16* x, long ldx, const bf16* blocks,
                               const int* row_ids, int lo, int hi,
                               float* red) {
  const int n = threadIdx.x & 15;
  const int g = threadIdx.x >> 4;
  float acc[kWalkRows];
#pragma unroll
  for (int m = 0; m < kWalkRows; ++m) acc[m] = 0.0f;
  for (int i = lo + g; i < hi; i += kWalkGroups) {
    const bf16* blk = blocks + (long)i * 256;
    float w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = __bfloat162float(blk[k * 16 + n]);
    const bf16* xr = x + (long)row_ids[i] * 16;
#pragma unroll
    for (int m = 0; m < kWalkRows; ++m) {
      float xv[16];
      load16<kCacheGlobal>(xr + m * ldx, xv);
      float a = acc[m];
#pragma unroll
      for (int k = 0; k < 16; ++k) a = fmaf(xv[k], w[k], a);
      acc[m] = a;
    }
  }
#pragma unroll
  for (int m = 0; m < kWalkRows; ++m)
    red[(g * kWalkRows + m) * 16 + n] = acc[m];
  __syncthreads();
  float r = 0.0f;
  if (threadIdx.x < kWalkRows * 16) {
    const int m = threadIdx.x >> 4;
    for (int gg = 0; gg < kWalkGroups; ++gg)
      r += red[(gg * kWalkRows + m) * 16 + n];
  }
  __syncthreads();
  return r;
}

}  // namespace repro

// The C interface returns cudaGetLastError() (0 on success) after a launch.
extern "C" const char* repro_error_string(int code);
