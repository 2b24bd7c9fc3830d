// Shared device code of the port's Hopper kernels: the fused bias+activation
// epilogue (counterpart of kernels/epilogue.py::fused_epilogue), cp.async
// copies and the mbarriers that guard their stages, TMA maps and loads,
// ldmatrix / mma.sync fragments, wgmma descriptors, fences and the
// m64n64k16 (and register-A m64n128k16) products of the two attention
// kernels, named barriers, and the warp walk of the BCSC fused MLP and
// GEMV.
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

// The same for a box of a 3-d or 4-d map at coordinates (c0, c1, c2[, c3]),
// innermost first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"((unsigned)__cvta_generic_to_shared(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"((unsigned)__cvta_generic_to_shared(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A TMA map of a tensor of ``rank`` dimensions (innermost first: sizes
// ``dims``, byte strides ``strides`` of dimensions 1..rank-1, each a
// multiple of 16) read in boxes of ``box``; elements outside the tensor read
// as zero. The driver's encoder is reached through the runtime, so the
// library needs no link to libcuda.
static inline cudaError_t tensor_map_nd(CUtensorMap* map,
                                        CUtensorMapDataType type, int rank,
                                        const void* base,
                                        const cuuint64_t* dims,
                                        const cuuint64_t* strides,
                                        const cuuint32_t* box,
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
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
      box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A TMA map of a row-major bf16 matrix (rows x cols, ``ld`` elements from
// one row to the next, a multiple of 8) read in boxes of box_rows x
// box_cols; elements outside the matrix read as zero.
static inline cudaError_t tensor_map(CUtensorMap* map, const void* base,
                                     uint64_t rows, uint64_t cols,
                                     uint64_t ld, uint32_t box_rows,
                                     uint32_t box_cols,
                                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  return tensor_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                       strides, box, swizzle);
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

// The attention kernels' tiles: blocks of 64 rows x 64 bf16 columns, each
// row 128 bytes in wgmma's (and TMA's) 128-byte swizzle.
constexpr int kSw128Block = 64 * 128;

// Byte offset of 16-byte chunk ``ch`` (8 bf16 columns) of row ``row`` in a
// tile of 64-column blocks with 128-byte swizzled rows.
__device__ __forceinline__ int swz(int row, int ch) {
  return (ch >> 3) * kSw128Block + row * 128 + (((ch & 7) ^ (row & 7)) << 4);
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 fp32) = (scale_d ? d : 0) + A (64 x 16, smem, K-major) *
// B (16 x 64, smem, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 128 from two 64-column blocks of B (lbo in the
// descriptor: the stride between them): d0 takes columns 0..63, d1 64..127,
// each in the m64n64 accumulator layout.
__device__ __forceinline__ void wgmma_rs_tb2(float (&d0)[32], float (&d1)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the special-function unit (relative error ~2^-22).
__device__ __forceinline__ float fast_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A barrier among ``threads`` threads (a multiple of 32) that use barrier
// ``id`` (1..15; 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// An arrival on it that does not wait: threads - (this warp's group) more
// must sync or arrive for the barrier to open.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

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

// The warp walk of the BCSC kernels (the fused MLP's phases and the GEMV):
// one warp streams the blocks of its column segment through a ring of its
// own in shared memory onto mma.sync, with the rows as the MMA's N.
//
// The ring of one warp for NT 8-row tiles of x: slots of one weight block
// (512 bytes) and its x slice (NT * 8 rows of 32 bytes); about 12 KB at
// the fused MLP's depths.
template <int NT>
struct WalkRing {
  static constexpr int kSlot = 512 + NT * 8 * 32;
  static constexpr int kStages = NT == 1 ? 16 : NT == 2 ? 12 : NT == 4 ? 8 : 4;
  static constexpr int kWarpBytes = kSlot * kStages;
};

// One warp's walk: the sum over the blocks of two column segments (items
// 0..n0-1: blocks lo0.. of pack 0 into acc0; items n0..n-1: blocks lo1.. of
// pack 1 into acc1) of src's block-row slice times the block, with the
// rows as the MMA's N: acc[t] holds output columns g and g + 8 (g = lane /
// 4) of rows 8t + 2 (lane % 4) and the next one. Item j goes through ring
// slot j % kStages as one cp.async group: the block, then src's slice of
// its block-row (rows [0, mp), ``ld`` elements a row). prefetch_blocks()
// may issue the first slots' blocks before src is ready, as groups of
// their own; run() then adds their slices as groups of their own, so the
// groups still complete in item order and one wait_group serves both.
// Copies are .cg: they read L2 only, so src may have been written by
// other SMs.
template <int NT, int kS = WalkRing<NT>::kStages>
struct WarpWalk {
  static constexpr int S = kS;   // ring slots (a ring of kS * kSlot bytes)
  const bf16* b0;
  const int* r0;
  int lo0, n0;
  const bf16* b1;
  const int* r1;
  int lo1, n;
  unsigned char* ring;
  int lane, cur, nxt;   // block-rows of items base + lane, a batch ahead

  __device__ WarpWalk(const bf16* b0_, const int* r0_, int lo0_, int n0_,
                      const bf16* b1_, const int* r1_, int lo1_, int n1_,
                      unsigned char* ring_)
      : b0(b0_), r0(r0_), lo0(lo0_), n0(n0_), b1(b1_), r1(r1_), lo1(lo1_),
        n(n0_ + n1_), ring(ring_), lane(threadIdx.x & 31) {
    cur = rows(0);
    nxt = rows(32);
  }
  __device__ int rows(int base) const {
    const int j = base + lane;
    if (j < n0) return __ldg(r0 + lo0 + j);
    if (j < n) return __ldg(r1 + lo1 + j - n0);
    return 0;
  }
  __device__ unsigned char* slot(int j) const {
    return ring + (j % S) * WalkRing<NT>::kSlot;
  }
  __device__ void copy_block(int j) const {   // 16 bytes a lane
    const bf16* blk = j < n0 ? b0 + (long)(lo0 + j) * 256
                             : b1 + (long)(lo1 + j - n0) * 256;
    cp_async16(slot(j) + swz32(lane >> 1, lane & 1), blk + lane * 8, true);
  }
  // src's slice of item j's block-row; all lanes, j in increasing order
  __device__ void copy_src(int j, const bf16* src, long ld, int mp) {
    if (j > 0 && (j & 31) == 0) {
      cur = nxt;
      nxt = rows(j + 32);
    }
    const int row = __shfl_sync(0xffffffffu, cur, j & 31);
#pragma unroll
    for (int e = lane; e < NT * 16; e += 32) {   // (row m, 16-byte half h)
      const int m = e >> 1, h = e & 1;
      const bool ok = m < mp;
      cp_async16(slot(j) + 512 + swz32(m, h),
                 ok ? src + m * ld + row * 16 + h * 8 : src, ok);
    }
  }
  __device__ void prefetch_blocks() const {
    for (int j = 0; j < S - 1; ++j) {
      if (j < n) copy_block(j);
      cp_async_commit();
    }
  }
  __device__ void run(const bf16* src, long ld, int mp, bool prefetched,
                      float (&acc0)[NT][4], float (&acc1)[NT][4]) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc0[t][e] = acc1[t][e] = 0.0f;
    for (int j = 0; j < S - 1; ++j) {
      if (j < n) {
        if (!prefetched) copy_block(j);
        copy_src(j, src, ld, mp);
      }
      cp_async_commit();
    }
    for (int j = 0; j < n; ++j) {
      if (j + S - 1 < n) {
        copy_block(j + S - 1);
        copy_src(j + S - 1, src, ld, mp);
      }
      cp_async_commit();
      cp_async_wait<S - 1>();   // this lane's copies of item j
      __syncwarp();             // and the warp's
      const unsigned char* sl = slot(j);
      // A = block^T: matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), a0..a3
      uint32_t a[4];
      ldmatrix_x4_trans(a, sl + swz32((lane & 7) + ((lane >> 4) << 3),
                                      (lane >> 3) & 1));
      uint32_t b[NT][2];
      if (NT == 1) {
        uint32_t r[2];
        ldmatrix_x2(r, sl + 512 + swz32(lane & 7, (lane >> 3) & 1));
        b[0][0] = r[0];
        b[0][1] = r[1];
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, sl + 512 + swz32(16 * p + (lane & 7) +
                                              ((lane >> 4) << 3),
                                          (lane >> 3) & 1));
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
      }
      if (j < n0) {
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_16816(acc0[t], a, b[t][0], b[t][1]);
      } else {
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_16816(acc1[t], a, b[t][0], b[t][1]);
      }
      __syncwarp();   // the slot is refilled by the next copies
    }
    cp_async_wait<0>();
  }
};

}  // namespace repro

// The C interface returns cudaGetLastError() (0 on success) after a launch.
extern "C" const char* repro_error_string(int code);
