// Shared device code of the port's Hopper kernels: the fused bias+activation
// epilogue (counterpart of kernels/epilogue.py::fused_epilogue) and the
// column-segment walk that the BCSC GEMV and the fused MLP share.
#pragma once

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
