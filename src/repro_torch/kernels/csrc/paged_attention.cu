// Paged decode attention: one query token per row attends to its history
// read through a block table.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_raw
// (Pallas body _paged_kernel).
//
// Bound on Hopper: bytes. Each decode step reads every resident K and V page
// once and does ~4·R·D flops per cached token (R query heads share one KV
// head), far below the card's ~295 flop/byte balance point.
//
// Design: one thread block per (row, KV head) holds the R query heads of that
// KV group (R x D fp32 in shared memory) and walks the row's pages in order,
// only j < ceil(len / ps), and clamps each table entry into [0, P - 1] as the
// reference does (an entry of -1 inside the occupancy reads page 0).
// Per page: each warp scores a strided subset of the page's tokens for all R
// heads at once (one K read serves R heads), the page's fp32 online-softmax
// update (m, l, corr) runs one warp per head, and each thread then owns head
// dimensions d and accumulates p·V for all R heads (one V read serves R
// heads). Tokens at or past the row's length are neither scored nor read.
// int8 pools are dequantised in the loop with the page's per-KV-head scale
// (value * scale / 127). The masking convention is the reference's:
// NEG_INF = -2e38, p = exp(s - m) only where s > NEG_INF / 2, and the output
// is acc / max(l, 1e-30).
//
// What holds it back: the grid is rows x KV heads (16 blocks at 8 rows of
// qwen2.5-3b), so most of the 132 SMs idle during a decode step; splitting a
// row's pages over several blocks (flash-decoding) is a later change.
#include "common.cuh"

namespace repro {

constexpr int kPaThreads = 128;
constexpr int kPaMaxR = 16;
constexpr float kNegInf = -2.0e38f;

template <bool kQuantized>
__device__ __forceinline__ float load_kv(const void* pool, long idx,
                                         float scale) {
  if (kQuantized)
    return (float)reinterpret_cast<const int8_t*>(pool)[idx] * scale;
  return __bfloat162float(reinterpret_cast<const bf16*>(pool)[idx]);
}

template <bool kQuantized>
__global__ void __launch_bounds__(kPaThreads) paged_attention_kernel(
    const bf16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ lengths, float* __restrict__ out, int KV, int R,
    int D, int P, int ps, int MP, float sm_scale, float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;              // R * D
  float* acc = qs + R * D;       // R * D
  float* s = acc + R * D;        // R * ps (scores, then probabilities)
  float* m_s = s + R * ps;       // R
  float* l_s = m_s + R;          // R
  float* corr = l_s + R;         // R

  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long head0 = ((long)b * KV + g) * R * D;

  for (int i = tid; i < R * D; i += blockDim.x) {
    qs[i] = __bfloat162float(q[head0 + i]);
    acc[i] = 0.0f;
  }
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  const int len = lengths[b];
  int n_pages = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_pages > MP) n_pages = MP;

  for (int j = 0; j < n_pages; ++j) {
    const int page = min(max(block_table[(long)b * MP + j], 0), P - 1);
    const int valid = min(ps, len - j * ps);
    const float ksc = kQuantized ? k_scale[page * KV + g] * (1.0f / 127.0f)
                                 : 1.0f;
    const float vsc = kQuantized ? v_scale[page * KV + g] * (1.0f / 127.0f)
                                 : 1.0f;
    const long page0 = (long)page * ps;

    // scores: warp w takes tokens w, w + nwarps, ...
    for (int t = warp; t < ps; t += nwarps) {
      float part[kPaMaxR];
#pragma unroll
      for (int r = 0; r < kPaMaxR; ++r) part[r] = 0.0f;
      if (t < valid) {
        const long base = ((page0 + t) * KV + g) * D;
        for (int d = lane; d < D; d += 32) {
          const float kf = load_kv<kQuantized>(k_pool, base + d, ksc);
#pragma unroll
          for (int r = 0; r < kPaMaxR; ++r)
            if (r < R) part[r] = fmaf(qs[r * D + d], kf, part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kPaMaxR; ++r) {
        if (r < R) {
          const float v = warp_sum(part[r]);
          if (lane == 0) {
            float sc = v * sm_scale;
            if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
            s[r * ps + t] = t < valid ? sc : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // online softmax over this page, one warp per head
    for (int r = warp; r < R; r += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, s[r * ps + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < ps; t += 32) {
        const float sv = s[r * ps + t];
        const float p = sv > kNegInf / 2 ? expf(sv - m_new) : 0.0f;
        s[r * ps + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V, thread per head dimension, all heads at once
    for (int d = tid; d < D; d += blockDim.x) {
      float a[kPaMaxR];
#pragma unroll
      for (int r = 0; r < kPaMaxR; ++r)
        a[r] = r < R ? acc[r * D + d] * corr[r] : 0.0f;
      for (int t = 0; t < valid; ++t) {
        const float vf =
            load_kv<kQuantized>(v_pool, ((page0 + t) * KV + g) * D + d, vsc);
#pragma unroll
        for (int r = 0; r < kPaMaxR; ++r)
          if (r < R) a[r] = fmaf(s[r * ps + t], vf, a[r]);
      }
#pragma unroll
      for (int r = 0; r < kPaMaxR; ++r)
        if (r < R) acc[r * D + d] = a[r];
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += blockDim.x)
    out[head0 + i] = acc[i] / fmaxf(l_s[i / D], 1e-30f);
}

}  // namespace repro

extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* out, int B, int KV, int R, int D, int P,
    int ps, int MP, float sm_scale, float softcap, void* stream) {
  using namespace repro;
  if (R > kPaMaxR) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * (size_t)R * D + (size_t)R * ps + 3 * R);
  const bool quantized = k_scale != nullptr;
  const void* fn = quantized ? (const void*)paged_attention_kernel<true>
                             : (const void*)paged_attention_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, KV);
  cudaStream_t st = (cudaStream_t)stream;
  if (quantized)
    paged_attention_kernel<true><<<grid, kPaThreads, smem, st>>>(
        (const bf16*)q, k_pool, v_pool, (const float*)k_scale,
        (const float*)v_scale, (const int*)block_table, (const int*)lengths,
        (float*)out, KV, R, D, P, ps, MP, sm_scale, softcap);
  else
    paged_attention_kernel<false><<<grid, kPaThreads, smem, st>>>(
        (const bf16*)q, k_pool, v_pool, nullptr, nullptr,
        (const int*)block_table, (const int*)lengths, (float*)out, KV, R, D,
        P, ps, MP, sm_scale, softcap);
  return (int)cudaGetLastError();
}
