// Causal sliding-window GQA attention (prefill): q (B, S, H, D), k and v
// (B, S, KV, D), all bf16; out (B, S, H, D) fp32. A query at position p
// attends to the keys at positions t with 0 <= p - t < window; a window of
// S is plain causal attention.
//
// Replaces: src/repro/kernels/local_attention.py::sliding_window_attention_raw
// (Pallas body _swa_kernel), and on the port's prefill path the XLA flash
// forward of src/repro/models/flash.py (_fwd_impl), which computes the same
// function.
//
// Bound on Hopper: operations at the shapes the model gives it. A band of
// ~S * window (query, key) pairs costs 4 * D flops per pair and head (QK^T and
// PV), e.g. 2.1e11 flops for gemma2-2b's local layers at S 8192 (0.21 ms at
// 989 TFLOP/s) against 0.13 GB of q, k, v and out (0.04 ms at 3.35 TB/s).
//
// Design: one thread block per (q tile, KV head, batch row). Its 64 rows are
// (position, query head) pairs, 64 / R positions x the R query heads that
// share the KV head, so every K and V tile loaded serves all R heads. The
// block walks only the 64-key tiles of its band, [q0 - window + 1, q_last],
// in ascending order; keys at or past S, and tiles outside the band, are
// never read. Per tile: the K and V tiles are staged in shared memory, the
// 64 x 64 scores come from bf16 WMMA (mma.sync) with fp32 accumulation,
// one warp per 8 rows applies scale, softcap and mask and updates the fp32
// online softmax (m, l), p is rounded to bf16 as the reference's flash does
// before its PV product, and the 64 x D fp32 accumulator, kept in shared
// memory, is rescaled and then advanced by P V through WMMA. The masking
// convention is the reference's: NEG_INF = -2e38, p = exp(s - m) only where
// s > NEG_INF / 2, and the output is acc / max(l, 1e-30).
//
// What holds it back: the loads are synchronous (no cp.async/TMA pipeline,
// so each tile's global-memory latency is exposed), the accumulator makes a
// round trip through shared memory on every tile for the rescale, and at
// D 256 the ~191 KB of shared memory allows one block per SM. wgmma with
// register-resident accumulators and a TMA ring are later changes.
#include <mma.h>

#include "common.cuh"

namespace repro {

constexpr int kSwaRows = 64;   // (position, head) rows per block
constexpr int kSwaKeys = 64;   // keys per tile
constexpr int kSwaWarps = 8;
constexpr int kSwaThreads = kSwaWarps * 32;
constexpr int kSwaSPad = kSwaKeys + 4;   // fp32 score row stride
constexpr int kSwaPPad = kSwaKeys + 8;   // bf16 probability row stride
constexpr float kSwaNegInf = -2.0e38f;

// Shared-memory bytes for head dimension D (every region a multiple of 32
// bytes, as WMMA's 256-bit aligned pointers need).
__host__ __device__ inline size_t swa_smem_bytes(int D) {
  const size_t dp = D + 8, dq = D + 4;
  return 2 * (size_t)kSwaRows * dp            // q tile
         + 2 * 2 * (size_t)kSwaKeys * dp      // k and v tiles
         + 4 * (size_t)kSwaRows * kSwaSPad    // scores
         + 2 * (size_t)kSwaRows * kSwaPPad    // probabilities
         + 4 * (size_t)kSwaRows * dq          // accumulator
         + 4 * 3 * (size_t)kSwaRows;          // m, l, corr
}

// rows x D bf16 from global rows of stride ld (elements) into shared rows of
// stride D + 8; rows at or past ``valid`` are zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long ld,
                                          int rows, int valid, int D,
                                          int rows_per_src_row, int heads) {
  const int chunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i % chunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    const int src_row = r / rows_per_src_row;
    if (src_row < valid) {
      const int h = r % rows_per_src_row;
      val = *reinterpret_cast<const uint4*>(src + src_row * ld +
                                            (long)h * heads + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + (long)r * (D + 8) + c * 8) = val;
  }
}

__global__ void __launch_bounds__(kSwaThreads) swa_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, float* __restrict__ out, int S, int H, int KV,
    int D, int window, float score_mult, float softcap) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = D + 8, Dq = D + 4;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kSwaRows * Dp;
  bf16* vs = ks + kSwaKeys * Dp;
  float* ss = reinterpret_cast<float*>(vs + kSwaKeys * Dp);
  bf16* ps = reinterpret_cast<bf16*>(ss + kSwaRows * kSwaSPad);
  float* os = reinterpret_cast<float*>(ps + kSwaRows * kSwaPPad);
  float* m_s = os + kSwaRows * Dq;
  float* l_s = m_s + kSwaRows;
  float* c_s = l_s + kSwaRows;

  const int R = H / KV;
  const int per_tile = kSwaRows / R;   // positions per block
  const int q0 = blockIdx.x * per_tile;
  const int g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // q rows: row = (position - q0) * R + head-in-group; a position's R heads
  // are contiguous in q (heads g*R .. g*R + R - 1)
  load_rows(qs, q + ((long)b * S + q0) * H * D + (long)g * R * D, (long)H * D,
            kSwaRows, S - q0, D, R, D);
  for (int i = threadIdx.x; i < kSwaRows * Dq; i += blockDim.x) os[i] = 0.0f;
  if (threadIdx.x < kSwaRows) {
    m_s[threadIdx.x] = kSwaNegInf;
    l_s[threadIdx.x] = 0.0f;
  }

  const int q_last = min(q0 + per_tile, S) - 1;
  const int k_lo = max(0, q0 - window + 1);
  const int t0 = k_lo / kSwaKeys, t1 = q_last / kSwaKeys;
  const int n_col_tiles = D / 16;

  for (int t = t0; t <= t1; ++t) {
    const int key0 = t * kSwaKeys;
    __syncthreads();  // previous tile's readers of ks/vs/ps are done
    const long kv0 = ((long)b * S + key0) * KV * D + (long)g * D;
    load_rows(ks, k + kv0, (long)KV * D, kSwaKeys, S - key0, D, 1, 0);
    load_rows(vs, v + kv0, (long)KV * D, kSwaKeys, S - key0, D, 1, 0);
    __syncthreads();

    // scores: 4 x 4 tiles of 16 x 16, two per warp
    for (int tile = warp; tile < 16; tile += kSwaWarps) {
      const int tr = tile >> 2, tc = tile & 3;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < n_col_tiles; ++kk) {
        wmma::load_matrix_sync(a, qs + tr * 16 * Dp + kk * 16, Dp);
        wmma::load_matrix_sync(bk, ks + tc * 16 * Dp + kk * 16, Dp);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(ss + tr * 16 * kSwaSPad + tc * 16, acc,
                              kSwaSPad, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one warp per 8 rows, two keys per lane
    for (int row = warp; row < kSwaRows; row += kSwaWarps) {
      const int qpos = q0 + row / R;
      float sv[2];
      float mx = kSwaNegInf;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const int kpos = key0 + c;
        float sc = ss[row * kSwaSPad + c] * score_mult;
        if (softcap > 0.0f) sc = tanhf(sc) * softcap;
        const bool ok = kpos <= qpos && qpos - kpos < window && kpos < S &&
                        qpos < S;
        sv[h] = ok ? sc : kSwaNegInf;
        mx = fmaxf(mx, sv[h]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = sv[h] > kSwaNegInf / 2 ? expf(sv[h] - m_new) : 0.0f;
        sum += p;
        ps[row * kSwaPPad + lane + 32 * h] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[row] = corr;
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < kSwaRows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      os[r * Dq + d] *= c_s[r];
    }
    __syncthreads();

    // acc += P V: 4 x (D / 16) tiles of 16 x 16
    for (int tile = warp; tile < 4 * n_col_tiles; tile += kSwaWarps) {
      const int tr = tile / n_col_tiles, tc = tile % n_col_tiles;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      float* o_tile = os + tr * 16 * Dq + tc * 16;
      wmma::load_matrix_sync(acc, o_tile, Dq, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kSwaKeys / 16; ++kk) {
        wmma::load_matrix_sync(a, ps + tr * 16 * kSwaPPad + kk * 16,
                               kSwaPPad);
        wmma::load_matrix_sync(bv, vs + kk * 16 * Dp + tc * 16, Dp);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, Dq, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kSwaRows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int pos = q0 + r / R;
    if (pos < S)
      out[(((long)b * S + pos) * H + (long)g * R + r % R) * D + d] =
          os[r * Dq + d] / fmaxf(l_s[r], 1e-30f);
  }
}

}  // namespace repro

// q (B, S, H, D), k/v (B, S, KV, D) bf16; out (B, S, H, D) fp32. H / KV
// must divide 64, D a multiple of 16 up to 256, 1 <= window <= S. Scores
// are q.k * score_mult, then tanh(.) * softcap when softcap > 0: the caller
// passes 1/sqrt(D), or with a softcap the fp32 (1/sqrt(D)) / softcap, the
// one multiply XLA makes of the reference's q.k * scale / softcap.
extern "C" int repro_sliding_window_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int KV, int D, int window, float score_mult, float softcap,
    void* stream) {
  using namespace repro;
  if (KV < 1 || H % KV || kSwaRows % (H / KV) || D % 16 || D > 256 ||
      window < 1 || S < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = swa_smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        swa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int per_tile = kSwaRows / (H / KV);
  dim3 grid((S + per_tile - 1) / per_tile, KV, B);
  swa_kernel<<<grid, kSwaThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (float*)out, S, H, KV,
      D, window, score_mult, softcap);
  return (int)cudaGetLastError();
}
