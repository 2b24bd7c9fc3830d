// The backward of causal, sliding-window and chunked GQA attention: dq, dk
// and dv from q (B, S, H, D), k and v (B, S, KV, D), the forward's bf16
// output out16 (B, S, H, D), its log-sum-exp lse (B, S, H) fp32 (natural-log
// units, written by local_attention.cu) and the output's cotangent dout
// (B, S, H, D) bf16. dq (B, S, H, D), dk and dv (B, S, KV, D) come out fp32.
// q (with out16, lse and dout) may hold a slice of the rows, positions
// q_off .. q_off + Sq - 1 of the Sk keys' (the reference's sequence-sharded
// attention): dq is then the slice's rows, dk and dv the slice's share,
// and each dk/dv block walks only the slice's q tiles of its band.
//
// Replaces no TPU kernel: it is the backward half of the reference's custom
// VJP (src/repro/models/flash.py, _bwd_impl), which XLA computes there. The
// port needs its own because autograd cannot see through the forward's
// launch. Numerics are _bwd_impl's: Drow = rowsum(dout * out16) in fp32; p =
// exp(s - lse) where the mask keeps the score (s = q.k * score_mult, or
// tanh of it times softcap); dP = dout . v^T in fp32 (bf16 operands, fp32
// sums: exact products of the same values); ds = p (dP - Drow), times
// 1 - t^2 under a cap, zero where masked; p and ds rounded to bf16 for dv +=
// p^T dout, dq += ds k and dk += ds^T q, fp32 sums; dq and dk times
// 1/sqrt(D) at the end.
//
// Bound on Hopper: operations. 5 products of 2 D flops per (query, key)
// pair of the band and head: QK^T and dout V^T recomputed, dv, dq and dk
// (e.g. 4.3e10 flops at qwen2.5-3b's S 2048, 16 heads of 128, causal: 0.044
// ms at 989 TFLOP/s, against 0.05 GB of inputs and outputs, 0.015 ms at
// 3.35 TB/s).
//
// Design, the simple first version: mma.sync m16n8k16 (bf16 in, fp32
// accumulators in registers), 4 warps of 16 rows a block, 64-row tiles
// staged by 16-byte cp.async in shared memory with rows padded by 16 bytes
// (conflict-free ldmatrix), the streamed tiles in a two-stage ring.
//  1. fbwd_drow_kernel: Drow, one warp per (position, head) row.
//  2. fbwd_dq_kernel: a block per (64 positions, query head x column part,
//     batch row) walks the key tiles of its band: S = Q K^T and dP = dO V^T
//     for its rows (16 x 64 per warp), ds in registers, then dq += ds K over
//     the part's columns. Longest q tiles first.
//  3. fbwd_dkv_kernel: a block per (64 keys, query head x column part, batch
//     row) walks the q tiles of its band in halves of 32 positions: S^T = K
//     Q^T and dP^T = V dO^T (16 keys x 32 positions per warp), p and ds in
//     registers, dv += p^T dO and dk += ds^T Q. Each query head writes its
//     own fp32 share (dk_part, dv_part, (B, S, H, D)).
//  4. fbwd_reduce_kernel: dk and dv sum the R = H / KV heads' shares in head
//     order.
// No atomics: every sum is taken in a fixed order, so a call gives the same
// bits every time. Head dims above 128 run in parts of 128 columns (D <= 64
// in one of 64), each part recomputing S and dP (at D 256: 10 D flops a pair
// in the dq kernel and 12 D in the dk/dv one, against 6 D and 8 D in one
// part). What holds it back: mma.sync at a fraction of wgmma's rate, the
// scores computed twice (once per kernel), 4 warps a block with no producer
// warp, the per-element mask and exp on the CUDA cores.
#include "common.cuh"

namespace repro {

constexpr int kFbRows = 64;        // positions of a dq block, keys of a dk/dv
constexpr int kFbThreads = 128;    // 4 warps of 16 rows
constexpr float kFbLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t fb_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the special-function unit (relative error ~2^-22).
__device__ __forceinline__ float fb_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// flash's mask: key t visible from position p (rows at or past q_end are
// padding).
__device__ __forceinline__ bool fb_visible(int p, int t, int q_end,
                                           int window, int chunk) {
  return t <= p && p - t < window && p < q_end &&
         (chunk == 0 || t / chunk == p / chunk);
}

// Rows [row0, row0 + 64) of a (B, S, heads, D) bf16 tensor at one head into
// a tile of 64 rows x Dpad columns, row stride Dpad + 8; rows at or past S
// and columns at or past D zero-filled.
__device__ __forceinline__ void fb_load_tile(bf16* dst, const bf16* src,
                                             int b, int row0, int head,
                                             int heads, int S, int D,
                                             int Dpad) {
  const int chunks = Dpad / 8;
  for (int i = threadIdx.x; i < kFbRows * chunks; i += kFbThreads) {
    const int r = i / chunks, c = i % chunks;
    const int pos = row0 + r;
    const bool ok = pos < S && c * 8 < D;
    const bf16* p = ok ? src + (((long)b * S + pos) * heads + head) * D + c * 8
                       : src;
    cp_async16(dst + r * (Dpad + 8) + c * 8, p, ok);
  }
}

// 64 fp32 values of a (B, S, H) tensor at one head, zero past S.
__device__ __forceinline__ void fb_load_rows(float* dst, const float* src,
                                             int b, int row0, int head, int H,
                                             int S, int i) {
  const int pos = row0 + i;
  cp_async4(dst + i, pos < S ? src + ((long)b * S + pos) * H + head : src,
            pos < S);
}

// The A fragment (16 x 16) at rows m0.., columns k0.. of a row-major tile.
__device__ __forceinline__ void fb_frag_a(uint32_t (&a)[4], const bf16* t,
                                          int rs, int m0, int k0, int lane) {
  ldmatrix_x4(a, t + (m0 + (lane & 15)) * rs + k0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles from an [n][k] tile (rows n0..n0+15, columns
// k0..k0+15): b[0], b[1] of tile n0, b[2], b[3] of tile n0 + 8.
__device__ __forceinline__ void fb_frag_b_nk(uint32_t (&b)[4], const bf16* t,
                                             int rs, int n0, int k0,
                                             int lane) {
  ldmatrix_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * rs + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The same from a [k][n] tile (rows k0..k0+15, columns n0..n0+15).
__device__ __forceinline__ void fb_frag_b_kn(uint32_t (&b)[4], const bf16* t,
                                             int rs, int k0, int n0,
                                             int lane) {
  ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * rs +
                           n0 + (lane >> 4) * 8);
}

// The A fragment of k16 step kk from accumulator tiles c[2 kk], c[2 kk + 1].
__device__ __forceinline__ void fb_acc_to_a(uint32_t (&a)[4],
                                            const float (&c0)[4],
                                            const float (&c1)[4]) {
  a[0] = fb_pack(c0[0], c0[1]);
  a[1] = fb_pack(c0[2], c0[3]);
  a[2] = fb_pack(c1[0], c1[1]);
  a[3] = fb_pack(c1[2], c1[3]);
}

__global__ void __launch_bounds__(256) fbwd_drow_kernel(
    const bf16* __restrict__ out16, const bf16* __restrict__ dout,
    float* __restrict__ drow, long rows, int D) {
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int c = lane; c < D / 8; c += 32) {
    const uint4 o = *reinterpret_cast<const uint4*>(out16 + row * D + c * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * D + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 of = __bfloat1622float2(o2[j]);
      const float2 gf = __bfloat1622float2(g2[j]);
      s += of.x * gf.x + of.y * gf.y;
    }
  }
  s = warp_sum(s);
  if (lane == 0) drow[row] = s;
}

template <int kPW>   // output columns of a part
__global__ void __launch_bounds__(kFbThreads) fbwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ drow,
    float* __restrict__ dq, int Sq, int Sk, int q_off, int H, int KV, int D,
    int Dpad, int parts, int window, int chunk, float score_mult,
    float softcap, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rs = Dpad + 8, tile = kFbRows * rs;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + tile;
  bf16* ks = dos + tile;          // [stage][tile]
  bf16* vs = ks + 2 * tile;
  const int R = H / KV;
  // q, dout, lse, drow and dq hold the rows at positions [q_off, q_end) of
  // the Sk keys': lq0 is the tile's first row there, q0 its position
  const int q_end = q_off + Sq;
  const int n_qt = (Sq + kFbRows - 1) / kFbRows;
  const int lq0 = (n_qt - 1 - (int)blockIdx.x) * kFbRows;  // longest first
  const int q0 = q_off + lq0;
  const int h = blockIdx.y / parts, part = blockIdx.y % parts;
  const int g = h / R, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int first = max(0, q0 - window + 1);
  if (chunk > 0) first = max(first, q0 / chunk * chunk);
  const int t_first = first / kFbRows;
  const int t_last = (min(q0 + kFbRows, q_end) - 1) / kFbRows;
  fb_load_tile(qs, q, b, lq0, h, H, Sq, D, Dpad);
  fb_load_tile(dos, dout, b, lq0, h, H, Sq, D, Dpad);
  fb_load_tile(ks, k, b, t_first * kFbRows, g, KV, Sk, D, Dpad);
  fb_load_tile(vs, v, b, t_first * kFbRows, g, KV, Sk, D, Dpad);
  cp_async_commit();

  // this thread's rows r0, r1 = r0 + 8 (positions p0, p1)
  const int r0 = 16 * warp + (lane >> 2);
  const int p0 = q0 + r0, p1 = p0 + 8;
  const long row0 = ((long)b * Sq + lq0 + r0) * H + h, row1 = row0 + 8L * H;
  const float l0 = p0 < q_end ? lse[row0] * kFbLog2e : 0.0f;
  const float l1 = p1 < q_end ? lse[row1] * kFbLog2e : 0.0f;
  const float d0 = p0 < q_end ? drow[row0] : 0.0f;
  const float d1 = p1 < q_end ? drow[row1] : 0.0f;
  const bool capped = softcap > 0.0f;
  const int nk16 = D / 16, c0 = part * kPW;
  float acc[kPW / 8][4];
#pragma unroll
  for (int j = 0; j < kPW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int t = t_first; t <= t_last; ++t) {
    const int st = (t - t_first) & 1;
    if (t < t_last) {
      fb_load_tile(ks + (st ^ 1) * tile, k, b, (t + 1) * kFbRows, g, KV, Sk,
                   D, Dpad);
      fb_load_tile(vs + (st ^ 1) * tile, v, b, (t + 1) * kFbRows, g, KV, Sk,
                   D, Dpad);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * tile;
    const bf16* vt = vs + st * tile;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    for (int kk = 0; kk < nk16; ++kk) {
      uint32_t aq[4], ado[4];
      fb_frag_a(aq, qs, rs, 16 * warp, kk * 16, lane);
      fb_frag_a(ado, dos, rs, 16 * warp, kk * 16, lane);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t bb[4];
        fb_frag_b_nk(bb, kt, rs, j2 * 16, kk * 16, lane);
        mma_16816(s[2 * j2], aq, bb[0], bb[1]);
        mma_16816(s[2 * j2 + 1], aq, bb[2], bb[3]);
        fb_frag_b_nk(bb, vt, rs, j2 * 16, kk * 16, lane);
        mma_16816(dp[2 * j2], ado, bb[0], bb[1]);
        mma_16816(dp[2 * j2 + 1], ado, bb[2], bb[3]);
      }
    }
    // ds into s's registers
    const int k0 = t * kFbRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const int pos = (e & 2) ? p1 : p0;
        const float x = s[j][e] * score_mult;
        const float tt = capped ? tanhf(x) : 0.0f;
        const float sc = capped ? tt * softcap : x;
        float ds = 0.0f;
        if (fb_visible(pos, key, q_end, window, chunk)) {
          const float p = fb_ex2(sc * kFbLog2e - ((e & 2) ? l1 : l0));
          ds = p * (dp[j][e] - ((e & 2) ? d1 : d0));
          if (capped) ds *= 1.0f - tt * tt;
        }
        s[j][e] = ds;
      }
    }
    // dq += ds K over the part's columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      fb_acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jn = 0; jn < kPW / 16; ++jn) {
        uint32_t bb[4];
        fb_frag_b_kn(bb, kt, rs, kk * 16, c0 + jn * 16, lane);
        mma_16816(acc[2 * jn], a, bb[0], bb[1]);
        mma_16816(acc[2 * jn + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();   // stage st is loaded again two tiles on
  }
#pragma unroll
  for (int j = 0; j < kPW / 8; ++j) {
    const int col = c0 + 8 * j + 2 * (lane & 3);
    if (col < D) {
      if (p0 < q_end)
        *reinterpret_cast<float2*>(dq + row0 * D + col) =
            make_float2(acc[j][0] * scale, acc[j][1] * scale);
      if (p1 < q_end)
        *reinterpret_cast<float2*>(dq + row1 * D + col) =
            make_float2(acc[j][2] * scale, acc[j][3] * scale);
    }
  }
}

template <int kPW>
__global__ void __launch_bounds__(kFbThreads) fbwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ drow,
    float* __restrict__ dk_part, float* __restrict__ dv_part, int Sq, int Sk,
    int q_off, int H, int KV, int D, int Dpad, int parts, int window,
    int chunk, float score_mult, float softcap, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rs = Dpad + 8, tile = kFbRows * rs;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + tile;
  bf16* qs = vs + tile;           // [stage][tile]
  bf16* dos = qs + 2 * tile;
  float* ls = reinterpret_cast<float*>(dos + 2 * tile);   // [stage][64]
  float* drs = ls + 2 * kFbRows;
  const int R = H / KV;
  const int k0 = blockIdx.x * kFbRows;
  const int h = blockIdx.y / parts, part = blockIdx.y % parts;
  const int g = h / R, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the band's positions among q's rows [q_off, q_end): from the later of
  // the block's first key and q_off, to a key's window or chunk end; the
  // block walks only the q tiles (64 of q's rows each, from its first)
  // that hold them, and none when the band misses q's rows
  const int q_end = q_off + Sq;
  int last = min(q_end - 1, k0 + kFbRows - 1 + window - 1);
  if (chunk > 0) last = min(last, ((k0 + kFbRows - 1) / chunk + 1) * chunk - 1);
  const int first = max(k0, q_off);
  const int t_first = (first - q_off) / kFbRows;
  const int t_last = last >= first ? (last - q_off) / kFbRows : t_first - 1;
  auto load_q = [&](int t, int st) {
    fb_load_tile(qs + st * tile, q, b, t * kFbRows, h, H, Sq, D, Dpad);
    fb_load_tile(dos + st * tile, dout, b, t * kFbRows, h, H, Sq, D, Dpad);
    if (tid < kFbRows)
      fb_load_rows(ls + st * kFbRows, lse, b, t * kFbRows, h, H, Sq, tid);
    else
      fb_load_rows(drs + st * kFbRows, drow, b, t * kFbRows, h, H, Sq,
                   tid - kFbRows);
  };
  fb_load_tile(ks, k, b, k0, g, KV, Sk, D, Dpad);
  fb_load_tile(vs, v, b, k0, g, KV, Sk, D, Dpad);
  if (t_first <= t_last) load_q(t_first, 0);
  cp_async_commit();

  // this thread's keys r0, r1 = r0 + 8
  const int r0 = 16 * warp + (lane >> 2);
  const int key0 = k0 + r0, key1 = key0 + 8;
  const bool capped = softcap > 0.0f;
  const int nk16 = D / 16, c0 = part * kPW;
  float dk[kPW / 8][4], dv[kPW / 8][4];
#pragma unroll
  for (int j = 0; j < kPW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

  for (int t = t_first; t <= t_last; ++t) {
    const int st = (t - t_first) & 1;
    if (t < t_last) {
      load_q(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * tile;
    const bf16* dot = dos + st * tile;
    const float* lt = ls + st * kFbRows;
    const float* dt = drs + st * kFbRows;
    const int q0 = q_off + t * kFbRows;
    for (int half = 0; half < 2; ++half) {
      const int n0 = half * 32;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      for (int kk = 0; kk < nk16; ++kk) {
        uint32_t ak[4], av[4];
        fb_frag_a(ak, ks, rs, 16 * warp, kk * 16, lane);
        fb_frag_a(av, vs, rs, 16 * warp, kk * 16, lane);
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          uint32_t bb[4];
          fb_frag_b_nk(bb, qt, rs, n0 + j2 * 16, kk * 16, lane);
          mma_16816(s[2 * j2], ak, bb[0], bb[1]);
          mma_16816(s[2 * j2 + 1], ak, bb[2], bb[3]);
          fb_frag_b_nk(bb, dot, rs, n0 + j2 * 16, kk * 16, lane);
          mma_16816(dp[2 * j2], av, bb[0], bb[1]);
          mma_16816(dp[2 * j2 + 1], av, bb[2], bb[3]);
        }
      }
      // p into s's registers, ds into dp's (rows keys, columns positions)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const int pos = q0 + col;
          const int key = (e & 2) ? key1 : key0;
          const float x = s[j][e] * score_mult;
          const float tt = capped ? tanhf(x) : 0.0f;
          const float sc = capped ? tt * softcap : x;
          float p = 0.0f, ds = 0.0f;
          if (key < Sk && fb_visible(pos, key, q_end, window, chunk)) {
            p = fb_ex2(sc * kFbLog2e - lt[col] * kFbLog2e);
            ds = p * (dp[j][e] - dt[col]);
            if (capped) ds *= 1.0f - tt * tt;
          }
          s[j][e] = p;
          dp[j][e] = ds;
        }
      }
      // dv += p^T dO, dk += ds^T Q over the part's columns
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[4], ad[4];
        fb_acc_to_a(ap, s[2 * kk], s[2 * kk + 1]);
        fb_acc_to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int jn = 0; jn < kPW / 16; ++jn) {
          uint32_t bb[4];
          fb_frag_b_kn(bb, dot, rs, n0 + kk * 16, c0 + jn * 16, lane);
          mma_16816(dv[2 * jn], ap, bb[0], bb[1]);
          mma_16816(dv[2 * jn + 1], ap, bb[2], bb[3]);
          fb_frag_b_kn(bb, qt, rs, n0 + kk * 16, c0 + jn * 16, lane);
          mma_16816(dk[2 * jn], ad, bb[0], bb[1]);
          mma_16816(dk[2 * jn + 1], ad, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // stage st is loaded again two tiles on
  }
  const long base0 = ((long)b * Sk + key0) * H + h, base1 = base0 + 8L * H;
#pragma unroll
  for (int j = 0; j < kPW / 8; ++j) {
    const int col = c0 + 8 * j + 2 * (lane & 3);
    if (col < D) {
      if (key0 < Sk) {
        *reinterpret_cast<float2*>(dk_part + base0 * D + col) =
            make_float2(dk[j][0] * scale, dk[j][1] * scale);
        *reinterpret_cast<float2*>(dv_part + base0 * D + col) =
            make_float2(dv[j][0], dv[j][1]);
      }
      if (key1 < Sk) {
        *reinterpret_cast<float2*>(dk_part + base1 * D + col) =
            make_float2(dk[j][2] * scale, dk[j][3] * scale);
        *reinterpret_cast<float2*>(dv_part + base1 * D + col) =
            make_float2(dv[j][2], dv[j][3]);
      }
    }
  }
}

// dk[b, s, g, :] = sum over r < R, in order, of dk_part[b, s, g R + r, :];
// dv the same.
__global__ void __launch_bounds__(256) fbwd_reduce_kernel(
    const float* __restrict__ dk_part, const float* __restrict__ dv_part,
    float* __restrict__ dk, float* __restrict__ dv, long n, int R, int D) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long d = i % D, row = i / D;        // row = (b S + s) KV + g
    const long src = row * R * D + d;
    float ak = 0.0f, av = 0.0f;
    for (int r = 0; r < R; ++r) {
      ak += dk_part[src + (long)r * D];
      av += dv_part[src + (long)r * D];
    }
    dk[i] = ak;
    dv[i] = av;
  }
}

size_t fbwd_smem_bytes(int Dpad) {
  return (size_t)6 * kFbRows * (Dpad + 8) * sizeof(bf16) +
         4 * kFbRows * sizeof(float);
}

template <int kPW>
int launch_fbwd(const bf16* q, const bf16* k, const bf16* v,
                const bf16* dout, const float* lse, const float* drow,
                float* dq, float* dk_part, float* dv_part, int B, int Sq,
                int Sk, int q_off, int H, int KV, int D, int Dpad,
                int window, int chunk, float score_mult, float softcap,
                float scale, cudaStream_t st) {
  const size_t smem = fbwd_smem_bytes(Dpad);
  static const cudaError_t a1 = cudaFuncSetAttribute(
      fbwd_dq_kernel<kPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fbwd_smem_bytes(256));
  static const cudaError_t a2 = cudaFuncSetAttribute(
      fbwd_dkv_kernel<kPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fbwd_smem_bytes(256));
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  const int parts = Dpad / kPW;
  // dq: a block per 64 of q's rows; dk / dv: a block per 64 keys
  const dim3 grid_q((Sq + kFbRows - 1) / kFbRows, H * parts, B);
  const dim3 grid_k((Sk + kFbRows - 1) / kFbRows, H * parts, B);
  fbwd_dq_kernel<kPW><<<grid_q, kFbThreads, smem, st>>>(
      q, k, v, dout, lse, drow, dq, Sq, Sk, q_off, H, KV, D, Dpad, parts,
      window, chunk, score_mult, softcap, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fbwd_dkv_kernel<kPW><<<grid_k, kFbThreads, smem, st>>>(
      q, k, v, dout, lse, drow, dk_part, dv_part, Sq, Sk, q_off, H, KV, D,
      Dpad, parts, window, chunk, score_mult, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro

// q (B, Sq, H, D): the rows at positions q_offset .. q_offset + Sq - 1 of
// k/v (B, Sk, KV, D) (Sq = Sk at offset 0: every row); out16 and dout (B,
// Sq, H, D) bf16; lse (B, Sq, H) fp32; out dq (B, Sq, H, D), dk/dv (B, Sk,
// KV, D) fp32 (at an offset: the slice's share of them); scratch drow (B,
// Sq, H), dk_part and dv_part (B, Sk, H, D) fp32. H / KV at most 64, D a
// multiple of 16 up to 256, 1 <= window <= Sk (Sk: causal), chunk 0 or the
// chunk width. score_mult and softcap as for the forward
// (repro_sliding_window_attention_q); scale 1/sqrt(D). At a q_offset that
// is a multiple of 64 each dq row has the bits of the launch over all Sk
// rows (the offset is a runtime argument: at 0 each index is the one the
// kernels computed before it).
extern "C" int repro_flash_backward(
    const void* q, const void* k, const void* v, const void* out16,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* drow, void* dk_part, void* dv_part, int B, int Sq, int Sk,
    int q_offset, int H, int KV, int D, int window, int chunk,
    float score_mult, float softcap, float scale, void* stream) {
  using namespace repro;
  if (KV < 1 || H % KV || H / KV > 64 || D % 16 || D > 256 || D < 16 ||
      window < 1 || chunk < 0 || Sq < 1 || Sk < 1 || B < 1 ||
      q_offset < 0 || q_offset > Sk - Sq)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long rows = (long)B * Sq * H;
  fbwd_drow_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const bf16*)out16, (const bf16*)dout, (float*)drow, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int Dpad = D <= 64 ? 64 : (D + 127) / 128 * 128;
  const int code =
      D <= 64
          ? launch_fbwd<64>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                            (const bf16*)dout, (const float*)lse,
                            (const float*)drow, (float*)dq, (float*)dk_part,
                            (float*)dv_part, B, Sq, Sk, q_offset, H, KV, D,
                            Dpad, window, chunk, score_mult, softcap, scale,
                            st)
          : launch_fbwd<128>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                             (const bf16*)dout, (const float*)lse,
                             (const float*)drow, (float*)dq, (float*)dk_part,
                             (float*)dv_part, B, Sq, Sk, q_offset, H, KV, D,
                             Dpad, window, chunk, score_mult, softcap, scale,
                             st);
  if (code) return code;
  const long n = (long)B * Sk * KV * D;
  const long blocks = (n + 255) / 256;
  fbwd_reduce_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
                       st>>>((const float*)dk_part, (const float*)dv_part,
                             (float*)dk, (float*)dv, n, H / KV, D);
  return (int)cudaGetLastError();
}
