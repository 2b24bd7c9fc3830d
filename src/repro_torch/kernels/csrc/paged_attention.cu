// Paged decode attention: one query token per row attends to its history
// read through a block table.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_raw
// (Pallas body _paged_kernel).
//
// Bound on Hopper: bytes. Each decode step reads every resident K and V page
// once and does ~4·R·D flops per cached token (R query heads share one KV
// head), far below the card's ~295 flop/byte balance point. At the served
// shapes the bytes are 3-50 MB, 1 to 15 us at 3.35 TB/s, so the kernel has
// to spread a row's pages over many SMs and keep pages in flight on each.
//
// Design (flash-decoding): the grid is (row, KV head, split). Split s takes
// the run of ``pages_per_split`` (at most 64) consecutive table entries
// starting at s * pages_per_split; a split whose run starts at or past the
// row's occupied pages, min(ceil(len / ps), MP), returns before reading
// anything, so the pages read over a call are exactly the reference's work
// steps. The run's table entries are read once, clamped into [0, P - 1] as
// the reference does (an entry of -1 inside the occupancy reads page 0),
// into shared memory, so no copy waits on a table read. A split walks its
// tokens in tiles of 64: the tile's K and V rows for the block's KV head
// (and, for int8 pools, each token's page scale) are staged in shared memory
// by 16-byte cp.async, two stages deep, so tile i + 1 is in flight while
// tile i is computed; rows are padded by 16 bytes so that lanes reading one
// column of eight consecutive tokens hit eight different bank groups.
// Tokens at or past the row's length are zero-filled, never read. Scores:
// four lanes per token, each dotting a quarter of the head dimension for
// all R heads against q (fp32, broadcast from shared memory), then two
// shuffles; 256 threads, so that eight warps hide each other's latencies.
// Loops over heads are unrolled to R rounded up to 2, 4, 8 or 16, one
// instantiation each, so a thread issues no work for heads that do not
// exist. The fp32 online softmax (max, sum, correction) is reduced once per
// (head, tile), one warp per head. P·V: each thread owns two head
// dimensions of a fixed set of heads in registers for all of its split's
// tiles. int8 pools are dequantised as (float)v * (scale * (1/127)),
// element by element. Each split writes its unnormalised (m, l, acc) to an
// fp32 workspace; a second small kernel, one block per (row, KV head, query
// head), combines the splits of a row in a fixed order (no atomics, so the
// result is the same from run to run), reading only the splits below the
// row's occupancy, recomputed from ``lengths`` on the device: a split that
// returned early wrote nothing, and a row of length 0 gives zeros. The
// masking convention is the reference's: NEG_INF = -2e38, p = exp(s - m)
// only where s > NEG_INF / 2, and the output is acc / max(l, 1e-30).
//
// What still holds it back: at the served shapes a call is ~10 us of fixed
// cost (two launches, the q and page-list reads, the combine's dependent
// reads) before its tiles; then the copies: one block per SM at D 256 (a
// 139 KB ring) keeps ~64 KB in flight, short of what HBM needs, and the
// scores and P·V run on the CUDA cores. The split count is chosen from
// shapes alone (no host sync on ``lengths``), so short rows leave splits
// empty.
#include "common.cuh"

namespace repro {

constexpr int kPaThreads = 256;
constexpr int kPaMaxR = 16;
constexpr int kPaTile = 64;    // tokens per staged tile
constexpr int kPaStages = 2;   // tiles in flight
constexpr int kPaMaxRun = 64;  // most pages one split may take
constexpr float kNegInf = -2.0e38f;

// The split kernel's arguments (see repro_paged_attention).
struct PaArgs {
  const bf16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_table;
  const int* lengths;
  float* ws_acc;
  float* ws_m;
  float* ws_l;
  int KV, R, P, ps, MP, pages_per_split;
  float sm_scale, softcap;
};

// Occupied pages of a row: min(ceil(len / ps), MP); 0 for len <= 0.
__device__ __forceinline__ int occupied_pages(int len, int ps, int MP) {
  return len > 0 ? min((len - 1) / ps + 1, MP) : 0;
}

// Shared-memory bytes of the split kernel for head dimension D.
__host__ __device__ inline size_t pa_smem_bytes(int D, int eb, int R) {
  const size_t row = (size_t)D * eb + 16;
  return 2 * kPaStages * kPaTile * row                       // K, V stages
         + 4 * ((size_t)R * D + (size_t)R * kPaTile          // q, scores
                + 2 * kPaStages * kPaTile + 3 * kPaMaxR      // scales, m l c
                + kPaMaxRun);                                // the run's pages
}

// 16 bytes of a staged row as fp32: 8 bf16, or 16 int8 times ``mul``.
template <bool kQ>
__device__ __forceinline__ void chunk_to_float(const unsigned char* p,
                                               float mul, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if (kQ) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * i + 0] = (float)((int)(w[i] << 24) >> 24) * mul;
      out[4 * i + 1] = (float)((int)(w[i] << 16) >> 24) * mul;
      out[4 * i + 2] = (float)((int)(w[i] << 8) >> 24) * mul;
      out[4 * i + 3] = (float)((int)w[i] >> 24) * mul;
    }
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// kR: the most query heads per KV head this instantiation takes (R <= kR);
// loops over heads run to kR, so R is rounded up to 2, 4, 8 or 16.
template <int kD, int kR, bool kQ>
__global__ void __launch_bounds__(kPaThreads) paged_attention_split_kernel(
    const PaArgs a) {
  const int KV = a.KV, R = a.R, P = a.P, ps = a.ps;
  const float sm_scale = a.sm_scale, softcap = a.softcap;
  constexpr int kEb = kQ ? 1 : 2;              // bytes per element
  constexpr int kE = 16 / kEb;                 // elements per 16-byte chunk
  constexpr int kChunks = kD / kE;             // chunks per token row
  constexpr int kRow = kD * kEb + 16;          // padded row stride, bytes
  constexpr int kLanes = kPaThreads / kPaTile;  // scoring lanes per token
  constexpr int kPart = (kChunks + kLanes - 1) / kLanes;  // chunks per lane
  constexpr int kGroups = kD / 2;              // P·V column pairs
  constexpr int kHeadSets = kPaThreads / kGroups;
  constexpr int kMaxHeads = (kR + kHeadSets - 1) / kHeadSets;
  static_assert(kChunks >= 1 && kGroups <= kPaThreads, "head dimension");
  static_assert(kPaTile % 32 == 0 && kLanes <= 32, "tile");

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;                       // [stage][tile][kRow]
  unsigned char* vs = ks + kPaStages * kPaTile * kRow;
  float* qs = reinterpret_cast<float*>(vs + kPaStages * kPaTile * kRow);
  float* sp = qs + R * kD;                  // [R][tile] scores, then p
  float* ksc = sp + R * kPaTile;            // [stage][tile] token page scales
  float* vsc = ksc + kPaStages * kPaTile;
  float* m_s = vsc + kPaStages * kPaTile;
  float* l_s = m_s + kPaMaxR;
  float* c_s = l_s + kPaMaxR;
  int* pg_s = reinterpret_cast<int*>(c_s + kPaMaxR);   // the run's pages

  const int b = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = a.lengths[b];
  const int n_pages = occupied_pages(len, ps, a.MP);
  const int j0 = split * a.pages_per_split;
  if (j0 >= n_pages) return;   // nothing of this row here: no reads, no write
  const int j1 = min(j0 + a.pages_per_split, n_pages);
  const int t_lo = j0 * ps, t_hi = min(j1 * ps, len);
  const int n_tiles = (t_hi - t_lo + kPaTile - 1) / kPaTile;

  // the run's table entries, clamped, read once: each tile's copies then
  // depend on no global read
  if (tid < j1 - j0)
    pg_s[tid] = min(max(a.block_table[(long)b * a.MP + j0 + tid], 0), P - 1);
  __syncthreads();

  // stage the K and V rows (and int8 scales) of tile ``tile`` into ``st``
  auto load_tile = [&](int tile, int st) {
    const int base = t_lo + tile * kPaTile;
    unsigned char* kd = ks + st * kPaTile * kRow;
    unsigned char* vd = vs + st * kPaTile * kRow;
#pragma unroll
    for (int it = 0; it < (kPaTile * kChunks + kPaThreads - 1) / kPaThreads;
         ++it) {
      const int i = tid + it * kPaThreads;
      const int t = i / kChunks, c = i % kChunks;
      if (t >= kPaTile) break;
      const int pos = base + t;
      const bool ok = pos < t_hi;
      int page = 0;
      long off = 0;
      if (ok) {
        page = pg_s[pos / ps - j0];
        off = (((long)page * ps + pos % ps) * KV + g) * (kD * kEb) + c * 16;
      }
      cp_async16(kd + t * kRow + c * 16,
                 reinterpret_cast<const unsigned char*>(a.k_pool) + off, ok);
      cp_async16(vd + t * kRow + c * 16,
                 reinterpret_cast<const unsigned char*>(a.v_pool) + off, ok);
      if (kQ && c == 0) {
        cp_async4(ksc + st * kPaTile + t, a.k_scale + (long)page * KV + g, ok);
        cp_async4(vsc + st * kPaTile + t, a.v_scale + (long)page * KV + g, ok);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kPaStages - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    cp_async_commit();
  }
  const bf16* qb = a.q + ((long)b * KV + g) * R * kD;
  for (int i = tid; i < R * kD; i += kPaThreads)
    qs[i] = __bfloat162float(qb[i]);
  if (tid < kPaMaxR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }

  const int cg = tid % kGroups, hs = tid / kGroups;   // P·V ownership
  float acc[kMaxHeads][2];
#pragma unroll
  for (int i = 0; i < kMaxHeads; ++i) acc[i][0] = acc[i][1] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kPaStages;
    if (tile + kPaStages - 1 < n_tiles)
      load_tile(tile + kPaStages - 1, (tile + kPaStages - 1) % kPaStages);
    cp_async_commit();
    cp_async_wait<kPaStages - 1>();
    __syncthreads();
    const int n_valid = min(kPaTile, t_hi - (t_lo + tile * kPaTile));

    // scores: token t by kLanes lanes of one warp, each dotting a part of
    // the row; a quarter-warp reads consecutive tokens' rows
    {
      constexpr int kTokWarp = 32 / kLanes;      // tokens per warp
      const int t = warp * kTokWarp + lane % kTokWarp, h = lane / kTokWarp;
      const unsigned char* krow = ks + (st * kPaTile + t) * kRow;
      const float kmul = kQ ? ksc[st * kPaTile + t] * (1.0f / 127.0f) : 1.0f;
      float part[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) part[r] = 0.0f;
#pragma unroll 2
      for (int cc = 0; cc < kPart; ++cc) {
        const int c = h * kPart + cc;
        if (c < kChunks) {
          float kf[kE];
          chunk_to_float<kQ>(krow + c * 16, kmul, kf);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            if (r < R) {
              const float4* qr =
                  reinterpret_cast<const float4*>(qs + r * kD + c * kE);
              float dot = part[r];
#pragma unroll
              for (int e = 0; e < kE / 4; ++e) {
                const float4 qv = qr[e];
                dot = fmaf(qv.x, kf[4 * e], dot);
                dot = fmaf(qv.y, kf[4 * e + 1], dot);
                dot = fmaf(qv.z, kf[4 * e + 2], dot);
                dot = fmaf(qv.w, kf[4 * e + 3], dot);
              }
              part[r] = dot;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < R) {
          float v = part[r];
#pragma unroll
          for (int o = kTokWarp; o < 32; o <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (h == 0) {
            float sc = v * sm_scale;
            if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
            sp[r * kPaTile + t] = t < n_valid ? sc : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per head
    for (int r = warp; r < R; r += kPaThreads / 32) {
      constexpr int kPer = kPaTile / 32;         // scores per lane
      float sv[kPer];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        sv[j] = sp[r * kPaTile + lane + 32 * j];
        mx = fmaxf(mx, sv[j]);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = sv[j] > kNegInf / 2 ? expf(sv[j] - m_new) : 0.0f;
        sp[r * kPaTile + lane + 32 * j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        c_s[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p · V; rows past n_valid are zero with p = 0
    {
#pragma unroll
      for (int i = 0; i < kMaxHeads; ++i) {
        const int r = hs + i * kHeadSets;
        if (r < R) {
          const float c = c_s[r];
          acc[i][0] *= c;
          acc[i][1] *= c;
        }
      }
      const unsigned char* vcol = vs + st * kPaTile * kRow + cg * 2 * kEb;
      const float* vmul = vsc + st * kPaTile;
      const int n4 = (n_valid + 3) & ~3;
      for (int t = 0; t < n4; t += 4) {
        float v[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned char* p = vcol + (t + u) * kRow;
          if (kQ) {
            const char2 c2 = *reinterpret_cast<const char2*>(p);
            const float mul = vmul[t + u] * (1.0f / 127.0f);
            v[u][0] = (float)c2.x * mul;
            v[u][1] = (float)c2.y * mul;
          } else {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p));
            v[u][0] = f.x;
            v[u][1] = f.y;
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxHeads; ++i) {
          const int r = hs + i * kHeadSets;
          if (r < R) {
            const float4 p =
                *reinterpret_cast<const float4*>(sp + r * kPaTile + t);
            float a0 = acc[i][0], a1 = acc[i][1];
            a0 = fmaf(p.x, v[0][0], a0);
            a1 = fmaf(p.x, v[0][1], a1);
            a0 = fmaf(p.y, v[1][0], a0);
            a1 = fmaf(p.y, v[1][1], a1);
            a0 = fmaf(p.z, v[2][0], a0);
            a1 = fmaf(p.z, v[2][1], a1);
            a0 = fmaf(p.w, v[3][0], a0);
            a1 = fmaf(p.w, v[3][1], a1);
            acc[i][0] = a0;
            acc[i][1] = a1;
          }
        }
      }
    }
    __syncthreads();   // the stage is refilled two tiles on
  }

  const long slot = ((long)b * KV + g) * gridDim.z + split;
  if (tid < R) {
    a.ws_m[slot * R + tid] = m_s[tid];
    a.ws_l[slot * R + tid] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < kMaxHeads; ++i) {
    const int r = hs + i * kHeadSets;
    if (r < R)
      *reinterpret_cast<float2*>(a.ws_acc + (slot * R + r) * kD + 2 * cg) =
          make_float2(acc[i][0], acc[i][1]);
  }
}

// out[b, g, r, d] from the splits of (b, g) below the row's occupancy, in
// split order: m = max m_s, l = sum l_s e^(m_s - m), out = sum acc_s
// e^(m_s - m) / max(l, 1e-30). A split holding no valid token (m_s =
// NEG_INF, l_s = 0) weighs 0. One block per (b, g, r), a thread per d.
__global__ void __launch_bounds__(256) paged_attention_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_m,
    const float* __restrict__ ws_l, const int* __restrict__ lengths,
    float* __restrict__ out, int KV, int R, int D, int ps, int MP,
    int pages_per_split, int n_split) {
  const int bg = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int n_pages = occupied_pages(lengths[bg / KV], ps, MP);
  const int n_used = (n_pages + pages_per_split - 1) / pages_per_split;
  const long row0 = (long)bg * n_split * R + r;   // (b, g, split 0, r)
  float m = kNegInf;
#pragma unroll 4
  for (int s = 0; s < n_used; ++s) m = fmaxf(m, ws_m[row0 + (long)s * R]);
  float l = 0.0f, a = 0.0f;
#pragma unroll 4
  for (int s = 0; s < n_used; ++s) {
    const long row = row0 + (long)s * R;
    const float ms = ws_m[row];
    const float w = ms > kNegInf / 2 ? expf(ms - m) : 0.0f;
    l = fmaf(ws_l[row], w, l);
    a = fmaf(ws_acc[row * D + d], w, a);
  }
  out[((long)bg * R + r) * D + d] = a / fmaxf(l, 1e-30f);
}

template <int kD, int kR, bool kQ>
int launch_split(dim3 grid, cudaStream_t st, const PaArgs& a) {
  auto fn = paged_attention_split_kernel<kD, kR, kQ>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pa_smem_bytes(kD, kQ ? 1 : 2, kR));
  if (attr != cudaSuccess) return (int)attr;
  fn<<<grid, kPaThreads, pa_smem_bytes(kD, kQ ? 1 : 2, a.R), st>>>(a);
  return (int)cudaGetLastError();
}

template <int kD, int kR>
int launch_q(dim3 grid, cudaStream_t st, const PaArgs& a) {
  return a.k_scale ? launch_split<kD, kR, true>(grid, st, a)
                   : launch_split<kD, kR, false>(grid, st, a);
}

template <int kD>
int launch_r(dim3 grid, cudaStream_t st, const PaArgs& a) {
  if (a.R <= 2) return launch_q<kD, 2>(grid, st, a);
  if (a.R <= 4) return launch_q<kD, 4>(grid, st, a);
  if (a.R <= 8) return launch_q<kD, 8>(grid, st, a);
  return launch_q<kD, 16>(grid, st, a);
}

}  // namespace repro

// q (B, KV, R, D) bf16; pools (P, ps, KV, D) bf16, or int8 with (P, KV)
// fp32 scales; block_table (B, MP) int32; lengths (B,) int32; out
// (B, KV, R, D) fp32. ``ws`` holds B * KV * n_split * R * (D + 2) floats:
// the splits' acc, then m, then l. R <= 16; D one of 16, 32, 64, 128, 256.
// Launches the split kernel on grid (B, KV, n_split), then the combine.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* out, void* ws, int B, int KV, int R, int D,
    int P, int ps, int MP, int pages_per_split, int n_split, float sm_scale,
    float softcap, void* stream) {
  using namespace repro;
  if (R < 1 || R > kPaMaxR || B < 1 || KV < 1 || P < 1 || ps < 1 ||
      MP < 1 || pages_per_split < 1 || pages_per_split > kPaMaxRun ||
      n_split < 1 || (long)pages_per_split * n_split < MP || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* acc = (float*)ws;
  float* m = acc + (size_t)B * KV * n_split * R * D;
  float* l = m + (size_t)B * KV * n_split * R;
  const PaArgs a = {(const bf16*)q, k_pool, v_pool, (const float*)k_scale,
                    (const float*)v_scale, (const int*)block_table,
                    (const int*)lengths, acc, m, l, KV, R, P, ps, MP,
                    pages_per_split, sm_scale, softcap};
  const dim3 grid(B, KV, n_split);
  int code;
  switch (D) {
    case 16: code = launch_r<16>(grid, st, a); break;
    case 32: code = launch_r<32>(grid, st, a); break;
    case 64: code = launch_r<64>(grid, st, a); break;
    case 128: code = launch_r<128>(grid, st, a); break;
    case 256: code = launch_r<256>(grid, st, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (code) return code;
  paged_attention_combine_kernel<<<dim3(B * KV, R), D, 0, st>>>(
      acc, m, l, (const int*)lengths, (float*)out, KV, R, D, ps, MP,
      pages_per_split, n_split);
  return (int)cudaGetLastError();
}
