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
// 3.35 TB/s). Only wgmma reaches that rate, so every product runs on it.
//
// Design: two passes and, where the grid needs it, a third; no atomics,
// every sum in a fixed order, so a call gives the same bits every time.
// Every product is wgmma m64n64k16 (m64n128k16 for dQ, dK and dV at D 128
// and up), bf16 operands from 128-byte swizzled tiles that TMA brings into
// shared memory (4-d maps over (B, S, heads, D); rows past a tensor read as
// zeros), fp32 accumulators in registers.
//  1. fbwd_dq_kernel: the forward's block (local_attention.cu): a consumer
//     warpgroup owns 64 rows, (position, query head) pairs, 64 / R
//     positions x the R query heads of one KV head (dead rows zero-filled
//     when R does not divide 64), so each K and V tile is loaded once for
//     all R heads; three consumer warpgroups a block at D 64, two at D 128,
//     one above (the tiles of more would not fit beside the K/V ring). A
//     producer warp's first lane loads Q, dO and out16 once and the band's
//     K and V tiles into a ring guarded by full / empty mbarriers. First
//     Drow of the block's rows, from the dO and out16 tiles, written with
//     lse * log2(e) into (B, H, Sq) fp32 rows (a q tile's 64 values of one
//     head are one TMA box of the next pass). Per key tile: S = Q K^T and
//     dP = dO V^T with both operands from shared memory; ds in registers,
//     packed into bf16 A fragments as it is formed; dQ += dS K with K,
//     [key][D], as the MN-major B.
//  2. fbwd_dkv_kernel: a block owns 64 keys of one KV head and walks the
//     q tiles (64 of q's rows each) of its band, each for the query heads
//     of its group in head order: S^T = K Q^T and dP^T = V dO^T from shared
//     memory, p and ds in registers, dV += P^T dO and dK += dS^T Q with
//     P^T / dS^T as the register A and dO / Q as the MN-major B; dK and dV
//     accumulate across the heads in registers. At D <= 128 the consumer
//     warpgroups (three at D 64, two at 128) take the steps (head, q tile)
//     in turn, each with its own dK and dV, through stages of its own that
//     its first thread loads by TMA; named barriers hand out turns to issue
//     S^T and dP^T in step order, so one warpgroup's per-element work runs
//     beside another's products; at the end the others' dK and dV join the
//     first's in warpgroup order through shared memory. Above D 128 a 64 x D
//     dK and dV would not fit one warpgroup's registers: the two warpgroups
//     split their columns and share the scores (the first computes S^T, the
//     second dP^T, which goes through shared memory to the first; it forms
//     p and ds once and hands their A fragments back). No producer warp: a
//     block of more than 256 threads has at most 168 registers a thread,
//     too few for a 64 x 128 dK and dV beside the scores (setmaxnreg did
//     not raise what ptxas allocates to more).
//  3. Grid fill: a KV head's R query heads can be cut into `groups`
//     groups (launch_config in kernels/flash_backward.py chooses it from the
//     shape and the SM count: 1 wherever B KV ceil(Sk / 64) blocks fill the
//     card). Each group's blocks write one fp32 share of dk and dv, and
//     fbwd_groups_kernel adds the shares in group order.
// The mask runs only on a tile's edge: the diagonal, the window's far edge,
// a chunk boundary inside the tile, keys past Sk or rows past the slice
// end, classified per tile as the forward does; interior tiles run a
// per-element loop compiled without it (fb_modes makes the mask, like the
// softcap, a template argument: a mask tested at run time inside the
// unrolled loop cost its work on every tile).
// Under a softcap, tanh comes from 2^x and 1/x on the special-function
// unit (absolute error ~4e-7; the library's tanhf took most of the time).
//
// What holds it back: the per-element work of each tile (ex2 on the
// special-function unit, the bf16 packing, the softcap's tanh) and the
// waits around it: a warpgroup waits for its products before and after it,
// and the turns overlap it with only the other warpgroups' products; the
// dq pass recomputes S and dP (7 products a pair in all, not 5); at D 256
// the dq kernel has one consumer warpgroup a block and the dk/dv kernel's
// second warpgroup waits for the first's p and ds; at D 64 the dq kernel's
// 416 threads get 128 registers each, and ptxas spills 64 bytes.
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kFbRows = 64;             // rows of a tile: (position, head)
                                        // pairs, keys, or positions
constexpr float kFbLog2e = 1.4426950408889634f;

// The dq kernel at D padded to 64 kNb: consumer warpgroups, K/V stages,
// threads (the consumers, then a producer warp: two consumer warpgroups at
// D 128 need at most the 168 registers a thread that 288 threads get,
// three at D 64 the 128 that 416 get) and dynamic shared memory (a Q, a dO
// and an out16 tile per consumer, the K and V stages, slack for the
// 1024-byte alignment of the swizzle atom).
template <int kNb>
struct FbDq {
  static constexpr int kWgs = kNb == 1 ? 3 : kNb == 2 ? 2 : 1;
  static constexpr int kStages = kNb <= 2 ? 4 : 2;
  static constexpr int kTile = kNb * kSw128Block;
  static constexpr int kThreads = 128 * kWgs + 32;
  static constexpr size_t kSmem =
      (size_t)(3 * kWgs + 2 * kStages) * kTile + 1024;
};

// The dk/dv kernel (kNb 1, 2 or 4): consumer warpgroups and no producer
// warp (a block of more than 256 threads caps every thread at 168
// registers, too few for a 64 x 128 dK and dV beside the scores; at D 64
// three warpgroups fit in 168). The block's 64 keys are either walked
// by each warpgroup in turn, step by step through kPer stages of its own
// (D <= 128), or by both warpgroups at every step, each with half of dK and
// dV's columns (kSplit, D 256). Shared memory: the K and V tiles, the
// stages' Q and dO tiles, the stages' 64 lse and 64 Drow values, and the
// split's exchange of dP^T (fp32) and of the bf16 A fragments of P^T and
// dS^T (32 + 16 + 16 words a thread).
template <int kNb>
struct FbDkv {
  static constexpr bool kSplit = kNb > 2;
  static constexpr int kWgs = kNb == 1 ? 3 : 2;
  static constexpr int kPer = kNb == 1 ? 4 : 2;
  static constexpr int kStages = kSplit ? 2 : kWgs * kPer;
  static constexpr int kTile = kNb * kSw128Block;
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kXchg = kSplit ? 64 * 128 * 4 : 0;
  static constexpr size_t kSmem =
      (size_t)(2 + 2 * kStages) * kTile +
      kStages * 2 * kFbRows * 4 + kXchg + 1024;
};

// flash's mask: key t visible from position p (rows at or past q_end are
// padding).
__device__ __forceinline__ bool fb_visible(int p, int t, int q_end,
                                           int window, int chunk) {
  return t <= p && p - t < window && p < q_end &&
         (chunk == 0 || t / chunk == p / chunk);
}

// The first key position p sees: its window's far edge or its chunk start.
__device__ __forceinline__ int fb_first_key(int p, int window, int chunk) {
  const int f = max(0, p - window + 1);
  return chunk > 0 ? max(f, p / chunk * chunk) : f;
}

__device__ __forceinline__ unsigned char* fb_align1024(unsigned char* p) {
  return p + ((1024 - ((unsigned)__cvta_generic_to_shared(p) & 1023)) & 1023);
}

// d = A B over kNb * 4 k16 steps, A and B 64-row K-major tiles in shared
// memory (64-column blocks of 128-byte swizzled rows).
template <int kNb>
__device__ __forceinline__ void fb_product_ss(float (&d)[32],
                                              const unsigned char* a,
                                              const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kNb * 4; ++kk) {
    const int off = (kk >> 2) * kSw128Block + (kk & 3) * 32;
    wgmma_ss(d, sw128_desc(a + off, 16, 1024), sw128_desc(b + off, 16, 1024),
             kk > 0);
  }
}

// d[n] += A (64 x 64 bf16 fragments in registers) times column block n of a
// 64-row tile in shared memory (from ``tile``), read as the MN-major B; two
// blocks a product (N = 128) where there are two.
template <int kN>
__device__ __forceinline__ void fb_product_rs(float (&d)[kN][32],
                                              const uint32_t (&a)[16],
                                              const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n + 1 < kN; n += 2)
      wgmma_rs_tb2(d[n], d[n + 1], a + 4 * kk,
                   sw128_desc(tile + n * kSw128Block + kk * 16 * 128,
                              kSw128Block, 1024));
    if (kN % 2)
      wgmma_rs_tb(d[kN - 1], a + 4 * kk,
                  sw128_desc(tile + (kN - 1) * kSw128Block + kk * 16 * 128,
                             kSw128Block, 1024));
  }
}

// The per-score constants: score_mult, score_mult log2(e), softcap log2(e).
struct FbScore {
  float mult, mult_l2e, cap_l2e;
};

__device__ __forceinline__ float fb_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (e^2x + 1) from 2^x and 1/x on the special-function
// unit: absolute error ~4e-7 (a few instructions, where the library's
// tanhf spends tens and a branch).
__device__ __forceinline__ float fb_tanh(float x) {
  return 1.0f - 2.0f * fb_rcp(fast_ex2(x * (2.0f * kFbLog2e)) + 1.0f);
}

// p and ds of one score: s the raw q.k, dp the raw dout.v, l = lse log2(e)
// and d = Drow of its row.
template <bool kCap>
__device__ __forceinline__ void fb_p_ds(float s, float dp, float l, float d,
                                        const FbScore& c, float* p_out,
                                        float* ds_out) {
  if (kCap) {
    const float t = fb_tanh(s * c.mult);
    const float p = fast_ex2(t * c.cap_l2e - l);
    *p_out = p;
    *ds_out = p * (dp - d) * (1.0f - t * t);
  } else {
    const float p = fast_ex2(s * c.mult_l2e - l);
    *p_out = p;
    *ds_out = p * (dp - d);
  }
}

// f(cap, edge) with both as compile-time booleans (std::bool_constant), so
// that an interior tile's per-element loop holds no mask.
template <class F>
__device__ __forceinline__ void fb_modes(bool capped, bool edge, F&& f) {
  if (capped) {
    if (edge) f(std::true_type{}, std::true_type{});
    else f(std::true_type{}, std::false_type{});
  } else {
    if (edge) f(std::false_type{}, std::true_type{});
    else f(std::false_type{}, std::false_type{});
  }
}

// A dq tile's ds, as the bf16 A fragments of dQ += dS K (a[i / 2] holds
// accumulator elements i and i + 1), from S and dP: rows r0 (position p0,
// the elements with bit 1 clear) and r1 (p1), keys key0 + the fragment's
// columns; the mask only on an edge tile.
template <bool kCap, bool kEdge>
__device__ __forceinline__ void fb_ds_rows(uint32_t (&a)[16],
                                           const float (&s)[32],
                                           const float (&dp)[32], float l0,
                                           float l1, float d0, float d1,
                                           const FbScore& c, int p0, int p1,
                                           int key0, int cq, int q_end,
                                           int window, int chunk) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    float ds[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = i + h;
      float p;
      fb_p_ds<kCap>(s[e], dp[e], (e & 2) ? l1 : l0, (e & 2) ? d1 : d0, c,
                    &p, &ds[h]);
      if (kEdge && !fb_visible((e & 2) ? p1 : p0,
                              key0 + 8 * (e >> 2) + cq + (e & 1), q_end,
                              window, chunk))
        ds[h] = 0.0f;
    }
    a[i / 2] = pack_bf16(ds[0], ds[1]);
  }
}

// A dk/dv step's p and ds as the bf16 A fragments of dV += P^T dO and dK +=
// dS^T Q, from S^T and dP^T (dp(e): element e of dP^T): rows keys key0 /
// key1, columns positions q0 + col with lse log2(e) lt[col] and Drow
// dt[col].
template <bool kCap, bool kEdge, class DP>
__device__ __forceinline__ void fb_p_ds_keys(
    uint32_t (&pa)[16], uint32_t (&da)[16], const float (&s)[32], DP dp,
    const float* lt, const float* dt, const FbScore& c, int q0, int key0,
    int key1, int Sk, int q_end, int window, int chunk, int cq) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    float p[2], ds[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = i + h;
      const int col = 8 * (e >> 2) + cq + (e & 1);
      const int key = (e & 2) ? key1 : key0;
      fb_p_ds<kCap>(s[e], dp(e), lt[col], dt[col], c, &p[h], &ds[h]);
      if (kEdge &&
          !(key < Sk && fb_visible(q0 + col, key, q_end, window, chunk)))
        p[h] = ds[h] = 0.0f;
    }
    pa[i / 2] = pack_bf16(p[0], p[1]);
    da[i / 2] = pack_bf16(ds[0], ds[1]);
  }
}

template <int kNb>
__global__ void __launch_bounds__(FbDq<kNb>::kThreads, 1) fbwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ lse,
    float* __restrict__ lse_t, float* __restrict__ drow_t,
    float* __restrict__ dq, int B, int Sq, int Sqp, int Sk, int q_off, int H,
    int KV, int D, int window, int chunk, float score_mult, float softcap,
    float scale) {
  using C = FbDq<kNb>;
  constexpr int kWgs = C::kWgs, kStages = C::kStages, kTile = C::kTile;
  extern __shared__ unsigned char smem_raw[];
  // qbar: the Q, dO and out16 tiles have landed; full[st]: the stage's K and V
  // tiles have (the producer's expect_tx); empty[st]: every consumer warp
  // is done reading it
  __shared__ uint64_t qbar, full[kStages], empty[kStages];
  unsigned char* smem = fb_align1024(smem_raw);
  unsigned char* qs = smem;                    // [warpgroup][kTile]
  unsigned char* dos = qs + kWgs * kTile;      // [warpgroup][kTile]
  unsigned char* os = dos + kWgs * kTile;      // [warpgroup][kTile]
  unsigned char* ks = os + kWgs * kTile;       // [stage][kTile]
  unsigned char* vs = ks + kStages * kTile;

  const int R = H / KV;
  const int per_wg = kFbRows / R, live = per_wg * R;
  const int per_block = kWgs * per_wg;
  // q holds the rows at positions [q_off, q_end) of the Sk keys'; every
  // position below is global
  const int q_end = q_off + Sq;
  const int n_qt = (Sq + per_block - 1) / per_block;
  const int rows_kv = B * KV;
  const int qt = n_qt - 1 - (int)(blockIdx.x / rows_kv);   // longest first
  const int g = (int)(blockIdx.x % rows_kv) % KV;
  const int b = (int)(blockIdx.x % rows_kv) / KV;
  const int lq0 = qt * per_block, q0 = q_off + lq0;
  const int t_first = fb_first_key(q0, window, chunk) / kFbRows;
  const int t_last = (min(q0 + per_block, q_end) - 1) / kFbRows;
  const int tid = threadIdx.x;

  // dead rows (R not dividing 64) of every Q and dO tile read as zeros
  if (live < kFbRows) {
    const int per_tile = kNb * (kFbRows - live) * 8;   // 16-byte chunks
    for (int i = tid; i < 2 * kWgs * per_tile; i += C::kThreads) {
      const int tile = i / per_tile, j = i % per_tile;
      const int nb = j / ((kFbRows - live) * 8);
      const int r = live + (j / 8) % (kFbRows - live);
      *reinterpret_cast<uint4*>(qs + tile * kTile + nb * kSw128Block +
                                r * 128 + (j % 8) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (tid == 0) {
    mbar_init(&qbar, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the warpgroup (the producer warp's is kWgs), warp-uniform for the
  // compiler, which then keeps each role's products on one path
  const int w = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (w == kWgs) {   // the producer warp: its first lane issues the loads
    if (tid == 128 * kWgs) {
      int n_wgs = 0;   // consumers with a row before q_end
      while (n_wgs < kWgs && q0 + n_wgs * per_wg < q_end) ++n_wgs;
      mbar_arrive_expect(&qbar, 3 * n_wgs * kNb * live * 128);
      for (int w = 0; w < n_wgs; ++w)
        for (int nb = 0; nb < kNb; ++nb) {
          const int at = w * kTile + nb * kSw128Block;
          const int row = lq0 + w * per_wg;
          tma_load_4d(qs + at, &tm_q, nb * 64, g * R, row, b, &qbar);
          tma_load_4d(dos + at, &tm_do, nb * 64, g * R, row, b, &qbar);
          tma_load_4d(os + at, &tm_o, nb * 64, g * R, row, b, &qbar);
        }
      for (int t = t_first; t <= t_last; ++t) {
        const int j = t - t_first, st = j % kStages;
        if (j >= kStages)   // tile j - kStages has left the stage
          mbar_wait(&empty[st], (j / kStages - 1) & 1);
        mbar_arrive_expect(&full[st], 2 * kTile);
        for (int nb = 0; nb < kNb; ++nb) {
          const int at = st * kTile + nb * kSw128Block;
          tma_load_4d(ks + at, &tm_k, nb * 64, g, t * kFbRows, b, &full[st]);
          tma_load_4d(vs + at, &tm_v, nb * 64, g, t * kFbRows, b, &full[st]);
        }
      }
    }
    return;
  }
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  // this warpgroup's rows: positions [qw0, qw_last], its own band (none
  // when it starts past q_end: it then only releases the block's tiles)
  const int qw0 = q0 + w * per_wg;
  const int qw_last = min(qw0 + per_wg, q_end) - 1;
  const bool active = qw0 < q_end;
  const int tw_first =
      active ? fb_first_key(qw0, window, chunk) / kFbRows : t_last + 1;
  const int tw_last = active ? qw_last / kFbRows : t_last;
  const unsigned char* qw = qs + w * kTile;
  const unsigned char* dow = dos + w * kTile;
  // accumulator fragment: rows r0, r1 = r0 + 8 and, in each 8-column group
  // j, columns 8j + cq and 8j + cq + 1 (a dead row is never stored)
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;
  const int p0 = qw0 + r0 / R, p1 = qw0 + r1 / R;
  const int cq = 2 * (lane & 3);
  const bool ok0 = r0 < live && p0 < q_end, ok1 = r1 < live && p1 < q_end;
  const int h0 = g * R + r0 % R, h1 = g * R + r1 % R;
  const float l0 =
      ok0 ? lse[((long)b * Sq + p0 - q_off) * H + h0] * kFbLog2e : 0.0f;
  const float l1 =
      ok1 ? lse[((long)b * Sq + p1 - q_off) * H + h1] * kFbLog2e : 0.0f;
  float d0 = 0.0f, d1 = 0.0f;   // the rows' Drow, formed once Q and dO land
  const bool capped = softcap > 0.0f;
  const FbScore sc{score_mult, score_mult * kFbLog2e, softcap * kFbLog2e};
  float acc[kNb][32];
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.0f;

  auto wait_full = [&](int t) {
    const int j = t - t_first;
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
  };
  auto release = [&](int t) {   // this warp is done with tile t's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(t - t_first) % kStages]);
  };
  auto k_tile = [&](int t) { return ks + (t - t_first) % kStages * kTile; };
  // S = Q K^T and dP = dO V^T of tile t, one committed group
  auto issue_sdp = [&](float (&s)[32], float (&dp)[32], int t) {
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    fb_product_ss<kNb>(s, qw, k_tile(t));
    fb_product_ss<kNb>(dp, dow, vs + (t - t_first) % kStages * kTile);
    wgmma_commit();
  };
  // ds of tile t, then dQ += dS K, one committed group
  auto issue_dq = [&](const float (&s)[32], const float (&dp)[32], int t) {
    const int key0 = t * kFbRows;
    const bool edge = key0 + kFbRows - 1 > qw0 ||
                      key0 <= qw_last - window || key0 + kFbRows > Sk ||
                      (chunk > 0 && key0 < qw_last / chunk * chunk);
    uint32_t a[16];
    fb_modes(capped, edge, [&](auto cap, auto e) {
      fb_ds_rows<decltype(cap)::value, decltype(e)::value>(
          a, s, dp, l0, l1, d0, d1, sc, p0, p1, key0, cq, q_end, window,
          chunk);
    });
    wgmma_fence();
    fb_product_rs<kNb>(acc, a, k_tile(t));
    wgmma_commit();
  };

  if (active) mbar_wait(&qbar, 0);
  // Drow of rows r0 and r1 from the dO and out16 tiles, each quad's four
  // threads 2 of every 8 16-byte chunks of a row, summed by shuffles;
  // written with lse log2(e) by head for the dk/dv pass
  if (active) {
    const unsigned char* ow = os + w * kTile;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = (lane & 3) + 4 * h;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? r1 : r0;
          const int at = nb * kSw128Block + row * 128 + ((ch ^ (row & 7)) << 4);
          const uint4 o = *reinterpret_cast<const uint4*>(ow + at);
          const uint4 gd = *reinterpret_cast<const uint4*>(dow + at);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&o);
          const __nv_bfloat162* g2 =
              reinterpret_cast<const __nv_bfloat162*>(&gd);
          float acc_r = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 of = __bfloat1622float2(o2[j]);
            const float2 gf = __bfloat1622float2(g2[j]);
            acc_r += of.x * gf.x + of.y * gf.y;
          }
          if (r) d1 += acc_r;
          else d0 += acc_r;
        }
      }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
  }
  if ((lane & 3) == 0) {
    if (ok0) {
      const long at = ((long)b * H + h0) * Sqp + (p0 - q_off);
      drow_t[at] = d0;
      lse_t[at] = l0;
    }
    if (ok1) {
      const long at = ((long)b * H + h1) * Sqp + (p1 - q_off);
      drow_t[at] = d1;
      lse_t[at] = l1;
    }
  }
  // the block's tiles before this warpgroup's band: released unread
  for (int t = t_first; t < tw_first; ++t) {
    wait_full(t);
    release(t);
  }
  for (int t = tw_first; t <= tw_last; ++t) {
    float s[32], dp[32];
    wait_full(t);
    issue_sdp(s, dp, t);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    issue_dq(s, dp, t);
    wgmma_wait<0>();
    release(t);
  }
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) fence_regs(acc[nb]);

#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + cq;
      if (col < D) {
        if (ok0)
          *reinterpret_cast<float2*>(
              dq + (((long)b * Sq + p0 - q_off) * H + h0) * D + col) =
              make_float2(acc[nb][4 * j] * scale, acc[nb][4 * j + 1] * scale);
        if (ok1)
          *reinterpret_cast<float2*>(
              dq + (((long)b * Sq + p1 - q_off) * H + h1) * D + col) =
              make_float2(acc[nb][4 * j + 2] * scale,
                          acc[nb][4 * j + 3] * scale);
      }
    }
  }
}

// Stores (or, kAdd, adds to what is there) this thread's fragment of kN
// column blocks (from column block nb0) of a block's dK (times scale) and
// dV at keys key0, key1 = key0 + 8.
template <int kN, bool kAdd = false>
__device__ __forceinline__ void fb_store_kv(float* dk, float* dv,
                                            const float (&dka)[kN][32],
                                            const float (&dva)[kN][32],
                                            int nb0, long row0, long row1,
                                            bool ok0, bool ok1, int D, int cq,
                                            float scale) {
#pragma unroll
  auto put = [](float* at, float2 v) {
    float2* p = reinterpret_cast<float2*>(at);
    if (kAdd) {
      const float2 o = *p;
      v = make_float2(o.x + v.x, o.y + v.y);
    }
    *p = v;
  };
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (nb0 + n) * 64 + 8 * j + cq;
      if (col < D) {
        if (ok0) {
          put(dk + row0 * D + col,
              make_float2(dka[n][4 * j] * scale, dka[n][4 * j + 1] * scale));
          put(dv + row0 * D + col,
              make_float2(dva[n][4 * j], dva[n][4 * j + 1]));
        }
        if (ok1) {
          put(dk + row1 * D + col, make_float2(dka[n][4 * j + 2] * scale,
                                               dka[n][4 * j + 3] * scale));
          put(dv + row1 * D + col,
              make_float2(dva[n][4 * j + 2], dva[n][4 * j + 3]));
        }
      }
    }
  }
}

template <int kNb>
__global__ void __launch_bounds__(FbDkv<kNb>::kThreads, 1) fbwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_l,
    const __grid_constant__ CUtensorMap tm_d, float* __restrict__ dk,
    float* __restrict__ dv, int B, int Sq, int Sk, int q_off, int H, int KV,
    int D, int groups, int window, int chunk, float score_mult,
    float softcap, float scale) {
  using C = FbDkv<kNb>;
  constexpr int kStages = C::kStages, kTile = C::kTile;
  extern __shared__ unsigned char smem_raw[];
  // kvbar: the block's K and V tiles have landed; full[st]: the stage's Q,
  // dO, lse and Drow have (its loader's expect_tx)
  __shared__ uint64_t kvbar, full[kStages];
  unsigned char* smem = fb_align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = ks + kTile;
  unsigned char* qs = vs + kTile;                  // [stage][kTile]
  unsigned char* dos = qs + kStages * kTile;       // [stage][kTile]
  float* ls = reinterpret_cast<float*>(dos + kStages * kTile);  // [st][64]
  float* drs = ls + kStages * kFbRows;                          // [st][64]
  float* xdp = drs + kStages * kFbRows;            // [32][128] (split only)
  uint32_t* xpa = reinterpret_cast<uint32_t*>(xdp + 32 * 128);  // [16][128]
  uint32_t* xda = xpa + 16 * 128;                               // [16][128]

  const int R = H / KV, per_group = R / groups;
  // blocks in key-tile order (causal bands are longest at the first keys)
  int idx = blockIdx.x;
  const int g = idx % KV;
  idx /= KV;
  const int b = idx % B;
  idx /= B;
  const int gi = idx % groups, kt = idx / groups;
  const int k0 = kt * kFbRows;
  // the band's positions among q's rows [q_off, q_end): from the later of
  // the block's first key and q_off, to a key's window or chunk end; the
  // block walks only the q tiles (64 of q's rows each, from its first)
  // that hold them, and none when the band misses q's rows
  const int q_end = q_off + Sq;
  int last = min(q_end - 1, k0 + kFbRows - 1 + window - 1);
  if (chunk > 0) last = min(last, ((k0 + kFbRows - 1) / chunk + 1) * chunk - 1);
  const int first = max(k0, q_off);
  const int t_first = (first - q_off) / kFbRows;
  const int nq = last >= first ? (last - q_off) / kFbRows - t_first + 1 : 0;
  const int n = nq * per_group;   // steps: (q tile, head of the group)
  // step i's head in the group and q tile: the heads of a q tile together
  // where the warpgroups take the steps in turn (the blocks in flight read
  // nearby q tiles); head by head where they split the columns (each
  // head's dK and dV, a sum of its tiles, then join the block's output in
  // head order)
  auto step_head = [&](int i) { return C::kSplit ? i / nq : i % per_group; };
  auto step_tile = [&](int i) { return C::kSplit ? i % nq : i / per_group; };
  const int h_base = g * R + gi * per_group;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&kvbar, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // step i's Q, dO, lse and Drow into stage st, by one thread
  auto load_step = [&](int i, int st) {
    const int h = h_base + step_head(i);
    const int row = (t_first + step_tile(i)) * kFbRows;
    mbar_arrive_expect(&full[st], 2 * kTile + 2 * kFbRows * 4);
    for (int nb = 0; nb < kNb; ++nb) {
      const int at = st * kTile + nb * kSw128Block;
      tma_load_4d(qs + at, &tm_q, nb * 64, h, row, b, &full[st]);
      tma_load_4d(dos + at, &tm_do, nb * 64, h, row, b, &full[st]);
    }
    tma_load_3d(ls + st * kFbRows, &tm_l, row, h, b, &full[st]);
    tma_load_3d(drs + st * kFbRows, &tm_d, row, h, b, &full[st]);
  };
  if (tid == 0 && n > 0) {
    mbar_arrive_expect(&kvbar, 2 * kTile);
    for (int nb = 0; nb < kNb; ++nb) {
      tma_load_4d(ks + nb * kSw128Block, &tm_k, nb * 64, g, k0, b, &kvbar);
      tma_load_4d(vs + nb * kSw128Block, &tm_v, nb * 64, g, k0, b, &kvbar);
    }
  }

  const int w = __shfl_sync(0xffffffffu, tid / 128, 0);   // warp-uniform
  const int ct = tid & 127, warp = ct >> 5, lane = tid & 31;
  // accumulator fragment: keys r0, r1 = r0 + 8 (rows) and, in each 8-column
  // group j, columns 8j + cq and 8j + cq + 1 (positions or head dims)
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;
  const int key0 = k0 + r0, key1 = k0 + r1;
  const int cq = 2 * (lane & 3);
  // this block's dk / dv: its group's share when groups > 1
  const long share = (long)gi * B * Sk * KV * D;
  const long row0 = ((long)b * Sk + key0) * KV + g;
  const long row1 = ((long)b * Sk + key1) * KV + g;
  const bool capped = softcap > 0.0f;
  const FbScore sc{score_mult, score_mult * kFbLog2e, softcap * kFbLog2e};
  // where the step's scores need the mask
  auto edge_of = [&](int q0) {
    return k0 + kFbRows - 1 > q0 || q0 + kFbRows - 1 - k0 >= window ||
           k0 + kFbRows > Sk || q0 + kFbRows > q_end ||
           (chunk > 0 && k0 / chunk != (q0 + kFbRows - 1) / chunk);
  };

  if constexpr (!C::kSplit) {
    // Warpgroup w takes steps w, w + kWgs, ... with its own dK and dV,
    // through its own kPer stages: its first thread loads its step j + kPer
    // into the stage of step j once the warpgroup is done with it.
    constexpr int kWgs = C::kWgs, kPer = C::kPer;
    float dka[kNb][32], dva[kNb][32];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[nb][i] = dva[nb][i] = 0.0f;
    const bool loader = ct == 0;
    if (loader)
      for (int j = 0; j < kPer && w + kWgs * j < n; ++j)
        load_step(w + kWgs * j, w * kPer + j);
    if (w < n) mbar_wait(&kvbar, 0);
    // Turns: step i's S^T and dP^T are issued after step i - 1's, so the
    // warpgroups' per-element work runs beside each other's products (named
    // barrier kWgs + 2 + w opens warpgroup w's turn; the last warpgroup
    // opens the first, and each step the next, but for the last step).
    const int turn0 = kWgs + 2;
    if (w == kWgs - 1 && n > 0) named_arrive(turn0, 256);
    for (int j = 0; w + kWgs * j < n; ++j) {
      const int i = w + kWgs * j, st = w * kPer + j % kPer;
      mbar_wait(&full[st], (j / kPer) & 1);
      const unsigned char* qt = qs + st * kTile;
      const unsigned char* dot = dos + st * kTile;
      const float* lt = ls + st * kFbRows;
      const float* dt = drs + st * kFbRows;
      const int q0 = q_off + (t_first + step_tile(i)) * kFbRows;
      float s[32], dp[32];
      fence_regs(s);
      fence_regs(dp);
      named_sync(turn0 + w, 256);
      wgmma_fence();
      fb_product_ss<kNb>(s, ks, qt);     // S^T = K Q^T
      fb_product_ss<kNb>(dp, vs, dot);   // dP^T = V dO^T
      wgmma_commit();
      if (i + 1 < n) named_arrive(turn0 + (w + 1) % kWgs, 256);
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const bool edge = edge_of(q0);
      uint32_t pa[16], da[16];
      auto dp_of = [&](int e) { return dp[e]; };
      fb_modes(capped, edge, [&](auto cap, auto e) {
        fb_p_ds_keys<decltype(cap)::value, decltype(e)::value>(
            pa, da, s, dp_of, lt, dt, sc, q0, key0, key1, Sk, q_end, window,
            chunk, cq);
      });
      wgmma_fence();
      fb_product_rs<kNb>(dva, pa, dot);   // dV += P^T dO
      fb_product_rs<kNb>(dka, da, qt);    // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        fence_regs(dka[nb]);
        fence_regs(dva[nb]);
      }
      named_sync(1 + w, 128);   // the warpgroup is done with the stage
      if (loader && i + kWgs * kPer < n) load_step(i + kWgs * kPer, st);
    }
    // the other warpgroups' sums join the first's, in warpgroup order,
    // through the ring, which no load or product touches any more
    float* red = reinterpret_cast<float*>(qs);   // [wg - 1][2 kNb][32][128]
    named_sync(kWgs + 1, 128 * kWgs);
    if (w > 0) {
      float* mine = red + (w - 1) * 2 * kNb * 32 * 128;
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          mine[((2 * nb) * 32 + e) * 128 + ct] = dka[nb][e];
          mine[((2 * nb + 1) * 32 + e) * 128 + ct] = dva[nb][e];
        }
    }
    named_sync(kWgs + 1, 128 * kWgs);
    if (w == 0) {
      for (int o = 0; o + 1 < kWgs; ++o) {
        const float* theirs = red + o * 2 * kNb * 32 * 128;
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            dka[nb][e] += theirs[((2 * nb) * 32 + e) * 128 + ct];
            dva[nb][e] += theirs[((2 * nb + 1) * 32 + e) * 128 + ct];
          }
      }
      fb_store_kv<kNb>(dk + share, dv + share, dka, dva, 0, row0, row1,
                       key0 < Sk, key1 < Sk, D, cq, scale);
    }
  } else {
    // Split columns (D > 128, padded to 256): warpgroup w owns column
    // blocks 2w and 2w + 1 of dK and dV; per step the first computes S^T,
    // the second dP^T, and p and ds are formed once, by the first. Both
    // then read the A fragments from shared memory, so the products take
    // their registers on one path. The block's first thread loads step
    // i + 2 into the stage of step i once both warpgroups are done with it.
    // After each head's last step, its dK and dV join the block's output
    // (the first head's are stored) and the accumulators restart.
    float dka[2][32], dva[2][32];
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[n2][i] = dva[n2][i] = 0.0f;
    const volatile uint32_t* vpa = xpa;
    const volatile uint32_t* vda = xda;
    if (tid == 0) {
      if (n > 0) load_step(0, 0);
      if (n > 1) load_step(1, 1);
    }
    if (n > 0) mbar_wait(&kvbar, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      const unsigned char* qt = qs + st * kTile;
      const unsigned char* dot = dos + st * kTile;
      float sd[32];   // S^T in the first warpgroup, dP^T in the second
      fence_regs(sd);
      wgmma_fence();
      fb_product_ss<kNb>(sd, w == 0 ? ks : vs, w == 0 ? qt : dot);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sd);
      if (w == 1) {
#pragma unroll
        for (int e = 0; e < 32; ++e) xdp[e * 128 + ct] = sd[e];
      }
      named_sync(1, 256);   // dP^T is in shared memory
      if (w == 0) {
        const float* lt = ls + st * kFbRows;
        const float* dt = drs + st * kFbRows;
        const int q0 = q_off + (t_first + step_tile(i)) * kFbRows;
        const bool edge = edge_of(q0);
        uint32_t pw[16], dw[16];
        auto dp_of = [&](int e) { return xdp[e * 128 + ct]; };
        fb_modes(capped, edge, [&](auto cap, auto e) {
          fb_p_ds_keys<decltype(cap)::value, decltype(e)::value>(
              pw, dw, sd, dp_of, lt, dt, sc, q0, key0, key1, Sk, q_end,
              window, chunk, cq);
        });
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          xpa[e * 128 + ct] = pw[e];
          xda[e * 128 + ct] = dw[e];
        }
      }
      named_sync(2, 256);   // the A fragments of P^T and dS^T are there
      uint32_t pa[16], da[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        pa[e] = vpa[e * 128 + ct];
        da[e] = vda[e * 128 + ct];
      }
      wgmma_fence();
      fb_product_rs<2>(dva, pa, dot + 2 * w * kSw128Block);   // dV += P^T dO
      fb_product_rs<2>(dka, da, qt + 2 * w * kSw128Block);    // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        fence_regs(dka[n2]);
        fence_regs(dva[n2]);
      }
      named_sync(3, 256);   // both warpgroups are done with the stage
      if (tid == 0 && i + kStages < n) load_step(i + kStages, st);
      if (i % nq == nq - 1) {   // the head's last tile
        if (i < nq)
          fb_store_kv<2>(dk + share, dv + share, dka, dva, 2 * w, row0, row1,
                         key0 < Sk, key1 < Sk, D, cq, scale);
        else
          fb_store_kv<2, true>(dk + share, dv + share, dka, dva, 2 * w, row0,
                               row1, key0 < Sk, key1 < Sk, D, cq, scale);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
          for (int e = 0; e < 32; ++e) dka[n2][e] = dva[n2][e] = 0.0f;
          fence_regs(dka[n2]);
          fence_regs(dva[n2]);
        }
      }
    }
    if (n == 0)   // no q row in the band: the block's share is zero
      fb_store_kv<2>(dk + share, dv + share, dka, dva, 2 * w, row0, row1,
                     key0 < Sk, key1 < Sk, D, cq, scale);
  }
}

// dk = the groups' dk shares added in group order; dv the same.
__global__ void __launch_bounds__(256) fbwd_groups_kernel(
    const float4* __restrict__ dk_s, const float4* __restrict__ dv_s,
    float4* __restrict__ dk, float4* __restrict__ dv, long n4, int groups) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 a = dk_s[i], c = dv_s[i];
    for (int s = 1; s < groups; ++s) {
      const float4 x = dk_s[i + s * n4], y = dv_s[i + s * n4];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
      c.x += y.x;
      c.y += y.y;
      c.z += y.z;
      c.w += y.w;
    }
    dk[i] = a;
    dv[i] = c;
  }
}

// A TMA map of a (B, S, heads, D) bf16 tensor as {D, heads, S, B}, read in
// boxes of 64 columns x box_heads heads x box_rows positions, 128-byte
// swizzle.
static cudaError_t fb_map_rows(CUtensorMap* map, const void* base, int B,
                               int S, int heads, int D, int box_heads,
                               int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows,
                             1};
  return tensor_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A TMA map of (B, H, Sqp) fp32 rows of Sq values, in boxes of 64.
static cudaError_t fb_map_vec(CUtensorMap* map, const float* base, int B,
                              int H, int Sq, int Sqp) {
  const cuuint64_t dims[3] = {(cuuint64_t)Sq, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)Sqp * 4,
                                 (cuuint64_t)H * Sqp * 4};
  const cuuint32_t box[3] = {kFbRows, 1, 1};
  return tensor_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int kNb, int kNbKv>
int launch_fbwd(const void* q, const void* k, const void* v,
                const void* out16, const void* lse, const void* dout,
                float* lse_t, float* drow_t,
                float* dq, float* dk, float* dv, int B, int Sq, int Sqp,
                int Sk, int q_off, int H, int KV, int D, int groups,
                int window, int chunk, float score_mult, float softcap,
                float scale, cudaStream_t st) {
  using Q = FbDq<kNb>;
  using K = FbDkv<kNbKv>;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      fbwd_dq_kernel<kNb>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Q::kSmem);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      fbwd_dkv_kernel<kNbKv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)K::kSmem);
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  const int R = H / KV, per_wg = kFbRows / R;
  CUtensorMap tq_rows, tdo_rows, to_rows, tq, tdo, tk, tv, tl, td;
  cudaError_t e;
  if ((e = fb_map_rows(&tq_rows, q, B, Sq, H, D, R, per_wg)) ||
      (e = fb_map_rows(&tdo_rows, dout, B, Sq, H, D, R, per_wg)) ||
      (e = fb_map_rows(&to_rows, out16, B, Sq, H, D, R, per_wg)) ||
      (e = fb_map_rows(&tq, q, B, Sq, H, D, 1, kFbRows)) ||
      (e = fb_map_rows(&tdo, dout, B, Sq, H, D, 1, kFbRows)) ||
      (e = fb_map_rows(&tk, k, B, Sk, KV, D, 1, kFbRows)) ||
      (e = fb_map_rows(&tv, v, B, Sk, KV, D, 1, kFbRows)) ||
      (e = fb_map_vec(&tl, lse_t, B, H, Sq, Sqp)) ||
      (e = fb_map_vec(&td, drow_t, B, H, Sq, Sqp)))
    return (int)e;
  const int per_block = Q::kWgs * per_wg;
  const long grid_q = (long)((Sq + per_block - 1) / per_block) * B * KV;
  const long grid_k = (long)((Sk + kFbRows - 1) / kFbRows) * groups * B * KV;
  if (grid_q > 0x7fffffffL || grid_k > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  fbwd_dq_kernel<kNb><<<(unsigned)grid_q, Q::kThreads, Q::kSmem, st>>>(
      tq_rows, tdo_rows, tk, tv, to_rows, (const float*)lse, lse_t, drow_t,
      dq, B, Sq, Sqp, Sk, q_off, H, KV, D, window, chunk, score_mult,
      softcap, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fbwd_dkv_kernel<kNbKv><<<(unsigned)grid_k, K::kThreads, K::kSmem, st>>>(
      tq, tdo, tk, tv, tl, td, dk, dv, B, Sq, Sk, q_off, H, KV, D, groups,
      window, chunk, score_mult, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro

// q (B, Sq, H, D): the rows at positions q_offset .. q_offset + Sq - 1 of
// k/v (B, Sk, KV, D) (Sq = Sk at offset 0: every row); out16 and dout (B,
// Sq, H, D) bf16; lse (B, Sq, H) fp32; out dq (B, Sq, H, D), dk/dv (B, Sk,
// KV, D) fp32 (at an offset: the slice's share of them). ws: fp32 scratch
// of 2 B H Sqp floats (Sqp = Sq rounded up to 64: lse log2(e) and Drow by
// head), then, when groups > 1, 2 groups B Sk KV D (the groups' dk and dv
// shares). H / KV at most 64 and a multiple of groups, D a multiple of 16
// up to 256, 1 <= window <= Sk (Sk: causal), chunk 0 or the chunk width;
// every tensor 16-byte aligned. score_mult and softcap as for the forward
// (repro_sliding_window_attention_q); scale 1/sqrt(D). At a q_offset that
// is a multiple of a dq block's positions (64 / R a consumer warpgroup:
// launch_config's dq_tile) each dq row has the bits of the launch over
// all Sk rows.
extern "C" int repro_flash_backward(
    const void* q, const void* k, const void* v, const void* out16,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* ws, int B, int Sq, int Sk, int q_offset, int H, int KV, int D,
    int window, int chunk, int groups, float score_mult, float softcap,
    float scale, void* stream) {
  using namespace repro;
  if (KV < 1 || H % KV || H / KV > 64 || D % 16 || D > 256 || D < 16 ||
      window < 1 || chunk < 0 || Sq < 1 || Sk < 1 || B < 1 ||
      q_offset < 0 || q_offset > Sk - Sq || groups < 1 ||
      (H / KV) % groups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int Sqp = (Sq + kFbRows - 1) / kFbRows * kFbRows;
  float* lse_t = (float*)ws;
  float* drow_t = lse_t + (long)B * H * Sqp;
  float* shares = drow_t + (long)B * H * Sqp;
  const long n = (long)B * Sk * KV * D;
  float* dk_to = groups > 1 ? shares : (float*)dk;
  float* dv_to = groups > 1 ? shares + groups * n : (float*)dv;
  int code;
#define REPRO_FBWD(NB, NBKV)                                           \
  code = launch_fbwd<NB, NBKV>(q, k, v, out16, lse, dout, lse_t, drow_t, \
                               (float*)dq, dk_to, dv_to, B, Sq, Sqp, Sk,   \
                               q_offset, H, KV, D, groups, window, chunk,  \
                               score_mult, softcap, scale, st)
  switch ((D + 63) / 64) {
    case 1: REPRO_FBWD(1, 1); break;
    case 2: REPRO_FBWD(2, 2); break;
    case 3: REPRO_FBWD(3, 4); break;   // dk/dv: D padded to 256
    default: REPRO_FBWD(4, 4); break;
  }
#undef REPRO_FBWD
  if (code || groups == 1) return code;
  const long n4 = n / 4, blocks = (n4 + 255) / 256;
  fbwd_groups_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
                       st>>>((const float4*)shares,
                             (const float4*)(shares + groups * n),
                             (float4*)dk, (float4*)dv, n4, groups);
  return (int)cudaGetLastError();
}
