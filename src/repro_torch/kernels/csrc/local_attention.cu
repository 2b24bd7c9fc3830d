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
// Only wgmma reaches that rate, so the products run on it.
//
// Design: one thread block per (pair of q tiles, KV head, batch row), two
// consumer warpgroups of 128 threads. A warpgroup owns one q tile of 64 rows,
// exactly wgmma's M: (position, query head) pairs, per_wg = 64 / R (floored)
// positions x the R query heads that share the KV head, so every K and V tile
// loaded serves all R heads of both tiles. Any R up to 64 fits: when R does
// not divide 64 (5, 6 and 10 in the reference's configs) the tile's last
// 64 - per_wg * R rows are dead. A dead row's Q is zero-filled, so its scores
// are 0 or masked on every tile (finite: its softmax never makes a NaN), the
// warpgroup's band of key tiles is that of its live rows, and it stores
// nothing. The block walks only the 64-key tiles of its band,
// [q0 - window + 1, q_last], in ascending order (a warpgroup skips the one
// tile at either end that only the other needs); keys at or past S are
// zero-filled, never read. Q (once) and each key tile's K and V are copied by
// 16-byte cp.async into shared memory in wgmma's 128-byte swizzled layout
// (64-column blocks of 128-byte rows, 16-byte chunk c of row r at c ^ (r %
// 8)), into a ring of two stages guarded by mbarriers: "full" completes when
// every thread's copies of the stage have landed, "empty" when every warp is
// done reading it. There is no block-wide barrier in the loop, so one
// warpgroup can run a tile ahead of the other and its products overlap the
// other's softmax. Per tile and warpgroup: S = Q K^T is wgmma m64n64k16 with
// both operands from shared memory (K as stored, [key][D], is the K-major B);
// the fp32 scores stay in registers, where scale, softcap (the library's
// tanhf, as the plain version's torch.tanh), the mask (only on the band's edge
// tiles: the diagonal, the window's far edge and keys past S) and the fp32
// online softmax run in log2 units (p = 2^(y - m) on the special-function
// unit; row max and sum by quad shuffles); O is rescaled only when a row's max
// moved. p is rounded to bf16 as the reference's flash does and becomes the A
// operand of O += P V, wgmma m64n64k16 with A from registers and V, [key][D],
// as the MN-major ("transposed") B, one instruction per 64 columns of D. The
// 64 x D fp32 accumulator lives in registers for the block's life (128 a
// thread at D 256); it leaves them once, divided by max(l, 1e-30), for the
// fp32 output. D is padded to a multiple of 64 with zeros in shared memory.
// Blocks are launched longest first: q tiles in descending order, since causal
// tiles have from 1 to S / 64 key tiles. The masking convention is the
// reference's: NEG_INF = -2e38, p = exp(s - m) only where s > NEG_INF / 2, and
// the output is acc / max(l, 1e-30).
//
// What still holds it back: the softmax's per-element work on the CUDA
// cores (tanhf above all) is still the largest share of a tile's time
// (dead rows take their share: 4 of 64 rows at R 5, 6 and 10), and
// a warpgroup's own softmax does not overlap its own products; no producer
// warp (all 256 threads issue the copies), and at D 256 the 193 KB of
// shared memory allow one block per SM; each block holds only 128 / R
// positions, so every K/V tile is re-read from L2 by each block whose band
// covers it.
#include "common.cuh"

namespace repro {

constexpr int kSwaRows = 64;      // (position, head) rows of a warpgroup
constexpr int kSwaWgs = 2;        // consumer warpgroups sharing each K/V tile
constexpr int kSwaKeys = 64;      // keys per tile
constexpr int kSwaThreads = 128 * kSwaWgs;
constexpr int kSwaStages = 2;     // K/V tiles in flight
constexpr int kSwaBlock = 64 * 128;  // 64 rows x 64 bf16 columns, swizzled
constexpr float kSwaNegInf = -2.0e38f;

// Dynamic shared memory for D padded to 64 * nb: a Q tile per warpgroup,
// then the K and V stages, plus slack to align the base to the 1024-byte
// swizzle atom.
__host__ __device__ constexpr size_t swa_smem_bytes(int nb) {
  return (size_t)(kSwaWgs + 2 * kSwaStages) * nb * kSwaBlock + 1024;
}

// Byte offset of 16-byte chunk ``ch`` (8 bf16 columns) of row ``row`` in a
// tile of 64-column blocks with 128-byte swizzled rows.
__device__ __forceinline__ int swz(int row, int ch) {
  return (ch >> 3) * kSwaBlock + row * 128 + (((ch & 7) ^ (row & 7)) << 4);
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

template <int kNb>   // D padded to 64 * kNb
__global__ void __launch_bounds__(kSwaThreads, 1) swa_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, float* __restrict__ out, int B, int S, int H,
    int KV, int D, int window, float score_mult, float softcap) {
  constexpr int kTile = kNb * kSwaBlock;
  constexpr int kChunks = kNb * 8;            // 16-byte chunks per row
  extern __shared__ unsigned char smem_raw[];
  // full[st]: every thread's copies of the stage have landed (one arrival
  // per thread); empty[st]: every warp is done reading it (one per warp)
  __shared__ uint64_t full[kSwaStages], empty[kSwaStages];
  unsigned char* smem = smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(
                                                smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                           // [warpgroup][kTile]
  unsigned char* ks = qs + kSwaWgs * kTile;           // [stage][kTile]
  unsigned char* vs = ks + kSwaStages * kTile;

  const int R = H / KV;
  const int per_wg = kSwaRows / R;                    // positions per tile
  const int per_block = kSwaWgs * per_wg;
  const int n_qt = (S + per_block - 1) / per_block;
  const int rows_kv = B * KV;
  const int qt = n_qt - 1 - (int)(blockIdx.x / rows_kv);   // longest first
  const int g = (int)(blockIdx.x % rows_kv) % KV;
  const int b = (int)(blockIdx.x % rows_kv) / KV;
  const int q0 = qt * per_block;
  const int t_first = max(0, q0 - window + 1) / kSwaKeys;
  const int t_last = (min(q0 + per_block, S) - 1) / kSwaKeys;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  // this warpgroup's own q tile and band; it skips the block's other tiles
  const int qw0 = q0 + wg * per_wg;
  const int qw_last = min(qw0 + per_wg, S) - 1;
  const int tw_first = max(0, qw0 - window + 1) / kSwaKeys;
  const int tw_last = qw_last / kSwaKeys;
  unsigned char* qw = qs + wg * kTile;

  // Q rows of warpgroup w's tile: row r = (position - (q0 + w per_wg)) * R
  // + head-in-group for r < live; rows past live are dead (zero-filled)
  const int live = per_wg * R;
  for (int i = tid; i < kSwaWgs * kSwaRows * kChunks; i += kSwaThreads) {
    const int w = i / (kSwaRows * kChunks);
    const int r = (i / kChunks) % kSwaRows, ch = i % kChunks;
    const int pos = q0 + w * per_wg + r / R;
    const bool ok = r < live && pos < S && ch * 8 < D;
    const bf16* src = ok ? q + (((long)b * S + pos) * H + (long)g * R +
                                r % R) * D + ch * 8
                         : q;
    cp_async16(qs + w * kTile + swz(r, ch), src, ok);
  }
  auto load_kv = [&](int tile, int st) {
    const int key0 = tile * kSwaKeys;
    for (int i = tid; i < kSwaKeys * kChunks; i += kSwaThreads) {
      const int row = i / kChunks, ch = i % kChunks;
      const int key = key0 + row;
      const bool ok = key < S && ch * 8 < D;
      const long off = ok ? (((long)b * S + key) * KV + g) * D + ch * 8 : 0;
      cp_async16(ks + st * kTile + swz(row, ch), k + off, ok);
      cp_async16(vs + st * kTile + swz(row, ch), v + off, ok);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kSwaStages; ++i) {
      mbar_init(&full[i], kSwaThreads);
      mbar_init(&empty[i], kSwaThreads / 32);
    }
  }
  __syncthreads();
  load_kv(t_first, 0);
  mbar_arrive_on_copies(&full[0]);   // the Q copies land with stage 0

  // accumulator fragment: this thread's rows r0, r1 = r0 + 8 and, in each
  // 8-column group j, columns 8j + cq and 8j + cq + 1 (a dead row's p is
  // past its tile's positions; it is never stored)
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;
  const int p0 = qw0 + r0 / R, p1 = qw0 + r1 / R;
  const int cq = 2 * (lane & 3);
  float o[kNb][32];
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.0f;
  float m0 = kSwaNegInf, m1 = kSwaNegInf, l0 = 0.0f, l1 = 0.0f;
  constexpr float kLog2e = 1.4426950408889634f;
  const bool capped = softcap > 0.0f;

  // No block-wide barrier in the loop: the two warpgroups meet only at the
  // stage barriers, so one can run up to a tile ahead of the other and its
  // products overlap the other's softmax.
  for (int t = t_first; t <= t_last; ++t) {
    const int j = t - t_first, st = j % kSwaStages;
    if (t < t_last) {
      const int nx = (j + 1) % kSwaStages;
      if (j + 1 >= kSwaStages)   // tile j + 1 - kSwaStages has left stage nx
        mbar_wait(&empty[nx], ((j + 1 - kSwaStages) / kSwaStages) & 1);
      load_kv(t + 1, nx);
      mbar_arrive_on_copies(&full[nx]);
    }
    mbar_wait(&full[st], (j / kSwaStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // a warpgroup none of whose rows meets this tile only releases it
    if (qw0 < S && t >= tw_first && t <= tw_last) {
      // S = Q K^T
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kNb * 4; ++kk) {
        const int off = (kk >> 2) * kSwaBlock + (kk & 3) * 32;
        wgmma_ss(s, sw128_desc(qw + off, 16, 1024),
                 sw128_desc(ks + st * kTile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, cap, mask (edge tiles only), online softmax in registers, in
      // log2 units: y = score * log2(e), p = 2^(y - m) = e^(score - m / log2 e)
      const int key0 = t * kSwaKeys;
      const bool edge = key0 + kSwaKeys - 1 > qw0 ||
                        key0 <= qw_last - window || key0 + kSwaKeys > S;
      float mx0 = kSwaNegInf, mx1 = kSwaNegInf;
      // the score exactly as before (the library's tanhf, which the plain
      // version's torch.tanh also calls), then in log2 units
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float x = s[i] * score_mult;
        s[i] = (capped ? tanhf(x) * softcap : x) * kLog2e;
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = key0 + 8 * (i >> 2) + cq + (i & 1);
          const int pos = (i & 2) ? p1 : p0;
          if (!(key <= pos && pos - key < window && key < S && pos < S))
            s[i] = kSwaNegInf;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = mn0 == m0 ? 1.0f : fast_ex2(m0 - mn0);
      const float c1 = mn1 == m1 ? 1.0f : fast_ex2(m1 - mn1);
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float mn = (i & 2) ? mn1 : mn0;
        float p = fast_ex2(s[i] - mn);
        if (edge && !(s[i] > kSwaNegInf / 2)) p = 0.0f;
        s[i] = p;
        if (i & 2) sum1 += p;
        else sum0 += p;
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      // O is rescaled only where a row's max moved (else the factor is 1)
      const bool moved = __any_sync(0xffffffffu, mn0 != m0 || mn1 != m1);
      m0 = mn0;
      m1 = mn1;
      // p in bf16 as the A fragments of four k16 steps over the tile's keys
      uint32_t pa[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      if (moved) {
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[nb][i] *= (i & 2) ? c1 : c0;
        }
      }
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) fence_regs(o[nb]);

      // O += P V
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb)
          wgmma_rs_tb(o[nb], pa + 4 * kk,
                      sw128_desc(vs + st * kTile + nb * kSwaBlock +
                                     kk * 16 * 128,
                                 kSwaBlock, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) fence_regs(o[nb]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with it
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const long h0 = (long)g * R;
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + cq;
      if (col < D) {
        if (r0 < live && p0 < S)
          *reinterpret_cast<float2*>(
              out + (((long)b * S + p0) * H + h0 + r0 % R) * D + col) =
              make_float2(o[nb][4 * j] / d0, o[nb][4 * j + 1] / d0);
        if (r1 < live && p1 < S)
          *reinterpret_cast<float2*>(
              out + (((long)b * S + p1) * H + h0 + r1 % R) * D + col) =
              make_float2(o[nb][4 * j + 2] / d1, o[nb][4 * j + 3] / d1);
      }
    }
  }
}

template <int kNb>
int launch_swa(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KV, int D, int window, float score_mult,
               float softcap, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      swa_kernel<kNb>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)swa_smem_bytes(kNb));
  if (attr != cudaSuccess) return (int)attr;
  const int per_block = kSwaWgs * (kSwaRows / (H / KV));
  const long blocks = (long)((S + per_block - 1) / per_block) * B * KV;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  swa_kernel<kNb><<<(unsigned)blocks, kSwaThreads, swa_smem_bytes(kNb),
                    st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                          (float*)out, B, S, H, KV, D, window, score_mult,
                          softcap);
  return (int)cudaGetLastError();
}

}  // namespace repro

// q (B, S, H, D), k/v (B, S, KV, D) bf16; out (B, S, H, D) fp32. H / KV
// at most 64, D a multiple of 16 up to 256, 1 <= window <= S. Scores
// are q.k * score_mult, then tanh(.) * softcap when softcap > 0: the caller
// passes 1/sqrt(D), or with a softcap the fp32 (1/sqrt(D)) / softcap, the
// one multiply XLA makes of the reference's q.k * scale / softcap.
extern "C" int repro_sliding_window_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int KV, int D, int window, float score_mult, float softcap,
    void* stream) {
  using namespace repro;
  if (KV < 1 || H % KV || H / KV > kSwaRows || D % 16 || D > 256 ||
      D < 16 || window < 1 || S < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((D + 63) / 64) {
    case 1: return launch_swa<1>(q, k, v, out, B, S, H, KV, D, window,
                                 score_mult, softcap, st);
    case 2: return launch_swa<2>(q, k, v, out, B, S, H, KV, D, window,
                                 score_mult, softcap, st);
    case 3: return launch_swa<3>(q, k, v, out, B, S, H, KV, D, window,
                                 score_mult, softcap, st);
    default: return launch_swa<4>(q, k, v, out, B, S, H, KV, D, window,
                                  score_mult, softcap, st);
  }
}
