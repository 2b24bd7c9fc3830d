// Fused block-CSC MLP: out = (act(x Wg) * (x Wu)) Wd in one launch, the
// hidden rounded to bf16 before the down-projection.
//
// Replaces: src/repro/kernels/bcsc_mlp.py::bcsc_mlp_raw (Pallas bodies
// _mlp_kernel and _mlp_kernel_unrolled; the unrolled variant is a TPU
// compile artefact and the port computes the one function).
//
// Bound on Hopper: bytes of the three packed weight streams (each real
// block read once per call), at the decode and short-prefill widths it is
// called at (Mp <= 64 rows per launch).
//
// The TPU kernel keeps the (bm, d_ff) fp32 hidden in VMEM; at bm = 64,
// d_ff = 11008 gate plus up is 5.6 MB, far beyond one SM's 227 KB of shared
// memory. What keeps the point of that kernel (one launch, the hidden never
// making a round trip through device memory) is one cooperative launch with
// a grid-wide barrier, the hidden kept in a bf16 device workspace that stays
// in the 50 MB L2. Design:
// * Tensor cores with the rows as the MMA's N (swap-AB). mma.sync m16n8k16
//   takes A = a weight block transposed (16 output columns x 16 k, by
//   ldmatrix .trans from shared memory) and B = 8 rows of x x 16 k; the
//   NT = Mp / 8 products of a block share its A fragment, so every real
//   block is read from device memory once per call at every Mp <= 64.
//   (wgmma would serialise inside this data-dependent walk.)
// * A warp-private cp.async ring (common.cuh WarpWalk, which the GEMV
//   walks too). Each warp streams its blocks through a ring of its own in
//   shared memory: per block one 16-byte copy a lane (512 bytes) and the
//   block-row's 16-column slice of x (Mp x 32 bytes, rows past Mp
//   zero-filled), kStages blocks ahead of the one it
//   multiplies; the ring is about 12 KB a warp, 16 warps an SM, as one
//   block (the grid barrier then meets 132 blocks, not 264). Row ids come 32
//   at a time, one batch ahead, so no copy waits on an index load.
//   Copies are .cg: they read L2 only, which phase 2 needs (the hidden was
//   written by other SMs).
// * Phase 1 (gate and up): pair p of warps owns hidden block-columns p,
//   p + pairs, ...; pairs are numbered across thread blocks first, so the
//   columns spread over every SM. The column's items (its gate segment,
//   then its up segment) are cut in two halves, one a warp, each walked into
//   two register accumulators; the second half's sums are added to the
//   first's through shared memory, and act(g) * u is taken in fp32 and
//   rounded once to the bf16 hidden. (With one warp a column, phase 1 was
//   bound by the longest columns' serial walks, most warps idle.)
// * Grid barrier, re-armed by a generation count in a word the wrapper
//   allocates once per device and stream (no fill launch per call).
// * Phase 2 (down): output block-column c's segment is cut into ``split``
//   parts of equal block counts (kernels/bcsc_mlp.py::mlp_plan picks split
//   from shapes so that columns x split fill the grid's warps), one part a
//   warp. A warp issues its part's first down blocks before the barrier
//   (they do not depend on phase 1), so they load while phase 1 finishes.
//   Each part's fp32 partial goes to a workspace; the warp that arrives
//   last at the column's counter (which it then re-zeroes) adds the
//   partials in split order and stores the column. No float atomics: two
//   calls give equal bits.
// Blocks at or past the layer's counts[i] are pads and are skipped; empty
// segments give zero sums.
// What still holds it back (scripts/ablate_kernels_torch.py, parts removed;
// PERF.md has the times): the launch, the index loads and the grid barrier
// take a quarter of a call at 8 rows; neither a ring of half the depth nor
// slots of two blocks changes the walks' time, so they are bound neither
// by bytes in flight nor by the per-slot copy and wait work; at 64 rows
// the last part's in-order sum of the partials is a chain of round trips
// to L2.
#include "common.cuh"

namespace repro {

constexpr int kMlpWarps = 16;                 // warps of a thread block
constexpr int kMlpThreads = 32 * kMlpWarps;
constexpr int kMlpBlocksPerSm = 1;            // kernels/bcsc_mlp.py plans for it

// Dynamic shared memory of a thread block: one walk ring a warp.
template <int NT>
constexpr int mlp_smem() {
  return WalkRing<NT>::kWarpBytes * kMlpWarps;
}

// Segment [lo, hi) of block-column c, cut at the real block count.
__device__ __forceinline__ void segment(const int* ptr, int c, int count,
                                        int* lo, int* hi) {
  *hi = min(ptr[c + 1], count);
  *lo = min(ptr[c], *hi);
}

// Barrier ``id`` (1..15) of ``threads`` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Grid barrier over words[0] (arrivals, back to 0 at every release) and
// words[1] (a generation count). The cooperative launch guarantees that
// every block of the grid is resident.
__device__ __forceinline__ void grid_barrier(unsigned* words) {
  volatile unsigned* gen = words + 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(words, 1u) == gridDim.x - 1) {
      atomicExch(words, 0u);
      __threadfence();
      atomicAdd(words + 1, 1u);
    } else {
      // a grid that is not all resident never meets: trap after seconds
      for (unsigned n = 0; *gen == g; ++n) {
        __nanosleep(64);
        if (n == (1u << 26)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The walk of phase-2 task ``task`` (output block-column task / split, part
// task % split of its segment, cut at equal block counts); empty past the
// last task.
template <int NT>
__device__ WarpWalk<NT> down_walk(const bf16* d_blk, const int* d_rows,
                                  const int* d_ptr, int n_d, int task,
                                  int tasks, int split, unsigned char* ring) {
  int lo = 0, hi = 0;
  if (task < tasks) {
    const int c = task / split, s = task % split;
    int dlo, dhi;
    segment(d_ptr, c, n_d, &dlo, &dhi);
    const long nd = dhi - dlo;
    lo = dlo + (int)(nd * s / split);
    hi = dlo + (int)(nd * (s + 1) / split);
  }
  return WarpWalk<NT>(d_blk, d_rows, lo, hi - lo, nullptr, nullptr, 0, 0,
                      ring);
}

// words: [0, 2) the grid barrier, [2, 2 + n_out / 16) the phase-2 column
// counters (zero at entry, left zero). ws: (n_out / 16) * split * NT * 128
// fp32 partials when split > 1.
template <int NT>
__global__ void __launch_bounds__(kMlpThreads, kMlpBlocksPerSm)
    bcsc_mlp_kernel(const bf16* __restrict__ x, int Mp, int K,
                    const bf16* __restrict__ g_blk,
                    const int* __restrict__ g_rows,
                    const int* __restrict__ g_ptr,
                    const bf16* __restrict__ u_blk,
                    const int* __restrict__ u_rows,
                    const int* __restrict__ u_ptr,
                    const bf16* __restrict__ d_blk,
                    const int* __restrict__ d_rows,
                    const int* __restrict__ d_ptr,
                    const int* __restrict__ counts, int act, int d_ff,
                    int n_out, bf16* hidden, float* __restrict__ out,
                    float4* ws, unsigned* words, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* ring = smem + warp * WalkRing<NT>::kWarpBytes;
  const int n_warps = gridDim.x * kMlpWarps;
  const int gw = warp * gridDim.x + blockIdx.x;   // across blocks first
  const bool gated = u_blk != nullptr;
  const int n_g = counts[0], n_u = counts[1], n_d = counts[2];
  const int g = lane >> 2, t4 = lane & 3;
  float acc0[NT][4], acc1[NT][4];

  // phase 1: hidden block-columns, one a pair of warps (2p, 2p + 1 of a
  // block; pairs numbered across blocks first). The column's items, its
  // gate blocks then its up blocks, are cut in two halves, half h walked by
  // warp 2p + h; the second half's sums meet the first's in shared memory
  // (warp 2p + 1's ring, free by then) and are added after them.
  const int half = warp & 1, pair_bar = 1 + (warp >> 1);
  const int n_pairs = gridDim.x * (kMlpWarps / 2);
  float4* xch = reinterpret_cast<float4*>(
      smem + (warp | 1) * WalkRing<NT>::kWarpBytes);
  for (int c = (warp >> 1) * gridDim.x + blockIdx.x; c < d_ff / 16;
       c += n_pairs) {
    int glo, ghi, ulo = 0, uhi = 0;
    segment(g_ptr, c, n_g, &glo, &ghi);
    if (gated) segment(u_ptr, c, n_u, &ulo, &uhi);
    const int ng = ghi - glo, n = ng + uhi - ulo;
    const int a = half ? n / 2 : 0, b = half ? n : n / 2;   // items [a, b)
    const int ga = min(a, ng), gb = min(b, ng);
    const int ua = max(a, ng) - ng, ub = max(b, ng) - ng;
    WarpWalk<NT>(g_blk, g_rows, glo + ga, gb - ga, u_blk, u_rows, ulo + ua,
                 ub - ua, ring)
        .run(x, K, Mp, false, acc0, acc1);
    if (half) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        xch[(2 * t) * 32 + lane] =
            make_float4(acc0[t][0], acc0[t][1], acc0[t][2], acc0[t][3]);
        xch[(2 * t + 1) * 32 + lane] =
            make_float4(acc1[t][0], acc1[t][1], acc1[t][2], acc1[t][3]);
      }
    }
    named_barrier(pair_bar, 64);
    if (!half) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float4 gv = xch[(2 * t) * 32 + lane];
        const float4 uv = xch[(2 * t + 1) * 32 + lane];
        const float gs[4] = {acc0[t][0] + gv.x, acc0[t][1] + gv.y,
                             acc0[t][2] + gv.z, acc0[t][3] + gv.w};
        const float us[4] = {acc1[t][0] + uv.x, acc1[t][1] + uv.y,
                             acc1[t][2] + uv.z, acc1[t][3] + uv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * t + 2 * t4 + (e & 1), col = g + 8 * (e >> 1);
          float h = epilogue(gs[e], 0.0f, act);
          if (gated) h *= us[e];
          if (m < Mp)
            hidden[(long)m * d_ff + c * 16 + col] = __float2bfloat16(h);
        }
      }
    }
    named_barrier(pair_bar, 64);   // warp 2p + 1's ring is free again
  }

  // phase 2: (output block-column, split part) tasks over the hidden. The
  // down blocks of this warp's first task do not depend on phase 1: they
  // are in flight across the barrier.
  const int n_cols = n_out / 16, tasks = n_cols * split;
  unsigned* cnt = words + 2;
  WarpWalk<NT> walk =
      down_walk<NT>(d_blk, d_rows, d_ptr, n_d, gw, tasks, split, ring);
  walk.prefetch_blocks();

  grid_barrier(words);

  for (int task = gw; task < tasks; task += n_warps) {
    const int c = task / split;
    if (task != gw)
      walk = down_walk<NT>(d_blk, d_rows, d_ptr, n_d, task, tasks, split,
                           ring);
    walk.run(hidden, d_ff, Mp, task == gw, acc0, acc1);
    if (split > 1) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
        __stcg(ws + ((long)task * NT + t) * 32 + lane,
               make_float4(acc0[t][0], acc0[t][1], acc0[t][2], acc0[t][3]));
      __threadfence();
      __syncwarp();
      unsigned last = 0;
      if (lane == 0) last = atomicAdd(cnt + c, 1u) == (unsigned)split - 1;
      if (!__shfl_sync(0xffffffffu, last, 0)) continue;
      // the column's last part: every partial, in split order
      __threadfence();
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc0[t][e] = 0.0f;
      for (int s2 = 0; s2 < split; ++s2) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float4 v =
              __ldcg(ws + ((long)(c * split + s2) * NT + t) * 32 + lane);
          acc0[t][0] += v.x;
          acc0[t][1] += v.y;
          acc0[t][2] += v.z;
          acc0[t][3] += v.w;
        }
      }
      if (lane == 0) cnt[c] = 0;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * t + 2 * t4 + (e & 1), col = g + 8 * (e >> 1);
        if (m < Mp) out[(long)m * n_out + c * 16 + col] = acc0[t][e];
      }
  }
}

template <int NT>
int launch_mlp(void** args, int grid, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bcsc_mlp_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mlp_smem<NT>());
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bcsc_mlp_kernel<NT>, kMlpThreads, mlp_smem<NT>());
  if (e != cudaSuccess) return (int)e;
  // the whole grid must be resident for the barrier
  if (grid < 1 || grid > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel((const void*)bcsc_mlp_kernel<NT>,
                                  dim3(grid), dim3(kMlpThreads), args,
                                  mlp_smem<NT>(), st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace repro

// x (Mp, K) bf16 with Mp a multiple of 8 up to 64; u_* null for an ungated
// MLP; counts (3,) int32 [n_g, n_u, n_d]; hidden (Mp, d_ff) bf16 workspace;
// out (Mp, n_out) fp32; ws the phase-2 partials (see bcsc_mlp_kernel);
// words >= 2 + n_out / 16 uint32, zero but for the barrier's generation;
// grid thread blocks (all resident) and split from
// kernels/bcsc_mlp.py::mlp_plan.
extern "C" int repro_bcsc_mlp(
    const void* x, int Mp, int K, const void* g_blk, const void* g_rows,
    const void* g_ptr, const void* u_blk, const void* u_rows,
    const void* u_ptr, const void* d_blk, const void* d_rows,
    const void* d_ptr, const void* counts, int act, int d_ff, int n_out,
    void* hidden, void* out, void* ws, void* words, int grid, int split,
    void* stream) {
  using namespace repro;
  if (Mp < 8 || Mp > 64 || Mp % 8 || K % 16 || d_ff % 16 || n_out % 16 ||
      split < 1 || (split > 1 && ws == nullptr) || words == nullptr)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x,      (void*)&Mp,     (void*)&K,
                  (void*)&g_blk,  (void*)&g_rows, (void*)&g_ptr,
                  (void*)&u_blk,  (void*)&u_rows, (void*)&u_ptr,
                  (void*)&d_blk,  (void*)&d_rows, (void*)&d_ptr,
                  (void*)&counts, (void*)&act,    (void*)&d_ff,
                  (void*)&n_out,  (void*)&hidden, (void*)&out,
                  (void*)&ws,     (void*)&words,  (void*)&split};
  cudaStream_t st = (cudaStream_t)stream;
  if (Mp <= 8) return launch_mlp<1>(args, grid, st);
  if (Mp <= 16) return launch_mlp<2>(args, grid, st);
  if (Mp <= 32) return launch_mlp<4>(args, grid, st);
  return launch_mlp<8>(args, grid, st);
}
