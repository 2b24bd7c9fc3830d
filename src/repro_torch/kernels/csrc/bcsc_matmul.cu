// Block-CSC sparse matmuls: x (M, K) bf16 times a BCSC (K, N) weight of
// 16 x 16 bf16 blocks, fp32 out.
//
// Replaces: src/repro/kernels/bcsc_matmul.py::bcsc_matmul_raw (Pallas body
// _bcsc_kernel) with repro_bcsc_gemm, and bcsc_gemv_raw (body
// _bcsc_gemv_kernel) with repro_bcsc_gemv.
//
// The TPU kernels walk one grid step per non-zero block and revisit-
// accumulate each output tile along its column segment, which needs the
// sequential grid. Here a thread block owns output columns (one
// block-column for the GEMV, a group of 16 and an m-tile for the GEMM) and
// walks their segments of the column-major payload in ascending block-row
// order: no atomics, the same sum order on every run. Segment starts come
// from col_ptr, derived from the non-decreasing col_ids. Pad blocks repeat
// the last (row, col) with a zero payload and add nothing.
//
// GEMM (prefill, M > 8). At 0.25 block density a 16-column block of the
// output meets a quarter of the block-rows, so a kernel that feeds each
// product its own operands (PR 11's one 16x16x16 WMMA per block, A fetched
// from global memory by every 16-row warp) moves ~1 KB from L2 per 8 KFLOP
// and is bound by that traffic. Design:
// * Output tiles over column groups. A thread block owns a BM x 256 tile of
//   out (BM = 128, or 64 at M <= 64): kGemmGroup = 16 adjacent
//   block-columns, one warp each, fp32 accumulators in registers.
// * A merged walk down K. The block indexes its group's segments once per
//   chunk of kGemmChunk block-rows (all its threads scan the group's
//   contiguous payload; each (row, column) keeps the first block of a run
//   of equal rows, so a zero pad that repeats the last real pair adds
//   nothing and never displaces the real block), then walks, in ascending
//   order, the k-tiles of 8 block-rows (128 columns of x) in which its
//   columns hold a block. Per k-tile the BM x 128 tile of x is staged in
//   shared memory once and every present block multiplies its 16 columns:
//   x is read N / 256 times in all instead of once per block, each weight
//   block M / BM times instead of M / 16 times. Presence depends on the
//   weight alone, and only present blocks are multiplied (a dense B over
//   the group would redo the 4x work of a dense product).
// * The ring: kGemmStages k-tiles in shared memory, the next one in flight
//   while the warps multiply this one. The x tile comes by TMA (two boxes
//   of 64 columns, 128-byte swizzle; rows past M and columns past K read as
//   zero), issued by one thread once every warp has released the stage
//   ("empty" mbarrier) and completing on the "full" mbarrier by its byte
//   count. Each warp copies its own column's blocks of the k-tile by 16-byte
//   cp.async (32-byte swizzle) and waits for them itself, so only the x tile
//   needs block-wide barriers.
// * Tensor cores: mma.sync m16n8k16 (bf16 in, fp32 accumulate) from ldmatrix
//   fragments. Warp j loops over the rows at which its column has a block:
//   one B fragment load, the BM x 16 A fragments of that block-row, 2 BM / 16
//   independent products into its own accumulators. The accumulators are
//   fixed per warp, so the data-dependent part is a loop count, not a
//   branch between products.
// * How it got here (variants timed on the card): 8 warps of 32 x 128
//   accumulators each, branching per present block, waited on fragment
//   loads for most of each k-tile (a dense walk of 4x the products took no
//   longer) and spent as long again issuing copies; wgmma m64n16k16 per
//   present block is serialised by the compiler inside the presence
//   branches and costs the dense price when predicated; single-block TMA
//   copies are slow to issue; sharing each x tile between the two blocks of
//   a cluster by TMA multicast (half the L2 traffic) and persistent blocks
//   were slower, since per-step synchronisation, not L2 bandwidth, bounds
//   the walk.
// * A fixed sum order: each column's blocks in ascending block-row order,
//   no atomics. When the tiles alone do not fill the card (qwen2.5-3b's
//   down projection at M 512 makes 32), kernels/bcsc_matmul.py::gemm_plan
//   splits K; split s > 0 writes its partial to a workspace and a second
//   kernel adds the partials to split 0's in split order.
// * Edges: rows past M are zero-filled and not stored; the last group's
//   block-columns past N / 16 have empty segments and are not stored.
// What still holds it back: the per-k-tile synchronisation of 16 warps,
// a large share of the time even when nothing is copied or multiplied;
// each warp re-reads the A fragments of every block-row it multiplies from
// shared memory; the index of a chunk is built and the ring drained before
// its walk, and the fp32 tile written after it, with one block per SM.
//
// GEMV (decode, M <= 8, rows padded to 8). Bound: bytes of the weight
// stream, each real block read once (22,016 blocks, 11.7 MB at qwen2.5-3b's
// up projection: 0.0035 ms at 3.35 TB/s). Design, the fused MLP's warp
// walk carried over:
// * Work units. Block-column c's segment is cut into ``split`` parts of
//   equal block counts, one part a warp, a thread block per column;
//   kernels/bcsc_matmul.py::gemv_plan picks split (at most 16) from shapes
//   alone so that columns x split fill the card's warps (qwen2.5-3b: 688
//   columns x 3 at the up projection, 128 x 16 at the down projection,
//   whose ~162-block columns alone would leave most SMs idle). Small
//   blocks spread evenly over the SMs (blocks of several columns left a
//   few SMs with twice the work).
// * Each warp walks its part with common.cuh's WarpWalk: the blocks (one
//   16-byte cp.async a lane) and x's 16-column slice of each block-row (8
//   rows x 32 bytes) through a ring of kGemvStages slots in shared memory,
//   the part's first blocks issued before its row ids arrive; mma.sync
//   m16n8k16 with A = the block transposed (ldmatrix .trans) and B = the 8
//   rows of x, so the 8 rows are the MMA's N; fp32 accumulators in
//   registers. The grid first asks L2 for all of x and each lane for its
//   bias, so that neither waits behind the weight stream.
// * Combine: at split > 1 each part leaves its fp32 partial in its warp's
//   ring in shared memory, and after one block barrier part 0 adds them
//   in split order. At split 1 a column is flushed from registers. Bias
//   and the activation run once, at the flush (epilogue). No atomics: two
//   calls give equal bits. (Partials in global memory added by the last
//   part to arrive at a per-column counter, or by a second kernel, timed
//   slower: each costs round trips to L2.)
// * Ring depth: 4 slots a warp (a part holds ~11 blocks at qwen2.5-3b's
//   shapes); a deeper ring, more shared memory a block, timed slower.
// * Pads (zero blocks repeating the last (row, col)) are walked and add
//   nothing.
// What still holds it back (scripts/ablate_kernels_torch.py; PERF.md has
// the times): the launch of the grid is about 40 % of a call at
// qwen2.5-3b's shapes, and each part waits on three dependent loads
// (col_ptr, its row ids, then x's slices) while its blocks stream in.
#include "common.cuh"

namespace repro {

constexpr int kGemmGroup = 16;         // block-columns of a thread block
constexpr int kGemmTileRows = 8;       // block-rows of a k-tile: 128 columns
constexpr int kGemmStages = 2;         // k-tiles in the ring
constexpr int kGemmChunk = 256;        // block-rows indexed at a time
constexpr int kGemmTabStride = kGemmGroup + 1;   // ints per indexed row
constexpr int kGemmSlots = kGemmTileRows * kGemmGroup;   // blocks a stage holds

// Threads of a thread block: one warp per block-column of the group.
constexpr int kGemmThreads = 32 * kGemmGroup;

constexpr int kGemvRows = 8;          // rows of x: the MMA's N
constexpr int kGemvMaxWarps = 16;     // parts of a block-column, at most
constexpr int kGemvStages = 4;        // ring slots a warp
constexpr int kGemvMaxThreads = 32 * kGemvMaxWarps;
constexpr int kGemvRingBytes = kGemvStages * WalkRing<1>::kSlot;

// Dynamic shared memory of a thread block of BM = 64 kWg rows: the ring's x
// tiles and block slots, the chunk index (tab, rmask, tiles), and slack to
// align the x tiles to the 1024-byte swizzle atom.
template <int kWg>
constexpr size_t gemm_smem_bytes() {
  return (size_t)kGemmStages * (kWg * 64 * 256 + kGemmSlots * 512) +
         (size_t)kGemmChunk * (kGemmTabStride + 1) * 4 +
         (size_t)(kGemmChunk / kGemmTileRows) * 4 + 1024;
}

// A 16-byte cp.async global -> shared copy, if ``on``.
__device__ __forceinline__ void cp_async16_if(void* dst, const void* src,
                                              bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"((int)on)
      : "memory");
}

// Grid (column groups, m-tiles, K splits). Split z walks block-rows
// [z * rows_per_split, (z + 1) * rows_per_split) (rows_per_split a multiple
// of kGemmTileRows) and writes out (z = 0) or ws[z - 1] (M x N each).
// tm_x: x as (M rows, K columns) in boxes of 64 columns x BM rows, 128-byte
// swizzle. BM = 64 kWg.
template <int kWg>
__global__ void __launch_bounds__(kGemmThreads, 1) bcsc_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_x, int M, int K,
    const bf16* __restrict__ blocks, const int* __restrict__ row_ids,
    const int* __restrict__ col_ptr, float* __restrict__ out,
    float* __restrict__ ws, int N, int rows_per_split) {
  constexpr int kThreads = kGemmThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int kBM = 64 * kWg;
  constexpr int kXBytes = kBM * 256;    // one x tile: two kBM x 64 halves
  extern __shared__ unsigned char smem_raw[];
  // the x tiles' 128-byte swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(
                                                 smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                           // [stage][x tile]
  unsigned char* wsm = xs + kGemmStages * kXBytes;    // [stage][q][col][blk]
  int* tab = reinterpret_cast<int*>(wsm + kGemmStages * kGemmSlots * 512);
  unsigned* rmask =
      reinterpret_cast<unsigned*>(tab + kGemmChunk * kGemmTabStride);
  int* tiles = reinterpret_cast<int*>(rmask + kGemmChunk);
  __shared__ uint64_t full[kGemmStages], empty[kGemmStages];
  __shared__ int seg[kGemmGroup + 1];
  __shared__ int warp_n[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NB = N / 16, KB = K / 16;
  const int c0 = blockIdx.x * kGemmGroup, m0 = blockIdx.y * kBM;
  const int kb_lo = blockIdx.z * rows_per_split;
  const int kb_hi = min(KB, kb_lo + rows_per_split);
  // segment bounds of the group's columns; columns past NB are empty
  if (tid <= kGemmGroup) seg[tid] = col_ptr[min(c0 + tid, NB)];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kGemmStages; ++i) {
      // full: thread 0's expect_tx for the x tile; empty: one per warp
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // warp j owns block-column c0 + j: the tile's kMT m16 row tiles x its 16
  // columns (two 8-column halves)
  constexpr int kMT = 4 * kWg;
  float acc[kMT][2][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
  // ldmatrix: this lane's row within a 16-row operand, and its 16-byte half
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lh = lane >> 4;
  int gstep = 0;   // ring steps of earlier chunks (the barriers' phases)

  for (int r0 = kb_lo; r0 < kb_hi; r0 += kGemmChunk) {
    const int r1 = min(r0 + kGemmChunk, kb_hi);
    __syncthreads();   // the previous chunk's index is no longer read
    for (int e = tid; e < kGemmChunk * kGemmTabStride; e += kThreads)
      tab[e] = -1;
    __syncthreads();
    // index every block of the group's segments (one contiguous range of
    // the payload) whose block-row lies in [r0, r1)
    for (int i = seg[0] + tid; i < seg[kGemmGroup]; i += kThreads) {
      const int row = row_ids[i];
      if (row < r0 || row >= r1) continue;
      int j = 0;   // the column: the last j with seg[j] <= i
#pragma unroll
      for (int s = kGemmGroup / 2; s > 0; s >>= 1)
        if (seg[j + s] <= i) j += s;
      if (i > seg[j] && row_ids[i - 1] == row) continue;   // a repeat
      tab[(row - r0) * kGemmTabStride + j] = i;
    }
    __syncthreads();
    // presence mask of each block-row over the group's 16 columns
    for (int r = tid; r < kGemmChunk; r += kThreads) {
      unsigned m = 0;
      if (r < r1 - r0) {
#pragma unroll
        for (int j = 0; j < kGemmGroup; ++j)
          m |= (unsigned)(tab[r * kGemmTabStride + j] >= 0) << j;
      }
      rmask[r] = m;
    }
    __syncthreads();
    // the walk: the chunk's k-tiles in which any column of the group holds
    // a block, in ascending order
    const int n_tiles = (r1 - r0 + kGemmTileRows - 1) / kGemmTileRows;
    static_assert(kGemmChunk / kGemmTileRows <= 128, "a thread per k-tile");
    bool held = false;
    if (tid < n_tiles) {
#pragma unroll
      for (int q = 0; q < kGemmTileRows; ++q)
        held |= rmask[tid * kGemmTileRows + q] != 0;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, held);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int n_steps = 0, pos = __popc(bal & ((1u << lane) - 1));
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += warp_n[w];
      n_steps += warp_n[w];
    }
    if (held) tiles[pos] = tid;
    __syncthreads();

    // step s: the x tile of k-tile tiles[s], by two TMA copies of 64 columns
    // (thread 0, once every warp has released the stage), and each warp's
    // own blocks of it, by 16-byte cp.async (a lane a chunk), into stage
    // (gstep + s) % kGemmStages, kGemmStages - 1 steps ahead of the step
    // multiplied. A warp reads only the blocks it copied, so only the x
    // tile needs the block-wide mbarriers.
    auto issue = [&](int s) {
      const int g = gstep + s, st = g % kGemmStages;
      const int rl0 = tiles[s] * kGemmTileRows;
      if (tid == 0) {
        if (g >= kGemmStages)   // step g - kGemmStages has left the stage
          mbar_wait(&empty[st], (g / kGemmStages - 1) & 1);
        mbar_arrive_expect(&full[st], kXBytes);
        tma_load_2d(xs + st * kXBytes, &tm_x, (r0 + rl0) * 16, m0, &full[st]);
        tma_load_2d(xs + st * kXBytes + kXBytes / 2, &tm_x,
                    (r0 + rl0) * 16 + 64, m0, &full[st]);
      }
      unsigned char* wd = wsm + st * kGemmSlots * 512;
#pragma unroll
      for (int q = 0; q < kGemmTileRows; ++q) {
        const long i = max(tab[(rl0 + q) * kGemmTabStride + warp], 0);
        cp_async16_if(wd + (q * kGemmGroup + warp) * 512 +
                          swz32(lane >> 1, lane & 1),
                      blocks + i * 256 + (lane >> 1) * 16 + (lane & 1) * 8,
                      (rmask[rl0 + q] >> warp) & 1u);
      }
    };
    // one cp.async group per step, empty past the walk's end
    for (int s = 0; s < kGemmStages - 1; ++s) {
      if (s < n_steps) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < n_steps; ++s) {
      if (s + kGemmStages - 1 < n_steps) issue(s + kGemmStages - 1);
      cp_async_commit();
      const int g = gstep + s, st = g % kGemmStages;
      cp_async_wait<kGemmStages - 1>();   // this thread's blocks of step s
      __syncwarp();                        // and its warp's
      mbar_wait(&full[st], (g / kGemmStages) & 1);   // the x tile
      {
        const int rl0 = tiles[s] * kGemmTileRows;
        const unsigned char* xq = xs + st * kXBytes;
        unsigned rows = 0;   // tile rows at which this column has a block
#pragma unroll
        for (int q = 0; q < kGemmTileRows; ++q)
          rows |= ((rmask[rl0 + q] >> warp) & 1u) << q;
        for (; rows; rows &= rows - 1) {
          const int q = __ffs(rows) - 1;
          uint32_t b[4];   // n 0-7: b[0], b[1]; n 8-15: b[2], b[3]
          ldmatrix_x4_trans(
              b, wsm + (st * kGemmSlots + q * kGemmGroup + warp) * 512 +
                     swz32(lr, lh));
          uint32_t a[kMT][4];
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
            ldmatrix_x4(a[mi], xq + (q >> 2) * (kXBytes / 2) +
                                   swz128(16 * mi + lr, 2 * (q & 3) + lh));
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            mma_16816(acc[mi][0], a[mi], b[0], b[1]);
            mma_16816(acc[mi][1], a[mi], b[2], b[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with it
    }
    cp_async_wait<0>();
    gstep += n_steps;
  }

  // accumulator fragment: rows g and g + 8 of each m16 tile, columns 2t and
  // 2t + 1 of each 8-column half of the warp's block-column
  const int cb = c0 + warp;
  if (cb >= NB) return;
  float* dst = blockIdx.z == 0 ? out : ws + (long)(blockIdx.z - 1) * M * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    const int row = m0 + 16 * mi + g;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* p = dst + (long)row * N + cb * 16 + nt * 8 + 2 * t;
      if (row < M)
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[mi][nt][0], acc[mi][nt][1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(p + 8 * (long)N) =
            make_float2(acc[mi][nt][2], acc[mi][nt][3]);
    }
  }
}

// out += ws[0] + ws[1] + ... (n4 float4s each), in split order: one fixed
// sum order for a given plan.
__global__ void bcsc_gemm_combine_kernel(float4* __restrict__ out,
                                         const float4* __restrict__ ws,
                                         long n4, int parts) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 v = out[i];
    for (int s = 0; s < parts; ++s) {
      const float4 w = ws[(long)s * n4 + i];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    out[i] = v;
  }
}

template <int kWg>
int launch_gemm(const void* x, int M, int K, const void* blocks,
                const void* row_ids, const void* col_ptr, void* out, void* ws,
                int N, int split, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bcsc_gemm_kernel<kWg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gemm_smem_bytes<kWg>());
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tm_x;
  cudaError_t e = tensor_map(&tm_x, x, M, K, K, 64 * kWg, 64,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  // block-rows per split, whole k-tiles
  const int rows = ((K / 16 + split - 1) / split + kGemmTileRows - 1) /
                   kGemmTileRows * kGemmTileRows;
  const dim3 grid((N / 16 + kGemmGroup - 1) / kGemmGroup,
                  (M + 64 * kWg - 1) / (64 * kWg), split);
  bcsc_gemm_kernel<kWg><<<grid, kGemmThreads, gemm_smem_bytes<kWg>(),
                          st>>>(tm_x, M, K, (const bf16*)blocks,
                                (const int*)row_ids,
                                (const int*)col_ptr, (float*)out, (float*)ws,
                                N, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  const long n4 = (long)M * N / 4;
  const long n_blocks = (n4 + 255) / 256;
  bcsc_gemm_combine_kernel<<<(unsigned)(n_blocks < 4096 ? n_blocks : 4096),
                             256, 0, st>>>((float4*)out, (const float4*)ws,
                                           n4, split - 1);
  return (int)cudaGetLastError();
}

// A thread block owns block-column blockIdx.x: ``split`` warps, warp s
// walking part s of its segment, so that the partials meet in shared
// memory.
__global__ void __launch_bounds__(kGemvMaxThreads)
    bcsc_gemv_kernel(const bf16* __restrict__ x, int K,
                     const bf16* __restrict__ blocks,
                     const int* __restrict__ row_ids,
                     const int* __restrict__ col_ptr,
                     const float* __restrict__ bias, int act,
                     float* __restrict__ out, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int split = blockDim.x >> 5, c = blockIdx.x;
  // x into L2 at once, one 128-byte line a thread across the grid: the x
  // slices wait on the row ids and would otherwise queue behind the weight
  // stream in device memory
  const int x_lines = (kGemvRows * K * 2 + 127) / 128;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < x_lines;
       i += gridDim.x * blockDim.x)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
        reinterpret_cast<const char*>(x) + (long)i * 128));
  unsigned char* ring = smem + s * kGemvRingBytes;
  // this lane's output columns (acc[0][e]: row 2 (lane % 4) + (e & 1),
  // column lane / 4 + 8 (e >> 1)) and their bias, loaded now, used last
  const int col0 = c * 16 + (lane >> 2);
  const float b0 = bias != nullptr ? __ldg(bias + col0) : 0.0f;
  const float b1 = bias != nullptr ? __ldg(bias + col0 + 8) : 0.0f;
  const int lo = col_ptr[c], n = col_ptr[c + 1] - lo;
  const int a = lo + (int)((long)n * s / split);
  const int b = lo + (int)((long)n * (s + 1) / split);
  float acc[1][4], unused[1][4];
  WarpWalk<1, kGemvStages> walk(blocks, row_ids, a, b - a, nullptr, nullptr,
                                0, 0, ring);
  walk.prefetch_blocks();   // the blocks need no row id
  walk.run(x, K, kGemvRows, true, acc, unused);
  if (split > 1) {
    // each part's partial in its warp's ring (free after the walk); part 0
    // adds them in split order
    reinterpret_cast<float4*>(ring)[lane] =
        make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    __syncthreads();
    if (s != 0) return;
    for (int s2 = 1; s2 < split; ++s2) {
      const float4 v = reinterpret_cast<const float4*>(
          smem + s2 * kGemvRingBytes)[lane];
      acc[0][0] += v.x;
      acc[0][1] += v.y;
      acc[0][2] += v.z;
      acc[0][3] += v.w;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[(long)(2 * (lane & 3) + (e & 1)) * N + col0 + 8 * (e >> 1)] =
        epilogue(acc[0][e], e < 2 ? b0 : b1, act);
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) bf16 with M a multiple of 16; blocks (nnzb, 16, 16) bf16; out
// (M, N) fp32; ws holds (split - 1) * M * N fp32 partials when split > 1
// (else it may be null). bm (64 or 128) and split come from
// kernels/bcsc_matmul.py::gemm_plan.
extern "C" int repro_bcsc_gemm(const void* x, int M, int K,
                               const void* blocks, const void* row_ids,
                               const void* col_ptr, void* out, void* ws,
                               int N, int bm, int split, void* stream) {
  using namespace repro;
  if (M < 16 || M % 16 || K < 16 || K % 16 || N < 16 || N % 16 ||
      split < 1 || split > K / 16 ||
      (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bm) {
    case 64:
      return launch_gemm<1>(x, M, K, blocks, row_ids, col_ptr, out, ws, N,
                            split, st);
    case 128:
      return launch_gemm<2>(x, M, K, blocks, row_ids, col_ptr, out, ws, N,
                            split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x (8, K) bf16; bias (N,) fp32 or null; out (8, N) fp32; split (1 to
// kGemvMaxWarps parts a block-column) from kernels/bcsc_matmul.py::gemv_plan.
extern "C" int repro_bcsc_gemv(const void* x, int K, const void* blocks,
                               const void* row_ids, const void* col_ptr,
                               const void* bias, int act, void* out, int N,
                               int split, void* stream) {
  using namespace repro;
  if (K % 16 || N % 16 || N < 16 || split < 1 || split > kGemvMaxWarps)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      bcsc_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGemvMaxWarps * kGemvRingBytes);
  if (attr != cudaSuccess) return (int)attr;
  bcsc_gemv_kernel<<<N / 16, 32 * split, split * kGemvRingBytes,
                     (cudaStream_t)stream>>>(
      (const bf16*)x, K, (const bf16*)blocks, (const int*)row_ids,
      (const int*)col_ptr, (const float*)bias, act, (float*)out, N);
  return (int)cudaGetLastError();
}
