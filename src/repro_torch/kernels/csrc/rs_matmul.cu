// Dense (M, K) x (K, N) matmul with bf16 operands, an fp32 accumulator held
// across the whole K loop and the fused bias + activation epilogue at its
// flush; out fp32 or bf16.
//
// Replaces: src/repro/kernels/rs_matmul.py::rs_matmul_raw (Pallas body
// _rs_matmul_kernel), the row-stationary kernel whose (bm, bn) fp32 psum
// tile stays in VMEM while x and w tiles stream past it.
//
// Bound on Hopper: operations at prefill-sized M (512 x 2304 x 9216 is
// 2.2e10 flops, 0.022 ms at 989 TFLOP/s, against 63 MB, 0.019 ms at
// 3.35 TB/s), bytes of w at decode-sized M.
//
// Two arms, both reading x and w where they lie (TMA maps over the caller's
// row strides; rows, columns and k past the matrix read as zeros, stores
// are predicated), so nothing is padded or copied:
// * M > 16: the tensor-core arm. Persistent thread blocks, one an SM, walk
//   128 x 128 output tiles (m fastest, so the blocks in flight share each
//   w column tile through L2). A producer thread keeps a ring of
//   kRsStages k-tiles full by TMA: x as 128 rows x 64 k (K-major, 128-byte
//   swizzle) and w as two boxes of 64 k x 64 columns (MN-major), completing
//   on the stage's "full" mbarrier; it refills a stage once all eight
//   consumer warps have arrived on its "empty" one. Two consumer
//   warpgroups each own 64 rows of the tile and run wgmma m64n128k16 from
//   shared memory (w as the transposed B), fp32 accumulators in registers,
//   one k-tile's group in flight while the next is issued; the ring runs
//   on across tiles. At a tile's end the consumers stage their fp32
//   accumulators in shared memory and go on to the next tile's products;
//   seven epilogue warps apply bias and the activation to the staged tile
//   in coalesced float4 chunks and store them to the fp32 or bf16 output,
//   so the epilogue overlaps the next tile's products. At 512 x 9216,
//   128 x 128 makes 288 tiles, 2.18 tiles' work a block (128 x 192 timed no
//   faster): the two full rounds run whole, and the 24 tiles of the last,
//   partial round are split in K into 5 parts, one a block
//   (kernels/rs_matmul.py::wgmma_plan), so the busiest block does 2.2
//   tiles' work, not 3. A part's raw fp32 tile goes to a workspace, and a
//   second kernel adds each split tile's parts in order, applies the
//   epilogue and stores.
// * M <= 16: the weight-streaming arm, bound by w's bytes. Units of 64
//   columns x 256 k rows (32 KB of w) are dealt round-robin to persistent
//   thread blocks, one an SM, each with a four-stage TMA ring (the w box
//   and x's 16 rows of the same k). Four warps each multiply 16 columns
//   with mma.sync m16n8k16, the rows as the MMA's N (swap-AB: A = the w
//   slice transposed by ldmatrix .trans, B = x), so no row is padded past
//   16. Units go k chunk first, so the blocks in flight read whole rows of
//   w. A unit's fp32 partial goes to a workspace, one M x N plane per k
//   chunk, and a second kernel adds the planes in k order, applies the
//   epilogue and stores. No float atomics: two calls give equal bits.
// What still holds it back (scripts/ablate_kernels_torch.py, parts removed;
// PERF.md has the times): the tensor-core arm's loads are bound by the
// ring's depth, and the staged tile takes the shared memory more stages
// would need.
#include "common.cuh"

namespace repro {

// ---------------------------------------------------- tensor-core arm
constexpr int kRsBM = 128, kRsBN = 128, kRsBK = 64;
constexpr int kRsStages = 4;
constexpr int kRsThreads = 512;   // producer and epilogue warps, 2 consumer
                                  // warpgroups, 4 more epilogue warps
constexpr int kRsEpiWarps = 7;
constexpr int kRsXBytes = kRsBM * kRsBK * 2;      // 16 KB
constexpr int kRsWBox = kRsBK * 128;              // one 64-column box of w
constexpr int kRsWBytes = kRsBK * kRsBN * 2;      // kRsBN / 64 boxes
constexpr int kRsStageBytes = kRsXBytes + kRsWBytes;
constexpr int kRsEpiStride = kRsBN + 8;   // floats a staged row (no bank
                                          // conflicts on the fragment writes)
constexpr int kRsSmem =                    // the ring, the staged tile, slack
    kRsStages * kRsStageBytes + kRsBM * kRsEpiStride * 4 + 1024;

// d (64 x 128 fp32) += A (64 x 16, smem, K-major) * B (16 x 128, smem,
// MN-major).
__device__ __forceinline__ void wgmma_tb(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Bias + activation of output (row, col), stored if inside (M, N).
__device__ __forceinline__ void store_one(void* out, int out_bf16, int M,
                                          int N, int row, int col, float v,
                                          const float* bias, int act) {
  if (row >= M || col >= N) return;
  v = epilogue(v, bias != nullptr ? bias[col] : 0.0f, act);
  const long o = (long)row * N + col;
  if (out_bf16)
    reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(out)[o] = v;
}

// The same for (row, col) and (row, col + 1), as one store where N is
// even (col always is).
__device__ __forceinline__ void store_pair(void* out, int out_bf16, int M,
                                           int N, int row, int col, float v0,
                                           float v1, const float* bias,
                                           int act) {
  if (row >= M || col >= N) return;
  if ((N & 1) || col + 1 >= N) {
    store_one(out, out_bf16, M, N, row, col, v0, bias, act);
    store_one(out, out_bf16, M, N, row, col + 1, v1, bias, act);
    return;
  }
  v0 = epilogue(v0, bias != nullptr ? bias[col] : 0.0f, act);
  v1 = epilogue(v1, bias != nullptr ? bias[col + 1] : 0.0f, act);
  const long o = (long)row * N + col;
  if (out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(out) + o) =
        __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) =
        make_float2(v0, v1);
}

// The four bias values of columns col..col + 3 where store4 takes its one
// vector store (else zeros: store4 reads the bias itself then).
__device__ __forceinline__ float4 bias4(const float* bias, int N, int col) {
  if (bias == nullptr || (N & 3) || col + 3 >= N)
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return *reinterpret_cast<const float4*>(bias + col);
}

// The same for four neighbouring outputs (col a multiple of 4) with their
// bias b (bias4), as one store where the row holds all four and N is a
// multiple of 4.
__device__ __forceinline__ void store4(void* out, int out_bf16, int M, int N,
                                       int row, int col, float4 v, float4 b,
                                       const float* bias, int act) {
  if (row >= M || col >= N) return;
  if ((N & 3) || col + 3 >= N) {
    store_pair(out, out_bf16, M, N, row, col, v.x, v.y, bias, act);
    store_pair(out, out_bf16, M, N, row, col + 2, v.z, v.w, bias, act);
    return;
  }
  v.x = epilogue(v.x, b.x, act);
  v.y = epilogue(v.y, b.y, act);
  v.z = epilogue(v.z, b.z, act);
  v.w = epilogue(v.w, b.w, act);
  const long o = (long)row * N + col;
  if (out_bf16) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                           __floats2bfloat162_rn(v.z, v.w)};
    *reinterpret_cast<uint2*>(reinterpret_cast<bf16*>(out) + o) =
        *reinterpret_cast<const uint2*>(h);
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o) = v;
  }
}

// One item of a block's work: output tile ``tile``, k-tiles [k0, k1), and
// ``unit`` >= 0 when it is a stream-K part whose raw fp32 partial goes to
// the workspace, -1 for a whole tile stored through the epilogue.
struct RsWork {
  int tile, k0, k1, unit;
};

// Item i of this block: the data-parallel tiles b, b + grid, ... below
// n_dp, then, when the last round is split (parts > 1), stream-K unit u =
// b: part u % parts of tile n_dp + u / parts. False past the last item.
__device__ __forceinline__ bool rs_work(int i, int n_dp, int sk_units,
                                        int parts, int nk, RsWork* w) {
  const int b = blockIdx.x, grid = gridDim.x;
  const int t = b + i * grid;
  if (t < n_dp) {
    *w = RsWork{t, 0, nk, -1};
    return true;
  }
  if (b >= sk_units || i != (n_dp - b + grid - 1) / grid) return false;
  const int p = b % parts;
  *w = RsWork{n_dp + b / parts, p * nk / parts, (p + 1) * nk / parts, b};
  return true;
}

__global__ void __launch_bounds__(kRsThreads, 1) rs_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
    int act, void* __restrict__ out, int out_bf16, int M, int K, int N,
    float* __restrict__ sk_ws, int parts) {
  static_assert(kRsBN == 4 * 32, "an epilogue lane takes 4 columns");
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(
                                                 smem_raw) & 1023)) & 1023);
  // full / empty: the ring's stages; staged: the consumers' fragments of a
  // tile are in stg (one arrival per consumer warp); drained: the epilogue
  // warps have stored them (one arrival per epilogue warp). Warpgroup 0 is
  // the producer thread and three epilogue warps, 1 and 2 the consumers, 3
  // four more epilogue warps.
  __shared__ uint64_t full[kRsStages], empty[kRsStages], staged, drained;
  float* stg = reinterpret_cast<float*>(smem + kRsStages * kRsStageBytes);
  const int tid = threadIdx.x, lane = tid & 31;
  const int tiles_m = (M + kRsBM - 1) / kRsBM;
  const int tiles = tiles_m * ((N + kRsBN - 1) / kRsBN);
  const int nk = (K + kRsBK - 1) / kRsBK;
  // the last, partial round of tiles is split in K over every block
  const int n_split = parts > 1 ? tiles % gridDim.x : 0;
  const int n_dp = tiles - n_split, sk_units = n_split * parts;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kRsStages; ++i) {
      mbar_init(&full[i], 1);    // the producer's expect_tx
      mbar_init(&empty[i], 8);   // one arrival per consumer warp
    }
    mbar_init(&staged, 8);
    mbar_init(&drained, kRsEpiWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp_id = tid >> 5;
  if (warp_id == 0) {   // one thread issues every copy
    if (lane != 0) return;
    int g = 0;
    RsWork w;
    for (int i = 0; rs_work(i, n_dp, sk_units, parts, nk, &w); ++i) {
      const int m0 = (w.tile % tiles_m) * kRsBM;
      const int n0 = (w.tile / tiles_m) * kRsBN;
      for (int kt = w.k0; kt < w.k1; ++kt, ++g) {
        const int st = g % kRsStages;
        if (g >= kRsStages)   // step g - kRsStages has left the stage
          mbar_wait(&empty[st], (g / kRsStages - 1) & 1);
        unsigned char* xs = smem + st * kRsStageBytes;
        unsigned char* ws = xs + kRsXBytes;
        mbar_arrive_expect(&full[st], kRsStageBytes);
        tma_load_2d(xs, &tm_x, kt * kRsBK, m0, &full[st]);
#pragma unroll
        for (int b = 0; b < kRsBN / 64; ++b)
          tma_load_2d(ws + b * kRsWBox, &tm_w, n0 + 64 * b, kt * kRsBK,
                      &full[st]);
      }
    }
    return;
  }
  if (warp_id < 4 || warp_id >= 12) {
    // Epilogue warp e (0..6): lane l always takes the float4 of columns
    // 4l..4l + 3 (their bias is read once a tile), rows e, e + 7, ...; the
    // loop is not unrolled, so the activation's code is held once.
    const int e = warp_id < 4 ? warp_id - 1 : warp_id - 9;
    // Applied by the consumers it would keep the tensor cores idle while it
    // runs; unrolled over their accumulator registers it would inline the
    // activation 64 times a tile.
    RsWork w;
    for (int j = 0; rs_work(j, n_dp, sk_units, parts, nk, &w); ++j) {
      const int m0 = (w.tile % tiles_m) * kRsBM;
      const int col = (w.tile / tiles_m) * kRsBN + 4 * lane;
      const float4 b = bias4(bias, N, col);
      mbar_wait(&staged, j & 1);
      if (w.unit < 0) {
#pragma unroll 1
        for (int row = e; row < kRsBM; row += kRsEpiWarps)
          store4(out, out_bf16, M, N, m0 + row, col,
                 *reinterpret_cast<const float4*>(stg + row * kRsEpiStride +
                                                  4 * lane),
                 b, bias, act);
      } else {   // a stream-K part: the raw tile, for rs_sk_combine_kernel
        float* part = sk_ws + (long)w.unit * kRsBM * kRsBN + 4 * lane;
#pragma unroll 1
        for (int row = e; row < kRsBM; row += kRsEpiWarps)
          __stcg(reinterpret_cast<float4*>(part + row * kRsBN),
                 *reinterpret_cast<const float4*>(stg + row * kRsEpiStride +
                                                  4 * lane));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&drained);
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = (tid >> 7) - 1, warp = (tid >> 5) & 3;
  float acc[64];
  int g = 0;
  RsWork w;
  for (int j = 0; rs_work(j, n_dp, sk_units, parts, nk, &w); ++j) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int kt = w.k0; kt < w.k1; ++kt, ++g) {
      const int st = g % kRsStages;
      mbar_wait(&full[st], (g / kRsStages) & 1);
      const unsigned char* xs = smem + st * kRsStageBytes + wg * 64 * 128;
      const unsigned char* ws = smem + st * kRsStageBytes + kRsXBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRsBK / 16; ++kk)
        wgmma_tb(acc, sw128_desc(xs + kk * 32, 16, 1024),
                 sw128_desc(ws + kk * 16 * 128, kRsWBox, 1024));
      wgmma_commit();
      wgmma_wait<1>();   // the previous k-tile's products are done
      if (kt > w.k0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(g - 1) % kRsStages]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(g - 1) % kRsStages]);
    // hand the tile to the epilogue warps once they have stored the last
    if (j > 0) mbar_wait(&drained, (j - 1) & 1);
    // fragment: rows r and r + 8, columns 8i + 2 (lane % 4) and the next
    const int r = wg * 64 + 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < kRsBN / 8; ++i) {
      *reinterpret_cast<float2*>(stg + r * kRsEpiStride + c + 8 * i) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(stg + (r + 8) * kRsEpiStride + c + 8 * i) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&staged);
  }
}

// The split tiles of the last round: out = epilogue(the tile's stream-K
// parts, added in part order), four neighbouring outputs a thread.
__global__ void rs_sk_combine_kernel(const float* __restrict__ sk_ws,
                                     int parts, int n_dp, int n_split,
                                     int tiles_m,
                                     const float* __restrict__ bias, int act,
                                     void* __restrict__ out, int out_bf16,
                                     int M, int N) {
  constexpr int kChunks = kRsBM * kRsBN / 4;   // float4s of a tile
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (long)n_split * kChunks; i += (long)gridDim.x * blockDim.x) {
    const int s = (int)(i / kChunks), c = (int)(i % kChunks);
    const int row = c / (kRsBN / 4), c4 = 4 * (c % (kRsBN / 4));
    const int tile = n_dp + s;
    const int m = (tile % tiles_m) * kRsBM + row;
    const int col = (tile / tiles_m) * kRsBN + c4;
    if (m >= M || col >= N) continue;
    const float4 v = sum_in_order(
        reinterpret_cast<const float4*>(sk_ws + (long)s * parts * kRsBM *
                                                    kRsBN) + c,
        kChunks, parts);
    store4(out, out_bf16, M, N, m, col, v, bias4(bias, N, col), bias, act);
  }
}

// ----------------------------------------------- weight-streaming arm
constexpr int kSkN = 64;          // columns of a unit: four warps of 16
constexpr int kSkK = 256;         // k rows of a unit
constexpr int kSkStages = 4;
constexpr int kSkThreads = 128;
constexpr int kSkWBytes = kSkK * 128;           // 32 KB: [k][64 columns]
constexpr int kSkXBytes = (kSkK / 64) * 2048;   // 8 KB: 16 rows x 64 k boxes
constexpr int kSkStageBytes = kSkWBytes + kSkXBytes;
constexpr int kSkSmem = kSkStages * kSkStageBytes + 1024;
constexpr int kSkMaxRows = 16;

// Units are dealt k chunk first: unit u is column tile u % tiles_n of k
// chunk u / tiles_n, so the thread blocks in flight read whole rows of w
// together. With one k chunk the unit stores the output; else its fp32
// partial goes to ws[kc] (M x N each) for rs_combine_kernel.
__global__ void __launch_bounds__(kSkThreads, 1) rs_stream_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
    int act, void* __restrict__ out, int out_bf16, int M, int K, int N,
    float* __restrict__ ws) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(
                                                 smem_raw) & 1023)) & 1023);
  __shared__ uint64_t full[kSkStages];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = (K + kSkK - 1) / kSkK;
  const int tiles_n = (N + kSkN - 1) / kSkN;
  const int units = tiles_n * nk;
  const int mine = (units - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  const int n_tiles = M > 8 ? 2 : 1;   // 8-row MMA tiles of x
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kSkStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {   // this block's unit i into stage i % kSkStages
    const int u = blockIdx.x + i * gridDim.x;
    const int n0 = (u % tiles_n) * kSkN, k0 = (u / tiles_n) * kSkK;
    unsigned char* st = smem + (i % kSkStages) * kSkStageBytes;
    uint64_t* bar = &full[i % kSkStages];
    mbar_arrive_expect(bar, kSkStageBytes);
    tma_load_2d(st, &tm_w, n0, k0, bar);
#pragma unroll
    for (int b = 0; b < kSkK / 64; ++b)
      tma_load_2d(st + kSkWBytes + b * 2048, &tm_x, k0 + 64 * b, 0, bar);
  };
  if (tid == 0)
    for (int i = 0; i < kSkStages - 1 && i < mine; ++i) issue(i);

  const int g = lane >> 2, t4 = lane & 3;
  for (int i = 0; i < mine; ++i) {
    // the stage refilled here was released by the barrier ending unit i - 1
    if (tid == 0 && i + kSkStages - 1 < mine) issue(i + kSkStages - 1);
    mbar_wait(&full[i % kSkStages], (i / kSkStages) & 1);
    const unsigned char* wsm = smem + (i % kSkStages) * kSkStageBytes;
    const unsigned char* xsm = wsm + kSkWBytes;
    float acc[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kSkK / 16; ++kk) {
      // A = w[k 16kk.., columns 16 warp..]^T; B = x rows 0-7 | 8-15
      uint32_t a[4], b[4];
      const int kr = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4_trans(a, wsm + swz128(kr, 2 * warp + ((lane >> 3) & 1)));
      const int xr = (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, xsm + (kk >> 2) * 2048 +
                         swz128(xr, 2 * (kk & 3) + ((lane >> 3) & 1)));
      mma_16816(acc[0], a, b[0], b[1]);
      if (n_tiles > 1) mma_16816(acc[1], a, b[2], b[3]);
    }
    // acc[t]: columns col, col + 8 of rows 8t + 2 (lane % 4) and the next
    const int u = blockIdx.x + i * gridDim.x;
    const int col = (u % tiles_n) * kSkN + 16 * warp + g;
    float* part = ws + (long)(u / tiles_n) * M * N;
    for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * t + 2 * t4 + (e & 1), c = col + 8 * (e >> 1);
        if (nk == 1)
          store_one(out, out_bf16, M, N, m, c, acc[t][e], bias, act);
        else if (m < M && c < N)
          __stcg(part + (long)m * N + c, acc[t][e]);
      }
    }
    __syncthreads();   // stage i % kSkStages is free again
  }
}

// out = epilogue(ws[0] + ws[1] + ... + ws[parts - 1]), added in that order,
// four neighbouring outputs a thread.
__global__ void rs_combine_kernel(const float* __restrict__ ws, int parts,
                                  const float* __restrict__ bias, int act,
                                  void* __restrict__ out, int out_bf16, int M,
                                  int N) {
  const int n4 = (N + 3) / 4;
  const long plane = (long)M * N;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < (long)M * n4;
       i += (long)gridDim.x * blockDim.x) {
    const int row = (int)(i / n4), col = 4 * (int)(i % n4);
    const long o = (long)row * N + col;
    float4 s;
    if ((N & 3) == 0) {
      s = sum_in_order(reinterpret_cast<const float4*>(ws + o), plane / 4,
                       parts);
    } else {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int p = 0; p < parts; ++p)
        for (int q = 0; q < 4 && col + q < N; ++q)
          v[q] += __ldcg(ws + p * plane + o + q);
      s = make_float4(v[0], v[1], v[2], v[3]);
    }
    store4(out, out_bf16, M, N, row, col, s, bias4(bias, N, col), bias, act);
  }
}

}  // namespace repro

// x (M, K) with ldx elements per row, w (K, N) with ldw, both bf16, row
// strides multiples of 8 elements and base addresses of 16 bytes; bias
// (N,) fp32 (16-byte aligned) or null; out (M, N) fp32, or bf16 when
// out_bf16. At M <= 16 and K > 256, ws holds ceil(K / 256) * M * N fp32
// partials; above 16 rows, when the last round of tiles is split in K
// (wgmma_plan), n_split * parts * 128 * 128; else it may be null.
extern "C" int repro_rs_matmul(const void* x, int ldx, const void* w, int ldw,
                               const void* bias, int act, void* out,
                               int out_bf16, int M, int K, int N, void* ws,
                               void* stream) {
  using namespace repro;
  if (M < 1 || K < 1 || N < 1 || ldx < K || ldw < N || ldx % 8 || ldw % 8 ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15) ||
      (reinterpret_cast<uintptr_t>(bias) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tm_x, tm_w;
  if (M <= kSkMaxRows) {
    const int nk = (K + kSkK - 1) / kSkK;
    if (nk > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        rs_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSkSmem);
    if (attr != cudaSuccess) return (int)attr;
    e = tensor_map(&tm_x, x, M, K, ldx, kSkMaxRows, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == cudaSuccess)
      e = tensor_map(&tm_w, w, K, N, ldw, kSkK, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return (int)e;
    const int units = ((N + kSkN - 1) / kSkN) * nk;
    rs_stream_kernel<<<units < sms ? units : sms, kSkThreads, kSkSmem, st>>>(
        tm_x, tm_w, (const float*)bias, act, out, out_bf16, M, K, N,
        (float*)ws);
    e = cudaGetLastError();
    if (e != cudaSuccess || nk == 1) return (int)e;
    const long chunks = (long)M * ((N + 3) / 4);
    const long blocks = (chunks + 255) / 256;
    rs_combine_kernel<<<(unsigned)(blocks < 4 * sms ? blocks : 4 * sms), 256,
                        0, st>>>((const float*)ws, nk, (const float*)bias, act,
                                 out, out_bf16, M, N);
    return (int)cudaGetLastError();
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      rs_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRsSmem);
  if (attr != cudaSuccess) return (int)attr;
  e = tensor_map(&tm_x, x, M, K, ldx, kRsBM, kRsBK,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tensor_map(&tm_w, w, K, N, ldw, kRsBK, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  const int tiles_m = (M + kRsBM - 1) / kRsBM;
  const int tiles = tiles_m * ((N + kRsBN - 1) / kRsBN);
  const int grid = tiles < sms ? tiles : sms;
  // kernels/rs_matmul.py::wgmma_plan: the last round's tiles split in K
  const int nk = (K + kRsBK - 1) / kRsBK;
  const int n_split = tiles > grid ? tiles % grid : 0;
  int parts = n_split > 0 ? grid / n_split : 1;
  if (parts > nk) parts = nk;
  if (parts < 2) parts = 1;
  if (parts > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  rs_wgmma_kernel<<<grid, kRsThreads, kRsSmem, st>>>(
      tm_x, tm_w, (const float*)bias, act, out, out_bf16, M, K, N,
      (float*)ws, parts);
  e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return (int)e;
  const long chunks = (long)n_split * kRsBM * kRsBN / 4;
  const long blocks = (chunks + 255) / 256;
  rs_sk_combine_kernel<<<(unsigned)(blocks < 4 * sms ? blocks : 4 * sms),
                         256, 0, st>>>((const float*)ws, parts,
                                       tiles - n_split, n_split, tiles_m,
                                       (const float*)bias, act, out, out_bf16,
                                       M, N);
  return (int)cudaGetLastError();
}
