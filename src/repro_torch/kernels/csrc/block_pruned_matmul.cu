// Block-pruned matrix product at decode, for Hopper (sm_90a):
// y = x[:, keep] @ w[keep, :] for a few rows of x.
//
// Replaces the TPU kernel src/repro/kernels/pruned_matmul.py:81
// block_pruned_matmul_2d (body _fwd_kernel), which streams only the kept
// (tm x block) / (block x tn) tiles through scalar-prefetched index maps,
// at the rows of the serving path (M = the 8 slots), up to
// BPM_DECODE_MAX_ROWS = 16 rows (kernels/ops.py, fixed by a sweep on the
// card). Above them the wrapper runs the tensor-core core of
// pruned_grad.cu (BpmPolicy) instead. `x_compact` reads x as
// [M, kb*block] with slot k holding block keep[k] (the pruned FFN's down
// product).
//
// What bounds it on the H100: the product does 2*M flops per weight
// element read, 16 flops per bf16 byte at M = 8, far below the ~295 where
// the tensor cores would be the limit. It is bound by the bytes of the
// KEPT weight rows (kb*block*N elements), which is what ZERO-resizing
// saves. At Yi-6B's `wq` (28 of 32 blocks of 128, N = 4096, bf16) that is
// 29.4 MB, 8.8 us at 3.35 TB/s; at `wk` (N = 512) 3.7 MB, 1.1 us. To keep
// 3.35 TB/s busy across ~0.7 us of latency about 2.3 MB must be in
// flight, ~18 KB per SM (more under load, when the latency grows).
//
// Design:
//   - a block of 8 warps owns 64 output columns and one contiguous range
//     of the kept contraction (grid (columns / 64, M / 8, ranges)); its
//     warps take 16-row chunks of the range in turn, each lane loading 4
//     rows x 8 columns of w in 16-byte loads (bf16: 4 loads, f32: 8;
//     neighbouring lanes on neighbouring addresses: a warp reads 4 rows x
//     128 contiguous bytes in bf16) and its 4 values of x;
//   - the loads run ahead of the arithmetic in a ring of registers: after
//     the products of one chunk, its registers take the warp's chunk one
//     turn of the ring ahead, so kDepth chunks per warp stay in flight
//     (bf16: 4 x 2 KB, f32: 2 x 4 KB), 64 KB per block, 128 KB per SM at two
//     blocks. No shared memory and no barrier before the products. The
//     wrapper picks the number of ranges so that all blocks run at once,
//     two per SM (a second wave measured 20-30% slower), with at least a
//     full ring per warp (4 ranges at `wq`, 7 at `wk`);
//   - the arithmetic on the tensor cores, operands swapped: y^T [N, 8] =
//     w^T . x^T with mma.sync m16n8k16 (bf16) or m16n8k8 in the 3xTF32
//     form (f32; common.cuh), so the weight's columns fill the 16-row
//     side and the 8 slots are the mma's n = 8. No transpose for w: the
//     mma's contraction order is free, so lane (g, tg) takes contraction
//     slots {2tg, 2tg+1, 2tg+8, 2tg+9} to be ITS rows 4tg..4tg+3 of the
//     chunk (f32: slots {tg, tg+4} of the two k-steps), and fragment row
//     g / g + 8 of n-tile u to be its columns 8g + 2u / + 1; a bf16
//     fragment register is two of its loaded words interleaved by
//     __byte_perm. x's fragment is the lane's 4 values of slot g, one 8-
//     or 16-byte load (x is small and stays in L1/L2);
//   - the 8 warps' sums meet in shared memory (in warp order); with one
//     range the block writes y, with more each writes its f32 partial and
//     a second launch (reduce_splits_kernel) sums them in range order, so
//     two calls give the same bits.
//   Chosen over FMA on CUDA cores (the old design's 64 flops per 16 bytes
//   would take half the SM's issue slots at the memory rate), over x
//   staged in shared memory (its scattered loads delayed every block's
//   first product) and over summing the ranges in the kernel's last block
//   to arrive at a tile (an integer counter per tile: 0.7-3 us slower
//   than the second launch's device time; PERF.md).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 64;        // output columns per block: 8 per lane row g
constexpr int kRows = 16;        // contraction rows per chunk: 4 per lane
constexpr int kSlots = 8;        // output rows per block: the mma's n

// Per lane and chunk: 16-byte loads per row of 8 columns, registers of
// w, elements per 16 bytes; chunks in flight per warp (the ring)
template <typename T> struct Dec {
  static constexpr int kPieces = 8 * (int)sizeof(T) / 16;
  static constexpr int kRegs = 4 * kPieces;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kDepth = 8 / kPieces / 2;
};

__device__ __forceinline__ long kept_row(const int* keep, int blk, int t) {
  return (long)__ldg(keep + t / blk) * blk + t % blk;
}

// What the loads of one chunk need: the operands, the lane's rows and
// columns, whether w and x take whole 16-byte / 4-element loads.
template <typename T>
struct DecArgs {
  const T* __restrict__ x;
  const T* __restrict__ w;
  const int* __restrict__ keep;
  int M, N, T_, blk, x_compact, m, col;  // m: the lane's slot of x
  long ldx;
  bool w_vec, x_vec;
};

// Lane (g, tg)'s rows 4tg..4tg+3 of the chunk at kept row t0: columns
// [col, col + 8) of w into v (16-byte loads, or element-wise where w's
// base or N is not whole 16-byte pieces) and x[slot m][those rows] into
// xv (one load where x's rows and the block allow); zeros past T, N or M.
template <typename T>
__device__ __forceinline__ void load_chunk(uint4 (&v)[Dec<T>::kRegs],
                                           uint4& xv, const DecArgs<T>& a,
                                           int t0) {
  constexpr int P = Dec<T>::kPieces, V = Dec<T>::kVec;
  const int t = t0 + 4 * (threadIdx.x & 3);
  long rows[4];
  if (a.blk % 4 == 0) {        // the lane's 4 rows lie in one block
    const long r0 = t < a.T_ ? kept_row(a.keep, a.blk, t) : 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) rows[r] = r0 + r;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rows[r] = t + r < a.T_ ? kept_row(a.keep, a.blk, t + r) : 0;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < P; ++h) {
      const int c = a.col + h * V;
      const T* src = a.w + rows[r] * a.N + c;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (t + r < a.T_) {
        if (a.w_vec) {
          if (c < a.N) q = load_w(src);
        } else {
          __align__(16) T tmp[V];
#pragma unroll
          for (int e = 0; e < V; ++e)
            tmp[e] = c + e < a.N ? src[e] : from_f<T>(0.f);
          q = *reinterpret_cast<const uint4*>(tmp);
        }
      }
      v[r * P + h] = q;
    }
  // x's position of row r: t + r in a compact x, else w's row
  __align__(16) T xs[4];
  const T* xrow = a.x + a.m * a.ldx;
  if (a.x_vec && a.m < a.M && t < a.T_) {
    const T* src = xrow + (a.x_compact ? (long)t : rows[0]);
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<uint4*>(xs) =
          __ldg(reinterpret_cast<const uint4*>(src));
    else
      *reinterpret_cast<uint2*>(xs) =
          __ldg(reinterpret_cast<const uint2*>(src));
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      xs[r] = a.m < a.M && t + r < a.T_
                  ? xrow[a.x_compact ? (long)(t + r) : rows[r]]
                  : from_f<T>(0.f);
  }
  if constexpr (sizeof(T) == 4)
    xv = *reinterpret_cast<const uint4*>(xs);
  else
    xv = make_uint4(reinterpret_cast<const uint2*>(xs)->x,
                    reinterpret_cast<const uint2*>(xs)->y, 0u, 0u);
}

// One chunk into the lane's accumulators acc[n-tile u][4]: acc[u][0..3]
// are y at (slot 2tg, column 8g + 2u), (2tg + 1, 8g + 2u), (2tg,
// 8g + 2u + 1), (2tg + 1, 8g + 2u + 1) of the block's 64 columns. `xv`
// holds x[slot g][the lane's 4 rows].
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4],
                                          const uint4 (&v)[4],
                                          const uint4& xv) {
  const unsigned b[2] = {xv.x, xv.y};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const unsigned w0 = word(v[0], u), w1 = word(v[1], u),
                   w2 = word(v[2], u), w3 = word(v[3], u);
    const unsigned a[4] = {__byte_perm(w0, w1, 0x5410),
                           __byte_perm(w0, w1, 0x7632),
                           __byte_perm(w2, w3, 0x5410),
                           __byte_perm(w2, w3, 0x7632)};
    mma_bf16(acc[u], a, b);
  }
}

__device__ __forceinline__ void mma_chunk(float (&acc)[4][4],
                                          const uint4 (&v)[8],
                                          const uint4& xv) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {          // k-steps: rows 2q and 2q + 1
    unsigned bh[2], bl[2];
    split_tf32(__uint_as_float(q ? xv.z : xv.x), bh[0], bl[0]);
    split_tf32(__uint_as_float(q ? xv.w : xv.y), bh[1], bl[1]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4& r0 = v[(2 * q) * 2 + u / 2];
      const uint4& r1 = v[(2 * q + 1) * 2 + u / 2];
      const int e = 2 * (u % 2);
      unsigned ah[4], al[4];
      split_tf32(__uint_as_float(word(r0, e)), ah[0], al[0]);
      split_tf32(__uint_as_float(word(r0, e + 1)), ah[1], al[1]);
      split_tf32(__uint_as_float(word(r1, e)), ah[2], al[2]);
      split_tf32(__uint_as_float(word(r1, e + 1)), ah[3], al[3]);
      mma_tf32(acc[u], al, bh);
      mma_tf32(acc[u], ah, bl);
      mma_tf32(acc[u], ah, bh);
    }
  }
}

// Block (x, y, z): columns [64 x, + 64), slots [8 y, + 8), chunks
// [z * chunks_per_split, ...) of the kept contraction.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bpm_decode_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ keep, float* __restrict__ partial,
                  T* __restrict__ y, int M, int K, int N, int kb, int blk,
                  int x_compact, int chunks_per_split, int w_vec,
                  int x_vec) {
  __shared__ float red[kWarps * 16 * 32];   // [warp][accumulator][lane]
  constexpr int D = Dec<T>::kDepth;
  constexpr int kTurn = kWarps * D;          // chunks of one ring turn
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T_ = kb * blk;
  const int chunks = (T_ + kRows - 1) / kRows;
  const int c_lo = blockIdx.z * chunks_per_split;
  const int nch = min(chunks, c_lo + chunks_per_split) - c_lo;
  const int t_lo = c_lo * kRows;
  const int m0 = blockIdx.y * kSlots;
  const DecArgs<T> a{x, w, keep, M, N, T_, blk, x_compact,
                     m0 + (lane >> 2),
                     (int)(blockIdx.x * kCols) + 8 * (lane >> 2),
                     x_compact ? (long)T_ : (long)K, w_vec != 0, x_vec != 0};

  // the ring: slot d holds the warp's chunk warp + (turn * D + d) * kWarps
  uint4 v[D][Dec<T>::kRegs], xv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int cl = warp + d * kWarps;
    if (cl < nch) load_chunk<T>(v[d], xv[d], a, t_lo + cl * kRows);
  }
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;
  for (int c0 = warp; c0 < nch; c0 += kTurn) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int cl = c0 + d * kWarps;
      if (cl < nch) mma_chunk(acc, v[d], xv[d]);
      if (cl + kTurn < nch)
        load_chunk<T>(v[d], xv[d], a, t_lo + (cl + kTurn) * kRows);
    }
  }

#pragma unroll
  for (int i = 0; i < 16; ++i)
    red[(warp * 16 + i) * 32 + lane] = acc[i / 4][i % 4];
  __syncthreads();
  // this thread's two outputs: accumulator i of lane ln for e = tid and
  // tid + 256, summed over the warps in order; with one range into y,
  // else into this range's partial, which the second launch sums
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = tid + k * kThreads, i = e >> 5, ln = e & 31;
    const int m = m0 + 2 * (ln & 3) + (i & 1);
    const int n = (int)(blockIdx.x * kCols) + 8 * (ln >> 2) + 2 * (i >> 2) +
                  ((i >> 1) & 1);
    if (m >= M || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += red[(wp * 16 + i) * 32 + ln];
    const long o = (long)m * N + n;
    if (gridDim.z == 1)
      y[o] = from_f<T>(sum);
    else
      partial[blockIdx.z * ((long)M * N) + o] = sum;
  }
}

// The launches of a call (the products, then the sum of the ranges when
// there is more than one); returns the count, 0 for shapes it refuses.
int config(int M, int N, int kb, int block, int splits, int dtype,
           LaunchRec* r, bool names) {
  if (M < 1 || N < 1 || kb < 1 || block < 1 || splits < 1) return 0;
  const int chunks = (kb * block + kRows - 1) / kRows;
  const int cps = (chunks + splits - 1) / splits;
  const int used = (chunks + cps - 1) / cps;   // ranges that hold a chunk
  const dim3 grid((N + kCols - 1) / kCols, (M + kSlots - 1) / kSlots, used);
  if (grid.y > 65535 || grid.z > 65535) return 0;
  set_launch(&r[0], names, grid, kThreads, 0, "bpm_decode_kernel<%s>",
             dt_name(dtype));
  if (used == 1) return 1;
  set_launch(&r[1], names, dim3((unsigned)(((long)M * N + 255) / 256)), 256,
             0, "reduce_splits_kernel<%s>", dt_name(dtype));
  return 2;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* keep,
                   float* partial, void* y, int M, int K, int N, int kb,
                   int block, int x_compact, int splits, cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  const int n = config(M, N, kb, block, splits, dtype_of<T>(), r, false);
  if (n == 0) return cudaErrorInvalidValue;
  const int chunks = (kb * block + kRows - 1) / kRows;
  const int cps = (chunks + splits - 1) / splits;
  const unsigned long long wp = (unsigned long long)w;
  const unsigned long long xp = (unsigned long long)x;
  const long ldx = x_compact ? (long)kb * block : (long)K;
  const int w_vec = wp % 16 == 0 && N % Dec<T>::kVec == 0;
  // a lane's 4 values of x in one load: whole 4-element rows and blocks
  const int x_vec = xp % (4 * sizeof(T)) == 0 && ldx % 4 == 0 &&
                    block % 4 == 0;
  bpm_decode_kernel<T><<<grid_of(r[0]), r[0].threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), keep, partial,
      static_cast<T*>(y), M, K, N, kb, block, x_compact, cps, w_vec, x_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 1) return e;
  reduce_splits_kernel<T><<<grid_of(r[1]), r[1].threads, 0, st>>>(
      partial, static_cast<T*>(y), (long)M * N, r[0].grid[2]);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (or [M, kb*block] when x_compact), w [K, N], keep int32 [kb],
// partial f32 scratch of at least splits*M*N (unused with one range),
// y [M, N]; all row-major and contiguous, x/w/y of one dtype (DT_F32 or
// DT_BF16).
extern "C" int repro_block_pruned_matmul(
    const void* x, const void* w, const int* keep, float* partial, void* y,
    int M, int K, int N, int kb, int block, int x_compact, int splits,
    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)launch<float>(x, w, keep, partial, y, M, K, N, kb, block,
                              x_compact, splits, st);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, w, keep, partial, y, M, K, N, kb,
                                      block, x_compact, splits, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_block_pruned_matmul_launch_config(int M, int N, int kb,
                                                       int block, int splits,
                                                       int dtype,
                                                       LaunchRec* r) {
  return config(M, N, kb, block, splits, dtype, r, true);
}
