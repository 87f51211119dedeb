// Pruned FFN for Hopper, first stage at decode: the compact hidden
// activation
//   h[:, c] = act(x @ Wgate[:, keep_col(c)]) * (x @ Wup[:, keep_col(c)])
// (or act(x @ Wup[:, keep_col(c)]) ungated), keep_col(c) =
// keep[c / block] * block + c % block, cast to Wdown's dtype, for up to
// BPM_DECODE_MAX_ROWS = 16 rows of x (kernels/ops.py). Above them the
// wrapper runs the tensor-core core of pruned_grad.cu (FfnPolicy /
// FfnGatedPolicy) instead. The second stage, y = h @ Wdown[keep, :], is
// the block-pruned product (block_pruned_matmul.cu, pruned_grad.cu)
// reading h as compact x.
//
// Replaces the TPU kernel src/repro/kernels/pruned_matmul.py:547
// fused_ffn_2d (bodies _ffn_kernel / _ffn_kernel_gated). That kernel keeps
// the hidden tile in VMEM and folds it into an f32 [tm, d_out] accumulator
// carried across a sequential grid. On the H100 that accumulator does not
// fit: at Yi-6B's d_out = 4096 it is 1 MiB even at tm = 64, against 227 KB
// of shared memory per block, and blocks cannot carry state across a
// grid. This port takes the two-stage design: the compact hidden
// [M, kb*block] goes to device memory once (8 x 9600 x 2 bytes = 154 KB
// at the serving path's keep 75/86, against 157 MB of kept Wup and Wgate
// columns), then the pruned down product reads it.
//
// What bounds it on the H100: at decode every weight element read feeds
// 2*M flops, 8 flops per bf16 byte at M = 8, far below the ~295 where the
// tensor cores would be the limit. It is bound by the bytes of the KEPT
// Wup and Wgate columns: 2 x 4096 x 9600 x 2 bytes = 157 MB at Yi-6B's
// keep 75/86, 47 us at 3.35 TB/s. To keep 3.35 TB/s busy across ~1 us of
// latency about 3.4 MB must be in flight, ~26 KB per SM.
//
// Design (the shape of #2's decode kernel, block_pruned_matmul.cu, with
// the pruning moved from the contraction to the output columns):
//   - a block of 8 warps owns 128 compact columns (a kept block's row of
//     256 bytes in bf16 at block 128), 8 rows of x and one contiguous
//     range of K (grid (columns / 128, M / 8, ranges)); warp w takes the
//     64 columns of group w % 2 and the 16-row chunks w / 2, w / 2 + 4,
//     ... of the range, so two warps read the two halves of the same rows
//     at once; each lane loads 4 rows x 8 columns of Wup (and Wgate) in
//     16-byte loads, neighbouring lanes on neighbouring addresses. A
//     lane's columns are resolved through the keep map once: a 16-byte
//     load (8 bf16 or 4 f32 columns) needs a block of whole loads (block
//     % 8 in bf16, % 4 in f32), so it never crosses a kept block, and
//     bf16 at block 8 is exactly one load per block row. A block, base or
//     H that is not whole loads takes a predicated element-wise path in
//     the same kernel;
//   - the loads run ahead of the arithmetic in a ring of registers, one
//     unit a chunk's rows of one weight: after the products of a unit its
//     registers take the warp's unit one turn of the ring ahead, so 16
//     16-byte loads per lane stay in flight (bf16: 4 units, f32: 2; a
//     gated chunk is two units, Wup's then Wgate's), 8 KB per warp, 128 KB
//     per SM at two blocks. The x rows of the block's range are staged
//     once in shared memory by cp.async while the first weight loads fly,
//     and all 8 warps read them;
//   - the arithmetic on the tensor cores, operands swapped: h^T [64, 8] =
//     W^T . x^T with mma.sync m16n8k16 (bf16) or m16n8k8 in the 3xTF32
//     form (f32; common.cuh), so the weight's columns fill the 16-row
//     side and the 8 rows of x are the mma's n = 8; no transpose for W:
//     lane (g, tg) takes contraction slots {2tg, 2tg+1, 2tg+8, 2tg+9} to
//     be ITS rows 4tg..4tg+3 of the chunk (f32: slots {tg, tg+4} of the
//     two k-steps), and fragment row g / g + 8 of n-tile u to be its
//     columns 8g + 2u / + 1; x's fragment is one 8- or 16-byte shared
//     load of those rows;
//   - K split across grid.z (the wrapper picks the count from the SM
//     count, ops._ffn_decode_splits: as many ranges as keep every block
//     resident at once, two a SM, as #2's decode kernel; the range sweep
//     of grad_timing.py --ffn-sweep); the 4 warps' sums of a column group
//     meet in shared memory (in warp order); with one range the block
//     applies the activation and writes h, with more each writes its f32
//     partials of both products and a second launch
//     (ffn_hidden_act_kernel, common.cuh) sums them in range order,
//     applies the activation and casts, so two calls give the same bits.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;       // compact columns per block
constexpr int kGroups = 2;       // column groups of 64: 8 per lane row g
constexpr int kChunkWarps = kWarps / kGroups;   // warps down one group
constexpr int kRows = 16;        // contraction rows per chunk: 4 per lane
constexpr int kSlots = 8;        // rows of x per block: the mma's n

// Per lane: 16-byte loads per row of 8 columns, elements per 16 bytes,
// registers of one unit (4 rows of one weight), units in flight per warp
// (the ring: 16 registers of 16 bytes), weights per chunk
template <typename T, bool G> struct Dec {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kPieces = 8 / kVec;
  static constexpr int kRegs = 4 * kPieces;
  static constexpr int kDepth = 16 / kRegs;
  static constexpr int kUnits = G ? 2 : 1;
  static_assert(kDepth % kUnits == 0, "a ring slot holds one weight");
};

// the x stage's row pitch in elements: R rows rounded up to 64, plus 16,
// puts the 8-byte (bf16) and 16-byte (f32) fragment loads of a warp's 8
// rows of x on distinct banks, every row 16-byte aligned
__host__ __device__ inline int x_pitch(int rows) {
  return (rows + 63) / 64 * 64 + 16;
}

// What the loads of one unit need: the lane's first row offset is t * H,
// its columns col[h] (stored, -1 past C) for the 16-byte path, c0 the
// lane's first compact column for the element-wise path.
template <typename T>
struct Lane {
  const int* __restrict__ keep;
  int K, H, C, blk, c0;
  int col[Dec<T, false>::kPieces];
  bool vec;
};

// Rows 4tg..4tg+3 of the chunk at K row t0 (lane tg = lane % 4), the
// lane's 8 columns of w into v; zeros past K and C.
template <typename T>
__device__ __forceinline__ void load_unit(uint4 (&v)[Dec<T, false>::kRegs],
                                          const T* __restrict__ w,
                                          const Lane<T>& a, int t0) {
  constexpr int P = Dec<T, false>::kPieces, V = Dec<T, false>::kVec;
  const int t = t0 + 4 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < P; ++h) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (t + r < a.K) {
        const T* row = w + (long)(t + r) * a.H;
        if (a.vec) {
          if (a.col[h] >= 0) q = load_w(row + a.col[h]);
        } else {
          __align__(16) T tmp[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int c = a.c0 + h * V + e;
            tmp[e] = c < a.C
                         ? row[(long)__ldg(a.keep + c / a.blk) * a.blk +
                               c % a.blk]
                         : from_f<T>(0.f);
          }
          q = *reinterpret_cast<const uint4*>(tmp);
        }
      }
      v[r * P + h] = q;
    }
}

// One unit into the lane's accumulators acc[n-tile u][4]: acc[u][0..3]
// are the product at (column 8g + 2u, row 2tg), (8g + 2u, 2tg + 1),
// (8g + 2u + 1, 2tg), (8g + 2u + 1, 2tg + 1) of the warp's 64 columns
// and the block's 8 rows of x. `xs` points at x[row g][the lane's 4 rows] in shared
// memory.
__device__ __forceinline__ void mma_unit(float (&acc)[4][4],
                                         const uint4 (&v)[4],
                                         const __nv_bfloat16* xs) {
  const uint2 xv = *reinterpret_cast<const uint2*>(xs);
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

__device__ __forceinline__ void mma_unit(float (&acc)[4][4],
                                         const uint4 (&v)[8],
                                         const float* xs) {
  const uint4 xv = *reinterpret_cast<const uint4*>(xs);
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

// Block (x, y, z): compact columns [128 x, + 128), rows of x [8 y, + 8),
// K chunks [z * chunks_per_split, ...). Dynamic shared memory: the x
// stage [8][x_pitch(range rows)], later the warps' sums
// [weights][warp][accumulator][lane].
template <typename T, bool G>
__global__ void __launch_bounds__(kThreads, 2)
ffn_hidden_decode_kernel(const T* __restrict__ x, const T* __restrict__ w_up,
                         const T* __restrict__ w_gate,
                         const int* __restrict__ keep,
                         float* __restrict__ partial, T* __restrict__ h,
                         int M, int K, int H, int C, int blk,
                         int chunks_per_split, int w_vec, int x_vec,
                         int act) {
  using D_ = Dec<T, G>;
  constexpr int D = D_::kDepth, U = D_::kUnits, V = D_::kVec;
  constexpr int kTurn = kChunkWarps * (D / U);  // chunks of a ring turn
  extern __shared__ __align__(16) unsigned char ffn_smem[];
  T* xs = reinterpret_cast<T*>(ffn_smem);
  float* red = reinterpret_cast<float*>(ffn_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int grp = warp % kGroups, wc = warp / kGroups;  // group, chunk lane
  const int chunks = (K + kRows - 1) / kRows;
  const int c_lo = blockIdx.z * chunks_per_split;
  const int nch = min(chunks, c_lo + chunks_per_split) - c_lo;
  const int t_lo = c_lo * kRows;
  const int m0 = blockIdx.y * kSlots;
  const int ldx = x_pitch(chunks_per_split * kRows);

  Lane<T> a{keep, K, H, C, blk,
            (int)(blockIdx.x * kCols) + grp * (kCols / kGroups) + 8 * g, {},
            w_vec != 0};
#pragma unroll
  for (int p = 0; p < Dec<T, false>::kPieces; ++p) {
    const int c = a.c0 + p * V;
    a.col[p] = c < C ? __ldg(keep + c / blk) * blk + c % blk : -1;
  }

  // the ring: slot d holds the warp's unit turn * D + d, weight d % U of
  // the warp's chunk wc + (turn * D + d) / U * kChunkWarps
  uint4 v[D][D_::kRegs];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int cl = wc + d / U * kChunkWarps;
    if (cl < nch)
      load_unit<T>(v[d], d % U ? w_gate : w_up, a, t_lo + cl * kRows);
  }
  // x rows [m0, m0 + 8) of the range's rows, zeros past M and K: 16-byte
  // copies where x's base and rows are whole copies, else element-wise
  const int rows = nch * kRows;
  for (int e = tid; e < kSlots * rows / V; e += kThreads) {
    const int s = e / (rows / V), r = e % (rows / V) * V;
    const int m = m0 + s, t = t_lo + r;
    T* dst = xs + s * ldx + r;
    if (x_vec) {
      const bool ok = m < M && t < K;
      cp_async16(dst, ok ? x + (long)m * K + t : x, ok);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        dst[i] = m < M && t + i < K ? x[(long)m * K + t + i] : from_f<T>(0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[U][4][4];
#pragma unroll
  for (int w = 0; w < U; ++w)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[w][u][c] = 0.f;
  const T* xl = xs + g * ldx + 4 * tg;      // x[row g][the lane's rows]
  for (int c0 = wc; c0 < nch; c0 += kTurn) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int cl = c0 + d / U * kChunkWarps;
      if (cl < nch) mma_unit(acc[d % U], v[d], xl + cl * kRows);
      if (cl + kTurn < nch)
        load_unit<T>(v[d], d % U ? w_gate : w_up, a,
                     t_lo + (cl + kTurn) * kRows);
    }
  }

  __syncthreads();                          // every warp is done with x
#pragma unroll
  for (int w = 0; w < U; ++w)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      red[((w * kWarps + warp) * 16 + i) * 32 + lane] = acc[w][i / 4][i % 4];
  __syncthreads();
  // this thread's four outputs: accumulator i of lane ln of column group
  // q for q * 512 + (i * 32 + ln) = tid + k * 256, summed over the
  // group's warps in order; with one range the activation into h, else
  // this range's partials, which the second launch sums
  const long n = (long)M * C;
#pragma unroll
  for (int k = 0; k < 2 * kGroups; ++k) {
    const int q = (tid + k * kThreads) >> 9, e = (tid + k * kThreads) & 511;
    const int i = e >> 5, ln = e & 31;
    const int m = m0 + 2 * (ln & 3) + (i & 1);
    const int c = (int)(blockIdx.x * kCols) + q * (kCols / kGroups) +
                  8 * (ln >> 2) + 2 * (i >> 2) + ((i >> 1) & 1);
    if (m >= M || c >= C) continue;
    float sum[U];
#pragma unroll
    for (int w = 0; w < U; ++w) {
      sum[w] = 0.f;
#pragma unroll
      for (int wq = 0; wq < kChunkWarps; ++wq)
        sum[w] += red[((w * kWarps + wq * kGroups + q) * 16 + i) * 32 + ln];
    }
    const long o = (long)m * C + c;
    if (gridDim.z == 1) {
      h[o] = from_f<T>(G ? act_f(sum[U - 1], act) * sum[0]
                         : act_f(sum[0], act));
    } else {
      partial[blockIdx.z * n + o] = sum[0];
      if (G) partial[(gridDim.z + blockIdx.z) * n + o] = sum[U - 1];
    }
  }
}

// chunks per range for `splits` ranges
int chunks_per_split(int K, int splits) {
  const int chunks = (K + kRows - 1) / kRows;
  return (chunks + splits - 1) / splits;
}

int smem_bytes(int K, int splits, int gated, int dtype) {
  const int xb = kSlots * x_pitch(chunks_per_split(K, splits) * kRows) *
                 (dtype == DT_BF16 ? 2 : 4);
  const int rb = (gated ? 2 : 1) * kWarps * 16 * 32 * 4;
  return xb > rb ? xb : rb;
}

// The launches of a call (the products, then the sum of the ranges with
// the activation when there is more than one); returns the count, 0 for
// shapes it refuses.
int config(int M, int K, int kb, int block, int gated, int splits,
           int dtype, LaunchRec* r, bool names) {
  if (M < 1 || K < 1 || kb < 1 || block < 1 || splits < 1) return 0;
  const int chunks = (K + kRows - 1) / kRows;
  const int cps = chunks_per_split(K, splits);
  const int used = (chunks + cps - 1) / cps;   // ranges that hold a chunk
  const int C = kb * block;
  const dim3 grid((C + kCols - 1) / kCols, (M + kSlots - 1) / kSlots, used);
  if (grid.y > 65535 || grid.z > 65535) return 0;
  set_launch(&r[0], names, grid, kThreads,
             smem_bytes(K, splits, gated, dtype),
             "ffn_hidden_decode_kernel<%s,%d>", dt_name(dtype), gated ? 1 : 0);
  if (used == 1) return 1;
  set_launch(&r[1], names, dim3((unsigned)(((long)M * C + 255) / 256)), 256,
             0, "ffn_hidden_act_kernel<%s>", dt_name(dtype));
  return 2;
}

template <typename T, bool G>
cudaError_t launch(const void* x, const void* w_up, const void* w_gate,
                   const int* keep, float* partial, void* h, int M, int K,
                   int H, int kb, int block, int splits, int act,
                   cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  const int n = config(M, K, kb, block, G, splits, dtype_of<T>(), r, false);
  if (n == 0) return cudaErrorInvalidValue;
  constexpr int V = Dec<T, G>::kVec;
  static size_t allowed[kSmemDevices] = {};
  cudaError_t e = allow_smem_once(ffn_hidden_decode_kernel<T, G>, r[0].smem,
                                  allowed);
  if (e != cudaSuccess) return e;
  auto whole = [](const void* p) {
    return (unsigned long long)p % 16 == 0;
  };
  // whole 16-byte loads: both weights' bases, their rows, and the blocks
  // (a load never crosses a kept block)
  const int w_vec = whole(w_up) && (!G || whole(w_gate)) && H % V == 0 &&
                    block % V == 0;
  const int x_vec = whole(x) && K % V == 0;
  ffn_hidden_decode_kernel<T, G><<<grid_of(r[0]), r[0].threads, r[0].smem,
                                   st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_up),
      static_cast<const T*>(w_gate), keep, partial, static_cast<T*>(h), M, K,
      H, kb * block, block, chunks_per_split(K, splits), w_vec, x_vec, act);
  e = cudaGetLastError();
  if (e != cudaSuccess || n == 1) return e;
  const long region = (long)M * kb * block;
  const int used = r[0].grid[2];
  ffn_hidden_act_kernel<T><<<grid_of(r[1]), r[1].threads, 0, st>>>(
      partial, G ? partial + used * region : nullptr, static_cast<T*>(h),
      region, used, act);
  return cudaGetLastError();
}

}  // namespace

// x [M <= 16, K], w_up / w_gate [K, H] (w_gate null: ungated), keep int32
// [kb] -> h [M, kb*block] = act(x @ w_gate[:, keep]) * (x @ w_up[:, keep]),
// ungated act(x @ w_up[:, keep]); partial f32 scratch of at least
// (1 + gated) * splits * M * kb*block (unused with one range); all
// row-major, of one dtype. act: ACT_SILU or ACT_GELU_TANH.
extern "C" int repro_pruned_ffn_hidden(
    const void* x, const void* w_up, const void* w_gate, const int* keep,
    float* partial, void* h, int M, int K, int H, int kb, int block,
    int splits, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act != ACT_SILU && act != ACT_GELU_TANH)
    return (int)cudaErrorInvalidValue;
  const bool gated = w_gate != nullptr;
  if (dtype == DT_F32)
    return (int)(gated ? launch<float, true> : launch<float, false>)(
        x, w_up, w_gate, keep, partial, h, M, K, H, kb, block, splits, act,
        st);
  if (dtype == DT_BF16)
    return (int)(gated ? launch<__nv_bfloat16, true>
                       : launch<__nv_bfloat16, false>)(
        x, w_up, w_gate, keep, partial, h, M, K, H, kb, block, splits, act,
        st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_pruned_ffn_hidden_launch_config(int M, int K, int kb,
                                                     int block, int gated,
                                                     int splits, int dtype,
                                                     LaunchRec* r) {
  return config(M, K, kb, block, gated, splits, dtype, r, true);
}
