// Fused absorbed-MLA (DeepSeek-V2) one-token decode attention for Hopper,
// over the fixed slot cache (#5) and over the block-paged pool (#6): one
// templated kernel, two row policies.
//
// Replaces the TPU kernels src/repro/kernels/decode_attn.py:227
// mla_decode_attn_2d (body _mla_kernel; entry repro_mla_decode_attn) and
// decode_attn.py:546 mla_paged_decode_attn_2d (body _paged_mla_kernel;
// entry repro_mla_paged_decode_attn). Per slot b and head h:
//
//   s[h, p] = (q_abs[b, h] . latent[p] + q_rope[b, h] . rope[p]) * scale
//   out[b, h] = sum_p softmax_p(s[h, :]) latent[p]        (f32, [R])
//
// over the rows p <= cur_pos[b] (a cur_pos past the cache — the engine's
// invalid lanes use 2**30 — attends every present row; a slot with no
// row writes 0). The two entry points differ only in where row p of slot
// b lives (a row policy):
//
//   SlotRows   latent [B, S, R]          -> b * S + p
//   PagedRows  latent [num_pages, ps, R] -> page * ps + p % ps with
//              page = pages[b, p / ps]; -1 (unallocated) or a page id
//              outside the pool is absent and never read, as the TPU
//              kernel's `page >= 0 && tile valid` test skips it.
//
// What bounds it on the H100: every attended row (R + Dr values: 1152 B
// in bf16 at R = 512, Dr = 64) is read once and feeds 4 * H * R + 2 * H *
// Dr flops for the H = 16 heads (about 60 flops a byte in bf16), so the
// kernel is bound by the bytes of each slot's attended rows (4.2 MB at
// the smoke run's phase-2 positions: 1.2 us at 3.35 TB/s). At these sizes
// a launch and one trip to device memory cost more than that.
//
// Design:
//   - work from the attended rows: block (b, r, z) takes the kRows rows
//     from r * kRows. The grid is sized from the cache length (no host
//     sync on cur_pos); a block past slot b's last attended row exits
//     before it stages anything and writes no partial, and the merge
//     reads only the ranges that hold rows (their count worked out from
//     cur_pos on the device). z covers groups of 16 heads (the mma's m)
//     and, where R has no compile-time size, column chunks of the output;
//   - all H = 16 heads share each latent row (MQA-like), so the block
//     stages q (16 x (R + Dr)) once and its kRows rows of [latent | rope]
//     once, in the input type, every copy a 16-byte cp.async issued up
//     front (one warp a row; the rows are resolved once, the page table
//     read by one thread a row beside cur_pos); an unattended row or one
//     in an absent page is zero-filled by the copy (src-size 0), masked,
//     never read;
//   - scores on the tensor cores (mma.sync, heads as the mma's m): warp w
//     computes the 16 x 16 score tiles w, w + 4, ... over k = R + Dr
//     (bf16 m16n8k16; f32 m16n8k8 in the 3xTF32 form, f32's accuracy),
//     into shared memory in base 2 (scale * log2 e);
//   - one softmax over the block's rows: each warp takes 4 heads, 8
//     lanes a head, for the maximum, the exponentials (in place) and
//     their sum. Where a row is too wide for a block's shared memory to
//     hold q and all kRows rows (R + Dr past about 700 in f32, 1400 in
//     bf16), the rows come in passes of 32 or 16 and the softmax is
//     carried across passes online;
//   - P . latent on the tensor cores: warp w owns output columns [128 w,
//     128 w + 128) with a 16 x 128 f32 accumulator in registers (64 a
//     lane); bf16 reads latent by ldmatrix.trans, f32 (3xTF32) by scalar
//     loads with the contraction order permuted (mma k = tg <-> row 2 tg,
//     k = tg + 4 <-> row 2 tg + 1: one float2 of P, 32 distinct banks);
//   - the block writes one f32 partial (m in base 2, l, acc not yet
//     divided by l) per (slot, range, head); a second launch merges the
//     ranges that hold rows in range order, with the loads of 8 ranges in
//     flight at once, so two calls give the same bits (no atomics).
// Compile-time R = 512, Dr = 64 (DeepSeek-V2-Lite, every path the port
// serves) fix every loop count; any other width runs the same body with
// run-time widths (RR = DRR = 0), chosen by the launcher. The TPU kernels
// instead walk a slot's tiles (or pages) in one sequential grid row.
#include "common.cuh"

#ifndef MLA_ROWS_PER_BLOCK          // a build of the rows-per-block sweep
#define MLA_ROWS_PER_BLOCK 64       // (attn_timing.py --mla-rows-sweep)
#endif

namespace {

constexpr int kRows = MLA_ROWS_PER_BLOCK;  // cache rows per block
constexpr int kTile = 16;        // rows per score tile (the mma's n)
constexpr int kWarps = 4;        // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 16;       // heads per block (the mma's m)
constexpr int kCols = 128;       // output columns per warp in P . latent
constexpr int kLdp = kRows + 8;  // f32 P row: float2 reads on 32 banks
constexpr int kFastR = 512;     // the compile-time widths: latent
constexpr int kFastDr = 64;     // and rope
static_assert(kRows % 32 == 0 && kRows <= kThreads, "rows a block");
static_assert(kWarps * 4 == kHeads, "4 heads a warp in the softmax");

struct SlotRows {
  int S;
  __device__ __forceinline__ long operator()(int b, int pos) const {
    return (long)b * S + pos;
  }
  __host__ __device__ int length() const { return S; }
};

struct PagedRows {
  const int* pages;  // [B, pps]
  int ps, pps, num_pages;
  __device__ __forceinline__ long operator()(int b, int pos) const {
    const int page = pages[(long)b * pps + pos / ps];
    if (page < 0 || page >= num_pages) return -1;
    return (long)page * ps + pos % ps;
  }
  __host__ __device__ int length() const { return ps * pps; }
};

// Ranges of kRows rows that hold slot b's attended rows [0, hi].
__device__ __forceinline__ int ranges_of(int cur, int length) {
  const int hi = min(cur, length - 1);
  return hi >= 0 ? hi / kRows + 1 : 0;
}

// Shared memory of one block for operands of type T: q [16][ld], `sub`
// of the block's rows [sub][ld] (each row [latent, padded to 16 | rope,
// padded to 16 | 16 bytes]), P f32 [16][kLdp], m, l and the corrections
// [16]. The 16-byte pad
// puts a row's start on an odd multiple of 16 bytes modulo 128, so
// ldmatrix's 8 rows fall on 8 distinct bank groups, and f32 rows 2 tg
// (column g) on 32 distinct banks.
template <typename T, int RR, int DRR>
struct Layout {
  static constexpr int kPad = 16 / (int)sizeof(T);
  __host__ __device__ static constexpr int rp(int R) {
    return RR ? RR : (R + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int drp(int Dr) {
    return DRR ? DRR : (Dr + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int ld(int R, int Dr) {
    return rp(R) + drp(Dr) + kPad;
  }
  static size_t bytes(int R, int Dr, int sub) {
    return (size_t)(kHeads + sub) * ld(R, Dr) * sizeof(T) +
           (size_t)kHeads * (kLdp + 3) * sizeof(float);
  }
};

// Copy one row of [x (width w, padded to wp) | y (width u, padded to up)]
// into dst by one warp; src rows x_row / y_row, or nothing (zeros) where
// ok is false. vec: 16-byte cp.async (w and u whole copies, bases
// aligned); else element by element.
template <typename T, int WP, int UP>
__device__ __forceinline__ void copy_row(T* dst, const T* __restrict__ x,
                                         const T* __restrict__ y, long x_row,
                                         long y_row, bool ok, int w, int wp,
                                         int u, int up, bool vec, int lane) {
  if (vec) {
    constexpr int V = 16 / (int)sizeof(T);
    const int cx = (WP ? WP : wp) / V, cn = cx + (UP ? UP : up) / V;
#pragma unroll
    for (int j = lane; j < cn; j += 32) {
      if (j < cx) {
        const int d = j * V;
        const bool in = ok && d < w;
        cp_async16(dst + d, in ? x + x_row * w + d : x, in);
      } else {
        const int d = (j - cx) * V;
        const bool in = ok && d < u;
        cp_async16(dst + (WP ? WP : wp) + d, in ? y + y_row * u + d : y, in);
      }
    }
  } else {
    const T zero = from_f<T>(0.f);
    const int xw = WP ? WP : wp, n = xw + (UP ? UP : up);
    for (int j = lane; j < n; j += 32) {
      if (j < xw)
        dst[j] = ok && j < w ? x[x_row * w + j] : zero;
      else
        dst[j] = ok && j - xw < u ? y[y_row * u + j - xw] : zero;
    }
  }
}

// acc[j] (output columns e0 + j * 8 + 2 tg, +1 of heads g, g + 8) +=
// P . latent over the block's first n_tiles tiles of rows. ncol: columns
// of this warp's chunk that exist (kCols at compile-time widths).
template <typename T>
__device__ __forceinline__ void block_pv(float (&acc)[kCols / 8][4],
                                         const float* p_s, const T* t_s,
                                         int ld, int n_tiles, int e0,
                                         int ncol, int lane) {
  const int g = lane >> 2, tg = lane & 3;
  if constexpr (sizeof(T) == 4) {
    for (int k0 = 0; k0 < n_tiles * kTile; k0 += 8) {
      // mma k = tg <-> row k0 + 2 tg, k = tg + 4 <-> row k0 + 2 tg + 1
      const float2 x0 = *reinterpret_cast<const float2*>(
          p_s + g * kLdp + k0 + 2 * tg);
      const float2 x1 = *reinterpret_cast<const float2*>(
          p_s + (g + 8) * kLdp + k0 + 2 * tg);
      unsigned ahi[4], alo[4];
      split_tf32(x0.x, ahi[0], alo[0]);
      split_tf32(x1.x, ahi[1], alo[1]);
      split_tf32(x0.y, ahi[2], alo[2]);
      split_tf32(x1.y, ahi[3], alo[3]);
      const float* v0 = reinterpret_cast<const float*>(t_s) +
                        (k0 + 2 * tg) * ld + e0 + g;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        if (j * 8 >= ncol) break;
        unsigned bhi[2], blo[2];
        split_tf32(v0[j * 8], bhi[0], blo[0]);
        split_tf32(v0[ld + j * 8], bhi[1], blo[1]);
        mma_tf32(acc[j], alo, bhi);
        mma_tf32(acc[j], ahi, blo);
        mma_tf32(acc[j], ahi, bhi);
      }
    }
  } else {
    const int lr = lane & 7, lm = lane >> 3;
    for (int t = 0; t < n_tiles; ++t) {
      const float* p0 = p_s + g * kLdp + t * kTile + 2 * tg;
      const float2 x0 = *reinterpret_cast<const float2*>(p0);
      const float2 x1 = *reinterpret_cast<const float2*>(p0 + 8 * kLdp);
      const float2 x2 = *reinterpret_cast<const float2*>(p0 + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(p0 + 8 * kLdp + 8);
      const unsigned a[4] = {bf16x2_of(x0.x, x0.y), bf16x2_of(x1.x, x1.y),
                             bf16x2_of(x2.x, x2.y), bf16x2_of(x3.x, x3.y)};
      const T* vr = t_s + (t * kTile + (lm & 1) * 8 + lr) * ld + e0 +
                    (lm >> 1) * 8;
#pragma unroll
      for (int j = 0; j < kCols / 8; j += 2) {
        if (j * 8 >= ncol) break;
        unsigned w[4];
        ldsm_x4_t(w, vr + j * 8);
        mma_bf16(acc[j], a, w);
        mma_bf16(acc[j + 1], a, w + 2);
      }
    }
  }
}

// Block (b, r, z): rows [r * kRows, + kRows) of slot b for heads [16 zh,
// 16 zh + 16) and output columns [512 zc, 512 zc + 512), z = zh * chunks
// + zc -> the f32 partial (m in base 2, l, acc not yet divided by l) of
// range r, rows (b * ranges + r) * H + h of part_*.
template <typename T, typename Rows, int RR, int DRR>
__global__ void __launch_bounds__(kThreads)
mla_partial_kernel(const T* __restrict__ q_abs, const T* __restrict__ q_rope,
                   const T* __restrict__ latent, const T* __restrict__ rope,
                   const int* __restrict__ cur_pos,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, Rows rows, int H, int R,
                   int Dr, float scale_log2, int vec, int sub) {
  using L = Layout<T, RR, DRR>;
  extern __shared__ __align__(16) unsigned char mla_smem[];
  __shared__ long row_s[kRows];      // cache row of each block row, or -1
  const int b = blockIdx.x, r = blockIdx.y;
  const int chunks = RR ? 1 : (R + kWarps * kCols - 1) / (kWarps * kCols);
  const int zh = blockIdx.z / chunks, zc = blockIdx.z - zh * chunks;
  const int row0 = r * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // where this block's rows live, read beside cur_pos (the page table's
  // entries exist for every row of the table), not after it
  long rr = -1;
  if (tid < kRows && row0 + tid < rows.length()) rr = rows(b, row0 + tid);
  const int hi = min(cur_pos[b], rows.length() - 1);
  if (r >= ranges_of(hi, rows.length())) return;  // no rows: nothing written
  const int n_rows = min(kRows, hi + 1 - row0);   // attended, from row0

  const int g = lane >> 2, tg = lane & 3;
  const int Rp = L::rp(R), Drp = L::drp(Dr), ld = L::ld(R, Dr);
  const int h0 = zh * kHeads;
  const bool vec_ok = vec != 0;
  T* q_s = reinterpret_cast<T*>(mla_smem);
  T* t_s = q_s + kHeads * ld;
  float* p_s = reinterpret_cast<float*>(t_s + sub * ld);
  float* m_s = p_s + kHeads * kLdp;
  float* l_s = m_s + kHeads;
  float* c_s = l_s + kHeads;

  // q's rows h0.. (zeros past H), one warp a row; the rows resolved once
  for (int hh = warp; hh < kHeads; hh += kWarps) {
    const int h = h0 + hh;
    copy_row<T, RR, DRR>(q_s + hh * ld, q_abs, q_rope, (long)b * H + h,
                         (long)b * H + h, h < H, R, Rp, Dr, Drp, vec_ok,
                         lane);
  }
  if (tid < kRows) row_s[tid] = row0 + tid <= hi ? rr : -1;
  if (tid < kHeads) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int e0 = zc * kWarps * kCols + warp * kCols;  // this warp's columns
  const int ncol = RR ? kCols : min(kCols, R - e0);
  float acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // the block's rows in passes of `sub` (all of them at once on every
  // path the port serves; fewer where a row is too wide for shared
  // memory), with the softmax carried across passes online. The
  // compile-time widths always fit one pass: no correction there.
  constexpr bool kOnePass = RR != 0;
  auto run_pass = [&](int p0, int n_tiles) {
    const long* prow = row_s + p0;
    __syncthreads();  // row_s is set; the last pass's reads are done
    // this pass's rows (whole tiles up to the last attended row), all in
    // flight at once
    for (int s = warp; s < n_tiles * kTile; s += kWarps) {
      const long row = prow[s];
      copy_row<T, RR, DRR>(t_s + s * ld, latent, rope, row, row, row >= 0,
                           R, Rp, Dr, Drp, vec_ok, lane);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // scores, base 2, into P: tile t's 16 rows are P's columns 16 t..
    for (int t = warp; t < n_tiles; t += kWarps) {
      float s[2][4];
      mma_tile16_scores<T, RR + DRR>(s, q_s, ld, t_s + t * kTile * ld, ld,
                                     Rp + Drp, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = t * kTile + n * 8 + 2 * tg;
        const bool ok0 = prow[c] >= 0, ok1 = prow[c + 1] >= 0;
        *reinterpret_cast<float2*>(p_s + g * kLdp + c) = make_float2(
            ok0 ? s[n][0] * scale_log2 : -INFINITY,
            ok1 ? s[n][1] * scale_log2 : -INFINITY);
        *reinterpret_cast<float2*>(p_s + (g + 8) * kLdp + c) = make_float2(
            ok0 ? s[n][2] * scale_log2 : -INFINITY,
            ok1 ? s[n][3] * scale_log2 : -INFINITY);
      }
    }
    __syncthreads();

    // the softmax over the pass's rows, carried online: warp w heads
    // 4 w.., 8 lanes a head, lane columns c0, c0 + 8, ...; exponentials
    // in place, and each head's correction of what came before
    {
      const int hh = warp * 4 + (lane >> 3), c0 = lane & 7;
      const int ncol_p = n_tiles * kTile;
      float* pr = p_s + hh * kLdp;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
        if (c0 + 8 * j < ncol_p) mx = fmaxf(mx, pr[c0 + 8 * j]);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[hh];
      const float m_new = fmaxf(m_old, mx);
      // -inf: no row with data so far; then every p and the correction
      // are 0
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
        if (c0 + 8 * j < ncol_p) {
          const float p = exp2f(pr[c0 + 8 * j] - mu);
          pr[c0 + 8 * j] = p;
          sum += p;
        }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();                   // every lane has read m_s[hh]
      if (c0 == 0) {
        const float corr = exp2f(m_old - mu);
        m_s[hh] = m_new;
        l_s[hh] = l_s[hh] * corr + sum;
        c_s[hh] = corr;
      }
    }
    __syncthreads();

    if (ncol > 0) {
      if constexpr (!kOnePass) {
        const float c_lo = c_s[g], c_hi = c_s[g + 8];
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          acc[j][0] *= c_lo;
          acc[j][1] *= c_lo;
          acc[j][2] *= c_hi;
          acc[j][3] *= c_hi;
        }
      }
      block_pv<T>(acc, p_s, t_s, ld, n_tiles, e0, ncol, lane);
    }
  };
  if constexpr (kOnePass) {
    run_pass(0, (n_rows + kTile - 1) / kTile);
  } else {
    for (int p0 = 0; p0 < n_rows; p0 += sub)
      run_pass(p0, (min(sub, n_rows - p0) + kTile - 1) / kTile);
  }
  // (m_s / l_s of the last pass are visible: a barrier followed them)
  const long part = (long)b * gridDim.y + r;
  if (ncol > 0) {
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int e = j * 8 + 2 * tg;
      if (e >= ncol) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = h0 + g + half * 8;
        if (h >= H) continue;
        float* dst = part_acc + (part * H + h) * R + e0 + e;
        if (RR || (R % 2 == 0)) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        } else {
          dst[0] = acc[j][2 * half];
          if (e + 1 < ncol) dst[1] = acc[j][2 * half + 1];
        }
      }
    }
  }
  if (zc == 0 && tid < kHeads && h0 + tid < H) {
    part_m[part * H + h0 + tid] = m_s[tid];   // -inf: no row with data
    part_l[part * H + h0 + tid] = l_s[tid];
  }
}

// out[b, h, e] = sum_j acc_j 2^(m_j - M) / sum_j l_j 2^(m_j - M) over the
// ranges j that hold rows of slot b (from cur_pos, in range order), M the
// largest m_j, taken as a running maximum; 0 where no range saw a row
// with data.
template <typename Rows>
__global__ void mla_merge_kernel(const float* __restrict__ part_m,
                                 const float* __restrict__ part_l,
                                 const float* __restrict__ part_acc,
                                 const int* __restrict__ cur_pos,
                                 float* __restrict__ out, Rows rows, int n,
                                 int H, int R, int ranges) {
  constexpr int kBatch = 8;          // ranges whose loads are in flight
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int bh = i / R, e = i - bh * R;        // bh = b * H + h
  const int b = bh / H, h = bh - b * H;
  const int nr = ranges_of(cur_pos[b], rows.length());
  float M = -INFINITY, Ls = 0.f, A = 0.f;
  for (int j0 = 0; j0 < nr; j0 += kBatch) {
    float mj[kBatch], lj[kBatch], aj[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long pj = ((long)b * ranges + min(j0 + u, nr - 1)) * H + h;
      const bool in = j0 + u < nr;
      mj[u] = in ? part_m[pj] : -INFINITY;
      lj[u] = in ? part_l[pj] : 0.f;
      aj[u] = in ? part_acc[pj * R + e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float mn = fmaxf(M, mj[u]);
      if (mn == -INFINITY) continue;      // no row with data so far
      const float c = exp2f(M - mn), w = exp2f(mj[u] - mn);
      Ls = Ls * c + lj[u] * w;
      A = A * c + aj[u] * w;
      M = mn;
    }
  }
  out[i] = A / fmaxf(Ls, 1e-30f);
}

// The compile-time widths (R = 512, Dr = 64) or run-time ones.
__host__ __device__ constexpr bool fast_widths(int R, int Dr) {
  return R == kFastR && Dr == kFastDr;
}

template <typename T>
size_t smem_of(int R, int Dr, int sub) {
  return fast_widths(R, Dr) ? Layout<T, kFastR, kFastDr>::bytes(R, Dr, sub)
                            : Layout<T, 0, 0>::bytes(R, Dr, sub);
}

// Rows a pass stages: all kRows where they fit a block's shared memory
// (every path the port serves), else the most of kRows / 2, ..., 16 that
// fit (16 where none does: the launch is then refused, and R4 names it).
int sub_of(int R, int Dr, int dtype) {
  int sub = kRows;
  for (; sub > kTile; sub /= 2) {
    const size_t bytes = dtype == DT_BF16 ? smem_of<__nv_bfloat16>(R, Dr, sub)
                                          : smem_of<float>(R, Dr, sub);
    if (bytes + sizeof(long) * kRows <= 232448) break;
  }
  return sub;
}

// The two launches of one call; returns their count. `ranges` is the
// cache length over kRows, rounded up (grid.y).
int config(int B, int H, int R, int Dr, int ranges, int paged, int dtype,
           LaunchRec* r, bool names) {
  const bool fast = fast_widths(R, Dr);
  const int sub = sub_of(R, Dr, dtype);
  const size_t smem = dtype == DT_BF16 ? smem_of<__nv_bfloat16>(R, Dr, sub)
                                       : smem_of<float>(R, Dr, sub);
  const int chunks = fast ? 1 : (R + kWarps * kCols - 1) / (kWarps * kCols);
  const int z = (H + kHeads - 1) / kHeads * chunks;
  const char* rn = paged ? "PagedRows" : "SlotRows";
  set_launch(&r[0], names, dim3(B, ranges, z), kThreads, smem,
             "mla_partial_kernel<%s,%s,%d,%d>", dt_name(dtype), rn,
             fast ? kFastR : 0, fast ? kFastDr : 0);
  const long n = (long)B * H * R;
  set_launch(&r[1], names, dim3((unsigned)((n + 255) / 256)), 256, 0,
             "mla_merge_kernel<%s>", rn);
  return 2;
}

template <typename Rows> constexpr int is_paged();
template <> constexpr int is_paged<SlotRows>() { return 0; }
template <> constexpr int is_paged<PagedRows>() { return 1; }

template <typename T, typename Rows, int RR, int DRR>
cudaError_t launch_widths(const LaunchRec* r, const T* q_abs,
                          const T* q_rope, const T* latent, const T* rope,
                          const int* cur_pos, float* part_m, float* part_l,
                          float* part_acc, float* out, Rows rows, int B,
                          int H, int R, int Dr, float scale, int vec,
                          cudaStream_t st) {
  auto kern = mla_partial_kernel<T, Rows, RR, DRR>;
  static size_t allowed[kSmemDevices] = {};   // the opt-in, once
  cudaError_t e = allow_smem_once(kern, r[0].smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(r[0]), r[0].threads, r[0].smem, st>>>(
      q_abs, q_rope, latent, rope, cur_pos, part_m, part_l, part_acc, rows,
      H, R, Dr, scale * 1.4426950408889634f, vec,
      sub_of(R, Dr, dtype_of<T>()));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = B * H * R;
  mla_merge_kernel<Rows><<<grid_of(r[1]), r[1].threads, 0, st>>>(
      part_m, part_l, part_acc, cur_pos, out, rows, n, H, R, r[0].grid[1]);
  return cudaGetLastError();
}

template <typename T, typename Rows>
cudaError_t launch(const void* q_abs, const void* q_rope, const void* latent,
                   const void* rope, const int* cur_pos, float* part_m,
                   float* part_l, float* part_acc, float* out, Rows rows,
                   int B, int H, int R, int Dr, float scale, int ranges,
                   cudaStream_t st) {
  if (ranges != (rows.length() + kRows - 1) / kRows)
    return cudaErrorInvalidValue;     // the wrapper's kRows is not ours
  LaunchRec r[kMaxLaunches];
  config(B, H, R, Dr, ranges, is_paged<Rows>(), dtype_of<T>(), r, false);
  constexpr int V = 16 / (int)sizeof(T);
  const int vec = R % V == 0 && Dr % V == 0 &&
                  reinterpret_cast<size_t>(q_abs) % 16 == 0 &&
                  reinterpret_cast<size_t>(q_rope) % 16 == 0 &&
                  reinterpret_cast<size_t>(latent) % 16 == 0 &&
                  reinterpret_cast<size_t>(rope) % 16 == 0;
  const T* qa = static_cast<const T*>(q_abs);
  const T* qr = static_cast<const T*>(q_rope);
  const T* lt = static_cast<const T*>(latent);
  const T* rp = static_cast<const T*>(rope);
  if (fast_widths(R, Dr))
    return launch_widths<T, Rows, kFastR, kFastDr>(
        r, qa, qr, lt, rp, cur_pos, part_m, part_l, part_acc, out, rows, B,
        H, R, Dr, scale, vec, st);
  return launch_widths<T, Rows, 0, 0>(r, qa, qr, lt, rp, cur_pos, part_m,
                                      part_l, part_acc, out, rows, B, H, R,
                                      Dr, scale, vec, st);
}

template <typename Rows>
int dispatch(const void* q_abs, const void* q_rope, const void* latent,
             const void* rope, const int* cur_pos, float* part_m,
             float* part_l, float* part_acc, float* out, Rows rows, int B,
             int H, int R, int Dr, float scale, int ranges, int dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)launch<float>(q_abs, q_rope, latent, rope, cur_pos, part_m,
                              part_l, part_acc, out, rows, B, H, R, Dr,
                              scale, ranges, st);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(q_abs, q_rope, latent, rope, cur_pos,
                                      part_m, part_l, part_acc, out, rows, B,
                                      H, R, Dr, scale, ranges, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_abs [B, H, R], q_rope [B, H, Dr], latent [B, S, R], rope [B, S, Dr],
// cur_pos int32 [B] -> out f32 [B, H, R]; contiguous, the four inputs of
// one dtype. `splits` is the number of row ranges, ceil(S / kRows);
// part_m / part_l f32 scratch of B*splits*H, part_acc of B*splits*H*R.
extern "C" int repro_mla_decode_attn(
    const void* q_abs, const void* q_rope, const void* latent,
    const void* rope, const int* cur_pos, float* part_m, float* part_l,
    float* part_acc, float* out, int B, int H, int R, int Dr, int S,
    float scale, int splits, int dtype, void* stream) {
  if (B < 1 || H < 1 || R < 1 || Dr < 1 || S < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch(q_abs, q_rope, latent, rope, cur_pos, part_m, part_l,
                  part_acc, out, SlotRows{S}, B, H, R, Dr, scale, splits,
                  dtype, stream);
}

// As repro_mla_decode_attn over the pools latent [num_pages, ps, R] /
// rope [num_pages, ps, Dr] through pages int32 [B, pps] (-1 = unallocated);
// `splits` is ceil(pps * ps / kRows).
extern "C" int repro_mla_paged_decode_attn(
    const void* q_abs, const void* q_rope, const void* latent_pool,
    const void* rope_pool, const int* pages, const int* cur_pos,
    float* part_m, float* part_l, float* part_acc, float* out, int B, int H,
    int R, int Dr, int num_pages, int ps, int pps, float scale, int splits,
    int dtype, void* stream) {
  if (B < 1 || H < 1 || R < 1 || Dr < 1 || num_pages < 1 || ps < 1 ||
      pps < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch(q_abs, q_rope, latent_pool, rope_pool, cur_pos, part_m,
                  part_l, part_acc, out, PagedRows{pages, ps, pps, num_pages},
                  B, H, R, Dr, scale, splits, dtype, stream);
}

// `splits`: the row ranges (grid.y) as the wrapper passes them.
extern "C" int repro_mla_decode_attn_launch_config(int B, int H, int R,
                                                   int Dr, int splits,
                                                   int paged, int dtype,
                                                   LaunchRec* r) {
  return config(B, H, R, Dr, splits, paged, dtype, r, true);
}
