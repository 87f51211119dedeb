// Fused one-token GQA decode attention for Hopper, over the slot cache
// (#1) and over the block-paged pool (#4): one templated kernel, two row
// policies.
//
// Replaces the TPU kernels src/repro/kernels/decode_attn.py:129
// gqa_decode_attn_2d (body _gqa_kernel; entry repro_gqa_decode_attn) and
// decode_attn.py:444 gqa_paged_decode_attn_2d (body _paged_gqa_kernel;
// entry repro_gqa_paged_decode_attn). q [B, Hkv, G, D] against K/V rows
// of D / Dv values, per slot b and KV head h:
//
//   out[b, h, g] = sum_p softmax_p(q[b, h, g] . k[p] / sqrt(D)) v[p]
//
// over the rows p <= cur_pos[b] (and p > cur_pos[b] - window when window
// > 0), f32 softmax. A cur_pos past the cache (the engine's invalid lanes
// use 2**30) attends every present row; a slot with no row writes 0. The
// two entry points differ only in where row p of (b, h) lives:
//
//   SlotRows   k [B, Hkv, S, D]          -> (b * Hkv + h) * S + p
//   PagedRows  k [num_pages, Hkv, ps, D] -> (page * Hkv + h) * ps + p % ps
//              with page = pages[b, p / ps]; -1 (unallocated) or a page
//              id outside the pool is absent and never read, as the TPU
//              kernel's `page >= 0 && tile valid` test skips it.
//
// What bounds it on the H100: every attended row is read once and feeds
// 2 * G * (D + Dv) flops (32 flops a byte in bf16 at G = 8), so the
// kernel is bound by the bytes of each slot's attended K/V rows — 7.4 MB
// at the smoke run's positions, 2.2 us at 3.35 TB/s — not by the cache
// length. At these sizes a launch and one trip to device memory cost
// about as much again.
//
// Design:
//   - work from the attended rows: block (b * Hkv + h, r, z) takes the
//     kRows rows from row first + r * kRows, where first is the start of
//     the tile that holds the slot's first attended row. The grid is sized
//     from the cache length (no host sync on cur_pos); a block past the
//     slot's attended rows exits before it stages anything, and writes no
//     partial. z covers groups of 16 query heads (the mma's m) and, where
//     the head dim has no compile-time tile, column chunks of the output;
//   - a compile-time head-dim tile HD (128, which covers D and Dv on every
//     path the port serves; 0 = any D at run time): every copy loop
//     and k-step has a fixed count, unrolled without a division, and bf16
//     q's A fragments stay in registers. With one block of 4 warps on an
//     SM there is no other warp to hide a dependent instruction's latency,
//     so the length of each warp's chain of instructions is the kernel's
//     time at these sizes (measured: PERF.md);
//   - warp tiles of 16 rows, each warp owning tiles warp, warp + W, ...
//     of the block's rows, copied whole in the input type by 16-byte
//     cp.async (neighbouring lanes on neighbouring addresses) into a ring
//     of kStages stages of the warp's own: the next tile is in flight
//     while this one is computed, and only the ring's waits (cp.async
//     wait + __syncwarp) remain per tile, no block barrier. Each tile's
//     16 rows are resolved once (lanes 0..15, one row each: the page
//     table for PagedRows) and handed to the copying lanes by a shuffle;
//     a row outside [lo, hi] or in an absent page is zero-filled by the
//     copy (src-size 0) and masked, never read. A page of 16 rows x 128
//     bf16 values is 4 KB of contiguous bytes per (page, head). q's rows
//     come by cp.async with the first stage. Where D or Dv is not whole
//     16-byte copies or a base is unaligned, an element-wise path fills
//     the same stages;
//   - scores and P.V on the tensor cores (mma.sync). bf16: m16n8k16, q's
//     rows (padded with zeros to 16) the A operand, K's rows the B operand
//     by ldmatrix, the score accumulators repacked as the A fragments of
//     P.V in registers (as FlashAttention-2), V by ldmatrix.trans. f32:
//     m16n8k8 in the 3xTF32 form (split_tf32, f32's accuracy); the score
//     accumulators are P.V's A fragments with the contraction order
//     permuted (mma k = tg <-> row 2 tg, k = tg + 4 <-> row 2 tg + 1), V
//     read by scalar loads on 32 banks. The row maximum and sum come from
//     quad shuffles; scores are kept in base 2 (scale * log2 e), the online
//     (m, l, acc) state in registers;
//   - the warps of a block merge once at the end, in warp order, through
//     shared memory (aliasing the ring), into one f32 partial (m, l, acc)
//     per (slot, head, range); a second launch merges the ranges that hold
//     rows (their count worked out from cur_pos on the device) in range
//     order, with the loads of 8 ranges in flight at once, so two calls
//     give the same bits. The TPU kernels instead walk a slot's tiles (or
//     pages) in one sequential grid row.
#include <type_traits>

#include "common.cuh"

#ifndef GQA_ROWS_PER_BLOCK          // a build of the rows-per-block sweep
#define GQA_ROWS_PER_BLOCK 128      // (attn_timing.py --rows-sweep) sets it
#endif

namespace {

constexpr int kRows = GQA_ROWS_PER_BLOCK;  // cache rows per block
constexpr int kTile = 16;        // rows per warp tile (the mma's n and k)
constexpr int kStages = 2;       // ring stages per warp
constexpr int kWarps = 4;        // warps per block, fewer where D is wide
constexpr int kGroup = 16;       // query heads per block (the mma's m)
static_assert(kRows % kTile == 0, "a block takes whole tiles");

struct SlotRows {
  int S, Hkv;
  __device__ __forceinline__ long operator()(int b, int h, int pos) const {
    return ((long)b * Hkv + h) * S + pos;
  }
  __host__ __device__ int length() const { return S; }
};

struct PagedRows {
  const int* pages;  // [B, pps]
  int ps, pps, num_pages, Hkv;
  __device__ __forceinline__ long operator()(int b, int h, int pos) const {
    const int page = pages[(long)b * pps + pos / ps];
    if (page < 0 || page >= num_pages) return -1;
    return ((long)page * Hkv + h) * ps + pos % ps;
  }
  __host__ __device__ int length() const { return ps * pps; }
};

// A slot's attended rows [lo, hi], the first row of the tile that holds
// lo, and how many blocks of kRows rows from there hold rows.
struct Span {
  int lo, hi, first;
  __device__ __forceinline__ int ranges() const {
    return hi >= lo ? (hi - first) / kRows + 1 : 0;
  }
};

__device__ __forceinline__ Span span_of(int cur, int length, int window) {
  Span s;
  s.hi = min(cur, length - 1);
  s.lo = window > 0 ? (int)max(0L, (long)cur - window + 1) : 0;
  s.first = s.lo / kTile * kTile;
  return s;
}

// The head-dim tile HD of a launch: 128 where D and Dv fit in it (every
// path the port serves; a narrower head is zero-padded), else 0: D padded
// to 16 at run time and Dv in chunks of 128 across grid.z. With HD = 128
// every copy loop and k-step has a compile-time count (unrolled, no
// divisions), and bf16 q stays in registers.
__host__ __device__ constexpr int hd_of(int D, int Dv) {
  return D <= 128 && Dv <= 128 ? 128 : 0;
}

// Shared memory of one block for operands of type T: q [16][ldk], then
// kStages stages per warp of K [16][ldk] and V [16][ldv]; the warps'
// merge (f32 acc [W][16][VT + 8], their weights and sums [W][16]) reuses
// the ring. The pads (16 bytes a row) put a row's start on an odd multiple
// of 16 bytes modulo 128, so ldmatrix's 8 rows fall on 8 distinct bank
// groups, and f32 V's scalar reads (rows 2 tg, column g) on 32 distinct
// banks; the merge's 8 floats a row put a warp's float2 stores on two
// wavefronts.
template <typename T, int HD>
struct Layout {
  static constexpr int kPad = 16 / (int)sizeof(T);
  static constexpr int VT = 128;                // output columns a block
  static constexpr int kLdv = VT + kPad;
  static constexpr int kLdr = VT + 8;           // f32 merge rows (float2)
  __host__ __device__ static constexpr int dk(int D) {
    return HD ? HD : (D + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int ldk(int D) { return dk(D) + kPad; }
  __host__ __device__ static constexpr int stage(int D) {
    return kTile * (ldk(D) + kLdv);
  }
  static size_t bytes(int D, int warps) {
    const size_t q = (size_t)kGroup * ldk(D) * sizeof(T);
    const size_t ring = (size_t)warps * kStages * stage(D) * sizeof(T);
    const size_t red = (size_t)warps * kGroup * (kLdr + 2) * sizeof(float);
    return q + (ring > red ? ring : red);
  }
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy one warp tile of 16 rows from p0: K [16][dk] and V columns
// [e0, e0 + VT) into stage (ks, vs); returns the mask of the rows that
// hold data (bit s for row p0 + s). Lane s < 16 resolves row p0 + s. Every
// loop has a multiple of 32 trips (dk and VT are multiples of 16), so its
// shuffles run on all lanes.
template <typename T, int HD, typename Rows>
__device__ __forceinline__ unsigned load_tile(
    T* ks, T* vs, const T* __restrict__ k, const T* __restrict__ v,
    const Rows& rows, int b, int h, int p0, const Span& sp, int D, int Dv,
    int e0, bool vec, int lane) {
  using L = Layout<T, HD>;
  const int dk = L::dk(D), ldk = L::ldk(D);
  long rr = -1;
  if (lane < kTile) {
    const int pos = p0 + lane;
    if (pos >= sp.lo && pos <= sp.hi) rr = rows(b, h, pos);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, rr >= 0) & 0xffffu;
  if (vec) {
    constexpr int V = 16 / (int)sizeof(T);
    const int kc = dk / V;                  // copies per K row
#pragma unroll
    for (int c = lane; c < kTile * kc; c += 32) {
      const int s = c / kc, d = (c - s * kc) * V;
      const long row = __shfl_sync(0xffffffffu, rr, s);
      const bool ok = row >= 0 && d < D;
      cp_async16(ks + s * ldk + d, ok ? k + row * D + d : k, ok);
    }
    constexpr int vc = L::VT / V;           // copies per V row
#pragma unroll
    for (int c = lane; c < kTile * vc; c += 32) {
      const int s = c / vc, d = (c - s * vc) * V;
      const long row = __shfl_sync(0xffffffffu, rr, s);
      const bool ok = row >= 0 && e0 + d < Dv;
      cp_async16(vs + s * L::kLdv + d, ok ? v + row * Dv + e0 + d : v, ok);
    }
  } else {                                  // element-wise, same stages
    const T zero = from_f<T>(0.f);
    for (int c = lane; c < kTile * dk; c += 32) {
      const int s = c / dk, d = c - s * dk;
      const long row = __shfl_sync(0xffffffffu, rr, s);
      ks[s * ldk + d] = row >= 0 && d < D ? k[row * D + d] : zero;
    }
    for (int c = lane; c < kTile * L::VT; c += 32) {
      const int s = c / L::VT, d = c - s * L::VT;
      const long row = __shfl_sync(0xffffffffu, rr, s);
      vs[s * L::kLdv + d] = row >= 0 && e0 + d < Dv ? v[row * Dv + e0 + d]
                                                    : zero;
    }
  }
  return mask;
}

// q's A fragments of the k-steps: held in registers for bf16 at a
// compile-time head dim (HD / 16 steps x 4 words), read from shared
// memory by ldmatrix otherwise.
template <typename T, int HD>
struct QFrags {
  static constexpr bool kRegs = HD > 0 && !std::is_same<T, float>::value;
  unsigned a[kRegs ? HD / 16 : 1][4];
  __device__ __forceinline__ void load(const T* q_s, int ldk, int lane) {
    if constexpr (kRegs) {
      const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(a[kk], q_s + ((lm & 1) * 8 + lr) * ldk + kk * 16 +
                           (lm >> 1) * 8);
    }
  }
};

// The 16 x 16 scores of one tile: s[n8 tile][4] in the mma C layout
// (row g: s[n][0..1] at columns n * 8 + 2 tg, +1; row g + 8: s[n][2..3]).
template <typename T, int HD>
__device__ __forceinline__ void tile_scores(float (&s)[2][4],
                                            const QFrags<T, HD>& qf,
                                            const T* q_s, const T* ks,
                                            int D, int lane) {
  using L = Layout<T, HD>;
  const int dk = L::dk(D), ldk = L::ldk(D);
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < dk; kk += 8) {
      unsigned a[4], w[4], ahi[4], alo[4], bhi[4], blo[4];
      ldsm_x4(a, q_s + ((lm & 1) * 8 + lr) * ldk + kk + (lm >> 1) * 4);
      ldsm_x4(w, ks + ((lm >> 1) * 8 + lr) * ldk + kk + (lm & 1) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split_tf32(__uint_as_float(a[i]), ahi[i], alo[i]);
        split_tf32(__uint_as_float(w[i]), bhi[i], blo[i]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) mma_tf32(s[n], alo, bhi + 2 * n);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma_tf32(s[n], ahi, blo + 2 * n);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma_tf32(s[n], ahi, bhi + 2 * n);
    }
  } else if constexpr (QFrags<T, HD>::kRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned w[4];
      ldsm_x4(w, ks + ((lm >> 1) * 8 + lr) * ldk + kk * 16 + (lm & 1) * 8);
      mma_bf16(s[0], qf.a[kk], w);
      mma_bf16(s[1], qf.a[kk], w + 2);
    }
  } else {
    for (int kk = 0; kk < dk; kk += 16) {
      unsigned a[4], w[4];
      ldsm_x4(a, q_s + ((lm & 1) * 8 + lr) * ldk + kk + (lm >> 1) * 8);
      ldsm_x4(w, ks + ((lm >> 1) * 8 + lr) * ldk + kk + (lm & 1) * 8);
      mma_bf16(s[0], a, w);
      mma_bf16(s[1], a, w + 2);
    }
  }
}

// acc[j] (output columns j * 8 + 2 tg, +1 of rows g, g + 8) += P . V over
// the tile's 16 rows, P = the probabilities in s.
template <typename T, int HD>
__device__ __forceinline__ void tile_pv(
    float (&acc)[Layout<T, HD>::VT / 8][4], const float (&s)[2][4],
    const T* vs, int lane) {
  constexpr int VT = Layout<T, HD>::VT, ldv = Layout<T, HD>::kLdv;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {    // rows kt * 8 + 2 tg and + 1
      unsigned ahi[4], alo[4];
      split_tf32(s[kt][0], ahi[0], alo[0]);
      split_tf32(s[kt][2], ahi[1], alo[1]);
      split_tf32(s[kt][1], ahi[2], alo[2]);
      split_tf32(s[kt][3], ahi[3], alo[3]);
      const float* v0 = vs + (kt * 8 + 2 * tg) * ldv + g;
#pragma unroll
      for (int j = 0; j < VT / 8; ++j) {
        unsigned bhi[2], blo[2];
        split_tf32(v0[j * 8], bhi[0], blo[0]);
        split_tf32(v0[ldv + j * 8], bhi[1], blo[1]);
        mma_tf32(acc[j], alo, bhi);
        mma_tf32(acc[j], ahi, blo);
        mma_tf32(acc[j], ahi, bhi);
      }
    }
  } else {
    const int lr = lane & 7, lm = lane >> 3;
    const unsigned a[4] = {pack_bf16(s[0][0], s[0][1]),
                           pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]),
                           pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < VT / 8; j += 2) {
      unsigned w[4];
      ldsm_x4_t(w, vs + ((lm & 1) * 8 + lr) * ldv + j * 8 + (lm >> 1) * 8);
      mma_bf16(acc[j], a, w);
      mma_bf16(acc[j + 1], a, w + 2);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Block (b * Hkv + h, r, z): rows [first + r * kRows, + kRows) of (b, h)
// for query heads [16 zg, 16 zg + 16) and output columns [VT zc, VT zc +
// VT), z = zg * chunks + zc -> the f32 partial (m in base 2, l, acc not
// yet divided by l) of range r, rows (b * Hkv + h) * R + r of part_*.
template <typename Rows, typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
gqa_decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ cur_pos,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc, Rows rows, int Hkv,
                          int G, int D, int Dv, float scale_log2,
                          int window, int vec) {
  using L = Layout<T, HD>;
  constexpr int VT = L::VT;
  extern __shared__ __align__(16) unsigned char gqa_smem[];
  __shared__ unsigned tile_mask[kWarps][kStages];
  const int bh = blockIdx.x, b = bh / Hkv, h = bh - b * Hkv;
  const int r = blockIdx.y, R = gridDim.y;
  const int chunks = HD ? 1 : (Dv + VT - 1) / VT;
  const int zg = blockIdx.z / chunks, zc = blockIdx.z - zg * chunks;
  const Span sp = span_of(cur_pos[b], rows.length(), window);
  if (r >= sp.ranges()) return;            // no rows here: nothing written
  const int row0 = sp.first + r * kRows;
  const int n_tiles = (min(row0 + kRows, sp.hi + 1) - row0 + kTile - 1) /
                      kTile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int dk = L::dk(D), ldk = L::ldk(D);
  const int g0 = zg * kGroup, e0 = zc * VT;
  T* q_s = reinterpret_cast<T*>(gqa_smem);
  T* ring = q_s + kGroup * ldk + warp * kStages * L::stage(D);

  // q's rows g0.. (zeros past G and past D), shared by the warps, copied
  // with the first stage: a chain of element loads here would cost a trip
  // to device memory each
  const bool vec_ok = vec != 0;
  const T* qb = q + ((long)bh * G + g0) * D;
  if (vec_ok) {
    constexpr int V = 16 / (int)sizeof(T);
    const int qc = dk / V;
    for (int c = tid; c < kGroup * qc; c += blockDim.x) {
      const int gi = c / qc, d = (c - gi * qc) * V;
      const bool ok = g0 + gi < G && d < D;
      cp_async16(q_s + gi * ldk + d, ok ? qb + (long)gi * D + d : q, ok);
    }
  } else {
    const T zero = from_f<T>(0.f);
    for (int i = tid; i < kGroup * dk; i += blockDim.x) {
      const int gi = i / dk, d = i - gi * dk;
      q_s[gi * ldk + d] = g0 + gi < G && d < D ? qb[(long)gi * D + d]
                                               : zero;
    }
  }

  // this warp's tiles warp, warp + W, ...: the first kStages in flight
  const int mine = n_tiles > warp ? (n_tiles - warp + W - 1) / W : 0;
  for (int i = 0; i < kStages; ++i) {
    if (i < mine) {
      T* ks = ring + i * L::stage(D);
      const unsigned m = load_tile<T, HD>(
          ks, ks + kTile * ldk, k, v, rows, b, h, row0 + (warp + i * W) * kTile,
          sp, D, Dv, e0, vec_ok, lane);
      if (lane == 0) tile_mask[warp][i] = m;
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();      // q (and this warp's first tile)
  __syncthreads();
  QFrags<T, HD> qf;
  qf.load(q_s, ldk, lane);

  float acc[VT / 8][4];
#pragma unroll
  for (int j = 0; j < VT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;   // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;               // this lane's columns only

  for (int i = 0; i < mine; ++i) {
    const int st = i % kStages;
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const T* ks = ring + st * L::stage(D);
    const unsigned mask = tile_mask[warp][st];
    float s[2][4];
    tile_scores<T, HD>(s, qf, q_s, ks, D, lane);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = (mask >> (n * 8 + 2 * tg + j)) & 1u;
        s[n][j] = ok ? s[n][j] * scale_log2 : -INFINITY;
        s[n][2 + j] = ok ? s[n][2 + j] * scale_log2 : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[n][j]);
        mx_hi = fmaxf(mx_hi, s[n][2 + j]);
      }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    // -inf while no row has data; then every p and the correction are 0
    const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float c_lo = exp2f(m_lo - mu_lo), c_hi = exp2f(m_hi - mu_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[n][j] = exp2f(s[n][j] - mu_lo);
        s[n][2 + j] = exp2f(s[n][2 + j] - mu_hi);
        sum_lo += s[n][j];
        sum_hi += s[n][2 + j];
      }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < VT / 8; ++j) {
      acc[j][0] *= c_lo;
      acc[j][1] *= c_lo;
      acc[j][2] *= c_hi;
      acc[j][3] *= c_hi;
    }
    tile_pv<T, HD>(acc, s, ks + kTile * ldk, lane);
    __syncwarp();                     // every lane is done with the stage
    if (i + kStages < mine) {
      T* ks2 = ring + st * L::stage(D);
      const unsigned m = load_tile<T, HD>(
          ks2, ks2 + kTile * ldk, k, v, rows, b, h,
          row0 + (warp + (i + kStages) * W) * kTile, sp, D, Dv, e0, vec_ok,
          lane);
      if (lane == 0) tile_mask[warp][st] = m;
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);

  // The warps' states meet in shared memory (the ring is done) and merge
  // in warp order: first each row's maximum, sum and the warps' weights
  // 2^(m_w - M), one thread a row, then the accumulators, one column a
  // thread.
  __syncthreads();
  float* red = reinterpret_cast<float*>(gqa_smem + (size_t)kGroup * ldk *
                                                       sizeof(T));
  constexpr int ldr = L::kLdr;
  float* red_w = red + W * kGroup * ldr;        // [W][16]: m, then weight
  float* red_l = red_w + W * kGroup;            // [W][16]
  {
    float* own = red + warp * kGroup * ldr;
#pragma unroll
    for (int j = 0; j < VT / 8; ++j) {
      const int e = j * 8 + 2 * tg;
      *reinterpret_cast<float2*>(own + g * ldr + e) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(own + (g + 8) * ldr + e) =
          make_float2(acc[j][2], acc[j][3]);
    }
    if (tg == 0) {
      red_w[warp * kGroup + g] = m_lo;
      red_w[warp * kGroup + g + 8] = m_hi;
      red_l[warp * kGroup + g] = l_lo;
      red_l[warp * kGroup + g + 8] = l_hi;
    }
  }
  __syncthreads();
  const long part = (long)bh * R + r;
  const int gn = min(kGroup, G - g0);
  if (tid < gn) {
    float M = -INFINITY;
    for (int w = 0; w < W; ++w) M = fmaxf(M, red_w[w * kGroup + tid]);
    float Ls = 0.f;
    for (int w = 0; w < W; ++w) {
      const float mw = red_w[w * kGroup + tid];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - M);
      Ls += red_l[w * kGroup + tid] * f;
      red_w[w * kGroup + tid] = f;
    }
    if (zc == 0) {
      part_m[part * G + g0 + tid] = M;   // -inf: no row with data here
      part_l[part * G + g0 + tid] = Ls;
    }
  }
  __syncthreads();
  const int en = min(VT, Dv - e0);
  for (int i = tid; i < gn * VT; i += blockDim.x) {
    const int gi = i / VT, e = i - gi * VT;       // VT: a shift
    if (e >= en) continue;
    float A = 0.f;
    for (int w = 0; w < W; ++w)
      A += red[(w * kGroup + gi) * ldr + e] * red_w[w * kGroup + gi];
    part_acc[(part * G + g0 + gi) * Dv + e0 + e] = A;
  }
}

// out[bh, g, e] = sum_j acc_j 2^(m_j - M) / sum_j l_j 2^(m_j - M) over
// the ranges j that hold rows of slot b (from cur_pos, in range order), M
// the largest m_j, taken as a running maximum; 0 where no range saw a row
// with data.
template <typename Rows, typename T>
__global__ void gqa_decode_merge_kernel(const float* __restrict__ part_m,
                                        const float* __restrict__ part_l,
                                        const float* __restrict__ part_acc,
                                        const int* __restrict__ cur_pos,
                                        T* __restrict__ out, Rows rows,
                                        int n, int Hkv, int G, int Dv, int R,
                                        int window) {
  constexpr int kBatch = 8;          // ranges whose loads are in flight
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int bhg = i / Dv;                      // (b * Hkv + h) * G + g
  const int e = i - bhg * Dv;
  const int bh = bhg / G, g = bhg - bh * G;
  const int nr = span_of(cur_pos[bh / Hkv], rows.length(), window).ranges();
  // one pass in range order, each range's (m, l, acc) rescaled into the
  // running state; the loads of kBatch ranges all start before any is used
  float M = -INFINITY, Ls = 0.f, A = 0.f;
  for (int j0 = 0; j0 < nr; j0 += kBatch) {
    float mj[kBatch], lj[kBatch], aj[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long pj = ((long)bh * R + min(j0 + u, nr - 1)) * G + g;
      const bool in = j0 + u < nr;
      mj[u] = in ? part_m[pj] : -INFINITY;
      lj[u] = in ? part_l[pj] : 0.f;
      aj[u] = in ? part_acc[pj * Dv + e] : 0.f;
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
  out[i] = from_f<T>(A / fmaxf(Ls, 1e-30f));
}

template <typename T>
size_t smem_of(int D, int Dv, int warps) {
  return hd_of(D, Dv) ? Layout<T, 128>::bytes(D, warps)
                       : Layout<T, 0>::bytes(D, warps);
}

// The two launches of one call; returns their count. Four warps, fewer
// where their stages would not fit a block's shared memory (wide D).
int config(int B, int Hkv, int G, int D, int Dv, int ranges, int paged,
           int dtype, LaunchRec* r, bool names) {
  const int hd = hd_of(D, Dv), vt = Layout<float, 0>::VT;
  int warps = kWarps;
  size_t smem = 0;
  for (; warps >= 1; warps /= 2) {
    smem = dtype == DT_BF16 ? smem_of<__nv_bfloat16>(D, Dv, warps)
                            : smem_of<float>(D, Dv, warps);
    if (smem + sizeof(unsigned) * kWarps * kStages <= 232448 || warps == 1)
      break;
  }
  const int z = (G + kGroup - 1) / kGroup * ((Dv + vt - 1) / vt);
  const char* rn = paged ? "PagedRows" : "SlotRows";
  set_launch(&r[0], names, dim3(B * Hkv, ranges, z), warps * 32, smem,
             "gqa_decode_partial_kernel<%s,%s,%d>", rn, dt_name(dtype), hd);
  const long n = (long)B * Hkv * G * Dv;
  set_launch(&r[1], names, dim3((unsigned)((n + 255) / 256)), 256, 0,
             "gqa_decode_merge_kernel<%s,%s>", rn, dt_name(dtype));
  return 2;
}

template <typename Rows> constexpr int is_paged();
template <> constexpr int is_paged<SlotRows>() { return 0; }
template <> constexpr int is_paged<PagedRows>() { return 1; }

template <typename T, int HD, typename Rows>
cudaError_t launch_hd(const LaunchRec* r, const T* q, const T* k,
                      const T* v, const int* cur_pos, float* part_m,
                      float* part_l, float* part_acc, T* out, Rows rows,
                      int B, int Hkv, int G, int D, int Dv, float scale,
                      int window, int vec, cudaStream_t st) {
  auto kern = gqa_decode_partial_kernel<Rows, T, HD>;
  static size_t allowed[kSmemDevices] = {};   // the opt-in, once
  cudaError_t e = allow_smem_once(kern, r[0].smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(r[0]), r[0].threads, r[0].smem, st>>>(
      q, k, v, cur_pos, part_m, part_l, part_acc, rows, Hkv, G, D, Dv,
      scale * 1.4426950408889634f, window, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = B * Hkv * G * Dv;
  gqa_decode_merge_kernel<Rows, T><<<grid_of(r[1]), r[1].threads, 0, st>>>(
      part_m, part_l, part_acc, cur_pos, out, rows, n, Hkv, G, Dv,
      r[0].grid[1], window);
  return cudaGetLastError();
}

template <typename T, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cur_pos, float* part_m, float* part_l,
                   float* part_acc, void* out, Rows rows, int B, int Hkv,
                   int G, int D, int Dv, float scale, int window, int ranges,
                   cudaStream_t st) {
  if (ranges != (rows.length() + kRows - 1) / kRows)
    return cudaErrorInvalidValue;     // the wrapper's kRows is not ours
  LaunchRec r[kMaxLaunches];
  config(B, Hkv, G, D, Dv, ranges, is_paged<Rows>(), dtype_of<T>(), r,
         false);
  constexpr int V = 16 / (int)sizeof(T);
  const int vec = D % V == 0 && Dv % V == 0 &&
                  reinterpret_cast<size_t>(q) % 16 == 0 &&
                  reinterpret_cast<size_t>(k) % 16 == 0 &&
                  reinterpret_cast<size_t>(v) % 16 == 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  if (hd_of(D, Dv))
    return launch_hd<T, 128>(r, qt, kt, vt, cur_pos, part_m, part_l,
                             part_acc, o, rows, B, Hkv, G, D, Dv, scale,
                             window, vec, st);
  return launch_hd<T, 0>(r, qt, kt, vt, cur_pos, part_m, part_l, part_acc,
                         o, rows, B, Hkv, G, D, Dv, scale, window, vec, st);
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v, const int* cur_pos,
             float* part_m, float* part_l, float* part_acc, void* out,
             Rows rows, int B, int Hkv, int G, int D, int Dv, float scale,
             int window, int ranges, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)launch<float>(q, k, v, cur_pos, part_m, part_l, part_acc,
                              out, rows, B, Hkv, G, D, Dv, scale, window,
                              ranges, st);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(q, k, v, cur_pos, part_m, part_l,
                                      part_acc, out, rows, B, Hkv, G, D, Dv,
                                      scale, window, ranges, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hkv, G, D], k [B, Hkv, S, D], v [B, Hkv, S, Dv], cur_pos int32 [B],
// out [B, Hkv, G, Dv]; contiguous, q/k/v/out of one dtype. `ranges` is
// ceil(S / kRows); part_m / part_l f32 scratch of B*Hkv*ranges*G, part_acc
// of B*Hkv*ranges*G*Dv.
extern "C" int repro_gqa_decode_attn(
    const void* q, const void* k, const void* v, const int* cur_pos,
    float* part_m, float* part_l, float* part_acc, void* out, int B, int Hkv,
    int G, int S, int D, int Dv, float scale, int window, int ranges,
    int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || S < 1 || D < 1 || Dv < 1 || ranges < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, cur_pos, part_m, part_l, part_acc, out,
                  SlotRows{S, Hkv}, B, Hkv, G, D, Dv, scale, window, ranges,
                  dtype, stream);
}

// As repro_gqa_decode_attn over the pools k_pool [num_pages, Hkv, ps, D] /
// v_pool [num_pages, Hkv, ps, Dv] through pages int32 [B, pps] (-1 =
// unallocated); `ranges` is ceil(pps * ps / kRows).
extern "C" int repro_gqa_paged_decode_attn(
    const void* q, const void* k_pool, const void* v_pool, const int* pages,
    const int* cur_pos, float* part_m, float* part_l, float* part_acc,
    void* out, int B, int Hkv, int G, int num_pages, int ps, int pps, int D,
    int Dv, float scale, int window, int ranges, int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || num_pages < 1 || ps < 1 || pps < 1 ||
      D < 1 || Dv < 1 || ranges < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch(q, k_pool, v_pool, cur_pos, part_m, part_l, part_acc, out,
                  PagedRows{pages, ps, pps, num_pages, Hkv}, B, Hkv, G, D, Dv,
                  scale, window, ranges, dtype, stream);
}

extern "C" int repro_gqa_decode_attn_launch_config(int B, int Hkv, int G,
                                                   int D, int Dv, int ranges,
                                                   int dtype, LaunchRec* r) {
  return config(B, Hkv, G, D, Dv, ranges, 0, dtype, r, true);
}

extern "C" int repro_gqa_paged_decode_attn_launch_config(
    int B, int Hkv, int G, int D, int Dv, int ranges, int dtype,
    LaunchRec* r) {
  return config(B, Hkv, G, D, Dv, ranges, 1, dtype, r, true);
}
