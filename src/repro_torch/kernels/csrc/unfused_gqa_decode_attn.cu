// Unfused one-token GQA decode attention for Hopper: the baseline that
// shows what fusing the decode attention saves.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:317
// unfused_gqa_decode_attn_2d (bodies _scores_kernel, _softmax_kernel,
// _wsum_kernel). Same contract as the fused kernel (gqa_decode_attn.cu):
// q [B, Hkv, G, D] against the slot cache k [B, Hkv, S, D] / v [B, Hkv,
// S, Dv] with a ragged cur_pos [B], computed as three launches on one
// stream with the f32 score matrix [B, Hkv, G, S] in device memory:
//
//   1. scores   s[g, p] = q[g] . k[p] * scale for every cache row p, and
//               NEG_INF = -1e30 where p > cur_pos (or p <= cur_pos -
//               window with a window);
//   2. softmax  over each row of S in place, in f32;
//   3. wsum     out[g] = sum_p prob[g, p] v[p], f32 accumulation.
//
// NEG_INF is finite, as in the TPU kernel: a slot with no attended row
// (cur_pos < 0) gets the uniform average of its S value rows, not zeros.
// A cur_pos past the cache (the engine's invalid lanes, 2**30) attends
// every row.
//
// What bounds it on the H100: every K and V row of the cache is read,
// whatever cur_pos is (2 * B * Hkv * S * D elements), and the score
// matrix is written, read, written and read again (4 * B * Hkv * G * S f32
// values), so it is bound by bytes — and by more of them than the fused
// kernel, which reads only the rows up to each cur_pos and keeps the
// scores in shared memory. That is the point of the baseline; this design
// keeps that contract and makes each launch fast. No padding: ragged S
// and head dims are masked.
//
//   1. scores: block (b * Hkv + h, 64-row tile, group of 16 query heads),
//      4 warps of 16 rows each (fewer where a wide head dim's rows would
//      not fit the block's shared memory). q's 16 rows (zeros past G) and each warp's
//      16 K rows come in the input type by 16-byte cp.async (one batch,
//      every copy in flight at once), and the 16 x 16 scores of a warp are
//      one tensor-core tile (mma.sync, q as the mma's m: bf16 m16n8k16,
//      f32 m16n8k8 in the 3xTF32 form, f32's accuracy). A head dim up to
//      128 is a compile-time tile (unrolled k-steps); wider runs the same
//      body with a run-time tile;
//   2. softmax: one block a row, in one pass where the row fits in
//      registers (S <= 1024: 4 values a thread): maximum and sum by
//      shuffles and one barrier each, one exponential an element; longer
//      rows take an online (m, l) pass and a normalising pass;
//   3. wsum: block (b * Hkv + h, 32 value columns), 16 warps; the
//      block's probabilities (16 query heads at a time, zeros past G) and
//      its V columns (up to 1024 rows at a time) come by 16-byte cp.async,
//      all in flight at once, and the sum runs on the tensor cores
//      (mma.sync, heads as the mma's m) with the f32 probabilities split
//      in two so they keep nearly f32's accuracy: bf16 m16n8k16, P as two
//      bf16 halves against V by ldmatrix.trans; f32 m16n8k8 in the 3xTF32
//      form, the contraction order permuted (mma k = tg <-> row 2 tg, k =
//      tg + 4 <-> row 2 tg + 1: P as one float2, V rows on distinct
//      banks). Warp w takes the k-steps w, w + 16, ...; the warps' 16 x 32
//      sums meet in shared memory and are added in warp order:
//      deterministic, no float atomics.
#include "common.cuh"

namespace {

constexpr int kScoreWarps = 4;                  // fewer where D is wide
constexpr int kTile = 16;                       // K rows a warp (mma n)
constexpr int kGroup = 16;                      // query heads (mma m)
constexpr int kSoftmaxThreads = 256;            // one block a row
constexpr int kRowRegs = 4;                     // values a thread holds
constexpr int kWsumWarps = 16;
constexpr int kCols = 32;                       // value columns a block
constexpr int kGBatch = 16;                     // query heads (mma m)
constexpr int kSChunk = 1024;                   // rows staged at once
constexpr float kNegInf = -1e30f;

// The head-dim tile of the scores: 128 where D fits (every path the port
// serves; a narrower head is zero-padded), else 0: D padded to 16 at run
// time.
__host__ __device__ constexpr int hd_of(int D) { return D <= 128 ? 128 : 0; }

// Shared memory of a scores block of `warps` warps: q [16][ldk], then K
// [16][ldk] per warp;
// the 16-byte pad puts a row's start on an odd multiple of 16 bytes modulo
// 128 (ldmatrix's 8 rows on 8 distinct bank groups).
template <typename T, int HD>
struct ScoreLayout {
  __host__ __device__ static constexpr int dk(int D) {
    return HD ? HD : (D + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int ldk(int D) {
    return dk(D) + 16 / (int)sizeof(T);
  }
  static size_t bytes(int D, int warps) {
    return (size_t)(kGroup + warps * kTile) * ldk(D) * sizeof(T);
  }
};

// Copy `n` rows [dk] from src rows first.. (row i at src + i * D; rows
// past `rows` and columns past D are zeros) into dst [n][ldk], threads
// tid, tid + step, ...
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src,
                                          int n, int rows, int D, bool vec,
                                          int tid, int step) {
  using L = ScoreLayout<T, HD>;
  const int dk = L::dk(D), ldk = L::ldk(D);
  if (vec) {
    constexpr int V = 16 / (int)sizeof(T);
    const int kc = dk / V;                   // copies per row
    for (int c = tid; c < n * kc; c += step) {
      const int s = c / kc, d = (c - s * kc) * V;
      const bool ok = s < rows && d < D;
      cp_async16(dst + s * ldk + d, ok ? src + (long)s * D + d : src, ok);
    }
  } else {
    const T zero = from_f<T>(0.f);
    for (int c = tid; c < n * dk; c += step) {
      const int s = c / dk, d = c - s * dk;
      dst[s * ldk + d] = s < rows && d < D ? src[(long)s * D + d] : zero;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kScoreWarps * 32)
unfused_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const int* __restrict__ cur_pos,
                      float* __restrict__ scores, int Hkv, int G, int S,
                      int D, float scale, int window, int vec) {
  using L = ScoreLayout<T, HD>;
  extern __shared__ __align__(16) unsigned char sc_smem[];
  const int bh = blockIdx.x, b = bh / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int W = blockDim.x >> 5;
  const int p0 = (blockIdx.y * W + warp) * kTile;  // this warp's rows
  const int g0 = blockIdx.z * kGroup;
  const int ldk = L::ldk(D);
  T* q_s = reinterpret_cast<T*>(sc_smem);
  T* k_s = q_s + (kGroup + warp * kTile) * ldk;
  const bool vec_ok = vec != 0;

  copy_rows<T, HD>(q_s, q + ((long)bh * G + g0) * D, kGroup, G - g0, D,
                   vec_ok, tid, blockDim.x);
  if (p0 < S)
    copy_rows<T, HD>(k_s, k + ((long)bh * S + p0) * D, kTile, S - p0, D,
                     vec_ok, lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (p0 >= S) return;

  float s[2][4];
  mma_tile16_scores<T, HD>(s, q_s, ldk, k_s, ldk, L::dk(D), lane);
  const int cur = cur_pos[b];
  float* sb = scores + ((long)bh * G) * S;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gq = g0 + g + half * 8;
    if (gq >= G) continue;
    float* row = sb + (long)gq * S;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int pos = p0 + n * 8 + 2 * tg;     // even
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = pos + j;
        const bool ok = p <= cur && (window <= 0 || p > cur - window);
        v[j] = ok ? s[n][2 * half + j] * scale : kNegInf;
      }
      if (S % 2 == 0 && pos < S) {
        *reinterpret_cast<float2*>(row + pos) = make_float2(v[0], v[1]);
      } else {
        if (pos < S) row[pos] = v[0];
        if (pos + 1 < S) row[pos + 1] = v[1];
      }
    }
  }
}

// max (kMax) or sum of v over the block; every thread gets the result.
// red holds one value a warp; each reduction has its own red, so one
// barrier a reduction suffices.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kSoftmaxThreads / 32; ++w)
    r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// One block a row of S scores, in place. The scores are finite (NEG_INF
// is), so a row's maximum is finite. Exponentials in base 2 of (x - max)
// * log2 e.
__global__ void __launch_bounds__(kSoftmaxThreads)
unfused_softmax_kernel(float* __restrict__ p, int S) {
  __shared__ float red[4][kSoftmaxThreads / 32];
  constexpr float kLog2e = 1.4426950408889634f;
  float* x = p + (long)blockIdx.x * S;
  const int tid = threadIdx.x;
  if (S <= kSoftmaxThreads * kRowRegs) {      // the row in registers
    float v[kRowRegs];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kRowRegs; ++i) {
      const int s = i * kSoftmaxThreads + tid;
      v[i] = s < S ? x[s] : -INFINITY;
      mx = fmaxf(mx, v[i]);
    }
    mx = block_reduce<true>(mx, red[0]);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kRowRegs; ++i) {
      v[i] = exp2f((v[i] - mx) * kLog2e);    // 0 past S
      sum += v[i];
    }
    const float inv = 1.f / block_reduce<false>(sum, red[1]);
#pragma unroll
    for (int i = 0; i < kRowRegs; ++i) {
      const int s = i * kSoftmaxThreads + tid;
      if (s < S) x[s] = v[i] * inv;
    }
    return;
  }
  float m = -INFINITY, l = 0.f;                // online, this thread's share
  for (int s = tid; s < S; s += kSoftmaxThreads) {
    const float xv = x[s];
    if (xv > m) {
      l = l * exp2f((m - xv) * kLog2e) + 1.f;
      m = xv;
    } else {
      l += exp2f((xv - m) * kLog2e);
    }
  }
  const float M = block_reduce<true>(m, red[2]);
  const float inv = 1.f / block_reduce<false>(
      m == -INFINITY ? 0.f : l * exp2f((m - M) * kLog2e), red[3]);
  for (int s = tid; s < S; s += kSoftmaxThreads)
    x[s] = exp2f((x[s] - M) * kLog2e) * inv;
}

// Shared memory of a wsum block: V [kSChunk][kLdv] in T (kCols columns
// and 16 bytes of pad: f32 rows 2 tg, column g on 32 distinct banks;
// ldmatrix's 8 bf16 rows on 8 distinct bank groups), then P
// [kGBatch][kLdp] f32 (a float2 read a lane on 32 banks). The warps' sums
// [warp][16][kLdr] reuse V.
template <typename T>
struct WsumLayout {
  static constexpr int kLdv = kCols + 16 / (int)sizeof(T);
  static constexpr int kLdp = kSChunk + 8;
  static constexpr int kLdr = kCols + 8;
  static constexpr size_t kV = (size_t)kSChunk * kLdv * sizeof(T);
  static constexpr size_t kBytes =
      kV + (size_t)kGBatch * kLdp * sizeof(float);
  static_assert((size_t)kWsumWarps * kGBatch * kLdr * sizeof(float) <= kV,
                "the warps' sums fit where V was");
};

// Two f32 values as two bf16 pairs: hi = their bf16 rounding, lo = the
// rounding of what hi misses (hi + lo is within about 2^-17 of x).
__device__ __forceinline__ void split_bf16x2(float2 x, unsigned& hi,
                                             unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = bf16x2_of(x.x - hf.x, x.y - hf.y);
}

template <typename T>
__global__ void __launch_bounds__(kWsumWarps * 32)
unfused_wsum_kernel(const float* __restrict__ p, const T* __restrict__ v,
                    T* __restrict__ out, int G, int S, int Dv, int vec_p,
                    int vec_v) {
  using L = WsumLayout<T>;
  constexpr int V = 16 / (int)sizeof(T);   // values a 16-byte copy
  constexpr int kThreads = kWsumWarps * 32;
  constexpr int kStep = sizeof(T) == 4 ? 8 : 16;   // rows an mma k-step
  extern __shared__ __align__(16) unsigned char ws_smem[];
  T* v_s = reinterpret_cast<T*>(ws_smem);
  float* p_s = reinterpret_cast<float*>(ws_smem + L::kV);
  float* red = reinterpret_cast<float*>(ws_smem);
  const int bh = blockIdx.x, e0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const float* pb = p + (long)bh * G * S;
  const T* vb = v + (long)bh * S * Dv + e0;

  for (int gb = 0; gb < G; gb += kGBatch) {
    const int gn = min(kGBatch, G - gb);
    const int p_rows = gn > 8 ? kGBatch : 8;   // rows g + 8 only past 8
    float acc[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kSChunk) {
      const int sn = min(kSChunk, S - s0);
      const int rows = (sn + kStep - 1) / kStep * kStep;  // zeros past sn
      __syncthreads();                         // the last reads are done
      // P rows gb.. (zeros past gn) and V rows s0.., every copy in flight
      if (vec_p) {
        const int cp = rows / 4;
        for (int i = tid; i < p_rows * cp; i += kThreads) {
          const int gi = i / cp, c = (i - gi * cp) * 4;
          const bool ok = gi < gn && c < sn;
          cp_async16(p_s + gi * L::kLdp + c,
                     ok ? pb + (long)(gb + gi) * S + s0 + c : pb, ok);
        }
      } else {
        for (int i = tid; i < p_rows * rows; i += kThreads) {
          const int gi = i / rows, c = i - gi * rows;
          p_s[gi * L::kLdp + c] =
              gi < gn && c < sn ? pb[(long)(gb + gi) * S + s0 + c] : 0.f;
        }
      }
      if (vec_v) {
        constexpr int cv = kCols / V;          // copies a row
        for (int i = tid; i < rows * cv; i += kThreads) {
          const int r = i / cv, d = (i - r * cv) * V;
          const bool ok = r < sn && e0 + d < Dv;
          cp_async16(v_s + r * L::kLdv + d,
                     ok ? vb + (long)(s0 + r) * Dv + d : vb, ok);
        }
      } else {
        const T zero = from_f<T>(0.f);
        for (int i = tid; i < rows * kCols; i += kThreads) {
          const int r = i / kCols, c = i - r * kCols;
          v_s[r * L::kLdv + c] =
              r < sn && e0 + c < Dv ? vb[(long)(s0 + r) * Dv + c] : zero;
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      // k-steps of kStep rows, warp w taking w, w + 16, ...
      for (int k0 = warp * kStep; k0 < rows; k0 += kWsumWarps * kStep) {
        const float* p0 = p_s + g * L::kLdp + k0 + 2 * tg;
        const float2 zero2 = make_float2(0.f, 0.f);
        if constexpr (sizeof(T) == 4) {
          // m16n8k8 3xTF32; mma k = tg <-> row k0 + 2 tg, k = tg + 4 <->
          // row k0 + 2 tg + 1 (P as one float2, V rows on 32 banks)
          const float2 x0 = *reinterpret_cast<const float2*>(p0);
          const float2 x1 = gn > 8 ? *reinterpret_cast<const float2*>(
              p0 + 8 * L::kLdp) : zero2;
          unsigned ahi[4], alo[4];
          split_tf32(x0.x, ahi[0], alo[0]);
          split_tf32(x1.x, ahi[1], alo[1]);
          split_tf32(x0.y, ahi[2], alo[2]);
          split_tf32(x1.y, ahi[3], alo[3]);
          const float* vr = reinterpret_cast<const float*>(v_s) +
                            (k0 + 2 * tg) * L::kLdv + g;
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j) {
            unsigned bhi[2], blo[2];
            split_tf32(vr[j * 8], bhi[0], blo[0]);
            split_tf32(vr[L::kLdv + j * 8], bhi[1], blo[1]);
            mma_tf32(acc[j], alo, bhi);
            mma_tf32(acc[j], ahi, blo);
            mma_tf32(acc[j], ahi, bhi);
          }
        } else {
          // m16n8k16 bf16: P as two bf16 halves (hi + lo, about 2^-17 of
          // P off) against V by ldmatrix.trans
          unsigned ahi[4], alo[4];
          split_bf16x2(*reinterpret_cast<const float2*>(p0), ahi[0], alo[0]);
          split_bf16x2(gn > 8 ? *reinterpret_cast<const float2*>(
              p0 + 8 * L::kLdp) : zero2, ahi[1], alo[1]);
          split_bf16x2(*reinterpret_cast<const float2*>(p0 + 8), ahi[2],
                       alo[2]);
          split_bf16x2(gn > 8 ? *reinterpret_cast<const float2*>(
              p0 + 8 * L::kLdp + 8) : zero2, ahi[3], alo[3]);
          const int lr = lane & 7, lm = lane >> 3;
          const T* vr = v_s + (k0 + (lm & 1) * 8 + lr) * L::kLdv +
                        (lm >> 1) * 8;
#pragma unroll
          for (int j = 0; j < kCols / 8; j += 2) {
            unsigned w[4];
            ldsm_x4_t(w, vr + j * 8);
            mma_bf16(acc[j], alo, w);
            mma_bf16(acc[j], ahi, w);
            mma_bf16(acc[j + 1], alo, w + 2);
            mma_bf16(acc[j + 1], ahi, w + 2);
          }
        }
      }
    }
    // the warps' sums (heads g, g + 8; columns j * 8 + 2 tg, +1) meet
    // where V was, and are added in warp order
    __syncthreads();
    float* own = red + warp * kGBatch * L::kLdr;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int c = j * 8 + 2 * tg;
      *reinterpret_cast<float2*>(own + g * L::kLdr + c) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(own + (g + 8) * L::kLdr + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
    __syncthreads();
    for (int i = tid; i < gn * kCols; i += kThreads) {
      const int gi = i / kCols, c = i - gi * kCols;
      if (e0 + c >= Dv) continue;
      float a[4] = {0.f, 0.f, 0.f, 0.f};     // four chains, fixed order
#pragma unroll
      for (int w = 0; w < kWsumWarps; ++w)
        a[w % 4] += red[(w * kGBatch + gi) * L::kLdr + c];
      out[((long)bh * G + gb + gi) * Dv + e0 + c] =
          from_f<T>((a[0] + a[1]) + (a[2] + a[3]));
    }
  }
}

// The three launches of one call; returns their count.
int config(int B, int Hkv, int G, int S, int D, int Dv, int dtype,
           LaunchRec* r, bool names) {
  // scores: 4 warps (64 rows) a block, fewer where a wide head dim's
  // rows would not fit a block's shared memory
  const int hd = hd_of(D);
  int warps = kScoreWarps;
  size_t sc = 0;
  for (; warps >= 1; warps /= 2) {
    sc = dtype == DT_BF16
        ? (hd ? ScoreLayout<__nv_bfloat16, 128>::bytes(D, warps)
              : ScoreLayout<__nv_bfloat16, 0>::bytes(D, warps))
        : (hd ? ScoreLayout<float, 128>::bytes(D, warps)
              : ScoreLayout<float, 0>::bytes(D, warps));
    if (sc <= 232448 || warps == 1) break;
  }
  const int rows = warps * kTile;               // cache rows a block
  set_launch(&r[0], names,
             dim3(B * Hkv, (S + rows - 1) / rows, (G + kGroup - 1) / kGroup),
             warps * 32, sc, "unfused_scores_kernel<%s,%d>", dt_name(dtype),
             hd);
  set_launch(&r[1], names, dim3(B * Hkv * G), kSoftmaxThreads, 0,
             "unfused_softmax_kernel");
  set_launch(&r[2], names, dim3(B * Hkv, (Dv + kCols - 1) / kCols),
             kWsumWarps * 32,
             dtype == DT_BF16 ? WsumLayout<__nv_bfloat16>::kBytes
                              : WsumLayout<float>::kBytes,
             "unfused_wsum_kernel<%s>", dt_name(dtype));
  return 3;
}

template <typename T, int HD>
cudaError_t launch_scores(const LaunchRec& r, const T* q, const T* k,
                          const int* cur_pos, float* scores, int Hkv, int G,
                          int S, int D, float scale, int window, int vec,
                          cudaStream_t st) {
  cudaError_t e = allow_smem(unfused_scores_kernel<T, HD>, r.smem);
  if (e != cudaSuccess) return e;
  unfused_scores_kernel<T, HD><<<grid_of(r), r.threads, r.smem, st>>>(
      q, k, cur_pos, scores, Hkv, G, S, D, scale, window, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cur_pos, float* scores, void* out, int B,
                   int Hkv, int G, int S, int D, int Dv, float scale,
                   int window, cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  config(B, Hkv, G, S, D, Dv, dtype_of<T>(), r, false);
  constexpr int V = 16 / (int)sizeof(T);
  const int vec_k = D % V == 0 && reinterpret_cast<size_t>(q) % 16 == 0 &&
                    reinterpret_cast<size_t>(k) % 16 == 0;
  const int vec_v = Dv % V == 0 && reinterpret_cast<size_t>(v) % 16 == 0;
  const int vec_p = S % 4 == 0;              // whole 16-byte runs of P
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  cudaError_t e = hd_of(D)
      ? launch_scores<T, 128>(r[0], qt, kt, cur_pos, scores, Hkv, G, S, D,
                              scale, window, vec_k, st)
      : launch_scores<T, 0>(r[0], qt, kt, cur_pos, scores, Hkv, G, S, D,
                            scale, window, vec_k, st);
  if (e != cudaSuccess) return e;
  unfused_softmax_kernel<<<grid_of(r[1]), r[1].threads, 0, st>>>(
      scores, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static size_t allowed[kSmemDevices] = {};   // the opt-in, once
  e = allow_smem_once(unfused_wsum_kernel<T>, r[2].smem, allowed);
  if (e != cudaSuccess) return e;
  unfused_wsum_kernel<T><<<grid_of(r[2]), r[2].threads, r[2].smem, st>>>(
      scores, static_cast<const T*>(v), static_cast<T*>(out), G, S, Dv,
      vec_p, vec_v);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hkv, G, D], k [B, Hkv, S, D], v [B, Hkv, S, Dv], cur_pos int32 [B],
// out [B, Hkv, G, Dv]; contiguous, q/k/v/out of one dtype. scores f32
// scratch of B*Hkv*G*S (the score, then probability, matrix).
extern "C" int repro_unfused_gqa_decode_attn(
    const void* q, const void* k, const void* v, const int* cur_pos,
    float* scores, void* out, int B, int Hkv, int G, int S, int D, int Dv,
    float scale, int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || G < 1 || S < 1 || D < 1 || Dv < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return (int)launch<float>(q, k, v, cur_pos, scores, out, B, Hkv, G, S, D,
                              Dv, scale, window, st);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(q, k, v, cur_pos, scores, out, B, Hkv,
                                      G, S, D, Dv, scale, window, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_unfused_gqa_decode_attn_launch_config(
    int B, int Hkv, int G, int S, int D, int Dv, int dtype, LaunchRec* r) {
  return config(B, Hkv, G, S, D, Dv, dtype, r, true);
}
