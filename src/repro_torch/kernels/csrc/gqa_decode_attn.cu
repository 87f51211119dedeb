// Fused one-token GQA decode attention for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:
// gqa_decode_attn_2d (body _gqa_kernel): q [B, Hkv, G, D] against the
// slot cache k [B, Hkv, S, D] / v [B, Hkv, S, Dv] with a ragged cur_pos
// [B]; slot b attends the positions p with p <= cur_pos[b] (and
// p > cur_pos[b] - window when window > 0). A cur_pos past the cache
// (the engine's invalid lanes use 2**30) attends every row, as the TPU
// kernel's tile test does; a slot with no position in range writes 0.
//
// What bounds it on the H100: every cache row in range is read once and
// feeds only 2*G*(D+Dv) flops, so the kernel is bound by the bytes of the
// K/V rows of each slot up to its cur_pos — not by the whole max_len
// cache. Design: the G query heads of a KV head share every K/V tile
// read. The tiles that intersect (cur_pos - window, cur_pos] — and only
// those, which makes tile skipping exact: each tile run holds at least
// one attended position, so a running maximum is always finite — are
// split into `splits` contiguous ranges, one block per (slot, KV head,
// range), so that the 8 x 4 (slot, KV head) pairs of the main path fill
// the card. Each block stages its tiles of TS rows in shared memory as
// f32 (K rows padded by one word against bank conflicts), runs the online
// (m, l, acc) softmax in f32 and writes its partial state; a second pass
// merges the ranges of each (slot, KV head) in a fixed order
// (deterministic, no atomics). The TPU kernel instead walks all tiles of
// a slot in one sequential grid row.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTS = 32;  // cache rows per tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ cur_pos,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc, int Hkv, int G,
                          int S, int D, int Dv, float scale, int window) {
  extern __shared__ float sm[];
  const int Dp = D + 1;
  float* q_s = sm;                   // [G][D]
  float* k_s = q_s + G * D;          // [TS][D + 1]
  float* v_s = k_s + kTS * Dp;       // [TS][Dv]
  float* p_s = v_s + kTS * Dv;       // [G][TS]
  float* acc_s = p_s + G * kTS;      // [G][Dv]
  float* m_s = acc_s + G * Dv;       // [G]
  float* l_s = m_s + G;              // [G]
  float* c_s = l_s + G;              // [G]

  const int bh = blockIdx.x;         // b * Hkv + h
  const int split = blockIdx.y, splits = gridDim.y;
  const int b = bh / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;

  const T* qb = q + (long)bh * G * D;
  const T* kb = k + (long)bh * S * D;
  const T* vb = v + (long)bh * S * Dv;

  const int cur = cur_pos[b];
  const int hi = min(cur, S - 1);                        // last attended row
  const int lo = window > 0 ? max(0, cur - window + 1) : 0;
  // this block's share of the tiles that intersect [lo, hi]
  const int t_first = (lo / kTS) * kTS;
  const int n_tiles = hi >= lo ? (hi - t_first) / kTS + 1 : 0;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = t_first + split * per * kTS;
  const int t_end = t_first + min(n_tiles, (split + 1) * per) * kTS;

  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f(qb[i]);
  for (int i = tid; i < G * Dv; i += kThreads) acc_s[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) { m_s[g] = -INFINITY; l_s[g] = 0.f; }

  for (int t0 = t_begin; t0 < t_end; t0 += kTS) {
    __syncthreads();  // previous tile's k_s / v_s / p_s reads are done
    for (int i = tid; i < kTS * D; i += kThreads) {
      const int s = i / D, d = i - s * D;
      const int pos = t0 + s;
      k_s[s * Dp + d] = pos < S ? to_f(kb[(long)pos * D + d]) : 0.f;
    }
    for (int i = tid; i < kTS * Dv; i += kThreads) {
      const int s = i / Dv, d = i - s * Dv;
      const int pos = t0 + s;
      v_s[i] = pos < S ? to_f(vb[(long)pos * Dv + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < G * kTS; i += kThreads) {
      const int g = i / kTS, s = i - g * kTS;
      const int pos = t0 + s;
      float sc = -INFINITY;
      if (pos >= lo && pos <= hi) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + s * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        sc = dot * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float* row = p_s + g * kTS;
      float mx = -INFINITY;
      for (int s = lane; s < kTS; s += 32) mx = fmaxf(mx, row[s]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile holds a row
      float sum = 0.f;
      for (int s = lane; s < kTS; s += 32) {
        const float sc = row[s];
        const float p = sc == -INFINITY ? 0.f : expf(sc - m_new);
        row[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * Dv; i += kThreads) {
      const int g = i / Dv, e = i - g * Dv;
      const float* pr = p_s + g * kTS;
      float a = acc_s[i] * c_s[g];
      for (int s = 0; s < kTS; ++s) a += pr[s] * v_s[s * Dv + e];
      acc_s[i] = a;
    }
  }
  __syncthreads();
  const long part = (long)bh * splits + split;
  for (int g = tid; g < G; g += kThreads) {
    part_m[part * G + g] = m_s[g];   // -inf for an empty range
    part_l[part * G + g] = l_s[g];
  }
  for (int i = tid; i < G * Dv; i += kThreads)
    part_acc[part * G * Dv + i] = acc_s[i];
}

// out[bh, g, e] = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M), M the
// largest m_j over the ranges of (bh, g); 0 when no range attended a row.
template <typename T>
__global__ void gqa_decode_merge_kernel(const float* __restrict__ part_m,
                                        const float* __restrict__ part_l,
                                        const float* __restrict__ part_acc,
                                        T* __restrict__ out, long n, int G,
                                        int Dv, int splits) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long bhg = i / Dv;                     // (b * Hkv + h) * G + g
  const int e = (int)(i - bhg * Dv);
  const long bh = bhg / G;
  const int g = (int)(bhg - bh * G);
  float M = -INFINITY;
  for (int j = 0; j < splits; ++j)
    M = fmaxf(M, part_m[(bh * splits + j) * G + g]);
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int j = 0; j < splits; ++j) {
      const long pj = bh * splits + j;
      const float mj = part_m[pj * G + g];
      if (mj == -INFINITY) continue;
      const float w = expf(mj - M);
      L += part_l[pj * G + g] * w;
      A += part_acc[(pj * G + g) * Dv + e] * w;
    }
  }
  out[i] = from_f<T>(A / fmaxf(L, 1e-30f));
}

// The two launches of one call; returns their count.
int config(int B, int Hkv, int G, int D, int Dv, int splits, int dtype,
           LaunchRec* r, bool names) {
  const size_t floats = (size_t)G * D + (size_t)kTS * (D + 1) +
                        (size_t)kTS * Dv + (size_t)G * kTS +
                        (size_t)G * Dv + 3 * (size_t)G;
  set_launch(&r[0], names,
             dim3(B * Hkv, splits), kThreads, floats * sizeof(float),
             "gqa_decode_partial_kernel<%s>", dt_name(dtype));
  const long n = (long)B * Hkv * G * Dv;
  set_launch(&r[1], names, dim3((unsigned)((n + 255) / 256)), 256, 0,
             "gqa_decode_merge_kernel<%s>", dt_name(dtype));
  return 2;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cur_pos, float* part_m, float* part_l,
                   float* part_acc, void* out, int B, int Hkv, int G, int S,
                   int D, int Dv, float scale, int window, int splits,
                   cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  config(B, Hkv, G, D, Dv, splits, dtype_of<T>(), r, false);
  cudaError_t e = allow_smem(gqa_decode_partial_kernel<T>, r[0].smem);
  if (e != cudaSuccess) return e;
  gqa_decode_partial_kernel<T><<<grid_of(r[0]), r[0].threads, r[0].smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cur_pos, part_m, part_l, part_acc, Hkv, G, S,
      D, Dv, scale, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long n = (long)B * Hkv * G * Dv;
  gqa_decode_merge_kernel<T><<<grid_of(r[1]), r[1].threads, 0, st>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n, G, Dv, splits);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hkv, G, D], k [B, Hkv, S, D], v [B, Hkv, S, Dv], cur_pos int32 [B],
// out [B, Hkv, G, Dv]; contiguous, q/k/v/out of one dtype. part_m /
// part_l f32 scratch of B*Hkv*splits*G, part_acc of B*Hkv*splits*G*Dv.
extern "C" int repro_gqa_decode_attn(
    const void* q, const void* k, const void* v, const int* cur_pos,
    float* part_m, float* part_l, float* part_acc, void* out, int B, int Hkv,
    int G, int S, int D, int Dv, float scale, int window, int splits,
    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || G < 1 || S < 1 || D < 1 || Dv < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return (int)launch<float>(q, k, v, cur_pos, part_m, part_l, part_acc, out,
                              B, Hkv, G, S, D, Dv, scale, window, splits, st);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(q, k, v, cur_pos, part_m, part_l,
                                      part_acc, out, B, Hkv, G, S, D, Dv,
                                      scale, window, splits, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_gqa_decode_attn_launch_config(int B, int Hkv, int G,
                                                   int D, int Dv, int splits,
                                                   int dtype, LaunchRec* r) {
  return config(B, Hkv, G, D, Dv, splits, dtype, r, true);
}
