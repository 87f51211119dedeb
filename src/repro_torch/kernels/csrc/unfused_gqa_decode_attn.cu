// Unfused one-token GQA decode attention for Hopper: the baseline that
// shows what fusing the decode attention saves.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:
// unfused_gqa_decode_attn_2d (bodies _scores_kernel, _softmax_kernel,
// _wsum_kernel). Same contract as the fused kernel (gqa_decode_attn.cu):
// q [B, Hkv, G, D] against the slot cache k [B, Hkv, S, D] / v [B, Hkv,
// S, Dv] with a ragged cur_pos [B], computed as three launches on one
// stream with the f32 score matrix [B, Hkv, G, S] in device memory:
//
//   1. scores   s[g, p] = q[g] . k[p] * scale for every cache row p, and
//               NEG_INF = -1e30 where p > cur_pos (or p <= cur_pos -
//               window with a window);
//   2. softmax  over each row of S in place, in f32: max, sum of exps,
//               normalise;
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
// scores in shared memory. That is the point of the baseline. Design,
// kept simple: (1) one block per (slot, KV head, tile of 32 rows) stages
// q once and the K tile in shared memory as f32 and writes G x 32 scores;
// (2) one block per score row reduces in f32; (3) one block per (slot,
// KV head, 32 value columns), 16 warps over 16 contiguous ranges of the
// rows (each warp a chain of one V load per row, so more warps keep more
// loads in flight), whose partial sums are added in a fixed order
// (deterministic, no float atomics). No padding: ragged S and head dims
// are masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTS = 32;             // cache rows per scores block
constexpr int kSoftmaxThreads = 256;
constexpr int kWsumWarps = 16;
constexpr int kCols = 32;           // value columns per wsum block
constexpr float kNegInf = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
unfused_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const int* __restrict__ cur_pos,
                      float* __restrict__ scores, int Hkv, int G, int S,
                      int D, float scale, int window) {
  extern __shared__ float sm[];
  const int Dp = D + 1;
  float* q_s = sm;                   // [G][D]
  float* k_s = q_s + G * D;          // [TS][D + 1]
  const int bh = blockIdx.x;         // b * Hkv + h
  const int b = bh / Hkv;
  const int t0 = blockIdx.y * kTS;
  const int tid = threadIdx.x;
  const T* qb = q + (long)bh * G * D;
  const T* kb = k + (long)bh * S * D;

  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f(qb[i]);
  for (int i = tid; i < kTS * D; i += kThreads) {
    const int s = i / D, d = i - s * D;
    const int pos = t0 + s;
    k_s[s * Dp + d] = pos < S ? to_f(kb[(long)pos * D + d]) : 0.f;
  }
  __syncthreads();
  const int cur = cur_pos[b];
  float* sb = scores + (long)bh * G * S;
  for (int i = tid; i < G * kTS; i += kThreads) {
    const int g = i / kTS, s = i - g * kTS;
    const int pos = t0 + s;
    if (pos >= S) continue;
    const float* qr = q_s + g * D;
    const float* kr = k_s + s * Dp;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
    const bool ok = pos <= cur && (window <= 0 || pos > cur - window);
    sb[(long)g * S + pos] = ok ? dot * scale : kNegInf;
  }
}

// Reduce v over the block with op (max or sum); every thread gets the
// result. red holds one value per warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red's previous use is done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = kMax ? -INFINITY : 0.f;
  for (int w = 0; w < kSoftmaxThreads / 32; ++w)
    r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__global__ void __launch_bounds__(kSoftmaxThreads)
unfused_softmax_kernel(float* __restrict__ p, int S) {
  __shared__ float red[kSoftmaxThreads / 32];
  float* row = p + (long)blockIdx.x * S;
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < S; s += kSoftmaxThreads)
    mx = fmaxf(mx, row[s]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int s = threadIdx.x; s < S; s += kSoftmaxThreads)
    sum += expf(row[s] - mx);
  sum = block_reduce<false>(sum, red);
  for (int s = threadIdx.x; s < S; s += kSoftmaxThreads)
    row[s] = expf(row[s] - mx) / sum;
}

template <typename T>
__global__ void __launch_bounds__(kWsumWarps * 32)
unfused_wsum_kernel(const float* __restrict__ p, const T* __restrict__ v,
                    T* __restrict__ out, int G, int S, int Dv) {
  extern __shared__ float acc_s[];   // [warps][G][kCols]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int e = blockIdx.y * kCols + lane;
  const float* pb = p + (long)bh * G * S;
  const T* vb = v + (long)bh * S * Dv;
  float* acc = acc_s + warp * G * kCols;
  for (int g = 0; g < G; ++g) acc[g * kCols + lane] = 0.f;
  const int per = (S + kWsumWarps - 1) / kWsumWarps;
  const int s_lo = warp * per, s_hi = min(S, s_lo + per);
  if (e < Dv) {
#pragma unroll 4
    for (int s = s_lo; s < s_hi; ++s) {
      const float vv = to_f(vb[(long)s * Dv + e]);
      for (int g = 0; g < G; ++g)
        acc[g * kCols + lane] += pb[(long)g * S + s] * vv;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWsumWarps) {
    float a = 0.f;
    for (int w = 0; w < kWsumWarps; ++w) a += acc_s[(w * G + g) * kCols + lane];
    if (e < Dv) out[((long)bh * G + g) * Dv + e] = from_f<T>(a);
  }
}

// The three launches of one call; returns their count.
int config(int B, int Hkv, int G, int S, int D, int Dv, int dtype,
           LaunchRec* r, bool names) {
  set_launch(&r[0], names, dim3(B * Hkv, (S + kTS - 1) / kTS), kThreads,
             ((size_t)G * D + (size_t)kTS * (D + 1)) * sizeof(float),
             "unfused_scores_kernel<%s>", dt_name(dtype));
  set_launch(&r[1], names, dim3(B * Hkv * G), kSoftmaxThreads, 0,
             "unfused_softmax_kernel");
  set_launch(&r[2], names,
             dim3(B * Hkv, (Dv + kCols - 1) / kCols), kWsumWarps * 32,
             (size_t)kWsumWarps * G * kCols * sizeof(float),
             "unfused_wsum_kernel<%s>", dt_name(dtype));
  return 3;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cur_pos, float* scores, void* out, int B,
                   int Hkv, int G, int S, int D, int Dv, float scale,
                   int window, cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  config(B, Hkv, G, S, D, Dv, dtype_of<T>(), r, false);
  cudaError_t e = allow_smem(unfused_scores_kernel<T>, r[0].smem);
  if (e != cudaSuccess) return e;
  unfused_scores_kernel<T><<<grid_of(r[0]), r[0].threads, r[0].smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), cur_pos, scores,
      Hkv, G, S, D, scale, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  unfused_softmax_kernel<<<grid_of(r[1]), r[1].threads, 0, st>>>(scores, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(unfused_wsum_kernel<T>, r[2].smem);
  if (e != cudaSuccess) return e;
  unfused_wsum_kernel<T><<<grid_of(r[2]), r[2].threads, r[2].smem, st>>>(
      scores, static_cast<const T*>(v), static_cast<T*>(out), G, S, Dv);
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
