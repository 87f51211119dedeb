// Pruned FFN for Hopper, first stage: the compact hidden activation
//   h[:, c] = act(x @ Wgate[:, keep_col(c)]) * (x @ Wup[:, keep_col(c)])
// (or act(x @ Wup[:, keep_col(c)]) ungated), keep_col(c) =
// keep[c / block] * block + c % block, cast to Wdown's dtype. The second
// stage, y = h @ Wdown[keep, :], is the block-pruned product
// (block_pruned_matmul.cu) reading h as compact x.
//
// Replaces the TPU kernel src/repro/kernels/pruned_matmul.py:fused_ffn_2d
// (bodies _ffn_kernel / _ffn_kernel_gated). That kernel keeps the hidden
// tile in VMEM and folds it into an f32 [tm, d_out] accumulator carried
// across a sequential grid. On the H100 that accumulator does not fit:
// at Yi-6B's d_out = 4096 it is 1 MiB even at tm = 64, against 227 KB of
// shared memory per block, and blocks cannot carry state across a grid.
// This port takes the two-launch design: the compact hidden
// [M, kb*block] goes to device memory once (M * kb * block elements —
// 8 x 11008 x 2 bytes = 176 KB at the main path, against 180 MB of
// weights), then the pruned down product reads it.
//
// What bounds it on the H100: at decode M = 8, so every weight element
// read feeds 2*M flops; the stage is bound by the bytes of the kept Wup
// and Wgate columns. Design: one thread per compact hidden column and
// all 8 rows of an M tile — neighbouring threads read neighbouring
// weight columns (coalesced within a kept block), x is staged in shared
// memory in 128-column chunks and broadcast. K = d_model is split into
// `splits` ranges across grid.z so that the kb*block / 128 column blocks
// fill the card; each range writes f32 partials of both products and a
// second pass sums them in a fixed order (no float atomics), applies the
// activation in f32 and casts.
#include "common.cuh"

namespace {

constexpr int kTM = 8;
constexpr int kThreads = 128;
constexpr int kChunk = 128;  // x columns staged per shared-memory pass

enum { ACT_SILU = 0, ACT_GELU_TANH = 1 };

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_hidden_partial_kernel(const T* __restrict__ x, const T* __restrict__ w_up,
                          const T* __restrict__ w_gate,
                          const int* __restrict__ keep,
                          float* __restrict__ part_up,
                          float* __restrict__ part_gate,
                          int M, int K, int H, int kb, int block,
                          int k_per_split) {
  __shared__ float xs[kTM * kChunk];
  const int C = kb * block;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * kTM;
  const int s = blockIdx.z;
  const int k_lo = s * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const bool gated = w_gate != nullptr;
  long j = 0;
  if (c < C) j = (long)keep[c / block] * block + (c % block);

  float au[kTM], ag[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) { au[i] = 0.f; ag[i] = 0.f; }

  for (int k0 = k_lo; k0 < k_hi; k0 += kChunk) {
    const int kn = min(kChunk, k_hi - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kTM * kChunk; i += kThreads) {
      const int mi = i / kChunk, r = i - mi * kChunk;
      const int m = m0 + mi;
      xs[i] = (m < M && r < kn) ? to_f(x[(long)m * K + k0 + r]) : 0.f;
    }
    __syncthreads();
    if (c < C) {
      const T* up = w_up + (long)k0 * H + j;
      const T* gp = gated ? w_gate + (long)k0 * H + j : nullptr;
#pragma unroll 4
      for (int r = 0; r < kn; ++r) {
        const float wu = to_f(up[(long)r * H]);
#pragma unroll
        for (int mi = 0; mi < kTM; ++mi) au[mi] += xs[mi * kChunk + r] * wu;
        if (gated) {
          const float wg = to_f(gp[(long)r * H]);
#pragma unroll
          for (int mi = 0; mi < kTM; ++mi) ag[mi] += xs[mi * kChunk + r] * wg;
        }
      }
    }
  }
  if (c < C) {
#pragma unroll
    for (int mi = 0; mi < kTM; ++mi) {
      const int m = m0 + mi;
      if (m >= M) continue;
      const long o = ((long)s * M + m) * C + c;
      part_up[o] = au[mi];
      if (gated) part_gate[o] = ag[mi];
    }
  }
}

__device__ __forceinline__ float act_f(float v, int act) {
  if (act == ACT_GELU_TANH) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
  }
  return v / (1.f + expf(-v));  // silu = v * sigmoid(v)
}

template <typename T>
__global__ void ffn_hidden_act_kernel(const float* __restrict__ part_up,
                                      const float* __restrict__ part_gate,
                                      T* __restrict__ h, long n, int splits,
                                      int act) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float u = 0.f, g = 0.f;
  for (int j = 0; j < splits; ++j) {
    u += part_up[(long)j * n + i];
    if (part_gate != nullptr) g += part_gate[(long)j * n + i];
  }
  const float v = part_gate != nullptr ? act_f(g, act) * u : act_f(u, act);
  h[i] = from_f<T>(v);
}

// whole kChunk ranges per split, so only the last range is ragged
int k_per_split(int K, int splits) {
  const int kps = (K + splits - 1) / splits;
  return (kps + kChunk - 1) / kChunk * kChunk;
}

// The two launches of one call; returns their count.
int config(int M, int K, int kb, int block, int splits, int dtype,
           LaunchRec* r, bool names) {
  const int kps = k_per_split(K, splits);
  const int used = (K + kps - 1) / kps;
  const int C = kb * block;
  set_launch(&r[0], names,
             dim3((C + kThreads - 1) / kThreads, (M + kTM - 1) / kTM,
                         used),
             kThreads, 0, "ffn_hidden_partial_kernel<%s>", dt_name(dtype));
  const long n = (long)M * C;
  set_launch(&r[1], names, dim3((unsigned)((n + 255) / 256)), 256, 0,
             "ffn_hidden_act_kernel<%s>", dt_name(dtype));
  return 2;
}

template <typename T>
cudaError_t launch(const void* x, const void* w_up, const void* w_gate,
                   const int* keep, float* part_up, float* part_gate,
                   void* h, int M, int K, int H, int kb, int block,
                   int splits, int act, cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  config(M, K, kb, block, splits, dtype_of<T>(), r, false);
  const int kps = k_per_split(K, splits);
  const int used = r[0].grid[2];
  ffn_hidden_partial_kernel<T><<<grid_of(r[0]), r[0].threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_up),
      static_cast<const T*>(w_gate), keep, part_up,
      w_gate != nullptr ? part_gate : nullptr, M, K, H, kb, block, kps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long n = (long)M * kb * block;
  ffn_hidden_act_kernel<T><<<grid_of(r[1]), r[1].threads, 0, st>>>(
      part_up, w_gate != nullptr ? part_gate : nullptr, static_cast<T*>(h),
      n, used, act);
  return cudaGetLastError();
}

}  // namespace

// x [M, K], w_up / w_gate [K, H] (w_gate may be null: ungated), keep int32
// [kb], part_up / part_gate f32 scratch of at least splits*M*kb*block
// each, h [M, kb*block]; all of one dtype. act: 0 = silu, 1 = gelu (tanh
// approximation).
extern "C" int repro_pruned_ffn_hidden(
    const void* x, const void* w_up, const void* w_gate, const int* keep,
    float* part_up, float* part_gate, void* h, int M, int K, int H, int kb,
    int block, int splits, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || block < 1 || (act != ACT_SILU && act != ACT_GELU_TANH))
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return (int)launch<float>(x, w_up, w_gate, keep, part_up, part_gate, h,
                              M, K, H, kb, block, splits, act, st);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, w_up, w_gate, keep, part_up,
                                      part_gate, h, M, K, H, kb, block,
                                      splits, act, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_pruned_ffn_hidden_launch_config(int M, int K, int kb,
                                                     int block, int splits,
                                                     int dtype,
                                                     LaunchRec* r) {
  return config(M, K, kb, block, splits, dtype, r, true);
}
