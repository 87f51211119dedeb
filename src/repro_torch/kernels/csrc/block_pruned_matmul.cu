// Block-pruned matrix product for Hopper: y = x[:, keep] @ w[keep, :].
//
// Replaces the TPU kernel src/repro/kernels/pruned_matmul.py:
// block_pruned_matmul_2d (body _fwd_kernel), which streams only the kept
// (tm x block) / (block x tn) tiles through scalar-prefetched index maps.
//
// What bounds it on the H100: at decode the product has M = num_slots
// rows (8 on the main path) against a weight of K x N, so it performs
// about 2*M flops per weight element read — far below the ~295 flops per
// byte where the tensor cores would become the limit. It is bound by the
// bytes of the KEPT weight rows (kb*block*N elements), which is exactly
// the saving ZERO-resizing buys.
//
// Design: each thread owns one output column and all TM (= 8) rows of an
// M tile, so every weight element is read once per M tile, by
// neighbouring threads at neighbouring addresses (coalesced), and reused
// TM times from a register. The block reads the keep ids from device
// memory and loops only over kept K-blocks; the matching x columns are
// staged in shared memory and broadcast. With M this small, N / 128
// column blocks cannot fill 132 SMs, so the kept blocks are split into
// `splits` contiguous ranges across grid.z; each range writes an f32
// partial and a second pass sums the partials in a fixed order
// (deterministic, no float atomics) and casts to the output type.
// `x_compact` reads x as already compacted ([M, kb*block], slot k holds
// block keep[k]) — the second stage of the pruned FFN.
#include "common.cuh"

namespace {

constexpr int kTM = 8;         // output rows per thread
constexpr int kThreads = 128;  // output columns per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
bpm_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ keep, float* __restrict__ partial,
                   int M, int K, int N, int kb, int block, int x_compact,
                   int blocks_per_split) {
  extern __shared__ float xs[];  // [kTM][block]
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * kTM;
  const int s = blockIdx.z;
  const int k_lo = s * blocks_per_split;
  const int k_hi = min(kb, k_lo + blocks_per_split);
  const long x_stride = x_compact ? (long)kb * block : (long)K;

  float acc[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) acc[i] = 0.f;

  for (int kk = k_lo; kk < k_hi; ++kk) {
    const int kid = keep[kk];
    const long xcol0 = (long)(x_compact ? kk : kid) * block;
    __syncthreads();  // the previous block's xs reads are done
    for (int i = threadIdx.x; i < kTM * block; i += kThreads) {
      const int mi = i / block, r = i - mi * block;
      const int m = m0 + mi;
      xs[i] = (m < M) ? to_f(x[(long)m * x_stride + xcol0 + r]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const T* wp = w + (long)kid * block * N + n;
#pragma unroll 4
      for (int r = 0; r < block; ++r) {
        const float wv = to_f(wp[(long)r * N]);
#pragma unroll
        for (int mi = 0; mi < kTM; ++mi) acc[mi] += xs[mi * block + r] * wv;
      }
    }
  }
  if (n < N) {
#pragma unroll
    for (int mi = 0; mi < kTM; ++mi) {
      const int m = m0 + mi;
      if (m < M) partial[((long)s * M + m) * N + n] = acc[mi];
    }
  }
}

// The two launches of one call; returns their count.
int config(int M, int N, int kb, int block, int splits, int dtype,
           LaunchRec* r, bool names) {
  const int bps = (kb + splits - 1) / splits;
  const int used = (kb + bps - 1) / bps;  // ranges that hold a kept block
  set_launch(&r[0], names,
             dim3((N + kThreads - 1) / kThreads, (M + kTM - 1) / kTM,
                         used),
             kThreads, (size_t)kTM * block * sizeof(float),
             "bpm_partial_kernel<%s>", dt_name(dtype));
  const long mn = (long)M * N;
  set_launch(&r[1], names, dim3((unsigned)((mn + 255) / 256)), 256, 0,
             "reduce_splits_kernel<%s>", dt_name(dtype));
  return 2;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* keep,
                   float* partial, void* y, int M, int K, int N, int kb,
                   int block, int x_compact, int splits, cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  config(M, N, kb, block, splits, dtype_of<T>(), r, false);
  const int bps = (kb + splits - 1) / splits;
  const int used = r[0].grid[2];
  cudaError_t e = allow_smem(bpm_partial_kernel<T>, r[0].smem);
  if (e != cudaSuccess) return e;
  bpm_partial_kernel<T><<<grid_of(r[0]), r[0].threads, r[0].smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), keep, partial,
      M, K, N, kb, block, x_compact, bps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_splits_kernel<T><<<grid_of(r[1]), r[1].threads, 0, st>>>(
      partial, static_cast<T*>(y), (long)M * N, used);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (or [M, kb*block] when x_compact), w [K, N], keep int32 [kb],
// partial f32 scratch of at least splits*M*N, y [M, N]; all row-major and
// contiguous, x/w/y of one dtype (DT_F32 or DT_BF16).
extern "C" int repro_block_pruned_matmul(
    const void* x, const void* w, const int* keep, float* partial, void* y,
    int M, int K, int N, int kb, int block, int x_compact, int splits,
    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > kb || block < 1) return (int)cudaErrorInvalidValue;
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
