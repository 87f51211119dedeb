// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel reads float32 or bfloat16 operands, converts them to
// float32 on load and accumulates in float32. The C entry points take a
// dtype code (DT_F32 / DT_BF16), launch on the caller's stream and
// return cudaGetLastError(), which the Python wrapper checks.
#pragma once

#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Ask for more than the default 48 KB of dynamic shared memory where a
// launch needs it (up to the 227 KB a block can have on Hopper).
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Deterministic split reduction: y[i] = sum_j partial[j, i] in a fixed
// order, cast to the output type. Used by the kernels that split their
// contraction across blocks (no float atomics).
template <typename T>
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     T* __restrict__ y, long n, int splits) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += partial[(long)j * n + i];
  y[i] = from_f<T>(s);
}
