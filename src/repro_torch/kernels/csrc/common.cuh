// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel reads float32 or bfloat16 operands, converts them to
// float32 on load and accumulates in float32. The C entry points take a
// dtype code (DT_F32 / DT_BF16), launch on the caller's stream and
// return cudaGetLastError(), which the Python wrapper checks.
//
// Each launcher family computes its launches (function, grid, threads,
// dynamic shared memory) in one config function that it launches from
// and also exports as repro_*_launch_config, so the analyzer
// (repro_torch.analysis, rule R4) prices exactly the launches that run.
// Only the export asks config for the functions' names (names = true):
// a launch formats no string.
#pragma once

#include <math.h>
#include <stdarg.h>
#include <stdio.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

template <typename T> constexpr int dtype_of();
template <> constexpr int dtype_of<float>() { return DT_F32; }
template <> constexpr int dtype_of<__nv_bfloat16>() { return DT_BF16; }

static inline const char* dt_name(int dtype) {
  return dtype == DT_BF16 ? "__nv_bfloat16" : "float";
}

// One kernel launch: the __global__ function as name<template arguments>
// (how the analyzer names the entries of ptxas's -v log), the grid, the
// threads per block and the dynamic shared memory in bytes.
struct LaunchRec {
  char fn[96];
  int grid[3];
  int threads;
  int smem;
};
constexpr int kMaxLaunches = 4;

static inline void set_launch(LaunchRec* r, bool names, dim3 grid,
                              int threads, size_t smem, const char* fmt,
                              ...) {
  r->fn[0] = '\0';
  if (names) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(r->fn, sizeof(r->fn), fmt, ap);
    va_end(ap);
  }
  r->grid[0] = (int)grid.x;
  r->grid[1] = (int)grid.y;
  r->grid[2] = (int)grid.z;
  r->threads = threads;
  r->smem = (int)smem;
}

static inline dim3 grid_of(const LaunchRec& r) {
  return dim3((unsigned)r.grid[0], (unsigned)r.grid[1], (unsigned)r.grid[2]);
}

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

// Tensor-core products through mma.sync (block_pruned_matmul.cu,
// pruned_grad.cu): fragments in the layouts of the PTX ISA, f32
// accumulation in place.
//
// x = hi + lo exactly: hi keeps the top 10 bits of x's mantissa (a TF32
// value), lo is the remainder, which the tensor core reads as TF32 by
// dropping its own low 13 bits. hi*hi + hi*lo + lo*hi then misses x's
// products by about 2^-20 relative: f32's accuracy, not TF32's 2^-10.
// A mask and a subtraction, not cvt.rna (a slow conversion pipe).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte copies from device to shared memory that run while the warp
// computes (pruned_grad.cu, gqa_decode_attn.cu): a copy with valid =
// false reads nothing and zero-fills its 16 bytes (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit elements (rows of 16 bytes) from shared
// memory; lane l gives the row address of matrix l / 8, row l % 8, and
// gets in r[m] the pair at (row l / 4, columns 2 (l % 4), +1) of matrix
// m. On f32 data a pair is one float: column l % 4 of a row of 4 floats.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The same, each matrix transposed: r[m] holds (rows 2 (l % 4), +1;
// column l / 4).
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Two f32 values as the bf16 pair of an mma fragment (lo in the low half).
__device__ __forceinline__ unsigned bf16x2_of(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The 16 x 16 product A . B^T of two 16-row tiles in shared memory, rows
// of kp values (kp a multiple of 16; KP = kp at compile time, or 0):
// A [16][lda], B [16][ldb] in T (row strides in elements, whole 16-byte
// units). s[n] is the n-th 8-column half in the mma C layout: row g =
// lane / 4 holds columns n * 8 + 2 (lane % 4), +1 in s[n][0..1], row g + 8
// in s[n][2..3]. bf16: m16n8k16, both operands by ldmatrix. f32: m16n8k8
// in the 3xTF32 form (split_tf32; f32's accuracy), an f32 row read by
// ldmatrix as pairs of 16-bit halves (one float a pair). Four sets of
// accumulators take the k-steps in turn and are added at the end in a
// fixed order, so the chain of dependent mma is a quarter as long. Used by
// the MLA decode attention (q against latent + rope rows) and the unfused
// attention's scores (q against K rows).
template <typename T, int KP>
__device__ __forceinline__ void mma_tile16_scores(float (&s)[2][4],
                                                  const T* a_s, int lda,
                                                  const T* b_s, int ldb,
                                                  int kp, int lane) {
  constexpr int kStep = sizeof(T) == 4 ? 8 : 16;   // k a step
  constexpr int kSets = 4;
  const int lr = lane & 7, lm = lane >> 3;
  const int k_end = KP ? KP : kp;
  float acc[kSets][2][4];
#pragma unroll
  for (int u = 0; u < kSets; ++u)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][n][i] = 0.f;
  const T* ar = a_s + ((lm & 1) * 8 + lr) * lda;
  const T* br = b_s + ((lm >> 1) * 8 + lr) * ldb;
  for (int k0 = 0; k0 < k_end; k0 += kSets * kStep) {
#pragma unroll
    for (int u = 0; u < kSets; ++u) {
      const int kk = k0 + u * kStep;
      if (kk >= k_end) break;                 // a run-time width's tail
      if constexpr (sizeof(T) == 4) {
        unsigned a[4], w[4], ahi[4], alo[4], bhi[4], blo[4];
        ldsm_x4(a, ar + kk + (lm >> 1) * 4);
        ldsm_x4(w, br + kk + (lm & 1) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(__uint_as_float(a[i]), ahi[i], alo[i]);
          split_tf32(__uint_as_float(w[i]), bhi[i], blo[i]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_tf32(acc[u][n], alo, bhi + 2 * n);
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_tf32(acc[u][n], ahi, blo + 2 * n);
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_tf32(acc[u][n], ahi, bhi + 2 * n);
      } else {
        unsigned a[4], w[4];
        ldsm_x4(a, ar + kk + (lm >> 1) * 8);
        ldsm_x4(w, br + kk + (lm & 1) * 8);
        mma_bf16(acc[u][0], a, w);
        mma_bf16(acc[u][1], a, w + 2);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[n][i] = (acc[0][n][i] + acc[1][n][i]) + (acc[2][n][i] + acc[3][n][i]);
}

// Ask for more than the default 48 KB of dynamic shared memory where a
// launch needs it (up to the 227 KB a block can have on Hopper).
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// allow_smem once per device and size, not at every launch
// (cudaFuncSetAttribute costs the host more than the launch itself).
// `allowed` is the launcher's record for this kernel: the bytes opted in
// on each of the first kSmemDevices devices.
constexpr int kSmemDevices = 16;
template <typename K>
static inline cudaError_t allow_smem_once(K kernel, size_t bytes,
                                          size_t (&allowed)[kSmemDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kSmemDevices && bytes <= allowed[dev]) return cudaSuccess;
  e = allow_smem(kernel, bytes);
  if (e == cudaSuccess && dev < kSmemDevices) allowed[dev] = bytes;
  return e;
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
