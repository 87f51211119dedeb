// The backward family of the block-pruned products, for Hopper (sm_90a).
//
// Replaces five TPU kernels of src/repro/kernels/pruned_matmul.py:
//
//   pruned_matmul_dx_2d      (#8)  dX[:, order[k]] = dy @ w[order[k]]^T, k < kb;
//                                  zeros at the pruned blocks; compact_out
//                                  writes slot k at columns [k*B, (k+1)*B)
//   pruned_matmul_dw_2d      (#9)  dW[order[k]] = x[:, order[k]]^T @ dy, k < kb;
//                                  zeros at the pruned rows; x_compact reads
//                                  x as [M, kb*B] with slot k at block k
//   outpruned_matmul_2d      (#10) yc[:, k] = x @ w[:, keep[k]]   (compact)
//   outpruned_matmul_dx_2d   (#11) dx = dyc @ w[:, keep]^T        (dense out)
//   outpruned_matmul_dw_2d   (#12) dW[:, order[k]] = x^T @ dyc[:, k], k < kb;
//                                  zeros at the pruned columns
//
// All five are one product C[i, j] = sum_t A(i, t) * B(t, j) that differ
// only in their index maps: an operand index that runs over a pruned
// dimension reads block idx[c / B] at offset c % B (B = the pruning block,
// resolved per B-wide block, so block 8 and block 128 run the same code),
// and the output is written compact or scattered back through idx. One
// templated core (`pruned_gemm_kernel`) holds the tiling; five small
// policy structs hold the maps. `idx` is the keep ids (#10, #11) or the
// inverse permutation `order` = keep ids, then pruned ids (#8, #9, #12):
// its first kb entries pair compact slot k with block idx[k] in the
// caller's order, sorted or not.
//
// What bounds it on the H100: on the training path (ViT-1B at tp = 4,
// M = 520 rows, d = 2048, f32) every product does 2*M flops per weight
// element and per output element, about 520 flops per byte read once:
// above the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 flops per byte, so
// the products are bound by operations. Design: a simple CUDA-core
// tiled GEMM, 64 x 64 output tiles per block of 256 threads, each thread
// a 4 x 4 register tile with f32 accumulation; operand tiles of depth 16
// staged in shared memory, loaded so that neighbouring threads read
// neighbouring addresses along whichever axis of the operand is
// contiguous. No split of the contraction (so no float atomics and no
// partials: the result is deterministic), no tensor cores, no TMA —
// those are for a later PR.
//
// Zeros are written by the kernel: an output tile that lies wholly in the
// pruned region skips the contraction and stores zeros, and a tile that
// straddles it stores zeros at its pruned positions. No output element is
// left unwritten, so an output allocated with torch.empty is safe.
#include "common.cuh"

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kDepth = 16;    // contraction depth per shared-memory stage
constexpr int kThreads = 256;
constexpr int kMicro = 4;     // per-thread register tile edge

struct Args {
  const void* a;
  const void* b;
  void* c;
  const int* idx;   // keep ids or the inverse order
  int I, J, T;      // output rows, output columns, contraction length
  int I_kept, J_kept;  // outputs at i >= I_kept or j >= J_kept are zeros
  int blk;          // pruning block
  int lda, ldb, ldc;   // row strides of the operands as stored
  int flag;         // compact_out (#8) / x_compact (#9)
};

__device__ __forceinline__ long mapped(const Args& p, int c) {
  return (long)p.idx[c / p.blk] * p.blk + c % p.blk;
}

// Each policy: A_CONTIG_T (A's stored layout is contiguous along t, else
// along i), B_CONTIG_T (B contiguous along t, else along j), the element
// offsets a_off / b_off, and the output offset c_off.

// #8: A = dy [I=M, T=N]; B(t, j) = w[row(j), t]; out [M, nslots*B].
struct DxPolicy {
  static constexpr const char* kName = "DxPolicy";
  static constexpr bool A_CONTIG_T = true;
  static constexpr bool B_CONTIG_T = true;
  __device__ static long a_off(const Args& p, int i, int t) {
    return (long)i * p.lda + t;
  }
  __device__ static long b_off(const Args& p, int t, int j) {
    return mapped(p, j) * p.ldb + t;
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return (long)i * p.ldc + (p.flag ? (long)j : mapped(p, j));
  }
};

// #9: A(i, t) = x[t, col(i)]; B = dy [T=M, J=N]; out row(i) of [nb*B, N].
struct DwPolicy {
  static constexpr const char* kName = "DwPolicy";
  static constexpr bool A_CONTIG_T = false;
  static constexpr bool B_CONTIG_T = false;
  __device__ static long a_off(const Args& p, int i, int t) {
    return (long)t * p.lda + (p.flag ? (long)i : mapped(p, i));
  }
  __device__ static long b_off(const Args& p, int t, int j) {
    return (long)t * p.ldb + j;
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return mapped(p, i) * p.ldc + j;
  }
};

// #10: A = x [M, K]; B(t, j) = w[t, col(j)]; out compact [M, kb*B].
struct OpPolicy {
  static constexpr const char* kName = "OpPolicy";
  static constexpr bool A_CONTIG_T = true;
  static constexpr bool B_CONTIG_T = false;
  __device__ static long a_off(const Args& p, int i, int t) {
    return (long)i * p.lda + t;
  }
  __device__ static long b_off(const Args& p, int t, int j) {
    return (long)t * p.ldb + mapped(p, j);
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return (long)i * p.ldc + j;
  }
};

// #11: A = dyc [M, kb*B]; B(t, j) = w[j, col(t)]; out dense [M, K].
struct OpDxPolicy {
  static constexpr const char* kName = "OpDxPolicy";
  static constexpr bool A_CONTIG_T = true;
  static constexpr bool B_CONTIG_T = true;
  __device__ static long a_off(const Args& p, int i, int t) {
    return (long)i * p.lda + t;
  }
  __device__ static long b_off(const Args& p, int t, int j) {
    return (long)j * p.ldb + mapped(p, t);
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return (long)i * p.ldc + j;
  }
};

// #12: A(i, t) = x[t, i]; B = dyc [T=M, kb*B]; out column col(j) of [K, nb*B].
struct OpDwPolicy {
  static constexpr const char* kName = "OpDwPolicy";
  static constexpr bool A_CONTIG_T = false;
  static constexpr bool B_CONTIG_T = false;
  __device__ static long a_off(const Args& p, int i, int t) {
    return (long)t * p.lda + i;
  }
  __device__ static long b_off(const Args& p, int t, int j) {
    return (long)t * p.ldb + j;
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return (long)i * p.ldc + mapped(p, j);
  }
};

template <typename Policy, typename T>
__global__ void __launch_bounds__(kThreads)
pruned_gemm_kernel(Args p) {
  __shared__ float As[kDepth][kTile + 1];  // As[t][i]
  __shared__ float Bs[kDepth][kTile + 1];  // Bs[t][j]
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ b = static_cast<const T*>(p.b);
  T* __restrict__ c = static_cast<T*>(p.c);
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int s = 0; s < kMicro; ++s) acc[r][s] = 0.f;

  // a tile wholly inside the pruned region only writes zeros
  const bool compute = i0 < p.I_kept && j0 < p.J_kept;
  if (compute) {
    for (int t0 = 0; t0 < p.T; t0 += kDepth) {
      __syncthreads();  // the previous stage's reads are done
      for (int e = tid; e < kTile * kDepth; e += kThreads) {
        int ii, tt;
        if (Policy::A_CONTIG_T) { ii = e / kDepth; tt = e % kDepth; }
        else                    { tt = e / kTile;  ii = e % kTile; }
        const int i = i0 + ii, t = t0 + tt;
        As[tt][ii] = (i < p.I_kept && t < p.T)
                         ? to_f(a[Policy::a_off(p, i, t)]) : 0.f;
      }
      for (int e = tid; e < kTile * kDepth; e += kThreads) {
        int jj, tt;
        if (Policy::B_CONTIG_T) { jj = e / kDepth; tt = e % kDepth; }
        else                    { tt = e / kTile;  jj = e % kTile; }
        const int j = j0 + jj, t = t0 + tt;
        Bs[tt][jj] = (j < p.J_kept && t < p.T)
                         ? to_f(b[Policy::b_off(p, t, j)]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int tt = 0; tt < kDepth; ++tt) {
        float av[kMicro], bv[kMicro];
#pragma unroll
        for (int r = 0; r < kMicro; ++r) av[r] = As[tt][ty + 16 * r];
#pragma unroll
        for (int s = 0; s < kMicro; ++s) bv[s] = Bs[tt][tx + 16 * s];
#pragma unroll
        for (int r = 0; r < kMicro; ++r)
#pragma unroll
          for (int s = 0; s < kMicro; ++s) acc[r][s] += av[r] * bv[s];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= p.I) continue;
#pragma unroll
    for (int s = 0; s < kMicro; ++s) {
      const int j = j0 + tx + 16 * s;
      if (j >= p.J) continue;
      const bool kept = i < p.I_kept && j < p.J_kept;
      c[Policy::c_off(p, i, j)] = from_f<T>(kept ? acc[r][s] : 0.f);
    }
  }
}

// The one launch of a call; returns the count, 0 for shapes it refuses.
int config(const Args& p, const char* policy, int dtype, LaunchRec* r,
           bool names) {
  if (p.I <= 0 || p.J <= 0 || p.T <= 0 || p.blk < 1) return 0;
  set_launch(&r[0], names,
             dim3((p.J + kTile - 1) / kTile, (p.I + kTile - 1) / kTile),
             kThreads, 0, "pruned_gemm_kernel<%s,%s>", policy, dt_name(dtype));
  return 1;
}

template <typename Policy>
int launch(const Args& p, int dtype, cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  if (config(p, Policy::kName, dtype, r, false) != 1 ||
      r[0].grid[1] > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    pruned_gemm_kernel<Policy, float><<<grid_of(r[0]), r[0].threads, 0, st>>>(p);
  else if (dtype == DT_BF16)
    pruned_gemm_kernel<Policy, __nv_bfloat16>
        <<<grid_of(r[0]), r[0].threads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The operands of each of the five products (pointers null for a config).
Args dx_args(const void* dy, const void* w, const int* order, void* dx,
             int M, int N, int nb, int kb, int block, int compact_out) {
  const int nslots = compact_out ? kb : nb;
  return Args{dy, w, dx, order, M, nslots * block, N, M, kb * block, block,
              N, N, nslots * block, compact_out};
}

Args dw_args(const void* x, const void* dy, const int* order, void* dw,
             int M, int N, int nb, int kb, int block, int x_compact) {
  const int ldx = (x_compact ? kb : nb) * block;
  return Args{x, dy, dw, order, nb * block, N, M, kb * block, N, block,
              ldx, N, N, x_compact};
}

Args op_args(const void* x, const void* w, const int* keep, void* yc, int M,
             int K, int H, int kb, int block) {
  return Args{x, w, yc, keep, M, kb * block, K, M, kb * block, block,
              K, H, kb * block, 0};
}

Args opdx_args(const void* dyc, const void* w, const int* keep, void* dx,
               int M, int K, int H, int kb, int block) {
  return Args{dyc, w, dx, keep, M, K, kb * block, M, K, block,
              kb * block, H, K, 0};
}

Args opdw_args(const void* x, const void* dyc, const int* order, void* dw,
               int M, int K, int nb, int kb, int block) {
  return Args{x, dyc, dw, order, K, nb * block, M, K, kb * block, block,
              K, kb * block, nb * block, 0};
}

}  // namespace

// All operands row-major and contiguous, of one dtype (DT_F32 / DT_BF16);
// idx int32. nb = number of B-wide blocks of the pruned dimension, kb the
// kept count (the length of the keep prefix of `order`). Each product's
// *_launch_config takes its integer arguments and writes its launch.

// #8. dy [M, N], w [nb*B, N], order [nb] -> dx [M, nb*B], or [M, kb*B]
// with compact_out (then only order's keep prefix is read).
extern "C" int repro_pruned_matmul_dx(
    const void* dy, const void* w, const int* order, void* dx, int M, int N,
    int nb, int kb, int block, int compact_out, int dtype, void* stream) {
  return launch<DxPolicy>(
      dx_args(dy, w, order, dx, M, N, nb, kb, block, compact_out), dtype,
      static_cast<cudaStream_t>(stream));
}

extern "C" int repro_pruned_matmul_dx_launch_config(
    int M, int N, int nb, int kb, int block, int compact_out, int dtype,
    LaunchRec* r) {
  return config(dx_args(nullptr, nullptr, nullptr, nullptr, M, N, nb, kb,
                        block, compact_out),
                DxPolicy::kName, dtype, r, true);
}

// #9. x [M, nb*B] (or [M, kb*B] with x_compact), dy [M, N], order [nb]
// -> dw [nb*B, N].
extern "C" int repro_pruned_matmul_dw(
    const void* x, const void* dy, const int* order, void* dw, int M, int N,
    int nb, int kb, int block, int x_compact, int dtype, void* stream) {
  return launch<DwPolicy>(
      dw_args(x, dy, order, dw, M, N, nb, kb, block, x_compact), dtype,
      static_cast<cudaStream_t>(stream));
}

extern "C" int repro_pruned_matmul_dw_launch_config(
    int M, int N, int nb, int kb, int block, int x_compact, int dtype,
    LaunchRec* r) {
  return config(dw_args(nullptr, nullptr, nullptr, nullptr, M, N, nb, kb,
                        block, x_compact),
                DwPolicy::kName, dtype, r, true);
}

// #10. x [M, K], w [K, H], keep [kb] -> yc [M, kb*B].
extern "C" int repro_outpruned_matmul(
    const void* x, const void* w, const int* keep, void* yc, int M, int K,
    int H, int kb, int block, int dtype, void* stream) {
  return launch<OpPolicy>(op_args(x, w, keep, yc, M, K, H, kb, block), dtype,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int repro_outpruned_matmul_launch_config(
    int M, int K, int H, int kb, int block, int dtype, LaunchRec* r) {
  return config(op_args(nullptr, nullptr, nullptr, nullptr, M, K, H, kb,
                        block),
                OpPolicy::kName, dtype, r, true);
}

// #11. dyc [M, kb*B], w [K, H], keep [kb] -> dx [M, K].
extern "C" int repro_outpruned_matmul_dx(
    const void* dyc, const void* w, const int* keep, void* dx, int M, int K,
    int H, int kb, int block, int dtype, void* stream) {
  return launch<OpDxPolicy>(opdx_args(dyc, w, keep, dx, M, K, H, kb, block),
                            dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_outpruned_matmul_dx_launch_config(
    int M, int K, int H, int kb, int block, int dtype, LaunchRec* r) {
  return config(opdx_args(nullptr, nullptr, nullptr, nullptr, M, K, H, kb,
                          block),
                OpDxPolicy::kName, dtype, r, true);
}

// #12. x [M, K], dyc [M, kb*B], order [nb] -> dw [K, nb*B].
extern "C" int repro_outpruned_matmul_dw(
    const void* x, const void* dyc, const int* order, void* dw, int M, int K,
    int nb, int kb, int block, int dtype, void* stream) {
  return launch<OpDwPolicy>(opdw_args(x, dyc, order, dw, M, K, nb, kb, block),
                            dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_outpruned_matmul_dw_launch_config(
    int M, int K, int nb, int kb, int block, int dtype, LaunchRec* r) {
  return config(opdw_args(nullptr, nullptr, nullptr, nullptr, M, K, nb, kb,
                          block),
                OpDwPolicy::kName, dtype, r, true);
}
