// The block-pruned products on the tensor cores, for Hopper (sm_90a).
//
// Replaces five TPU kernels of src/repro/kernels/pruned_matmul.py, and
// #2 above the decode kernel's rows (block_pruned_matmul.cu):
//
//   block_pruned_matmul_2d   (#2)  y = x[:, keep] @ w[keep, :], M rows
//                                  above the decode kernel's; x_compact
//                                  reads x as [M, kb*B] (#3's down product)
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
// All six are one product C[i, j] = sum_t A(i, t) * B(t, j) that differ
// only in their index maps: an index that runs over a pruned dimension
// reads block idx[c / B] at offset c % B (B = the pruning block, resolved
// per B-wide block, so block 8 and block 128 run the same code), and the
// output is written compact or scattered back through idx. The pruned
// index is i or j (#8, #9, #10, #12) or the contraction t itself (#2, #11:
// the kept blocks of w's rows or columns are what is summed over). One
// templated core (below) holds the tiling; six small policy structs hold
// the maps. `idx` is the keep ids (#2, #10, #11) or the inverse
// permutation `order` = keep ids, then pruned ids (#8, #9, #12): its
// first kb entries pair compact slot k with block idx[k] in the caller's
// order, sorted or not.
//
// What bounds it on the H100, on the training path (ViT-1B at tp = 4,
// M = 520 rows, d = 2048, f32 products as 3xTF32 at 495/3 TFLOP/s):
//   - #2, #8, #10 and #11 do 2*M flops per weight element and per output
//     element, about 520 flops per byte read once: bound by operations,
//     except #8 with few kept blocks (`wq`: 32 of 256), where writing its
//     mostly-zero output makes it bound by bytes;
//   - #9 and #12 contract over only M = 520 rows, and their outputs are
//     full weight gradients of which the kept blocks are a small part
//     (#9 `wq`: 256 of 2048 rows; the FFN's dW_down and dW_up: 240 of 2048
//     rows or columns), so they are bound by bytes, and most of the bytes
//     are the zeros of the pruned rows or columns (3.7 MB of `wq`'s 5.8,
//     14.8 of the FFN's 21.5).
//
// The core, `pruned_gemm_tc_kernel`:
//   - tensor cores through mma.sync: m16n8k16 bf16 with f32 accumulation
//     for bf16 operands; for f32 operands m16n8k8 TF32 in the 3xTF32 form
//     (each operand split into its top 10 mantissa bits and the rest,
//     both read as TF32, summed as lo*hi + hi*lo + hi*hi), which keeps
//     about f32's accuracy at a third of the TF32 rate (495/3 TFLOP/s);
//   - 64 x 64 output tiles per block of 4 warps (32 x 32 each), operand
//     tiles of depth 32 in a 3-stage cp.async ring in dynamic shared
//     memory, 16 bytes a copy, out-of-range copies zero-filled (src-size
//     0). An operand contiguous along the contraction (#2's, #8's, #10's
//     and #11's A, #8's and #11's B) is staged [rows][32 + pad] and read
//     by ldmatrix; one stored along i or j (x transposed, #9's and #12's
//     A; #2's, #9's, #10's and #12's B) is staged [32][64 + 8], copied
//     along i or j with the column of each copy resolved once per block
//     through the block map, and read by scalar shared loads in f32
//     (ldmatrix has no 32-bit transpose; a pitch of 72 puts a fragment's
//     32 lanes on 32 banks) or by ldmatrix.trans in bf16;
//   - a contraction through the block map (#2's A unless x_compact and
//     its B, #11's B): the stored position of t is resolved once per copy
//     and stage. Along t a 16-byte copy then needs a block of whole copies
//     (B % 4 in f32, B % 8 in bf16), so it never crosses a block; a copy
//     along i or j reads one mapped row t. An operand whose base, stride
//     or block is not whole 16-byte copies takes a predicated
//     element-wise path inside the same kernel;
//   - the contraction split across grid.z so that the kept tiles fill 132
//     SMs (the wrapper picks the count from the shapes and the SM count:
//     about two blocks per SM for #2, #8, #10 and #11, three for #9 and
//     #12, whose 17 stages give 9 ranges at `wq` and `wo` and 4 at the
//     FFN). Each split writes f32 partials of the kept region only; a
//     second launch sums them in a fixed order (no float atomics, so two
//     runs are bit-identical) and writes the output: `reduce_splits_kernel`
//     where it is contiguous (#2, #10, #11, #8 compact_out),
//     `reduce_splits_scatter_kernel` through the policy's map otherwise
//     (#8, #9, #12). Where #2 and #11 get one range (#11 at the FFN's 288
//     tiles; #2 at `wo` and the FFN's down product) the epilogue writes
//     the output itself and there is no second launch;
//   - the zeros: extra blocks of the first launch write the pruned columns
//     (#8, #12; along x) or rows (#9; along y), 64 x 64 a block in 16-byte
//     stores, while the product runs.
//   Measured against the alternatives (PERF.md): one range and no second
//   launch loses 1.4-2x to the split for #8, #9, #10 and #12; the zeros
//   written by the product's own blocks, and the splits of a tile summed
//   in a thread-block cluster through distributed shared memory, both
//   measured slower.
//
// No output element is left unwritten, so an output allocated with
// torch.empty is safe.
#include <type_traits>

#include "common.cuh"

namespace {

struct Args {
  const void* a;
  const void* b;
  void* c;
  const int* idx;   // keep ids or the inverse order
  int I, J, T;      // output rows, output columns, contraction length
  int I_kept, J_kept;  // outputs at i >= I_kept or j >= J_kept are zeros
  int blk;          // pruning block
  int lda, ldb, ldc;   // row strides of the operands as stored
  int flag;         // compact_out (#8) / x_compact (#2, #9)
  int a_vec, b_vec, c_vec;  // 16-byte copies / stores
};

__device__ __forceinline__ long mapped(const Args& p, int c) {
  return (long)p.idx[c / p.blk] * p.blk + c % p.blk;
}

// Which side of a scattered output holds the pruned region's zeros: none
// (a compact output), the rows [I_kept, I) (#9) or the columns
// [J_kept, J) (#8 unless compact_out, #12).
enum ZeroSide { kZeroNone, kZeroRows, kZeroCols };

// Each policy: A_CONTIG_T (A's stored layout is contiguous along t, else
// along i), B_CONTIG_T (B contiguous along t, else along j), A_MAPPED /
// B_MAPPED (an operand stored along i or j reads its columns through the
// block map, so a 16-byte copy needs a block of whole copies), ZERO and
// scattered(p) (whether this call's output is scattered, with its zeros
// written by the first launch), the element offsets a_off / b_off, whose
// t is the STORED position along the contraction, and the output offset
// c_off. From PolicyBase, unless a policy says otherwise: a_tmap(p) /
// b_tmap(p) (the operand's contraction index resolves through the block
// map: the stored position of t is mapped(p, t)) and DIRECT (with one
// range the epilogue writes the output through c_off, with no second
// launch).
struct PolicyBase {
  __host__ __device__ static bool a_tmap(const Args&) { return false; }
  __host__ __device__ static bool b_tmap(const Args&) { return false; }
  static constexpr bool DIRECT = false;
};

// #8: A = dy [I=M, T=N]; B(t, j) = w[row(j), t]; out [M, nslots*B].
struct DxPolicy : PolicyBase {
  static constexpr const char* kName = "DxPolicy";
  static constexpr bool A_CONTIG_T = true;
  static constexpr bool B_CONTIG_T = true;
  static constexpr bool A_MAPPED = false;
  static constexpr bool B_MAPPED = true;
  static constexpr ZeroSide ZERO = kZeroCols;   // unless compact_out
  __host__ __device__ static bool scattered(const Args& p) { return !p.flag; }
  __device__ static long a_off(const Args& p, int i, long t) {
    return (long)i * p.lda + t;
  }
  __device__ static long b_off(const Args& p, long t, int j) {
    return mapped(p, j) * p.ldb + t;
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return (long)i * p.ldc + (p.flag ? (long)j : mapped(p, j));
  }
};

// #9: A(i, t) = x[t, col(i)]; B = dy [T=M, J=N]; out row(i) of [nb*B, N].
struct DwPolicy : PolicyBase {
  static constexpr const char* kName = "DwPolicy";
  static constexpr bool A_CONTIG_T = false;
  static constexpr bool B_CONTIG_T = false;
  static constexpr bool A_MAPPED = true;    // unless x_compact
  static constexpr bool B_MAPPED = false;
  static constexpr ZeroSide ZERO = kZeroRows;
  __host__ __device__ static bool scattered(const Args&) { return true; }
  __device__ static long a_off(const Args& p, int i, long t) {
    return (long)t * p.lda + (p.flag ? (long)i : mapped(p, i));
  }
  __device__ static long b_off(const Args& p, long t, int j) {
    return (long)t * p.ldb + j;
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return mapped(p, i) * p.ldc + j;
  }
};

// #10: A = x [M, K]; B(t, j) = w[t, col(j)]; out compact [M, kb*B].
struct OpPolicy : PolicyBase {
  static constexpr const char* kName = "OpPolicy";
  static constexpr bool A_CONTIG_T = true;
  static constexpr bool B_CONTIG_T = false;
  static constexpr bool A_MAPPED = false;
  static constexpr bool B_MAPPED = true;
  static constexpr ZeroSide ZERO = kZeroNone;
  __host__ __device__ static bool scattered(const Args&) { return false; }
  __device__ static long a_off(const Args& p, int i, long t) {
    return (long)i * p.lda + t;
  }
  __device__ static long b_off(const Args& p, long t, int j) {
    return (long)t * p.ldb + mapped(p, j);
  }
  // the output is compact and contiguous: reduce_splits_kernel writes it
};

// #11: A = dyc [M, kb*B]; B(t, j) = w[j, col(t)]; out dense [M, K].
struct OpDxPolicy : PolicyBase {
  static constexpr const char* kName = "OpDxPolicy";
  static constexpr bool A_CONTIG_T = true;
  static constexpr bool B_CONTIG_T = true;
  static constexpr bool A_MAPPED = false;
  static constexpr bool B_MAPPED = false;
  static constexpr ZeroSide ZERO = kZeroNone;
  static constexpr bool DIRECT = true;
  __host__ __device__ static bool scattered(const Args&) { return false; }
  __host__ __device__ static bool b_tmap(const Args&) { return true; }
  __device__ static long a_off(const Args& p, int i, long t) {
    return (long)i * p.lda + t;
  }
  __device__ static long b_off(const Args& p, long t, int j) {
    return (long)j * p.ldb + t;
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return (long)i * p.ldc + j;
  }
};

// #2 above the decode kernel's rows: A(i, t) = x[i, col(t)] (x [M, K];
// with x_compact x [M, kb*B], slot k = block k, not mapped); B(t, j) =
// w[row(t), j] (w [K, N]); out dense [M, N].
struct BpmPolicy : PolicyBase {
  static constexpr const char* kName = "BpmPolicy";
  static constexpr bool A_CONTIG_T = true;
  static constexpr bool B_CONTIG_T = false;
  static constexpr bool A_MAPPED = false;
  static constexpr bool B_MAPPED = false;
  static constexpr ZeroSide ZERO = kZeroNone;
  static constexpr bool DIRECT = true;
  __host__ __device__ static bool scattered(const Args&) { return false; }
  __host__ __device__ static bool a_tmap(const Args& p) { return !p.flag; }
  __host__ __device__ static bool b_tmap(const Args&) { return true; }
  __device__ static long a_off(const Args& p, int i, long t) {
    return (long)i * p.lda + t;
  }
  __device__ static long b_off(const Args& p, long t, int j) {
    return t * p.ldb + j;
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return (long)i * p.ldc + j;
  }
};

// #12: A(i, t) = x[t, i]; B = dyc [T=M, kb*B]; out column col(j) of [K, nb*B].
struct OpDwPolicy : PolicyBase {
  static constexpr const char* kName = "OpDwPolicy";
  static constexpr bool A_CONTIG_T = false;
  static constexpr bool B_CONTIG_T = false;
  static constexpr bool A_MAPPED = false;
  static constexpr bool B_MAPPED = false;
  static constexpr ZeroSide ZERO = kZeroCols;
  __host__ __device__ static bool scattered(const Args&) { return true; }
  __device__ static long a_off(const Args& p, int i, long t) {
    return (long)t * p.lda + i;
  }
  __device__ static long b_off(const Args& p, long t, int j) {
    return (long)t * p.ldb + j;
  }
  __device__ static long c_off(const Args& p, int i, int j) {
    return (long)i * p.ldc + mapped(p, j);
  }
};

// ---------------------------------------------------------------------------
// The tensor-core core: split contraction, cp.async ring, mma.sync
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;      // output tile: rows
constexpr int kTcCols = 64;      // output tile: columns
constexpr int kTcDepth = 32;     // contraction depth of one ring stage
constexpr int kTcStages = 3;     // ring stages in flight
constexpr int kTcWarpsN = kTcCols / 32;  // one warp per 32 x 32 of the tile
constexpr int kTcThreads = kTcRows / 32 * kTcWarpsN * 32;

// Shared-memory layout of one ring stage for operands of type T. A is
// [kTcRows][kLdT] when it is contiguous along t (#8, #10), else
// [kTcDepth][kLdI] (#9, #12); B is [kTcCols][kLdT] when it is contiguous
// along t (#8), else [kTcDepth][kLdJ] (#9, #10, #12). The pads (16 bytes
// per t-row, 8 elements per i- or j-row) keep the fragment loads of a warp
// on 32 distinct banks and every row 16-byte aligned.
template <typename Policy, typename T>
struct TcLayout {
  static constexpr int kVec = 16 / (int)sizeof(T);    // elements per copy
  static constexpr int kLdT = kTcDepth + kVec;
  static constexpr int kLdI = kTcRows + 8;
  static constexpr int kLdJ = kTcCols + 8;
  static constexpr int kA = Policy::A_CONTIG_T ? kTcRows * kLdT
                                               : kTcDepth * kLdI;
  static constexpr int kB = Policy::B_CONTIG_T ? kTcCols * kLdT
                                               : kTcDepth * kLdJ;
  static constexpr int kStage = kA + kB;
  static constexpr int kBytes = kTcStages * kStage * (int)sizeof(T);
};

template <typename Policy>
int tc_smem_bytes(int dtype) {
  return dtype == DT_BF16 ? TcLayout<Policy, __nv_bfloat16>::kBytes
                          : TcLayout<Policy, float>::kBytes;
}

// One ring stage's products into the warp's 32 x 32 accumulator
// acc[m16 tile][n8 tile][4], fragments in the mma layouts of the PTX ISA
// (g = lane / 4 picks A's row and B's column, tg = lane % 4 the
// contraction index). Lane l addresses row l % 8 of matrix l / 8 of each
// ldmatrix.x4: for A, matrix m covers rows + 8 (m & 1) and the second
// half of the k-step when m >= 2; for B, the n8 tile + (m >> 1) and the
// second half of the k-step when m is odd. An operand stored along i or j
// (rows of the tile are t) is read by scalar loads in f32, where
// ldmatrix has no 32-bit transpose: with a row pitch of 72 the 32 lanes
// (t = k + tg, column g) fall on banks 8 tg + g, all distinct; in bf16 by
// ldmatrix.trans.
template <typename Policy, typename T>
__device__ __forceinline__ void tc_stage(float (&acc)[2][4][4], const T* As,
                                         const T* Bs, int wm, int wn,
                                         int lane) {
  using L = TcLayout<Policy, T>;
  const int lr = lane & 7, lm = lane >> 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int k = 0; k < kTcDepth; k += 8) {
      unsigned ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        unsigned v[4];
        if constexpr (Policy::A_CONTIG_T) {
          ldsm_x4(v, As + (wm * 32 + mt * 16 + (lm & 1) * 8 + lr) * L::kLdT +
                         k + (lm >> 1) * 4);
        } else {  // rows along i: a0..a3 at (g, tg), (g+8, tg), +4 in t
          const T* c = As + (k + (lane & 3)) * L::kLdI + wm * 32 + mt * 16 +
                       (lane >> 2);
          v[0] = __float_as_uint(c[0]);
          v[1] = __float_as_uint(c[8]);
          v[2] = __float_as_uint(c[4 * L::kLdI]);
          v[3] = __float_as_uint(c[4 * L::kLdI + 8]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(__uint_as_float(v[q]), ahi[mt][q], alo[mt][q]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        unsigned v[4];
        if constexpr (Policy::B_CONTIG_T) {
          ldsm_x4(v, Bs + (wn * 32 + nt * 8 + (lm >> 1) * 8 + lr) * L::kLdT +
                         k + (lm & 1) * 4);
        } else {  // rows along j: ldmatrix has no 32-bit transpose
          const T* c = Bs + (k + (lane & 3)) * L::kLdJ + wn * 32 + nt * 8 +
                       (lane >> 2);
          v[0] = __float_as_uint(c[0]);
          v[1] = __float_as_uint(c[4 * L::kLdJ]);
          v[2] = __float_as_uint(c[8]);
          v[3] = __float_as_uint(c[4 * L::kLdJ + 8]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(__uint_as_float(v[q]), bhi[nt + q / 2][q % 2],
                     blo[nt + q / 2][q % 2]);
      }
      // the small products first, each pass over all eight tiles, so a
      // tile's three dependent products are eight apart
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ahi[mt], blo[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ahi[mt], bhi[nt]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kTcDepth; k += 16) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if constexpr (Policy::A_CONTIG_T)
          ldsm_x4(a[mt], As + (wm * 32 + mt * 16 + (lm & 1) * 8 + lr) *
                                  L::kLdT + k + (lm >> 1) * 8);
        else  // matrix m: rows + 8 (m & 1), k + 8 (m >> 1), transposed
          ldsm_x4_t(a[mt], As + (k + (lm >> 1) * 8 + lr) * L::kLdI + wm * 32 +
                               mt * 16 + (lm & 1) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        unsigned v[4];
        if constexpr (Policy::B_CONTIG_T)
          ldsm_x4(v, Bs + (wn * 32 + nt * 8 + (lm >> 1) * 8 + lr) * L::kLdT +
                         k + (lm & 1) * 8);
        else
          ldsm_x4_t(v, Bs + (k + (lm & 1) * 8 + lr) * L::kLdJ + wn * 32 +
                           nt * 8 + (lm >> 1) * 8);
        b[nt][0] = v[0];
        b[nt][1] = v[1];
        b[nt + 1][0] = v[2];
        b[nt + 1][1] = v[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }
}

// Two neighbouring output elements in one store (8 bytes in f32, 4 in
// bf16); the caller checks the alignment.
__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// Block (x, y, z): output tile (y, x) of the kept region [I_kept, J_kept],
// contraction stages [z * steps_per_split, ...) -> f32 partials
// partial[z][i][j] of that region, summed by a second launch (with one
// range of a DIRECT policy, the output itself). With a
// scattered output, blocks past the kept tiles (along x for zero columns,
// along y for zero rows) write the pruned region's zeros while the
// product runs.
template <typename Policy, typename T>
__global__ void __launch_bounds__(kTcThreads)
pruned_gemm_tc_kernel(Args p, float* __restrict__ partial,
                      int steps_per_split) {
  static_assert(kTcRows == kTcCols, "A and B share the column-copy layout");
  using L = TcLayout<Policy, T>;
  constexpr int V = L::kVec;
  constexpr int kRowChunks = kTcDepth / V;          // copies per t-row
  constexpr int kACopies = kTcRows * kRowChunks / kTcThreads;
  constexpr int kBCopies = kTcCols * kRowChunks / kTcThreads;
  constexpr int kColChunks = kTcCols / V;           // copies per i- or j-row
  constexpr int kColCopies = kTcDepth * kColChunks / kTcThreads;
  constexpr int kColRows = kTcThreads / kColChunks;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sm = reinterpret_cast<T*>(tc_smem);
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ b = static_cast<const T*>(p.b);
  const T zero = from_f<T>(0.f);
  const int i0 = blockIdx.y * kTcRows;
  const int j0 = blockIdx.x * kTcCols;
  const int steps = (p.T + kTcDepth - 1) / kTcDepth;
  const int k_lo = blockIdx.z * steps_per_split;
  const int k_hi = min(steps, k_lo + steps_per_split);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
  const int tiles_x = (p.J_kept + kTcCols - 1) / kTcCols;
  const int tiles_y = (p.I_kept + kTcRows - 1) / kTcRows;
  if ((int)blockIdx.x >= tiles_x || (int)blockIdx.y >= tiles_y) {
    // chunk (x - tiles_x) * gridDim.z + z of the pruned columns, at rows
    // [i0, i0 + kTcRows), or (y - tiles_y) * gridDim.z + z of the pruned
    // rows, at columns [j0, j0 + kTcCols)
    if constexpr (Policy::ZERO != kZeroNone) {
      const int chunk = (Policy::ZERO == kZeroCols ? blockIdx.x - tiles_x
                                                   : blockIdx.y - tiles_y) *
                            gridDim.z + blockIdx.z;
      const int zi = Policy::ZERO == kZeroCols ? i0
                                                : p.I_kept + chunk * kTcRows;
      const int zj = Policy::ZERO == kZeroCols ? p.J_kept + chunk * kTcCols
                                                : j0;
      T* c = static_cast<T*>(p.c);
      const int w = p.c_vec ? V : 1;   // a store stays inside one block
      for (int e = tid; e < kTcRows * kTcCols / w; e += kTcThreads) {
        const int i = zi + e / (kTcCols / w), j = zj + e % (kTcCols / w) * w;
        if (i >= p.I || j >= p.J) continue;
        if (p.c_vec)
          *reinterpret_cast<uint4*>(c + Policy::c_off(p, i, j)) = uint4{};
        else
          c[Policy::c_off(p, i, j)] = zero;
      }
    }
    return;
  }

  // This thread's copies keep their rows (an operand contiguous along t)
  // or their column (one stored along i or j) across stages: resolve the
  // index map once. -1 marks a row or column outside the kept region.
  const int tc = (tid % kRowChunks) * V;
  long a_row[kACopies], b_row[kBCopies];
#pragma unroll
  for (int r = 0; r < kACopies; ++r) {
    const int rr = (tid + r * kTcThreads) / kRowChunks;
    a_row[r] = (Policy::A_CONTIG_T && i0 + rr < p.I_kept)
                   ? Policy::a_off(p, i0 + rr, 0) : -1;
  }
#pragma unroll
  for (int r = 0; r < kBCopies; ++r) {
    const int rr = (tid + r * kTcThreads) / kRowChunks;
    b_row[r] = (Policy::B_CONTIG_T && j0 + rr < p.J_kept)
                   ? Policy::b_off(p, 0, j0 + rr) : -1;
  }
  const int cc = (tid % kColChunks) * V;
  const int tr = tid / kColChunks;
  const long a_col = (!Policy::A_CONTIG_T && i0 + cc < p.I_kept)
                         ? Policy::a_off(p, i0 + cc, 0) : -1;
  const long b_col = (!Policy::B_CONTIG_T && j0 + cc < p.J_kept)
                         ? Policy::b_off(p, 0, j0 + cc) : -1;

  // the stored position of contraction index t < T of an operand whose t
  // runs through the block map (`tmap`), else t itself
  auto pos = [&](int t, bool tmap) -> long {
    return tmap ? mapped(p, t) : (long)t;
  };
  // This thread's copies of a tile contiguous along t all start at t0 + tc:
  // one stored position per stage (with a mapped t the vector path needs
  // whole copies per block, so a copy stays inside one block)
  auto load_rows = [&](const T* src, const long* row, int copies, T* tile,
                       int t0, bool vec, bool tmap) {
    const int t = t0 + tc;
    const long tp = (vec && t < p.T) ? pos(t, tmap) : 0;
#pragma unroll
    for (int r = 0; r < copies; ++r) {
      const int rr = (tid + r * kTcThreads) / kRowChunks;
      T* dst = tile + rr * L::kLdT + tc;
      if (vec) {
        const bool ok = row[r] >= 0 && t < p.T;
        cp_async16(dst, ok ? src + row[r] + tp : src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          dst[e] = (row[r] >= 0 && t + e < p.T)
                       ? src[row[r] + pos(t + e, tmap)] : zero;
      }
    }
  };
  // rows t of a [kTcDepth][ld] tile, columns [c0 + cc, + V) of this
  // thread; `off(tp, c)` is the element offset of the element-wise path
  // at stored position tp
  auto load_cols = [&](const T* src, long col, int ld_src, int ld, int c0,
                       int c_end, T* tile, int t0, bool vec, bool tmap,
                       auto off) {
#pragma unroll
    for (int r = 0; r < kColCopies; ++r) {
      const int tt = tr + r * kColRows, t = t0 + tt;
      T* dst = tile + tt * ld + cc;
      const long tp = t < p.T ? pos(t, tmap) : 0;
      if (vec) {
        const bool ok = col >= 0 && t < p.T;
        cp_async16(dst, ok ? src + tp * ld_src + col : src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int c = c0 + cc + e;
          dst[e] = (c < c_end && t < p.T) ? src[off(tp, c)] : zero;
        }
      }
    }
  };
  auto load = [&](int kt, int slot) {
    const int t0 = kt * kTcDepth;
    T* As = sm + slot * L::kStage;
    T* Bs = As + L::kA;
    if constexpr (Policy::A_CONTIG_T)
      load_rows(a, a_row, kACopies, As, t0, p.a_vec, Policy::a_tmap(p));
    else
      load_cols(a, a_col, p.lda, L::kLdI, i0, p.I_kept, As, t0, p.a_vec,
                Policy::a_tmap(p),
                [&](long tp, int i) { return Policy::a_off(p, i, tp); });
    if constexpr (Policy::B_CONTIG_T)
      load_rows(b, b_row, kBCopies, Bs, t0, p.b_vec, Policy::b_tmap(p));
    else
      load_cols(b, b_col, p.ldb, L::kLdJ, j0, p.J_kept, Bs, t0, p.b_vec,
                Policy::b_tmap(p),
                [&](long tp, int j) { return Policy::b_off(p, tp, j); });
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  // the ring: stage kt lives in slot (kt - k_lo) % kTcStages; one commit
  // group per stage, empty past the split's end, so the wait counts hold
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (k_lo + s < k_hi) load(k_lo + s, s);
    cp_async_commit();
  }
  for (int kt = k_lo; kt < k_hi; ++kt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    const int nk = kt + kTcStages - 1;
    if (nk < k_hi) load(nk, (nk - k_lo) % kTcStages);
    cp_async_commit();
    const T* As = sm + ((kt - k_lo) % kTcStages) * L::kStage;
    tc_stage<Policy, T>(acc, As, As + L::kA, wm, wn, lane);
  }
  cp_async_wait<0>();

  // one range of a DIRECT policy: the output itself, through c_off (rows
  // contiguous along j); otherwise this range's f32 partial of the kept
  // region, summed by the second launch
  if constexpr (Policy::DIRECT) {
    if (gridDim.z == 1) {
      T* c = static_cast<T*>(p.c);
      const bool pairs =
          (p.ldc & 1) == 0 &&
          ((unsigned long long)p.c & (2 * sizeof(T) - 1)) == 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + wm * 32 + mt * 16 + g + 8 * h;
          if (i >= p.I_kept) continue;
          T* row = c + Policy::c_off(p, i, 0);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int j = j0 + wn * 32 + nt * 8 + 2 * tg;
            const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
            if (pairs && j + 1 < p.J_kept) {
              store2(row + j, v0, v1);
            } else {
              if (j < p.J_kept) row[j] = from_f<T>(v0);
              if (j + 1 < p.J_kept) row[j + 1] = from_f<T>(v1);
            }
          }
        }
      return;
    }
  }
  float* out = partial + (long)blockIdx.z * p.I_kept * p.J_kept;
  const bool pairs = (p.J_kept & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wm * 32 + mt * 16 + g + 8 * h;
      if (i >= p.I_kept) continue;
      float* row = out + (long)i * p.J_kept;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = j0 + wn * 32 + nt * 8 + 2 * tg;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pairs && j + 1 < p.J_kept) {
          *reinterpret_cast<float2*>(row + j) = make_float2(v0, v1);
        } else {
          if (j < p.J_kept) row[j] = v0;
          if (j + 1 < p.J_kept) row[j + 1] = v1;
        }
      }
    }
}

// The second pass of #8 without compact_out: y at Policy::c_off(i, j) =
// the sum of the splits' partials at (i, j) of the kept region, in a fixed
// order. The pruned columns got their zeros from the first launch.
template <typename Policy, typename T>
__global__ void reduce_splits_scatter_kernel(
    Args p, const float* __restrict__ partial, int splits) {
  const long n = (long)p.I_kept * p.J_kept;
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * n + e];
  static_cast<T*>(p.c)[Policy::c_off(p, (int)(e / p.J_kept),
                                     (int)(e % p.J_kept))] = from_f<T>(s);
}

// Ring stages per contraction range for `splits` ranges.
static inline int tc_steps_per_split(const Args& p, int splits) {
  const int steps = (p.T + kTcDepth - 1) / kTcDepth;
  return (steps + splits - 1) / splits;
}

// The launches of a call (the split products, then the sum of the splits;
// the products alone for one range of a DIRECT policy); returns the
// count, 0 for shapes it refuses.
template <typename Policy>
int tc_config(const Args& p, int splits, int dtype, LaunchRec* r,
              bool names) {
  if (p.I <= 0 || p.J <= 0 || p.T <= 0 || p.blk < 1 || p.I_kept <= 0 ||
      p.J_kept <= 0 || splits < 1)
    return 0;
  const int sps = tc_steps_per_split(p, splits);
  const int used = ((p.T + kTcDepth - 1) / kTcDepth + sps - 1) / sps;
  // with a scattered output, extra blocks write the zeros of the pruned
  // columns [J_kept, J) (along x) or rows [I_kept, I) (along y) in
  // kTcRows x kTcCols chunks, `used` per extra block
  const bool scattered = Policy::scattered(p);
  const int zero_x = scattered && Policy::ZERO == kZeroCols
                         ? (p.J - p.J_kept + kTcCols - 1) / kTcCols : 0;
  const int zero_y = scattered && Policy::ZERO == kZeroRows
                         ? (p.I - p.I_kept + kTcRows - 1) / kTcRows : 0;
  set_launch(&r[0], names,
             dim3((p.J_kept + kTcCols - 1) / kTcCols +
                      (zero_x + used - 1) / used,
                  (p.I_kept + kTcRows - 1) / kTcRows +
                      (zero_y + used - 1) / used,
                  used),
             kTcThreads, tc_smem_bytes<Policy>(dtype),
             "pruned_gemm_tc_kernel<%s,%s>", Policy::kName, dt_name(dtype));
  if (Policy::DIRECT && used == 1) return 1;
  // one thread per element of the kept region (the whole output when it
  // is compact)
  const dim3 sum_grid((unsigned)(((long)p.I_kept * p.J_kept + 255) / 256));
  if (scattered)
    set_launch(&r[1], names, sum_grid, 256, 0,
               "reduce_splits_scatter_kernel<%s,%s>", Policy::kName,
               dt_name(dtype));
  else
    set_launch(&r[1], names, sum_grid, 256, 0, "reduce_splits_kernel<%s>",
               dt_name(dtype));
  return 2;
}

static inline bool aligned16(const void* q) {
  return ((unsigned long long)q & 15ull) == 0;
}

template <typename Policy, typename T>
int tc_launch_t(Args p, float* partial, int splits, cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  const int n = tc_config<Policy>(p, splits, dtype_of<T>(), r, false);
  if (n == 0 || r[0].grid[1] > 65535 || r[0].grid[2] > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int V = TcLayout<Policy, T>::kVec;
  // whole 16-byte copies: along t, the contraction's rows and, through a
  // block map, the block; along i or j, the kept edge and, through a
  // block map, the block
  p.a_vec = aligned16(p.a) && p.lda % V == 0 &&
            (Policy::A_CONTIG_T
                 ? p.T % V == 0 && (!Policy::a_tmap(p) || p.blk % V == 0)
                 : p.I_kept % V == 0 && (!Policy::A_MAPPED || p.blk % V == 0));
  p.b_vec = aligned16(p.b) && p.ldb % V == 0 &&
            (Policy::B_CONTIG_T
                 ? p.T % V == 0 && (!Policy::b_tmap(p) || p.blk % V == 0)
                 : p.J_kept % V == 0 && (!Policy::B_MAPPED || p.blk % V == 0));
  // zero stores run along j: inside one row (zero rows) or one block
  p.c_vec = aligned16(p.c) && p.ldc % V == 0 &&
            (Policy::ZERO == kZeroRows ? p.J % V == 0 : p.blk % V == 0);
  const int used = r[0].grid[2];
  cudaError_t e = allow_smem(pruned_gemm_tc_kernel<Policy, T>, r[0].smem);
  if (e != cudaSuccess) return (int)e;
  pruned_gemm_tc_kernel<Policy, T><<<grid_of(r[0]), r[0].threads, r[0].smem,
                                     st>>>(p, partial,
                                           tc_steps_per_split(p, splits));
  e = cudaGetLastError();
  if (e != cudaSuccess || n == 1) return (int)e;
  if constexpr (Policy::ZERO != kZeroNone) {
    if (Policy::scattered(p)) {
      reduce_splits_scatter_kernel<Policy, T>
          <<<grid_of(r[1]), r[1].threads, 0, st>>>(p, partial, used);
      return (int)cudaGetLastError();
    }
  }
  reduce_splits_kernel<T><<<grid_of(r[1]), r[1].threads, 0, st>>>(
      partial, static_cast<T*>(p.c), (long)p.I_kept * p.J_kept, used);
  return (int)cudaGetLastError();
}

template <typename Policy>
int tc_launch(const Args& p, float* partial, int splits, int dtype,
              cudaStream_t st) {
  if (dtype == DT_F32) return tc_launch_t<Policy, float>(p, partial, splits, st);
  if (dtype == DT_BF16)
    return tc_launch_t<Policy, __nv_bfloat16>(p, partial, splits, st);
  return (int)cudaErrorInvalidValue;
}

// The operands of each of the six products (pointers null for a config).
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

Args bpm_args(const void* x, const void* w, const int* keep, void* y, int M,
              int K, int N, int kb, int block, int x_compact) {
  return Args{x, w, y, keep, M, N, kb * block, M, N, block,
              x_compact ? kb * block : K, N, N, x_compact};
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
// with compact_out (then only order's keep prefix is read); partial f32
// scratch of at least splits * M * kb*B.
extern "C" int repro_pruned_matmul_dx(
    const void* dy, const void* w, const int* order, float* partial,
    void* dx, int M, int N, int nb, int kb, int block, int compact_out,
    int splits, int dtype, void* stream) {
  return tc_launch<DxPolicy>(
      dx_args(dy, w, order, dx, M, N, nb, kb, block, compact_out), partial,
      splits, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_pruned_matmul_dx_launch_config(
    int M, int N, int nb, int kb, int block, int compact_out, int splits,
    int dtype, LaunchRec* r) {
  return tc_config<DxPolicy>(dx_args(nullptr, nullptr, nullptr, nullptr, M,
                                     N, nb, kb, block, compact_out),
                             splits, dtype, r, true);
}

// #9. x [M, nb*B] (or [M, kb*B] with x_compact), dy [M, N], order [nb]
// -> dw [nb*B, N]; partial f32 scratch of at least splits * kb*B * N.
extern "C" int repro_pruned_matmul_dw(
    const void* x, const void* dy, const int* order, float* partial,
    void* dw, int M, int N, int nb, int kb, int block, int x_compact,
    int splits, int dtype, void* stream) {
  return tc_launch<DwPolicy>(
      dw_args(x, dy, order, dw, M, N, nb, kb, block, x_compact), partial,
      splits, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_pruned_matmul_dw_launch_config(
    int M, int N, int nb, int kb, int block, int x_compact, int splits,
    int dtype, LaunchRec* r) {
  return tc_config<DwPolicy>(dw_args(nullptr, nullptr, nullptr, nullptr, M,
                                     N, nb, kb, block, x_compact),
                             splits, dtype, r, true);
}

// #10. x [M, K], w [K, H], keep [kb] -> yc [M, kb*B]; partial f32
// scratch of at least splits * M * kb*B.
extern "C" int repro_outpruned_matmul(
    const void* x, const void* w, const int* keep, float* partial, void* yc,
    int M, int K, int H, int kb, int block, int splits, int dtype,
    void* stream) {
  return tc_launch<OpPolicy>(op_args(x, w, keep, yc, M, K, H, kb, block),
                             partial, splits, dtype,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_outpruned_matmul_launch_config(
    int M, int K, int H, int kb, int block, int splits, int dtype,
    LaunchRec* r) {
  return tc_config<OpPolicy>(op_args(nullptr, nullptr, nullptr, nullptr, M,
                                     K, H, kb, block),
                             splits, dtype, r, true);
}

// #11. dyc [M, kb*B], w [K, H], keep [kb] -> dx [M, K]; partial f32
// scratch of at least splits * M * K (unused with one range).
extern "C" int repro_outpruned_matmul_dx(
    const void* dyc, const void* w, const int* keep, float* partial,
    void* dx, int M, int K, int H, int kb, int block, int splits, int dtype,
    void* stream) {
  return tc_launch<OpDxPolicy>(
      opdx_args(dyc, w, keep, dx, M, K, H, kb, block), partial, splits,
      dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_outpruned_matmul_dx_launch_config(
    int M, int K, int H, int kb, int block, int splits, int dtype,
    LaunchRec* r) {
  return tc_config<OpDxPolicy>(opdx_args(nullptr, nullptr, nullptr, nullptr,
                                         M, K, H, kb, block),
                               splits, dtype, r, true);
}

// #2 on the tensor cores (the rows above the decode kernel's, see
// block_pruned_matmul.cu). x [M, K] (or [M, kb*B] with x_compact), w
// [K, N], keep [kb] -> y [M, N]; partial f32 scratch of at least
// splits * M * N (unused with one range).
extern "C" int repro_block_pruned_matmul_tc(
    const void* x, const void* w, const int* keep, float* partial, void* y,
    int M, int K, int N, int kb, int block, int x_compact, int splits,
    int dtype, void* stream) {
  return tc_launch<BpmPolicy>(
      bpm_args(x, w, keep, y, M, K, N, kb, block, x_compact), partial,
      splits, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_block_pruned_matmul_tc_launch_config(
    int M, int K, int N, int kb, int block, int x_compact, int splits,
    int dtype, LaunchRec* r) {
  return tc_config<BpmPolicy>(bpm_args(nullptr, nullptr, nullptr, nullptr, M,
                                       K, N, kb, block, x_compact),
                              splits, dtype, r, true);
}

// #12. x [M, K], dyc [M, kb*B], order [nb] -> dw [K, nb*B]; partial f32
// scratch of at least splits * K * kb*B.
extern "C" int repro_outpruned_matmul_dw(
    const void* x, const void* dyc, const int* order, float* partial,
    void* dw, int M, int K, int nb, int kb, int block, int splits, int dtype,
    void* stream) {
  return tc_launch<OpDwPolicy>(
      opdw_args(x, dyc, order, dw, M, K, nb, kb, block), partial, splits,
      dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_outpruned_matmul_dw_launch_config(
    int M, int K, int nb, int kb, int block, int splits, int dtype,
    LaunchRec* r) {
  return tc_config<OpDwPolicy>(opdw_args(nullptr, nullptr, nullptr, nullptr,
                                         M, K, nb, kb, block),
                               splits, dtype, r, true);
}
