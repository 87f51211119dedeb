// Fused absorbed-MLA (DeepSeek-V2) one-token decode attention for Hopper,
// over the fixed slot cache and over the block-paged pool.
//
// Replaces the TPU kernels src/repro/kernels/decode_attn.py:
// mla_decode_attn_2d (body _mla_kernel; entry repro_mla_decode_attn) and
// mla_paged_decode_attn_2d (body _paged_mla_kernel; entry
// repro_mla_paged_decode_attn). Per slot b and head h:
//
//   s[h, p] = (q_abs[b, h] . latent[p] + q_rope[b, h] . rope[p]) * scale
//   out[b, h] = sum_p softmax_p(s[h, :]) latent[p]        (f32, [R])
//
// over the rows p <= cur_pos[b] (a cur_pos past the cache — the engine's
// invalid lanes use 2**30 — attends every present row; a slot with no
// row writes 0). The two entry points share one templated body and differ
// only in where row p of slot b lives (a row policy):
//
//   SlotRows   latent [B, S, R]          -> b * S + p
//   PagedRows  latent [num_pages, ps, R] -> page * ps + p % ps with
//              page = pages[b, p / ps]; -1 (unallocated) or a page id
//              outside the pool is absent and never read, as the TPU
//              kernel's `page >= 0 && tile valid` test skips it.
//
// What bounds it on the H100: every attended row (R + Dr values: 1152 B
// in bf16 at R = 512, Dr = 64) is read once and feeds 4 * H * R + 2 * H *
// Dr flops for the H = 16 heads, ~70 flops per byte, so the kernel is
// bound by the bytes of each slot's rows up to its cur_pos. Design: all H
// heads share each latent row (MQA-like), so one block per (slot, range
// of rows) stages a tile of TS latent + rope rows in shared memory as f32
// (rows padded by one word against bank conflicts; absent rows are zero
// and never loaded), computes the H x TS scores, runs the online (m, l)
// softmax per head in f32 and accumulates p . latent into an [H, R] f32
// partial in shared memory. Only B = 8 slots exist on the main path, so
// each slot's tiles are split into contiguous ranges across blocks, or
// the card would sit idle; a second pass merges the ranges of each slot
// in a fixed order (deterministic, no atomics). The TPU kernels instead
// walk a slot's tiles (or pages) in one sequential grid row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTS = 16;  // latent rows per tile

struct SlotRows {
  int S;
  __device__ __forceinline__ long operator()(int b, int pos) const {
    return (long)b * S + pos;
  }
};

struct PagedRows {
  const int* pages;  // [B, pps]
  int ps, pps, num_pages;
  __device__ __forceinline__ long operator()(int b, int pos) const {
    const int page = pages[(long)b * pps + pos / ps];
    if (page < 0 || page >= num_pages) return -1;
    return (long)page * ps + pos % ps;
  }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
mla_partial_kernel(const T* __restrict__ q_abs, const T* __restrict__ q_rope,
                   const T* __restrict__ latent, const T* __restrict__ rope,
                   const int* __restrict__ cur_pos,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, Rows rows, int H, int R,
                   int Dr, int S, float scale) {
  extern __shared__ float sm[];
  __shared__ long row_s[kTS];        // cache row of each tile row, or -1
  const int Qp = R + Dr + 1;         // q row: [q_abs | q_rope | pad]
  const int Rp = R + 1, Dp = Dr + 1;
  float* q_s = sm;                   // [H][R + Dr + 1]
  float* lat_s = q_s + H * Qp;       // [TS][R + 1]
  float* rope_s = lat_s + kTS * Rp;  // [TS][Dr + 1]
  float* p_s = rope_s + kTS * Dp;    // [H][TS]
  float* acc_s = p_s + H * kTS;      // [H][R]
  float* m_s = acc_s + H * R;        // [H]
  float* l_s = m_s + H;              // [H]
  float* c_s = l_s + H;              // [H]

  const int b = blockIdx.x;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;

  const int cur = cur_pos[b];
  const int hi = min(cur, S - 1);    // last attended row
  const int n_tiles = hi >= 0 ? hi / kTS + 1 : 0;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = split * per * kTS;
  const int t_end = min(n_tiles, (split + 1) * per) * kTS;

  for (int i = tid; i < H * R; i += kThreads) {
    const int h = i / R, r = i - h * R;
    q_s[h * Qp + r] = to_f(q_abs[(long)b * H * R + i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < H * Dr; i += kThreads) {
    const int h = i / Dr, d = i - h * Dr;
    q_s[h * Qp + R + d] = to_f(q_rope[(long)b * H * Dr + i]);
  }
  for (int h = tid; h < H; h += kThreads) { m_s[h] = -INFINITY; l_s[h] = 0.f; }

  for (int t0 = t_begin; t0 < t_end; t0 += kTS) {
    __syncthreads();  // previous tile's row_s / lat_s / p_s reads are done
    for (int s = tid; s < kTS; s += kThreads) {
      const int pos = t0 + s;
      row_s[s] = pos <= hi ? rows(b, pos) : -1;
    }
    __syncthreads();
    for (int i = tid; i < kTS * R; i += kThreads) {
      const int s = i / R, r = i - s * R;
      const long row = row_s[s];
      lat_s[s * Rp + r] = row >= 0 ? to_f(latent[row * R + r]) : 0.f;
    }
    for (int i = tid; i < kTS * Dr; i += kThreads) {
      const int s = i / Dr, d = i - s * Dr;
      const long row = row_s[s];
      rope_s[s * Dp + d] = row >= 0 ? to_f(rope[row * Dr + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < H * kTS; i += kThreads) {
      const int h = i / kTS, s = i - h * kTS;
      float sc = -INFINITY;
      if (row_s[s] >= 0) {
        const float* qr = q_s + h * Qp;
        const float* lr = lat_s + s * Rp;
        const float* rr = rope_s + s * Dp;
        float dot = 0.f;
        for (int r = 0; r < R; ++r) dot += qr[r] * lr[r];
        float dot_r = 0.f;
        for (int d = 0; d < Dr; ++d) dot_r += qr[R + d] * rr[d];
        sc = (dot + dot_r) * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    for (int h = warp; h < H; h += nwarps) {
      float* row = p_s + h * kTS;
      float mx = -INFINITY;
      for (int s = lane; s < kTS; s += 32) mx = fmaxf(mx, row[s]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      // -inf only while no present row has been seen; then every p is 0
      const float m_new = fmaxf(m_old, mx);
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
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
        c_s[h] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < H * R; i += kThreads) {
      const int h = i / R, r = i - h * R;
      const float* pr = p_s + h * kTS;
      float a = acc_s[i] * c_s[h];
      for (int s = 0; s < kTS; ++s) a += pr[s] * lat_s[s * Rp + r];
      acc_s[i] = a;
    }
  }
  __syncthreads();
  const long part = (long)b * splits + split;
  for (int h = tid; h < H; h += kThreads) {
    part_m[part * H + h] = m_s[h];   // -inf for an empty range
    part_l[part * H + h] = l_s[h];
  }
  for (int i = tid; i < H * R; i += kThreads)
    part_acc[part * H * R + i] = acc_s[i];
}

// out[b, h, r] = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M), M the
// largest m_j over the ranges of (b, h); 0 when no range attended a row.
__global__ void mla_merge_kernel(const float* __restrict__ part_m,
                                 const float* __restrict__ part_l,
                                 const float* __restrict__ part_acc,
                                 float* __restrict__ out, long n, int H,
                                 int R, int splits) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long bh = i / R;                       // b * H + h
  const int r = (int)(i - bh * R);
  const long b = bh / H;
  const int h = (int)(bh - b * H);
  float M = -INFINITY;
  for (int j = 0; j < splits; ++j)
    M = fmaxf(M, part_m[(b * splits + j) * H + h]);
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int j = 0; j < splits; ++j) {
      const long pj = b * splits + j;
      const float mj = part_m[pj * H + h];
      if (mj == -INFINITY) continue;
      const float w = expf(mj - M);
      L += part_l[pj * H + h] * w;
      A += part_acc[(pj * H + h) * R + r] * w;
    }
  }
  out[i] = A / fmaxf(L, 1e-30f);
}

// The two launches of one call; returns their count. ``paged`` picks the
// row policy (PagedRows or SlotRows).
int config(int B, int H, int R, int Dr, int splits, int paged, int dtype,
           LaunchRec* r, bool names) {
  const size_t floats = (size_t)H * (R + Dr + 1) + (size_t)kTS * (R + 1) +
                        (size_t)kTS * (Dr + 1) + (size_t)H * kTS +
                        (size_t)H * R + 3 * (size_t)H;
  set_launch(&r[0], names, dim3(B, splits), kThreads, floats * sizeof(float),
             "mla_partial_kernel<%s,%s>", dt_name(dtype),
             paged ? "PagedRows" : "SlotRows");
  const long n = (long)B * H * R;
  set_launch(&r[1], names, dim3((unsigned)((n + 255) / 256)), 256, 0,
             "mla_merge_kernel");
  return 2;
}

template <typename Rows> constexpr int is_paged();
template <> constexpr int is_paged<SlotRows>() { return 0; }
template <> constexpr int is_paged<PagedRows>() { return 1; }

template <typename T, typename Rows>
cudaError_t launch(const void* q_abs, const void* q_rope, const void* latent,
                   const void* rope, const int* cur_pos, float* part_m,
                   float* part_l, float* part_acc, float* out, Rows rows,
                   int B, int H, int R, int Dr, int S, float scale,
                   int splits, cudaStream_t st) {
  LaunchRec r[kMaxLaunches];
  config(B, H, R, Dr, splits, is_paged<Rows>(), dtype_of<T>(), r, false);
  cudaError_t e = allow_smem(mla_partial_kernel<T, Rows>, r[0].smem);
  if (e != cudaSuccess) return e;
  mla_partial_kernel<T, Rows><<<grid_of(r[0]), r[0].threads, r[0].smem, st>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_rope),
      static_cast<const T*>(latent), static_cast<const T*>(rope), cur_pos,
      part_m, part_l, part_acc, rows, H, R, Dr, S, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long n = (long)B * H * R;
  mla_merge_kernel<<<grid_of(r[1]), r[1].threads, 0, st>>>(
      part_m, part_l, part_acc, out, n, H, R, splits);
  return cudaGetLastError();
}

template <typename Rows>
int dispatch(const void* q_abs, const void* q_rope, const void* latent,
             const void* rope, const int* cur_pos, float* part_m,
             float* part_l, float* part_acc, float* out, Rows rows, int B,
             int H, int R, int Dr, int S, float scale, int splits, int dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)launch<float>(q_abs, q_rope, latent, rope, cur_pos, part_m,
                              part_l, part_acc, out, rows, B, H, R, Dr, S,
                              scale, splits, st);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(q_abs, q_rope, latent, rope, cur_pos,
                                      part_m, part_l, part_acc, out, rows, B,
                                      H, R, Dr, S, scale, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_abs [B, H, R], q_rope [B, H, Dr], latent [B, S, R], rope [B, S, Dr],
// cur_pos int32 [B] -> out f32 [B, H, R]; contiguous, the four inputs of
// one dtype. part_m / part_l f32 scratch of B*splits*H, part_acc of
// B*splits*H*R.
extern "C" int repro_mla_decode_attn(
    const void* q_abs, const void* q_rope, const void* latent,
    const void* rope, const int* cur_pos, float* part_m, float* part_l,
    float* part_acc, float* out, int B, int H, int R, int Dr, int S,
    float scale, int splits, int dtype, void* stream) {
  if (B < 1 || H < 1 || R < 1 || Dr < 1 || S < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch(q_abs, q_rope, latent, rope, cur_pos, part_m, part_l,
                  part_acc, out, SlotRows{S}, B, H, R, Dr, S, scale, splits,
                  dtype, stream);
}

// As repro_mla_decode_attn over the pools latent [num_pages, ps, R] /
// rope [num_pages, ps, Dr] through pages int32 [B, pps] (-1 = unallocated).
extern "C" int repro_mla_paged_decode_attn(
    const void* q_abs, const void* q_rope, const void* latent_pool,
    const void* rope_pool, const int* pages, const int* cur_pos,
    float* part_m, float* part_l, float* part_acc, float* out, int B, int H,
    int R, int Dr, int num_pages, int ps, int pps, float scale, int splits,
    int dtype, void* stream) {
  if (B < 1 || H < 1 || R < 1 || Dr < 1 || num_pages < 1 || ps < 1 ||
      pps < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch(q_abs, q_rope, latent_pool, rope_pool, cur_pos, part_m,
                  part_l, part_acc, out, PagedRows{pages, ps, pps, num_pages},
                  B, H, R, Dr, ps * pps, scale, splits, dtype, stream);
}

extern "C" int repro_mla_decode_attn_launch_config(int B, int H, int R,
                                                   int Dr, int splits,
                                                   int paged, int dtype,
                                                   LaunchRec* r) {
  return config(B, H, R, Dr, splits, paged, dtype, r, true);
}
