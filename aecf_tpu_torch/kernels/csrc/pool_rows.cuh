// The row kernels of the port's shared-query chains for Hopper (sm_90a),
// one copy for the three chains that include this header: train_step.cu
// (the one-pass step), shared_query_fwd.cu (the forward) and
// shared_query_bwd.cu (its H == 1 backward).  Between them the chains run
// their E x E products over the whole batch in gemm_f32.cuh.
//
//   R1  rows_fwd_kernel, a warp a row: scores against the shared u_h, c_h,
//       softmax over M (row_softmax up to kMaxH heads — the call every
//       kernel of the port makes there, so the forward, the step and the
//       streamed kernels draw the same mask for the same seed words bit for
//       bit; row_softmax_heads[4] above), head mean, entropy, the side
//       outputs (eval passthrough or the training mask chain), the softmax
//       weights a (H == 1) and MIX[b, h, :] = sum_m a_h[m] kv[b, m] with
//       the unmasked a_h (quirk Q1).
//   R2  rows_bwd_kernel, a warp a row: d_a[m] = d_mix . kv[m] (+ d_w[m]),
//       d_s = a (d_a - sum_m a d_a), optional d_kv = a d_mix + d_s u in
//       kv's type; then one row of partial sums a block of kWarps rows:
//       du | sum d_out | sum d_s, and with kLoss (the step) | loss | db_head.
//   part_sum  the partial rows summed in a fixed order.
//   pad_rows  a matrix copied to rows of a multiple of four floats, for the
//       GEMM's 16-byte chunks at widths E % 4 != 0.
//
// Widths: any E.  The chains' workspace rows (mix, d_mix, d_out) are `ld`
// floats apart, a multiple of 4.  Lane l takes the features 4 l + 128 i +
// {0..3} of a row: with `vec` (E % 4 == 0 and kv, u and d_kv aligned to
// those four-feature accesses; the caller decides) in one 16-byte (f32),
// 8-byte (bf16) or 4-byte (int8) access, else one feature at a time, zero
// past E — the same fmafs in the same order, so where both apply the two
// agree bit for bit.  Rows past B write nothing and add nothing to any sum.
// No atomics: a run is bit for bit repeatable.

#pragma once

#include "pool_common.cuh"

namespace aecf {

// Blocks of a row kernel: kWarps rows each.
inline int warp_blocks(int B) { return (B + kWarps - 1) / kWarps; }

// Features j .. j + 3 of row m (j < E, j % 4 == 0).
template <typename T>
__device__ __forceinline__ float4 kv_quad(const KvRow<T>& r, int m, int j,
                                          bool vec) {
  if (vec) return r.at4(m, j);
  const int E = r.E;
  return make_float4(r.at(m, j), j + 1 < E ? r.at(m, j + 1) : 0.f,
                     j + 2 < E ? r.at(m, j + 2) : 0.f,
                     j + 3 < E ? r.at(m, j + 3) : 0.f);
}
// p[j .. j + 3] of a row of n floats (j < n).
__device__ __forceinline__ float4 quad(const float* p, int j, int n,
                                       bool vec) {
  if (vec) return load4(p + j);
  return make_float4(p[j], j + 1 < n ? p[j + 1] : 0.f,
                     j + 2 < n ? p[j + 2] : 0.f, j + 3 < n ? p[j + 3] : 0.f);
}
// p[j .. j + 3] = v, stopping at n (j < n).
template <typename T>
__device__ __forceinline__ void store_quad(T* p, int j, int n, float4 v,
                                           bool vec) {
  if (vec) {
    store4(p + j, v);
    return;
  }
  p[j] = from_f32<T>(v.x);
  if (j + 1 < n) p[j + 1] = from_f32<T>(v.y);
  if (j + 2 < n) p[j + 2] = from_f32<T>(v.z);
  if (j + 3 < n) p[j + 3] = from_f32<T>(v.w);
}

// ---- R1 ---------------------------------------------------------------------

struct FwdRows {
  const void* kv;       // (B, M, E) f32, bf16 or int8
  const float* scales;  // (B, M), int8 only
  const float* u;       // (H, E)
  const float* c;       // (H,)
  const float* pad;     // (B, M) additive score bias, or null
  float* w;             // (B, M) side outputs w, mw, ent, rate; w null:
  float* mw;            //   none (the backward's recompute)
  float* ent;           // (B,)
  float* rate;          // (B,)
  float* a;             // H <= kMaxH: (B, M) head 0's softmax weights, or
                        // null; H > kMaxH: (B, H, M), required
  float* mix;           // (B, H, ld): row b, head h at (b H + h) ld
  int B, M, E, H, ld, vec;  // H: read by the kHeads = 0 instance only
};

// dst[e] = sum_m a[m] kv[m, e] for e < align4(E) (zero past E).
template <typename T>
__device__ __forceinline__ void row_mix(const KvRow<T>& kvr,
                                        const float a[kMaxM], int M, int E,
                                        bool vec, float* dst) {
  const int lane = threadIdx.x & 31;
  for (int j = 4 * lane; j < E; j += 128) {
    float4 acc = kv_quad(kvr, 0, j, vec);
    acc = make_float4(a[0] * acc.x, a[0] * acc.y, a[0] * acc.z, a[0] * acc.w);
#pragma unroll
    for (int m = 1; m < kMaxM; ++m)
      if (m < M) acc = axpy4(a[m], kv_quad(kvr, m, j, vec), acc);
    store4(dst + j, acc);
  }
}

// kHeads: the call's H when it is 1 or 2 (kMaxH), 0 for any H above, the
// scores then in passes.  A compile-time head count keeps a second head's
// registers and FMAs out of the H = 1 instances (the step's, the
// backward's): with H at run time the int8 instance took 80 registers and
// 0.030 ms at the north star, with H = 1 fixed 62 and 0.020 (H100 SXM,
// 700 W).
template <typename T, bool kTraining, int kHeads>
AECF_ROW_KERNEL(3) rows_fwd_kernel(FwdRows p, MaskParams mp) {
  static_assert(kHeads >= 0 && kHeads <= kMaxH, "kHeads: 1, 2 or 0");
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;  // warp-uniform; no block barrier below
  const int M = p.M;
  const int E = p.E;
  const int H = kHeads > 0 ? kHeads : p.H;
  const bool vec = p.vec != 0;
  const KvRow<T> kvr(static_cast<const T*>(p.kv), p.scales, b, M, E);
  const float* pad_row = p.pad != nullptr ? p.pad + (size_t)b * M : nullptr;
  float* mix = p.mix + (size_t)b * H * p.ld;
  float w[kMaxM];
  if constexpr (kHeads > 0) {
    float a[kMaxH][kMaxM];
    row_softmax(kvr, p.u, p.c, pad_row, M, E, kHeads, a, w);
    if (p.a != nullptr && lane == 0) {
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
        if (m < M) p.a[(size_t)b * M + m] = a[0][m];
    }
    if (p.w != nullptr)
      row_side_outputs<kTraining>(w, b, M, mp, p.w, p.mw, p.ent, p.rate);
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      row_mix(kvr, a[h], M, E, vec, mix + (size_t)h * p.ld);
  } else {
    float* a_row = p.a + (size_t)b * H * M;
    if (vec)
      row_softmax_heads4(kvr, p.u, p.c, pad_row, M, E, H, a_row, w);
    else
      row_softmax_heads(kvr, p.u, p.c, pad_row, M, E, H, a_row, w);
    if (p.w != nullptr)
      row_side_outputs<kTraining>(w, b, M, mp, p.w, p.mw, p.ent, p.rate);
    for (int h = 0; h < H; ++h) {
      float a[kMaxM];
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) a[m] = m < M ? a_row[h * M + m] : 0.f;
      row_mix(kvr, a, M, E, vec, mix + (size_t)h * p.ld);
    }
  }
}

// ---- R2 ---------------------------------------------------------------------

struct BwdRows {
  const void* kv;        // (B, M, E) f32, bf16 or int8
  const float* scales;   // (B, M), int8 only
  const float* u;        // (E,)
  const float* a;        // (B, M): R1's softmax weights
  const float* dmix;     // (B, ld)
  const float* dout;     // (B, ld)
  const float* dw;       // (B, M) weights cotangent, or null (!kLoss)
  void* dkv;             // (B, M, E) in kv's type, or null (int8: null)
  float* part;           // warp_blocks(B) x part_cols(E, C, kLoss)
  int B, M, E, ld, vec;
  // kLoss (the step): the quadratic loss's sq (B, sq_ld) of sum out^2 per
  // (row, column tile) when C == 0; the head's row loss lrow (B,) and
  // d_logits (B, ldl) when C > 0
  const float* sq;
  const float* lrow;
  const float* dlogits;
  int sq_ld, ldl, C;
  float inv;
};

__host__ __device__ inline int part_cols(int E, int C, bool loss) {
  return 2 * E + 1 + (loss ? 1 + C : 0);
}

// The block's partial row: du | sum d_out | sum d_s (| loss | db_head),
// each column summed over the block's rows in order.
template <typename T, bool kLoss>
__global__ void __launch_bounds__(kThreads) rows_bwd_kernel(BwdRows p) {
  __shared__ float ds_s[kWarps * kMaxM];
  const int E = p.E;
  const int M = p.M;
  const int B = p.B;
  const int C = kLoss ? p.C : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  const int rows_valid = min(kWarps, B - row0);
  const bool vec = p.vec != 0;
  const T* kv = static_cast<const T*>(p.kv);
  const int b = row0 + warp;
  if (b < B) {
    // d_a[m] = d_mix . kv[m] (+ d_w[m]);  d_s = a (d_a - sum_m a d_a)
    const KvRow<T> kvr(kv, p.scales, b, M, E);
    const float* dmix = p.dmix + (size_t)b * p.ld;
    float da[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) da[m] = 0.f;
    for (int j = 4 * lane; j < E; j += 128) {
      const float4 dm = quad(dmix, j, E, vec);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
        if (m < M) da[m] = dot4(dm, kv_quad(kvr, m, j, vec), da[m]);
    }
    float a[kMaxM];
    float dot = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      a[m] = 0.f;
      if (m < M) {
        da[m] = warp_sum(da[m]);
        if (!kLoss && p.dw != nullptr) da[m] += p.dw[(size_t)b * M + m];
        a[m] = p.a[(size_t)b * M + m];
        dot += a[m] * da[m];
      }
    }
    float ds[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      ds[m] = m < M ? a[m] * (da[m] - dot) : 0.f;
      if (lane == 0) ds_s[warp * kMaxM + m] = ds[m];
    }
    if constexpr (!kQuantized<T>) {
      if (p.dkv != nullptr) {  // d_kv[m] = a[m] d_mix + d_s[m] u
        T* dkv = static_cast<T*>(p.dkv) + (size_t)b * M * E;
        for (int j = 4 * lane; j < E; j += 128) {
          const float4 dm = quad(dmix, j, E, vec);
          const float4 ue = quad(p.u, j, E, vec);
#pragma unroll
          for (int m = 0; m < kMaxM; ++m)
            if (m < M)
              store_quad(dkv + (size_t)m * E, j, E,
                         make_float4(a[m] * dm.x + ds[m] * ue.x,
                                     a[m] * dm.y + ds[m] * ue.y,
                                     a[m] * dm.z + ds[m] * ue.z,
                                     a[m] * dm.w + ds[m] * ue.w),
                         vec);
        }
      }
    }
  }
  __syncthreads();
  float* part = p.part + (size_t)blockIdx.x * part_cols(E, C, kLoss);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float du = 0.f;
    float dsum = 0.f;
#pragma unroll 4
    for (int r = 0; r < rows_valid; ++r) {
      const KvRow<T> kvr(kv, p.scales, row0 + r, M, E);
      for (int m = 0; m < M; ++m)
        du = fmaf(ds_s[r * kMaxM + m], kvr.at(m, e), du);
      dsum += p.dout[(size_t)(row0 + r) * p.ld + e];
    }
    part[e] = du;
    part[E + e] = dsum;
  }
  if (threadIdx.x == 0) {
    float sd = 0.f;
    for (int r = 0; r < rows_valid; ++r)
      for (int m = 0; m < M; ++m) sd += ds_s[r * kMaxM + m];
    part[2 * E] = sd;
    if constexpr (kLoss) {
      float s = 0.f;
      if (C == 0) {
        for (int r = 0; r < rows_valid; ++r) {
          const float* sq = p.sq + (size_t)(row0 + r) * p.sq_ld;
          float o2 = 0.f;
          for (int t = 0; t < p.sq_ld; ++t) o2 += sq[t];
          s += o2 * p.inv;
        }
      } else {
        for (int r = 0; r < rows_valid; ++r) s += p.lrow[row0 + r];
      }
      part[2 * E + 1] = s;
    }
  }
  if constexpr (kLoss) {
    for (int j = threadIdx.x; j < C; j += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows_valid; ++r)
        s += p.dlogits[(size_t)(row0 + r) * p.ldl + j];
      part[2 * E + 2 + j] = s;
    }
  }
}

// ---- part_sum, pad_rows -----------------------------------------------------

// out[j] = sum_r part[r cols + j]: in a block, 16 row groups each sum rows
// g, g + 16, ... in order, then the 16 group sums add in group order.
constexpr int kSumCols = 16;
constexpr int kSumGroups = kThreads / kSumCols;

__global__ void __launch_bounds__(kThreads)
    part_sum_kernel(const float* __restrict__ part, int rows, int cols,
                    float* __restrict__ out) {
  __shared__ float s[kSumGroups][kSumCols];
  const int tx = threadIdx.x % kSumCols;
  const int g = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + tx;
  float acc = 0.f;
  if (j < cols)
    for (int r = g; r < rows; r += kSumGroups)
      acc += part[(size_t)r * cols + j];
  s[g][tx] = acc;
  __syncthreads();
  if (g == 0 && j < cols) {
    float t = s[0][tx];
    for (int k = 1; k < kSumGroups; ++k) t += s[k][tx];
    out[j] = t;
  }
}

inline cudaError_t part_sum(const float* part, int rows, int cols,
                            float* out, cudaStream_t stream) {
  part_sum_kernel<<<(cols + kSumCols - 1) / kSumCols, kThreads, 0, stream>>>(
      part, rows, cols, out);
  return cudaGetLastError();
}

// dst[r ld + j] = j < n ? src[r n + j] : 0 for r < rows, j < ld.
__global__ void pad_rows_kernel(const float* __restrict__ src, int rows,
                                int n, int ld, float* __restrict__ dst) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * ld) return;
  const int j = (int)(i % ld);
  dst[i] = j < n ? src[(i / ld) * n + j] : 0.f;
}

inline cudaError_t pad_rows(const float* src, int rows, int n, int ld,
                            float* dst, cudaStream_t stream) {
  const size_t total = (size_t)rows * ld;
  pad_rows_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      src, rows, n, ld, dst);
  return cudaGetLastError();
}

}  // namespace aecf
