// Device code shared by the port's shared-query kernels for Hopper (sm_90a):
// shared_query_fwd.cu, shared_query_bwd.cu, train_step.cu, fused_pool_fwd.cu,
// stream_mix.cu and stream_bwd.cu include it.  The build hashes this header
// with each source (kernels/_build.py), so an edit here rebuilds them all.
//
// What lives here:
//   * the per-row chain every shared-query kernel runs first — scores
//     kv . u_h + c_h + pad, softmax over M, head mean, entropy — and the
//     training mask chain (Philox draw -> min_active -> renorm), i.e. the
//     bodies of aecf_tpu/kernels/shared_query.py::_weights_entropy_mask
//     and ::_mask_and_renorm;
//   * the per-row softmax backward (::_tile_softmax_bwd) and the
//     per-block partial sums of du / sum(d_out) / sum(d_s);
//   * SIMT f32 GEMM helpers for a block's kRows rows, with the weights
//     streamed from L2 through a staging tile (gemm_rows for narrow or
//     column-split products, gemm_rows_wide, register-blocked, for the
//     row kernels' full-width E x E products);
//   * the cross-block reductions.  The TPU kernels add G = d_out^T mix
//     (E x E) and the small accumulators into one VMEM block across a
//     sequential grid; blocks on the GPU run in parallel and in no order.
//     Here the row kernels write mix / d_out (B x E each) and one row of
//     small partials per block to a workspace, and second kernels reduce
//     them in a fixed order: gemm_tn (one block per 64 x 64 output tile,
//     optionally split over the batch with a fixed-order sum of the
//     splits) and colsum.  No atomics: a run is bit for bit repeatable.
//
// Random bits: Philox4x32-10 (Salmon et al., Random123), keyed by the two
// 32-bit seed words of the call; the counter of batch row b and modality m
// is (b, m / 4, 0, 0) and the draw is word m % 4.  Draws therefore do not
// depend on the tile size, and the forward kernel and the train step draw
// the same mask for the same seed.  The uniform is the TPU kernel's 24-bit
// construction (bits >> 8) * 2^-24.
//
// Features: f32, bf16 or int8, always read through KvRow (the port of
// _kv_tile_slices): f32 and bf16 are cast, int8 is dequantized per element
// as float(q) * scale[row, m], so every kernel sees the f32 values that
// q.float() * scales gives in torch.
//
// Numerics: f32 throughout; entropy floors w at the subnormal 1e-38, so
// every source that includes this header is built without fast-math and
// without flush-to-zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace aecf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;   // batch rows per block of a row kernel
constexpr int kCols = 64;   // output columns per GEMM tile
constexpr int kChunk = 32;  // k-depth of one staged weight tile
constexpr int kWtStride = kCols + 1;  // pad: conflict-free transposed store
constexpr int kMaxM = 8;
constexpr int kMaxH = 2;
constexpr int kTn = 64;     // output tile of gemm_tn
constexpr int kWideCols = 256;  // output columns per pass of gemm_rows_wide
constexpr int kWideChunk = 16;  // k-depth of its staged weight tile
constexpr int kSms = 132;   // H100 SXM
constexpr float kEps = 1e-8f;  // aecf_tpu/core/masking.py EPS

static_assert(kRows == 2 * kWarps, "each warp owns two GEMM rows");
static_assert(kCols == 64, "each lane owns two GEMM columns");
static_assert(kThreads == 256 && kTn == 64, "gemm_tn: 16 x 16 threads, 4 x 4 each");
static_assert(kThreads * 16 == kRows * kWideCols, "gemm_rows_wide: 4 x 4 each");
static_assert(kWideChunk % 4 == 0, "gemm_rows_wide reads A as float4 over k");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA
}

// Four consecutive features as one 16-byte (f32) or 8-byte (bf16) access;
// p must be aligned to that size.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// The feature storage codes of the C interfaces (kv_dtype).
enum KvDtype : int { kKvF32 = 0, kKvBf16 = 1, kKvInt8 = 2 };

// int8 features are frozen (quantization is not differentiable): no
// kernel writes a d_kv for them.
template <typename T>
constexpr bool kQuantized = false;
template <>
constexpr bool kQuantized<int8_t> = true;

// One batch row of kv (M x E elements, contiguous) read as f32: at(m, e)
// one feature, at4(m, j) the four features j .. j + 3 in one access of
// 16 (f32), 8 (bf16) or 4 (int8) bytes, aligned to that size.  The f32
// and bf16 forms are the plain loads; the int8 form holds the row's M
// scales (B, M) in registers, loaded once, and returns float(q) * scale[m]
// rounded on its own (__fmul_rn: never contracted into a later FMA), so
// its values equal the f32 kernel's on q.float() * scales bit for bit.
// `scales` is read only for int8.
template <typename T>
struct KvRow {
  const T* p;
  int E;
  __device__ __forceinline__ KvRow(const T* kv, const float* /*scales*/,
                                   int row, int M, int E_)
      : p(kv + (size_t)row * M * E_), E(E_) {}
  __device__ __forceinline__ float at(int m, int e) const {
    return to_f32(p[(size_t)m * E + e]);
  }
  __device__ __forceinline__ float4 at4(int m, int j) const {
    return load4(p + (size_t)m * E + j);
  }
};

template <>
struct KvRow<int8_t> {
  const int8_t* p;
  int E;
  float s[kMaxM];
  __device__ __forceinline__ KvRow(const int8_t* kv, const float* scales,
                                   int row, int M, int E_)
      : p(kv + (size_t)row * M * E_), E(E_) {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      s[m] = m < M ? scales[(size_t)row * M + m] : 0.f;
  }
  __device__ __forceinline__ float at(int m, int e) const {
    return __fmul_rn((float)p[(size_t)m * E + e], s[m]);
  }
  __device__ __forceinline__ float4 at4(int m, int j) const {
    const char4 q = *reinterpret_cast<const char4*>(p + (size_t)m * E + j);
    return make_float4(__fmul_rn((float)q.x, s[m]), __fmul_rn((float)q.y, s[m]),
                       __fmul_rn((float)q.z, s[m]), __fmul_rn((float)q.w, s[m]));
  }
};

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);  // round to nearest even
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}
// acc + x . y, summed x, y, z, w in that order
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}
// acc + s x, per component
__device__ __forceinline__ float4 axpy4(float s, float4 x, float4 acc) {
  return make_float4(fmaf(s, x.x, acc.x), fmaf(s, x.y, acc.y),
                     fmaf(s, x.z, acc.z), fmaf(s, x.w, acc.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- Philox4x32-10 --------------------------------------------------------

struct Philox4 {
  uint32_t v[4];
};

__host__ __device__ __forceinline__ uint32_t mulhi32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

__host__ __device__ __forceinline__ Philox4 philox4x32_10(
    uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3, uint32_t k0,
    uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = mulhi32(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = mulhi32(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Philox4 out;
  out.v[0] = c0;
  out.v[1] = c1;
  out.v[2] = c2;
  out.v[3] = c3;
  return out;
}

// One Philox call per (counter, key) row of `in` (n x 6 words: c0..c3,
// k0, k1) into `out` (n x 4): the known-answer check of the device copy.
__global__ void philox_kernel(const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* p = in + 6 * (size_t)i;
  const Philox4 r = philox4x32_10(p[0], p[1], p[2], p[3], p[4], p[5]);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[4 * (size_t)i + j] = r.v[j];
}

// The M uniforms of batch row `row`: (bits >> 8) * 2^-24, exact in f32.
__device__ __forceinline__ void row_uniforms(uint32_t k0, uint32_t k1,
                                             int row, int M,
                                             float uni[kMaxM]) {
#pragma unroll
  for (int g = 0; g < kMaxM / 4; ++g) {
    if (4 * g < M) {
      const Philox4 r = philox4x32_10((uint32_t)row, (uint32_t)g, 0u, 0u,
                                      k0, k1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        uni[4 * g + j] = (float)(r.v[j] >> 8) * (1.0f / 16777216.0f);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) uni[4 * g + j] = 1.f;
    }
  }
}

// ---- the per-row forward chain ---------------------------------------------

struct MaskParams {
  float max_entropy;  // ln M (0 for M == 1)
  float mask_prob;
  int min_active;
  int training;
  uint32_t seed0, seed1;
};

// One warp per row: per-head softmax weights a[h][m] (every lane holds
// them) and the head mean w[m].  s_h[m] = (kv[m] . u_h + c_h) + pad[m].
template <typename T>
__device__ __forceinline__ void row_softmax(const KvRow<T>& kvr,
                                            const float* __restrict__ u,
                                            const float* __restrict__ c,
                                            const float* pad_row, int M,
                                            int E, int H,
                                            float a[kMaxH][kMaxM],
                                            float w[kMaxM]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < kMaxH; ++h)
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) a[h][m] = 0.f;
  for (int e = lane; e < E; e += 32) {
    float uh[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) uh[h] = h < H ? u[h * E + e] : 0.f;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        const float x = kvr.at(m, e);
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) a[h][m] = fmaf(x, uh[h], a[h][m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) w[m] = 0.f;
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
    if (h >= H) break;
    float smax = -INFINITY;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        const float bias = pad_row != nullptr ? pad_row[m] : 0.f;
        a[h][m] = (warp_sum(a[h][m]) + c[h]) + bias;
        smax = fmaxf(smax, a[h][m]);
      }
    }
    float denom = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        a[h][m] = expf(a[h][m] - smax);
        denom += a[h][m];
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        a[h][m] = a[h][m] / denom;
        w[m] += a[h][m];
      }
    }
  }
  const float inv_h = 1.0f / (float)H;
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) w[m] *= inv_h;
}

// Any H (H > kMaxH included): row_softmax over the heads in passes of at
// most kMaxH, so the register arrays stay a[kMaxH][kMaxM] — a[8][8] would
// spill under the row kernels' 64-register bound.  Each pass re-reads the
// warp's kv row (from L1) and lane 0 writes its heads' weights to a_row
// (H x M, shared memory); the head mean then sums a_row in head order,
// w = (sum_h a_h) * (1/H), the order row_softmax and the plain version use.
template <typename T>
__device__ __forceinline__ void row_softmax_heads(
    const KvRow<T>& kvr, const float* __restrict__ u,
    const float* __restrict__ c, const float* pad_row, int M, int E, int H,
    float* a_row, float w[kMaxM]) {
  const int lane = threadIdx.x & 31;
  for (int h0 = 0; h0 < H; h0 += kMaxH) {
    const int nh = min(kMaxH, H - h0);
    float a[kMaxH][kMaxM];
    row_softmax(kvr, u + (size_t)h0 * E, c + h0, pad_row, M, E, nh, a, w);
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
          if (h < nh && m < M) a_row[(h0 + h) * M + m] = a[h][m];
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    float s = 0.f;
    if (m < M)
      for (int h = 0; h < H; ++h) s += a_row[h * M + m];
    w[m] = s;
  }
  const float inv_h = 1.0f / (float)H;
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) w[m] *= inv_h;
}

// Entropy clip(-sum w log(max(w, 1e-38)) [w > 0], 0, ln M), then (when
// kTraining and mp.training) the training mask chain, writing the four
// side outputs of row gr (lane 0).  kTraining = false compiles the eval
// passthrough alone: the eval forward kernel without the chain measured
// 0.0411 / 0.0421 ms against 0.0436 / 0.0455 ms with it (B = 32 / 256,
// M = 2, E = 512, H100).
//   keep = clip(1 - p clip(ent / ln M, 0, 1), 0, 1)
//   mask = uniform < keep; a row with fewer than min(min_active, M) kept
//   slots is replaced whole by its top-min_active indicator (first
//   occurrence wins ties); mw = w mask / sum(w mask), or w when that sum
//   is <= 1e-8; rate = 1 - mean(mask).
template <bool kTraining>
__device__ __forceinline__ void row_side_outputs(
    const float w[kMaxM], int gr, int M, const MaskParams& mp,
    float* __restrict__ w_out, float* __restrict__ mw_out,
    float* __restrict__ ent_out, float* __restrict__ rate_out) {
  float plogp = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
    if (m < M) plogp += w[m] > 0.f ? w[m] * logf(fmaxf(w[m], 1e-38f)) : 0.f;
  const float ent = fminf(fmaxf(-plogp, 0.f), mp.max_entropy);

  float mw[kMaxM];
  float rate = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) mw[m] = w[m];
  if (kTraining && mp.training && M > 1) {
    const float norm = fminf(fmaxf(ent / mp.max_entropy, 0.f), 1.f);
    // __fmul_rn: no contraction into an FMA, as the plain version rounds
    const float keep = fminf(fmaxf(1.f - __fmul_rn(mp.mask_prob, norm), 0.f),
                             1.f);
    float uni[kMaxM];
    row_uniforms(mp.seed0, mp.seed1, gr, M, uni);
    float mask[kMaxM];
    float kept = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      mask[m] = (m < M && uni[m] < keep) ? 1.f : 0.f;
      kept += mask[m];
    }
    const int eff = min(mp.min_active, M);
    if (kept < (float)eff) {
      float work[kMaxM];
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        work[m] = m < M ? w[m] : -INFINITY;
        mask[m] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kMaxM; ++k) {
        if (k >= eff) break;
        float mx = -INFINITY;
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
          if (m < M) mx = fmaxf(mx, work[m]);
        int first = M;
#pragma unroll
        for (int m = kMaxM - 1; m >= 0; --m)
          if (m < M && work[m] == mx) first = m;
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m == first) {
            mask[m] = 1.f;
            work[m] = -INFINITY;
          }
        }
      }
    }
    float msum = 0.f;
    kept = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        msum += w[m] * mask[m];
        kept += mask[m];
      }
    }
    const bool valid = msum > kEps;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < M) mw[m] = valid ? (w[m] * mask[m]) / msum : w[m];
    rate = 1.f - kept / (float)M;
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        w_out[(size_t)gr * M + m] = w[m];
        mw_out[(size_t)gr * M + m] = mw[m];
      }
    }
    ent_out[gr] = ent;
    rate_out[gr] = rate;
  }
}

// ---- block-level pieces ----------------------------------------------------

// dst[r * ldd + n] = sum_k A[r * lda + k] * W(n, k) + (bias ? bias[n] : 0)
// for the block's kRows rows (rows >= rows_valid are not written) and the
// columns n in [n0, n1).  W(n, k) = W[n * ldw + k], or W[k * ldw + n] when
// kKMajor.  A is in shared memory; W and bias in global memory; wt is the
// block's staging tile (kChunk x kWtStride floats).  dst must not alias A.
template <bool kKMajor>
__device__ void gemm_rows(const float* A, int lda, int K,
                          const float* __restrict__ W, int ldw,
                          const float* __restrict__ bias, int n0, int n1,
                          float* wt, float* dst, int ldd, int rows_valid) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int nt = n0; nt < n1; nt += kCols) {
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      // Stage W(nt:nt+kCols, k0:k0+kChunk) as wt[k][n]; consecutive
      // threads read consecutive addresses of W in either layout.
      for (int i = tid; i < kCols * kChunk; i += kThreads) {
        int kk, nn;
        if (kKMajor) {
          nn = i % kCols;
          kk = i / kCols;
        } else {
          kk = i % kChunk;
          nn = i / kChunk;
        }
        const int n = nt + nn;
        float v = 0.f;
        if (n < n1 && kk < kc)
          v = kKMajor ? W[(size_t)(k0 + kk) * ldw + n]
                      : W[(size_t)n * ldw + k0 + kk];
        wt[kk * kWtStride + nn] = v;
      }
      __syncthreads();
      const float* a0p = A + warp * lda + k0;
      const float* a1p = A + (warp + kWarps) * lda + k0;
      for (int kk = 0; kk < kc; ++kk) {
        const float a0 = a0p[kk];
        const float a1 = a1p[kk];
        const float w0 = wt[kk * kWtStride + lane];
        const float w1 = wt[kk * kWtStride + lane + 32];
        acc[0][0] = fmaf(a0, w0, acc[0][0]);
        acc[0][1] = fmaf(a0, w1, acc[0][1]);
        acc[1][0] = fmaf(a1, w0, acc[1][0]);
        acc[1][1] = fmaf(a1, w1, acc[1][1]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp + i * kWarps;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = nt + lane + 32 * j;
        if (r < rows_valid && n < n1)
          dst[r * ldd + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
      }
    }
  }
}

// dst[r * ldd + n] = sum_k A[r * lda + k] * W[k * ldw + n]
// (+ bias[n] when given) for the block's kRows rows (rows >= rows_valid
// are not written) and every n in [0, N).  The full-width form of
// gemm_rows for the row kernels' E x E products: each thread holds a 4 x 4
// tile of a 16 x 256 pass, reads its four A rows as float4 over k
// (broadcast: a warp shares its rows) and its four columns as float4 from
// the staged W tile — 64 FMAs for 8 shared-memory reads, where gemm_rows
// does one FMA a read.  A is in shared memory with lda and K multiples of
// 4; wt (16-byte aligned) holds kWideChunk x kWideCols floats; dst must
// not alias A.
__device__ void gemm_rows_wide(const float* A, int lda, int K,
                               const float* __restrict__ W, int ldw,
                               const float* __restrict__ bias, int N,
                               float* wt, float* dst, int ldd,
                               int rows_valid) {
  const int tid = threadIdx.x;
  const int tr = tid / (kWideCols / 4);  // rows 4 tr .. 4 tr + 3
  const int tc = tid % (kWideCols / 4);  // columns 4 tc .. 4 tc + 3
  for (int nt = 0; nt < N; nt += kWideCols) {
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kWideChunk) {
      const int kc = min(kWideChunk, K - k0);
      for (int i = tid; i < kWideChunk * kWideCols; i += kThreads) {
        const int nn = i % kWideCols;
        const int kk = i / kWideCols;
        const int n = nt + nn;
        wt[i] = (n < N && kk < kc) ? W[(size_t)(k0 + kk) * ldw + n] : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 4) {
        float a[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float4 v =
              *reinterpret_cast<const float4*>(A + (4 * tr + p) * lda + k0 + kk);
          a[p][0] = v.x;
          a[p][1] = v.y;
          a[p][2] = v.z;
          a[p][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w =
              *reinterpret_cast<const float4*>(wt + (kk + j) * kWideCols + 4 * tc);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[p][0] = fmaf(a[p][j], w.x, acc[p][0]);
            acc[p][1] = fmaf(a[p][j], w.y, acc[p][1]);
            acc[p][2] = fmaf(a[p][j], w.z, acc[p][2]);
            acc[p][3] = fmaf(a[p][j], w.w, acc[p][3]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = 4 * tr + p;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = nt + 4 * tc + q;
        if (r < rows_valid && n < N)
          dst[r * ldd + n] = acc[p][q] + (bias != nullptr ? bias[n] : 0.f);
      }
    }
  }
}

// Floats of a row kernel's staging tile: the larger of gemm_rows' and
// gemm_rows_wide's.
constexpr int kStageFloats =
    kWideChunk * kWideCols > kChunk * kWtStride ? kWideChunk * kWideCols
                                                : kChunk * kWtStride;

// Rounds a shared-memory offset in floats up to 16 bytes.
__host__ __device__ inline int align4(int floats) { return (floats + 3) & ~3; }

// mix[r, e] = sum_m a[r, h, m] kv[row0 + r, m, e]; zero for rows past B.
// a_s is (kRows, H, M); scales (B, M) is read for int8 kv only.  mix_out
// (B, E) in global memory, when given, receives the block's valid rows
// too.  Not inlined: inlined, it pushed the eval forward kernel into
// register spills (measured on the H100 at 64 registers: 0.053 vs 0.045
// ms at B = 32).
template <typename T>
__device__ __noinline__ void build_mix(const T* __restrict__ kv,
                          const float* __restrict__ scales, const float* a_s,
                          float* mix, float* __restrict__ mix_out, int row0,
                          int B, int M, int E, int H, int h) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= B) {
      for (int e = lane; e < E; e += 32) mix[r * E + e] = 0.f;
      continue;
    }
    float a[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      a[m] = m < M ? a_s[(r * H + h) * M + m] : 0.f;
    const KvRow<T> kvr(kv, scales, gr, M, E);
    for (int e = lane; e < E; e += 32) {
      float acc = a[0] * kvr.at(0, e);
#pragma unroll
      for (int m = 1; m < kMaxM; ++m)
        if (m < M) acc = acc + a[m] * kvr.at(m, e);
      mix[r * E + e] = acc;
      if (mix_out != nullptr) mix_out[(size_t)gr * E + e] = acc;
    }
  }
}

// Softmax backward of the block's rows (H == 1), one warp per row, from
// d_mix (kRows x E, shared) and an optional weights cotangent d_w (B, M):
//   d_a[m] = d_mix . kv[m] + d_w[m];  d_s = a (d_a - sum_m a d_a)
// into ds_s (kRows x kMaxM, zero for rows past B), and, when dkv is
// given, d_kv[m] = a[m] d_mix + d_s[m] u in the feature dtype (never for
// int8: dkv must be null).
template <typename T>
__device__ void softmax_bwd_rows(const T* __restrict__ kv,
                                 const float* __restrict__ scales,
                                 const float* __restrict__ u,
                                 const float* dmix, const float* a_s,
                                 const float* __restrict__ dw, float* ds_s,
                                 T* __restrict__ dkv, int row0, int B, int M,
                                 int E) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= B) {
      if (lane == 0)
        for (int m = 0; m < kMaxM; ++m) ds_s[r * kMaxM + m] = 0.f;
      continue;
    }
    const KvRow<T> kvr(kv, scales, gr, M, E);
    float da[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) da[m] = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float dm = dmix[r * E + e];
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
        if (m < M) da[m] = fmaf(dm, kvr.at(m, e), da[m]);
    }
    float a[kMaxM];
    float dot = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      a[m] = 0.f;
      if (m < M) {
        da[m] = warp_sum(da[m]) + (dw != nullptr ? dw[(size_t)gr * M + m] : 0.f);
        a[m] = a_s[r * M + m];
        dot += a[m] * da[m];
      }
    }
    float ds[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      ds[m] = m < M ? a[m] * (da[m] - dot) : 0.f;
      if (lane == 0) ds_s[r * kMaxM + m] = ds[m];
    }
    if constexpr (!kQuantized<T>) {
      if (dkv != nullptr) {
        T* dkvr = dkv + (size_t)gr * M * E;
        for (int e = lane; e < E; e += 32) {
          const float dm = dmix[r * E + e];
          const float ue = u[e];
#pragma unroll
          for (int m = 0; m < kMaxM; ++m)
            if (m < M)
              dkvr[(size_t)m * E + e] = from_f32<T>(a[m] * dm + ds[m] * ue);
        }
      }
    }
  }
}

// The block's row of partial sums: part[e] = sum_r sum_m d_s[r, m]
// kv[r, m, e] (du), part[E + e] = sum_r d_out[r, e], part[2E] = sum d_s,
// over the block's valid rows in a fixed order.
template <typename T>
__device__ void block_partials(const T* __restrict__ kv,
                               const float* __restrict__ scales,
                               const float* ds_s, const float* dout,
                               float* __restrict__ part, int row0, int B,
                               int M, int E) {
  const int rows_valid = min(kRows, B - row0);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float du = 0.f;
    float dsum = 0.f;
    for (int r = 0; r < rows_valid; ++r) {
      const KvRow<T> kvr(kv, scales, row0 + r, M, E);
      for (int m = 0; m < M; ++m)
        du = fmaf(ds_s[r * kMaxM + m], kvr.at(m, e), du);
      dsum += dout[r * E + e];
    }
    part[e] = du;
    part[E + e] = dsum;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < rows_valid; ++r)
      for (int m = 0; m < M; ++m) s += ds_s[r * kMaxM + m];
    part[2 * E] = s;
  }
}

// ---- cross-block reductions -------------------------------------------------

// out[s][i, j] = sum_{b in split s} A[b, i] Bm[b, j]: A (Bn x Ni) and Bm
// (Bn x Nj) row-major; one block per 64 x 64 output tile and batch split.
__global__ void __launch_bounds__(kThreads)
    gemm_tn_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                   float* __restrict__ out, int Ni, int Nj, int Bn,
                   int rows_per_split) {
  __shared__ __align__(16) float As[kChunk][kTn];
  __shared__ __align__(16) float Bs[kChunk][kTn];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * kTn;
  const int j0 = blockIdx.x * kTn;
  const int b_begin = blockIdx.z * rows_per_split;
  const int b_end = min(Bn, b_begin + rows_per_split);
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  for (int b0 = b_begin; b0 < b_end; b0 += kChunk) {
    for (int idx = threadIdx.x; idx < kChunk * kTn; idx += kThreads) {
      const int kk = idx / kTn;
      const int ii = idx % kTn;
      const int b = b0 + kk;
      As[kk][ii] = (b < b_end && i0 + ii < Ni) ? A[(size_t)b * Ni + i0 + ii] : 0.f;
      Bs[kk][ii] = (b < b_end && j0 + ii < Nj) ? Bm[(size_t)b * Nj + j0 + ii] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      // float4 reads: a warp shares two A quads and 16 B quads
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.z * Ni * Nj;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + 4 * ty + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 4 * tx + q;
      if (i < Ni && j < Nj) o[(size_t)i * Nj + j] = acc[p][q];
    }
  }
}

// out[i] = sum_s part[s * n + i], s in order.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

// out[j] = sum_r part[r * cols + j], r in order.
__global__ void colsum_kernel(const float* __restrict__ part, int rows,
                              int cols, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * cols + j];
  out[j] = s;
}

// Batch splits of gemm_tn: enough blocks for two waves of the SMs, at
// least 256 rows a split.
inline int tn_splits(int Ni, int Nj, int Bn) {
  const int tiles = ((Ni + kTn - 1) / kTn) * ((Nj + kTn - 1) / kTn);
  const int want = (2 * kSms + tiles - 1) / tiles;
  const int cap = (Bn + 255) / 256;
  return max(1, min(want, cap));
}

inline size_t gemm_tn_scratch(int Ni, int Nj, int Bn) {
  const int s = tn_splits(Ni, Nj, Bn);
  return s > 1 ? (size_t)s * Ni * Nj : 0;
}

// out (Ni x Nj) = A^T Bm over Bn rows; scratch holds gemm_tn_scratch floats.
inline void gemm_tn(const float* A, const float* Bm, float* out,
                    float* scratch, int Ni, int Nj, int Bn,
                    cudaStream_t stream) {
  const int splits = tn_splits(Ni, Nj, Bn);
  const int rps = (Bn + splits - 1) / splits;
  const dim3 grid((Nj + kTn - 1) / kTn, (Ni + kTn - 1) / kTn, splits);
  gemm_tn_kernel<<<grid, kThreads, 0, stream>>>(
      A, Bm, splits > 1 ? scratch : out, Ni, Nj, Bn, rps);
  if (splits > 1) {
    const int n = Ni * Nj;
    sum_splits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(scratch, out, n,
                                                           splits);
  }
}

inline void colsum(const float* part, int rows, int cols, float* out,
                   cudaStream_t stream) {
  colsum_kernel<<<(cols + 255) / 256, 256, 0, stream>>>(part, rows, cols,
                                                        out);
}

inline int row_blocks(int B) { return (B + kRows - 1) / kRows; }

// Launch bounds of a row kernel: 256 threads and `min_blocks` blocks an
// SM, which caps ptxas at 65536 / (256 min_blocks) registers.  Measured on
// the H100 for the forward kernel (device time, B = 32 / 256 / 4096): one
// block (128 registers) 0.038 / 0.039 / 0.443 ms, four (64 registers, no
// spill) 0.041 / 0.042 / 0.321 ms — occupancy wins at the training batch.
// The step and backward kernels hold 80 KB of shared memory at E = 512, so
// two blocks an SM is all they can have.
#define AECF_ROW_KERNEL(min_blocks) \
  __global__ void __launch_bounds__(aecf::kThreads, min_blocks)

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace aecf
