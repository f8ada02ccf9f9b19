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
// The chains' row kernels and the fixed-order cross-block sum (part_sum)
// are in pool_rows.cuh, their GEMM in gemm_f32.cuh, the streamed kernels'
// staging in stream_stage.cuh.
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

#include <atomic>
#include <stddef.h>
#include <stdint.h>

namespace aecf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 8;
constexpr int kMaxH = 2;
constexpr float kEps = 1e-8f;  // aecf_tpu/core/masking.py EPS

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
  // The two seed words in device memory, read in place of seed0 and seed1
  // when set (the one-pass step's, so that a replayed CUDA graph draws the
  // words the host wrote for this replay); null for every other caller.
  const uint32_t* seeds = nullptr;
};

// One warp per row: per-head softmax weights a[h][m] (every lane holds
// them) and the head mean w[m].  s_h[m] = (kv[m] . u_h + c_h) + pad[m].
// Lane l sums the features e = l, l + 32, ... in that order.  Row is the
// row's reader: KvRow<T> (device memory) or StagedRow<T> (the streamed
// forward's copy in shared memory, stream_stage.cuh), which give the same
// values, so both give the same bits.
template <typename Row>
__device__ __forceinline__ void row_softmax(const Row& kvr,
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
// spill under the row kernels' register bound.  Each pass re-reads the
// warp's kv row (from L1) and lane 0 writes its heads' weights to a_row
// (H x M, the warp's own; every lane reads it after the warp's barrier);
// the head mean then sums a_row in head order,
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

// Every head's scores s_h[m] = (kv[m] . u_h + c_h) + pad[m] and softmax over
// M, the heads in passes of kMaxH, into a_row (H x M), and the head
// mean w = (sum_h a_h) (1 / H): row_softmax_heads with the kv row read four
// features a lane a pass (float4; the scalar reads of row_softmax left the
// row kernel at three times its bytes' time at B = 8192, E = 1024).
template <typename T>
__device__ __forceinline__ void row_softmax_heads4(
    const KvRow<T>& kvr, const float* __restrict__ u,
    const float* __restrict__ c, const float* pad_row, int M, int E, int H,
    float* a_row, float w[kMaxM]) {
  const int lane = threadIdx.x & 31;
  for (int h0 = 0; h0 < H; h0 += kMaxH) {
    const int nh = min(kMaxH, H - h0);
    float s[kMaxH][kMaxM];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) s[h][m] = 0.f;
    for (int j = 4 * lane; j < E; j += 128) {
      float4 uh[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        uh[h] = h < nh ? load4(u + (size_t)(h0 + h) * E + j)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float4 x = kvr.at4(m, j);
#pragma unroll
          for (int h = 0; h < kMaxH; ++h) s[h][m] = dot4(x, uh[h], s[h][m]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      if (h >= nh) break;
      float smax = -INFINITY;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float bias = pad_row != nullptr ? pad_row[m] : 0.f;
          s[h][m] = (warp_sum(s[h][m]) + c[h0 + h]) + bias;
          smax = fmaxf(smax, s[h][m]);
        }
      }
      float denom = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          s[h][m] = expf(s[h][m] - smax);
          denom += s[h][m];
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
          if (m < M) a_row[(h0 + h) * M + m] = s[h][m] / denom;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    float t = 0.f;
    if (m < M)
      for (int h = 0; h < H; ++h) t += a_row[h * M + m];
    w[m] = t;
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
    if (mp.seeds != nullptr)
      row_uniforms(mp.seeds[0], mp.seeds[1], gr, M, uni);
    else
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

// SMs of the current device (132 on the H100 SXM, 114 on the H100 PCIe):
// what the GEMMs' default plans and the persistent grids are sized by.
// Asked once a device, then cached.
inline int sm_count() {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices)
    dev = -1;
  if (dev >= 0) {
    const int n = known[dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                             dev < 0 ? 0 : dev) != cudaSuccess || n < 1)
    n = 132;
  if (dev >= 0) known[dev].store(n, std::memory_order_relaxed);
  return n;
}

// Rounds a count of floats up to a multiple of 4 (16 bytes).
__host__ __device__ inline int align4(int floats) { return (floats + 3) & ~3; }

// Launch bounds of a row kernel: 256 threads and `min_blocks` blocks an
// SM, which caps ptxas at 65536 / (256 min_blocks) registers: occupancy to
// hide the rows' loads, against spills of the per-row register arrays.
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
