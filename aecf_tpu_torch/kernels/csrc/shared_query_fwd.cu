// Shared-query fusion-pool forward (eval) for Hopper (sm_90a).
//
// Replaces aecf_tpu/kernels/shared_query.py::_shared_kernel (its eval
// branch: _shared_body -> _weights_entropy_mask with training=False, then
// the context GEMM).  Per batch row b, with the per-call vectors u (H, E),
// c (H,) and the fused context weights computed outside the kernel:
//
//   s_h[m]  = kv[b, m] . u_h + c_h + pad[b, m]        (pad: 0 or -1e30)
//   a_h     = softmax_m(s_h)
//   w       = mean_h(a_h);  mw = w;  rate = 0
//   ent     = clip(-sum_m w log(max(w, 1e-38)) [w > 0], 0, ln M)
//   mix_h   = sum_m a_h[m] kv[b, m]
//   H == 1: out = mix_0 W_vo^T + b_ctx            (W_vo = Wo Wv)
//   H  > 1: ctx = concat_h(mix_h Wv_h^T) + bv;  out = ctx Wo^T + bo
//
// What bounds it on the H100: bytes.  Each block reads its kv tile
// (kRows x M x E) and, for the context GEMM, a kCols-wide slice of W_vo
// (E x kCols floats) from L2; the arithmetic is B x E^2 FMAs, far below
// the SIMT rate at serving batch sizes.  The design keeps every
// intermediate (scores, softmax, mix) on chip: one block takes kRows rows
// and, for H == 1, one kCols-wide tile of output columns, so a bucket of
// 32 rows at E = 512 still launches 16 blocks.  The mix tile lives in
// dynamic shared memory; the GEMM is a plain SIMT f32 loop over k-chunks
// of W staged through shared memory.  The tail rows of a ragged batch are
// masked here; nothing is padded on the host.  wgmma and TMA are for
// later work on this kernel.
//
// Measured on an H100 SXM (700 W): 0.041-0.042 ms at B = 32 and B = 256
// (M = 2, E = 512, H = 1), flat in B, so it does not reach the byte bound
// yet: each block walks the k-chunks of W serially, with a global load and
// two barriers per chunk, and up to B = 256 there are fewer blocks (128)
// than SMs (132).
//
// Numerics: full f32 FMAs for every precision mode.  Entropy uses logf on
// max(w, 1e-38) — a subnormal floor — so this file must be built without
// --use_fast_math and without -ftz=true.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;   // batch rows per block
constexpr int kCols = 64;   // output columns per GEMM tile
constexpr int kChunk = 32;  // k-depth of one staged W tile
constexpr int kWtStride = kCols + 1;  // pad: conflict-free transposed store
constexpr int kMaxM = 8;
constexpr int kMaxH = 2;

static_assert(kRows == 2 * kWarps, "each warp owns two GEMM rows");
static_assert(kCols == 64, "each lane owns two GEMM columns");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r * ldd + n] = sum_k A[r * lda + k] * W[n * ldw + k] + bias[n]
// for the block's kRows rows (rows >= rows_valid are not written) and the
// columns n in [n0, n1).  A is in shared memory; W and bias in global
// memory; wt is the block's staging tile (kChunk x kWtStride floats).
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
      // Stage W[nt:nt+kCols, k0:k0+kChunk] transposed: a warp reads 32
      // consecutive k of one W row (128 coalesced bytes).
      for (int i = tid; i < kCols * kChunk; i += kThreads) {
        const int kk = i % kChunk;
        const int nn = i / kChunk;
        const int n = nt + nn;
        wt[kk * kWtStride + nn] =
            (n < n1 && kk < kc) ? W[(size_t)n * ldw + k0 + kk] : 0.f;
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
        if (r < rows_valid && n < n1) dst[r * ldd + n] = acc[i][j] + bias[n];
      }
    }
  }
}

// mix[r, e] = sum_m a[r, h, m] kv[row0 + r, m, e]; zero for rows past B.
template <typename T>
__device__ void build_mix(const T* __restrict__ kv, const float* a_s,
                          float* mix, int row0, int B, int M, int E, int H,
                          int h) {
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
    for (int m = 0; m < kMaxM; ++m) a[m] = m < M ? a_s[(r * H + h) * M + m] : 0.f;
    const T* kvr = kv + (size_t)gr * M * E;
    for (int e = lane; e < E; e += 32) {
      float acc = a[0] * to_f32(kvr[e]);
#pragma unroll
      for (int m = 1; m < kMaxM; ++m)
        if (m < M) acc = acc + a[m] * to_f32(kvr[(size_t)m * E + e]);
      mix[r * E + e] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) shared_query_fwd_kernel(
    const T* __restrict__ kv, const float* __restrict__ u,
    const float* __restrict__ c, const float* __restrict__ pad,
    const float* __restrict__ wctx, const float* __restrict__ wo,
    const float* __restrict__ bctx, const float* __restrict__ bo,
    float* __restrict__ out, float* __restrict__ w_out,
    float* __restrict__ mw_out, float* __restrict__ ent_out,
    float* __restrict__ rate_out, int B, int M, int E, int H,
    float max_entropy) {
  extern __shared__ float smem[];
  float* mix = smem;                                   // kRows x E
  float* ctx = mix + kRows * E;                        // kRows x E (H > 1)
  float* a_s = ctx + (H > 1 ? kRows * E : 0);          // kRows x H x M
  float* wt = a_s + kRows * kMaxH * kMaxM;             // kChunk x kWtStride

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, B - row0);

  // ---- scores -> softmax -> head mean -> entropy: one warp per row ----
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= B) continue;  // warp-uniform
    const T* kvr = kv + (size_t)gr * M * E;
    float s[kMaxH][kMaxM];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) s[h][m] = 0.f;
    for (int e = lane; e < E; e += 32) {
      float uh[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) uh[h] = h < H ? u[h * E + e] : 0.f;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float x = to_f32(kvr[(size_t)m * E + e]);
#pragma unroll
          for (int h = 0; h < kMaxH; ++h) s[h][m] = fmaf(x, uh[h], s[h][m]);
        }
      }
    }
    float w[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) w[m] = 0.f;
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      if (h >= H) break;
      float smax = -INFINITY;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float bias = pad != nullptr ? pad[(size_t)gr * M + m] : 0.f;
          s[h][m] = (warp_sum(s[h][m]) + c[h]) + bias;
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
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float a = s[h][m] / denom;
          if (lane == 0) a_s[(r * H + h) * M + m] = a;
          w[m] += a;
        }
      }
    }
    const float inv_h = 1.0f / (float)H;
    float plogp = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        w[m] *= inv_h;
        plogp += w[m] > 0.f ? w[m] * logf(fmaxf(w[m], 1e-38f)) : 0.f;
      }
    }
    if (blockIdx.y == 0 && lane == 0) {
      for (int m = 0; m < M; ++m) {
        w_out[(size_t)gr * M + m] = w[m];
        mw_out[(size_t)gr * M + m] = w[m];  // eval: masking is a passthrough
      }
      ent_out[gr] = fminf(fmaxf(-plogp, 0.f), max_entropy);
      rate_out[gr] = 0.f;
    }
  }
  __syncthreads();

  // ---- mix -> context GEMM(s) (quirk Q1: unmasked per-head attention) ----
  if (H == 1) {
    build_mix(kv, a_s, mix, row0, B, M, E, H, 0);
    __syncthreads();
    const int n0 = blockIdx.y * kCols;
    gemm_rows(mix, E, E, wctx, E, bctx, n0, min(E, n0 + kCols), wt,
              out + (size_t)row0 * E, E, rows_valid);
    return;
  }
  const int Dh = E / H;
  for (int h = 0; h < H; ++h) {
    build_mix(kv, a_s, mix, row0, B, M, E, H, h);
    __syncthreads();
    // Rows h*Dh.. of Wv are head h's value projection.
    gemm_rows(mix, E, E, wctx, E, bctx, h * Dh, (h + 1) * Dh, wt, ctx, E,
              kRows);
    __syncthreads();
  }
  gemm_rows(ctx, E, E, wo, E, bo, 0, E, wt, out + (size_t)row0 * E, E,
            rows_valid);
}

size_t smem_bytes(int E, int H) {
  return sizeof(float) * ((size_t)kRows * E * (H > 1 ? 2 : 1) +
                          kRows * kMaxH * kMaxM + kChunk * kWtStride);
}

template <typename T>
cudaError_t launch(const void* kv, const float* u, const float* c,
                   const float* pad, const float* wctx, const float* wo,
                   const float* bctx, const float* bo, float* out, float* w,
                   float* mw, float* ent, float* rate, int B, int M, int E,
                   int H, float max_entropy, cudaStream_t stream) {
  const size_t smem = smem_bytes(E, H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        shared_query_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // H > 1 keeps every output column in one block: its second GEMM needs
  // the block's whole ctx tile, which a column split would recompute.
  const dim3 grid((B + kRows - 1) / kRows,
                  H == 1 ? (E + kCols - 1) / kCols : 1);
  shared_query_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(kv), u, c, pad, wctx, wo, bctx, bo, out, w, mw,
      ent, rate, B, M, E, H, max_entropy);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 means the launch was accepted.  kv is (B, M, E)
// f32 (kv_bf16 = 0) or bf16 (kv_bf16 = 1); pad may be null (no padding);
// wo and bo are read only when H > 1.  All other pointers are f32 device
// buffers of the shapes in the header comment, contiguous.
int aecf_shared_query_fwd(const void* kv, int kv_bf16, const float* u,
                          const float* c, const float* pad, const float* wctx,
                          const float* wo, const float* bctx, const float* bo,
                          float* out, float* w, float* mw, float* ent,
                          float* rate, int B, int M, int E, int H,
                          float max_entropy, void* stream) {
  if (B < 1 || M < 1 || M > kMaxM || H < 1 || H > kMaxH || E < 1 ||
      E % H != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      kv_bf16 ? launch<__nv_bfloat16>(kv, u, c, pad, wctx, wo, bctx, bo, out,
                                      w, mw, ent, rate, B, M, E, H,
                                      max_entropy, s)
              : launch<float>(kv, u, c, pad, wctx, wo, bctx, bo, out, w, mw,
                              ent, rate, B, M, E, H, max_entropy, s);
  return (int)err;
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
