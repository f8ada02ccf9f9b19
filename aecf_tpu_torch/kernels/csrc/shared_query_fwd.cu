// Shared-query fusion-pool forward (eval and training) for Hopper (sm_90a).
//
// Replaces aecf_tpu/kernels/shared_query.py::_shared_kernel (f32/bf16
// features) and ::_shared_kernel_q8 (int8 features with per-(row,
// modality) f32 scales, dequantized per element by KvRow): _shared_body
// -> _weights_entropy_mask (with the training branch, _mask_and_renorm),
// then the context GEMM.  Per batch row b, with the per-call vectors u
// (H, E), c (H,) and the fused context weights computed outside the kernel:
//
//   s_h[m]  = kv[b, m] . u_h + c_h + pad[b, m]        (pad: 0 or -1e30)
//   a_h     = softmax_m(s_h)
//   w       = mean_h(a_h)
//   ent     = clip(-sum_m w log(max(w, 1e-38)) [w > 0], 0, ln M)
//   eval:     mw = w;  rate = 0
//   training: Philox keep-mask, min_active, renorm (pool_common.cuh)
//   mix_h   = sum_m a_h[m] kv[b, m]       (quirk Q1: unmasked weights)
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
// masked here; nothing is padded on the host.  Only the blockIdx.y == 0
// blocks of a row tile write the side outputs and make the draw.  wgmma
// and TMA are for later work on this kernel.
//
// Measured on an H100 SXM (700 W), eval: 0.041-0.042 ms at B = 32 and
// B = 256 (M = 2, E = 512, H = 1), flat in B, so it does not reach the
// byte bound yet: each block walks the k-chunks of W serially, with a
// global load and two barriers per chunk, and up to B = 256 there are
// fewer blocks (128) than SMs (132).
//
// Heads: any H dividing E (E <= 1024), as the TPU kernel when forced.  Up
// to kMaxH = 2 heads the scores live in one register array a[kMaxH][kMaxM]
// (the eval instance runs at 64 registers, no spill); above it,
// row_softmax_heads takes the heads in passes of two, re-reading the warp's
// kv row from L1 once a pass, and keeps every head's weights in a_s
// (kRows x H x M floats, sized by the call); these are instances of their
// own (kManyHeads), which leaves the H <= 2 instances' code and registers
// as they were.  The H > 1 epilogue then runs one head at a time: mix_h,
// its Dh = E / H columns of ctx, and after the last head the output GEMM —
// 2 B E^2 FMAs whatever H.  Measured at the medical model's pool (B = 4096,
// M = 3, E = 512, H = 8, eval): 0.63 ms, against 0.80 ms for the torch
// route and a 0.067 ms bound (operations; H100 SXM, 700 W).
//
// int8 features (the _shared_kernel_q8 instance): every column block of a
// row tile reads the tile's kv again for the scores and the mix (E / 64
// times, mostly from L2), so the quarter-size int8 rows show even in this
// GEMM-heavy kernel: 2.865 ms against 4.074 ms for f32 features holding
// the same dequantized values, at B = 8192, M = 4, E = 1024, H = 1, eval
// (bound 0.258 ms, by operations; H100 SXM, 700 W).
//
// Numerics: full f32 FMAs for every precision mode.  Entropy uses logf on
// max(w, 1e-38) — a subnormal floor — so this file must be built without
// --use_fast_math and without -ftz=true.

#include "pool_common.cuh"

using namespace aecf;

namespace {

// kManyHeads: H > kMaxH, the scores in passes (its own instance, so the
// H <= 2 instances compile as before: 64 registers, no spill).
template <typename T, bool kTraining, bool kManyHeads>
AECF_ROW_KERNEL(4) shared_query_fwd_kernel(
    const T* __restrict__ kv, const float* __restrict__ scales,
    const float* __restrict__ u,
    const float* __restrict__ c, const float* __restrict__ pad,
    const float* __restrict__ wctx, const float* __restrict__ wo,
    const float* __restrict__ bctx, const float* __restrict__ bo,
    float* __restrict__ out, float* __restrict__ w_out,
    float* __restrict__ mw_out, float* __restrict__ ent_out,
    float* __restrict__ rate_out, int B, int M, int E, int H,
    MaskParams mp) {
  extern __shared__ float smem[];
  float* mix = smem;                                   // kRows x E
  float* ctx = mix + kRows * E;                        // kRows x E (H > 1)
  float* a_s = ctx + (H > 1 ? kRows * E : 0);          // kRows x H x M
  float* wt = a_s + (kManyHeads ? align4(kRows * H * M)  // kChunk x kWtStride
                                : kRows * kMaxH * kMaxM);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, B - row0);

  // ---- scores -> softmax -> head mean -> entropy -> mask: a warp a row --
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= B) continue;  // warp-uniform
    float w[kMaxM];
    if constexpr (!kManyHeads) {
      float a[kMaxH][kMaxM];
      row_softmax(KvRow<T>(kv, scales, gr, M, E), u, c,
                  pad != nullptr ? pad + (size_t)gr * M : nullptr, M, E, H, a,
                  w);
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
#pragma unroll
          for (int m = 0; m < kMaxM; ++m)
            if (h < H && m < M) a_s[(r * H + h) * M + m] = a[h][m];
      }
    } else {
      row_softmax_heads(KvRow<T>(kv, scales, gr, M, E), u, c,
                        pad != nullptr ? pad + (size_t)gr * M : nullptr, M, E,
                        H, a_s + r * H * M, w);
    }
    if (blockIdx.y == 0)
      row_side_outputs<kTraining>(w, gr, M, mp, w_out, mw_out, ent_out,
                                  rate_out);
  }
  __syncthreads();

  // ---- mix -> context GEMM(s) (quirk Q1: unmasked per-head attention) ----
  if (H == 1) {
    build_mix(kv, scales, a_s, mix, (float*)nullptr, row0, B, M, E, H, 0);
    __syncthreads();
    const int n0 = blockIdx.y * kCols;
    gemm_rows<false>(mix, E, E, wctx, E, bctx, n0, min(E, n0 + kCols), wt,
                     out + (size_t)row0 * E, E, rows_valid);
    return;
  }
  const int Dh = E / H;
  for (int h = 0; h < H; ++h) {
    build_mix(kv, scales, a_s, mix, (float*)nullptr, row0, B, M, E, H, h);
    __syncthreads();
    // Rows h*Dh.. of Wv are head h's value projection.
    gemm_rows<false>(mix, E, E, wctx, E, bctx, h * Dh, (h + 1) * Dh, wt, ctx,
                     E, kRows);
    __syncthreads();
  }
  gemm_rows<false>(ctx, E, E, wo, E, bo, 0, E, wt, out + (size_t)row0 * E, E,
                   rows_valid);
}

// mix (and ctx for H > 1), a_s (kRows x kMaxH x kMaxM floats, or sized by
// the call's H and M above two heads), the staging tile: 73 KB at E = 1024,
// H = 1; 137-141 KB at E = 1024, H > 1.
size_t smem_bytes(int E, int H, int M) {
  return sizeof(float) * ((size_t)kRows * E * (H > 1 ? 2 : 1) +
                          align4(kRows * max(H * M, kMaxH * kMaxM)) +
                          kChunk * kWtStride);
}

template <typename T, bool kTraining, bool kManyHeads>
cudaError_t launch_heads(const void* kv, const float* scales, const float* u,
                         const float* c, const float* pad, const float* wctx,
                         const float* wo, const float* bctx, const float* bo,
                         float* out, float* w, float* mw, float* ent,
                         float* rate, int B, int M, int E, int H,
                         const MaskParams& mp, cudaStream_t stream) {
  const auto kernel = shared_query_fwd_kernel<T, kTraining, kManyHeads>;
  const size_t smem = smem_bytes(E, H, M);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // H > 1 keeps every output column in one block: its second GEMM needs
  // the block's whole ctx tile, which a column split would recompute.
  const dim3 grid(row_blocks(B), H == 1 ? (E + kCols - 1) / kCols : 1);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(kv), scales, u, c, pad, wctx, wo, bctx, bo, out,
      w, mw, ent, rate, B, M, E, H, mp);
  return cudaGetLastError();
}

template <typename T, bool kTraining>
cudaError_t launch(const void* kv, const float* scales, const float* u,
                   const float* c,
                   const float* pad, const float* wctx, const float* wo,
                   const float* bctx, const float* bo, float* out, float* w,
                   float* mw, float* ent, float* rate, int B, int M, int E,
                   int H, const MaskParams& mp, cudaStream_t stream) {
  return (H > kMaxH ? launch_heads<T, kTraining, true>
                    : launch_heads<T, kTraining, false>)(
      kv, scales, u, c, pad, wctx, wo, bctx, bo, out, w, mw, ent, rate, B, M,
      E, H, mp, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 means the launch was accepted.  kv is (B, M, E)
// f32 (kv_dtype = 0), bf16 (1) or int8 (2, with scales (B, M) f32; scales
// is read for int8 only); pad may be null (no padding); wo and bo are read
// only when H > 1.  All other pointers are f32 device buffers of the
// shapes in the header comment, contiguous.  training = 0 is the eval
// branch (seed words, mask_prob and min_active unread).
int aecf_shared_query_fwd(const void* kv, int kv_dtype, const float* scales,
                          const float* u, const float* c, const float* pad,
                          const float* wctx,
                          const float* wo, const float* bctx, const float* bo,
                          float* out, float* w, float* mw, float* ent,
                          float* rate, int B, int M, int E, int H,
                          float max_entropy, int training, unsigned int seed0,
                          unsigned int seed1, float mask_prob, int min_active,
                          void* stream) {
  if (B < 1 || M < 1 || M > kMaxM || H < 1 || E < 1 || E % H != 0 ||
      (kv_dtype == kKvInt8 && scales == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  MaskParams mp;
  mp.max_entropy = max_entropy;
  mp.mask_prob = mask_prob;
  mp.min_active = min_active;
  mp.training = training;
  mp.seed0 = seed0;
  mp.seed1 = seed1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // eval and training are separate instances (see row_side_outputs)
  auto run = [&](auto launcher) {
    return launcher(kv, scales, u, c, pad, wctx, wo, bctx, bo, out, w, mw,
                    ent, rate, B, M, E, H, mp, s);
  };
  switch (kv_dtype) {
    case kKvF32:
      return (int)(training ? run(launch<float, true>)
                            : run(launch<float, false>));
    case kKvBf16:
      return (int)(training ? run(launch<__nv_bfloat16, true>)
                            : run(launch<__nv_bfloat16, false>));
    case kKvInt8:
      return (int)(training ? run(launch<int8_t, true>)
                            : run(launch<int8_t, false>));
  }
  return (int)cudaErrorInvalidValue;
}

// Philox4x32-10 of n (c0, c1, c2, c3, k0, k1) rows of `in` into n x 4
// words of `out` (device buffers): the known-answer check of the device
// generator.
int aecf_philox4x32_10(const unsigned int* in, unsigned int* out, int n,
                       void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  philox_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, n);
  return (int)cudaGetLastError();
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
