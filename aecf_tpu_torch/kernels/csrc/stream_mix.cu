// Streamed shared-query forward (the "mix" kernel) for Hopper (sm_90a).
//
// Replaces aecf_tpu/kernels/shared_query.py::_mix_kernel (launched by
// _forward_streamed), f32/bf16 features and its quantized=True branch
// (int8 with per-(row, modality) scales, read through KvRow in 4-byte
// loads): the forward of the streamed split, which takes the
// shared-query pools with H <= 2 above the resident kernel's cap
// (1024 < E <= 8192) and H == 2 training from E = 512.  Per batch row b,
// with u (H, E) and c (H,) computed outside the kernel:
//
//   s_h[m] = kv[b, m] . u_h + c_h + pad[b, m]      (pad: 0 or -1e30)
//   a_h    = softmax_m(s_h);  w = mean_h(a_h);  ent, and in training the
//            Philox mask chain -> mw, rate           (pool_common.cuh)
//   mix[b, h E : (h + 1) E] = sum_m a_h[m] kv[b, m]  (f32, unmasked: Q1)
//
// The context GEMMs (out = mix W_vo^T + b_ctx for H == 1; the per-head V
// projection, then the output projection, for H == 2) run in cuBLAS
// outside the kernel, as the JAX package leaves them to XLA: the kernel
// holds no E x E matrix, so E is bounded by nothing but the caller's cap.
//
// What bounds it on the H100: bytes.  It must read kv (B M E) and write
// mix (B H E f32); its arithmetic, about (6 + 2H) B M E flops, is far
// below the SIMT rate.  One warp takes one row: row_softmax and
// row_side_outputs run the resident forward's chain in the same order, so
// the two kernels give the same weights, entropy and mask bit for bit for
// the same seed words; then a second pass over the row reads kv in 16-byte
// (f32), 8-byte (bf16) or 4-byte (int8) loads and writes mix in 16-byte
// stores.  That second read comes from L2 only while the rows in flight
// fit in it (32 KB a row at M = 4, E = 2048 in f32), so at large B M E it
// goes to device memory again.  Needs E % 4 == 0.  Tensor cores have
// nothing to do here.
//
// Measured on an H100 SXM (700 W) at B = 4096, M = 4, E = 2048, H = 1, f32:
// 0.141 ms in training and 0.139 ms in eval, against a bound of 0.050 ms
// (168 MB at 3.35 TB/s); int8, eval: 0.085 ms against a bound of 0.020 ms
// (67 MB).
//
// Numerics: f32 throughout; the entropy floors w at the subnormal 1e-38,
// so this file is built without fast-math and without flush-to-zero.

#include "pool_common.cuh"

using namespace aecf;

namespace {

template <typename T, bool kTraining>
AECF_ROW_KERNEL(4) stream_mix_kernel(
    const T* __restrict__ kv, const float* __restrict__ scales,
    const float* __restrict__ u,
    const float* __restrict__ c, const float* __restrict__ pad,
    float* __restrict__ mix, float* __restrict__ w_out,
    float* __restrict__ mw_out, float* __restrict__ ent_out,
    float* __restrict__ rate_out, int B, int M, int E, int H,
    MaskParams mp) {
  const int lane = threadIdx.x & 31;
  const int gr = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gr >= B) return;  // warp-uniform; the kernel has no block barrier
  const KvRow<T> kvr(kv, scales, gr, M, E);
  float a[kMaxH][kMaxM];
  float w[kMaxM];
  row_softmax(kvr, u, c, pad != nullptr ? pad + (size_t)gr * M : nullptr, M,
              E, H, a, w);
  row_side_outputs<kTraining>(w, gr, M, mp, w_out, mw_out, ent_out, rate_out);

  float* mixr = mix + (size_t)gr * H * E;
  for (int j = 4 * lane; j < E; j += 4 * 32) {
    float4 acc[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        const float4 x = kvr.at4(m, j);
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H) acc[h] = axpy4(a[h][m], x, acc[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
      if (h < H) store4(mixr + (size_t)h * E + j, acc[h]);
  }
}

template <typename T, bool kTraining>
cudaError_t launch(const void* kv, const float* scales, const float* u,
                   const float* c, const float* pad, float* mix, float* w,
                   float* mw,
                   float* ent, float* rate, int B, int M, int E, int H,
                   const MaskParams& mp, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  stream_mix_kernel<T, kTraining><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(kv), scales, u, c, pad, mix, w, mw, ent, rate, B,
      M, E, H, mp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 means the launch was accepted.  kv is (B, M, E)
// f32 (kv_dtype = 0), bf16 (1) or int8 (2, with scales (B, M) f32, read
// for int8 only), aligned to four elements; pad may be null (no padding);
// mix is (B, H E) f32, 16-byte aligned; w, mw (B, M), ent, rate (B,).  All
// contiguous device buffers.  training = 0 is the eval branch (seed words,
// mask_prob and min_active unread).
int aecf_stream_mix(const void* kv, int kv_dtype, const float* scales,
                    const float* u, const float* c, const float* pad,
                    float* mix, float* w,
                    float* mw, float* ent, float* rate, int B, int M, int E,
                    int H, float max_entropy, int training,
                    unsigned int seed0, unsigned int seed1, float mask_prob,
                    int min_active, void* stream) {
  if (B < 1 || M < 1 || M > kMaxM || H < 1 || H > kMaxH || E < 4 ||
      E % 4 != 0 || (kv_dtype == kKvInt8 && scales == nullptr)) {
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
  auto run = [&](auto launcher) {
    return launcher(kv, scales, u, c, pad, mix, w, mw, ent, rate, B, M, E, H,
                    mp, s);
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

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
