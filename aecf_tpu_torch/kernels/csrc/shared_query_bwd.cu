// Shared-query fusion-pool backward, H == 1, for Hopper (sm_90a).
//
// Replaces aecf_tpu/kernels/shared_query.py::_bwd_kernel (launched by
// _bwd_pallas), f32/bf16 features and its quantized=True branch (int8
// features with per-(row, modality) scales, read through KvRow; frozen,
// so no d_kv): the two-pass training step's backward.  Per batch row b,
// with u (E), c and W_vo = Wo Wv computed outside the kernel:
//
//   recompute  a = softmax_m(kv[b, m] . u + c + pad[b, m]);  mix = sum a kv
//   d_mix    = d_out W_vo                        (out = mix W_vo^T + b)
//   d_a[m]   = d_mix . kv[b, m] + d_w[m];   d_s = a (d_a - sum_m a d_a)
//   d_kv[m]  = a[m] d_mix + d_s[m] u              (optional, kv dtype)
// and the batch sums
//   G = sum_b d_out^T mix (E x E),  du = sum_b sum_m d_s kv,
//   sum_b d_out (E),  dc = sum_b sum_m d_s.
// dW_o, dW_v, the biases and the query-path grads follow from these in
// torch (_g_epilogue, _query_path_grads), as the JAX package leaves them
// to XLA.
//
// What bounds it on the H100: at the north-star shape (B = 4096, E = 512)
// the two per-row GEMMs (d_mix, and G) are 2 B E^2 FMAs on the SIMT
// pipes; the kv stream (B M E) is read twice (scores, then d_a and du),
// the second time mostly from L2.  The TPU kernel adds G into one VMEM
// block across its sequential grid; blocks on the GPU run in parallel, so
// the row kernel writes mix (B x E) to a workspace and one row of partial
// sums per 16-row block, and the reductions of pool_common.cuh finish G
// (gemm_tn over the batch) and the small sums (colsum) in a fixed order:
// no atomics, and a run is bit for bit repeatable.  Padded rows (>= B)
// write nothing and add nothing.  Tensor cores are later work.  int8
// features change the bytes, not the operations: 3.990 ms against 4.105
// ms for f32 at B = 8192, M = 4, E = 1024, no d_kv (bound 0.517 ms, by
// operations; H100 SXM, 700 W).

#include "pool_common.cuh"

using namespace aecf;

// Also declared, field for field, by kernels/shared_query.py (ctypes).
struct BwdParams {
  const void* kv;     // (B, M, E) f32, bf16 or int8 (kv_dtype)
  const float* scales;  // (B, M) dequant scales, int8 only
  const float* u;     // (E,)
  const float* c;     // (1,)
  const float* pad;   // (B, M) or null
  const float* dout;  // (B, E)
  const float* dw;    // (B, M) or null
  const float* wvo;   // (E, E)
  void* dkv;          // (B, M, E) kv dtype, or null: no d_kv (int8: null)
  float* g;           // (E, E)
  float* sums;        // (2E + 1): du | sum d_out | sum d_s
  float* ws;          // aecf_shared_query_bwd_workspace floats
  int B, M, E, kv_dtype;  // KvDtype: 0 f32, 1 bf16, 2 int8
};

namespace {

template <typename T>
AECF_ROW_KERNEL(2) bwd_rows_kernel(BwdParams p, float* __restrict__ mix_ws,
                    float* __restrict__ part) {
  extern __shared__ float smem[];
  const int E = p.E;
  const int M = p.M;
  const int B = p.B;
  float* bufA = smem;                     // kRows x E: mix, then d_mix
  float* bufB = bufA + kRows * E;         // kRows x E: d_out
  float* a_s = bufB + kRows * E;          // kRows x M
  float* ds_s = a_s + kRows * kMaxM;      // kRows x kMaxM
  float* wt = ds_s + kRows * kMaxM;       // kStageFloats

  const T* kv = static_cast<const T*>(p.kv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;

  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= B) {
      for (int e = lane; e < E; e += 32) bufB[r * E + e] = 0.f;
      continue;
    }
    float a[kMaxH][kMaxM];
    float w[kMaxM];
    row_softmax(KvRow<T>(kv, p.scales, gr, M, E), p.u, p.c,
                p.pad != nullptr ? p.pad + (size_t)gr * M : nullptr, M, E, 1,
                a, w);
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
        if (m < M) a_s[r * M + m] = a[0][m];
    }
    for (int e = lane; e < E; e += 32)
      bufB[r * E + e] = p.dout[(size_t)gr * E + e];
  }
  __syncthreads();
  build_mix(kv, p.scales, a_s, bufA, mix_ws, row0, B, M, E, 1, 0);
  __syncthreads();
  // d_mix[r, k] = sum_n d_out[r, n] W_vo[n, k]: W(k, n) read k-major
  gemm_rows_wide(bufB, E, E, p.wvo, E, nullptr, E, wt, bufA, E, kRows);
  __syncthreads();
  softmax_bwd_rows(kv, p.scales, p.u, bufA, a_s, p.dw, ds_s,
                   static_cast<T*>(p.dkv), row0, B, M, E);
  __syncthreads();
  block_partials(kv, p.scales, ds_s, bufB,
                 part + (size_t)blockIdx.x * (2 * E + 1), row0, B, M, E);
}

size_t smem_bytes(int E) {
  return sizeof(float) *
         ((size_t)2 * kRows * E + 2 * kRows * kMaxM + kStageFloats);
}

// Workspace carve: mix (B x E) | partials (blocks x (2E + 1)) | G splits.
size_t workspace_floats(int B, int E) {
  return (size_t)B * E + (size_t)row_blocks(B) * (2 * E + 1) +
         gemm_tn_scratch(E, E, B);
}

template <typename T>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.E);
  cudaError_t err = allow_smem(bwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = row_blocks(p.B);
  float* mix_ws = p.ws;
  float* part = mix_ws + (size_t)p.B * p.E;
  float* gscratch = part + (size_t)blocks * (2 * p.E + 1);
  bwd_rows_kernel<T><<<blocks, kThreads, smem, stream>>>(p, mix_ws, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_tn(p.dout, mix_ws, p.g, gscratch, p.E, p.E, p.B, stream);
  colsum(part, blocks, 2 * p.E + 1, p.sums, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace aecf_shared_query_bwd needs for (B, E).
size_t aecf_shared_query_bwd_workspace(int B, int E) {
  return workspace_floats(B, E);
}

// Returns a cudaError_t; 0 means every launch was accepted.  Pointers are
// contiguous device buffers as listed in BwdParams; int8 needs scales and
// takes no dkv.
int aecf_shared_query_bwd(const BwdParams* p, void* stream) {
  if (p->B < 1 || p->M < 1 || p->M > kMaxM || p->E < 1 || p->E % 4 != 0 ||
      (p->kv_dtype == kKvInt8 && (p->scales == nullptr || p->dkv != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->kv_dtype) {
    case kKvF32: return (int)launch<float>(*p, s);
    case kKvBf16: return (int)launch<__nv_bfloat16>(*p, s);
    case kKvInt8: return (int)launch<int8_t>(*p, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
