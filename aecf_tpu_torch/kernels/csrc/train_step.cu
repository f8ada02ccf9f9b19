// One-pass fused train step of the H == 1 shared-query pool, for Hopper
// (sm_90a).
//
// Replaces aecf_tpu/kernels/train_step.py::_step_kernel (launched by
// fused_pool_train_step), f32/bf16 features and its quantized=True branch
// (int8 with per-(row, modality) scales, read through KvRow; frozen, so
// no d_kv).  One read of each row's features does the whole step, with
// u (E), c, W_vo = Wo Wv and b_ctx computed outside:
//
//   forward:  scores -> softmax a -> w, entropy, training mask chain
//             (side outputs w, mw, ent, rate);  mix = sum_m a kv;
//             out = mix W_vo^T + b_ctx
//   loss:     quadratic  loss_b = inv sum_e out^2,  d_out = 2 inv out
//             (inv = loss_scale / (B E)); or the linear head:
//             logits = out W_head + b_head,  loss_b = inv sum_c bce,
//             bce = max(x, 0) - x y + log1p(exp(-|x|)),
//             d_logits = inv (sigmoid(x) - y),  d_out = d_logits W_head^T
//             (inv = loss_scale / (B C))
//   backward: d_mix = d_out W_vo;  d_s = a (d_a - sum a d_a) with
//             d_a = d_mix . kv (quirk Q1: the mask never touches out);
//             optional d_kv = a d_mix + d_s u in the kv dtype
//   sums:     G = d_out^T mix (E x E), du = sum d_s kv, sum d_out,
//             sum d_s, sum loss_b, and with the head
//             dW_head = out^T d_logits (E x C), db_head = sum d_logits.
//
// What bounds it on the H100: at the north-star shape (B = 4096, M = 3,
// E = 512) the three GEMMs over the batch (out, d_mix, G: 3 B E^2 FMAs)
// run on the SIMT pipes; the kv stream (25 MB in f32) is read once from
// device memory and re-read from L2 for d_a and du.  The TPU kernel
// carries G, du and the head gradient in VMEM across its sequential grid.
// Blocks on the GPU run in parallel: a block holds 16 whole rows (the row
// loss, the logits and d_mix all need the whole out row), writes mix and
// d_out (and, with the head, out and d_logits) to a workspace and one row
// of partial sums, and the reductions of pool_common.cuh finish G and
// dW_head (gemm_tn over the batch) and the small sums (colsum) in a fixed
// order: no atomics, and a run is bit for bit repeatable.  Shared memory:
// two 16 x E f32 tiles (mix -> d_mix, out -> d_out), 128 KB at E = 1024,
// and a 16 KB weight staging tile.  The two E x E products run in
// gemm_rows_wide (4 x 4 outputs a thread), reading W_vo^T for out and W_vo
// for d_mix, both row-contiguous along the output columns.
// Rows past B write nothing and add nothing to any sum; nothing is padded
// on the host.  Tensor cores are later work.  int8 features: 0.585 ms
// against 0.637 ms for f32 at the north star with the C = 14 head, no
// d_kv (bound 0.0995 ms, by operations; H100 SXM, 700 W).
//
// Numerics: f32 throughout; built without fast-math or flush-to-zero
// (the entropy's subnormal floor).

#include "pool_common.cuh"

using namespace aecf;

// Also declared, field for field, by kernels/train_step.py (ctypes).
struct StepParams {
  const void* kv;        // (B, M, E) f32, bf16 or int8 (kv_dtype)
  const float* scales;   // (B, M) dequant scales, int8 only
  const float* u;        // (E,)
  const float* c;        // (1,)
  const float* pad;      // (B, M) or null
  const float* wvo;      // (E, E)
  const float* wvo_t;    // (E, E): W_vo transposed, for the out GEMM
  const float* bctx;     // (E,)
  const float* head_w;   // (E, C), or null: the quadratic loss
  const float* head_b;   // (C,)
  const float* labels;   // (B, C)
  float* w;              // (B, M)
  float* mw;             // (B, M)
  float* ent;            // (B,)
  float* rate;           // (B,)
  void* dkv;             // (B, M, E) kv dtype, or null: no d_kv (int8: null)
  float* g;              // (E, E)
  float* dhead_w;        // (E, C)
  float* sums;           // (2E + 2 + C): du | sum d_out | sum d_s | loss | db_head
  float* ws;             // aecf_train_step_workspace floats
  int B, M, E, C, kv_dtype, training, min_active;  // kv_dtype: KvDtype
  unsigned int seed0, seed1;
  float max_entropy, mask_prob, inv, two_inv;
};

namespace {

struct Workspace {
  float* mix;      // B x E
  float* dout;     // B x E
  float* out;      // B x E (head)
  float* dlogits;  // B x C (head)
  float* part;     // blocks x P
  float* gscr;     // G splits
  float* hscr;     // dW_head splits
};

__host__ __device__ inline int part_width(int E, int C) { return 2 * E + 2 + C; }

// Floats of each workspace piece, in carve order.
void workspace_sizes(int B, int E, int C, size_t n[7]) {
  n[0] = (size_t)B * E;
  n[1] = (size_t)B * E;
  n[2] = C > 0 ? (size_t)B * E : 0;
  n[3] = (size_t)B * C;
  n[4] = (size_t)row_blocks(B) * part_width(E, C);
  n[5] = gemm_tn_scratch(E, E, B);
  n[6] = C > 0 ? gemm_tn_scratch(E, C, B) : 0;
}

size_t workspace_floats(int B, int E, int C) {
  size_t n[7];
  workspace_sizes(B, E, C, n);
  size_t total = 0;
  for (int i = 0; i < 7; ++i) total += n[i];
  return total;
}

Workspace carve(float* ws, int B, int E, int C) {
  size_t n[7];
  workspace_sizes(B, E, C, n);
  float* at[7];
  for (int i = 0; i < 7; ++i) {
    at[i] = ws;
    ws += n[i];
  }
  return Workspace{at[0], at[1], at[2], at[3], at[4], at[5], at[6]};
}

template <typename T>
AECF_ROW_KERNEL(2) step_rows_kernel(StepParams p, Workspace ws) {
  extern __shared__ float smem[];
  const int E = p.E;
  const int M = p.M;
  const int B = p.B;
  const int C = p.head_w != nullptr ? p.C : 0;
  const int P = part_width(E, C);
  float* bufA = smem;                  // kRows x E: mix, then d_mix
  float* bufB = bufA + kRows * E;      // kRows x E: out, then d_out
  float* a_s = bufB + kRows * E;       // kRows x M
  float* ds_s = a_s + kRows * kMaxM;   // kRows x kMaxM
  float* lrow = ds_s + kRows * kMaxM;  // kRows: row loss
  float* lg = lrow + kRows;            // kRows x C: logits, then d_logits
  float* wt = smem + align4(2 * kRows * E + 2 * kRows * kMaxM + kRows +
                            kRows * C);  // kStageFloats

  const T* kv = static_cast<const T*>(p.kv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, B - row0);
  MaskParams mp;
  mp.max_entropy = p.max_entropy;
  mp.mask_prob = p.mask_prob;
  mp.min_active = p.min_active;
  mp.training = p.training;
  mp.seed0 = p.seed0;
  mp.seed1 = p.seed1;

  // ---- forward chain and side outputs: a warp a row ----------------------
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= B) continue;  // warp-uniform
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
    row_side_outputs<true>(w, gr, M, mp, p.w, p.mw, p.ent, p.rate);
  }
  __syncthreads();
  build_mix(kv, p.scales, a_s, bufA, ws.mix, row0, B, M, E, 1, 0);
  __syncthreads();
  // out[r, n] = sum_k mix[r, k] W_vo[n, k] + b_ctx[n]
  gemm_rows_wide(bufA, E, E, p.wvo_t, E, p.bctx, E, wt, bufB, E, kRows);
  __syncthreads();

  // ---- row loss and d_out (rows past B: zero loss, zero d_out) -----------
  if (C == 0) {
    for (int r = warp; r < kRows; r += kWarps) {
      const bool valid = row0 + r < B;
      float s = 0.f;
      for (int e = lane; e < E; e += 32) {
        const float o = bufB[r * E + e];
        s = fmaf(o, o, s);
        bufB[r * E + e] = valid ? o * p.two_inv : 0.f;
      }
      s = warp_sum(s);
      if (lane == 0) lrow[r] = valid ? s * p.inv : 0.f;
    }
  } else {
    for (int r = warp; r < rows_valid; r += kWarps)
      for (int e = lane; e < E; e += 32)
        ws.out[(size_t)(row0 + r) * E + e] = bufB[r * E + e];
    // logits[r, c] = sum_e out[r, e] W_head[e, c] + b_head[c]
    gemm_rows<true>(bufB, E, E, p.head_w, C, p.head_b, 0, C, wt, lg, C,
                    kRows);
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const int gr = row0 + r;
      const bool valid = gr < B;
      float s = 0.f;
      for (int j = lane; j < C; j += 32) {
        float d = 0.f;
        if (valid) {
          const float x = lg[r * C + j];
          const float y = p.labels[(size_t)gr * C + j];
          s += fmaxf(x, 0.f) - x * y + log1pf(expf(-fabsf(x)));
          d = (1.f / (1.f + expf(-x)) - y) * p.inv;
          ws.dlogits[(size_t)gr * C + j] = d;
        }
        lg[r * C + j] = d;
      }
      s = warp_sum(s);
      if (lane == 0) lrow[r] = valid ? s * p.inv : 0.f;
    }
    __syncthreads();
    // d_out[r, e] = sum_c d_logits[r, c] W_head[e, c]
    gemm_rows<false>(lg, C, C, p.head_w, C, nullptr, 0, E, wt, bufB, E,
                     kRows);
  }
  __syncthreads();
  for (int r = warp; r < rows_valid; r += kWarps)
    for (int e = lane; e < E; e += 32)
      ws.dout[(size_t)(row0 + r) * E + e] = bufB[r * E + e];

  // ---- backward: d_mix = d_out W_vo, softmax backward, partial sums ------
  // d_mix[r, k] = sum_n d_out[r, n] W_vo[n, k]
  gemm_rows_wide(bufB, E, E, p.wvo, E, nullptr, E, wt, bufA, E, kRows);
  __syncthreads();
  softmax_bwd_rows(kv, p.scales, p.u, bufA, a_s, (const float*)nullptr,
                   ds_s, static_cast<T*>(p.dkv), row0, B, M, E);
  __syncthreads();
  float* part = ws.part + (size_t)blockIdx.x * P;
  block_partials(kv, p.scales, ds_s, bufB, part, row0, B, M, E);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < rows_valid; ++r) s += lrow[r];
    part[2 * E + 1] = s;
  }
  for (int j = threadIdx.x; j < C; j += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows_valid; ++r) s += lg[r * C + j];
    part[2 * E + 2 + j] = s;
  }
}

size_t smem_bytes(int E, int C) {
  return sizeof(float) *
         ((size_t)align4(2 * kRows * E + 2 * kRows * kMaxM + kRows + kRows * C) +
          kStageFloats);
}

template <typename T>
cudaError_t launch(const StepParams& p, cudaStream_t stream) {
  const int C = p.head_w != nullptr ? p.C : 0;
  const size_t smem = smem_bytes(p.E, C);
  cudaError_t err = allow_smem(step_rows_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const Workspace ws = carve(p.ws, p.B, p.E, C);
  const int blocks = row_blocks(p.B);
  step_rows_kernel<T><<<blocks, kThreads, smem, stream>>>(p, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_tn(ws.dout, ws.mix, p.g, ws.gscr, p.E, p.E, p.B, stream);
  if (C > 0) gemm_tn(ws.out, ws.dlogits, p.dhead_w, ws.hscr, p.E, C, p.B, stream);
  colsum(ws.part, blocks, part_width(p.E, C), p.sums, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace aecf_train_step needs for (B, E, C); C = 0 for the
// quadratic loss.
size_t aecf_train_step_workspace(int B, int E, int C) {
  return workspace_floats(B, E, C);
}

// Shared memory in bytes one block of the row kernel asks for.
size_t aecf_train_step_smem(int E, int C) { return smem_bytes(E, C); }

// Returns a cudaError_t; 0 means every launch was accepted.  Pointers are
// contiguous device buffers as listed in StepParams; int8 needs scales and
// takes no dkv.
int aecf_train_step(const StepParams* p, void* stream) {
  if (p->B < 1 || p->M < 1 || p->M > kMaxM || p->E < 1 || p->E % 4 != 0 ||
      (p->head_w != nullptr && p->C < 1) ||
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
