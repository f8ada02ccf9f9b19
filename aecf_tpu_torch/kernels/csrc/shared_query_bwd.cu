// Shared-query fusion-pool backward, H == 1, for Hopper (sm_90a): a chain
// of kernels behind the one aecf_shared_query_bwd call.
//
// Replaces aecf_tpu/kernels/shared_query.py::_bwd_kernel (launched by
// _bwd_pallas), f32/bf16 features and its quantized=True branch (int8
// features with per-(row, modality) scales, read through KvRow; frozen,
// so no d_kv): the two-pass training step's backward.  Per batch row b,
// with u (E), c and W_vo = Wo Wv computed outside the chain:
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
// What bounds it on the H100: the two E x E products over the batch
// (d_mix and G, 4 B E^2 operations) on the SIMT f32 pipes at precision
// 'highest', on the TF32 tensor cores at 'default' (BwdParams.precision,
// gemm::Precision: the JAX kernel's dots at mxu_precision; R1 and R2 stay
// f32 at both); the kv stream (B M E) is read twice, by R1 and by R2.  It is the one-pass step's chain
// (train_step.cu) without the loss, with the same row kernels
// (pool_rows.cuh) and products (gemm_f32.cuh):
//
//   R1  a warp a row: the softmax recomputed (row_softmax, as the forward)
//       a -> ws.a and mix -> ws.mix; JAX's recompute, nothing saved from
//       the forward
//   G2  d_mix = d_out W_vo, W_vo read k-major as stored
//   R2  a warp a row: d_a with the weights' cotangent d_w, d_s, optional
//       d_kv; one row of partial sums a block of eight rows: du | sum d_out
//       | sum d_s
//   G3  G = d_out^T mix: transposed A, split over the batch, the splits
//       summed in order
//   part_sum  the partial rows into du | sum d_out | sum d_s.
//
// Widths: any E (E <= 1024 at the wrapper, the gate's cap): the workspace
// rows are E4 = 4 ceil(E / 4) floats apart, and at E % 4 != 0 d_out and
// W_vo are first copied to rows of E4 floats (pad_rows), for the GEMM's
// 16-byte chunks.  Rows past B write nothing and add nothing.  int8
// changes only R1 and R2, so the int8 backward equals the f32 backward on
// q.float() * s bit for bit.  No atomics: a run is bit for bit repeatable.
//
// Plans: BwdParams.plans gives G2's and G3's column tiles and K splits
// (gemm_f32.cuh GemmTile, {0, 0} the default; kernels/tiles.py chooses
// them), and the workspace follows them.

#include "gemm_f32.cuh"
#include "gemm_tf32.cuh"
#include "pool_rows.cuh"

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
  int precision;          // gemm::Precision
  gemm::GemmTile plans[2];  // G2 d_mix, G3 G; {0, 0}: gemm_plan's
};

namespace {

struct Workspace {
  float* a;     // B x kMaxM (B x M used): the softmax weights
  float* mix;   // B x E4
  float* dmix;  // B x E4
  float* dout;  // B x E4: d_out in rows of E4 (E % 4 != 0)
  float* wvo;   // E x E4: W_vo in rows of E4 (E % 4 != 0)
  float* part;  // warp_blocks(B) x (2E + 1): R2's partial rows
  float* scr;   // G2's and G3's scratch (gemm::product_scratch)
};

constexpr int kPieces = 7;

// The chain's products in launch order: G2 d_mix, G3 G (kernels/_plan.py
// lists the same).
constexpr int kProducts = 2;
int products(int B, int E, gemm::Product q[kProducts]) {
  q[0] = {B, E, E, 1, true, true};
  q[1] = {E, E, B, 1, true, true};
  return kProducts;
}

void workspace_sizes(int B, int E, const gemm::GemmTile* t,
                     size_t n[kPieces]) {
  const size_t E4 = align4(E);
  const bool ragged = E % 4 != 0;
  gemm::Product q[kProducts];
  n[0] = (size_t)B * kMaxM;
  n[1] = B * E4;
  n[2] = B * E4;
  n[3] = ragged ? B * E4 : 0;
  n[4] = ragged ? E * E4 : 0;
  n[5] = (size_t)warp_blocks(B) * part_cols(E, 0, false);
  n[6] = gemm::product_scratch(q, t, products(B, E, q));
  for (int i = 0; i < kPieces; ++i) n[i] = (n[i] + 63) & ~(size_t)63;
}

Workspace carve(float* ws, int B, int E, const gemm::GemmTile* t) {
  size_t n[kPieces];
  workspace_sizes(B, E, t, n);
  float* at[kPieces];
  for (int i = 0; i < kPieces; ++i) {
    at[i] = ws;
    ws += n[i];
  }
  return Workspace{at[0], at[1], at[2], at[3], at[4], at[5], at[6]};
}

template <typename T>
cudaError_t launch(const BwdParams& p, int vec, cudaStream_t stream) {
  const int B = p.B;
  const int E = p.E;
  const int E4 = align4(E);
  const Workspace ws = carve(p.ws, B, E, p.plans);
  cudaError_t err;

  // the GEMM operands d_out and W_vo: rows of E4 floats
  const float* dout = p.dout;
  const float* wvo = p.wvo;
  if (E % 4 != 0) {
    if ((err = pad_rows(p.dout, B, E, E4, ws.dout, stream)) != cudaSuccess)
      return err;
    if ((err = pad_rows(p.wvo, E, E, E4, ws.wvo, stream)) != cudaSuccess)
      return err;
    dout = ws.dout;
    wvo = ws.wvo;
  }

  // R1: a and mix, no side outputs
  FwdRows r1{};
  r1.kv = p.kv;
  r1.scales = p.scales;
  r1.u = p.u;
  r1.c = p.c;
  r1.pad = p.pad;
  r1.a = ws.a;
  r1.mix = ws.mix;
  r1.B = B;
  r1.M = p.M;
  r1.E = E;
  r1.H = 1;
  r1.ld = E4;
  r1.vec = vec;
  rows_fwd_kernel<T, false, 1>
      <<<warp_blocks(B), kThreads, 0, stream>>>(r1, MaskParams{});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // G2: d_mix[b, k] = sum_n d_out[b, n] W_vo[n, k]: W_vo k-major
  gemm::GemmArgs g2{};
  g2.A = dout;
  g2.lda = E4;
  g2.W = wvo;
  g2.ldw = E4;
  g2.C = ws.dmix;
  g2.ldc = E4;
  g2.rows = B;
  g2.N = E;
  g2.K = E;
  g2.groups = 1;
  err = gemm::gemm<false, true>(p.precision, g2, gemm::EpiAffine{},
                                p.plans[0], ws.scr, stream);
  if (err != cudaSuccess) return err;

  // R2 with the weights' cotangent
  BwdRows r2{};
  r2.kv = p.kv;
  r2.scales = p.scales;
  r2.u = p.u;
  r2.a = ws.a;
  r2.dmix = ws.dmix;
  r2.dout = dout;
  r2.dw = p.dw;
  r2.dkv = p.dkv;
  r2.part = ws.part;
  r2.B = B;
  r2.M = p.M;
  r2.E = E;
  r2.ld = E4;
  r2.vec = vec;
  rows_bwd_kernel<T, false><<<warp_blocks(B), kThreads, 0, stream>>>(r2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // G3: G[i, j] = sum_b d_out[b, i] mix[b, j] (A transposed, K = B)
  gemm::GemmArgs g3{};
  g3.A = dout;
  g3.lda = E4;
  g3.W = ws.mix;
  g3.ldw = E4;
  g3.C = p.g;
  g3.ldc = E;
  g3.rows = E;
  g3.N = E;
  g3.K = B;
  g3.groups = 1;
  err = gemm::gemm<true, true>(p.precision, g3, gemm::EpiAffine{},
                               p.plans[1], ws.scr, stream);
  if (err != cudaSuccess) return err;
  return part_sum(ws.part, warp_blocks(B), part_cols(E, 0, false), p.sums,
                  stream);
}

}  // namespace

extern "C" {

// Floats of workspace aecf_shared_query_bwd needs for (B, E) under the
// products' plans (BwdParams.plans; null: the default plans).
size_t aecf_shared_query_bwd_workspace(int B, int E,
                                       const gemm::GemmTile* plans) {
  const gemm::GemmTile none[kProducts] = {};
  size_t n[kPieces];
  workspace_sizes(B, E, plans != nullptr ? plans : none, n);
  size_t total = 0;
  for (int i = 0; i < kPieces; ++i) total += n[i];
  return total;
}

// The plans the chain's products run at (B, E) when asked for `plans`
// (null: the default plans): bn, splits and k_per_split for each product
// in launch order into `out` (3 x 2 ints).  Returns the number of
// products, or minus the cudaError_t of a plan the chain refuses.
int aecf_shared_query_bwd_plans(int B, int E, const gemm::GemmTile* plans,
                                int* out) {
  gemm::Product q[kProducts];
  const int n = products(B, E, q);
  const cudaError_t err = gemm::report_plans(q, plans, n, out);
  return err != cudaSuccess ? -(int)err : n;
}

// Returns a cudaError_t; 0 means every launch was accepted.  Pointers are
// contiguous device buffers as listed in BwdParams, dout, wvo and ws 16-byte
// aligned; int8 needs scales and takes no dkv.  The plans are checked
// before anything launches.
int aecf_shared_query_bwd(const BwdParams* p, void* stream) {
  if (p->B < 1 || p->M < 1 || p->M > kMaxM || p->E < 1 ||
      (p->kv_dtype == kKvInt8 && (p->scales == nullptr || p->dkv != nullptr)) ||
      (p->precision != gemm::kHighest && p->precision != gemm::kTf32) ||
      !gemm::aligned16(p->dout) || !gemm::aligned16(p->wvo) ||
      !gemm::aligned16(p->ws)) {
    return (int)cudaErrorInvalidValue;
  }
  int plan[3 * kProducts];
  if (aecf_shared_query_bwd_plans(p->B, p->E, p->plans, plan) < 0)
    return (int)cudaErrorInvalidValue;
  // the four-feature accesses of kv, u and d_kv (16 bytes f32, 8 bf16, 4
  // int8)
  const uintptr_t size =
      p->kv_dtype == kKvF32 ? 16 : p->kv_dtype == kKvBf16 ? 8 : 4;
  const int vec = p->E % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(p->kv) % size == 0 &&
                  reinterpret_cast<uintptr_t>(p->dkv) % size == 0 &&
                  gemm::aligned16(p->u);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->kv_dtype) {
    case kKvF32: return (int)launch<float>(*p, vec, s);
    case kKvBf16: return (int)launch<__nv_bfloat16>(*p, vec, s);
    case kKvInt8: return (int)launch<int8_t>(*p, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
