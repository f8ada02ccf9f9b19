// Shared-query fusion-pool forward (eval and training) for Hopper
// (sm_90a): a chain of kernels behind the one aecf_shared_query_fwd call.
//
// Replaces aecf_tpu/kernels/shared_query.py::_shared_kernel (f32/bf16
// features) and ::_shared_kernel_q8 (int8 features with per-(row,
// modality) f32 scales, dequantized per element by KvRow): _shared_body
// -> _weights_entropy_mask (with the training branch, _mask_and_renorm),
// then the context GEMM.  Per batch row b, with the per-call vectors u
// (H, E), c (H,) and the fused context weights computed outside the chain:
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
// What bounds it on the H100: the context products, 2 B E^2 operations at
// H == 1 and 4 B E^2 at H > 1, on the SIMT f32 pipes at precision
// 'highest' (IEEE f32, which the tensor cores cannot give) or the TF32
// tensor cores at 'default', and at small B the kv stream and the weights'
// bytes.  A kernel that runs those products 16 batch rows a block loads
// each weight for 16 FMAs and, split over column tiles, reads the row chain
// again for every tile.  The chain runs the row-local phases once, a warp a
// row, and the products over the whole batch in gemm_f32.cuh (128-row
// tiles, a 3-stage cp.async ring, the weights read as stored, split K where
// the tiles leave SMs idle); nothing stays resident in shared memory:
//
//   R   a warp a row (pool_rows.cuh rows_fwd_kernel): scores, softmax (the
//       one-pass step's row_softmax up to two heads: the same masks bit for
//       bit; row_softmax_heads[4] above), head mean, entropy, the eval
//       passthrough or the training mask, MIX[b, h, :] = sum_m a_h[m] kv[b,
//       m] with the unmasked a_h
//   H == 1:  G1  out = MIX W_vo^T + b_ctx
//   H  > 1:  G2  CTX[:, h Dh:(h+1) Dh] = MIX[:, h, :] Wv_h^T + bv_h, a
//                grouped GEMM over the heads (N = Dh)
//            G3  out = CTX Wo^T + bo
//
// Widths: any H dividing E (E <= 1024 at the wrapper, the gate's cap), any
// E: MIX and CTX rows are E4 = 4 ceil(E / 4) floats apart in the workspace,
// and at E % 4 != 0 the (E, E) weights are first copied to rows of E4
// floats (pad_rows), for the GEMM's 16-byte chunks.  Rows past B are masked
// in the kernels; nothing is padded on the host.  int8 changes only R, so
// the int8 forward equals the f32 forward on q.float() * s bit for bit.  No
// atomics: a run is bit for bit repeatable.
//
// Plans: `plans` gives the products' column tiles and K splits in launch
// order (G1 at H == 1; G2, G3 above; gemm_f32.cuh GemmTile, {0, 0} the
// default; kernels/tiles.py chooses them), and the workspace follows them.
//
// Precision (gemm::Precision): kHighest runs the products in IEEE f32
// FMAs (gemm_f32.cuh); kTf32, precision='default', on the TF32 tensor
// cores (gemm_tf32.cuh), as the JAX kernel's dots at mxu_precision = None.
// R is f32 at both, as JAX's VPU code is, and the int8 forward still equals
// the f32 forward on q.float() * s bit for bit at both.
//
// Numerics: f32 outside the TF32 products.  Entropy uses logf on
// max(w, 1e-38) — a subnormal floor — so this file must be built without
// --use_fast_math and without -ftz=true.

#include "gemm_f32.cuh"
#include "gemm_tf32.cuh"
#include "pool_rows.cuh"

using namespace aecf;

namespace {

struct FwdCall {
  const void* kv;
  const float* scales;
  const float* u;
  const float* c;
  const float* pad;
  const float* wctx;  // W_vo (H == 1) or Wv (H > 1), (E, E)
  const float* wo;    // (E, E), H > 1
  const float* bctx;  // b_ctx (H == 1) or bv (H > 1), (E,)
  const float* bo;    // (E,), H > 1
  float* out;
  float* w;
  float* mw;
  float* ent;
  float* rate;
  float* ws;
  int B, M, E, H;
  int precision;                // gemm::Precision
  const gemm::GemmTile* plans;  // one a product, in launch order
};

struct Workspace {
  float* mix;      // B x H x E4
  float* ctx;      // B x E4 (H > 1)
  float* a;        // B x H x M: the heads' weights (H > kMaxH)
  float* wctx;     // E x E4: wctx in rows of E4 (E % 4 != 0)
  float* wo;       // E x E4: wo in rows of E4 (E % 4 != 0, H > 1)
  float* scratch;  // the products' scratch (gemm::product_scratch)
};

constexpr int kPieces = 6;

// The chain's products in launch order: the out GEMM at H == 1; the
// grouped context GEMM and the output GEMM above (kernels/_plan.py lists
// the same).
constexpr int kProducts = 2;
int products(int B, int E, int H, gemm::Product q[kProducts]) {
  const gemm::Product out{B, E, E, 1, false, true};
  if (H == 1) {
    q[0] = out;
    return 1;
  }
  q[0] = {B, E / H, E, H, false, true};
  q[1] = out;
  return 2;
}

// Floats of each workspace piece, in carve order, each rounded up to 64
// (256-byte aligned starts).
void workspace_sizes(int B, int M, int E, int H, const gemm::GemmTile* t,
                     size_t n[kPieces]) {
  const size_t E4 = align4(E);
  const bool ragged = E % 4 != 0;
  n[0] = (size_t)B * H * E4;
  n[1] = H > 1 ? (size_t)B * E4 : 0;
  n[2] = H > kMaxH ? (size_t)B * H * M : 0;
  n[3] = ragged ? E * E4 : 0;
  n[4] = ragged && H > 1 ? E * E4 : 0;
  gemm::Product q[kProducts];
  n[5] = gemm::product_scratch(q, t, products(B, E, H, q));
  for (int i = 0; i < kPieces; ++i) n[i] = (n[i] + 63) & ~(size_t)63;
}

Workspace carve(float* ws, int B, int M, int E, int H,
                const gemm::GemmTile* t) {
  size_t n[kPieces];
  workspace_sizes(B, M, E, H, t, n);
  float* at[kPieces];
  for (int i = 0; i < kPieces; ++i) {
    at[i] = ws;
    ws += n[i];
  }
  return Workspace{at[0], at[1], at[2], at[3], at[4], at[5]};
}

// Whether kv's rows take the four-feature accesses: E % 4 == 0 and kv
// aligned to 16 (f32), 8 (bf16) or 4 (int8) bytes, u to 16.
bool kv_vec(const void* kv, int kv_dtype, const float* u, int E) {
  const uintptr_t size = kv_dtype == kKvF32 ? 16 : kv_dtype == kKvBf16 ? 8 : 4;
  return E % 4 == 0 && reinterpret_cast<uintptr_t>(kv) % size == 0 &&
         gemm::aligned16(u);
}

template <typename T, bool kTraining>
cudaError_t launch(const FwdCall& p, int vec, const MaskParams& mp,
                   cudaStream_t stream) {
  const int B = p.B;
  const int E = p.E;
  const int H = p.H;
  const int E4 = align4(E);
  const Workspace ws = carve(p.ws, B, p.M, E, H, p.plans);
  cudaError_t err;

  // the weights as GEMM operands: rows of E4 floats
  const float* wctx = p.wctx;
  const float* wo = p.wo;
  if (E % 4 != 0) {
    if ((err = pad_rows(p.wctx, E, E, E4, ws.wctx, stream)) != cudaSuccess)
      return err;
    wctx = ws.wctx;
    if (H > 1) {
      if ((err = pad_rows(p.wo, E, E, E4, ws.wo, stream)) != cudaSuccess)
        return err;
      wo = ws.wo;
    }
  }

  // R
  FwdRows r{};
  r.kv = p.kv;
  r.scales = p.scales;
  r.u = p.u;
  r.c = p.c;
  r.pad = p.pad;
  r.w = p.w;
  r.mw = p.mw;
  r.ent = p.ent;
  r.rate = p.rate;
  r.a = H > kMaxH ? ws.a : nullptr;
  r.mix = ws.mix;
  r.B = B;
  r.M = p.M;
  r.E = E;
  r.H = H;
  r.ld = E4;
  r.vec = vec;
  const auto rows = H == 1   ? rows_fwd_kernel<T, kTraining, 1>
                    : H == 2 ? rows_fwd_kernel<T, kTraining, 2>
                             : rows_fwd_kernel<T, kTraining, 0>;
  rows<<<warp_blocks(B), kThreads, 0, stream>>>(r, mp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // out[b, n] = sum_k A[b, k] W[n, k] + bias[n]: W_vo and MIX (H == 1), or
  // Wo and CTX (H > 1), W n-major
  gemm::GemmArgs go{};
  go.lda = E4;
  go.ldw = E4;
  go.C = p.out;
  go.ldc = E;
  go.rows = B;
  go.N = E;
  go.K = E;
  go.groups = 1;
  gemm::EpiAffine eo;
  if (H == 1) {
    go.A = ws.mix;
    go.W = wctx;
    eo.bias = p.bctx;
    return gemm::gemm<false, false>(p.precision, go, eo, p.plans[0],
                                    ws.scratch, stream);
  }

  // G2: CTX[b, h Dh + n] = sum_k MIX[b, h, k] Wv[h Dh + n, k] + bv[h Dh + n]
  const int Dh = E / H;
  gemm::GemmArgs gc{};
  gc.A = ws.mix;
  gc.lda = (long long)H * E4;
  gc.a_gstride = E4;
  gc.W = wctx;
  gc.ldw = E4;
  gc.w_gstride = (long long)Dh * E4;
  gc.C = ws.ctx;
  gc.ldc = E4;
  gc.c_gstride = Dh;
  gc.rows = B;
  gc.N = Dh;
  gc.K = E;
  gc.groups = H;
  gemm::EpiAffine ec;
  ec.bias = p.bctx;
  ec.bias_gstride = Dh;
  if ((err = gemm::gemm<false, false>(p.precision, gc, ec, p.plans[0],
                                      ws.scratch, stream)) != cudaSuccess)
    return err;

  // G3: out = CTX Wo^T + bo
  go.A = ws.ctx;
  go.W = wo;
  eo.bias = p.bo;
  return gemm::gemm<false, false>(p.precision, go, eo, p.plans[1], ws.scratch,
                                  stream);
}

}  // namespace

extern "C" {

// Floats of workspace one call needs under the products' plans (null: the
// default plans).
size_t aecf_shared_query_fwd_workspace(int B, int M, int E, int H,
                                       const gemm::GemmTile* plans) {
  const gemm::GemmTile none[kProducts] = {};
  size_t n[kPieces];
  workspace_sizes(B, M, E, H, plans != nullptr ? plans : none, n);
  size_t total = 0;
  for (int i = 0; i < kPieces; ++i) total += n[i];
  return total;
}

// The plans the chain's products run at (B, E, H) when asked for `plans`
// (null: the default plans): bn, splits and k_per_split for each product
// in launch order into `out` (3 x 2 ints).  Returns the number of
// products, or minus the cudaError_t of a plan the chain refuses.
int aecf_shared_query_fwd_plans(int B, int E, int H,
                                const gemm::GemmTile* plans, int* out) {
  gemm::Product q[kProducts];
  const int n = products(B, E, H, q);
  const cudaError_t err = gemm::report_plans(q, plans, n, out);
  return err != cudaSuccess ? -(int)err : n;
}

// Returns a cudaError_t; 0 means every launch was accepted.  kv is (B, M,
// E) f32 (kv_dtype = 0), bf16 (1) or int8 (2, with scales (B, M) f32;
// scales is read for int8 only); pad may be null (no padding); wo and bo
// are read only when H > 1.  All other pointers are f32 device buffers of
// the shapes in the header comment, contiguous; wctx, wo and ws 16-byte
// aligned; ws holds aecf_shared_query_fwd_workspace(B, M, E, H, plans)
// floats; plans (one a product, or null: the default plans) are checked
// before anything launches.  training = 0 is the eval branch (seed words,
// mask_prob and min_active unread); precision is a gemm::Precision.
int aecf_shared_query_fwd(const void* kv, int kv_dtype, const float* scales,
                          const float* u, const float* c, const float* pad,
                          const float* wctx, const float* wo,
                          const float* bctx, const float* bo, float* out,
                          float* w, float* mw, float* ent, float* rate,
                          float* ws, int B, int M, int E, int H,
                          float max_entropy, int training, unsigned int seed0,
                          unsigned int seed1, float mask_prob, int min_active,
                          int precision, const gemm::GemmTile* plans,
                          void* stream) {
  if (B < 1 || M < 1 || M > kMaxM || H < 1 || E < 1 || E % H != 0 ||
      (kv_dtype == kKvInt8 && scales == nullptr) ||
      (H > 1 && (wo == nullptr || bo == nullptr)) || !gemm::aligned16(wctx) ||
      (H > 1 && !gemm::aligned16(wo)) || !gemm::aligned16(ws) ||
      (precision != gemm::kHighest && precision != gemm::kTf32)) {
    return (int)cudaErrorInvalidValue;
  }
  const gemm::GemmTile none[kProducts] = {};
  if (plans == nullptr) plans = none;
  int plan[3 * kProducts];
  if (aecf_shared_query_fwd_plans(B, E, H, plans, plan) < 0)
    return (int)cudaErrorInvalidValue;
  MaskParams mp;
  mp.max_entropy = max_entropy;
  mp.mask_prob = mask_prob;
  mp.min_active = min_active;
  mp.training = training;
  mp.seed0 = seed0;
  mp.seed1 = seed1;
  const FwdCall p{kv, scales, u,  c,  pad, wctx, wo, bctx,      bo,   out,
                  w,  mw,     ent, rate, ws, B, M, E, H, precision, plans};
  const int vec = kv_vec(kv, kv_dtype, u, E);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // eval and training are separate instances (see row_side_outputs)
  switch (kv_dtype) {
    case kKvF32:
      return (int)(training ? launch<float, true>(p, vec, mp, s)
                            : launch<float, false>(p, vec, mp, s));
    case kKvBf16:
      return (int)(training ? launch<__nv_bfloat16, true>(p, vec, mp, s)
                            : launch<__nv_bfloat16, false>(p, vec, mp, s));
    case kKvInt8:
      return (int)(training ? launch<int8_t, true>(p, vec, mp, s)
                            : launch<int8_t, false>(p, vec, mp, s));
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
