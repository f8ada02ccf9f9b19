// Per-row-query fusion-pool forward (eval and training) for Hopper
// (sm_90a): a chain of kernels behind the one aecf_fused_pool_fwd call.
//
// Replaces aecf_tpu/kernels/fused_pool.py::_fusion_kernel (launched by
// _forward_pallas under fused_fusion_pool): the pool of the README's
// Quick start, whose query is a (B, 1, E) tensor, one row per sample.  Per
// batch row b, with scale = Dh^-1/2:
//
//   qp      = q[b] Wq^T + bq
//   u_h     = scale Wk_h^T qp_h;   c_h = scale qp_h . bk_h
//   s_h[m]  = kv[b, m] . u_h + c_h + pad[b, m]    (pad: 0 or -1e30)
//           = scale qp_h . (kv[b, m] Wk^T + bk)_h, the TPU kernel's score
//   a_h     = softmax_m(s_h);  w = mean_h(a_h)
//   ent     = clip(-sum_m w log(max(w, 1e-38)) [w > 0], 0, ln M)
//   eval:     mw = w;  rate = 0
//   training: Philox keep-mask, min_active, renorm (pool_common.cuh)
//   ctx_h   = (sum_m a_h[m] kv[b, m]) Wv_h^T + bv_h   (quirk Q1: unmasked;
//             the rows of a_h sum to 1, so bv passes through)
//   out     = ctx Wo^T + bo
//
// What bounds it on the H100: the E x E products — qp, u (over the
// heads), ctx and out, 8 B E^2 operations, where the TPU kernel projects K
// and V for every (b, m) and does 4 (M + 1) B E^2 — on the SIMT f32 pipes
// (the pool runs IEEE f32 whatever its precision setting, as the TPU kernel
// runs HIGHEST).  With the README's expanded query (row stride 0) qp and u
// are one row's: 4 B E^2 + 4 E^2, and the chain computes them once.  The
// products run over the whole batch in gemm_f32.cuh (128-row tiles, a
// 3-stage cp.async ring, the weights read as stored); the row-local chain
// runs a warp a row; no tile of the batch stays resident in shared memory.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): the Quick
// start (B = 4096, M = 3, E = 512, training) 0.206 ms with the expanded
// query (bound 0.064 ms by operations) and 0.306 ms with distinct query
// rows (bound 0.129); B = 8192, M = 4, E = 1024, H = 2, eval, 1.204 ms
// (bound 0.517).
//
//   Q0  (bf16 or unaligned query only) the query rows in f32
//   G1  QP = q Wq^T + bq, for one row when the query's row stride is 0
//   G2  U[b, h, :] = scale QP[b, h Dh:(h+1) Dh] Wk[h Dh:(h+1) Dh, :], a
//       grouped GEMM over the heads with K = Dh (one row when stride 0)
//   R   a warp a row: c_h, every head's scores against its U row and
//       softmax (row_softmax_heads4, float4 reads), head mean, entropy,
//       eval passthrough or training mask (row_side_outputs), MIX[b, h, :]
//       = sum_m a_h[m] kv[b, m] with the unmasked a_h (quirk Q1)
//   G3  CTX[:, h Dh:(h+1) Dh] = MIX[:, h, :] Wv_h^T + bv_h, grouped, N = Dh
//   G4  out = CTX Wo^T + bo
//
// QP, U, MIX and CTX live in a workspace the wrapper allocates
// (aecf_fused_pool_fwd_workspace).  Any H with E a multiple of 4 H runs;
// the query and kv may be bf16.  Rows past B are masked in the kernels and
// nothing is padded on the host.
//
// Plans: FusedParams.plans gives G1..G4's column tiles and K splits
// (gemm_f32.cuh GemmTile, {0, 0} the default; kernels/tiles.py chooses
// them), and the workspace follows them.
//
// Numerics: f32 FMAs throughout.  Scores are kv . (Wk^T qp) where the
// plain version computes (kv Wk^T + bk) . qp: the sums run in another
// order, ~1e-6 apart.  Built without fast-math and without flush-to-zero
// (the entropy's subnormal floor).

#include "gemm_f32.cuh"
#include "pool_common.cuh"

using namespace aecf;
using gemm::cdiv;

// Also declared, field for field, by kernels/fused_pool.py (ctypes).
struct FusedParams {
  const void* q;     // (B, E) f32 or bf16, rows ldq elements apart
  const void* kv;    // (B, M, E) f32 or bf16, contiguous
  const float* pad;  // (B, M) additive score bias, or null
  const float* wq;   // (E, E) as stored (row = output feature), and so on
  const float* bq;   // (E,)
  const float* wk;   // (E, E)
  const float* bk;   // (E,)
  const float* wv;   // (E, E)
  const float* bv;   // (E,)
  const float* wo;   // (E, E)
  const float* bo;   // (E,)
  float* out;        // (B, E)
  float* w;          // (B, M)
  float* mw;         // (B, M)
  float* ent;        // (B,)
  float* rate;       // (B,)
  float* ws;         // aecf_fused_pool_fwd_workspace floats
  long long ldq;     // query row stride in elements (0: one shared row)
  int B, M, E, H, q_bf16, kv_bf16, training, min_active;
  unsigned int seed0, seed1;
  float max_entropy, mask_prob, scale;
  gemm::GemmTile plans[4];  // G1 .. G4; {0, 0}: gemm_plan's
};

namespace {

struct Workspace {
  float* q;        // qrows x E: the query in f32 (Q0)
  float* qp;       // qrows x E
  float* u;        // qrows x H x E
  float* mix;      // B x H x E
  float* ctx;      // B x E
  float* scratch;  // split partials, the largest of G1 .. G4's
};

constexpr int kPieces = 6;

// The chain's products in launch order: G1 QP, G2 U, G3 CTX, G4 out
// (kernels/_plan.py lists the same).  qrows: 1 for a stride-0 query, else
// B.
constexpr int kProducts = 4;
int products(int B, int E, int H, int qrows, gemm::Product q[kProducts]) {
  const int Dh = E / H;
  q[0] = {qrows, E, E, 1, false, true};
  q[1] = {qrows, E, Dh, H, true, true};
  q[2] = {B, Dh, E, H, false, true};
  q[3] = {B, E, E, 1, false, true};
  return kProducts;
}

// Floats of each workspace piece, in carve order, each rounded up to 64
// (256-byte aligned starts).  qrows: 1 for a stride-0 query, else B.
void workspace_sizes(int B, int E, int H, int qrows, const gemm::GemmTile* t,
                     size_t n[kPieces]) {
  n[0] = (size_t)qrows * E;
  n[1] = (size_t)qrows * E;
  n[2] = (size_t)qrows * H * E;
  n[3] = (size_t)B * H * E;
  n[4] = (size_t)B * E;
  gemm::Product q[kProducts];
  n[5] = gemm::scratch_floats(q, t, products(B, E, H, qrows, q));
  for (int i = 0; i < kPieces; ++i) n[i] = (n[i] + 63) & ~(size_t)63;
}

Workspace carve(float* ws, int B, int E, int H, int qrows,
                const gemm::GemmTile* t) {
  size_t n[kPieces];
  workspace_sizes(B, E, H, qrows, t, n);
  float* at[kPieces];
  for (int i = 0; i < kPieces; ++i) {
    at[i] = ws;
    ws += n[i];
  }
  return Workspace{at[0], at[1], at[2], at[3], at[4], at[5]};
}

// Q0: dst[r, e] = f32(q[r ldq + e]) for the qrows rows.
__global__ void query_f32_kernel(FusedParams p, float* __restrict__ dst,
                                 int qrows) {
  const size_t n = (size_t)qrows * p.E;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t off = (i / p.E) * p.ldq + i % p.E;
  dst[i] = p.q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(p.q)[off])
                    : static_cast<const float*>(p.q)[off];
}

// R: a warp a row.  Shared memory: per warp the heads' weights (H x M) and
// offsets c_h (H).  Two blocks an SM: at three (80 registers) the bf16
// eval instance spilled.
template <typename T, bool kTraining>
AECF_ROW_KERNEL(2) fused_rows_kernel(FusedParams p, Workspace ws,
                                     MaskParams mp) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= p.B) return;  // warp-uniform; no block barrier below
  const int E = p.E;
  const int M = p.M;
  const int H = p.H;
  const int Dh = E / H;
  float* a_row = smem + warp * (H * M + H);  // H x M
  float* c_w = a_row + H * M;                // H
  const int qb = p.ldq == 0 ? 0 : b;
  const float* qp = ws.qp + (size_t)qb * E;
  const float* u = ws.u + (size_t)qb * H * E;
  // c_h = scale qp_h . bk_h (Dh a multiple of 4)
  for (int h = 0; h < H; ++h) {
    float cd = 0.f;
    for (int d = 4 * lane; d < Dh; d += 128)
      cd = dot4(load4(qp + h * Dh + d), load4(p.bk + h * Dh + d), cd);
    cd = warp_sum(cd) * p.scale;
    if (lane == 0) c_w[h] = cd;
  }
  __syncwarp();
  const T* kv = static_cast<const T*>(p.kv);
  const KvRow<T> kvr(kv, nullptr, b, M, E);
  float w[kMaxM];
  row_softmax_heads4(kvr, u, c_w,
                     p.pad != nullptr ? p.pad + (size_t)b * M : nullptr, M,
                     E, H, a_row, w);
  row_side_outputs<kTraining>(w, b, M, mp, p.w, p.mw, p.ent, p.rate);
  // MIX[b, h, e] = sum_m a_h[m] kv[b, m, e], four features a lane a pass
  for (int h = 0; h < H; ++h) {
    float a[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) a[m] = m < M ? a_row[h * M + m] : 0.f;
    float* mix = ws.mix + ((size_t)b * H + h) * E;
    for (int j = 4 * lane; j < E; j += 128) {
      float4 acc = kvr.at4(0, j);
      acc = make_float4(a[0] * acc.x, a[0] * acc.y, a[0] * acc.z,
                        a[0] * acc.w);
#pragma unroll
      for (int m = 1; m < kMaxM; ++m)
        if (m < M) acc = axpy4(a[m], kvr.at4(m, j), acc);
      store4(mix + j, acc);
    }
  }
}

size_t rows_smem_bytes(int H, int M) {
  return sizeof(float) * kWarps * ((size_t)H * M + H);
}

template <typename T, bool kTraining>
cudaError_t launch(const FusedParams& p, cudaStream_t stream) {
  const int B = p.B;
  const int E = p.E;
  const int H = p.H;
  const int Dh = E / H;
  const int qrows = p.ldq == 0 ? 1 : B;
  const Workspace ws = carve(p.ws, B, E, H, qrows, p.plans);
  cudaError_t err;

  // the query as GEMM rows: in place when f32 with 16-byte aligned rows
  const float* qa = static_cast<const float*>(p.q);
  long long lda = p.ldq;
  if (p.q_bf16 || p.ldq % 4 != 0 || !gemm::aligned16(p.q)) {
    const size_t n = (size_t)qrows * E;
    query_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        p, ws.q, qrows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    qa = ws.q;
    lda = E;
  }

  // G1: QP[r, n] = sum_k q[r, k] Wq[n, k] + bq[n]
  gemm::GemmArgs g1{};
  g1.A = qa;
  g1.lda = lda;
  g1.W = p.wq;
  g1.ldw = E;
  g1.C = ws.qp;
  g1.ldc = E;
  g1.rows = qrows;
  g1.N = E;
  g1.K = E;
  g1.groups = 1;
  gemm::EpiAffine e1;
  e1.bias = p.bq;
  if ((err = gemm::gemm_f32<false, false>(g1, e1, p.plans[0], ws.scratch,
                                          stream)) !=
      cudaSuccess)
    return err;

  // G2: U[r, h, e] = scale sum_d QP[r, h Dh + d] Wk[h Dh + d, e]
  gemm::GemmArgs g2{};
  g2.A = ws.qp;
  g2.lda = E;
  g2.a_gstride = Dh;
  g2.W = p.wk;
  g2.ldw = E;
  g2.w_gstride = (long long)Dh * E;
  g2.C = ws.u;
  g2.ldc = (long long)H * E;
  g2.c_gstride = E;
  g2.rows = qrows;
  g2.N = E;
  g2.K = Dh;
  g2.groups = H;
  gemm::EpiAffine e2;
  e2.scale = p.scale;
  if ((err = gemm::gemm_f32<false, true>(g2, e2, p.plans[1], ws.scratch,
                                          stream)) !=
      cudaSuccess)
    return err;

  MaskParams mp;
  mp.max_entropy = p.max_entropy;
  mp.mask_prob = p.mask_prob;
  mp.min_active = p.min_active;
  mp.training = p.training;
  mp.seed0 = p.seed0;
  mp.seed1 = p.seed1;
  const size_t smem = rows_smem_bytes(H, p.M);
  if ((err = allow_smem(fused_rows_kernel<T, kTraining>, smem)) != cudaSuccess)
    return err;
  fused_rows_kernel<T, kTraining>
      <<<cdiv(B, kWarps), kThreads, smem, stream>>>(p, ws, mp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // G3: CTX[b, h Dh + n] = sum_k MIX[b, h, k] Wv[h Dh + n, k] + bv[h Dh + n]
  gemm::GemmArgs g3{};
  g3.A = ws.mix;
  g3.lda = (long long)H * E;
  g3.a_gstride = E;
  g3.W = p.wv;
  g3.ldw = E;
  g3.w_gstride = (long long)Dh * E;
  g3.C = ws.ctx;
  g3.ldc = E;
  g3.c_gstride = Dh;
  g3.rows = B;
  g3.N = Dh;
  g3.K = E;
  g3.groups = H;
  gemm::EpiAffine e3;
  e3.bias = p.bv;
  e3.bias_gstride = Dh;
  if ((err = gemm::gemm_f32<false, false>(g3, e3, p.plans[2], ws.scratch,
                                          stream)) !=
      cudaSuccess)
    return err;

  // G4: out[b, n] = sum_k CTX[b, k] Wo[n, k] + bo[n]
  gemm::GemmArgs g4{};
  g4.A = ws.ctx;
  g4.lda = E;
  g4.W = p.wo;
  g4.ldw = E;
  g4.C = p.out;
  g4.ldc = E;
  g4.rows = B;
  g4.N = E;
  g4.K = E;
  g4.groups = 1;
  gemm::EpiAffine e4;
  e4.bias = p.bo;
  return gemm::gemm_f32<false, false>(g4, e4, p.plans[3], ws.scratch, stream);
}

}  // namespace

extern "C" {

// Floats of workspace one call needs under the products' plans
// (FusedParams.plans; null: the default plans): shared_q = 1 for a query
// of row stride 0, else 0.
size_t aecf_fused_pool_fwd_workspace(int B, int E, int H, int shared_q,
                                     const gemm::GemmTile* plans) {
  const gemm::GemmTile none[kProducts] = {};
  size_t n[kPieces];
  workspace_sizes(B, E, H, shared_q ? 1 : B, plans != nullptr ? plans : none,
                  n);
  size_t total = 0;
  for (int i = 0; i < kPieces; ++i) total += n[i];
  return total;
}

// The most shared memory in bytes one block of the chain asks for at width
// E with H heads and M modalities.
size_t aecf_fused_pool_fwd_smem(int E, int H, int M) {
  (void)E;
  const size_t rows = rows_smem_bytes(H, M);
  return rows > gemm::kMaxSmemBytes ? rows : gemm::kMaxSmemBytes;
}

// The plans the chain's products run at (B, E, H; shared_q as above) when
// asked for `plans` (null: the default plans): bn, splits and k_per_split
// for each product in launch order into `out` (3 x 4 ints).  Returns the
// number of products, or minus the cudaError_t of a plan the chain
// refuses.
int aecf_fused_pool_fwd_plans(int B, int E, int H, int shared_q,
                              const gemm::GemmTile* plans, int* out) {
  gemm::Product q[kProducts];
  const int n = products(B, E, H, shared_q ? 1 : B, q);
  const cudaError_t err = gemm::report_plans(q, plans, n, out);
  return err != cudaSuccess ? -(int)err : n;
}

// Returns a cudaError_t; 0 means every launch was accepted.  Pointers are
// device buffers as listed in FusedParams (kv aligned to four features,
// the weights, out and ws to 16 bytes); any H with E a multiple of 4 H
// (the GEMMs read 16-byte chunks of each head's slice).  training = 0 is
// the eval branch (seed words, mask_prob and min_active unread).  The
// plans are checked before anything launches.
int aecf_fused_pool_fwd(const FusedParams* p, void* stream) {
  if (p->B < 1 || p->M < 1 || p->M > kMaxM || p->H < 1 || p->E < 1 ||
      p->E % (4 * p->H) != 0 || p->ldq < 0) {
    return (int)cudaErrorInvalidValue;
  }
  int plan[3 * kProducts];
  if (aecf_fused_pool_fwd_plans(p->B, p->E, p->H, p->ldq == 0, p->plans,
                                plan) < 0)
    return (int)cudaErrorInvalidValue;
  const void* aligned[] = {p->wq, p->wk, p->wv, p->wo, p->bk, p->out, p->ws};
  for (const void* ptr : aligned)
    if (!gemm::aligned16(ptr)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(p->kv) % (p->kv_bf16 ? 8 : 16) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p->kv_bf16)
    err = p->training ? launch<__nv_bfloat16, true>(*p, s)
                      : launch<__nv_bfloat16, false>(*p, s);
  else
    err = p->training ? launch<float, true>(*p, s) : launch<float, false>(*p, s);
  return (int)err;
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
