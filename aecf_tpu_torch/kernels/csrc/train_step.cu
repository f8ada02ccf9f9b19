// One-pass fused train step of the H == 1 shared-query pool, for Hopper
// (sm_90a): a chain of kernels behind the one aecf_train_step call.
//
// Replaces aecf_tpu/kernels/train_step.py::_step_kernel (launched by
// fused_pool_train_step), f32/bf16 features and its quantized=True branch
// (int8 with per-(row, modality) scales, read through KvRow; frozen, so
// no d_kv).  With u (E), c, W_vo = Wo Wv and b_ctx computed outside:
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
// What bounds it on the H100: the three E x E products over the batch
// (out, d_mix, G: 6 B E^2 of the step's 6.67 GFLOP at the north star B =
// 4096, M = 3, E = 512, C = 14) on the SIMT f32 pipes at precision
// 'highest' — IEEE f32, which the tensor cores cannot give — with a bound
// of 0.0995 ms by operations; the kv stream (25 MB in f32) is the bytes.
// At 'default' the products run on the TF32 tensor cores (gemm_tf32.cuh),
// and the bytes bound the step.
// A kernel that runs the products 16 batch rows a block loads each weight
// for 16 FMAs and idles its FMA pipes while the weights load.  The chain
// runs them over the whole batch in gemm_f32.cuh (128-row tiles, 8 x 8 or
// 8 x 4 accumulators a thread, a 3-stage cp.async ring; W_vo read in its
// stored layout by both out and d_mix; G split over the batch) and the
// row-local phases in row kernels of their own.  Measured (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md section 6): 0.324 ms a call at the north star,
// 0.315 ms with int8 features; the three products run at 28-34 TFLOP/s,
// 0.7-0.9 of cuBLAS's SGEMM on the same operands.
//
//   R1  a warp a row: scores, softmax, entropy, mask chain, side outputs
//       (row_softmax, row_side_outputs: the training forward's masks, bit
//       for bit); a -> ws.a, mix -> ws.mix (pool_rows.cuh)
//   G1  out = mix W_vo^T + b_ctx; quadratic loss: the epilogue stores
//       d_out and a partial of sum out^2 per (row, column tile); head: out
//   HD  (head only) a warp a row: logits, BCE, d_logits, the row loss,
//       d_out = d_logits W_head^T (E C a row, C = 14; W_head staged in
//       shared memory a block)
//   G2  d_mix = d_out W_vo
//   R2  a warp a row: softmax backward and d_kv, then one row of partial
//       sums a block of eight rows (du, sum d_out, sum d_s, the loss from
//       the row partials, db_head; pool_rows.cuh, with the backward's R1
//       and R2 and the forward's R)
//   G3  G = d_out^T mix and dW_head = out^T d_logits (transposed A, split
//       over the batch, splits summed in order); then part_sum of the
//       partial rows into du | sum d_out | sum d_s | loss | db_head.
//
// kv is read by R1 and again by R2; int8 changes only R1 and R2 (the GEMMs
// see f32 mix, d_out and d_mix), so the int8 step equals the f32 step on
// q.float() * s bit for bit.  No atomics: a run is bit for bit repeatable.
// Rows past B write nothing and add nothing to any sum; nothing is padded
// on the host.
//
// Widths: any E (E <= 1024 at the wrapper), as the backward chain: the
// workspace rows (mix, out, d_out, d_mix) are E4 = 4 ceil(E / 4) floats
// apart, and at E % 4 != 0 W_vo is first copied to rows of E4 floats
// (pad_rows), for the GEMMs' 16-byte chunks.  kv is read four features a
// lane when E % 4 == 0 and kv, d_kv and u are aligned to those accesses,
// else one feature at a time (the same fmafs in the same order); so a kv
// that is a view into a staged batch (row_offset) needs no alignment.  At
// E % 4 == 0 with aligned operands the chain is the one it was before
// these widths: the same kernels, layouts and bits.
//
// Plans: StepParams.plans gives each product's column tile and K splits
// (gemm_f32.cuh, GemmTile; kernels/tiles.py chooses them); {0, 0} is the
// default, gemm_plan's.  G1's column tile sets the quadratic loss's row
// partials, so the workspace follows the plans (aecf_train_step_workspace
// takes them), and a plan the chain refuses fails the call before any
// launch.
//
// Seeds: the mask's two seed words come by value (seed0, seed1), or, when
// `seeds` is set, from device memory, read by R1: a CUDA graph of K steps
// (the training chunk) keeps a (K, 2) buffer that the host refills before
// each replay, so each replay draws its own steps' masks.
//
// Precision (StepParams.precision, gemm::Precision): kHighest runs every
// product in IEEE f32 FMAs; kTf32 ('default') runs each product the JAX
// kernel runs at mxu_precision with TF32 operands — G1, G2, G and dW_head
// on the TF32 instance of the GEMM block, and the head kernel's logits and
// d_out on out, W_head and d_logits rounded by cvt.rna.tf32 (C = 14 needs
// no tensor cores).  The row kernels (scores, softmax, entropy, masks,
// softmax backward, sums) are f32 at both, as JAX's VPU code is.
//
// Numerics: f32 throughout, apart from the TF32 operands above; built
// without fast-math or flush-to-zero (the entropy's subnormal floor).

#include "gemm_f32.cuh"
#include "gemm_tf32.cuh"
#include "pool_rows.cuh"

using namespace aecf;
using gemm::cdiv;

// Also declared, field for field, by kernels/train_step.py (ctypes).
struct StepParams {
  const void* kv;        // (B, M, E) f32, bf16 or int8 (kv_dtype)
  const float* scales;   // (B, M) dequant scales, int8 only
  const float* u;        // (E,)
  const float* c;        // (1,)
  const float* pad;      // (B, M) or null
  const float* wvo;      // (E, E), read as stored by both products
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
  const uint32_t* seeds;  // two seed words on the device, or null: seed0/1
  int B, M, E, C, kv_dtype, training, min_active;  // kv_dtype: KvDtype
  int precision;         // gemm::Precision: kHighest or kTf32 ('default')
  unsigned int seed0, seed1;
  float max_entropy, mask_prob, inv, two_inv;
  gemm::GemmTile plans[4];  // out, d_mix, G, dW_head; {0, 0}: gemm_plan's
};

namespace {

struct Workspace {
  float* a;        // B x M: the softmax weights
  float* mix;      // B x E4
  float* out;      // B x E4 (head)
  float* dout;     // B x E4
  float* dmix;     // B x E4
  float* sq;       // B x tiles: sum out^2 per (row, G1 column tile)
  float* lrow;     // B: row loss (head)
  float* dlogits;  // B x ldl (head)
  float* part;     // warp_blocks(B) x part_cols(E, C, true): R2's rows
  float* scr;      // the GEMMs' scratch (gemm::product_scratch)
  float* wvo;      // E x E4: W_vo in rows of E4 (E % 4 != 0)
  int sq_ld;       // G1's column tiles
};

// Row stride of d_logits: a multiple of 4 floats, for G3's 16-byte loads.
__host__ __device__ inline int logits_ld(int C) { return align4(C); }

// The chain's products in launch order: G1 out (split only with the head:
// the quadratic loss's epilogue keeps row partials), G2 d_mix, G and, with
// the head, dW_head (kernels/_plan.py lists the same).
constexpr int kProducts = 4;
int products(int B, int E, int C, gemm::Product q[kProducts]) {
  q[0] = {B, E, E, 1, false, C > 0};
  q[1] = {B, E, E, 1, true, true};
  q[2] = {E, E, B, 1, true, true};
  q[3] = {E, C, B, 1, true, true};
  return C > 0 ? 4 : 3;
}

// Column tiles of G1 under its plan (the quadratic loss's partials a row:
// G1's plan sets the loss's summation order).
inline int out_tiles(int B, int E, const gemm::GemmTile* t) {
  gemm::Product q[kProducts];
  products(B, E, 0, q);
  gemm::GemmPlan p;
  if (gemm::plan_of(q[0], t[0], &p) != cudaSuccess)
    p = gemm::gemm_plan(B, E, E, 1, false, false);  // refused at launch
  return cdiv(E, p.bn);
}

constexpr int kPieces = 11;

// Floats of scratch the chain's GEMMs need under their plans (split
// partials; at precision='default' also W rounded once a call), the
// largest of them: they run one after another on one stream.
size_t scratch_floats(int B, int E, int C, const gemm::GemmTile* t) {
  gemm::Product q[kProducts];
  return gemm::product_scratch(q, t, products(B, E, C, q));
}

// Floats of each workspace piece, in carve order; each rounded up to 64
// floats, so every piece starts 256-byte aligned.
void workspace_sizes(int B, int E, int C, const gemm::GemmTile* t,
                     size_t n[kPieces]) {
  const size_t E4 = align4(E);
  const size_t be = (size_t)B * E4;
  n[0] = (size_t)B * kMaxM;  // a: B x M used (the size takes no M)
  n[1] = be;
  n[2] = C > 0 ? be : 0;
  n[3] = be;
  n[4] = be;
  n[5] = C > 0 ? 0 : (size_t)B * out_tiles(B, E, t);
  n[6] = B;
  n[7] = C > 0 ? (size_t)B * logits_ld(C) : 0;
  n[8] = (size_t)warp_blocks(B) * part_cols(E, C, true);
  n[9] = scratch_floats(B, E, C, t);
  n[10] = E % 4 != 0 ? (size_t)E * E4 : 0;
  for (int i = 0; i < kPieces; ++i) n[i] = (n[i] + 63) & ~(size_t)63;
}

size_t workspace_floats(int B, int E, int C, const gemm::GemmTile* t) {
  size_t n[kPieces];
  workspace_sizes(B, E, C, t, n);
  size_t total = 0;
  for (int i = 0; i < kPieces; ++i) total += n[i];
  return total;
}

Workspace carve(float* ws, int B, int E, int C, const gemm::GemmTile* t) {
  size_t n[kPieces];
  workspace_sizes(B, E, C, t, n);
  float* at[kPieces];
  for (int i = 0; i < kPieces; ++i) {
    at[i] = ws;
    ws += n[i];
  }
  return Workspace{at[0], at[1], at[2], at[3], at[4], at[5],
                   at[6], at[7], at[8], at[9], at[10], out_tiles(B, E, t)};
}

MaskParams mask_params(const StepParams& p) {
  MaskParams mp;
  mp.max_entropy = p.max_entropy;
  mp.mask_prob = p.mask_prob;
  mp.min_active = p.min_active;
  mp.training = p.training;
  mp.seed0 = p.seed0;
  mp.seed1 = p.seed1;
  mp.seeds = p.seeds;
  return mp;
}

// HD (head only): a warp a row — logits = out W_head + b_head, BCE,
// d_logits and the row loss, then d_out = d_logits W_head^T.  Shared
// memory: W_head (E x C) when it fits in kHeadStageFloats (the lanes of a
// warp read 32 of its rows at a time, 56 bytes apart at C = 14: from device
// memory that is one cache line a lane), then the warp's C logits.  kTf32:
// the products' operands rounded to TF32 (out, W_head, d_logits), their
// sums f32 — the JAX kernel's logits and d_out dots at mxu_precision.
constexpr int kHeadChunk = 16;             // logits a lane accumulates at once
constexpr int kHeadStageFloats = 24576;    // 96 KB: E = 1024 at C = 24

template <bool kTf32>
__device__ __forceinline__ float head_operand(float x) {
  return kTf32 ? __uint_as_float(gemm::to_tf32(x)) : x;
}

template <bool kTf32>
__global__ void __launch_bounds__(kThreads)
    step_head_kernel(StepParams p, Workspace ws, int staged) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int E = p.E;
  const int E4 = align4(E);
  const int C = p.C;
  const float* W = p.head_w;
  float* lg = smem;
  if (staged) {
    float* Ws = smem;
    for (int i = threadIdx.x; i < E * C; i += kThreads)
      Ws[i] = head_operand<kTf32>(W[i]);
    W = Ws;
    lg = smem + E * C;
    __syncthreads();
  }
  lg += warp * C;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= p.B) return;  // warp-uniform; no block barrier below
  const float* o = ws.out + (size_t)b * E4;
  for (int c0 = 0; c0 < C; c0 += kHeadChunk) {
    float acc[kHeadChunk];
#pragma unroll
    for (int j = 0; j < kHeadChunk; ++j) acc[j] = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float x = head_operand<kTf32>(o[e]);
      const float* wr = W + (size_t)e * C + c0;
#pragma unroll
      for (int j = 0; j < kHeadChunk; ++j)
        if (c0 + j < C)
          acc[j] = fmaf(x, staged ? wr[j] : head_operand<kTf32>(wr[j]),
                        acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kHeadChunk; ++j) {
      const float v = warp_sum(acc[j]);
      if (lane == 0 && c0 + j < C) lg[c0 + j] = v + p.head_b[c0 + j];
    }
  }
  __syncwarp();
  const int ldl = logits_ld(C);
  float s = 0.f;
  for (int j = lane; j < C; j += 32) {
    const float x = lg[j];
    const float y = p.labels[(size_t)b * C + j];
    s += fmaxf(x, 0.f) - x * y + log1pf(expf(-fabsf(x)));
    const float d = (1.f / (1.f + expf(-x)) - y) * p.inv;
    ws.dlogits[(size_t)b * ldl + j] = d;
    lg[j] = head_operand<kTf32>(d);
  }
  s = warp_sum(s);
  if (lane == 0) ws.lrow[b] = s * p.inv;
  __syncwarp();
  // d_out[e] = sum_c d_logits[c] W_head[e, c]
  float* dout = ws.dout + (size_t)b * E4;
  for (int e = lane; e < E; e += 32) {
    const float* wr = W + (size_t)e * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c)
      acc = fmaf(lg[c], staged ? wr[c] : head_operand<kTf32>(wr[c]), acc);
    dout[e] = acc;
  }
}

bool head_staged(int E, int C) { return (size_t)E * C <= kHeadStageFloats; }

size_t head_smem_bytes(int E, int C) {
  return sizeof(float) *
         ((head_staged(E, C) ? (size_t)E * C : 0) + (size_t)kWarps * C);
}

template <typename T>
cudaError_t launch(const StepParams& p, int vec, cudaStream_t stream) {
  const int B = p.B;
  const int E = p.E;
  const int E4 = align4(E);
  const int C = p.head_w != nullptr ? p.C : 0;
  const Workspace ws = carve(p.ws, B, E, C, p.plans);
  cudaError_t err;

  // the GEMM operand W_vo: rows of E4 floats
  const float* wvo = p.wvo;
  if (E % 4 != 0) {
    if ((err = pad_rows(p.wvo, E, E, E4, ws.wvo, stream)) != cudaSuccess)
      return err;
    wvo = ws.wvo;
  }

  // R1 (the training instance: the forward's masks, bit for bit)
  FwdRows r1{};
  r1.kv = p.kv;
  r1.scales = p.scales;
  r1.u = p.u;
  r1.c = p.c;
  r1.pad = p.pad;
  r1.w = p.w;
  r1.mw = p.mw;
  r1.ent = p.ent;
  r1.rate = p.rate;
  r1.a = ws.a;
  r1.mix = ws.mix;
  r1.B = B;
  r1.M = p.M;
  r1.E = E;
  r1.H = 1;
  r1.ld = E4;
  r1.vec = vec;
  rows_fwd_kernel<T, true, 1>
      <<<warp_blocks(B), kThreads, 0, stream>>>(r1, mask_params(p));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // G1: out[b, n] = sum_k mix[b, k] W_vo[n, k] (+ b_ctx): W_vo n-major
  gemm::GemmArgs g1{};
  g1.A = ws.mix;
  g1.lda = E4;
  g1.W = wvo;
  g1.ldw = E4;
  g1.ldc = E4;
  g1.rows = B;
  g1.N = E;
  g1.K = E;
  g1.groups = 1;
  if (C == 0) {
    g1.C = ws.dout;
    err = gemm::gemm<false, false>(
        p.precision, g1, gemm::EpiQuadLoss{p.bctx, p.two_inv, ws.sq, ws.sq_ld},
        p.plans[0], ws.scr, stream);
  } else {
    g1.C = ws.out;
    gemm::EpiAffine bias;
    bias.bias = p.bctx;
    err = gemm::gemm<false, false>(p.precision, g1, bias, p.plans[0], ws.scr,
                                   stream);
  }
  if (err != cudaSuccess) return err;

  if (C > 0) {
    const size_t smem = head_smem_bytes(E, C);
    const auto head = p.precision == gemm::kTf32 ? step_head_kernel<true>
                                                 : step_head_kernel<false>;
    if ((err = allow_smem(head, smem)) != cudaSuccess) return err;
    head<<<cdiv(B, kWarps), kThreads, smem, stream>>>(p, ws,
                                                      head_staged(E, C));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  // G2: d_mix[b, k] = sum_n d_out[b, n] W_vo[n, k]: W_vo k-major
  gemm::GemmArgs g2 = g1;
  g2.A = ws.dout;
  g2.C = ws.dmix;
  err = gemm::gemm<false, true>(p.precision, g2, gemm::EpiAffine{},
                                p.plans[1], ws.scr, stream);
  if (err != cudaSuccess) return err;

  // R2 with the loss partials
  BwdRows r2{};
  r2.kv = p.kv;
  r2.scales = p.scales;
  r2.u = p.u;
  r2.a = ws.a;
  r2.dmix = ws.dmix;
  r2.dout = ws.dout;
  r2.dkv = p.dkv;
  r2.part = ws.part;
  r2.B = B;
  r2.M = p.M;
  r2.E = E;
  r2.ld = E4;
  r2.vec = vec;
  r2.sq = ws.sq;
  r2.lrow = ws.lrow;
  r2.dlogits = ws.dlogits;
  r2.sq_ld = ws.sq_ld;
  r2.ldl = logits_ld(C);
  r2.C = C;
  r2.inv = p.inv;
  rows_bwd_kernel<T, true><<<warp_blocks(B), kThreads, 0, stream>>>(r2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // G3: G[i, j] = sum_b d_out[b, i] mix[b, j] (A transposed, K = B)
  gemm::GemmArgs g3{};
  g3.A = ws.dout;
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
                               p.plans[2], ws.scr, stream);
  if (err != cudaSuccess) return err;
  if (C > 0) {
    // dW_head[i, c] = sum_b out[b, i] d_logits[b, c]
    gemm::GemmArgs gh = g3;
    gh.A = ws.out;
    gh.W = ws.dlogits;
    gh.ldw = logits_ld(C);
    gh.C = p.dhead_w;
    gh.ldc = C;
    gh.N = C;
    err = gemm::gemm<true, true>(p.precision, gh, gemm::EpiAffine{},
                                 p.plans[3], ws.scr, stream);
    if (err != cudaSuccess) return err;
  }
  return part_sum(ws.part, warp_blocks(B), part_cols(E, C, true), p.sums,
                  stream);
}

}  // namespace

extern "C" {

// Floats of workspace aecf_train_step needs for (B, E, C) under the
// products' plans (StepParams.plans; null: the default plans); C = 0 for
// the quadratic loss.
size_t aecf_train_step_workspace(int B, int E, int C,
                                 const gemm::GemmTile* plans) {
  const gemm::GemmTile none[kProducts] = {};
  return workspace_floats(B, E, C, plans != nullptr ? plans : none);
}

// The plans the chain's products run at (B, E, C) when asked for `plans`
// (null: the default plans): bn, splits and k_per_split for each product
// in launch order into `out` (3 x 4 ints).  Returns the number of
// products, or minus the cudaError_t of a plan the chain refuses.
int aecf_train_step_plans(int B, int E, int C, const gemm::GemmTile* plans,
                          int* out) {
  gemm::Product q[kProducts];
  const int n = products(B, E, C, q);
  const cudaError_t err = gemm::report_plans(q, plans, n, out);
  return err != cudaSuccess ? -(int)err : n;
}

// Bytes of shared memory a block of the chain asks for at (E, C), C = 0
// for the quadratic loss: the larger of the GEMMs' ring and the head
// kernel's.  The wrapper checks its own count (_step_smem) before it
// launches; chip_smoke.py holds the two equal.
size_t aecf_train_step_smem(int E, int C) {
  const size_t head = C > 0 ? head_smem_bytes(E, C) : 0;
  return head > gemm::kMaxSmemBytes ? head : gemm::kMaxSmemBytes;
}

// Returns a cudaError_t; 0 means every launch was accepted.  Pointers are
// contiguous device buffers as listed in StepParams (wvo and ws 16-byte
// aligned; kv at any element offset); int8 needs scales and takes no dkv.
// The shared memory a block asks for, the larger of the GEMMs' ring
// (gemm::kMaxSmemBytes) and head_smem_bytes(E, C), is checked against the
// H100's 227 KB by the wrapper (kernels/train_step.py, _step_smem).
int aecf_train_step(const StepParams* p, void* stream) {
  if (p->B < 1 || p->M < 1 || p->M > kMaxM || p->E < 1 ||
      (p->head_w != nullptr && p->C < 1) ||
      (p->kv_dtype == kKvInt8 && (p->scales == nullptr || p->dkv != nullptr)) ||
      (p->precision != gemm::kHighest && p->precision != gemm::kTf32) ||
      !gemm::aligned16(p->wvo) || !gemm::aligned16(p->ws)) {
    return (int)cudaErrorInvalidValue;
  }
  // every plan is checked before anything launches
  int plan[3 * kProducts];
  if (aecf_train_step_plans(p->B, p->E, p->head_w != nullptr ? p->C : 0,
                            p->plans, plan) < 0)
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

// The GEMM block alone, either instance (precision: gemm::Precision), with
// the affine epilogue, for its checks and its cuBLAS yardstick
// (kernels/_gemm.py).  Also declared by kernels/_gemm.py (ctypes).
struct GemmCall {
  const float* A;
  long long lda, a_gstride;
  const float* W;
  long long ldw, w_gstride;
  const float* bias;  // or null
  long long bias_gstride;
  float* C;
  long long ldc, c_gstride;
  float* partials;  // aecf_gemm_f32_scratch floats
  int rows, N, K, groups, a_trans, w_kmajor;
  float scale;
  gemm::GemmTile plan;  // {0, 0}: gemm_plan's
  int precision;        // gemm::Precision
};

size_t aecf_gemm_f32_scratch(int rows, int N, int K, int groups,
                             int w_kmajor, int bn, int splits) {
  return gemm::product_scratch(
      gemm::Product{rows, N, K, groups, w_kmajor != 0, true},
      gemm::GemmTile{bn, splits});
}

// The plan one product runs when asked for (bn, splits) ({0, 0}:
// gemm_plan's): bn, splits and k_per_split into `out`.  Returns a
// cudaError_t (a refused plan: cudaErrorInvalidValue).
int aecf_gemm_f32_plan(int rows, int N, int K, int groups, int w_kmajor,
                       int may_split, int bn, int splits, int* out) {
  const gemm::Product q{rows, N, K, groups, w_kmajor != 0, may_split != 0};
  const gemm::GemmTile t{bn, splits};
  return (int)gemm::report_plans(&q, &t, 1, out);
}

// Returns a cudaError_t; 0 means every launch was accepted.  A, W and C
// 16-byte aligned, lda, ldw and the group strides of A and W multiples of 4;
// the layouts the chains run (a transposed A with a k-major W only).
int aecf_gemm_f32(const GemmCall* c, void* stream) {
  if (c->rows < 1 || c->N < 1 || c->K < 1 || c->groups < 1 ||
      (c->a_trans && !c->w_kmajor) ||
      !gemm::aligned16(c->A) || !gemm::aligned16(c->W) ||
      !gemm::aligned16(c->C) || c->lda % 4 || c->ldw % 4 ||
      c->a_gstride % 4 || c->w_gstride % 4) {
    return (int)cudaErrorInvalidValue;
  }
  gemm::GemmArgs a{};
  a.A = c->A;
  a.lda = c->lda;
  a.a_gstride = c->a_gstride;
  a.W = c->W;
  a.ldw = c->ldw;
  a.w_gstride = c->w_gstride;
  a.C = c->C;
  a.ldc = c->ldc;
  a.c_gstride = c->c_gstride;
  a.rows = c->rows;
  a.N = c->N;
  a.K = c->K;
  a.groups = c->groups;
  gemm::EpiAffine e;
  e.bias = c->bias;
  e.bias_gstride = c->bias_gstride;
  e.scale = c->scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pr = c->precision;
  cudaError_t err;
  if (c->a_trans)
    err = gemm::gemm<true, true>(pr, a, e, c->plan, c->partials, s);
  else
    err = c->w_kmajor
              ? gemm::gemm<false, true>(pr, a, e, c->plan, c->partials, s)
              : gemm::gemm<false, false>(pr, a, e, c->plan, c->partials, s);
  return (int)err;
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
