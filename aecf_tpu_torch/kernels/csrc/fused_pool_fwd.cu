// Per-row-query fusion-pool forward (eval and training) for Hopper (sm_90a).
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
// What bounds it on the H100: the four E x E products of each row — qp,
// u (over the heads), ctx and out: 4 B E^2 FMAs, where the TPU kernel
// projects K and V for every (b, m) and does (2M + 2) B E^2.  They run on
// the SIMT pipes in f32 (gemm_rows_wide, 4 x 4 outputs a thread), with the
// weights streamed from L2 through a 16 KB staging tile; the kv stream (B M
// E) is read once from device memory and re-read from L1/L2 per head and
// for the mix.  Projecting K and V per (b, m) would need a 16 M x E tile of
// each (512 KB at M = 8, E = 1024); the u / c rewrite of the shared-query
// kernels, with u and c per row, needs none.  A block holds kRows = 16
// rows and takes the heads one after another, first every head's scores
// and softmax, then every head's mix and context, so two 16 x E f32 tiles
// are enough (q -> u_h -> mix_h, and qp -> ctx): 82 KB of shared memory
// with the staging tile at E = 512 (two blocks an SM; a third q tile would
// have left one), 146 KB at E = 1024 (one); the heads' weights (kRows x H
// x M floats, sized by the call) add 4 KB at most, H = 8 and M = 8, so any
// H with E a multiple of 4 H runs, one head a pass.  Rows past B are
// masked here and nothing is padded on the host.  The query may have any
// row stride, 0 included (the expanded (1, 1, E) fusion query), and may be
// bf16, as kv may.  Tensor cores, TMA and wgmma are later work.
//
// Numerics: f32 FMAs throughout, whatever the pool's precision setting
// (the TPU kernel runs HIGHEST always).  Scores are kv . (Wk^T qp) where
// the plain version computes (kv Wk^T + bk) . qp: the sums run in another
// order, ~1e-6 apart.  Built without fast-math and without flush-to-zero
// (the entropy's subnormal floor).

#include "pool_common.cuh"

using namespace aecf;

// Also declared, field for field, by kernels/fused_pool.py (ctypes).
struct FusedParams {
  const void* q;      // (B, E) f32 or bf16, rows ldq elements apart
  const void* kv;     // (B, M, E) f32 or bf16, contiguous
  const float* pad;   // (B, M) additive score bias, or null
  const float* wq_t;  // (E, E): Wq transposed
  const float* bq;    // (E,)
  const float* wk;    // (E, E): Wk as stored (row = output feature)
  const float* bk;    // (E,)
  const float* wv_t;  // (E, E): Wv transposed
  const float* bv;    // (E,)
  const float* wo_t;  // (E, E): Wo transposed
  const float* bo;    // (E,)
  float* out;         // (B, E)
  float* w;           // (B, M)
  float* mw;          // (B, M)
  float* ent;         // (B,)
  float* rate;        // (B,)
  long long ldq;      // query row stride in elements (0: one shared row)
  int B, M, E, H, q_bf16, kv_bf16, training, min_active;
  unsigned int seed0, seed1;
  float max_entropy, mask_prob, scale;
};

namespace {

// Floats of shared memory before the staging tile; a_s is sized by the
// call's H and M.
__host__ __device__ inline int tile_floats(int E, int H, int M) {
  return align4(2 * kRows * E + kRows * H * M + kRows * kMaxM + kRows);
}

size_t smem_bytes(int E, int H, int M) {
  return sizeof(float) * ((size_t)tile_floats(E, H, M) + kStageFloats);
}

template <typename T, bool kTraining>
AECF_ROW_KERNEL(2) fused_pool_fwd_kernel(FusedParams p) {
  extern __shared__ float smem[];
  const int E = p.E;
  const int M = p.M;
  const int B = p.B;
  const int H = p.H;
  const int Dh = E / H;
  float* xs = smem;                           // kRows x E: q, u_h, mix_h
  float* ys = xs + kRows * E;                 // kRows x E: qp, then ctx
  float* a_s = ys + kRows * E;                // kRows x H x M
  float* wsum = a_s + kRows * H * M;          // kRows x kMaxM: sum_h a_h
  float* c_s = wsum + kRows * kMaxM;          // kRows: c_h
  float* wt = smem + tile_floats(E, H, M);    // kStageFloats

  const T* kv = static_cast<const T*>(p.kv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, B - row0);

  // ---- the block's query rows in f32 (zero past B) ------------------------
  for (int i = threadIdx.x; i < kRows * E; i += kThreads) {
    const int r = i / E;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < B) {
      const size_t off = (size_t)gr * p.ldq + (i - r * E);
      v = p.q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(p.q)[off])
                   : static_cast<const float*>(p.q)[off];
    }
    xs[i] = v;
  }
  for (int i = threadIdx.x; i < kRows * kMaxM; i += kThreads) wsum[i] = 0.f;
  __syncthreads();
  // qp[r, n] = sum_k q[r, k] Wq[n, k] + bq[n]
  gemm_rows_wide(xs, E, E, p.wq_t, E, p.bq, E, wt, ys, E, kRows);
  __syncthreads();

  // ---- per head: u_h, c_h, scores, softmax (a warp a row) -----------------
  for (int h = 0; h < H; ++h) {
    // u_h[r, e] = sum_d qp[r, h Dh + d] Wk[h Dh + d, e] (scaled below)
    gemm_rows_wide(ys + h * Dh, E, Dh, p.wk + (size_t)h * Dh * E, E, nullptr,
                   E, wt, xs, E, kRows);
    __syncthreads();
    for (int r = warp; r < rows_valid; r += kWarps) {
      const int gr = row0 + r;
      float* ur = xs + r * E;
      // each lane scales the entries row_softmax has it read
      for (int e = lane; e < E; e += 32) ur[e] *= p.scale;
      float cd = 0.f;
      for (int d = lane; d < Dh; d += 32)
        cd = fmaf(ys[r * E + h * Dh + d], p.bk[h * Dh + d], cd);
      cd = warp_sum(cd) * p.scale;
      if (lane == 0) c_s[r] = cd;
      __syncwarp();
      float a[kMaxH][kMaxM];
      float w[kMaxM];
      row_softmax(KvRow<T>(kv, nullptr, gr, M, E), ur, c_s + r,
                  p.pad != nullptr ? p.pad + (size_t)gr * M : nullptr, M, E,
                  1, a, w);
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m < M) {
            a_s[(r * H + h) * M + m] = a[0][m];
            wsum[r * kMaxM + m] += a[0][m];
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- head mean -> entropy -> eval passthrough or training mask ----------
  MaskParams mp;
  mp.max_entropy = p.max_entropy;
  mp.mask_prob = p.mask_prob;
  mp.min_active = p.min_active;
  mp.training = p.training;
  mp.seed0 = p.seed0;
  mp.seed1 = p.seed1;
  const float inv_h = 1.0f / (float)H;
  for (int r = warp; r < rows_valid; r += kWarps) {
    float w[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      w[m] = m < M ? wsum[r * kMaxM + m] * inv_h : 0.f;
    row_side_outputs<kTraining>(w, row0 + r, M, mp, p.w, p.mw, p.ent,
                                p.rate);
  }

  // ---- per head: mix_h, ctx_h (quirk Q1: the unmasked a_h); qp is spent ---
  for (int h = 0; h < H; ++h) {
    build_mix(kv, (const float*)nullptr, a_s, xs, (float*)nullptr, row0, B,
              M, E, H, h);
    __syncthreads();
    // ctx[r, h Dh + n] = sum_k mix_h[r, k] Wv[h Dh + n, k] + bv[h Dh + n]
    gemm_rows_wide(xs, E, E, p.wv_t + h * Dh, E, p.bv + h * Dh, Dh, wt,
                   ys + h * Dh, E, kRows);
    __syncthreads();
  }

  // ---- out[r, n] = sum_k ctx[r, k] Wo[n, k] + bo[n] -----------------------
  gemm_rows_wide(ys, E, E, p.wo_t, E, p.bo, E, wt, p.out + (size_t)row0 * E,
                 E, rows_valid);
}

template <typename T, bool kTraining>
cudaError_t launch(const FusedParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.E, p.H, p.M);
  const cudaError_t err = allow_smem(fused_pool_fwd_kernel<T, kTraining>, smem);
  if (err != cudaSuccess) return err;
  fused_pool_fwd_kernel<T, kTraining>
      <<<row_blocks(p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory in bytes one block asks for at width E with H heads and M
// modalities.
size_t aecf_fused_pool_fwd_smem(int E, int H, int M) {
  return smem_bytes(E, H, M);
}

// Returns a cudaError_t; 0 means the launch was accepted.  Pointers are
// device buffers as listed in FusedParams; any H with E a multiple of 4 H
// (the GEMMs read float4 rows of each head's slice).  training = 0 is the
// eval branch (seed words, mask_prob and min_active unread).
int aecf_fused_pool_fwd(const FusedParams* p, void* stream) {
  if (p->B < 1 || p->M < 1 || p->M > kMaxM || p->H < 1 || p->E < 1 ||
      p->E % (4 * p->H) != 0 || p->ldq < 0) {
    return (int)cudaErrorInvalidValue;
  }
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
