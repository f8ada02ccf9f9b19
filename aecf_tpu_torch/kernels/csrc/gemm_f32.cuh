// Pipelined, register-tiled SIMT f32 GEMM for Hopper (sm_90a): the
// building block of the port's chained kernels (train_step.cu and
// fused_pool_fwd.cu).  For g in [0, groups):
//
//   C[g] (rows x N) = epi(A[g] (rows x K) . W[g] (K x N))
//
// Why SIMT f32: precision='highest' is IEEE f32, which TF32 / bf16 tensor
// cores cannot give; a SIMT GEMM built for the card is the lever.  At
// precision='default' the chains run the block's tensor-core instance
// instead (gemm_tf32.cuh: the same interface, plans and epilogues, TF32
// wgmma fed by TMA).  Design:
//
//   * 256-thread blocks, block tiles of 128 x 128 or 128 x 64 (gemm_plan
//     picks per shape so that the grid fills the device's SMs, unless the
//     caller gives a plan, a GemmTile: kernels/tiles.py; 128 x 128 only
//     for a k-major W), 8 x 8 or 8 x 4 accumulators a thread: each weight
//     loaded into shared memory is used for 128 FMAs, each row element for
//     64 or 128;
//   * a 3-stage ring of k-depth-32 stages in shared memory, filled by
//     16-byte cp.async (commit_group / wait_group), so the loads of stage
//     k + 2 overlap the FMAs of stage k (depth 32 measured 5% faster than
//     16 at the north star's products, 4 stages no faster than 3);
//   * operands read in their stored layouts, no transposed copies: A
//     row-major (A(r, k) = A[r lda + k]) or transposed (A[k lda + r], the
//     batch reductions G = d_out^T mix, where K is the batch); W k-major
//     (W(k, n) = W[k ldw + n]) or n-major (W[n ldw + k], an nn.Linear weight
//     used as x W^T).  A k-contiguous tile is kept as rows of 36 floats (32
//     + 4 pad: its float4 reads along k are conflict-free); an m- or
//     n-contiguous one as rows of the tile width;
//   * a group index from blockIdx.z with element strides (the per-head
//     products), and split-K over K with a fixed-order sum of the splits
//     (splitk_reduce_kernel, split 0 first), for the reductions over the
//     batch and the one-row products, as many splits as fill one wave (a
//     second, nearly empty wave cost G = d_out^T mix 30%);
//   * an epilogue functor applied to each output: EpiAffine (scale, bias)
//     or EpiQuadLoss (the train step's quadratic loss: d_out = 2 inv out
//     and one partial of sum out^2 per (row, column tile)).
//
// Numerics: every output is sum_k A(r, k) W(k, n) in increasing k, one
// fmaf per term from +0, whatever the layouts (the k-contiguous and the
// contiguous-along-the-tile fragments apply the same fmafs in the same
// order); splits add in split order.  No atomics: a run is bit for bit
// repeatable.  Ragged rows, columns and K are zero-filled by cp.async's
// src-size operand and never stored; nothing is padded on the host.
// Requires 16-byte aligned base pointers and lda, ldw and the group strides
// multiples of 4 (the callers check).  Built without fast-math and without
// flush-to-zero, as every source of the port.

#pragma once

#include "pool_common.cuh"

namespace aecf {
namespace gemm {

constexpr int kBM = 128;          // block tile rows
constexpr int kBK = 32;           // k-depth of one stage
constexpr int kStages = 3;        // the cp.async ring
constexpr int kLdK = kBK + 4;     // row stride of a k-contiguous tile (36)
constexpr int kTM = 8;            // accumulator rows a thread
constexpr int kTx = 16;           // threads along the columns
static_assert(kThreads == 256 && kTx * kTx == kThreads, "16 x 16 threads");
static_assert(kBM == kTM * kTx, "8 rows a thread");
static_assert((kLdK / 4) % 2 == 1, "conflict-free float4 reads along k");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- cp.async ----------------------------------------------------------------

// 16 bytes from gmem to smem, of which the first `src_bytes` (0..16) are
// read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ---- epilogues ---------------------------------------------------------------

// C = scale acc + bias[c] (bias per group at + g bias_gstride, or none).
struct EpiAffine {
  const float* bias = nullptr;
  long long bias_gstride = 0;
  float scale = 1.f;
  static constexpr bool kRowSquares = false;
  __device__ __forceinline__ float operator()(int g, int c, float acc,
                                              float& /*sq*/) const {
    const float v = acc * scale;
    return bias != nullptr ? v + bias[g * bias_gstride + c] : v;
  }
  __device__ __forceinline__ void row_squares(int, int, float) const {}
};

// The train step's quadratic loss: out = acc + bias[c] is not stored;
// C = two_inv out (d_out), and sq[r sq_ld + tile] = sum of out^2 over the
// row's columns in this column tile (summed over tiles and scaled by inv in
// the row-partials kernel).  Never split over K.
struct EpiQuadLoss {
  const float* bias;
  float two_inv;
  float* sq;
  int sq_ld;
  static constexpr bool kRowSquares = true;
  __device__ __forceinline__ float operator()(int, int c, float acc,
                                              float& s) const {
    const float o = acc + bias[c];
    s = fmaf(o, o, s);
    return o * two_inv;
  }
  __device__ __forceinline__ void row_squares(int r, int tile,
                                              float s) const {
    sq[(size_t)r * sq_ld + tile] = s;
  }
};

// ---- the problem and its plan ------------------------------------------------

struct GemmArgs {
  const float* A;
  long long lda, a_gstride;
  const float* W;
  long long ldw, w_gstride;
  float* C;
  long long ldc, c_gstride;
  int rows, N, K, groups;
  int splits, k_per_split;  // from the plan (plan_of)
  float* partials;          // splits > 1: splits x groups x rows x N floats
};

struct GemmPlan {
  int bn;           // block tile columns: 128 or 64
  int splits;       // K splits (1: no split)
  int k_per_split;  // a multiple of kBK
};

// A product's plan as its caller asks for it, in the C interfaces (also
// declared by kernels/_plan.py): block tile columns and K splits; {0, 0}
// is gemm_plan's.
struct GemmTile {
  int bn;
  int splits;
};

// One product of a chain: its shape and what its layout and epilogue
// allow (a k-major W for bn = 128; splits where the epilogue is not the
// quadratic loss's).  Each chain lists its products, in launch order, to
// size its split partials and to report its plans.
struct Product {
  int rows, N, K, groups;
  bool w_kmajor, may_split;
};

// 128 x 128 tiles where they alone give two blocks for every SM (the
// registers allow two an SM) and W is k-major, else 128 x 64 (with an
// n-major W, 8 x 8 accumulators and float4 fragments of both operands
// along k spill at two blocks an SM); split K where the tiles leave SMs
// idle (and the epilogue allows it), keeping four stages a split.  Sized
// by the device's SMs; kernels/_plan.py holds a copy.
inline GemmPlan gemm_plan(int rows, int N, int K, int groups, bool w_kmajor,
                          bool may_split) {
  const int sms = sm_count();
  GemmPlan p;
  const int mt = cdiv(rows, kBM);
  p.bn = (w_kmajor && N > 64 && mt * cdiv(N, 128) * groups >= 2 * sms)
             ? 128
             : 64;
  const int blocks = mt * cdiv(N, p.bn) * groups;
  p.splits = 1;
  if (may_split && blocks < sms)  // at most one wave of two blocks an SM
    p.splits = max(1, min(2 * sms / blocks, K / (4 * kBK)));
  p.k_per_split = cdiv(cdiv(K, p.splits), kBK) * kBK;
  p.splits = cdiv(K, p.k_per_split);
  return p;
}

// The plan a product runs: gemm_plan's for a zero tile, else the caller's,
// checked (cudaErrorInvalidValue: bn other than 64 or 128, 128 with an
// n-major W, splits < 1, splits > 1 where the epilogue forbids them, or
// more splits than k-stages).  Each split takes ceil(K / splits) of K
// rounded up to kBK, so the splits that run are ceil(K / k_per_split).
inline cudaError_t plan_of(const Product& q, GemmTile t, GemmPlan* p) {
  if (t.bn == 0 && t.splits == 0) {
    *p = gemm_plan(q.rows, q.N, q.K, q.groups, q.w_kmajor, q.may_split);
    return cudaSuccess;
  }
  if (!(t.bn == 64 || (t.bn == 128 && q.w_kmajor)) || t.splits < 1 ||
      (t.splits > 1 && !q.may_split) || t.splits > cdiv(q.K, kBK))
    return cudaErrorInvalidValue;
  p->bn = t.bn;
  p->k_per_split = cdiv(cdiv(q.K, t.splits), kBK) * kBK;
  p->splits = cdiv(q.K, p->k_per_split);
  return cudaSuccess;
}

// Floats of split-K partials a product needs under a plan (0 when it does
// not split, or when the plan is refused: its launch then fails).
inline size_t scratch_floats(const Product& q, GemmTile t) {
  GemmPlan p;
  if (plan_of(q, t, &p) != cudaSuccess || p.splits == 1) return 0;
  return (size_t)p.splits * q.groups * q.rows * q.N;
}

// The largest of n products' partials: a chain runs them one at a time.
inline size_t scratch_floats(const Product* q, const GemmTile* t, int n) {
  size_t m = 0;
  for (int i = 0; i < n; ++i) {
    const size_t x = scratch_floats(q[i], t != nullptr ? t[i] : GemmTile{});
    m = x > m ? x : m;
  }
  return m;
}

// The plans n products run, three ints each (bn, splits, k_per_split), for
// a chain's plan report; the first refused plan's error.
inline cudaError_t report_plans(const Product* q, const GemmTile* t, int n,
                                int* out) {
  for (int i = 0; i < n; ++i) {
    GemmPlan p;
    const cudaError_t err =
        plan_of(q[i], t != nullptr ? t[i] : GemmTile{}, &p);
    if (err != cudaSuccess) return err;
    out[3 * i] = p.bn;
    out[3 * i + 1] = p.splits;
    out[3 * i + 2] = p.k_per_split;
  }
  return cudaSuccess;
}

template <bool kATrans>
__host__ __device__ constexpr int a_stage_floats() {
  return kATrans ? kBK * kBM : kBM * kLdK;
}
template <int BN, bool kWKMajor>
__host__ __device__ constexpr int w_stage_floats() {
  return kWKMajor ? kBK * BN : BN * kLdK;
}
template <int BN, bool kATrans, bool kWKMajor>
constexpr size_t smem_bytes() {
  return sizeof(float) * kStages *
         (a_stage_floats<kATrans>() + w_stage_floats<BN, kWKMajor>());
}
// The largest ring any instance asks for: 128 x 128 with A k-contiguous
// (102 KB, two blocks an SM; 128 x 64 with both operands k-contiguous
// asks for 81 KB).
constexpr size_t kMaxSmemBytes = smem_bytes<128, false, true>();
static_assert(smem_bytes<64, false, false>() <= kMaxSmemBytes, "");

// ---- the kernel --------------------------------------------------------------

// Thread (tx, ty) = (tid % 16, tid / 16) holds rows ty 4 + {0..3} and
// 64 + ty 4 + {0..3} of the block tile, and columns tx 4 + {0..3} (+ 64)
// for an n-contiguous W tile (float4 reads), or tx + 16 j for a
// k-contiguous one (conflict-free float4 reads along k).
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i / 4) * 64 + ty * 4 + (i % 4);
}
template <bool kWKMajor>
__device__ __forceinline__ int tile_col(int tx, int j) {
  return kWKMajor ? (j / 4) * 64 + tx * 4 + (j % 4) : tx + kTx * j;
}

template <int BN, bool kATrans, bool kWKMajor>
__device__ __forceinline__ void load_stage(const GemmArgs& a, const float* A,
                                           const float* W, float* As,
                                           float* Ws, int r0, int n0, int k0,
                                           int kend) {
  const int tid = threadIdx.x;
  if constexpr (kATrans) {  // As[kk][r]: 4 rows a chunk
    for (int c = tid; c < kBK * (kBM / 4); c += kThreads) {
      const int kk = c / (kBM / 4), r = (c % (kBM / 4)) * 4;
      const int gk = k0 + kk, gr = r0 + r;
      const bool ok = gk < kend && gr < a.rows;
      cp_async16(As + kk * kBM + r, ok ? A + gk * a.lda + gr : A,
                 ok ? 4 * min(4, a.rows - gr) : 0);
    }
  } else {  // As[r][kk]: 4 k a chunk
    for (int c = tid; c < kBM * (kBK / 4); c += kThreads) {
      const int r = c / (kBK / 4), kk = (c % (kBK / 4)) * 4;
      const int gk = k0 + kk, gr = r0 + r;
      const bool ok = gk < kend && gr < a.rows;
      cp_async16(As + r * kLdK + kk, ok ? A + gr * a.lda + gk : A,
                 ok ? 4 * min(4, kend - gk) : 0);
    }
  }
  if constexpr (kWKMajor) {  // Ws[kk][n]: 4 columns a chunk
    for (int c = tid; c < kBK * (BN / 4); c += kThreads) {
      const int kk = c / (BN / 4), n = (c % (BN / 4)) * 4;
      const int gk = k0 + kk, gn = n0 + n;
      const bool ok = gk < kend && gn < a.N;
      cp_async16(Ws + kk * BN + n, ok ? W + gk * a.ldw + gn : W,
                 ok ? 4 * min(4, a.N - gn) : 0);
    }
  } else {  // Ws[n][kk]: 4 k a chunk
    for (int c = tid; c < BN * (kBK / 4); c += kThreads) {
      const int n = c / (kBK / 4), kk = (c % (kBK / 4)) * 4;
      const int gk = k0 + kk, gn = n0 + n;
      const bool ok = gk < kend && gn < a.N;
      cp_async16(Ws + n * kLdK + kk, ok ? W + gn * a.ldw + gk : W,
                 ok ? 4 * min(4, kend - gk) : 0);
    }
  }
}

template <int BN, bool kATrans, bool kWKMajor>
__device__ __forceinline__ void compute_stage(const float* As,
                                              const float* Ws, int tx,
                                              int ty,
                                              float acc[kTM][BN / kTx]) {
  constexpr int kTN = BN / kTx;
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    float a[kTM][4];  // rows x k kq .. kq + 3
    if constexpr (kATrans) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < kTM / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + (kq + kk) * kBM + h * 64 + ty * 4);
          a[4 * h + 0][kk] = v.x;
          a[4 * h + 1][kk] = v.y;
          a[4 * h + 2][kk] = v.z;
          a[4 * h + 3][kk] = v.w;
        }
    } else {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            As + tile_row(ty, i) * kLdK + kq);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
    }
    if constexpr (kWKMajor) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[kTN];
#pragma unroll
        for (int h = 0; h < kTN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              Ws + (kq + kk) * BN + h * 64 + tx * 4);
          w[4 * h + 0] = v.x;
          w[4 * h + 1] = v.y;
          w[4 * h + 2] = v.z;
          w[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(a[i][kk], w[j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            Ws + tile_col<false>(tx, j) * kLdK + kq);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          acc[i][j] = fmaf(a[i][3], v.w,
                           fmaf(a[i][2], v.z,
                                fmaf(a[i][1], v.y,
                                     fmaf(a[i][0], v.x, acc[i][j]))));
      }
    }
  }
}

// blockIdx = (column tile, row tile, group * splits + split).  With
// a.splits > 1 the block writes its raw sums to a.partials and
// splitk_reduce_kernel applies the epilogue.
template <int BN, bool kATrans, bool kWKMajor, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(GemmArgs a, Epi epi) {
  constexpr int kTN = BN / kTx;
  extern __shared__ float4 gemm_smem[];  // float4: 16-byte aligned
  float* smem = reinterpret_cast<float*>(gemm_smem);
  float* As0 = smem;
  float* Ws0 = smem + kStages * a_stage_floats<kATrans>();
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * kBM;
  const int g = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int kbeg = split * a.k_per_split;
  const int kend = min(a.K, kbeg + a.k_per_split);
  const float* A = a.A + g * a.a_gstride;
  const float* W = a.W + g * a.w_gstride;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int ktiles = cdiv(kend - kbeg, kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_stage<BN, kATrans, kWKMajor>(
          a, A, W, As0 + s * a_stage_floats<kATrans>(),
          Ws0 + s * w_stage_floats<BN, kWKMajor>(), r0, n0, kbeg + s * kBK,
          kend);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // and every thread is done with kt - 1
    const int nt = kt + kStages - 1;
    if (nt < ktiles) {
      const int s = nt % kStages;
      load_stage<BN, kATrans, kWKMajor>(
          a, A, W, As0 + s * a_stage_floats<kATrans>(),
          Ws0 + s * w_stage_floats<BN, kWKMajor>(), r0, n0, kbeg + nt * kBK,
          kend);
    }
    cp_async_commit();
    const int s = kt % kStages;
    compute_stage<BN, kATrans, kWKMajor>(
        As0 + s * a_stage_floats<kATrans>(),
        Ws0 + s * w_stage_floats<BN, kWKMajor>(), tx, ty, acc);
  }
  cp_async_wait<0>();

  if (a.splits > 1) {
    float* P = a.partials + ((size_t)split * a.groups + g) * a.rows * a.N;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = r0 + tile_row(ty, i);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = n0 + tile_col<kWKMajor>(tx, j);
        if (r < a.rows && c < a.N) P[(size_t)r * a.N + c] = acc[i][j];
      }
    }
    return;
  }
  float* C = a.C + g * a.c_gstride;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + tile_row(ty, i);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tile_col<kWKMajor>(tx, j);
      if (r < a.rows && c < a.N) C[r * a.ldc + c] = epi(g, c, acc[i][j], sq);
    }
    if constexpr (Epi::kRowSquares) {
      // the row's 16 column partials sit in the 16 lanes of a half-warp
#pragma unroll
      for (int o = kTx / 2; o > 0; o >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      if (tx == 0 && r < a.rows) epi.row_squares(r, blockIdx.x, sq);
    }
  }
}

// C[g][r, c] = epi(sum over splits s, in order, of partials[s][g][r, c]).
template <class Epi>
__global__ void splitk_reduce_kernel(GemmArgs a, Epi epi) {
  const size_t n = (size_t)a.groups * a.rows * a.N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % a.N);
  const int r = (int)((i / a.N) % a.rows);
  const int g = (int)(i / ((size_t)a.N * a.rows));
  float s = a.partials[i];
  for (int k = 1; k < a.splits; ++k) s += a.partials[(size_t)k * n + i];
  float sq = 0.f;
  a.C[g * a.c_gstride + r * a.ldc + c] = epi(g, c, s, sq);
}

template <int BN, bool kATrans, bool kWKMajor, class Epi>
cudaError_t launch_tiles(const GemmArgs& a, const Epi& epi,
                         cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BN, kATrans, kWKMajor>();
  auto kernel = gemm_kernel<BN, kATrans, kWKMajor, Epi>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.N, BN), cdiv(a.rows, kBM), a.groups * a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a, epi);
  return cudaGetLastError();
}

// The plan of one product under the caller's `tile` (plan_of: a zero tile
// is gemm_plan's): fills a's splits, k_per_split and partials (which must
// hold scratch_floats(product, tile) floats) and the plan.  Shared by the
// two instances of the block (gemm_f32 here, gemm_tf32 in gemm_tf32.cuh).
template <bool kWKMajor, class Epi>
cudaError_t plan_product(GemmArgs& a, GemmTile tile, float* partials,
                         GemmPlan* plan) {
  const Product q{a.rows, a.N, a.K, a.groups, kWKMajor, !Epi::kRowSquares};
  const cudaError_t err = plan_of(q, tile, plan);
  if (err != cudaSuccess) return err;
  a.splits = plan->splits;
  a.k_per_split = plan->k_per_split;
  a.partials = partials;
  return a.splits > 1 && partials == nullptr ? cudaErrorInvalidValue
                                             : cudaSuccess;
}

// After the product's kernel (launched with `err`): the split sum, in
// split order, when the plan splits.
template <class Epi>
cudaError_t reduce_splits(const GemmArgs& a, const Epi& epi, cudaError_t err,
                          cudaStream_t stream) {
  if constexpr (!Epi::kRowSquares) {
    if (err != cudaSuccess || a.splits == 1) return err;
    const size_t n = (size_t)a.groups * a.rows * a.N;
    splitk_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        a, epi);
    return cudaGetLastError();
  }
  return err;
}

// The product of GemmArgs under the caller's plan `tile` (plan_product).
// Launches one GEMM kernel, and the split sum when it splits.
template <bool kATrans, bool kWKMajor, class Epi>
cudaError_t gemm_f32(GemmArgs a, const Epi& epi, GemmTile tile,
                     float* partials, cudaStream_t stream) {
  GemmPlan plan;
  cudaError_t err = plan_product<kWKMajor, Epi>(a, tile, partials, &plan);
  if (err != cudaSuccess) return err;
  if constexpr (kWKMajor)
    err = plan.bn == 128 ? launch_tiles<128, kATrans, true>(a, epi, stream)
                         : launch_tiles<64, kATrans, true>(a, epi, stream);
  else
    err = launch_tiles<64, kATrans, false>(a, epi, stream);
  return reduce_splits(a, epi, err, stream);
}

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace gemm
}  // namespace aecf
