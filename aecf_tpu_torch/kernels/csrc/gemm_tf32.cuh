// The TF32 tensor-core instance of the GEMM block for Hopper (sm_90a): the
// products of the port's chains at precision='default' (train_step.cu,
// shared_query_fwd.cu, shared_query_bwd.cu).  For g in [0, groups):
//
//   C[g] (rows x N) = epi(tf32(A[g]) (rows x K) . tf32(W[g]) (K x N))
//
// It replaces, with the SIMT instance of gemm_f32.cuh, the in-kernel
// products the JAX package runs at mxu_precision = None at 'default'
// (aecf_tpu/kernels/shared_query.py: _shared_kernel's context and output
// dots, _bwd_kernel's d_mix and G; aecf_tpu/kernels/train_step.py:
// _step_kernel's out, logits, d_out, dW_head, d_mix and G).  On an Ampere
// or Hopper GPU JAX runs such f32 dots as TF32, so this is what the JAX
// package computes on this card.
//
// Interface: gemm_f32.cuh's, whole — GemmArgs, Product, GemmTile (bn 64 or
// 128, K splits), gemm_plan's default rule and plan_of's checks,
// EpiAffine and EpiQuadLoss, the fixed-order splitk_reduce_kernel, a
// transposed A (the batch reductions G = d_out^T mix), k-major and n-major
// W, groups, ragged rows, N and K zero-filled by cp.async's src-size — so
// kernels/_plan.py, kernels/tiles.py and every plan the tuner writes apply
// unchanged to both instances.  The ring's stages take the same bytes
// (smem_bytes), so the chains' shared-memory counts hold for both.
//
// What bounds it on the H100: operations at the chains' products (B E^2
// at B = 4096, E = 512: 2.1 GFLOP each, 0.0043 ms at the dense TF32 peak of
// 495 TFLOP/s) and, as the batch shrinks, the operand bytes.  A simple
// instance first: mma.sync.aligned.m16n8k8 (f32 accumulators) fed by the
// SIMT instance's 3-stage cp.async ring; wgmma and TMA are later work.
//
//   * 256 threads, 8 warps as 2 (rows) x 4 (columns): a warp owns 64 rows
//     and BN / 4 columns of the 128 x BN block tile, 4 x BN / 32 mma tiles
//     of 16 x 8;
//   * each operand is rounded to TF32 (cvt.rna.tf32.f32: to nearest, ties
//     away from zero) as it leaves shared memory; accumulation is f32 in
//     the tensor cores;
//   * fragments are read from shared memory without bank conflicts: a
//     k-contiguous tile keeps gemm_f32.cuh's rows of 36 floats; an m- or
//     n-contiguous tile (a transposed A, a k-major W) keeps rows of the
//     tile width with the columns of row k XOR-swizzled by 8 (k mod 4), so
//     the four k of a fragment fall on four banks groups;
//   * the epilogue applies the functor to each output in place; the
//     quadratic loss's row squares meet across the four column warps in
//     shared memory, in warp order.
//
// Numerics: the products of two TF32 operands are exact in f32, so the
// result differs from the plain version (round_tf32 on both operands,
// then an IEEE f32 product) only in the order of the f32 sums inside and
// across the mma tiles.  Deterministic: no atomics, a fixed instruction
// order, splits added in split order — a run is bit for bit repeatable.

#pragma once

#include "gemm_f32.cuh"

namespace aecf {
namespace gemm {

// The precision field of the chains' C parameters: which instance of the
// block their products run.
enum Precision : int {
  kHighest = 0,  // IEEE f32 FMAs: gemm_f32.cuh's SIMT instance
  kTf32 = 1,     // 'default': TF32 tensor cores, this file
};

constexpr int kWarpRows = 64;  // rows of the block tile a warp owns
constexpr int kMmaM = 16, kMmaN = 8, kMmaK = 8;
constexpr int kWarpsN = 4;     // warps along the columns
static_assert(kWarps == 2 * kWarpsN && 2 * kWarpRows == kBM, "2 x 4 warps");

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Column of element (k, c) of an m- or n-contiguous tile row: c XOR 8 (k
// mod 4).  A 16-byte chunk (4 columns from a multiple of 4) stays whole.
__device__ __forceinline__ int swz(int k, int c) { return c ^ ((k & 3) << 3); }

template <int BN, bool kATrans, bool kWKMajor>
__device__ __forceinline__ void load_stage_tc(const GemmArgs& a,
                                              const float* A, const float* W,
                                              float* As, float* Ws, int r0,
                                              int n0, int k0, int kend) {
  const int tid = threadIdx.x;
  if constexpr (kATrans) {  // As[kk][swz(r)]: 4 rows a chunk
    for (int c = tid; c < kBK * (kBM / 4); c += kThreads) {
      const int kk = c / (kBM / 4), r = (c % (kBM / 4)) * 4;
      const int gk = k0 + kk, gr = r0 + r;
      const bool ok = gk < kend && gr < a.rows;
      cp_async16(As + kk * kBM + swz(kk, r), ok ? A + gk * a.lda + gr : A,
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
  if constexpr (kWKMajor) {  // Ws[kk][swz(n)]: 4 columns a chunk
    for (int c = tid; c < kBK * (BN / 4); c += kThreads) {
      const int kk = c / (BN / 4), n = (c % (BN / 4)) * 4;
      const int gk = k0 + kk, gn = n0 + n;
      const bool ok = gk < kend && gn < a.N;
      cp_async16(Ws + kk * BN + swz(kk, n), ok ? W + gk * a.ldw + gn : W,
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

// A(r, k) and W(k, n) of a stage in shared memory, as TF32.
template <bool kATrans>
__device__ __forceinline__ uint32_t a_at(const float* As, int r, int k) {
  return to_tf32(kATrans ? As[k * kBM + swz(k, r)] : As[r * kLdK + k]);
}
template <int BN, bool kWKMajor>
__device__ __forceinline__ uint32_t w_at(const float* Ws, int k, int n) {
  return to_tf32(kWKMajor ? Ws[k * BN + swz(k, n)] : Ws[n * kLdK + k]);
}

// One stage: kBK / 8 steps of the warp's 4 x NT mma tiles.  Lane l is
// (group gi = l / 4, thread ti = l % 4) in PTX's fragment layouts: A's
// a0..a3 at (gi, ti), (gi + 8, ti), (gi, ti + 4), (gi + 8, ti + 4); B's b0,
// b1 at (k ti, n gi), (k ti + 4, n gi).
template <int BN, bool kATrans, bool kWKMajor>
__device__ __forceinline__ void compute_stage_tc(
    const float* As, const float* Ws, int wr, int wc, int gi, int ti,
    float (&acc)[kWarpRows / kMmaM][BN / kWarpsN / kMmaN][4]) {
  constexpr int kMT = kWarpRows / kMmaM;
  constexpr int kNT = BN / kWarpsN / kMmaN;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += kMmaK) {
    uint32_t af[kMT][4];
    uint32_t bf[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int r = wr + i * kMmaM + gi;
      af[i][0] = a_at<kATrans>(As, r, ks + ti);
      af[i][1] = a_at<kATrans>(As, r + 8, ks + ti);
      af[i][2] = a_at<kATrans>(As, r, ks + ti + 4);
      af[i][3] = a_at<kATrans>(As, r + 8, ks + ti + 4);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = wc + j * kMmaN + gi;
      bf[j][0] = w_at<BN, kWKMajor>(Ws, ks + ti, n);
      bf[j][1] = w_at<BN, kWKMajor>(Ws, ks + ti + 4, n);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], af[i], bf[j]);
  }
}

// blockIdx = (column tile, row tile, group * splits + split), as
// gemm_kernel.  Accumulator acc[i][j][e] of lane (gi, ti) in warp (wm, wn)
// is row wm 64 + 16 i + gi + 8 (e / 2), column wn BN / 4 + 8 j + 2 ti +
// e % 2 of the block tile.
template <int BN, bool kATrans, bool kWKMajor, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_tf32_kernel(GemmArgs a, Epi epi) {
  constexpr int kMT = kWarpRows / kMmaM;
  constexpr int kNT = BN / kWarpsN / kMmaN;
  extern __shared__ float4 gemm_smem[];  // float4: 16-byte aligned
  float* smem = reinterpret_cast<float*>(gemm_smem);
  float* As0 = smem;
  float* Ws0 = smem + kStages * a_stage_floats<kATrans>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gi = lane >> 2, ti = lane & 3;
  const int wm = warp % 2, wn = warp / 2;
  const int wr = wm * kWarpRows, wc = wn * (BN / kWarpsN);
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * kBM;
  const int g = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int kbeg = split * a.k_per_split;
  const int kend = min(a.K, kbeg + a.k_per_split);
  const float* A = a.A + g * a.a_gstride;
  const float* W = a.W + g * a.w_gstride;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = cdiv(kend - kbeg, kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_stage_tc<BN, kATrans, kWKMajor>(
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
      load_stage_tc<BN, kATrans, kWKMajor>(
          a, A, W, As0 + s * a_stage_floats<kATrans>(),
          Ws0 + s * w_stage_floats<BN, kWKMajor>(), r0, n0, kbeg + nt * kBK,
          kend);
    }
    cp_async_commit();
    const int s = kt % kStages;
    compute_stage_tc<BN, kATrans, kWKMajor>(
        As0 + s * a_stage_floats<kATrans>(),
        Ws0 + s * w_stage_floats<BN, kWKMajor>(), wr, wc, gi, ti, acc);
  }
  cp_async_wait<0>();

  if (a.splits > 1) {
    float* P = a.partials + ((size_t)split * a.groups + g) * a.rows * a.N;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + wr + i * kMmaM + gi + 8 * (e / 2);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int c = n0 + wc + j * kMmaN + 2 * ti + e % 2;
          if (r < a.rows && c < a.N) P[(size_t)r * a.N + c] = acc[i][j][e];
        }
      }
    return;
  }
  float* C = a.C + g * a.c_gstride;
  float* red = smem;  // kWarpsN x kBM: the row squares of each column warp
  if constexpr (Epi::kRowSquares) __syncthreads();  // the ring is free
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rt = wr + i * kMmaM + gi + 8 * h;  // row in the block tile
      const int r = r0 + rt;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const int c = n0 + wc + j * kMmaN + 2 * ti + e % 2;
          if (r < a.rows && c < a.N)
            C[r * a.ldc + c] = epi(g, c, acc[i][j][e], sq);
        }
      if constexpr (Epi::kRowSquares) {
        // the row's partials in this warp sit in the four lanes of its group
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        if (ti == 0) red[wn * kBM + rt] = sq;
      }
    }
  if constexpr (Epi::kRowSquares) {
    __syncthreads();
    for (int rt = threadIdx.x; rt < kBM; rt += kThreads) {
      float sq = red[rt];
#pragma unroll
      for (int w = 1; w < kWarpsN; ++w) sq += red[w * kBM + rt];
      if (r0 + rt < a.rows) epi.row_squares(r0 + rt, blockIdx.x, sq);
    }
  }
}

template <int BN, bool kATrans, bool kWKMajor, class Epi>
cudaError_t launch_tiles_tf32(const GemmArgs& a, const Epi& epi,
                              cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BN, kATrans, kWKMajor>();
  static_assert(sizeof(float) * kWarpsN * kBM <= smem, "row squares fit");
  auto kernel = gemm_tf32_kernel<BN, kATrans, kWKMajor, Epi>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.N, BN), cdiv(a.rows, kBM), a.groups * a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a, epi);
  return cudaGetLastError();
}

// gemm_f32's product on the tensor cores: the same plan (plan_product),
// one GEMM kernel, and the split sum when it splits.
template <bool kATrans, bool kWKMajor, class Epi>
cudaError_t gemm_tf32(GemmArgs a, const Epi& epi, GemmTile tile,
                      float* partials, cudaStream_t stream) {
  GemmPlan plan;
  cudaError_t err = plan_product<kWKMajor, Epi>(a, tile, partials, &plan);
  if (err != cudaSuccess) return err;
  if constexpr (kWKMajor)
    err = plan.bn == 128
              ? launch_tiles_tf32<128, kATrans, true>(a, epi, stream)
              : launch_tiles_tf32<64, kATrans, true>(a, epi, stream);
  else
    err = launch_tiles_tf32<64, kATrans, false>(a, epi, stream);
  return reduce_splits(a, epi, err, stream);
}

// A chain's product at its precision (Precision): the SIMT instance at
// kHighest, the tensor-core one at kTf32; any other value is refused.
template <bool kATrans, bool kWKMajor, class Epi>
cudaError_t gemm(int precision, const GemmArgs& a, const Epi& epi,
                 GemmTile tile, float* partials, cudaStream_t stream) {
  switch (precision) {
    case kHighest:
      return gemm_f32<kATrans, kWKMajor>(a, epi, tile, partials, stream);
    case kTf32:
      return gemm_tf32<kATrans, kWKMajor>(a, epi, tile, partials, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace gemm
}  // namespace aecf
