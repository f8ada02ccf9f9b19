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
// _step_kernel's out, d_mix, G and dW_head).  On an Ampere or Hopper GPU
// JAX runs such f32 dots as TF32, so this is what the JAX package computes
// on this card.
//
// Interface: gemm_f32.cuh's, whole — GemmArgs, Product, GemmTile (bn 64 or
// 128, K splits), gemm_plan's default rule and plan_of's checks,
// EpiAffine and EpiQuadLoss, the fixed-order splitk_reduce_kernel, a
// transposed A (the batch reductions G = d_out^T mix), k-major and n-major
// W, groups, ragged rows, N and K — so kernels/_plan.py, kernels/tiles.py
// and every plan the tuner writes apply unchanged to both instances.  Every
// ring here fits in the SIMT instance's largest (kMaxSmemBytes), so the
// chains' shared-memory counts hold for both.  The chains size their
// scratch with product_scratch, which adds room for W rounded once.
//
// What bounds it on the H100: operations at the dense TF32 peak (495
// TFLOP/s: B E^2 at B = 4096, E = 512 is 2.1 GFLOP, 0.0043 ms) and, as the
// batch shrinks, the operand bytes.  Under the plans' 128 x 64 tile each
// block streams 24 KB of operands a k-stage of 32 for 0.5 MFLOP, and on
// this card that stream sets the pace: a variant that only streams the
// stages takes 70-100% of the kernel's time (chip_gemm_variants.py), and
// sharing A across a cluster by TMA multicast did not shorten it.  So the
// design keeps everything else off that stream's path:
//
//   * 256 threads, two warpgroups, a 128 x BN block tile (64 rows a
//     warpgroup): per k-step of 8, one wgmma.mma_async.m64nBNk8.f32.tf32
//     a warpgroup, f32 accumulators in registers (BN / 2 a thread), two
//     blocks an SM;
//   * operands arrive by TMA (cp.async.bulk.tensor, one thread issues, an
//     mbarrier a stage counts the bytes) into a ring of k-depth-32 stages;
//     the tensor maps are encoded on the host at each launch (the driver's
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the build links nothing beyond the runtime) and passed as
//     __grid_constant__ parameters.  TMA zero-fills rows, columns and K
//     beyond the operand, and a K split ends on a stage boundary;
//   * wgmma takes TF32 operands K-major only, and reads them as they lie:
//     the TF32 rounding (cvt.rna, as the plain version's round_tf32) has
//     to happen before it.  A goes through registers: each lane loads its
//     fragment from the landed stage (conflict-free shared loads under
//     TMA's 128-byte swizzle; a transposed A's fragment rows spread over
//     the warpgroup's 64 so that a lane reads two adjacent rows at once)
//     and rounds it, which takes either A layout.  W reaches wgmma by one
//     of three paths (WMode): at 1024 rows or more it is rounded once a
//     call into a K-major copy in the scratch (round_w_once_kernel) and
//     lands ready; otherwise an n-major W (K-major in PTX's terms) lands
//     128-byte swizzled and is rounded in place, and a k-major W (MN-major)
//     lands row by row and is rewritten, rounded and transposed, into a
//     K-major double buffer;
//   * a software pipeline: while a stage's wgmmas run, the threads load
//     and round the next stage's A fragments and W; a stage's slot goes
//     back to TMA as soon as nothing reads it (W read in place: after its
//     wgmmas; a transposed W: after its rewrite);
//   * the epilogue applies the functor to each output in place; a row's
//     squares (the quadratic loss) are the four lanes of one warp.
//
// Numerics: the products of two TF32 operands are exact in f32, so the
// result differs from the plain version (round_tf32 on both operands,
// then an IEEE f32 product) only in the order of the f32 sums inside the
// tensor cores and across stages.  Deterministic: no atomics, a fixed
// instruction order, splits added in split order — a run is bit for bit
// repeatable.  Requires 16-byte aligned A and W, lda, ldw and the group
// strides multiples of 4, and nonzero group strides (TMA's rules; anything
// else is refused with cudaErrorInvalidValue before a launch, never run
// another way).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the driver: at run time)

#include "gemm_f32.cuh"

namespace aecf {
namespace gemm {

// The precision field of the chains' C parameters: which instance of the
// block their products run.
enum Precision : int {
  kHighest = 0,  // IEEE f32 FMAs: gemm_f32.cuh's SIMT instance
  kTf32 = 1,     // 'default': TF32 tensor cores, this file
};

static_assert(kThreads == 256 && kBM == 128, "two warpgroups of 64 rows");

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

namespace tc {

// ---- the ring ---------------------------------------------------------

constexpr uint32_t kABytes = kBM * kBK * 4;  // an A stage: 16 KB
template <int BN>
__host__ __device__ constexpr uint32_t w_bytes() { return BN * kBK * 4; }

// How a stage's W reaches wgmma, K-major, 128-byte swizzled, TF32:
enum WMode {
  kWInPlace,    // an n-major W lands so and is rounded in place
  kWTranspose,  // a k-major W lands as rows of BN and is rewritten, rounded
                // and transposed, into a K-major double buffer
  kWReady,      // W was rounded once per call into a K-major copy
                // (round_w_once_kernel): it lands ready
};

// Stages of the ring: four where W is rounded in place or ready (three
// ready at bn 128); with a transposed W, whose double buffer takes room,
// three at bn 64 and two at bn 128 — every ring within kMaxSmemBytes, two
// blocks an SM.
template <int BN, WMode M>
__host__ __device__ constexpr int stages() {
  return M == kWTranspose ? (BN == 64 ? 3 : 2) : (BN == 64 ? 4 : 3);
}

// Bytes a block asks for: 1024 to align the ring (the 128-byte swizzle
// repeats every 1024), the stages, the transposed W's double buffer, and a
// barrier a stage.
template <int BN, WMode M>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)stages<BN, M>() * (kABytes + w_bytes<BN>()) +
         (M == kWTranspose ? 2 * w_bytes<BN>() : 0) + 8 * stages<BN, M>();
}
static_assert(smem_bytes<64, kWInPlace>() <= kMaxSmemBytes &&
                  smem_bytes<64, kWTranspose>() <= kMaxSmemBytes &&
                  smem_bytes<128, kWTranspose>() <= kMaxSmemBytes &&
                  smem_bytes<128, kWReady>() <= kMaxSmemBytes,
              "the TF32 rings fit the chains' shared-memory count");

// ---- PTX --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts4(uint32_t a, uint32_t x, uint32_t y,
                                     uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(x),
               "r"(y), "r"(z), "r"(w)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of `parity` to complete.  A stage that has not
// landed after about ten seconds (a TMA the hardware dropped) traps, which
// fails the launch, instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > 20000000000LL)
      __trap();
  }
}
// One box of a rank-3 tensor map (coordinates innermost first) into shared
// memory at dst, counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
// Generic-proxy accesses of shared memory (the rewrite of W, the loads of
// a stage) ordered before the async proxy's (wgmma's reads, TMA's writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmmas that write them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Keeps A's fragments alive until the wgmmas that read them have retired:
// the compiler does not know that wgmma reads its registers after issue,
// and would otherwise give the next stage's fragments the same registers.
__device__ __forceinline__ void fence_frags(uint32_t (&af)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(af[s][e])::"memory");
}

// The shared-memory matrix descriptor of a K-major operand tile in the
// canonical 128-byte-swizzled layout: rows of 32 floats (128 bytes), 8-row
// groups 1024 bytes apart (SBO), the tile 1024-byte aligned; a k-step of 8
// (32 bytes) further into the rows is its start address plus 32 bytes.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2],
                                      const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (BN == 64)
    wgmma_n64(d, a, desc);
  else
    wgmma_n128(d, a, desc);
}

// Byte offset of element (row, c) in a 128-byte-swizzled tile of 128-byte
// rows (32 floats), as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it: the
// 16-byte chunk c / 4 of the row moves to chunk (c / 4) XOR (row mod 8).
__device__ __forceinline__ uint32_t swz128(int row, int c) {
  return row * 128 + ((((c >> 2) ^ row) & 7) << 4) + (c & 3) * 4;
}

// The tile's row of fragment row gi + 8 h (h = 0, 1) of warp w (0..7):
// the warp's 16 rows in order for a row-major A; for a transposed A, rows
// 16 (gi / 2) + 4 (w % 4) + 2 (gi % 2) + h of its warpgroup's 64, so that
// a lane's two rows are adjacent (one float2) and the 16 lanes of a
// half-warp, at four k, fall on 16 different 8-byte bank pairs under the
// swizzle.
template <bool kATrans>
__device__ __forceinline__ int frag_row(int w, int gi, int h) {
  return kATrans ? 64 * (w >> 2) + 16 * (gi >> 1) + 4 * (w & 3) +
                       2 * (gi & 1) + h
                 : 16 * w + gi + 8 * h;
}

// Lane (gi, ti) of warp w: its A fragments of one stage, rounded, af[s]
// the k-step s (PTX's m64nNk8 .tf32 A layout: a0..a3 at (gi, ti), (gi + 8,
// ti), (gi, ti + 4), (gi + 8, ti + 4) of the fragment's 16 rows).
// Row-major A lands as 128 rows of 32 k (one box, swizzled); a transposed
// A as four boxes of 32 k by 32 rows.
template <bool kATrans>
__device__ __forceinline__ void load_a(uint32_t As, int w, int gi, int ti,
                                       uint32_t (&af)[4][4]) {
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s) {
    if constexpr (kATrans) {
      const int r = frag_row<true>(w, gi, 0);  // rows r, r + 1 of the tile
      const uint32_t box = As + (r >> 5) * (32 * 128);
      const int k = 8 * s + ti;
      const float2 lo = lds2(box + swz128(k, r & 31));
      const float2 hi = lds2(box + swz128(k + 4, r & 31));
      af[s][0] = to_tf32(lo.x);
      af[s][1] = to_tf32(lo.y);
      af[s][2] = to_tf32(hi.x);
      af[s][3] = to_tf32(hi.y);
    } else {
      const int r = frag_row<false>(w, gi, 0);
      const int k = 8 * s + ti;
      af[s][0] = to_tf32(lds(As + swz128(r, k)));
      af[s][1] = to_tf32(lds(As + swz128(r + 8, k)));
      af[s][2] = to_tf32(lds(As + swz128(r, k + 4)));
      af[s][3] = to_tf32(lds(As + swz128(r + 8, k + 4)));
    }
  }
}

// W of one stage as wgmma reads it (WMode): an n-major W is rounded in
// place; a k-major W, landed as 32 rows of BN columns, is rewritten into
// Wt, transposed; a ready W is left.
template <int BN, WMode M>
__device__ __forceinline__ void round_w(uint32_t Ws, uint32_t Wt) {
  if constexpr (M == kWReady) {
    return;
  } else if constexpr (M == kWInPlace) {
    for (int i = threadIdx.x; i < BN * kBK / 4; i += kThreads) {
      const float4 v = lds4(Ws + 16 * i);
      sts4(Ws + 16 * i, to_tf32(v.x), to_tf32(v.y), to_tf32(v.z),
           to_tf32(v.w));
    }
  } else {
    // task (n, chunk j): Wt row n, k 4 j .. 4 j + 3
    for (int i = threadIdx.x; i < BN * kBK / 4; i += kThreads) {
      const int n = i % BN, j = i / BN;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = to_tf32(lds(Ws + ((4 * j + e) * BN + n) * 4));
      sts4(Wt + swz128(n, 4 * j), v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace tc

// blockIdx = (column tile, row tile, group * splits + split), as
// gemm_kernel.  Warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block
// tile and every column; accumulator acc[4 j + e] of lane (gi, ti) in warp
// w is fragment row gi + 8 (e / 2) (the tile's row frag_row), column 8 j +
// 2 ti + e % 2.
template <int BN, bool kATrans, tc::WMode kW, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w, GemmArgs a,
                      Epi epi) {
  using namespace tc;
  constexpr bool kWt = kW == kWTranspose;
  constexpr int S = stages<BN, kW>();
  constexpr uint32_t kWBytes = w_bytes<BN>();
  constexpr uint32_t kSlot = kABytes + kWBytes;
  extern __shared__ float4 gemm_smem[];
  const uint32_t ring = (smem_addr(gemm_smem) + 1023) & ~1023u;
  const uint32_t wt = ring + S * kSlot;  // a transposed W's double buffer
  const uint32_t bars = wt + (kWt ? 2 * kWBytes : 0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * kBM;
  const int g = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int kbeg = split * a.k_per_split;
  const int kend = min(a.K, kbeg + a.k_per_split);
  const int ktiles = cdiv(kend - kbeg, kBK);

  // stage j of the split into slot j % S
  auto issue = [&](int j) {
    const uint32_t slot = ring + (j % S) * kSlot, bar = bars + 8 * (j % S);
    const int k = kbeg + j * kBK;
    mbar_expect(bar, kSlot);
    if constexpr (kATrans) {
#pragma unroll
      for (int q = 0; q < kBM / 32; ++q)
        tma_load(slot + q * (32 * 128), &map_a, r0 + 32 * q, k, g, bar);
    } else {
      tma_load(slot, &map_a, k, r0, g, bar);
    }
    if constexpr (kWt)
      tma_load(slot + kABytes, &map_w, n0, k, g, bar);
    else
      tma_load(slot + kABytes, &map_w, k, n0, g, bar);
  };
  // W of stage j as wgmma reads it
  auto w_of = [&](int j) {
    return kWt ? wt + (j & 1) * kWBytes : ring + (j % S) * kSlot + kABytes;
  };
  // stage j landed: its A fragments into af, its W rounded for wgmma
  auto prepare = [&](int j, uint32_t(&af)[4][4]) {
    const uint32_t slot = ring + (j % S) * kSlot;
    mbar_wait(bars + 8 * (j % S), (j / S) & 1);
    load_a<kATrans>(slot, warp, gi, ti, af);
    round_w<BN, kW>(slot + kABytes, w_of(j));
    fence_proxy_async();
  };
  // a slot nothing reads any more takes stage j + S
  auto release = [&](int j) {
    if (tid == 0 && j + S < ktiles) issue(j + S);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < S && j < ktiles; ++j) issue(j);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t af[4][4], an[4][4];
  prepare(0, an);
  __syncthreads();
  if (kWt) release(0);
  for (int kt = 0; kt < ktiles; ++kt) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) af[s][e] = an[s][e];
    const uint32_t wk = w_of(kt);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s)
      wgmma<BN>(acc, af[s], kmajor_desc(wk + 32 * s));
    wgmma_commit();
    if (kt + 1 < ktiles) prepare(kt + 1, an);
    wgmma_wait_all();
    fence_acc(acc);
    fence_frags(af);
    __syncthreads();  // stage kt + 1 is ready, stage kt's wgmmas are done
    release(kWt ? kt + 1 : kt);
  }

  // the tile's row of acc[4 j + e]
  auto tile_row = [&](int e) { return frag_row<kATrans>(warp, gi, e / 2); };
  if (a.splits > 1) {
    float* P = a.partials + ((size_t)split * a.groups + g) * a.rows * a.N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + tile_row(e);
        const int c = n0 + 8 * j + 2 * ti + e % 2;
        if (r < a.rows && c < a.N) P[(size_t)r * a.N + c] = acc[4 * j + e];
      }
    return;
  }
  float* C = a.C + g * a.c_gstride;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + tile_row(2 * h);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const int c = n0 + 8 * j + 2 * ti + e % 2;
        if (r < a.rows && c < a.N)
          C[r * a.ldc + c] = epi(g, c, acc[4 * j + e], sq);
      }
    if constexpr (Epi::kRowSquares) {
      // the row's squares in this tile sit in the four lanes of its group
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      if (ti == 0 && r < a.rows) epi.row_squares(r, blockIdx.x, sq);
    }
  }
}

// ---- tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no -lcuda), or
// null where the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-3 f32 map of (inner, outer, groups) elements, rows `ld` floats
// apart, groups `gstride` floats apart, boxes of (box0, box1, 1), zeros
// beyond the operand.  A single group takes a stride it never steps.
inline bool encode_map(CUtensorMap* map, const float* base, int inner,
                       int outer, int groups, long long ld,
                       long long gstride, int box0, int box1, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)groups};
  const cuuint64_t strides[2] = {
      (cuuint64_t)ld * 4,
      (cuuint64_t)(groups > 1 ? gstride : ld * outer) * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA's rules for an operand, which the chains' padded rows (ld = E4)
// meet: a 16-byte aligned base, row and group strides of whole 16-byte
// chunks.
inline bool tma_operands_ok(const GemmArgs& a) {
  return aligned16(a.A) && aligned16(a.W) && a.lda > 0 && a.ldw > 0 &&
         a.lda % 4 == 0 && a.ldw % 4 == 0 &&
         (a.groups == 1 || (a.a_gstride > 0 && a.w_gstride > 0 &&
                            a.a_gstride % 4 == 0 && a.w_gstride % 4 == 0));
}

// ---- W rounded once a call --------------------------------------------

// Row tiles from which W is rounded once a call into a K-major copy
// (round_w_once_kernel: W read and written once more) instead of once a
// block (every row tile rounds all of W in shared memory, beside the
// operand stream that sets the pace): from 8.  At 4 row tiles (the north
// star's G) the copy measured slower on the H100.
constexpr int kOnceTiles = 8;
inline bool rounds_w_once(const Product& q) {
  return cdiv(q.rows, kBM) >= kOnceTiles;
}
// Rows of the rounded copy: K rounded up to 16 bytes.
inline long long w_once_ld(int K) { return (K + 3) & ~3; }
inline size_t w_once_floats(const Product& q) {
  return rounds_w_once(q) ? (size_t)q.groups * q.N * w_once_ld(q.K) : 0;
}
inline size_t round64(size_t n) { return (n + 63) & ~(size_t)63; }

// Scratch a product needs at either precision: its split partials
// (scratch_floats), then, 256-byte aligned, the TF32 instance's rounded W.
inline size_t product_scratch(const Product& q, GemmTile t) {
  const size_t once = w_once_floats(q);
  return once > 0 ? round64(scratch_floats(q, t)) + once
                  : scratch_floats(q, t);
}
// The largest of n products' scratch: a chain runs them one at a time.
inline size_t product_scratch(const Product* q, const GemmTile* t, int n) {
  size_t m = 0;
  for (int i = 0; i < n; ++i) {
    const size_t x = product_scratch(q[i], t != nullptr ? t[i] : GemmTile{});
    m = x > m ? x : m;
  }
  return m;
}

// Wr[g][n][k] = tf32(W[g](k, n)), rows of ldr floats: an n-major W read
// along its rows; a k-major one through 32 x 32 tiles of shared memory
// (reads along n, writes along k).  Blocks of 32 x 8 threads, 32 k by 32
// columns each.
template <bool kWKMajor>
__global__ void __launch_bounds__(256)
    round_w_once_kernel(GemmArgs a, float* Wr, long long ldr) {
  __shared__ float tile[32][33];
  const int g = blockIdx.z;
  const float* W = a.W + g * a.w_gstride;
  float* R = Wr + (size_t)g * a.N * ldr;
  const int n0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  if constexpr (kWKMajor) {
    for (int i = ty; i < 32; i += 8) {  // tile[k][n] from W[k][n]
      const int k = k0 + i, n = n0 + tx;
      if (k < a.K && n < a.N) tile[i][tx] = W[k * a.ldw + n];
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      const int n = n0 + i, k = k0 + tx;
      if (n < a.N && k < a.K)
        R[n * ldr + k] = __uint_as_float(to_tf32(tile[tx][i]));
    }
  } else {
    for (int i = ty; i < 32; i += 8) {
      const int n = n0 + i, k = k0 + tx;
      if (n < a.N && k < a.K)
        R[n * ldr + k] = __uint_as_float(to_tf32(W[n * a.ldw + k]));
    }
  }
}

template <int BN, bool kATrans, tc::WMode kW, class Epi>
cudaError_t launch_tiles_tf32(const GemmArgs& a, const Epi& epi,
                              cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  const bool ok =
      (kATrans ? encode_map(&map_a, a.A, a.rows, a.K, a.groups, a.lda,
                            a.a_gstride, 32, 32, true)
               : encode_map(&map_a, a.A, a.K, a.rows, a.groups, a.lda,
                            a.a_gstride, kBK, kBM, true)) &&
      (kW == tc::kWTranspose
           ? encode_map(&map_w, a.W, a.N, a.K, a.groups, a.ldw, a.w_gstride,
                        BN, kBK, false)
           : encode_map(&map_w, a.W, a.K, a.N, a.groups, a.ldw, a.w_gstride,
                        kBK, BN, true));
  if (!ok) return cudaErrorInvalidValue;
  constexpr size_t smem = tc::smem_bytes<BN, kW>();
  auto kernel = gemm_wgmma_kernel<BN, kATrans, kW, Epi>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.N, BN), cdiv(a.rows, kBM), a.groups * a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(map_a, map_w, a, epi);
  return cudaGetLastError();
}

// gemm_f32's product on the tensor cores: the same plan (plan_product),
// then one GEMM kernel and the split sum when it splits.  W reaches wgmma
// rounded in place (n-major), rewritten (k-major) or, where rounds_w_once
// holds and `partials` has product_scratch's room, rounded once into a
// K-major copy after the partials.  A transposed A takes a k-major W (the
// layouts the chains run).
template <bool kATrans, bool kWKMajor, class Epi>
cudaError_t gemm_tf32(GemmArgs a, const Epi& epi, GemmTile tile,
                      float* partials, cudaStream_t stream) {
  static_assert(!kATrans || kWKMajor, "a transposed A takes a k-major W");
  if (!tma_operands_ok(a)) return cudaErrorInvalidValue;
  GemmPlan plan;
  cudaError_t err = plan_product<kWKMajor, Epi>(a, tile, partials, &plan);
  if (err != cudaSuccess) return err;
  const Product q{a.rows, a.N, a.K, a.groups, kWKMajor, !Epi::kRowSquares};
  if (partials != nullptr && rounds_w_once(q)) {
    const size_t split = a.splits > 1 ? (size_t)a.splits * a.groups * a.rows *
                                            a.N
                                      : 0;
    float* wr = partials + round64(split);
    const long long ldr = w_once_ld(a.K);
    const dim3 grid(cdiv(a.K, 32), cdiv(a.N, 32), a.groups);
    round_w_once_kernel<kWKMajor><<<grid, 256, 0, stream>>>(a, wr, ldr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    a.W = wr;
    a.ldw = ldr;
    a.w_gstride = (long long)a.N * ldr;
    err = plan.bn == 128
              ? launch_tiles_tf32<128, kATrans, tc::kWReady>(a, epi, stream)
              : launch_tiles_tf32<64, kATrans, tc::kWReady>(a, epi, stream);
  } else if constexpr (kWKMajor) {
    err = plan.bn == 128
              ? launch_tiles_tf32<128, kATrans, tc::kWTranspose>(a, epi, stream)
              : launch_tiles_tf32<64, kATrans, tc::kWTranspose>(a, epi, stream);
  } else {
    err = launch_tiles_tf32<64, kATrans, tc::kWInPlace>(a, epi, stream);
  }
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
