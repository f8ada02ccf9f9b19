// Staging of the streamed kernels for Hopper (sm_90a): stream_mix.cu and
// stream_bwd.cu include it.  Each batch row of kv (and, in the backward,
// of d_mix) crosses from device memory to the SM once, into a ring of row
// buffers in shared memory; every pass over the row then reads it there.
//
//   * A stage is one row (or one block's slice of a row): a few pieces of
//     contiguous bytes.  A piece whose address and size are multiples of
//     16 bytes goes by TMA's 1-D bulk copy (cp.async.bulk), completing on
//     the stage's mbarrier; any other piece by cp.async in 8- or 4-byte
//     chunks (bf16 and int8 rows at shapes such as M = 3, E = 1540 are not
//     16-byte multiples), completing with the thread's commit group.  Every
//     stage arrives once on its mbarrier and commits one group in every
//     thread, bulk bytes or not, so the waits count alike on both routes.
//   * Two stages: the copy of the next row is in flight while the current
//     one is computed (kStages).
//   * StagedRow<T> reads a staged row as KvRow reads one in device memory:
//     at(m, e), at4(m, j), int8 dequantised on read with the same __fmul_rn,
//     so row_softmax gives the same bits over either.
//   * Slices: a row too wide for one block's share of shared memory is cut
//     along E across a cluster of C blocks, each staging its slice of every
//     modality; partial sums of a row meet through distributed shared
//     memory and add in rank order.
//
// Numerics: f32 throughout; no fast-math, no flush-to-zero.

#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "pool_common.cuh"

namespace aecf {

namespace cg = cooperative_groups;

constexpr int kStages = 2;
// Shared memory a block may take (the H100's 227 KB).
constexpr int kBlockSmem = 227 * 1024;
// f32 bytes of one stage of a slice: the width cut picks the least power
// of two C (up to 8 blocks) that brings a stage under this.  It is sized
// on f32 whatever the feature type, so an int8 or bf16 row is cut as the
// f32 row of its shape and sums in the same order.
constexpr int kSliceBytes = 48 * 1024;

// ---- PTX -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}
// The barriers' initialisation, visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Generic-proxy reads of a buffer ordered before the async proxy's next
// write into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
template <int kG>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(kG)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Every committed group but the newest kStages - 1 has landed.
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
}

// ---- stages ---------------------------------------------------------------

// One piece of a stage: `bytes` from src (device memory) to dst (shared, 16-
// byte aligned), by route g (route_of).  g = 16: the leader issues one TMA
// copy (the stage's expect_tx counts it); else the group's threads (thread
// t of n) copy g-byte chunks with cp.async.
__device__ __forceinline__ void stage_piece(void* dst, const void* src,
                                            uint32_t bytes, int g,
                                            uint64_t* bar, int t, int n) {
  if (g == 16) {
    if (t == 0) bulk_copy(dst, src, bytes, bar);
    return;
  }
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (g == 8) {
    for (uint32_t o = 8 * t; o < bytes; o += 8 * n) cp_async<8>(d + o, s + o);
  } else {
    for (uint32_t o = 4 * t; o < bytes; o += 4 * n) cp_async<4>(d + o, s + o);
  }
}

// How a call stages a buffer: 16, by TMA, when every piece starts and
// ends on 16 bytes; else the widest cp.async chunk, 8 or 4 bytes, that
// divides them all.  `unit` is the byte size of every piece offset and
// length (row and slice widths) and `base` the buffer's address.
inline int route_of(const void* base, size_t unit) {
  const size_t a = (size_t)base | unit;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : 4;
}

// A staged row (or slice) of kv read as f32, as KvRow<T> reads device
// memory: modality m at p + m * ld; int8 dequantised per element with the
// row's scales in registers, float(q) * scale rounded on its own.
template <typename T>
struct StagedRow {
  const T* p;
  int ld;
  __device__ __forceinline__ StagedRow(const T* buf, const float* /*scales*/,
                                       int /*row*/, int /*M*/, int ld_)
      : p(buf), ld(ld_) {}
  __device__ __forceinline__ float at(int m, int e) const {
    return to_f32(p[m * ld + e]);
  }
  __device__ __forceinline__ float4 at4(int m, int j) const {
    return load4(p + m * ld + j);
  }
};

template <>
struct StagedRow<int8_t> {
  const int8_t* p;
  int ld;
  float s[kMaxM];
  __device__ __forceinline__ StagedRow(const int8_t* buf, const float* scales,
                                       int row, int M, int ld_)
      : p(buf), ld(ld_) {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      s[m] = m < M ? scales[(size_t)row * M + m] : 0.f;
  }
  __device__ __forceinline__ float at(int m, int e) const {
    return __fmul_rn((float)p[m * ld + e], s[m]);
  }
  __device__ __forceinline__ float4 at4(int m, int j) const {
    const char4 q = *reinterpret_cast<const char4*>(p + m * ld + j);
    return make_float4(__fmul_rn((float)q.x, s[m]), __fmul_rn((float)q.y, s[m]),
                       __fmul_rn((float)q.z, s[m]), __fmul_rn((float)q.w, s[m]));
  }
};

// Rounds a byte count up to a multiple of 16.
__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

// dst[h ld + e] = u[h E + e0 + e] for h < H, e < ne: the block's slice of
// the score vectors, copied to shared memory once.
__device__ __forceinline__ void load_slice(float* dst,
                                           const float* __restrict__ u, int H,
                                           int E, int e0, int ne, int ld) {
  for (int i = threadIdx.x; i < H * ne; i += blockDim.x) {
    const int h = i / ne;
    const int e = i - h * ne;
    dst[h * ld + e] = u[(size_t)h * E + e0 + e];
  }
}

// ---- slices -----------------------------------------------------------------

// The cut of a row along E across a cluster of C blocks: rank k owns the
// features [k es, min(E, (k + 1) es)), staged as M pieces `ld` elements
// apart (a multiple of 16, so every piece starts on 16 bytes in shared
// memory).
struct Slices {
  int C, es, ld;
};
// per_row_f32: f32 bytes a row's stage needs in one block.
inline Slices slices_of(int E, size_t per_row_f32) {
  int C = 1;
  while (C < 8 && per_row_f32 > (size_t)C * kSliceBytes) C *= 2;
  const int es = align4((E + C - 1) / C);
  return {C, es, (es + 15) & ~15};
}

// Blocks an SM of a persistent grid when the caller asks for `req` (the
// streamed plan, kernels/tiles.py): 0 takes `limit`, the most that run at
// once (blocks_per_sm); 1 .. limit is taken as asked; anything else is
// refused (-1).
inline int grid_per_sm(int req, int limit) {
  if (req == 0) return limit;
  return req >= 1 && req <= limit ? req : -1;
}

// Clusters of a persistent grid: `per_sm` blocks an SM, at most one row a
// cluster.
inline int clusters_of(int B, int C, int per_sm) {
  return max(1, min(B, max(1, per_sm * sm_count() / C)));
}

// The rows [first, end) that cluster q of n walks: contiguous, in order.
__device__ __forceinline__ void row_range(int B, int q, int n, int& first,
                                          int& end) {
  first = (int)((long long)q * B / n);
  end = (int)((long long)(q + 1) * B / n);
}

// Warp sums of N values a lane (N a power of two, at most 32) by recursive
// halving: each exchange sends the half of the values the lane does not
// keep, so the warp spends N - 1 + log2(32 / N) shuffles where a warp_sum
// of each value spends 5 N.  On return lane l holds the sum of value
// `idx` (the bits of l above log2(32 / N) pick it) in every lane of its
// group; the lanes with the low bits zero write it.  A fixed tree: the
// same inputs give the same bits.
template <int W, int kOff, int N>
__device__ __forceinline__ void warp_halve(float (&v)[N], int lane, int& idx) {
  const bool up = (lane & kOff) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = up ? v[i] : v[i + W];
    const float keep = up ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
  if (up) idx += W;
  if constexpr (W > 1) warp_halve<W / 2, kOff / 2>(v, lane, idx);
}
template <int N>
__device__ __forceinline__ float warp_sums(float (&v)[N], int lane,
                                           int& idx) {
  static_assert(N >= 2 && N <= 32 && (N & (N - 1)) == 0, "N: 2^k <= 32");
  idx = 0;
  warp_halve<N / 2, 16>(v, lane, idx);
  float s = v[0];
#pragma unroll
  for (int off = 16 / N; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}
template <int N>
__device__ __forceinline__ bool warp_sums_writer(int lane) {
  return (lane & (32 / N - 1)) == 0;
}

// The row's sums: fin[i] = sum over the warps (red[w][i], in order), then
// over the cluster's ranks in rank order through distributed shared
// memory (part: this rank's sums, two buffers alternated by the caller, so
// a rank's next write to one comes after every rank has passed the
// barrier that follows its reads).  Called by every thread after a block
// barrier that follows the writes to red; returns after one, fin ready.
template <int N>
__device__ __forceinline__ void reduce_rows(const float (*red)[N],
                                            float* part, float* fin, int C) {
  const int i = threadIdx.x;
  if (i < N) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w][i];
    (C > 1 ? part : fin)[i] = t;
  }
  if (C > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (i < N) {
      float t = 0.f;
      for (int r = 0; r < C; ++r) t += cl.map_shared_rank(part, r)[i];
      fin[i] = t;
    }
  }
  __syncthreads();
}

// The softmax of a row from its summed scores, lane-parallel: lane l < 16
// of a warp takes head l / 8 and slot l % 8 (kMaxM = 8: a head's slots are
// an aligned group of 8 lanes), so max and sum over M are three shuffles
// each.  Every warp of a block runs it on the same sums and gets the same
// bits.  The orders are fixed (a butterfly over the 8 lanes), not the
// resident chain's: the slices paths have no resident counterpart.
struct LaneRow {
  int h, m;    // this lane's head and slot
  bool valid;  // h < H and m < M
};
__device__ __forceinline__ LaneRow lane_row(int lane, int M, int H) {
  LaneRow r;
  r.h = lane / kMaxM;
  r.m = lane % kMaxM;
  r.valid = r.h < H && r.m < M;
  return r;
}
__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// a_h[m] of this lane's (h, m) (0 where not valid): s = (dot + c_h) +
// pad[m], then exp(s - max) / sum over the head's slots.
__device__ __forceinline__ float lane_softmax(const LaneRow& r, float dot,
                                              float c, float pad) {
  const float s = r.valid ? (dot + c) + pad : -INFINITY;
  const float mx = group8_max(s);
  const float e = r.valid ? expf(s - mx) : 0.f;
  const float den = group8_sum(e);
  return r.valid ? e / den : 0.f;
}

// The launch of a kernel in clusters of C blocks (C = 1: a plain launch),
// with `smem` bytes of dynamic shared memory, opted into above 48 KB.
template <typename... Args, typename... Actual>
cudaError_t launch_clusters(void (*kernel)(Args...), int blocks, int threads,
                            size_t smem, int C, cudaStream_t stream,
                            Actual&&... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Actual>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that run at once on one SM: registers, shared memory and threads
// counted by the runtime, so a persistent grid of this many blocks an SM
// is one wave.  Asked once a (kernel, threads, smem), then cached.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> known;
  const auto key = std::make_tuple((const void*)kernel, threads, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find(key);
    if (it != known.end()) return it->second;
  }
  int n = 0;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return 1;
  n = max(1, n);
  std::lock_guard<std::mutex> lock(mu);
  known[key] = n;
  return n;
}

}  // namespace aecf
