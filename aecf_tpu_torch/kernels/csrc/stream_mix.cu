// Streamed shared-query forward (the "mix" kernel) for Hopper (sm_90a).
//
// Replaces aecf_tpu/kernels/shared_query.py::_mix_kernel (launched by
// _forward_streamed), f32/bf16 features and its quantized=True branch
// (int8 with per-(row, modality) scales, dequantised on read): the
// forward of the streamed split, which takes the shared-query pools with
// H <= 2 above the resident kernel's cap (1024 < E <= 8192) and H == 2
// training from E = 512.  Per batch row b,
// with u (H, E) and c (H,) computed outside the kernel:
//
//   s_h[m] = kv[b, m] . u_h + c_h + pad[b, m]      (pad: 0 or -1e30)
//   a_h    = softmax_m(s_h);  w = mean_h(a_h);  ent, and in training the
//            Philox mask chain -> mw, rate           (pool_common.cuh)
//   mix[b, h E : (h + 1) E] = sum_m a_h[m] kv[b, m]  (unmasked: Q1)
//
// mix is stored in f32 at precision 'highest' and in bf16 at 'default'
// (mix_dtype; JAX's _stream_mix_dtype: the streamed split's mix and d_mix
// round trips are bf16 there), rounded to nearest even from the f32 sum:
// an output-type instance of the store, nothing else changes.
//
// The context GEMMs (out = mix W_vo^T + b_ctx for H == 1; the per-head V
// projection, then the output projection, for H == 2) run in cuBLAS
// outside the kernel, as the JAX package leaves them to XLA: the kernel
// holds no E x E matrix, so E is bounded by nothing but the caller's cap.
//
// What bounds it on the H100: bytes.  It must read kv (B M E) and write
// mix (B H E, f32 or bf16); its arithmetic, about (6 + 2H) B M E flops, is far
// below the SIMT rate.  So each kv row crosses from device memory once,
// into shared memory (stream_stage.cuh: TMA bulk copies where the row is a
// 16-byte multiple, cp.async otherwise), and the score pass and the mix
// both read it there; the copy of a warp's next row is in flight while
// its current row is computed (two buffers a warp).
//   * E <= 1024 (the resident widths; slice (h)): a warp a row, persistent
//     warps walking rows with a stride.  row_softmax and row_side_outputs
//     run the resident forward's chain in its order over the staged row,
//     so the two kernels give the same weights, entropy and mask bit for
//     bit for the same seed words; the mix reads four features a lane.
//   * E > 1024 (slices (f), (g), (i), (k)): a block a row, persistent
//     blocks walking contiguous rows, the scores summed in a fixed order
//     (four-feature chunks, warp_sums, warps); a row above 48 KB in f32
//     (up to M = 8, E = 8192: 256 KB) is cut along E across a cluster of
//     up to 8 blocks, its sums meeting through distributed shared memory
//     in rank order.
// int8 and bf16 rows take the path and cut of the f32 row of their shape,
// so they sum in its order.  Needs E % 4 == 0.  Tensor cores have nothing
// to do here.
//
// Measured on an H100 SXM (700 W) at B = 4096, M = 4, E = 2048, H = 1
// (bound 0.050 ms: 168 MB at 3.35 TB/s): 0.074 ms in training and 0.071
// ms in eval, where the warp-a-row kernel reading kv twice took 0.141 and
// 0.139; int8, eval, 0.054 ms (bound 0.020 ms: 67 MB; before, 0.085); at
// B = 8192, M = 4, E = 1024, H = 2, training, 0.098 ms (before, 0.156).
//
// The grid: as many blocks an SM as the kernel's registers and shared
// memory let run at once (one wave), or fewer where the caller asks
// (blocks_per_sm, the streamed plan; kernels/tiles.py).  Rows are
// independent, so the grid changes no bit of the result.
//
// Numerics: f32 throughout; the entropy floors w at the subnormal 1e-38,
// so this file is built without fast-math and without flush-to-zero.

#include "stream_stage.cuh"

using namespace aecf;

namespace {

// The widest E the resident forward takes: up to it the streamed forward
// runs the resident kernel's row chain (a warp a row), above it the slices
// path.
constexpr int kResidentE = 1024;

struct MixArgs {
  const void* kv;       // (B, M, E) f32, bf16 or int8
  const float* scales;  // (B, M), int8 only
  const float* u;       // (H, E)
  const float* c;       // (H,)
  const float* pad;     // (B, M) or null
  void* mix;            // (B, H E) f32 or bf16 (the store's type O)
  float *w, *mw, *ent, *rate;
  int B, M, E, H;
  int g;                // the route of kv's pieces (route_of)
  int slot;             // bytes of a warp row buffer (rows path)
  Slices sl;            // the cut of a row (slices path)
};

// Rows path: a warp a row, as the resident forward's R1.  Warp gw of n walks
// the rows gw, gw + n, ... through its own two row buffers; lane 0 issues
// the next row's copy before the current one is computed.  row_softmax
// reads the staged row in the resident kernel's order (lane l: e = l, l +
// 32, ...), so weights, entropy and mask equal R1's bit for bit; the mix
// then reads it four features a lane.
template <typename T, typename O, bool kTraining>
__global__ void __launch_bounds__(kThreads) stream_mix_rows(MixArgs p,
                                                            MaskParams mp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int M = p.M, E = p.E, H = p.H;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + kStages * warp;
  float* us = reinterpret_cast<float*>(smem + 128);  // u (H, E)
  unsigned char* buf =
      smem + 128 + align16(H * E * 4) + (size_t)warp * kStages * p.slot;
  const int gw = blockIdx.x * nw + warp;
  const int stride = gridDim.x * nw;
  const int n = gw < p.B ? (p.B - 1 - gw) / stride + 1 : 0;
  const T* kv = static_cast<const T*>(p.kv);
  const uint32_t bytes = (uint32_t)((size_t)M * E * sizeof(T));
  if (lane == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(bar + s);
  fence_barrier_init();
  for (int i = threadIdx.x; i < H * E; i += blockDim.x) us[i] = p.u[i];
  float cr[kMaxH];
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) cr[h] = h < H ? p.c[h] : 0.f;
  __syncthreads();

  auto issue = [&](int k) {  // row k of the warp's walk into buffer k % 2
    if (k < n) {
      const int s = k % kStages;
      const int row = gw + k * stride;
      if (lane == 0) {
        fence_proxy_async();
        mbar_arrive_expect(bar + s, p.g == 16 ? bytes : 0u);
      }
      stage_piece(buf + (size_t)s * p.slot, kv + (size_t)row * M * E, bytes,
                  p.g, bar + s, lane, 32);
    }
    cp_async_commit();
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < n; ++k) {
    issue(k + kStages - 1);
    const int s = k % kStages;
    const int row = gw + k * stride;
    float padv[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      padv[m] = p.pad != nullptr && m < M ? p.pad[(size_t)row * M + m] : 0.f;
    cp_async_wait_stage();
    mbar_wait(bar + s, (k / kStages) & 1);
    __syncwarp();
    const StagedRow<T> kvr(
        reinterpret_cast<const T*>(buf + (size_t)s * p.slot), p.scales, row,
        M, E);
    float a[kMaxH][kMaxM];
    float w[kMaxM];
    row_softmax(kvr, us, cr, p.pad != nullptr ? padv : nullptr, M, E, H, a,
                w);
    row_side_outputs<kTraining>(w, row, M, mp, p.w, p.mw, p.ent, p.rate);
    O* mixr = static_cast<O*>(p.mix) + (size_t)row * H * E;
    for (int j = 4 * lane; j < E; j += 4 * 32) {
      float4 acc[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float4 x = kvr.at4(m, j);
#pragma unroll
          for (int h = 0; h < kMaxH; ++h)
            if (h < H) acc[h] = axpy4(a[h][m], x, acc[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        if (h < H) store4(mixr + (size_t)h * E + j, acc[h]);
    }
    __syncwarp();  // the buffer is free for row k + 2
  }
}

// Slices path, for rows wider than the resident kernel takes (E > 1024): a
// cluster of C blocks takes a row at a time (C = 1 up to 48 KB of f32 row),
// rank k staging features [k es, k es + es) of every modality; the cluster
// walks a contiguous range of rows.  Scores: a thread's four-feature
// chunks in order, warp_sums, warps in order, ranks in order
// (reduce_rows); every warp then runs the softmax lane-parallel on those
// sums (lane_softmax), each rank mixes its slice, and one warp of rank 0
// writes the side outputs.
template <typename T, typename O, bool kTraining>
__global__ void __launch_bounds__(kThreads) stream_mix_slices(MixArgs p,
                                                              MaskParams mp) {
  constexpr int kN = kMaxH * kMaxM;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kWarps][kN];
  __shared__ float part[2][kN];
  __shared__ float fin[kN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int M = p.M, E = p.E, H = p.H;
  const int C = p.sl.C, ld = p.sl.ld;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* us = reinterpret_cast<float*>(smem + 128);  // u's slice (H, ld)
  unsigned char* buf = smem + 128 + align16(H * ld * 4);
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int e0 = rank * p.sl.es;
  const int ne = max(0, min(p.sl.es, E - e0));
  int first, end;
  row_range(p.B, blockIdx.x / C, gridDim.x / C, first, end);
  const int n = end - first;
  const T* kv = static_cast<const T*>(p.kv);
  const size_t stage = (size_t)M * ld * sizeof(T);
  const uint32_t bytes = (uint32_t)(ne * sizeof(T));
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(bar + s);
  fence_barrier_init();
  load_slice(us, p.u, H, E, e0, ne, ld);
  const LaneRow lr = lane_row(lane, M, H);
  const float cl = lr.valid ? p.c[lr.h] : 0.f;
  __syncthreads();

  auto issue = [&](int k) {
    if (k < n) {
      const int s = k % kStages;
      const size_t row = first + k;
      if (threadIdx.x == 0) {
        fence_proxy_async();
        mbar_arrive_expect(bar + s, p.g == 16 ? M * bytes : 0u);
      }
      for (int m = 0; m < M; ++m)
        stage_piece(buf + s * stage + (size_t)m * ld * sizeof(T),
                    kv + (row * M + m) * E + e0, bytes, p.g, bar + s,
                    threadIdx.x, blockDim.x);
    }
    cp_async_commit();
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < n; ++k) {
    issue(k + kStages - 1);
    const int s = k % kStages;
    const int row = first + k;
    const float padl = lr.valid && p.pad != nullptr
                           ? p.pad[(size_t)row * M + lr.m] : 0.f;
    cp_async_wait_stage();
    mbar_wait(bar + s, (k / kStages) & 1);
    __syncthreads();
    const StagedRow<T> kvr(reinterpret_cast<const T*>(buf + s * stage),
                           p.scales, row, M, ld);
    float sc[kMaxH][kMaxM];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) sc[h][m] = 0.f;
    for (int j = 4 * threadIdx.x; j < ne; j += 4 * kThreads) {
      float4 uh[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        uh[h] = h < H ? load4(us + h * ld + j)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float4 x = kvr.at4(m, j);
#pragma unroll
          for (int h = 0; h < kMaxH; ++h) sc[h][m] = dot4(x, uh[h], sc[h][m]);
        }
      }
    }
    float v[kN];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) v[h * kMaxM + m] = sc[h][m];
    int idx;
    const float t = warp_sums<kN>(v, lane, idx);
    if (warp_sums_writer<kN>(lane)) red[warp][idx] = t;
    __syncthreads();
    reduce_rows<kN>(red, part[k & 1], fin, C);
    const float al = lane_softmax(lr, lr.valid ? fin[lane] : 0.f, cl, padl);
    // the head mean, in lanes m < 8: (a_0 + a_1) / H
    const float wl =
        (H > 1 ? al + __shfl_down_sync(0xffffffffu, al, kMaxM) : al) *
        (1.0f / (float)H);
    float w[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      w[m] = __shfl_sync(0xffffffffu, wl, m);
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        sc[h][m] = __shfl_sync(0xffffffffu, al, h * kMaxM + m);  // a_h[m]
    }
    O* mixr = static_cast<O*>(p.mix) + (size_t)row * H * E + e0;
    for (int j = 4 * threadIdx.x; j < ne; j += 4 * kThreads) {
      float4 acc[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float4 x = kvr.at4(m, j);
#pragma unroll
          for (int h = 0; h < kMaxH; ++h)
            if (h < H) acc[h] = axpy4(sc[h][m], x, acc[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        if (h < H) store4(mixr + (size_t)h * E + j, acc[h]);
    }
    __syncthreads();  // the stage is free for row k + kStages
    // the side outputs need only w: one warp a row, in turn, writes them
    // while the others go on to the next row
    if (warp == k % kWarps && rank == 0)
      row_side_outputs<kTraining>(w, row, M, mp, p.w, p.mw, p.ent, p.rate);
  }
  if (C > 1) cg::this_cluster().sync();  // ranks read each other's part
}

// A call's launch: its path, threads, shared memory and the blocks an SM
// that run at once (the limit of the plan's blocks_per_sm, the f32 store's
// for both stores: rows are independent, so the grid changes no bit);
// fills the path's fields of `a`.
struct MixLaunch {
  bool rows;
  int threads;
  size_t smem;
  int per_sm;
};

template <typename T, bool kTraining>
MixLaunch mix_launch(MixArgs& a) {
  if (a.E <= kResidentE) {
    a.slot = (int)align16(a.M * a.E * sizeof(T));
    a.g = route_of(a.kv, (size_t)a.M * a.E * sizeof(T));
    const size_t head = 128 + align16(a.H * a.E * 4);
    const int nw = max(1, min(kWarps, (int)((kBlockSmem - head) /
                                            (kStages * a.slot))));
    const size_t smem = head + (size_t)nw * kStages * a.slot;
    return {true, 32 * nw, smem,
            blocks_per_sm(stream_mix_rows<T, float, kTraining>, 32 * nw,
                          smem)};
  }
  a.sl = slices_of(a.E, (size_t)a.M * a.E * 4);
  a.g = route_of(a.kv,
                 (size_t)a.sl.es * sizeof(T) | (size_t)a.E * sizeof(T));
  const size_t smem = 128 + align16(a.H * a.sl.ld * 4) +
                      (size_t)kStages * a.M * a.sl.ld * sizeof(T);
  return {false, kThreads, smem,
          blocks_per_sm(stream_mix_slices<T, float, kTraining>, kThreads,
                        smem)};
}

template <typename T, typename O, bool kTraining>
cudaError_t launch(MixArgs a, const MaskParams& mp, int req,
                   cudaStream_t stream) {
  const MixLaunch l = mix_launch<T, kTraining>(a);
  const int per_sm = grid_per_sm(req, l.per_sm);
  if (per_sm < 1) return cudaErrorInvalidValue;
  if (l.rows) {
    const int nw = l.threads / 32;
    const int blocks = max(1, min((a.B + nw - 1) / nw, per_sm * sm_count()));
    return launch_clusters(stream_mix_rows<T, O, kTraining>, blocks,
                           l.threads, l.smem, 1, stream, a, mp);
  }
  const int clusters = clusters_of(a.B, a.sl.C, per_sm);
  return launch_clusters(stream_mix_slices<T, O, kTraining>,
                         clusters * a.sl.C, l.threads, l.smem, a.sl.C, stream,
                         a, mp);
}

// The instance of the call's kv dtype and branch storing mix as O.
template <typename O>
cudaError_t launch_stored(MixArgs a, const MaskParams& mp, int kv_dtype,
                          int req, cudaStream_t s) {
  const bool t = mp.training != 0;
  switch (kv_dtype) {
    case kKvF32:
      return t ? launch<float, O, true>(a, mp, req, s)
               : launch<float, O, false>(a, mp, req, s);
    case kKvBf16:
      return t ? launch<__nv_bfloat16, O, true>(a, mp, req, s)
               : launch<__nv_bfloat16, O, false>(a, mp, req, s);
    case kKvInt8:
      return t ? launch<int8_t, O, true>(a, mp, req, s)
               : launch<int8_t, O, false>(a, mp, req, s);
  }
  return cudaErrorInvalidValue;
}

template <bool kTraining>
int occupancy(MixArgs& a, int kv_dtype) {
  switch (kv_dtype) {
    case kKvF32: return mix_launch<float, kTraining>(a).per_sm;
    case kKvBf16: return mix_launch<__nv_bfloat16, kTraining>(a).per_sm;
    case kKvInt8: return mix_launch<int8_t, kTraining>(a).per_sm;
  }
  return -1;
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 means the launch was accepted.  kv is (B, M, E)
// f32 (kv_dtype = 0), bf16 (1) or int8 (2, with scales (B, M) f32, read
// for int8 only), aligned to four elements; pad may be null (no padding);
// mix is (B, H E) f32 (mix_dtype = 0) or bf16 (1), 16-byte aligned; w, mw
// (B, M), ent, rate (B,).  All contiguous device buffers.  training = 0 is
// the eval branch (seed words, mask_prob and min_active unread).
// blocks_per_sm: the persistent grid's blocks an SM, 1 up to
// aecf_stream_mix_occupancy, or 0 for that limit.
int aecf_stream_mix(const void* kv, int kv_dtype, const float* scales,
                    const float* u, const float* c, const float* pad,
                    void* mix, float* w,
                    float* mw, float* ent, float* rate, int B, int M, int E,
                    int H, float max_entropy, int training,
                    unsigned int seed0, unsigned int seed1, float mask_prob,
                    int min_active, int mix_dtype, int blocks_per_sm,
                    void* stream) {
  if (B < 1 || M < 1 || M > kMaxM || H < 1 || H > kMaxH || E < 4 ||
      E % 4 != 0 || (kv_dtype == kKvInt8 && scales == nullptr) ||
      (mix_dtype != kKvF32 && mix_dtype != kKvBf16)) {
    return (int)cudaErrorInvalidValue;
  }
  MaskParams mp;
  mp.max_entropy = max_entropy;
  mp.mask_prob = mask_prob;
  mp.min_active = min_active;
  mp.training = training;
  mp.seed0 = seed0;
  mp.seed1 = seed1;
  MixArgs a = {};
  a.kv = kv;
  a.scales = scales;
  a.u = u;
  a.c = c;
  a.pad = pad;
  a.mix = mix;
  a.w = w;
  a.mw = mw;
  a.ent = ent;
  a.rate = rate;
  a.B = B;
  a.M = M;
  a.E = E;
  a.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mix_dtype == kKvBf16
                   ? launch_stored<__nv_bfloat16>(a, mp, kv_dtype,
                                                  blocks_per_sm, s)
                   : launch_stored<float>(a, mp, kv_dtype, blocks_per_sm, s));
}

// The most blocks an SM of aecf_stream_mix's persistent grid at (M, E, H)
// for the kv dtype and branch (the limit of its blocks_per_sm); -1 for
// arguments it refuses.
int aecf_stream_mix_occupancy(int M, int E, int H, int kv_dtype,
                              int training) {
  if (M < 1 || M > kMaxM || H < 1 || H > kMaxH || E < 4 || E % 4 != 0)
    return -1;
  MixArgs a = {};
  a.M = M;
  a.E = E;
  a.H = H;
  return training ? occupancy<true>(a, kv_dtype)
                  : occupancy<false>(a, kv_dtype);
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
