// Streamed shared-query backward, H == 1 and H == 2, for Hopper (sm_90a).
//
// Replaces aecf_tpu/kernels/shared_query.py::_bwd_kernel_streamed (H == 1,
// launched by _bwd_streamed) and ::_bwd_kernel_streamed_mh (H >= 2, by
// _bwd_streamed_mh; here H == 2, the streamed split's widest), f32/bf16
// features and their quantized=True branches (int8 with per-(row,
// modality) scales, dequantised on read; frozen, so no d_kv): the
// backward of the streamed split.  The GEMMs that need an E x E matrix
// (d_mix = d_out W_vo and G = d_out^T mix for H == 1; the per-head
// output/V-projection backward for H == 2) run in cuBLAS before this
// kernel, as the JAX package runs them in XLA.  Per batch row b, with the
// score vectors u (H, E) and offsets c (H,):
//
//   recompute  a_h = softmax_m(kv[b, m] . u_h + c_h + pad[b, m])
//   d_a_h[m] = d_mix_h . kv[b, m] + d_w[m] / H;  d_s_h = a_h (d_a_h - a_h . d_a_h)
//   d_kv[m]  = sum_h (a_h[m] d_mix_h + d_s_h[m] u_h)   (optional, kv dtype)
// and the batch sums du_h = sum_b sum_m d_s_h kv and dc_h = sum_b sum_m d_s_h.
//
// d_mix comes in f32 at precision 'highest' and in bf16 at 'default'
// (dmix_dtype; JAX's _stream_mix_dtype: the streamed split's round trips
// are bf16 there): the bf16 row is staged as it is and read through the
// staged-row reader kv's bf16 rows use (StagedRow<__nv_bfloat16>), so
// only its bytes and its upcast change; the cut, the grid and every sum's
// order are the f32 call's.
//
// What bounds it on the H100: bytes.  It must read kv (B M E) and d_mix
// (B H E, f32 or bf16), and write d_kv when asked; the arithmetic, about (8 + 6H)
// B M E flops, is far below the SIMT rate.  So each kv row and each d_mix
// row crosses from device memory once, into shared memory
// (stream_stage.cuh: TMA bulk copies where the pieces are 16-byte
// multiples, cp.async otherwise; two stages, the next row's copy in flight
// while the current one is computed), and both phases read it there.  A
// fixed grid of persistent clusters — as many blocks an SM as the f32
// call's registers and shared memory let run at once, whatever B — each
// walks a contiguous range of rows; a row wider than a block's stage
// (above 48 KB of kv and d_mix in f32, e.g. M = 8, E = 8192) is cut along
// E across a cluster of up to 8 blocks, the row's sums meeting through
// distributed shared memory in rank order.  du stays in shared memory and
// dc in a register across the cluster's rows; each cluster then writes one
// partial row, and part_sum (pool_rows.cuh) adds the partial rows in a
// fixed order — the TPU kernel adds du/dc into one VMEM block across its
// sequential grid.  No atomics: two calls agree bit for bit.  int8 and
// bf16 calls take the f32 call's cut and grid, so an int8 call sums in the
// f32 call's order.  Needs E % 4 == 0.  The grid's blocks an SM may come
// from the caller (StreamBwdParams.blocks_per_sm, the streamed plan;
// kernels/tiles.py resolves it from the f32 call's key, so every dtype
// takes one grid), 1 up to the f32 kernel's occupancy; 0 is that limit.
//
// Measured on an H100 SXM (700 W), f32, no d_kv: 0.069 ms at B = 4096,
// M = 4, E = 2048, H = 1 (bound 0.050 ms; with d_kv 0.122 ms, bound
// 0.090); 0.085 ms at B = 8192, M = 4, E = 1024, H = 2 (bound 0.060 ms).
// int8, no d_kv: 0.065 ms (bound 0.020 ms) and 0.089 ms (bound 0.030 ms)
// at the same shapes: the int8 call keeps the f32 call's grid and per-row
// chain (so it sums in its order), and that chain, not the bytes, bounds
// it.  The kernel this design replaced (16 rows a block, kv read twice,
// a column sum over B / 16 partial rows) took 0.134, 0.209, 0.198, 0.114
// and 0.156 ms there.

#include "pool_rows.cuh"
#include "stream_stage.cuh"

using namespace aecf;

// Also declared, field for field, by kernels/shared_query.py (ctypes).
struct StreamBwdParams {
  const void* kv;     // (B, M, E) f32, bf16 or int8 (kv_dtype)
  const float* scales;  // (B, M) dequant scales, int8 only
  const void* dmix;   // (B, H E) f32 or bf16 (dmix_dtype)
  const float* dw;    // (B, M) or null: the weights cotangent (head mean)
  const float* pad;   // (B, M) or null
  const float* u;     // (H, E)
  const float* c;     // (H,)
  void* dkv;          // (B, M, E) kv dtype, or null: no d_kv (int8: null)
  float* acc;         // (H E + H): du_0 .. du_{H-1} | dc
  float* ws;          // aecf_stream_bwd_workspace floats
  int B, M, E, kv_dtype;  // KvDtype: 0 f32, 1 bf16, 2 int8
  int dmix_dtype;         // KvDtype: 0 f32, 1 bf16
  int blocks_per_sm;      // the grid's, 1 .. occupancy; 0: the occupancy
};

namespace {

// The schedule of a call: the cut of a row (C blocks a row, a cluster) and
// the routes of kv's and d_mix's pieces (stream_stage.cuh).
struct BwdPlan {
  Slices sl;
  int kv_g, dm_g;  // route_of kv's and d_mix's pieces
};

// Shared memory of a block: du and u's slice (H ld f32 each), then kStages
// stages of kv (M ld elements) and d_mix (H ld elements).
size_t bwd_smem(const Slices& sl, int M, int H, size_t kv_size,
                size_t dm_size) {
  return 128 + 2 * (size_t)H * sl.ld * 4 +
         kStages * (align16((size_t)M * sl.ld * kv_size) +
                    (size_t)H * sl.ld * dm_size);
}
Slices bwd_slices(int M, int E, int H) {
  return slices_of(E, (size_t)(M + H) * E * 4);  // a stage: kv and d_mix
}

// A cluster of C blocks walks a contiguous range of rows, rank k owning the
// features [k es, k es + es) of each.  Per row, staged once (kv's M pieces
// and d_mix's H pieces, two stages): phase A takes the scores and d_a =
// d_mix_h . kv[m] in one pass (a thread's four-feature chunks, warp_sums,
// warps in order, ranks in order), then every warp runs the softmax and
// its backward lane-parallel on the sums (lane_softmax) and keeps a and
// d_s in shared memory for its lanes; phase B adds d_s kv into the block's
// du slice (shared memory, each thread its own chunks, rows in order) and
// writes d_kv.  After its last row the cluster writes one partial row,
// du | dc.
template <typename T, typename D, int kH>
__global__ void __launch_bounds__(kThreads) stream_bwd_kernel(
    StreamBwdParams p, BwdPlan pl) {
  constexpr int kN = 2 * kH * kMaxM;  // s_h[m] | d_a_h[m]
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kWarps][kN];
  __shared__ float part[2][kN];
  __shared__ float fin[kN];
  __shared__ float aw[kWarps][32];   // a_h[m] at h kMaxM + m, a warp's copy
  __shared__ float dsw[kWarps][32];  // d_s_h[m], likewise
  const int E = p.E, M = p.M;
  const int C = pl.sl.C, ld = pl.sl.ld;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int q = blockIdx.x / C;
  const int e0 = rank * pl.sl.es;
  const int ne = max(0, min(pl.sl.es, E - e0));
  int first, end;
  row_range(p.B, q, gridDim.x / C, first, end);
  const int n = end - first;
  const T* kv = static_cast<const T*>(p.kv);
  const D* dmix = static_cast<const D*>(p.dmix);
  T* dkv = static_cast<T*>(p.dkv);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* du = reinterpret_cast<float*>(smem + 128);  // kH x ld
  float* us = du + kH * ld;                           // u's slice, kH x ld
  unsigned char* buf = smem + 128 + (size_t)2 * kH * ld * 4;
  const size_t kv_bytes = align16((size_t)M * ld * sizeof(T));
  const size_t stage = kv_bytes + (size_t)kH * ld * sizeof(D);
  const uint32_t kv_piece = (uint32_t)(ne * sizeof(T));
  const uint32_t dm_piece = (uint32_t)(ne * sizeof(D));
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(bar + s);
  fence_barrier_init();
  for (int j = 4 * threadIdx.x; j < ne; j += 4 * kThreads)
#pragma unroll
    for (int h = 0; h < kH; ++h)
      store4(du + h * ld + j, make_float4(0.f, 0.f, 0.f, 0.f));
  load_slice(us, p.u, kH, E, e0, ne, ld);
  const LaneRow lr = lane_row(lane, M, kH);
  const float cl = lr.valid ? p.c[lr.h] : 0.f;
  __syncthreads();

  auto issue = [&](int k) {
    if (k < n) {
      const int s = k % kStages;
      const size_t row = first + k;
      unsigned char* st = buf + s * stage;
      if (threadIdx.x == 0) {
        fence_proxy_async();
        mbar_arrive_expect(bar + s, (pl.kv_g == 16 ? M * kv_piece : 0u) +
                                        (pl.dm_g == 16 ? kH * dm_piece : 0u));
      }
      for (int m = 0; m < M; ++m)
        stage_piece(st + (size_t)m * ld * sizeof(T),
                    kv + (row * M + m) * E + e0, kv_piece, pl.kv_g, bar + s,
                    threadIdx.x, kThreads);
      for (int h = 0; h < kH; ++h)
        stage_piece(st + kv_bytes + (size_t)h * ld * sizeof(D),
                    dmix + (row * kH + h) * E + e0, dm_piece, pl.dm_g,
                    bar + s, threadIdx.x, kThreads);
    }
    cp_async_commit();
  };

  float dc[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) dc[h] = 0.f;
  const float inv_h = 1.0f / (float)kH;
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < n; ++k) {
    issue(k + kStages - 1);
    const int s = k % kStages;
    const int row = first + k;
    const size_t slot = (size_t)row * M + lr.m;
    const float padl = lr.valid && p.pad != nullptr ? p.pad[slot] : 0.f;
    const float dwl = lr.valid && p.dw != nullptr ? p.dw[slot] : 0.f;
    cp_async_wait_stage();
    mbar_wait(bar + s, (k / kStages) & 1);
    __syncthreads();
    const StagedRow<T> kvr(reinterpret_cast<const T*>(buf + s * stage),
                           p.scales, row, M, ld);
    const StagedRow<D> dmr(reinterpret_cast<const D*>(buf + s * stage +
                                                      kv_bytes),
                           nullptr, row, kH, ld);

    // ---- phase A: scores and d_a, summed over the cluster ----------------
    float sc[kMaxH][kMaxM];
    float da[kMaxH][kMaxM];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) sc[h][m] = da[h][m] = 0.f;
    for (int j = 4 * threadIdx.x; j < ne; j += 4 * kThreads) {
      float4 uh[kH];
      float4 dm[kH];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        uh[h] = load4(us + h * ld + j);
        dm[h] = dmr.at4(h, j);
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float4 x = kvr.at4(m, j);
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            sc[h][m] = dot4(x, uh[h], sc[h][m]);
            da[h][m] = dot4(x, dm[h], da[h][m]);
          }
        }
      }
    }
    float v[kN];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        v[h * kMaxM + m] = sc[h][m];
        v[(kH + h) * kMaxM + m] = da[h][m];
      }
    int idx;
    const float t = warp_sums<kN>(v, lane, idx);
    if (warp_sums_writer<kN>(lane)) red[warp][idx] = t;
    __syncthreads();
    reduce_rows<kN>(red, part[k & 1], fin, C);

    // ---- the softmax and its backward: lane-parallel, in every warp --------
    const float al = lane_softmax(lr, lr.valid ? fin[lane] : 0.f, cl, padl);
    const float dal =
        lr.valid ? fin[kH * kMaxM + lane] + dwl * inv_h : 0.f;  // d_a
    const float dsl = al * (dal - group8_sum(al * dal));         // d_s
    // the warp's copy of a and d_s, read by its lanes in phase B
    aw[warp][lane] = al;
    dsw[warp][lane] = dsl;
    __syncwarp();
    const float dcl = group8_sum(dsl);  // sum_m d_s_h, in lane 8 h
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float t = __shfl_sync(0xffffffffu, dcl, h * kMaxM);
      if (threadIdx.x == 0 && rank == 0) dc[h] += t;
    }
    // ---- phase B: du into the block's slice, d_kv --------------------------
    for (int j = 4 * threadIdx.x; j < ne; j += 4 * kThreads) {
      float4 acc[kH];
#pragma unroll
      for (int h = 0; h < kH; ++h) acc[h] = load4(du + h * ld + j);
      float4 uh[kH];
      float4 dm[kH];
      if (dkv != nullptr) {
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          uh[h] = load4(us + h * ld + j);
          dm[h] = dmr.at4(h, j);
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float4 x = kvr.at4(m, j);
#pragma unroll
          for (int h = 0; h < kH; ++h)
            acc[h] = axpy4(dsw[warp][h * kMaxM + m], x, acc[h]);
          if constexpr (!kQuantized<T>) {
            if (dkv != nullptr) {
              float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int h = 0; h < kH; ++h) {
                g = axpy4(aw[warp][h * kMaxM + m], dm[h], g);
                g = axpy4(dsw[warp][h * kMaxM + m], uh[h], g);
              }
              store4(dkv + ((size_t)row * M + m) * E + e0 + j, g);
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kH; ++h) store4(du + h * ld + j, acc[h]);
    }
    __syncthreads();  // the stage is free for row k + 2
  }

  // ---- the cluster's partial row: du | dc ----------------------------------
  float* prow = p.ws + (size_t)q * (kH * E + kH);
  for (int j = 4 * threadIdx.x; j < ne; j += 4 * kThreads)
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float4 v = load4(du + h * ld + j);
      float* o = prow + (size_t)h * E + e0 + j;
      o[0] = v.x;
      o[1] = v.y;
      o[2] = v.z;
      o[3] = v.w;
    }
  if (threadIdx.x == 0 && rank == 0)
#pragma unroll
    for (int h = 0; h < kH; ++h) prow[kH * E + h] = dc[h];
  if (C > 1) cg::this_cluster().sync();  // ranks read each other's part
}

// The most blocks an SM of the f32 kernel at (M, E, H) that run at once.
int bwd_occupancy(int M, int E, int H) {
  const Slices sl = bwd_slices(M, E, H);
  const size_t smem = bwd_smem(sl, M, H, 4, 4);
  return H == 1
             ? blocks_per_sm(stream_bwd_kernel<float, float, 1>, kThreads, smem)
             : blocks_per_sm(stream_bwd_kernel<float, float, 2>, kThreads,
                             smem);
}

// Clusters of the persistent grid: `req` blocks an SM (0: as many as the
// f32 call's registers and shared memory let run at once), at most one row
// a cluster; -1 for a request above that.  It depends on (B, M, E, H) and
// the request alone — the workspace does too, and an int8 or bf16 call
// splits the batch as the f32 call does, so sums in its order.
int bwd_clusters(int B, int M, int E, int H, int req) {
  const int per_sm = grid_per_sm(req, bwd_occupancy(M, E, H));
  return per_sm < 1 ? -1 : clusters_of(B, bwd_slices(M, E, H).C, per_sm);
}

// Workspace: one partial row (H E + H floats) a cluster (0 for a refused
// grid: its launch fails).
size_t workspace_floats(int B, int M, int E, int H, int req) {
  const int clusters = bwd_clusters(B, M, E, H, req);
  return clusters < 1 ? 0 : (size_t)clusters * (H * E + H);
}

template <typename T, typename D, int kH>
cudaError_t launch(const StreamBwdParams& p, cudaStream_t stream) {
  BwdPlan pl;
  pl.sl = bwd_slices(p.M, p.E, kH);
  pl.kv_g = route_of(p.kv, (size_t)pl.sl.es * sizeof(T) |
                               (size_t)p.E * sizeof(T));
  pl.dm_g = route_of(p.dmix, (size_t)pl.sl.es * sizeof(D) |
                                 (size_t)p.E * sizeof(D));
  const size_t smem = bwd_smem(pl.sl, p.M, kH, sizeof(T), sizeof(D));
  const int clusters = bwd_clusters(p.B, p.M, p.E, kH, p.blocks_per_sm);
  if (clusters < 1) return cudaErrorInvalidValue;
  cudaError_t err = launch_clusters(stream_bwd_kernel<T, D, kH>,
                                    clusters * pl.sl.C, kThreads, smem,
                                    pl.sl.C, stream, p, pl);
  if (err != cudaSuccess) return err;
  return part_sum(p.ws, clusters, kH * p.E + kH, p.acc, stream);
}

template <typename D, int kH>
int run_dmix(const StreamBwdParams* p, cudaStream_t s) {
  switch (p->kv_dtype) {
    case kKvF32: return (int)launch<float, D, kH>(*p, s);
    case kKvBf16: return (int)launch<__nv_bfloat16, D, kH>(*p, s);
    case kKvInt8: return (int)launch<int8_t, D, kH>(*p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int kH>
int run(const StreamBwdParams* p, void* stream) {
  if (p->B < 1 || p->M < 1 || p->M > kMaxM || p->E < 4 || p->E % 4 != 0 ||
      (p->kv_dtype == kKvInt8 && (p->scales == nullptr || p->dkv != nullptr)) ||
      (p->dmix_dtype != kKvF32 && p->dmix_dtype != kKvBf16)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p->dmix_dtype == kKvBf16 ? run_dmix<__nv_bfloat16, kH>(p, s)
                                  : run_dmix<float, kH>(p, s);
}

}  // namespace

extern "C" {

// Floats of workspace aecf_stream_bwd (H = 1) or aecf_stream_bwd_mh
// (H = 2) needs for (B, M, E) and the grid's blocks_per_sm.
size_t aecf_stream_bwd_workspace(int B, int M, int E, int H,
                                 int blocks_per_sm) {
  return workspace_floats(B, M, E, H, blocks_per_sm);
}

// The most blocks an SM of the persistent grid at (M, E, H) (the limit of
// StreamBwdParams.blocks_per_sm); -1 for arguments it refuses.
int aecf_stream_bwd_occupancy(int M, int E, int H) {
  if (M < 1 || M > kMaxM || H < 1 || H > 2 || E < 4 || E % 4 != 0) return -1;
  return bwd_occupancy(M, E, H);
}

// The H == 1 backward (_bwd_kernel_streamed).  Returns a cudaError_t; 0
// means every launch was accepted.  Pointers are contiguous device
// buffers as listed in StreamBwdParams; kv, dmix, u, dkv and ws aligned
// to four elements; int8 needs scales and takes no dkv; dmix is f32 or
// bf16 (dmix_dtype).
int aecf_stream_bwd(const StreamBwdParams* p, void* stream) {
  return run<1>(p, stream);
}

// The H == 2 backward (_bwd_kernel_streamed_mh); as aecf_stream_bwd.
int aecf_stream_bwd_mh(const StreamBwdParams* p, void* stream) {
  return run<2>(p, stream);
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
