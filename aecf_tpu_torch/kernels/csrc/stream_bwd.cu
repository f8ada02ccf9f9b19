// Streamed shared-query backward, H == 1 and H == 2, for Hopper (sm_90a).
//
// Replaces aecf_tpu/kernels/shared_query.py::_bwd_kernel_streamed (H == 1,
// launched by _bwd_streamed) and ::_bwd_kernel_streamed_mh (H >= 2, by
// _bwd_streamed_mh; here H == 2, the streamed split's widest), f32/bf16
// features and their quantized=True branches (int8 with per-(row,
// modality) scales, read through KvRow in 4-byte loads; frozen, so no
// d_kv): the backward of the streamed split.  The GEMMs that need an
// E x E matrix (d_mix = d_out W_vo and G = d_out^T mix for H == 1; the
// per-head output/V-projection backward for H == 2) run in cuBLAS before
// this kernel, as the JAX package runs them in XLA.  Per batch row b, with the
// score vectors u (H, E) and offsets c (H,):
//
//   recompute  a_h = softmax_m(kv[b, m] . u_h + c_h + pad[b, m])
//   d_a_h[m] = d_mix_h . kv[b, m] + d_w[m] / H;  d_s_h = a_h (d_a_h - a_h . d_a_h)
//   d_kv[m]  = sum_h (a_h[m] d_mix_h + d_s_h[m] u_h)   (optional, kv dtype)
// and the batch sums du_h = sum_b sum_m d_s_h kv and dc_h = sum_b sum_m d_s_h.
//
// What bounds it on the H100: bytes.  It must read kv (B M E) and d_mix
// (B H E f32), and write d_kv when asked; the arithmetic, about (8 + 6H)
// B M E flops, is far below the SIMT rate.  A block takes kRows rows.
// Phase A, a warp a row: one pass over the row takes the scores and d_a
// together (kv read once with u and d_mix beside it, 16-byte loads), then
// the softmax backward; a and d_s go to shared memory.  Phase B, a thread
// a 4-column chunk: it walks the block's rows in order, reading kv again
// (from L2 while the block's rows fit there) for du, and d_mix again for
// d_kv, which it sums over the heads in registers and stores once.  The
// TPU kernel adds du/dc into one VMEM block across its sequential grid;
// here each block writes one row of du and one of dc partials, and colsum
// (pool_common.cuh) adds the rows in a fixed order: no atomics, and a run
// repeats bit for bit.  Padded rows (>= B) write nothing and add nothing.
// Needs E % 4 == 0.
//
// Measured on an H100 SXM (700 W), f32, no d_kv: 0.134 ms at B = 4096,
// M = 4, E = 2048, H = 1 (bound 0.050 ms; with d_kv 0.209 ms, bound 0.090);
// 0.198 ms at B = 8192, M = 4, E = 1024, H = 2 (bound 0.060 ms).  int8, no
// d_kv: 0.114 ms (bound 0.020 ms) and 0.156 ms (bound 0.030 ms) at the same
// shapes; d_mix, read in f32, is then most of the bytes.

#include "pool_common.cuh"

using namespace aecf;

// Also declared, field for field, by kernels/shared_query.py (ctypes).
struct StreamBwdParams {
  const void* kv;     // (B, M, E) f32, bf16 or int8 (kv_dtype)
  const float* scales;  // (B, M) dequant scales, int8 only
  const float* dmix;  // (B, H E)
  const float* dw;    // (B, M) or null: the weights cotangent (head mean)
  const float* pad;   // (B, M) or null
  const float* u;     // (H, E)
  const float* c;     // (H,)
  void* dkv;          // (B, M, E) kv dtype, or null: no d_kv (int8: null)
  float* acc;         // (H E + H): du_0 .. du_{H-1} | dc
  float* ws;          // aecf_stream_bwd_workspace floats
  int B, M, E, kv_dtype;  // KvDtype: 0 f32, 1 bf16, 2 int8
};

namespace {

template <typename T, int kH>
AECF_ROW_KERNEL(2) stream_bwd_kernel(StreamBwdParams p) {
  __shared__ float a_s[kRows][kH][kMaxM];
  __shared__ float ds_s[kRows][kH][kMaxM];
  const int E = p.E;
  const int M = p.M;
  const int B = p.B;
  const T* kv = static_cast<const T*>(p.kv);
  T* dkv = static_cast<T*>(p.dkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, B - row0);

  // ---- phase A: scores and d_a in one pass, then the softmax backward ----
  for (int r = warp; r < rows_valid; r += kWarps) {
    const int gr = row0 + r;
    const KvRow<T> kvr(kv, p.scales, gr, M, E);
    const float* dmr = p.dmix + (size_t)gr * kH * E;
    float s[kH][kMaxM];
    float da[kH][kMaxM];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) s[h][m] = da[h][m] = 0.f;
    for (int j = 4 * lane; j < E; j += 4 * 32) {
      float4 uh[kH];
      float4 dm[kH];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        uh[h] = load4(p.u + (size_t)h * E + j);
        dm[h] = load4(dmr + (size_t)h * E + j);
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float4 x = kvr.at4(m, j);
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            s[h][m] = dot4(x, uh[h], s[h][m]);
            da[h][m] = dot4(x, dm[h], da[h][m]);
          }
        }
      }
    }
    const float inv_h = 1.0f / (float)kH;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      float smax = -INFINITY;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float bias = p.pad != nullptr ? p.pad[(size_t)gr * M + m] : 0.f;
          s[h][m] = (warp_sum(s[h][m]) + p.c[h]) + bias;
          smax = fmaxf(smax, s[h][m]);
          da[h][m] = warp_sum(da[h][m]) +
                     (p.dw != nullptr ? p.dw[(size_t)gr * M + m] * inv_h : 0.f);
        }
      }
      float denom = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          s[h][m] = expf(s[h][m] - smax);
          denom += s[h][m];
        }
      }
      float dot = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          s[h][m] = s[h][m] / denom;  // a_h[m]
          dot += s[h][m] * da[h][m];
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m < M) {
            a_s[r][h][m] = s[h][m];
            ds_s[r][h][m] = s[h][m] * (da[h][m] - dot);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- phase B: du partials and d_kv, a thread a 4-column chunk ----------
  float* pb = p.ws + (size_t)blockIdx.x * kH * E;  // 16-byte aligned rows
  for (int j = 4 * threadIdx.x; j < E; j += 4 * kThreads) {
    float4 uh[kH];
    float4 du[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      uh[h] = load4(p.u + (size_t)h * E + j);
      du[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int r = 0; r < rows_valid; ++r) {
      const int gr = row0 + r;
      const KvRow<T> kvr(kv, p.scales, gr, M, E);
      float4 dm[kH];
      if (dkv != nullptr) {
#pragma unroll
        for (int h = 0; h < kH; ++h)
          dm[h] = load4(p.dmix + ((size_t)gr * kH + h) * E + j);
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float4 x = kvr.at4(m, j);
#pragma unroll
          for (int h = 0; h < kH; ++h) du[h] = axpy4(ds_s[r][h][m], x, du[h]);
          if constexpr (!kQuantized<T>) {
            if (dkv != nullptr) {
              float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int h = 0; h < kH; ++h) {
                g = axpy4(a_s[r][h][m], dm[h], g);
                g = axpy4(ds_s[r][h][m], uh[h], g);
              }
              // the load's offset: d_kv is laid out as kv
              store4(dkv + (kvr.p - kv) + (size_t)m * E + j, g);
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) store4(pb + (size_t)h * E + j, du[h]);
  }
  if (threadIdx.x < kH) {
    const int h = threadIdx.x;
    float dc = 0.f;
    for (int r = 0; r < rows_valid; ++r)
      for (int m = 0; m < M; ++m) dc += ds_s[r][h][m];
    p.ws[(size_t)gridDim.x * kH * E + (size_t)blockIdx.x * kH + h] = dc;
  }
}

// Workspace: one row of du partials (H E) per block, then one row of dc
// partials (H) per block.
size_t workspace_floats(int B, int E, int H) {
  return (size_t)row_blocks(B) * (H * E + H);
}

template <typename T, int kH>
cudaError_t launch(const StreamBwdParams& p, cudaStream_t stream) {
  const int blocks = row_blocks(p.B);
  stream_bwd_kernel<T, kH><<<blocks, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum(p.ws, blocks, kH * p.E, p.acc, stream);
  colsum(p.ws + (size_t)blocks * kH * p.E, blocks, kH, p.acc + kH * p.E,
         stream);
  return cudaGetLastError();
}

template <int kH>
int run(const StreamBwdParams* p, void* stream) {
  if (p->B < 1 || p->M < 1 || p->M > kMaxM || p->E < 4 || p->E % 4 != 0 ||
      (p->kv_dtype == kKvInt8 && (p->scales == nullptr || p->dkv != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->kv_dtype) {
    case kKvF32: return (int)launch<float, kH>(*p, s);
    case kKvBf16: return (int)launch<__nv_bfloat16, kH>(*p, s);
    case kKvInt8: return (int)launch<int8_t, kH>(*p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Floats of workspace aecf_stream_bwd (H = 1) or aecf_stream_bwd_mh
// (H = 2) needs for (B, E).
size_t aecf_stream_bwd_workspace(int B, int E, int H) {
  return workspace_floats(B, E, H);
}

// The H == 1 backward (_bwd_kernel_streamed).  Returns a cudaError_t; 0
// means every launch was accepted.  Pointers are contiguous device
// buffers as listed in StreamBwdParams; kv, dmix, u, dkv and ws aligned
// to four elements; int8 needs scales and takes no dkv.
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
