// InfoNCE's softmax cross-entropy over rows of logits and its gradient, in
// one kernel, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves `z @ t_all.T / tau` and
// optax.softmax_cross_entropy_with_integer_labels to XLA
// (examples/train_contrastive.py).  On the card the same loss through ATen
// takes about a dozen passes over the (B, N) logits (the division,
// log-softmax, NLL, and their backward: a zero fill and a scatter, the
// log-softmax backward, the division's backward).  Here, per row b of the
// raw product (B, N) with x_j = raw[b, j] / tau and label = label_offset + b:
//
//   m = max_j x_j,  s = sum_j exp(x_j - m),  o_j = (x_j - m) - log s
//   loss[b]   = -o_label * scale
//   raw[b, j] = ([j == label] (-scale) - exp(o_j) (-scale)) / tau
//
// ATen's order of operations for the same quantities (log-softmax forward
// and backward, then the division's backward), so the results differ from
// its route only by the order of the sums.  tau is divided by, never
// multiplied as a rounded 1/tau; expf and logf are the accurate functions
// (the build carries no fast-math).
//
// What bounds it on the H100: bytes.  The row must be read once and the
// gradient written once, 2 B N 4 bytes (134 MB at B = 2048, N = 8192: 0.040
// ms at 3.35 TB/s); the exponentials and divisions are far below the SIMT
// rate.  So a block takes a row and holds it in registers (16-byte loads
// where N is a multiple of four, 512 threads of up to 8 vectors each: rows
// of up to 16,384 floats; 4,096 with scalar loads), reduces the max and the
// sum in a fixed order (warp butterflies, then the warps' partials in warp
// order, so every thread holds the same value), and writes the gradient
// over the row it read: HBM sees one read and one write.  A wider row takes
// the second path, chosen from N: an online max and sum over the row, then
// a pass that reads it again and writes the gradient.  No atomics and no
// data-dependent order: eager calls and graph replays agree bit for bit.
// A row is read, reduced and written in turn, so the SM overlaps one
// block's loads with another's arithmetic: up to 4 vectors a thread the
// kernel is held to 42 registers, three blocks (1,536 threads) an SM.
// Measured on an H100 SXM (700 W) at B = 2048, N = 8192: 0.063 ms, where
// 256 threads of 8 vectors (79 registers, 3 blocks an SM) took 0.077, 256
// threads held to 64 registers 0.066 and 1,024 threads of 2 vectors 0.106.
//
// The kernels live outside namespace aecf, and their names hold "infonce",
// so a trace tells them from the pool chains' kernels.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;  // the most threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecs = 8;  // vectors a thread holds on the resident path

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Butterfly sums: each pair is added in both lanes, and addition commutes,
// so every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's max: warps' maxima in warp order, read by every thread.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  return r;
}

// (m, s) pairs of an online softmax sum, merged: the larger max, each sum
// rescaled to it (an empty part, m = -inf, adds nothing).  Symmetric in
// its two arguments, so a butterfly leaves every lane the same pair.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.f : s * expf(m - mx);
  const float b = m2 == -INFINITY ? 0.f : s2 * expf(m2 - mx);
  m = mx;
  s = a + b;
}

// The loss and the gradient of one element, from the row's m and log s.
__device__ __forceinline__ float grad_of(float x, float m, float logs,
                                         bool is_label, float scale,
                                         float tau) {
  const float o = (x - m) - logs;
  const float g = (is_label ? -scale : 0.f) - expf(o) * (-scale);
  return g / tau;
}

// Resident path: a block a row, thread t holding vectors t, t + T, ... (V
// floats each) of the row in registers, C of them.
template <int V, int C>
__global__ void __launch_bounds__(kThreads, C <= 4 ? 3 : 1)
    infonce_rows_resident(float* __restrict__ raw, float* __restrict__ loss,
                          int N, int label_offset, float tau, float scale) {
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps];
  const int b = blockIdx.x;
  float* row = raw + (size_t)b * N;
  const int label = label_offset + b;
  const int T = blockDim.x;
  // the label's logit, read before the barriers that precede every write
  const float xl = threadIdx.x == 0 ? row[label] / tau : 0.f;
  float x[C][V];
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = (c * T + (int)threadIdx.x) * V;
    if (V == 4 && j < N) {  // N % 4 == 0: the whole vector is in the row
      const float4 v = *reinterpret_cast<const float4*>(row + j);
      x[c][0] = v.x / tau;
      x[c][1 % V] = v.y / tau;
      x[c][2 % V] = v.z / tau;
      x[c][3 % V] = v.w / tau;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        x[c][k] = j + k < N ? row[j + k] / tau : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) m = fmaxf(m, x[c][k]);
  }
  m = block_max(m, red_max);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < V; ++k) s += expf(x[c][k] - m);  // exp(-inf) = 0
  s = block_sum(s, red_sum);
  const float logs = logf(s);
  if (threadIdx.x == 0) loss[b] = -((xl - m) - logs) * scale;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = (c * T + (int)threadIdx.x) * V;
    if (j >= N) continue;
    if (V == 4) {
      float4 g;
      g.x = grad_of(x[c][0], m, logs, j == label, scale, tau);
      g.y = grad_of(x[c][1 % V], m, logs, j + 1 == label, scale, tau);
      g.z = grad_of(x[c][2 % V], m, logs, j + 2 == label, scale, tau);
      g.w = grad_of(x[c][3 % V], m, logs, j + 3 == label, scale, tau);
      *reinterpret_cast<float4*>(row + j) = g;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (j + k < N)
          row[j + k] = grad_of(x[c][k], m, logs, j + k == label, scale, tau);
    }
  }
}

// Two-pass path, for rows wider than a block holds: an online max and sum
// over the row (thread t: vectors t, t + T, ... in order), the threads'
// pairs merged in a fixed order, then a pass that reads the row again and
// writes the gradient.
template <int V>
__global__ void __launch_bounds__(kThreads)
    infonce_rows_streamed(float* __restrict__ raw, float* __restrict__ loss,
                          int N, int label_offset, float tau, float scale) {
  __shared__ float red_m[kWarps];
  __shared__ float red_s[kWarps];
  const int b = blockIdx.x;
  float* row = raw + (size_t)b * N;
  const int label = label_offset + b;
  const int step = blockDim.x * V;
  const float xl = threadIdx.x == 0 ? row[label] / tau : 0.f;
  float m = -INFINITY, s = 0.f;
  for (int j = threadIdx.x * V; j < N; j += step) {
    float x[V];
    if (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + j);
      x[0] = v.x / tau;
      x[1 % V] = v.y / tau;
      x[2 % V] = v.z / tau;
      x[3 % V] = v.w / tau;
    } else {
      x[0] = row[j] / tau;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (x[k] > m) {
        s = s * expf(m - x[k]) + 1.f;  // s = 0 while m = -inf
        m = x[k];
      } else {
        s += expf(x[k] - m);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  if ((threadIdx.x & 31) == 0) {
    red_m[threadIdx.x >> 5] = m;
    red_s[threadIdx.x >> 5] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    merge(m, s, red_m[w], red_s[w]);
  const float logs = logf(s);
  if (threadIdx.x == 0) loss[b] = -((xl - m) - logs) * scale;
  for (int j = threadIdx.x * V; j < N; j += step) {
    if (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + j);
      float4 g;
      g.x = grad_of(v.x / tau, m, logs, j == label, scale, tau);
      g.y = grad_of(v.y / tau, m, logs, j + 1 == label, scale, tau);
      g.z = grad_of(v.z / tau, m, logs, j + 2 == label, scale, tau);
      g.w = grad_of(v.w / tau, m, logs, j + 3 == label, scale, tau);
      *reinterpret_cast<float4*>(row + j) = g;
    } else {
      row[j] = grad_of(row[j] / tau, m, logs, j == label, scale, tau);
    }
  }
}

// The resident instance for C vectors a thread, or the streamed kernel
// where the row needs more than kMaxVecs.
template <int V>
cudaError_t launch(float* raw, float* loss, int B, int N, int label_offset,
                   float tau, float scale, cudaStream_t stream) {
  const int vecs = (N + V - 1) / V;
  if (vecs > kThreads * kMaxVecs) {
    infonce_rows_streamed<V><<<B, kThreads, 0, stream>>>(raw, loss, N,
                                                         label_offset, tau,
                                                         scale);
    return cudaGetLastError();
  }
  // the fewest threads (a multiple of 32) that hold the row in one vector
  // each, up to kThreads; beyond, kThreads holding 2, 4 or 8
  int threads = (vecs + 31) / 32 * 32, per = 1;
  if (vecs > kThreads) {
    threads = kThreads;
    while (per * kThreads < vecs) per *= 2;
  }
  const dim3 grid(B), block(threads);
#define AECF_INFONCE_CASE(C)                                           \
  case C:                                                              \
    infonce_rows_resident<V, C><<<grid, block, 0, stream>>>(           \
        raw, loss, N, label_offset, tau, scale);                       \
    break;
  switch (per) {
    AECF_INFONCE_CASE(1)
    AECF_INFONCE_CASE(2)
    AECF_INFONCE_CASE(4)
    AECF_INFONCE_CASE(8)
  }
#undef AECF_INFONCE_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 means the launch was accepted.  raw is (B, N)
// f32, contiguous, and is overwritten with the gradient; loss_out is (B,)
// f32.  label_offset + B <= N; the wrapper checks the shapes.  16-byte
// loads where N % 4 == 0 and raw is 16-byte aligned.  Launches on stream,
// allocates nothing and does not synchronise.
int aecf_infonce_rows(float* raw, int B, int N, int label_offset, float tau,
                      float scale, float* loss_out, void* stream) {
  if (B < 1 || N < 1 || label_offset < 0 || label_offset > N - B)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = N % 4 == 0 && reinterpret_cast<size_t>(raw) % 16 == 0;
  return (int)(vec4 ? launch<4>(raw, loss_out, B, N, label_offset, tau,
                                scale, s)
                    : launch<1>(raw, loss_out, B, N, label_offset, tau,
                                scale, s));
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
