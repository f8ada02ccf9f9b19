// Adam and AdamW over all of an optimizer's leaves, each element read once
// and written once, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the optimizer to optax
// (aecf_tpu/train/pool_step.py).  On the card torch.optim.AdamW with
// capturable=True steps through its foreach branch (torch/optim/adam.py,
// _multi_tensor_adam): nine passes over the parameter-sized tensors, 88
// bytes an element read and written — p *= 1 - lr wd (8), lerp of m (12),
// v *= b2 (8), v += (1 - b2) g g (12), sqrt(v) into a temporary (8), its
// division by sqrt(1 - b2^t) (8), + eps (8), its division by the step size
// (8), p += m / it (16) — the two divisions one launch a leaf, since their
// divisors are one-element tensors.
//
// What bounds it on the H100: bytes.  An update has to read p, g, m and v
// and write p, m and v: 28 bytes an element, 1.49 GB at 53.29 M
// parameters, 0.445 ms at 3.35 TB/s.  So each element is read once into
// registers, updated there and written once.  The leaves' elements, laid
// end to end in chunks of kChunk, are walked by a persistent grid (kBlocks
// a SM, grid-stride over the chunks), so a leaf of 38.5 M elements and a
// bias of 14 keep the same blocks busy.  A leaf whose p, m and v share
// their offset within 16 bytes moves in 16-byte vectors after a scalar head
// of up to three elements (and a scalar tail); g too where it shares that
// offset, else four 4-byte loads (a data-parallel step's gradients are
// views at any offset of the all-reduce's flat buffer).  The leaves'
// pointers, sizes and hyperparameters travel by value in the kernel's
// parameter struct (under 4 KB: kMaxLeaves a launch; more leaves take
// more launches).
//
// The step's scalars need the step count after its increment, which the
// state keeps on the card: a one-block prologue adds 1 to each leaf's step
// and writes the leaf's step size and sqrt(1 - b2^t) to a scratch buffer
// the wrapper allocates on each call.  It is a launch of its own, since
// blocks of the update reading a step that another block increments would
// race.
//
// The arithmetic is torch's capturable foreach branch, in its order and
// with its roundings, so the two agree bit for bit: every product, sum,
// quotient and root is rounded where ATen's kernels round it (the _rn
// intrinsics, which the compiler never contracts), and fused where ATen's
// `a + s * b` compiles to one FMA (lerp, addcmul, the L2 term).  ATen's
// foreach division by a Python number multiplies by its reciprocal, taken
// in double and rounded to f32 (measured on the card: true division by lr
// moves the step size by an ulp for some lr and t).  Per element, with the
// prologue's step size ss = 1 / ((b1^t - 1) (1 / lr)) and
// c2 = sqrt(-(b2^t - 1)):
//
//   p = p (1 - lr wd)                       AdamW, wd != 0
//   g = g + wd p                            Adam, wd != 0
//   m = lerp(m, g, 1 - b1)                  ATen's lerp
//   v = v b2 + (1 - b2) g g
//   p = p + m / ((sqrt(v) / c2 + eps) / ss)
//
// No atomics and no reductions: eager calls and graph replays agree bit
// for bit.  The kernels live outside namespace aecf, and their names hold
// "adam", so a trace tells them from the pool chains' kernels.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxLeaves = 40;  // leaves a launch: the struct under 4 KB
constexpr int kThreads = 256;
constexpr int kVecs = 2;  // 16-byte vectors of each operand a thread a chunk
constexpr int kChunk = kThreads * kVecs * 4;  // elements a chunk
constexpr int kBlocks = 3;                    // blocks a SM
constexpr int kPrologueThreads = 64;

// flags of a leaf
constexpr unsigned char kDecay = 1;      // weight_decay != 0
constexpr unsigned char kDecoupled = 2;  // AdamW's decay of p, else Adam's
constexpr unsigned char kVec = 4;        // p, m, v in 16-byte vectors
constexpr unsigned char kVecG = 8;       // g too

struct Batch {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  float* step[kMaxLeaves];
  long long n[kMaxLeaves];
  // the Python numbers as ATen takes them, rounded to f32 once
  float inv_lr[kMaxLeaves];  // 1 / lr, taken in double
  float beta1[kMaxLeaves], beta2[kMaxLeaves];
  float w1[kMaxLeaves];     // 1 - beta1, lerp's weight
  float w2[kMaxLeaves];     // 1 - beta2
  float eps[kMaxLeaves];
  float wd[kMaxLeaves];     // Adam's L2 coefficient
  float decay[kMaxLeaves];  // AdamW's 1 - lr wd
  int first[kMaxLeaves + 1];  // leaf i's chunks: [first[i], first[i + 1])
  unsigned char head[kMaxLeaves];  // scalar elements before the vectors
  unsigned char flags[kMaxLeaves];
  float* scratch;  // (step size, sqrt(1 - b2^t)) a leaf of this batch
  int count;
};
static_assert(sizeof(Batch) <= 4096, "the kernel parameters exceed 4 KB");

// The step's scalars, torch's foreach ops one after another: pow, sub,
// div by lr (a product with 1 / lr), reciprocal; pow, sub, neg, sqrt.
__global__ void __launch_bounds__(kPrologueThreads)
    adam_prologue(const __grid_constant__ Batch b) {
  for (int i = threadIdx.x; i < b.count; i += blockDim.x) {
    const float t = __fadd_rn(*b.step[i], 1.f);
    *b.step[i] = t;
    const float bc1 =
        __fmul_rn(__fsub_rn(powf(b.beta1[i], t), 1.f), b.inv_lr[i]);
    b.scratch[2 * i] = __fdiv_rn(1.f, bc1);
    b.scratch[2 * i + 1] = __fsqrt_rn(-__fsub_rn(powf(b.beta2[i], t), 1.f));
  }
}

struct Scalars {
  float decay, wd, w1, b2, w2, eps, step_size, c2;
  unsigned char flags;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Scalars& s) {
  if (s.flags & kDecay) {
    if (s.flags & kDecoupled)
      p = __fmul_rn(p, s.decay);
    else
      g = __fmaf_rn(s.wd, p, g);
  }
  // ATen's lerp: self + w (end - self) where |w| < 0.5, else
  // end - (end - self) (1 - w)
  const float d = __fsub_rn(g, m);
  m = fabsf(s.w1) < 0.5f ? __fmaf_rn(s.w1, d, m)
                         : __fmaf_rn(-d, __fsub_rn(1.f, s.w1), g);
  v = __fmaf_rn(s.w2, __fmul_rn(g, g), __fmul_rn(v, s.b2));
  const float den = __fdiv_rn(
      __fadd_rn(__fdiv_rn(__fsqrt_rn(v), s.c2), s.eps), s.step_size);
  p = __fadd_rn(p, __fdiv_rn(m, den));
}

__device__ __forceinline__ void update4(float4& p, float4 g, float4& m,
                                        float4& v, const Scalars& s) {
  update(p.x, g.x, m.x, v.x, s);
  update(p.y, g.y, m.y, v.y, s);
  update(p.z, g.z, m.z, v.z, s);
  update(p.w, g.w, m.w, v.w, s);
}

__device__ __forceinline__ void update_at(const Batch& b, int leaf,
                                          long long i, const Scalars& s) {
  float p = b.p[leaf][i], m = b.m[leaf][i], v = b.v[leaf][i];
  update(p, b.g[leaf][i], m, v, s);
  b.p[leaf][i] = p;
  b.m[leaf][i] = m;
  b.v[leaf][i] = v;
}

__global__ void __launch_bounds__(kThreads, kBlocks)
    adam_leaves(const __grid_constant__ Batch b) {
  const int total = b.first[b.count];
  int leaf = 0;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    while (c >= b.first[leaf + 1]) ++leaf;
    Scalars s;
    s.decay = b.decay[leaf];
    s.wd = b.wd[leaf];
    s.w1 = b.w1[leaf];
    s.b2 = b.beta2[leaf];
    s.w2 = b.w2[leaf];
    s.eps = b.eps[leaf];
    s.step_size = b.scratch[2 * leaf];
    s.c2 = b.scratch[2 * leaf + 1];
    s.flags = b.flags[leaf];
    const long long n = b.n[leaf];
    const int head = b.head[leaf];
    const long long start = head + (long long)(c - b.first[leaf]) * kChunk;
    const long long end = start + kChunk < n ? start + kChunk : n;
    if (!(s.flags & kVec)) {
      for (long long i = start + threadIdx.x; i < end; i += kThreads)
        update_at(b, leaf, i, s);
      continue;
    }
    float* const pp = b.p[leaf];
    const float* const gp = b.g[leaf];
    float* const mp = b.m[leaf];
    float* const vp = b.v[leaf];
    float4 P[kVecs], G[kVecs], M[kVecs], V[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long i = start + 4LL * (k * kThreads + threadIdx.x);
      if (i + 4 <= end) {
        P[k] = *reinterpret_cast<const float4*>(pp + i);
        M[k] = *reinterpret_cast<const float4*>(mp + i);
        V[k] = *reinterpret_cast<const float4*>(vp + i);
        if (s.flags & kVecG)
          G[k] = *reinterpret_cast<const float4*>(gp + i);
        else
          G[k] = make_float4(gp[i], gp[i + 1], gp[i + 2], gp[i + 3]);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long i = start + 4LL * (k * kThreads + threadIdx.x);
      if (i + 4 <= end) {
        update4(P[k], G[k], M[k], V[k], s);
        *reinterpret_cast<float4*>(pp + i) = P[k];
        *reinterpret_cast<float4*>(mp + i) = M[k];
        *reinterpret_cast<float4*>(vp + i) = V[k];
      }
    }
    // the leaf's last chunk: up to three elements past its last vector;
    // its first: the head before its first vector
    if (end > start) {
      const long long tail = start + ((end - start) & ~3LL);
      if (threadIdx.x < end - tail) update_at(b, leaf, tail + threadIdx.x, s);
    }
    if (c == b.first[leaf] && (int)threadIdx.x < head)
      update_at(b, leaf, threadIdx.x, s);
  }
}

}  // namespace

extern "C" {

int aecf_adam_max_leaves() { return kMaxLeaves; }

// Returns a cudaError_t; 0 means every launch was accepted.  count leaves:
// ptrs holds five device pointers a leaf (p, g, m, v: f32, contiguous, of
// sizes[i] elements; step: one f32), hyper eight floats a leaf (1 / lr,
// beta1, beta2, 1 - beta1, 1 - beta2, eps, weight_decay, 1 - lr
// weight_decay, each taken in double and rounded to f32 as ATen rounds the
// Python number), flags one int a leaf
// (bit 0: weight_decay != 0, bit 1: AdamW's decoupled decay); scratch is
// two device floats a leaf.  Launches the prologue and the update for each
// kMaxLeaves leaves in turn, on stream; allocates nothing and does not
// synchronise.
int aecf_adam_step(int count, const unsigned long long* ptrs,
                   const long long* sizes, const float* hyper,
                   const int* flags, float* scratch, void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  for (int base = 0; base < count; base += kMaxLeaves) {
    Batch b = {};
    b.count = count - base < kMaxLeaves ? count - base : kMaxLeaves;
    b.scratch = scratch + 2 * base;
    long long chunks = 0;
    for (int i = 0; i < b.count; ++i) {
      const int j = base + i;
      const unsigned long long* q = ptrs + 5 * j;
      const float* h = hyper + 8 * j;
      b.p[i] = reinterpret_cast<float*>(q[0]);
      b.g[i] = reinterpret_cast<const float*>(q[1]);
      b.m[i] = reinterpret_cast<float*>(q[2]);
      b.v[i] = reinterpret_cast<float*>(q[3]);
      b.step[i] = reinterpret_cast<float*>(q[4]);
      const long long n = sizes[j];
      if (n < 0) return (int)cudaErrorInvalidValue;
      b.n[i] = n;
      b.inv_lr[i] = h[0];
      b.beta1[i] = h[1];
      b.beta2[i] = h[2];
      b.w1[i] = h[3];
      b.w2[i] = h[4];
      b.eps[i] = h[5];
      b.wd[i] = h[6];
      b.decay[i] = h[7];
      unsigned char f = (flags[j] & 1 ? kDecay : 0) |
                        (flags[j] & 2 ? kDecoupled : 0);
      const unsigned long long at = q[0] & 15;
      long long head = 0;
      if (at % 4 == 0 && (q[2] & 15) == at && (q[3] & 15) == at) {
        f |= kVec;
        if ((q[1] & 15) == at) f |= kVecG;
        head = (long long)((16 - at) & 15) / 4;
        if (head > n) head = n;
      }
      b.head[i] = (unsigned char)head;
      b.flags[i] = f;
      b.first[i] = (int)chunks;
      const long long own = (n - head + kChunk - 1) / kChunk;
      chunks += own > 0 ? own : 1;
      if (chunks > INT_MAX) return (int)cudaErrorInvalidValue;
    }
    b.first[b.count] = (int)chunks;
    adam_prologue<<<1, kPrologueThreads, 0, st>>>(b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long most = (long long)sms * kBlocks;
    const int grid = (int)(chunks < most ? chunks : most);
    adam_leaves<<<grid, kThreads, 0, st>>>(b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
