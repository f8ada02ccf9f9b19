// The model families' draws for Hopper (sm_90a): uniforms keyed by a step's
// two seed words, and the fold of those words into a sub-key, each in one
// launch that reads the words from the card.
//
// The rule (kernels/draws.py, docs/prng.md): a draw of a (rows, cols) block
// at site tag t puts at (r, c) word c % 4 of Philox4x32-10 at counter
// (r, c / 4, t, 0), keyed by the seed words, as the uniform (bits >> 8) *
// 2^-24 (exact in f32).  Tag 0 is the curriculum mask's own counter
// (pool_common.cuh row_uniforms), so a pool's mask drawn here equals the
// mask its kernels draw for the same words.  A fold of the words with n is
// the first two words of Philox at counter (n low, n high, "FOLD", 0): the
// step's fold_seed_words, so a sub-key drawn on the card equals the one the
// host computes.
//
// The seed words come by value or, where `key` is not null, from two words
// on the card, read when the kernel runs: a captured CUDA graph draws what
// the buffer holds at each replay.  One thread a counter: four words a
// Philox call, stored as one 16-byte vector where the row holds whole
// groups of four.  Bound by the bytes written (4 a uniform) on the H100.
//
// The kernels live outside namespace aecf, and their names hold
// "philox_draws", so a trace tells them from the pool chains' kernels.

#include "pool_common.cuh"

namespace {

constexpr int kDrawThreads = 256;
constexpr uint32_t kFold = 0x464F4C44u;  // "FOLD", kernels/draws.py _FOLD

__device__ __forceinline__ void load_key(const uint32_t* key, uint32_t& k0,
                                         uint32_t& k1) {
  if (key != nullptr) {
    k0 = key[0];
    k1 = key[1];
  }
}

__global__ void __launch_bounds__(kDrawThreads) philox_draws_uniforms(
    const uint32_t* __restrict__ key, uint32_t k0, uint32_t k1, int rows,
    int cols, uint32_t tag, float* __restrict__ out) {
  const int groups = (cols + 3) / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * groups) return;
  load_key(key, k0, k1);
  const int row = (int)(i / groups);
  const int g = (int)(i % groups);
  const aecf::Philox4 r =
      aecf::philox4x32_10((uint32_t)row, (uint32_t)g, tag, 0u, k0, k1);
  float u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    u[j] = (float)(r.v[j] >> 8) * (1.0f / 16777216.0f);
  float* dst = out + (size_t)row * cols + 4 * (size_t)g;
  if ((cols & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(u[0], u[1], u[2], u[3]);
  } else {
    const int n = min(4, cols - 4 * g);
    for (int j = 0; j < n; ++j) dst[j] = u[j];
  }
}

__global__ void philox_draws_fold(const uint32_t* __restrict__ key,
                                  uint32_t k0, uint32_t k1, uint32_t n0,
                                  uint32_t n1, uint32_t* __restrict__ out) {
  load_key(key, k0, k1);
  const aecf::Philox4 r = aecf::philox4x32_10(n0, n1, kFold, 0u, k0, k1);
  out[0] = r.v[0];
  out[1] = r.v[1];
}

}  // namespace

extern "C" {

// (rows, cols) f32 uniforms at site `tag` into `out` (contiguous, 16-byte
// aligned); the words from `key` when it is not null, else k0, k1.
int aecf_draw_uniforms(const void* key, uint32_t k0, uint32_t k1, int rows,
                       int cols, uint32_t tag, void* out, void* stream) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * ((cols + 3) / 4);
  if (n == 0) return 0;
  const long long blocks = (n + kDrawThreads - 1) / kDrawThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  philox_draws_uniforms<<<(unsigned)blocks, kDrawThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)key, k0, k1, rows, cols, tag, (float*)out);
  return (int)cudaGetLastError();
}

// The two words of the fold of the seed words with n = (n0, n1) into `out`.
int aecf_fold_words(const void* key, uint32_t k0, uint32_t k1, uint32_t n0,
                    uint32_t n1, void* out, void* stream) {
  philox_draws_fold<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, k0, k1, n0, n1, (uint32_t*)out);
  return (int)cudaGetLastError();
}

const char* aecf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
