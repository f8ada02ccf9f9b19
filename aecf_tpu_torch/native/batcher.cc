// Native host-side batch pipeline for aecf_tpu_torch.
//
// Role: the port's data-loader runtime (aecf_tpu_torch/data/loader.py),
// a copy of the JAX package's aecf_tpu/native/batcher.cc kept in the port
// so that the port imports and builds nothing of that package.  A worker
// thread shuffles an epoch's indices and gathers feature rows into a ring
// of contiguous batch buffers while the card consumes previous batches, so
// host gather time hides behind device step time.
//
// ABI v2: streams are generic — any count, any element size.  The gather
// is a per-row memcpy of `row_bytes[s]`, so int8 feature stores (4x more
// rows per host than f32), bf16 tables, f32 labels, and per-row
// quantization scales all ride the same ring without the pipeline knowing
// about dtypes; the Python layer owns the dtype bookkeeping and
// reinterprets the returned buffers.
//
// C ABI only (consumed via ctypes); no Python.h dependency.
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<std::vector<uint8_t>> bufs;  // one per stream
  int64_t rows = 0;   // actual rows in this batch (tail batch may be short)
  int64_t epoch = 0;  // epoch this batch belongs to
};

struct Batcher {
  // Source arrays (borrowed; caller keeps them alive).
  std::vector<const uint8_t*> srcs;
  std::vector<int64_t> row_bytes;
  int64_t n;
  int64_t batch;
  bool drop_last;
  uint64_t seed;
  bool shuffle;

  // Ring of prefetched batches.
  size_t capacity;
  std::queue<Batch*> ready;
  std::queue<Batch*> free_list;
  std::vector<Batch*> all;

  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_free;
  std::atomic<bool> stop{false};
  bool done = false;  // end-of-stream reached (guarded by mu); terminal
  std::thread worker;

  // Batch currently held by the consumer.
  Batch* held = nullptr;

  ~Batcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    if (worker.joinable()) worker.join();
    for (Batch* b : all) delete b;
  }
};

void produce_epoch(Batcher* B, int64_t epoch) {
  std::vector<int64_t> idx(B->n);
  for (int64_t i = 0; i < B->n; ++i) idx[i] = i;
  if (B->shuffle) {
    std::mt19937_64 rng(B->seed + static_cast<uint64_t>(epoch) * 0x9e3779b97f4a7c15ULL);
    for (int64_t i = B->n - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> dist(0, i);
      std::swap(idx[i], idx[dist(rng)]);
    }
  }

  const size_t S = B->srcs.size();
  for (int64_t start = 0; start < B->n; start += B->batch) {
    int64_t rows = std::min(B->batch, B->n - start);
    if (B->drop_last && rows < B->batch) break;

    Batch* out = nullptr;
    {
      std::unique_lock<std::mutex> lk(B->mu);
      B->cv_free.wait(lk, [&] { return B->stop || !B->free_list.empty(); });
      if (B->stop) return;
      out = B->free_list.front();
      B->free_list.pop();
    }

    out->rows = rows;
    out->epoch = epoch;
    for (size_t s = 0; s < S; ++s) {
      const int64_t rb = B->row_bytes[s];
      uint8_t* dst = out->bufs[s].data();
      const uint8_t* src = B->srcs[s];
      for (int64_t r = 0; r < rows; ++r) {
        std::memcpy(dst + r * rb, src + idx[start + r] * rb,
                    static_cast<size_t>(rb));
      }
    }

    {
      std::lock_guard<std::mutex> lk(B->mu);
      B->ready.push(out);
    }
    B->cv_ready.notify_one();
  }
}

void worker_loop(Batcher* B, int64_t epochs) {
  for (int64_t e = 0; e < epochs && !B->stop; ++e) produce_epoch(B, e);
  {
    std::lock_guard<std::mutex> lk(B->mu);
    B->ready.push(nullptr);  // end-of-stream sentinel
  }
  B->cv_ready.notify_one();
}

}  // namespace

extern "C" {

// ABI version handshake: the Python loader checks this before trusting a
// pre-built .so (a v1 library had a fixed 3×f32-stream signature).
int32_t aecf_batcher_abi(void) { return 2; }

// Creates the pipeline and starts prefetching `epochs` epochs of batches.
// `streams[s]` is a C-contiguous (n, row_bytes[s]) byte matrix; the caller
// keeps all stream arrays alive for the pipeline's lifetime.
void* aecf_batcher_create(const void* const* streams,
                          const int64_t* row_bytes, int32_t n_streams,
                          int64_t n, int64_t batch, int64_t epochs,
                          int32_t n_prefetch, uint64_t seed, int32_t shuffle,
                          int32_t drop_last) {
  if (n <= 0 || batch <= 0 || n_prefetch <= 0 || n_streams <= 0)
    return nullptr;
  for (int32_t s = 0; s < n_streams; ++s) {
    if (streams[s] == nullptr || row_bytes[s] <= 0) return nullptr;
  }
  auto* B = new Batcher();
  B->srcs.reserve(n_streams);
  B->row_bytes.assign(row_bytes, row_bytes + n_streams);
  for (int32_t s = 0; s < n_streams; ++s)
    B->srcs.push_back(static_cast<const uint8_t*>(streams[s]));
  B->n = n;
  B->batch = batch;
  B->drop_last = drop_last != 0;
  B->seed = seed;
  B->shuffle = shuffle != 0;
  B->capacity = static_cast<size_t>(n_prefetch);
  for (size_t i = 0; i < B->capacity; ++i) {
    auto* b = new Batch();
    b->bufs.resize(n_streams);
    for (int32_t s = 0; s < n_streams; ++s)
      b->bufs[s].resize(static_cast<size_t>(batch) * row_bytes[s]);
    B->all.push_back(b);
    B->free_list.push(b);
  }
  B->worker = std::thread(worker_loop, B, epochs);
  return B;
}

// Blocks for the next batch.  Returns the row count (0 = end of stream) and
// fills `out[s]` with views into internal buffers that stay valid until the
// next acquire (the previously held batch is recycled).  `out` must have
// room for n_streams pointers.
int64_t aecf_batcher_acquire(void* handle, const void** out, int64_t* epoch) {
  auto* B = static_cast<Batcher*>(handle);
  if (B->held != nullptr) {
    {
      std::lock_guard<std::mutex> lk(B->mu);
      B->free_list.push(B->held);
    }
    B->cv_free.notify_one();
    B->held = nullptr;
  }
  Batch* b;
  {
    std::unique_lock<std::mutex> lk(B->mu);
    B->cv_ready.wait(lk,
                     [&] { return B->stop || B->done || !B->ready.empty(); });
    if (B->stop) return 0;
    if (B->done && B->ready.empty()) return 0;  // terminal: repeat acquires
    b = B->ready.front();                       // after EOS return 0 forever
    B->ready.pop();
    if (b == nullptr) {
      // end-of-stream sentinel: latch `done` so a retrying consumer does
      // not block on an empty queue with the worker already exited
      B->done = true;
      return 0;
    }
  }
  B->held = b;
  for (size_t s = 0; s < b->bufs.size(); ++s) out[s] = b->bufs[s].data();
  if (epoch) *epoch = b->epoch;
  return b->rows;
}

void aecf_batcher_destroy(void* handle) {
  delete static_cast<Batcher*>(handle);
}

}  // extern "C"
