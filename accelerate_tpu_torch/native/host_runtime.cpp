// Native host-side data-path kernels (layer L3 hot path).
//
// The reference delegates batch assembly to torch's C++ DataLoader machinery
// (pin-memory threads + C collate, SURVEY.md §2.9); this is the TPU-native
// equivalent: multithreaded row gather / item stacking into contiguous
// batch buffers, called from Python through ctypes (which releases the GIL
// for the duration, so a Python-thread prefetcher gets real overlap with
// device compute).
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 host_runtime.cpp -o libhost_runtime.so
// (done at first use by accelerate_tpu_torch/native/__init__.py, into
// native/.build/).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

// Persistent worker pool: spawning std::threads per call costs more than a
// typical batch memcpy, so workers are created once and parked on a condvar.
class Pool {
 public:
  explicit Pool(int nthreads) : nthreads_(nthreads) {
    for (int t = 0; t < nthreads; ++t) {
      workers_.emplace_back([this, t]() { Run(t); });
    }
  }

  // Blocks until fn(begin, end) has covered [0, n) across the pool.
  // Serialized: ctypes releases the GIL, so concurrent Python threads (e.g.
  // two prefetching dataloaders) may call in simultaneously.
  void ParallelFor(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    if (n <= 0) return;
    std::lock_guard<std::mutex> call_lk(call_m_);
    {
      std::lock_guard<std::mutex> lk(m_);
      fn_ = &fn;
      n_ = n;
      chunk_ = std::max<int64_t>(1, (n + nthreads_) / (nthreads_ + 1));
      next_ = 0;
      pending_ = nthreads_;
      ++epoch_;
    }
    cv_.notify_all();
    // The calling thread works too.
    Drain(fn);
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [this]() { return pending_ == 0; });
    fn_ = nullptr;
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      ++epoch_;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

 private:
  void Drain(const std::function<void(int64_t, int64_t)>& fn) {
    while (true) {
      int64_t begin = next_.fetch_add(chunk_);
      if (begin >= n_) break;
      fn(begin, std::min<int64_t>(begin + chunk_, n_));
    }
  }

  void Run(int t) {
    uint64_t seen = 0;
    while (true) {
      const std::function<void(int64_t, int64_t)>* fn;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&]() { return stop_ || epoch_ != seen; });
        if (stop_) return;
        seen = epoch_;
        fn = fn_;
      }
      if (fn) Drain(*fn);
      {
        std::lock_guard<std::mutex> lk(m_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  int nthreads_;
  std::vector<std::thread> workers_;
  std::mutex call_m_;  // one ParallelFor at a time
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int64_t, int64_t)>* fn_ = nullptr;
  int64_t n_ = 0, chunk_ = 1;
  std::atomic<int64_t> next_{0};
  int pending_ = 0;
  uint64_t epoch_ = 0;
  bool stop_ = false;
};

Pool* GetPool(int nthreads) {
  static Pool* pool = new Pool(std::max(1, nthreads - 1));
  return pool;
}

template <typename F>
void parallel_for(int64_t n, int nthreads, F fn) {
  if (nthreads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  std::function<void(int64_t, int64_t)> f = fn;
  GetPool(nthreads)->ParallelFor(n, f);
}

}  // namespace

extern "C" {

// dst[j, :] = src[idx[j], :] for row_bytes-sized rows.
void at_gather_rows(const char* src, int64_t row_bytes, const int64_t* idx,
                    int64_t n, char* dst, int nthreads) {
  parallel_for(n, nthreads, [=](int64_t begin, int64_t end) {
    for (int64_t j = begin; j < end; ++j) {
      std::memcpy(dst + j * row_bytes, src + idx[j] * row_bytes, row_bytes);
    }
  });
}

// dst[j, :] = *srcs[j] for item_bytes-sized independent items.
void at_stack_ptrs(const char** srcs, int64_t item_bytes, int64_t n, char* dst,
                   int nthreads) {
  parallel_for(n, nthreads, [=](int64_t begin, int64_t end) {
    for (int64_t j = begin; j < end; ++j) {
      std::memcpy(dst + j * item_bytes, srcs[j], item_bytes);
    }
  });
}

// Gather rows from several parallel column arrays in one call (one batch of a
// dict-of-arrays dataset): for each column c, dsts[c][j] = srcs[c][idx[j]].
void at_gather_columns(const char** srcs, const int64_t* row_bytes,
                       int64_t ncols, const int64_t* idx, int64_t n,
                       char** dsts, int nthreads) {
  parallel_for(n * ncols, nthreads, [=](int64_t begin, int64_t end) {
    for (int64_t k = begin; k < end; ++k) {
      int64_t c = k / n;
      int64_t j = k % n;
      std::memcpy(dsts[c] + j * row_bytes[c], srcs[c] + idx[j] * row_bytes[c],
                  row_bytes[c]);
    }
  });
}

int at_version() { return 3; }

}  // extern "C"

#include <fcntl.h>
#include <unistd.h>
#include <cerrno>

extern "C" {

// Parallel positioned reads: dsts[i] receives sizes[i] bytes from
// offsets[i] of `path`. The checkpoint-streaming hot path (L7/L8): one
// safetensors shard holds hundreds of tensors, and per-tensor pread from
// page cache is memcpy-bound — exactly what the pool parallelizes. Returns 0
// on success, -errno of the first failed segment otherwise.
int at_pread_segments(const char* path, const int64_t* offsets,
                      const int64_t* sizes, char** dsts, int64_t n,
                      int nthreads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  std::atomic<int> status{0};
  parallel_for(n, nthreads, [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t done = 0;
      while (done < sizes[i]) {
        ssize_t r = ::pread(fd, dsts[i] + done, sizes[i] - done, offsets[i] + done);
        if (r <= 0) {
          int err = r < 0 ? errno : EIO;
          int expected = 0;
          status.compare_exchange_strong(expected, -err);
          return;
        }
        done += r;
      }
    }
  });
  ::close(fd);
  return status.load();
}

// Parallel positioned writes — the save-side twin of at_pread_segments
// (checkpoint export: one safetensors shard, hundreds of tensor payloads,
// page-cache memcpy-bound). Creates/truncates `path`, writes `header` at
// offset 0, then fans the payload segments over the pool. fsync before
// close so a returned 0 means bytes reached storage. Returns 0 on success,
// -errno of the first failure otherwise.
int at_pwrite_segments(const char* path, const char* header,
                       int64_t header_len, const int64_t* offsets,
                       const int64_t* sizes, const char** srcs, int64_t n,
                       int nthreads) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  int64_t done = 0;
  while (done < header_len) {
    ssize_t r = ::pwrite(fd, header + done, header_len - done, done);
    if (r <= 0) {
      int err = r < 0 ? errno : EIO;
      ::close(fd);
      return -err;
    }
    done += r;
  }
  std::atomic<int> status{0};
  // Dedicated one-shot threads, NOT the shared pool: pwrites block on disk
  // under writeback throttling, and the pool serializes ParallelFor calls —
  // a multi-GB checkpoint write would stall the data-loading gathers that
  // share it. Writes are storage-bound; thread-spawn cost is noise.
  {
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n || status.load() != 0) return;
        int64_t w = 0;
        while (w < sizes[i]) {
          ssize_t r = ::pwrite(fd, srcs[i] + w, sizes[i] - w, offsets[i] + w);
          if (r <= 0) {
            int err = r < 0 ? errno : EIO;
            int expected = 0;
            status.compare_exchange_strong(expected, -err);
            return;
          }
          w += r;
        }
      }
    };
    int nw = static_cast<int>(std::min<int64_t>(std::max(1, nthreads), n));
    std::vector<std::thread> threads;
    threads.reserve(nw - 1);
    for (int t = 1; t < nw; ++t) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
  }
  if (::fsync(fd) != 0) {
    int expected = 0;
    status.compare_exchange_strong(expected, -errno);
  }
  ::close(fd);
  return status.load();
}

}  // extern "C"
