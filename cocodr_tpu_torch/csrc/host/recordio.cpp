// Threaded gather of token records for the port's data plane
// (cocodr_tpu_torch/data/native.py), built with g++ at first use.
//
// A record file is mapped once, and a batch gather decodes each record's
// big-endian length and copies its tokens from a few threads, outside
// Python's interpreter lock (ctypes releases it around the call).
//
// Record layout (cocodr_tpu_torch/data/records.py): length (4 bytes
// big-endian) + int32[max_len] token ids (little-endian).
//
// C ABI (ctypes): rio_open / rio_total / rio_gather / rio_gather_masked /
// rio_lengths / rio_close.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Reader {
  const uint8_t* base = nullptr;
  size_t size = 0;
  int64_t total = 0;
  int32_t max_len = 0;
  size_t record_bytes = 0;
  int fd = -1;
};

inline int32_t be32(const uint8_t* p) {
  return (int32_t)((uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                   (uint32_t(p[2]) << 8) | uint32_t(p[3]));
}

}  // namespace

extern "C" {

// An opaque handle, or nullptr when the file cannot be opened or mapped or
// its size is not a whole number of records.
void* rio_open(const char* path, int32_t max_len) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  size_t record_bytes = 4 + size_t(max_len) * 4;
  if (st.st_size % record_bytes != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = nullptr;
  if (st.st_size > 0) {
    mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (mem == MAP_FAILED) {
      ::close(fd);
      return nullptr;
    }
    madvise(mem, st.st_size, MADV_WILLNEED);
  }
  auto* r = new Reader();
  r->base = static_cast<const uint8_t*>(mem);
  r->size = st.st_size;
  r->max_len = max_len;
  r->record_bytes = record_bytes;
  r->total = int64_t(st.st_size / record_bytes);
  r->fd = fd;
  return r;
}

int64_t rio_total(void* handle) {
  return static_cast<Reader*>(handle)->total;
}

// Gather n records into out_tokens [n, max_len] int32 and out_lens [n]
// int32 over n_threads threads. 0 on success, -1 on an index out of range.
int32_t rio_gather(void* handle, const int64_t* indices, int64_t n,
                   int32_t* out_tokens, int32_t* out_lens,
                   int32_t n_threads) {
  auto* r = static_cast<Reader*>(handle);
  std::atomic<int32_t> status{0};
  const int64_t max_len = r->max_len;

  auto work = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t idx = indices[i];
      if (idx < 0 || idx >= r->total) {
        status.store(-1);
        return;
      }
      const uint8_t* rec = r->base + size_t(idx) * r->record_bytes;
      out_lens[i] = be32(rec);
      std::memcpy(out_tokens + i * max_len, rec + 4, size_t(max_len) * 4);
    }
  };

  if (n_threads <= 1 || n < 2 * n_threads) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
      int64_t b = t * chunk;
      int64_t e = std::min(n, b + chunk);
      if (b >= e) break;
      threads.emplace_back(work, b, e);
    }
    for (auto& th : threads) th.join();
  }
  return status.load();
}

// Gather and the attention mask (mask[i, j] = j < len_i).
int32_t rio_gather_masked(void* handle, const int64_t* indices, int64_t n,
                          int32_t* out_tokens, int32_t* out_mask,
                          int32_t n_threads) {
  auto* r = static_cast<Reader*>(handle);
  std::vector<int32_t> lens(static_cast<size_t>(n));
  int32_t st = rio_gather(handle, indices, n, out_tokens, lens.data(),
                          n_threads);
  if (st != 0) return st;
  const int64_t max_len = r->max_len;
  for (int64_t i = 0; i < n; ++i) {
    int32_t L = lens[i];
    int32_t* m = out_mask + i * max_len;
    for (int64_t j = 0; j < max_len; ++j) m[j] = j < L ? 1 : 0;
  }
  return 0;
}

// Every record's length into out_lens [total], reading the 4-byte prefixes
// alone.
void rio_lengths(void* handle, int32_t* out_lens) {
  auto* r = static_cast<Reader*>(handle);
  for (int64_t i = 0; i < r->total; ++i)
    out_lens[i] = be32(r->base + size_t(i) * r->record_bytes);
}

void rio_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r->base) munmap(const_cast<uint8_t*>(r->base), r->size);
  ::close(r->fd);
  delete r;
}

}  // extern "C"
