// Native feature loader: mmap .npy readers + threadpool prefetch cache.
//
// The reference feeds features through torch DataLoader worker *processes*
// doing np.load per item (dataset/dvc_dataset.py:61-70, SURVEY.md L2). Here
// the hot IO path is native: .npy headers are parsed once, data is mmap'd
// (zero-copy until touched), the temporal subsample/pad to a static shape
// (dvc_dataset.py:72-84 stride rule) happens in C++, and a threadpool
// prefetches upcoming items into an LRU cache so the host never stalls the
// GPU step on disk reads. The port's copy of the JAX package's loader, built
// by vidchapters_tpu_torch/data/_native_build.py.
//
// C ABI (ctypes-friendly):
//   void* fl_create(int threads, long cache_bytes);
//   void  fl_destroy(void*);
//   long  fl_load(void*, const char* path, float* out, long max_rows,
//                 long dim);                 // subsample/pad; rows written
//   long  fl_shape(void*, const char* path, long* rows, long* cols);
//   void  fl_prefetch(void*, const char* path);
//   long  fl_cache_entries(void*);

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <list>
#include <memory>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unordered_map>
#include <vector>
#include <unistd.h>

namespace {

struct NpyArray {
  std::vector<float> data;
  long rows = 0;
  long cols = 0;
  bool ok = false;
};

// Minimal .npy parser: v1.0/2.0 headers, little-endian f4/f8, C-order 2-D.
NpyArray load_npy(const std::string &path) {
  NpyArray out;
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return out;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) { ::close(fd); return out; }
  size_t size = static_cast<size_t>(st.st_size);
  void *mem = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return out;
  const uint8_t *p = static_cast<const uint8_t *>(mem);

  auto cleanup = [&]() { munmap(mem, size); };
  if (memcmp(p, "\x93NUMPY", 6) != 0) { cleanup(); return out; }
  uint8_t major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | (p[10] << 16) |
                 (static_cast<size_t>(p[11]) << 24);
    header_off = 12;
  }
  // a truncated/corrupt file can claim a header longer than the mapping
  if (header_off + header_len > size) { cleanup(); return out; }
  std::string header(reinterpret_cast<const char *>(p + header_off), header_len);

  bool f8 = header.find("<f8") != std::string::npos;
  if (!f8 && header.find("<f4") == std::string::npos) { cleanup(); return out; }
  if (header.find("'fortran_order': True") != std::string::npos) {
    cleanup(); return out;
  }
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) { cleanup(); return out; }
  size_t open_paren = header.find('(', sp);
  size_t close_paren = header.find(')', open_paren);
  std::string shape = header.substr(open_paren + 1, close_paren - open_paren - 1);
  long rows = 0, cols = 1;
  if (sscanf(shape.c_str(), "%ld , %ld", &rows, &cols) < 1 &&
      sscanf(shape.c_str(), "%ld, %ld", &rows, &cols) < 1) {
    sscanf(shape.c_str(), "%ld", &rows);
  }
  if (rows <= 0 || cols <= 0) { cleanup(); return out; }

  const uint8_t *body = p + header_off + header_len;
  size_t n = static_cast<size_t>(rows) * cols;
  size_t need = n * (f8 ? 8 : 4);
  if (header_off + header_len + need > size) { cleanup(); return out; }
  out.data.resize(n);
  if (f8) {
    const double *src = reinterpret_cast<const double *>(body);
    for (size_t i = 0; i < n; ++i) out.data[i] = static_cast<float>(src[i]);
  } else {
    memcpy(out.data.data(), body, need);
  }
  out.rows = rows;
  out.cols = cols;
  out.ok = true;
  cleanup();
  return out;
}

class Loader {
 public:
  Loader(int threads, long cache_bytes)
      : cache_limit_(cache_bytes > 0 ? cache_bytes : (1L << 30)) {
    int n = threads > 0 ? threads : 4;
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { worker(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &t : workers_) t.join();
  }

  std::shared_ptr<NpyArray> get(const std::string &path) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = cache_.find(path);
      if (it != cache_.end()) {
        touch(path);
        return it->second;
      }
    }
    auto arr = std::make_shared<NpyArray>(load_npy(path));
    insert(path, arr);
    return arr;
  }

  void prefetch(const std::string &path) {
    std::lock_guard<std::mutex> lk(mu_);
    if (cache_.count(path) || pending_.count(path)) return;
    pending_.insert({path, true});
    queue_.push_back(path);
    cv_.notify_one();
  }

  long cache_entries() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<long>(cache_.size());
  }

 private:
  void worker() {
    for (;;) {
      std::string path;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_) return;
        path = queue_.front();
        queue_.pop_front();
      }
      auto arr = std::make_shared<NpyArray>(load_npy(path));
      insert(path, arr);
      {
        std::lock_guard<std::mutex> lk(mu_);
        pending_.erase(path);
      }
    }
  }

  void insert(const std::string &path, std::shared_ptr<NpyArray> arr) {
    std::lock_guard<std::mutex> lk(mu_);
    // a get() racing a prefetch of the same path inserts twice: keep the
    // first entry, or the duplicate LRU node + double-counted bytes would
    // permanently shrink the effective cache
    if (cache_.count(path)) return;
    long bytes = static_cast<long>(arr->data.size() * sizeof(float));
    cache_[path] = std::move(arr);
    lru_.push_back(path);
    cache_bytes_ += bytes;
    while (cache_bytes_ > cache_limit_ && !lru_.empty()) {
      const std::string victim = lru_.front();
      lru_.pop_front();
      auto it = cache_.find(victim);
      if (it != cache_.end()) {
        cache_bytes_ -=
            static_cast<long>(it->second->data.size() * sizeof(float));
        cache_.erase(it);
      }
    }
  }

  void touch(const std::string &path) {
    for (auto it = lru_.begin(); it != lru_.end(); ++it) {
      if (*it == path) {
        lru_.erase(it);
        lru_.push_back(path);
        return;
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::string> queue_;
  std::unordered_map<std::string, bool> pending_;
  std::unordered_map<std::string, std::shared_ptr<NpyArray>> cache_;
  std::list<std::string> lru_;
  long cache_bytes_ = 0;
  long cache_limit_;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void *fl_create(int threads, long cache_bytes) {
  return new Loader(threads, cache_bytes);
}

void fl_destroy(void *h) { delete static_cast<Loader *>(h); }

long fl_shape(void *h, const char *path, long *rows, long *cols) {
  auto arr = static_cast<Loader *>(h)->get(path);
  if (!arr->ok) return -1;
  *rows = arr->rows;
  *cols = arr->cols;
  return 0;
}

// Load with the reference stride rule: rows > max_rows -> out[j] =
// row[(j * rows) / max_rows]; rows < max_rows -> zero-pad. Returns the
// number of valid (unpadded) rows, or -1 on failure.
long fl_load(void *h, const char *path, float *out, long max_rows, long dim) {
  auto arr = static_cast<Loader *>(h)->get(path);
  if (!arr->ok || arr->cols != dim) return -1;
  const float *src = arr->data.data();
  long rows = arr->rows;
  if (rows >= max_rows) {
    for (long j = 0; j < max_rows; ++j) {
      long idx = (j * rows) / max_rows;
      memcpy(out + j * dim, src + idx * dim, dim * sizeof(float));
    }
    return max_rows;
  }
  memcpy(out, src, rows * dim * sizeof(float));
  memset(out + rows * dim, 0, (max_rows - rows) * dim * sizeof(float));
  return rows;
}

void fl_prefetch(void *h, const char *path) {
  static_cast<Loader *>(h)->prefetch(path);
}

long fl_cache_entries(void *h) {
  return static_cast<Loader *>(h)->cache_entries();
}

}  // extern "C"
