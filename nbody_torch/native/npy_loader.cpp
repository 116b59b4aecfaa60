// Threaded .npy volume loader (native data path for the emulator).
//
// The reference's training loop is host-I/O bound: its keras DataGenerator
// np.load()s one volume per item per batch per epoch in Python
// (`TheFeedingPipeline/Cosmo NN5.py:186-241`; SURVEY.md §3.4 marks it HOT).
// This loader parses the .npy header and reads/decodes volumes with a C++
// thread pool into one preallocated contiguous buffer, so Python touches
// the data exactly once per batch.
//
// Supported payloads: '<f4' (copied) and '<f8' (converted to f32),
// C-contiguous, any shape.  API is plain C for ctypes.
//
// Error codes: negative values, see NPY_ERR_*.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int NPY_ERR_OPEN = -1;
constexpr int NPY_ERR_MAGIC = -2;
constexpr int NPY_ERR_HEADER = -3;
constexpr int NPY_ERR_DTYPE = -4;
constexpr int NPY_ERR_FORTRAN = -5;
constexpr int NPY_ERR_CAPACITY = -6;
constexpr int NPY_ERR_READ = -7;

struct NpyInfo {
  long n_elems = 0;
  int itemsize = 0;  // 4 or 8
  long data_offset = 0;
};

int parse_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return NPY_ERR_MAGIC;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return NPY_ERR_MAGIC;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return NPY_ERR_HEADER;
    hlen = b[0] | (b[1] << 8);
    info->data_offset = 10 + hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return NPY_ERR_HEADER;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
    info->data_offset = 12 + hlen;
  }
  std::string header(hlen, '\0');
  if (fread(&header[0], 1, hlen, f) != hlen) return NPY_ERR_HEADER;

  if (header.find("'<f4'") != std::string::npos ||
      header.find("\"<f4\"") != std::string::npos) {
    info->itemsize = 4;
  } else if (header.find("'<f8'") != std::string::npos ||
             header.find("\"<f8\"") != std::string::npos) {
    info->itemsize = 8;
  } else {
    return NPY_ERR_DTYPE;
  }
  if (header.find("'fortran_order': True") != std::string::npos)
    return NPY_ERR_FORTRAN;

  auto pos = header.find("'shape':");
  if (pos == std::string::npos) return NPY_ERR_HEADER;
  pos = header.find('(', pos);
  auto end = header.find(')', pos);
  if (pos == std::string::npos || end == std::string::npos) return NPY_ERR_HEADER;
  std::string shape = header.substr(pos + 1, end - pos - 1);
  long total = 1;
  bool any = false;
  const char* p = shape.c_str();
  while (*p) {
    while (*p && (*p == ' ' || *p == ',')) ++p;
    if (!*p) break;
    long d = strtol(p, const_cast<char**>(&p), 10);
    if (d <= 0) return NPY_ERR_HEADER;
    total *= d;
    any = true;
  }
  info->n_elems = any ? total : 1;  // '()' scalar
  return 0;
}

int read_one(const char* path, float* out, long capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return NPY_ERR_OPEN;
  NpyInfo info;
  int rc = parse_header(f, &info);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  if (info.n_elems > capacity) {
    fclose(f);
    return NPY_ERR_CAPACITY;
  }
  if (fseek(f, info.data_offset, SEEK_SET) != 0) {
    fclose(f);
    return NPY_ERR_READ;
  }
  if (info.itemsize == 4) {
    if (fread(out, 4, info.n_elems, f) != size_t(info.n_elems)) {
      fclose(f);
      return NPY_ERR_READ;
    }
  } else {
    std::vector<double> tmp(info.n_elems);
    if (fread(tmp.data(), 8, info.n_elems, f) != size_t(info.n_elems)) {
      fclose(f);
      return NPY_ERR_READ;
    }
    for (long i = 0; i < info.n_elems; ++i) out[i] = float(tmp[i]);
  }
  fclose(f);
  return int(info.n_elems > INT32_MAX ? INT32_MAX : info.n_elems);
}

}  // namespace

extern "C" {

// Read one .npy file of float32/float64 into `out` (as f32).
// Returns element count (>0) or a negative NPY_ERR_* code.
int npy_read_f32(const char* path, float* out, long capacity) {
  return read_one(path, out, capacity);
}

// Read n files concurrently; file i lands at out + i*per_item and must
// have exactly `per_item` elements.  Returns 0 or the first error code.
int npy_batch_read_f32(const char** paths, int n, float* out, long per_item,
                       int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      int rc = read_one(paths[i], out + long(i) * per_item, per_item);
      if (rc < 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
        return;
      }
      if (rc != per_item) {
        int expected = 0;
        err.compare_exchange_strong(expected, NPY_ERR_CAPACITY);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return err.load();
}

}  // extern "C"
