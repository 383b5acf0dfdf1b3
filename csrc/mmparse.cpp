// Fast parallel Matrix Market parser — native host-side I/O path.
//
// Counterpart of the reference's mmio.c + the byte-range-splitting
// parallel read of SpParMat::ParallelReadMM (SpParMat.cpp:3980): the file is
// mmap'd, the body is split at newline boundaries into one chunk per hardware
// thread, and each thread parses its range with a hand-rolled integer/float
// scanner (no locale, no strtod overhead).  Exposed through a minimal C ABI
// consumed via ctypes (combblas_tpu/io/mtx.py) — no pybind11 dependency.
//
// Supported: coordinate real/integer/pattern, general/symmetric/skew
// symmetric; 1-based indices; headerless "m n nnz" triple files (the
// reference's ReadDistribute style, e.g. ReleaseTests/small_nonsym.mtx).
//
// Build: make -C csrc   (produces libmmparse.so)

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
  explicit MappedFile(const char* path) {
    fd = open(path, O_RDONLY);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) { close(fd); fd = -1; return; }
    size = static_cast<size_t>(st.st_size);
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) { close(fd); fd = -1; return; }
    data = static_cast<const char*>(p);
  }
  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) close(fd);
  }
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_ll(const char* p, const char* end, long long* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = *p == '-'; ++p; }
  long long v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_double(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  char* q = nullptr;
  // bounded strtod: lines are short; end-of-mapping is not NUL-terminated in
  // theory, but mmap of a regular file rounds to page size with zero fill, so
  // strtod stops at the padding for all but exactly-page-sized files; handle
  // those by copying the tail.
  *out = strtod(p, &q);
  return q ? q : p;
}

struct Header {
  long long m = 0, n = 0, nnz = 0;
  bool pattern = false;
  bool symmetric = false;   // also set for skew (sign handled separately)
  double sym_sign = 1.0;
  const char* body = nullptr;  // first data byte
  bool ok = false;
};

Header parse_header(const MappedFile& f) {
  Header h;
  const char* p = f.data;
  const char* end = f.data + f.size;
  auto line_end = [&](const char* q) {
    while (q < end && *q != '\n') ++q;
    return q;
  };
  const char* le = line_end(p);
  std::string first(p, le - p);
  std::string lower = first;
  std::transform(lower.begin(), lower.end(), lower.begin(), ::tolower);
  if (lower.rfind("%%matrixmarket", 0) == 0) {
    if (lower.find("coordinate") == std::string::npos) return h;  // dense unsupported
    h.pattern = lower.find("pattern") != std::string::npos;
    if (lower.find("skew-symmetric") != std::string::npos) {
      h.symmetric = true;
      h.sym_sign = -1.0;
    } else if (lower.find("symmetric") != std::string::npos ||
               lower.find("hermitian") != std::string::npos) {
      h.symmetric = true;
    }
    p = le + 1;
    while (p < end && (*p == '%' || *p == '\n')) p = line_end(p) + 1;
  } else if (first.size() && first[0] == '%') {
    return h;
  }
  // dims line (also the headerless-file entry point)
  p = parse_ll(p, end, &h.m);
  p = parse_ll(p, end, &h.n);
  p = parse_ll(p, end, &h.nnz);
  p = line_end(p);
  if (p < end) ++p;
  if (h.m <= 0 || h.n <= 0 || h.nnz < 0) return h;
  h.body = p;
  h.ok = true;
  return h;
}

}  // namespace

extern "C" {

// Upper bound on output entries (accounts for symmetric mirroring), or -1.
long long mm_count(const char* path) {
  MappedFile f(path);
  if (!f.ok()) return -1;
  Header h = parse_header(f);
  if (!h.ok) return -1;
  return h.symmetric ? 2 * h.nnz : h.nnz;
}

// Parse into caller-allocated arrays of capacity `cap`; returns entries
// written (>= 0) or -1 on error.  flags: bit0 = pattern, bit1 = symmetric.
long long mm_parse(const char* path, long long* m, long long* n,
                   long long* nnz, int* flags, int32_t* row, int32_t* col,
                   float* val, long long cap) {
  MappedFile f(path);
  if (!f.ok()) return -1;
  Header h = parse_header(f);
  if (!h.ok) return -1;
  *m = h.m;
  *n = h.n;
  *nnz = h.nnz;
  *flags = (h.pattern ? 1 : 0) | (h.symmetric ? 2 : 0);

  const char* body = h.body;
  const char* end = f.data + f.size;
  unsigned nthreads =
      std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
  size_t body_len = static_cast<size_t>(end - body);
  if (body_len < (1u << 20)) nthreads = 1;

  // chunk boundaries snapped to newlines
  std::vector<const char*> starts(nthreads + 1);
  starts[0] = body;
  starts[nthreads] = end;
  for (unsigned t = 1; t < nthreads; ++t) {
    const char* p = body + body_len * t / nthreads;
    while (p < end && *p != '\n') ++p;
    starts[t] = p < end ? p + 1 : end;
  }

  struct Chunk {
    std::vector<int32_t> r, c;
    std::vector<float> v;
    bool bad = false;
  };
  std::vector<Chunk> chunks(nthreads);
  auto work = [&](unsigned t) {
    Chunk& ck = chunks[t];
    const char* p = starts[t];
    const char* stop = starts[t + 1];
    ck.r.reserve((stop - p) / 12);
    ck.c.reserve((stop - p) / 12);
    if (!h.pattern) ck.v.reserve((stop - p) / 12);
    while (p < stop) {
      p = skip_ws(p, stop);
      if (p >= stop) break;
      if (*p == '\n') { ++p; continue; }
      if (*p == '%') { while (p < stop && *p != '\n') ++p; continue; }
      long long i = 0, j = 0;
      double x = 1.0;
      p = parse_ll(p, stop, &i);
      p = parse_ll(p, stop, &j);
      if (!h.pattern) {
        const char* q = skip_ws(p, stop);
        if (q < stop && *q != '\n') p = parse_double(q, stop, &x);
      }
      while (p < stop && *p != '\n') ++p;
      if (p < stop) ++p;
      if (i < 1 || j < 1 || i > h.m || j > h.n) { ck.bad = true; return; }
      ck.r.push_back(static_cast<int32_t>(i - 1));
      ck.c.push_back(static_cast<int32_t>(j - 1));
      ck.v.push_back(static_cast<float>(x));
    }
  };
  std::vector<std::thread> threads;
  for (unsigned t = 1; t < nthreads; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();

  long long out = 0;
  for (unsigned t = 0; t < nthreads; ++t) {
    Chunk& ck = chunks[t];
    if (ck.bad) return -1;
    for (size_t k = 0; k < ck.r.size(); ++k) {
      if (out >= cap) return -1;
      row[out] = ck.r[k];
      col[out] = ck.c[k];
      val[out] = ck.v[k];
      ++out;
      if (h.symmetric && ck.r[k] != ck.c[k]) {
        if (out >= cap) return -1;
        row[out] = ck.c[k];
        col[out] = ck.r[k];
        val[out] = static_cast<float>(h.sym_sign) * ck.v[k];
        ++out;
      }
    }
  }
  return out;
}

}  // extern "C"
