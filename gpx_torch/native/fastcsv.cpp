// Native chain-IO runtime: fast CSV serialization for MCMC chains.
//
// The reference streams sampler output to per-chain CSVs through
// kantan.csv + Akka Streams (Streaming.writeParallelChain,
// examples/SimulatedGp.scala:163-165). Python's csv module is the bottleneck
// for large chains (millions of rows x dozens of parameters); this C++
// implementation writes/parses with hand-rolled double formatting at memory
// bandwidth and is exposed to gpx_torch.io through ctypes. gpx_torch.io
// keeps a pure-Python path that writes the same bytes, for machines
// without g++.
//
// Build: gpx_torch/native/build.py (g++ -O3 -shared -fPIC -std=c++17) at
// first use, into build/ at the root of the checkout.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Write a rows x cols matrix of doubles as CSV with a header line.
// header: comma-joined column names (already formatted by the caller).
// Returns 0 on success, negative errno-style codes on failure.
int gpx_write_csv(const char* path, const char* header, const double* data,
                  int64_t rows, int64_t cols) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;

  std::string buf;
  buf.reserve(1 << 22);
  buf.append(header);
  buf.push_back('\n');

  char num[64];
  for (int64_t r = 0; r < rows; ++r) {
    const double* row = data + r * cols;
    for (int64_t c = 0; c < cols; ++c) {
      int len = std::snprintf(num, sizeof(num), "%.17g", row[c]);
      buf.append(num, len);
      buf.push_back(c + 1 == cols ? '\n' : ',');
    }
    if (buf.size() > (1 << 21)) {
      if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        return -2;
      }
      buf.clear();
    }
  }
  if (!buf.empty() &&
      std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  return 0;
}

// First pass: return number of data rows and columns (from the header).
int gpx_csv_shape(const char* path, int64_t* rows, int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> content(size);
  if (size > 0 && std::fread(content.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  int64_t nrows = 0, ncols = 1;
  const char* p = content.data();
  const char* end = p + size;
  // header
  const char* nl = (const char*)memchr(p, '\n', end - p);
  if (!nl) return -3;
  for (const char* q = p; q < nl; ++q)
    if (*q == ',') ++ncols;
  p = nl + 1;
  while (p < end) {
    nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) {
      if (end - p > 1) ++nrows;  // last line without newline
      break;
    }
    if (nl > p) ++nrows;
    p = nl + 1;
  }
  *rows = nrows;
  *cols = ncols;
  return 0;
}

// Second pass: parse data rows into a caller-allocated rows*cols buffer.
int gpx_read_csv(const char* path, double* out, int64_t rows, int64_t cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> content(size + 1);
  if (size > 0 && std::fread(content.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  content[size] = '\0';

  char* p = content.data();
  char* end = p + size;
  // skip header
  char* nl = (char*)memchr(p, '\n', end - p);
  if (!nl) return -3;
  p = nl + 1;

  int64_t idx = 0;
  const int64_t total = rows * cols;
  while (p < end && idx < total) {
    char* next = nullptr;
    out[idx++] = std::strtod(p, &next);
    if (next == p) {  // skip separators / blank bytes
      ++p;
      --idx;
      continue;
    }
    p = next;
    if (p < end && (*p == ',' || *p == '\n' || *p == '\r')) ++p;
  }
  return idx == total ? 0 : -4;
}

}  // extern "C"
