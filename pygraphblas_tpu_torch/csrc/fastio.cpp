// Native MatrixMarket parser and COO canonicaliser for
// pygraphblas_tpu_torch/io (the port's copy of native/fastio.cpp's
// parse_mm and sort_dedup), behind a plain C interface for ctypes.
// Built with g++ at first use by pygraphblas_tpu_torch/_native.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o libpgb_fastio_<hash>.so fastio.cpp

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Triples {
  std::vector<int64_t> rows;
  std::vector<int64_t> cols;
  std::vector<double> vals;    // a real file's values
  std::vector<int64_t> ivals;  // an integer file's values, exact
  int64_t nrows = 0;
  int64_t ncols = 0;
  char field = 'r';  // r(eal) | i(nteger) | p(attern)
  char symmetry = 'g';
};

// fast forward over spaces/tabs
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Parse into `out`.  Returns 0, 2 (not a coordinate MatrixMarket file) or
// 3 (a file this parser leaves to the Python reader: complex or
// hermitian, or an integer value that is not an int64 literal).
int parse_mm_buffer(const char* buf, size_t len, Triples* out) {
  const char* p = buf;
  const char* end = buf + len;
  // header
  if (len < 14 || strncmp(p, "%%MatrixMarket", 14) != 0) return 2;
  {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    std::string header(p, line_end - p);
    for (char& ch : header) ch = (char)std::tolower((unsigned char)ch);
    if (header.find("coordinate") == std::string::npos) return 2;
    if (header.find("complex") != std::string::npos ||
        header.find("hermitian") != std::string::npos)
      return 3;
    if (header.find("pattern") != std::string::npos) out->field = 'p';
    else if (header.find("integer") != std::string::npos) out->field = 'i';
    else out->field = 'r';
    // "skew-symmetric" holds "symmetric": test it first
    if (header.find("skew-symmetric") != std::string::npos)
      out->symmetry = 'k';
    else if (header.find("symmetric") != std::string::npos)
      out->symmetry = 's';
    p = next_line(p, end);
  }
  while (p < end && *p == '%') p = next_line(p, end);
  char* q;
  out->nrows = strtoll(p, &q, 10);
  out->ncols = strtoll(q, &q, 10);
  int64_t nnz = strtoll(q, &q, 10);
  p = next_line(q, end);

  const size_t cap = nnz * (out->symmetry == 'g' ? 1 : 2);
  out->rows.reserve(cap);
  out->cols.reserve(cap);
  if (out->field == 'r') out->vals.reserve(cap);
  if (out->field == 'i') out->ivals.reserve(cap);

  for (int64_t k = 0; k < nnz && p < end; ++k) {
    int64_t i = strtoll(p, &q, 10) - 1;
    int64_t j = strtoll(q, &q, 10) - 1;
    double v = 1.0;
    int64_t iv = 1;
    if (out->field == 'r') {
      v = strtod(q, &q);
    } else if (out->field == 'i') {
      const char* s = skip_ws(q, end);
      errno = 0;
      iv = strtoll(s, &q, 10);
      const char* t = skip_ws(q, end);
      if (errno == ERANGE || q == s || (t < end && *t != '\n')) return 3;
    }
    out->rows.push_back(i);
    out->cols.push_back(j);
    if (out->field == 'r') out->vals.push_back(v);
    if (out->field == 'i') out->ivals.push_back(iv);
    if (out->symmetry != 'g' && i != j) {
      out->rows.push_back(j);
      out->cols.push_back(i);
      const bool skew = out->symmetry == 'k';
      if (out->field == 'r') out->vals.push_back(skew ? -v : v);
      // wraps at INT64_MIN as numpy's negation does
      if (out->field == 'i')
        out->ivals.push_back(skew ? (int64_t)(0ULL - (uint64_t)iv) : iv);
    }
    p = next_line(q, end);
  }
  return 0;
}

// LSD radix sort of (row, col) keyed triples, 16 bits per pass; the
// values (if any) only move.
template <typename V>
void radix_sort_triples(std::vector<int64_t>& rows,
                        std::vector<int64_t>& cols,
                        std::vector<V>& vals, bool has_vals) {
  const size_t n = rows.size();
  if (n < 2) return;
  int64_t max_row = 0, max_col = 0;
  for (size_t k = 0; k < n; ++k) {
    if (rows[k] > max_row) max_row = rows[k];
    if (cols[k] > max_col) max_col = cols[k];
  }
  std::vector<uint32_t> order(n), tmp(n);
  for (size_t k = 0; k < n; ++k) order[k] = (uint32_t)k;

  auto passes_for = [](int64_t maxv) {
    int p = 0;
    while (maxv > 0) { ++p; maxv >>= 16; }
    return p > 0 ? p : 1;
  };
  auto run_passes = [&](const std::vector<int64_t>& key, int npass) {
    std::vector<size_t> count(65536);
    for (int pass = 0; pass < npass; ++pass) {
      const int shift = pass * 16;
      std::fill(count.begin(), count.end(), 0);
      for (size_t k = 0; k < n; ++k)
        ++count[(key[order[k]] >> shift) & 0xFFFF];
      size_t total = 0;
      for (size_t b = 0; b < 65536; ++b) {
        size_t c = count[b];
        count[b] = total;
        total += c;
      }
      for (size_t k = 0; k < n; ++k) {
        uint32_t idx = order[k];
        tmp[count[(key[idx] >> shift) & 0xFFFF]++] = idx;
      }
      order.swap(tmp);
    }
  };
  run_passes(cols, passes_for(max_col));
  run_passes(rows, passes_for(max_row));

  // apply permutation, dedup keeping the LAST occurrence (stable LSD sort
  // keeps original order within equal keys)
  std::vector<int64_t> r2, c2;
  std::vector<V> v2;
  r2.reserve(n);
  c2.reserve(n);
  if (has_vals) v2.reserve(n);
  for (size_t k = 0; k < n; ++k) {
    uint32_t idx = order[k];
    bool dup = !r2.empty() && r2.back() == rows[idx] &&
               c2.back() == cols[idx];
    if (dup) {
      if (has_vals) v2.back() = vals[idx];
    } else {
      r2.push_back(rows[idx]);
      c2.push_back(cols[idx]);
      if (has_vals) v2.push_back(vals[idx]);
    }
  }
  rows.swap(r2);
  cols.swap(c2);
  if (has_vals) vals.swap(v2);
}

}  // namespace

extern "C" {

// Parse the MatrixMarket coordinate file at `path` (symmetric and
// skew-symmetric files expanded), sorted by (row, col) with the last of
// duplicate entries kept when `canonicalize`.  Returns a handle for
// pgb_mm_take, or nullptr with *err 1 (the file cannot be read), 2 (not
// a coordinate MatrixMarket file) or 3 (complex, hermitian, or an
// integer value that is not an int64 literal: the Python reader's).
void* pgb_mm_parse(const char* path, int canonicalize, int64_t* nnz,
                   int64_t* nrows, int64_t* ncols, char* field, int* err) {
  *err = 0;
  FILE* f = fopen(path, "rb");
  if (!f) {
    *err = 1;
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(sz > 0 ? sz : 0);
  size_t got = sz > 0 ? fread(buf.data(), 1, sz, f) : 0;
  fclose(f);
  Triples* t = new Triples();
  if ((*err = parse_mm_buffer(buf.data(), got, t)) != 0) {
    delete t;
    return nullptr;
  }
  if (canonicalize) {
    if (t->field == 'i')
      radix_sort_triples(t->rows, t->cols, t->ivals, true);
    else
      radix_sort_triples(t->rows, t->cols, t->vals, t->field == 'r');
  }
  *nnz = (int64_t)t->rows.size();
  *nrows = t->nrows;
  *ncols = t->ncols;
  *field = t->field;
  return t;
}

// Copy a parsed file's triples out (vals: float64 for a real file, int64
// for an integer one, unused for a pattern file) and free the handle.
void pgb_mm_take(void* h, int64_t* rows, int64_t* cols, void* vals) {
  Triples* t = static_cast<Triples*>(h);
  std::copy(t->rows.begin(), t->rows.end(), rows);
  std::copy(t->cols.begin(), t->cols.end(), cols);
  if (vals && t->field == 'r')
    std::copy(t->vals.begin(), t->vals.end(), static_cast<double*>(vals));
  if (vals && t->field == 'i')
    std::copy(t->ivals.begin(), t->ivals.end(), static_cast<int64_t*>(vals));
  delete t;
}

// Sort n int64 (row, col) keyed triples in place, carrying an int64
// payload (an index into the caller's values, or null), keeping the last
// of duplicate keys; returns the new count.
int64_t pgb_sort_dedup(int64_t n, int64_t* rows, int64_t* cols,
                       int64_t* payload) {
  std::vector<int64_t> r(rows, rows + n), c(cols, cols + n);
  std::vector<int64_t> v;
  if (payload) v.assign(payload, payload + n);
  radix_sort_triples(r, c, v, payload != nullptr);
  std::copy(r.begin(), r.end(), rows);
  std::copy(c.begin(), c.end(), cols);
  if (payload) std::copy(v.begin(), v.end(), payload);
  return (int64_t)r.size();
}

}  // extern "C"
