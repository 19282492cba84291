// Host text I/O of the PyTorch port: base encoding, and the parsing and
// formatting of the numeric text tables kf2vec reads and writes (`.kf`
// rows, `.di_mtrx` bodies, the str(np.float32) rows of APPLES matrices,
// `.emb` files and the trainers' exports).
//
// The text half of the JAX package's C++ ingest library, copied so the port
// needs nothing of that package: the formatters write exactly the bytes of
// CPython's repr(float) / numpy's str(np.float32), and the parsers read the
// values Python's float() reads. Counting is not here: the port counts on
// the card with kmer_hist.
//
// Built with g++ -O3 -std=c++17 -fPIC -shared by lib.py on first use;
// loaded with ctypes.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

uint8_t LUT[256];

struct LutInit {
  LutInit() {
    memset(LUT, 4, sizeof(LUT));
    LUT['A'] = LUT['a'] = 0;
    LUT['C'] = LUT['c'] = 1;
    LUT['G'] = LUT['g'] = 2;
    LUT['T'] = LUT['t'] = 3;
  }
} lut_init;

// Render one float/double exactly as CPython repr(float) / str(np.float32):
// shortest round-trip digits (std::to_chars scientific); fixed notation for
// exact |v| in [1e-4, 1e16), otherwise scientific with explicit sign and
// >= 2 exponent digits. The notation choice uses the EXACT value (numpy's
// dragon4 rule: float32(1e-4) = 9.9999997e-05 prints '1e-04' even though
// its shortest digits are "1"e-4); for float64 this coincides with
// CPython's digit-exponent rule on every double.
template <typename T>
char* py_repr(T v, char* p) {
  if (std::isnan(v)) {  // repr(float('nan')) == 'nan' (sign dropped)
    memcpy(p, "nan", 3);
    return p + 3;
  }
  if (std::isinf(v)) {
    if (v < 0) *p++ = '-';
    memcpy(p, "inf", 3);
    return p + 3;
  }
  if (v == (T)0.0) {
    if (std::signbit(v)) *p++ = '-';
    *p++ = '0';
    *p++ = '.';
    *p++ = '0';
    return p;
  }
  if (v < 0) {
    *p++ = '-';
    v = -v;
  }
  const bool fixed = (double)v >= 1e-4 && (double)v < 1e16;
  char buf[48];
  auto res = std::to_chars(buf, buf + 48, v, std::chars_format::scientific);
  char digits[32];
  int nd = 0;
  char* q = buf;
  digits[nd++] = *q++;
  if (*q == '.') {
    ++q;
    while (*q != 'e') digits[nd++] = *q++;
  }
  ++q;  // 'e'
  int esign = (*q++ == '-') ? -1 : 1;
  int E = 0;
  while (q < res.ptr) E = E * 10 + (*q++ - '0');
  E *= esign;
  if (fixed) {
    if (E >= nd - 1) {  // integral: digits, zero pad, ".0"
      memcpy(p, digits, nd);
      p += nd;
      for (int i = 0; i < E - nd + 1; ++i) *p++ = '0';
      *p++ = '.';
      *p++ = '0';
    } else if (E >= 0) {  // decimal point inside the digit string
      memcpy(p, digits, E + 1);
      p += E + 1;
      *p++ = '.';
      memcpy(p, digits + E + 1, nd - E - 1);
      p += nd - E - 1;
    } else {  // 0.0...digits
      *p++ = '0';
      *p++ = '.';
      for (int i = 0; i < -E - 1; ++i) *p++ = '0';
      memcpy(p, digits, nd);
      p += nd;
    }
  } else {  // scientific, python style
    *p++ = digits[0];
    if (nd > 1) {
      *p++ = '.';
      memcpy(p, digits + 1, nd - 1);
      p += nd - 1;
    }
    *p++ = 'e';
    *p++ = E >= 0 ? '+' : '-';
    int a = E >= 0 ? E : -E;
    char tmp[8];
    int len = 0;
    do {
      tmp[len++] = (char)('0' + a % 10);
      a /= 10;
    } while (a);
    while (len < 2) tmp[len++] = '0';
    while (len) *p++ = tmp[--len];
  }
  return p;
}

}  // namespace

extern "C" {

// Base codes A/a=0, C/c=1, G/g=2, T/t=3, anything else 4.
void kf2vec_encode(const uint8_t* in, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = LUT[in[i]];
}

// An int64 array as a `.kf` row tail: each value as "<int>.0" joined by
// commas, then '\n'. Returns the bytes written; out needs n * 24 bytes
// (worst: '-' + 19 digits + ".0" + separator).
int64_t kf2vec_format_counts(const int64_t* vals, int64_t n, char* out) {
  char* p = out;
  for (int64_t i = 0; i < n; ++i) {
    if (i) *p++ = ',';
    int64_t v = vals[i];
    // negate via uint64: -INT64_MIN is signed-overflow UB in int64
    uint64_t u;
    if (v < 0) {
      *p++ = '-';
      u = ~(uint64_t)v + 1;
    } else {
      u = (uint64_t)v;
    }
    char tmp[20];
    int len = 0;
    do {
      tmp[len++] = (char)('0' + u % 10);
      u /= 10;
    } while (u);
    while (len) *p++ = tmp[--len];
    *p++ = '.';
    *p++ = '0';
  }
  *p++ = '\n';
  return p - out;
}

// py_repr renderings of a float64 array joined by `sep`, then '\n'. out
// needs n * 26 bytes. Returns the bytes written.
int64_t kf2vec_format_doubles(const double* vals, int64_t n, char* out,
                              char sep) {
  char* p = out;
  for (int64_t i = 0; i < n; ++i) {
    if (i) *p++ = sep;
    p = py_repr(vals[i], p);
  }
  *p++ = '\n';
  return p - out;
}

// The same for float32 (str(np.float32)). out needs n * 22 bytes.
int64_t kf2vec_format_floats(const float* vals, int64_t n, char* out,
                             char sep) {
  char* p = out;
  for (int64_t i = 0; i < n; ++i) {
    if (i) *p++ = sep;
    p = py_repr(vals[i], p);
  }
  *p++ = '\n';
  return p - out;
}

// A run of decimal floats separated by ',' '\t' ' ' (and line ends) into
// out (capacity max_vals). Returns the count, or -1 on a malformed token or
// capacity overflow.
int64_t kf2vec_parse_doubles(const char* s, int64_t len, double* out,
                             int64_t max_vals) {
  const char* p = s;
  const char* end = s + len;
  int64_t n = 0;
  while (p < end) {
    while (p < end && (*p == ',' || *p == '\t' || *p == ' ' || *p == '\n' ||
                       *p == '\r'))
      ++p;
    if (p >= end) break;
    if (n >= max_vals) return -1;
    auto res = std::from_chars(p, end, out[n]);
    if (res.ec != std::errc()) return -1;
    ++n;
    p = res.ptr;
  }
  return n;
}

// A whole name-prefixed numeric table (.kf: "name,v1,...\n" rows; .di_mtrx
// body: "name\tv1\t...\n"). Fills vals row-major and records the [start,
// end) byte offsets of each row's name in name_spans (2 per row). Every row
// must have the same value count. Returns the row count and sets
// *cols_out; -1 on malformed or ragged input or capacity overflow.
int64_t kf2vec_parse_table(const char* s, int64_t len, double* vals,
                           int64_t max_vals, int64_t* name_spans,
                           int64_t max_rows, int64_t* cols_out) {
  const char* p = s;
  const char* end = s + len;
  int64_t rows = 0, nvals = 0, cols = -1;
  while (p < end) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    if (rows >= max_rows) return -1;
    const char* name_start = p;
    while (p < end && *p != ',' && *p != '\t' && *p != '\n') ++p;
    if (p >= end || *p == '\n') return -1;  // row with no values
    name_spans[2 * rows] = name_start - s;
    name_spans[2 * rows + 1] = p - s;
    int64_t row_vals = 0;
    while (p < end && *p != '\n') {
      while (p < end && (*p == ',' || *p == '\t' || *p == ' ' || *p == '\r'))
        ++p;
      if (p >= end || *p == '\n') break;
      if (nvals >= max_vals) return -1;
      auto res = std::from_chars(p, end, vals[nvals]);
      if (res.ec != std::errc()) return -1;
      ++nvals;
      ++row_vals;
      p = res.ptr;
    }
    if (cols < 0) cols = row_vals;
    if (row_vals != cols) return -1;
    ++rows;
  }
  *cols_out = cols < 0 ? 0 : cols;
  return rows;
}

}  // extern "C"
