// Vectorized host-side batch parsers for the input pipeline.
//
// Reference parity: the reference's input path leaned on tf.data's C++ op
// kernels to keep record decoding off the Python interpreter (SURVEY §2.4,
// §7 hard-part 4). This is the rebuild's equivalent: one ctypes call parses
// an entire batch of records into preallocated numpy buffers, releasing the
// GIL for the duration (ctypes drops it around foreign calls), so a thread
// pool of parsers scales across cores instead of serializing on the
// interpreter the way the per-record Python loop did.
//
// Layout contract (shared with data/parsing.py): the caller concatenates the
// batch's records into one contiguous buffer and passes n+1 offsets;
// record i is buf[offsets[i], offsets[i+1]). Records may keep a trailing
// newline — parsers treat '\n' as end-of-record.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC batch_parse.cc -o libbatch_parse.so
// (data/nativelib.py auto-builds exactly this name — lib<stem>.so — on
// first use; a manually built .so must match it or the loader ignores it).

#include <cstdint>
#include <cstring>

namespace {

// Parse a non-negative decimal int from [p, end); stops at the first
// non-digit. Returns the value and advances *pp. Criteo dense fields can be
// negative in the wild (counts occasionally are), so allow a leading '-'.
inline long long parse_int(const char** pp, const char* end) {
  const char* p = *pp;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  long long v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  *pp = p;
  return neg ? -v : v;
}

// Parse a float: integer part, optional fraction, optional exponent — the
// same grammar Python's float() accepts for finite decimals, so the native
// kernel and the pure-Python fallback parse identical values ("2.5e2" must
// be 250, not 2.5). Criteo dense fields are integers in practice, but the
// reference's CSV path tolerated floats. "" parses as 0.
inline float parse_float(const char** pp, const char* end) {
  const char* p = *pp;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  double v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * scale;
      scale *= 0.1;
      ++p;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    const char* mark = p;  // only consume a well-formed exponent
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    if (p < end && *p >= '0' && *p <= '9') {
      long long e = 0;
      while (p < end && *p >= '0' && *p <= '9') {
        e = e * 10 + (*p - '0');
        ++p;
      }
      double f = 1.0;
      for (long long i = 0; i < e && i < 64; ++i) f *= 10.0;
      v = eneg ? v / f : v * f;
    } else {
      p = mark;  // bare 'e' is not an exponent; leave it for skip_field
    }
  }
  *pp = p;
  return static_cast<float>(neg ? -v : v);
}

// Parse a lowercase/uppercase hex field (Criteo categorical), masked to
// int32 range like the Python parser's `int(p, 16) & 0x7FFFFFFF`.
inline int32_t parse_hex(const char** pp, const char* end) {
  const char* p = *pp;
  uint64_t v = 0;
  while (p < end) {
    char c = *p;
    uint32_t d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
    else break;
    v = (v << 4) | d;
    ++p;
  }
  *pp = p;
  return static_cast<int32_t>(v & 0x7FFFFFFF);
}

inline void skip_field(const char** pp, const char* end, char sep) {
  const char* p = *pp;
  while (p < end && *p != sep && *p != '\n') ++p;
  *pp = p;
}

}  // namespace

extern "C" {

// Criteo TSV: label \t d1..d13 \t c1..c26(hex). Missing fields parse as 0
// (empty string between tabs), short records are zero-padded — matching the
// Python parser in model_zoo/deepfm/deepfm.py exactly.
//
// labels: int32[n]; dense: float32[n*num_dense]; cat: int32[n*num_cat].
// Returns 0 on success (this parser never fails: malformed bytes degrade to
// zeros, same as the Python twin's `errors="replace"` stance).
int edl_parse_criteo(const char* buf, const int64_t* offsets, int64_t n,
                     int num_dense, int num_cat, int32_t* labels,
                     float* dense, int32_t* cat) {
  for (int64_t i = 0; i < n; ++i) {
    const char* p = buf + offsets[i];
    const char* end = buf + offsets[i + 1];
    while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;

    labels[i] = static_cast<int32_t>(parse_int(&p, end));
    skip_field(&p, end, '\t');

    float* drow = dense + i * num_dense;
    for (int f = 0; f < num_dense; ++f) {
      drow[f] = 0.0f;
      if (p < end && *p == '\t') {
        ++p;
        drow[f] = parse_float(&p, end);
        skip_field(&p, end, '\t');
      }
    }
    int32_t* crow = cat + i * num_cat;
    for (int f = 0; f < num_cat; ++f) {
      crow[f] = 0;
      if (p < end && *p == '\t') {
        ++p;
        crow[f] = parse_hex(&p, end);
        skip_field(&p, end, '\t');
      }
    }
  }
  return 0;
}

// Delimiter-separated numeric table (CSV/TSV of floats): parses `num_cols`
// float fields per record into out[n, num_cols]; `label_col` (if >= 0) is
// copied to labels as int32 and excluded from out when exclude_label != 0.
// Used by CSV-style tabular configs to skip per-field Python parsing.
int edl_parse_numeric(const char* buf, const int64_t* offsets, int64_t n,
                      char sep, int num_cols, int label_col,
                      int exclude_label, int32_t* labels, float* out) {
  int out_cols = num_cols - (exclude_label && label_col >= 0 ? 1 : 0);
  for (int64_t i = 0; i < n; ++i) {
    const char* p = buf + offsets[i];
    const char* end = buf + offsets[i + 1];
    while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
    float* row = out + i * out_cols;
    int oc = 0;
    for (int c = 0; c < num_cols; ++c) {
      float v = parse_float(&p, end);
      if (c == label_col) {
        if (labels) labels[i] = static_cast<int32_t>(v);
        if (!exclude_label) row[oc++] = v;
      } else {
        row[oc++] = v;
      }
      skip_field(&p, end, sep);
      if (p < end && *p == sep) ++p;
    }
  }
  return 0;
}

// Fixed-width binary records (the synthetic mnist/cifar layout: 1 label byte
// + w uint8 payload): fan out to labels int32[n] and float32[n*w] scaled by
// `scale` (e.g. 1/255). Avoids n numpy frombuffer calls.
int edl_parse_u8_image(const char* buf, const int64_t* offsets, int64_t n,
                       int width, float scale, int32_t* labels, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const unsigned char* p =
        reinterpret_cast<const unsigned char*>(buf + offsets[i]);
    int64_t len = offsets[i + 1] - offsets[i];
    if (len < 1 + width) return -1;
    labels[i] = p[0];
    float* row = out + i * static_cast<int64_t>(width);
    const unsigned char* px = p + 1;
    for (int j = 0; j < width; ++j) row[j] = px[j] * scale;
  }
  return 0;
}

}  // extern "C"
