// Native extended-XYZ row parser.
//
// Counterpart of gpumd_tpu/native/xyz_native.cpp, the analog of the
// reference's host-side C++ model reader (ref: src/model/read_xyz.cu:
// 163-330): the Python front end parses the
// two header lines (count + Properties spec) and delegates the O(N)
// token work — the actual hot loop at million-atom model files — to
// this translation unit via ctypes.  No Python object churn per token.
//
// Build: g++ -O3 -shared -fPIC xyz_native.cpp -o libxyz_native.so
// (driven lazily by gpumd_tpu_torch/native/__init__.py, which raises if
// the build fails).

#include <cstdlib>
#include <cstring>

namespace {

// skip whitespace, return pointer to next token start (or end)
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

inline const char* token_end(const char* p, const char* end) {
  while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
    ++p;
  return p;
}

} // namespace

extern "C" {

// Parse `n_rows` whitespace-separated rows of `n_cols` columns from a
// caller-held buffer.  The column `species_col` (or -1) is copied as a
// NUL-padded 15-char string into species_out (n_rows * 16 bytes); every
// other column is strtod'd into numeric_out row-major
// (n_rows * (n_cols - has_species)).
// Returns the number of rows parsed (== n_rows on success) or -1.
long xyz_parse_mem(const char* buf, long len, long n_rows, int n_cols,
                   int species_col, char* species_out, double* numeric_out) {
  const char* p = buf;
  const char* end = buf + len;
  long ni = 0;
  for (long r = 0; r < n_rows; ++r) {
    for (int c = 0; c < n_cols; ++c) {
      p = skip_ws(p, end);
      if (p >= end) return -1;
      const char* te = token_end(p, end);
      if (c == species_col) {
        long l = te - p;
        if (l > 15) l = 15;
        char* dst = species_out + r * 16;
        memcpy(dst, p, l);
        memset(dst + l, 0, 16 - l);
      } else {
        char* endp = nullptr;
        numeric_out[ni++] = strtod(p, &endp);
        if (endp == p) return -1;
      }
      p = te;
    }
  }
  return n_rows;
}

} // extern "C"
