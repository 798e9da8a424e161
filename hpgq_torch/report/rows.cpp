// The report writer's per-position files: one line format applied to each
// row of a few columns, as C printf would print them.
//
// Built on first use with the packer's g++ flags (hpgq_torch/io/native) and
// bound by rows.py.  A line format holds literal text and three conversions,
// each taking the next column:
//   %i     an int64 column, printed as printf's %i;
//   %c     an int64 column, printed as the byte of its low 8 bits;
//   %0.2f  a double column, printed as glibc's %0.2f: correctly rounded
//          (ties to even on the exact binary value), "nan"/"-nan" and
//          "inf"/"-inf" by the sign bit.
// %0.2f rounds the exact product of the value and 100 in 64-bit integers;
// a value of 1e15 or more goes to glibc's snprintf.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Kind { LIT, INT, CHR, F2 };

struct Part {
  Kind kind;
  std::string text;  // LIT only
};

bool parse(const char* fmt, std::vector<Part>& parts) {
  std::string lit;
  for (const char* p = fmt; *p; ++p) {
    if (*p != '%') {
      lit += *p;
      continue;
    }
    if (!lit.empty()) parts.push_back({LIT, lit});
    lit.clear();
    if (p[1] == 'i') {
      parts.push_back({INT, ""});
      p += 1;
    } else if (p[1] == 'c') {
      parts.push_back({CHR, ""});
      p += 1;
    } else if (std::strncmp(p + 1, "0.2f", 4) == 0) {
      parts.push_back({F2, ""});
      p += 4;
    } else {
      return false;
    }
  }
  if (!lit.empty()) parts.push_back({LIT, lit});
  return true;
}

char* put_u64(char* o, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *o++ = tmp[--n];
  return o;
}

char* put_i64(char* o, int64_t v) {
  if (v < 0) {
    *o++ = '-';
    return put_u64(o, 0 - static_cast<uint64_t>(v));
  }
  return put_u64(o, static_cast<uint64_t>(v));
}

// %0.2f of x into o, which has room for 400 bytes
char* put_f2(char* o, double x) {
  if (std::isnan(x)) {
    if (std::signbit(x)) *o++ = '-';
    std::memcpy(o, "nan", 3);
    return o + 3;
  }
  if (std::isinf(x)) {
    if (std::signbit(x)) *o++ = '-';
    std::memcpy(o, "inf", 3);
    return o + 3;
  }
  if (std::fabs(x) >= 1e15) return o + std::snprintf(o, 400, "%0.2f", x);
  // |x| = m * 2^e exactly, so 100 |x| = (100 m) * 2^e with 100 m < 2^60:
  // shift it to a whole number, rounding to nearest, ties to even
  uint64_t bits;
  std::memcpy(&bits, &x, sizeof bits);
  const int biased = static_cast<int>(bits >> 52 & 0x7FF);
  uint64_t m = bits & ((uint64_t(1) << 52) - 1);
  int e = -1074;
  if (biased) {
    m |= uint64_t(1) << 52;
    e = biased - 1075;
  }
  m *= 100;
  uint64_t v;
  if (e >= 0) {
    v = m << e;  // |x| < 1e15: fits
  } else if (e <= -61) {
    v = 0;  // 100 m < 2^60 <= half a unit
  } else {
    const int s = -e;
    v = m >> s;
    const uint64_t rem = m & ((uint64_t(1) << s) - 1);
    const uint64_t half = uint64_t(1) << (s - 1);
    v += rem > half || (rem == half && (v & 1));
  }
  if (std::signbit(x)) *o++ = '-';
  o = put_u64(o, v / 100);
  *o++ = '.';
  *o++ = static_cast<char>('0' + v / 10 % 10);
  *o++ = static_cast<char>('0' + v % 10);
  return o;
}

}  // namespace

extern "C" {

int hpgq_rows_abi_version() { return 1; }

// Format `nrows` rows of `fmt` (conversions as above, one column each, in
// order: `cols[j]` points at the j-th conversion's column) into `out`.
// Returns the bytes written; -1 when `fmt` holds another conversion or its
// conversions are not `ncols`, -2 when the text would pass `cap` bytes.
int64_t hpgq_format_rows(const char* fmt, int64_t nrows, const void* const* cols,
                         int ncols, char* out, int64_t cap) {
  std::vector<Part> parts;
  if (!parse(fmt, parts)) return -1;
  int nconv = 0;
  for (const Part& p : parts) nconv += p.kind != LIT;
  if (nconv != ncols) return -1;
  char* o = out;
  char* end = out + cap;
  for (int64_t r = 0; r < nrows; ++r) {
    int j = 0;
    for (const Part& p : parts) {
      if (end - o < static_cast<int64_t>(p.text.size()) + 400) return -2;
      switch (p.kind) {
        case LIT:
          std::memcpy(o, p.text.data(), p.text.size());
          o += p.text.size();
          break;
        case INT:
          o = put_i64(o, static_cast<const int64_t*>(cols[j++])[r]);
          break;
        case CHR:
          *o++ = static_cast<char>(static_cast<const int64_t*>(cols[j++])[r] & 0xFF);
          break;
        case F2:
          o = put_f2(o, static_cast<const double*>(cols[j++])[r]);
          break;
      }
    }
  }
  return o - out;
}

}  // extern "C"
