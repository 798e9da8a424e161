// Streaming gzip reader (RFC 1952) over a DEFLATE decoder (RFC 1951),
// written for the port's read layer: one call fills the caller's buffer
// with up to n bytes of text, and the 32 KB history carries from one call to
// the next, so memory is the caller's buffer plus this handle (a 256 KB
// input buffer, the history and the decode tables).
//
// The decoder follows the design of libdeflate's: a 64-bit bit buffer
// refilled eight bytes at a time without branches while enough input
// remains; literal/length and distance tables with one primary lookup (11
// and 8 bits) plus subtables, each entry packing the symbol or base, the
// extra-bit count and the code length; a fast loop that decodes up to three
// literals per refill; match copies a word at a time into slack past the
// match, with offsets under 8 written as a repeated 8-byte pattern.  Near
// the end of the input or of the caller's buffer a careful loop decodes one
// symbol at a time, may stop inside a match, and feeds zero bits past the
// end of the file, counted, so that a symbol that needs them reads as a
// truncation and not as bad data.
//
// Integrity is gzip.GzipFile's: every header flag, several members one
// after another, zero padding after the last, each member's CRC-32 (folded
// with PCLMULQDQ where the compiler targets it, slice-by-8 otherwise) and
// ISIZE checked.  Errors carry the class gzip.GzipFile raises on the same
// bytes (EOFError, gzip.BadGzipFile, zlib.error, OSError) and zlib's or
// gzip's message; bytes decoded before an error are returned first, and
// the error at the next call, as gzip does.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -march=native inflate.cpp
// (hpgq_torch.io.native.inflate builds and loads it).

#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <new>
#include <unistd.h>

#if defined(__PCLMUL__) && defined(__SSE4_1__)
#include <immintrin.h>
#define HPGQ_CRC_FOLD 1
#endif

namespace {

constexpr int kAbi = 1;

// error classes, as hpgq_gz_read returns them (negated) to Python
enum : int {
    E_EOF = 1,      // EOFError: the input ended inside a member
    E_BADGZIP = 2,  // gzip.BadGzipFile: header, CRC or length
    E_ZLIB = 3,     // zlib.error: invalid DEFLATE data
    E_OS = 4,       // OSError: the file's read failed
};

// ---------------------------------------------------------------- CRC-32

struct CrcTables {
    uint32_t t[8][256];
    CrcTables() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0xEDB88320u : c >> 1;
            t[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; ++i)
            for (int s = 1; s < 8; ++s)
                t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
    }
};
const CrcTables kCrc;

// CRC of the bytes with the register not inverted on entry or exit
uint32_t crc_bytes(uint32_t c, const uint8_t* p, size_t n) {
    while (n >= 8) {
        uint64_t v;
        memcpy(&v, p, 8);
        v ^= c;
        c = kCrc.t[7][v & 0xff] ^ kCrc.t[6][(v >> 8) & 0xff] ^
            kCrc.t[5][(v >> 16) & 0xff] ^ kCrc.t[4][(v >> 24) & 0xff] ^
            kCrc.t[3][(v >> 32) & 0xff] ^ kCrc.t[2][(v >> 40) & 0xff] ^
            kCrc.t[1][(v >> 48) & 0xff] ^ kCrc.t[0][v >> 56];
        p += 8;
        n -= 8;
    }
    while (n--) c = kCrc.t[0][(c ^ *p++) & 0xff] ^ (c >> 8);
    return c;
}

#ifdef HPGQ_CRC_FOLD
// Carry-less folding of 64-byte lines, then a Barrett reduction (Intel,
// "Fast CRC Computation for Generic Polynomials Using PCLMULQDQ"; the
// constants are those of the reflected polynomial 0xEDB88320).  n >= 64
// and a multiple of 16; the register is not inverted.
uint32_t crc_fold(uint32_t c, const uint8_t* p, size_t n) {
    const __m128i k1k2 = _mm_set_epi64x(0x1c6e41596LL, 0x154442bd4LL);
    const __m128i k3k4 = _mm_set_epi64x(0x0ccaa009eLL, 0x1751997d0LL);
    const __m128i k5 = _mm_set_epi64x(0, 0x163cd6124LL);
    const __m128i poly = _mm_set_epi64x(0x1F7011641LL, 0x1DB710641LL);
    const __m128i mask32 = _mm_set_epi32(0, 0, 0, -1);
    auto ld = [](const uint8_t* q) {
        return _mm_loadu_si128(reinterpret_cast<const __m128i*>(q));
    };
    auto fold = [](__m128i x, __m128i k, __m128i next) {
        __m128i lo = _mm_clmulepi64_si128(x, k, 0x00);
        __m128i hi = _mm_clmulepi64_si128(x, k, 0x11);
        return _mm_xor_si128(_mm_xor_si128(lo, hi), next);
    };
    __m128i x1 = _mm_xor_si128(ld(p), _mm_cvtsi32_si128(static_cast<int>(c)));
    __m128i x2 = ld(p + 16), x3 = ld(p + 32), x4 = ld(p + 48);
    p += 64;
    n -= 64;
    while (n >= 64) {
        x1 = fold(x1, k1k2, ld(p));
        x2 = fold(x2, k1k2, ld(p + 16));
        x3 = fold(x3, k1k2, ld(p + 32));
        x4 = fold(x4, k1k2, ld(p + 48));
        p += 64;
        n -= 64;
    }
    x1 = fold(x1, k3k4, x2);
    x1 = fold(x1, k3k4, x3);
    x1 = fold(x1, k3k4, x4);
    while (n >= 16) {
        x1 = fold(x1, k3k4, ld(p));
        p += 16;
        n -= 16;
    }
    // 128 -> 64 bits, then 64 -> 32, then the reduction
    __m128i t = _mm_clmulepi64_si128(x1, k3k4, 0x10);
    x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), t);
    __m128i x2b = _mm_srli_si128(x1, 4);
    x1 = _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), k5, 0x00);
    x1 = _mm_xor_si128(x1, x2b);
    x2b = x1;
    x1 = _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), poly, 0x10);
    x1 = _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), poly, 0x00);
    x1 = _mm_xor_si128(x1, x2b);
    return static_cast<uint32_t>(_mm_extract_epi32(x1, 1));
}
#endif

// gzip's CRC-32 of p[0..n) continued from crc (zlib.crc32's convention)
uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
    uint32_t c = ~crc;
#ifdef HPGQ_CRC_FOLD
    if (n >= 64) {
        size_t m = n & ~static_cast<size_t>(15);
        c = crc_fold(c, p, m);
        p += m;
        n -= m;
    }
#endif
    return ~crc_bytes(c, p, n);
}

// ---------------------------------------------------------------- tables

// A decode table entry (32 bits):
//   [5:0]   bits consumed: the codeword's (at this table level) plus the
//           extra bits of a length or distance; a subtable pointer's is the
//           primary table's bits
//   [11:6]  the codeword's bits, where the extra bits start; a subtable
//           pointer's is the subtable's index bits
//   [15:12] flags
//   [31:16] literal byte, length or distance base, or subtable offset
constexpr uint32_t F_LIT = 1u << 12;  // a literal
constexpr uint32_t F_EXC = 1u << 13;  // not a literal nor a length/distance
constexpr uint32_t F_SUB = 1u << 14;  // with F_EXC: a subtable pointer
constexpr uint32_t F_EOB = 1u << 15;  // with F_EXC: end of block
// F_EXC alone: a symbol the format does not allow (invalid code)

constexpr unsigned LITLEN_BITS = 11, DIST_BITS = 8, PRE_BITS = 7;
constexpr unsigned NUM_LITLEN = 288, NUM_DIST = 32, NUM_PRE = 19;
// primary table plus the most subtable entries any code could need
constexpr unsigned LITLEN_CAP = (1u << LITLEN_BITS) + NUM_LITLEN * 16;
constexpr unsigned DIST_CAP = (1u << DIST_BITS) + NUM_DIST * 128;

inline uint32_t entry(uint32_t value, unsigned total, unsigned cw, uint32_t flags) {
    return value << 16 | flags | cw << 6 | total;
}
inline unsigned ent_bits(uint32_t e) { return e & 63; }
inline unsigned ent_cw(uint32_t e) { return (e >> 6) & 63; }

inline uint64_t low_bits(uint64_t v, unsigned n) { return v & ((1ull << n) - 1); }
// a length's or distance's extra bits, from the bit buffer before the entry
inline uint32_t ent_extra(uint64_t saved, uint32_t e) {
    return static_cast<uint32_t>(low_bits(saved, ent_bits(e)) >> ent_cw(e));
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                                17,   25,   33,   49,   65,   97,    129,   193,
                                257,  385,  513,  769,  1025, 1537,  2049,  3073,
                                4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kNameFlags[2] = {8, 16};
// the byte of the last d that each of 8 bytes repeats, and the step that
// keeps an 8-byte pattern in phase, for a match distance d under 8
const uint8_t kPatIdx[8][8] = {{0, 0, 0, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 0, 0, 0},
                               {0, 1, 0, 1, 0, 1, 0, 1}, {0, 1, 2, 0, 1, 2, 0, 1},
                               {0, 1, 2, 3, 0, 1, 2, 3}, {0, 1, 2, 3, 4, 0, 1, 2},
                               {0, 1, 2, 3, 4, 5, 0, 1}, {0, 1, 2, 3, 4, 5, 6, 0}};
const uint8_t kPatStep[8] = {8, 8, 8, 6, 8, 5, 6, 7};
const uint8_t kPreOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                               11, 4, 12, 3, 13, 2, 14, 1, 15};

enum Kind { K_PRE, K_LITLEN, K_DIST };

// The entry of symbol s of a code of this kind, its codeword cw bits long.
uint32_t symbol_entry(Kind kind, unsigned s, unsigned cw) {
    if (kind == K_PRE) return entry(s, cw, cw, 0);
    if (kind == K_LITLEN) {
        if (s < 256) return entry(s, cw, cw, F_LIT);
        if (s == 256) return entry(0, cw, cw, F_EXC | F_EOB);
        if (s < 286) return entry(kLenBase[s - 257], cw + kLenExtra[s - 257], cw, 0);
        return entry(0, cw, cw, F_EXC);
    }
    if (s < 30) return entry(kDistBase[s], cw + kDistExtra[s], cw, 0);
    return entry(0, cw, cw, F_EXC);
}

// Build the decode table of a canonical code from its code lengths, with
// zlib's rules: an over-subscribed set fails; an incomplete set fails
// unless it is empty or one codeword of length 1 (not for the precode);
// entries that no codeword reaches decode as invalid.
bool build_table(uint32_t* table, unsigned cap, const uint8_t* lens,
                 unsigned nsyms, unsigned tb, Kind kind) {
    unsigned count[16] = {0};
    for (unsigned s = 0; s < nsyms; ++s) count[lens[s]]++;
    count[0] = 0;
    unsigned maxlen = 0;
    for (unsigned l = 15; l >= 1; --l)
        if (count[l]) { maxlen = l; break; }
    int left = 1;
    for (unsigned l = 1; l <= 15; ++l) {
        left <<= 1;
        left -= static_cast<int>(count[l]);
        if (left < 0) return false;
    }
    const uint32_t invalid = entry(0, 1, 1, F_EXC);
    const unsigned size = 1u << tb;
    for (unsigned i = 0; i < size; ++i) table[i] = invalid;
    if (maxlen == 0) return kind != K_PRE;
    if (left > 0 && (kind == K_PRE || maxlen != 1)) return false;

    unsigned offs[16];
    offs[1] = 0;
    for (unsigned l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    uint16_t sorted[NUM_LITLEN];
    for (unsigned s = 0; s < nsyms; ++s)
        if (lens[s]) sorted[offs[lens[s]]++] = static_cast<uint16_t>(s);

    unsigned rem[16];
    memcpy(rem, count, sizeof(rem));
    unsigned code = 0, k = 0, next_sub = size;
    unsigned cur_prefix = ~0u, sub_start = 0, sub_bits = 0;
    for (unsigned len = 1; len <= maxlen; ++len, code <<= 1) {
        for (unsigned c = 0; c < count[len]; ++c, ++k, ++code) {
            const unsigned s = sorted[k];
            unsigned rev = 0;
            for (unsigned b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
            if (len <= tb) {
                const uint32_t e = symbol_entry(kind, s, len);
                for (unsigned i = rev; i < size; i += 1u << len) table[i] = e;
            } else {
                const unsigned prefix = rev & (size - 1);
                if (prefix != cur_prefix) {
                    // the subtable holds every codeword under this prefix:
                    // grow it until the codewords left fill it (zlib's rule)
                    unsigned cur = len - tb;
                    int room = 1 << cur;
                    while (cur + tb < maxlen) {
                        room -= static_cast<int>(rem[cur + tb]);
                        if (room <= 0) break;
                        ++cur;
                        room <<= 1;
                    }
                    sub_bits = cur;
                    sub_start = next_sub;
                    next_sub += 1u << sub_bits;
                    if (next_sub > cap) return false;
                    for (unsigned i = sub_start; i < next_sub; ++i) table[i] = invalid;
                    table[prefix] = entry(sub_start, tb, sub_bits, F_EXC | F_SUB);
                    cur_prefix = prefix;
                }
                const unsigned sl = len - tb;
                const uint32_t e = symbol_entry(kind, s, sl);
                for (unsigned i = rev >> tb; i < (1u << sub_bits); i += 1u << sl)
                    table[sub_start + i] = e;
            }
            rem[len]--;
        }
    }
    return true;
}

// ---------------------------------------------------------------- decoder

inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}
inline void store64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }

constexpr size_t IN_CAP = 256 * 1024;  // input buffer
constexpr size_t IN_SLACK = 64;
constexpr size_t IN_KEEP = 8;          // bytes kept behind in_next on a refill
constexpr size_t IN_LOW = 4096;        // top up below this much input
constexpr size_t FAST_IN = 32;         // the fast loop's input margin
constexpr size_t FAST_OUT = 320;       // its output margin: an iteration writes < 2 + 258 + 16
constexpr uint32_t WINDOW = 32768;

enum State { S_HEADER, S_BLOCK, S_HUFF, S_STORED, S_TRAILER, S_DONE };
enum : int { R_GO = 0, R_EOB = -1, R_FULL = -2 };  // besides error codes

struct Gz {
    int fd = -1;
    uint8_t* in_buf = nullptr;
    const uint8_t* in_next = nullptr;
    const uint8_t* in_end = nullptr;
    bool in_eof = false;

    uint64_t bitbuf = 0;
    unsigned bitsleft = 0;
    unsigned overread = 0;  // zero bytes fed past the end of the file

    State state = S_HEADER;
    bool final_block = false;
    uint32_t stored_left = 0;
    uint32_t pend_len = 0, pend_dist = 0;
    bool fixed_loaded = false;

    uint32_t crc = 0;
    uint64_t msize = 0;  // this member's bytes so far
    uint32_t hist_len = 0;

    int err = 0;
    char msg[200] = {0};

    // this call's output
    uint8_t* member_base = nullptr;  // where the member's bytes of this call start
    uint8_t* crc_from = nullptr;     // first byte not yet in crc/msize

    uint8_t hist[WINDOW];
    uint32_t litlen[LITLEN_CAP];
    uint32_t dist[DIST_CAP];
    uint32_t pre[1u << PRE_BITS];

    int fail(int code, const char* m) {
        snprintf(msg, sizeof(msg), "%s", m);
        return code;
    }
    bool past_end() const { return bitsleft < 8u * overread; }
    // bad data, unless the bits that show it lie past the end of the file
    int zerr(const char* m) {
        if (past_end()) return truncated();
        char b[160];
        snprintf(b, sizeof(b), "Error -3 while decompressing data: %s", m);
        return fail(E_ZLIB, b);
    }
    int truncated() {
        return fail(E_EOF, "Compressed file ended before the end-of-stream marker was reached");
    }

    int fill_input() {
        const size_t back = static_cast<size_t>(in_next - in_buf) < IN_KEEP
                                ? static_cast<size_t>(in_next - in_buf)
                                : IN_KEEP;
        const uint8_t* from = in_next - back;
        const size_t have = static_cast<size_t>(in_end - from);
        memmove(in_buf, from, have);
        in_next = in_buf + back;
        uint8_t* end = in_buf + have;
        while (end < in_buf + IN_CAP) {
            const ssize_t r = ::read(fd, end, static_cast<size_t>(in_buf + IN_CAP - end));
            if (r < 0) {
                if (errno == EINTR) continue;
                in_end = end;
                snprintf(msg, sizeof(msg), "%s", strerror(errno));
                return E_OS;
            }
            if (r == 0) {
                in_eof = true;
                break;
            }
            end += r;
        }
        in_end = end;
        return 0;
    }

    // at least 56 bits in bitbuf; zero bytes past the end of the file
    int refill_careful() {
        while (bitsleft < 56) {
            if (in_next == in_end) {
                if (!in_eof) {
                    if (int r = fill_input()) return r;
                    continue;
                }
                bitbuf = low_bits(bitbuf, bitsleft);
                overread++;
            } else {
                bitbuf |= static_cast<uint64_t>(*in_next++) << bitsleft;
            }
            bitsleft += 8;
        }
        return 0;
    }
    uint32_t take(unsigned n) {  // n <= bitsleft
        const uint32_t v = static_cast<uint32_t>(low_bits(bitbuf, n));
        bitbuf >>= n;
        bitsleft -= n;
        return v;
    }
    // to the next byte boundary, handing whole bytes back to the input
    int align() {
        take(bitsleft & 7);
        if (past_end()) return truncated();
        in_next -= bitsleft / 8 - overread;
        bitbuf = 0;
        bitsleft = 0;
        overread = 0;
        return 0;
    }
    int read_byte() {  // -1 at the end of the file (bit buffer empty)
        if (in_next == in_end) {
            if (in_eof) return -1;
            if (int r = fill_input()) return -1000 - r;
            if (in_next == in_end) return -1;
        }
        return *in_next++;
    }
    int read_exact(uint8_t* dst, unsigned n) {
        for (unsigned i = 0; i < n; ++i) {
            const int c = read_byte();
            if (c <= -1000) return -1000 - c;
            if (c < 0) return truncated();
            dst[i] = static_cast<uint8_t>(c);
        }
        return 0;
    }

    // this call's bytes of the member so far into its CRC and size
    void account(uint8_t* out_next) {
        const size_t n = static_cast<size_t>(out_next - crc_from);
        if (n) {
            crc = crc32_update(crc, crc_from, n);
            msize += n;
            crc_from = out_next;
        }
    }

    // ---- gzip framing

    int header(uint8_t* out_next) {
        int c0 = read_byte();
        if (c0 <= -1000) return -1000 - c0;
        if (c0 < 0) {
            state = S_DONE;
            return 0;
        }
        int c1 = read_byte();
        if (c1 <= -1000) return -1000 - c1;
        if (c0 != 0x1f || c1 != 0x8b) {
            char b[64];
            char* w = b + snprintf(b, sizeof(b), "Not a gzipped file (b'");
            const int got[2] = {c0, c1};
            for (int i = 0; i < 2 && got[i] >= 0; ++i) {
                const int ch = got[i];
                if (ch == '\\' || ch == '\'') w += sprintf(w, "\\%c", ch);
                else if (ch == '\t') w += sprintf(w, "\\t");
                else if (ch == '\n') w += sprintf(w, "\\n");
                else if (ch == '\r') w += sprintf(w, "\\r");
                else if (ch >= 32 && ch < 127) *w++ = static_cast<char>(ch);
                else w += sprintf(w, "\\x%02x", ch);
            }
            sprintf(w, "')");
            return fail(E_BADGZIP, b);
        }
        uint8_t h[8];
        if (int r = read_exact(h, 8)) return r;
        if (h[0] != 8) return fail(E_BADGZIP, "Unknown compression method");
        const uint8_t flags = h[1];
        if (flags & 4) {  // FEXTRA
            uint8_t x[2];
            if (int r = read_exact(x, 2)) return r;
            for (unsigned n = x[0] | x[1] << 8u; n; --n) {
                const int c = read_byte();
                if (c <= -1000) return -1000 - c;
                if (c < 0) return truncated();
            }
        }
        for (const uint8_t f : kNameFlags) {  // FNAME, FCOMMENT
            if (!(flags & f)) continue;
            for (;;) {
                const int c = read_byte();
                if (c <= -1000) return -1000 - c;
                if (c <= 0) break;  // gzip stops at the end of the file too
            }
        }
        if (flags & 2) {  // FHCRC, read and not checked, as gzip does
            uint8_t x[2];
            if (int r = read_exact(x, 2)) return r;
        }
        crc = 0;
        msize = 0;
        hist_len = 0;
        member_base = crc_from = out_next;
        final_block = false;
        state = S_BLOCK;
        return 0;
    }

    int trailer(uint8_t* out_next) {
        if (int r = align()) return r;
        account(out_next);
        uint8_t t[8];
        if (int r = read_exact(t, 8)) return r;
        const uint32_t want_crc = t[0] | t[1] << 8 | t[2] << 16 | static_cast<uint32_t>(t[3]) << 24;
        const uint32_t want_size = t[4] | t[5] << 8 | t[6] << 16 | static_cast<uint32_t>(t[7]) << 24;
        if (want_crc != crc) {
            char b[80];
            snprintf(b, sizeof(b), "CRC check failed 0x%x != 0x%x", want_crc, crc);
            return fail(E_BADGZIP, b);
        }
        if (want_size != static_cast<uint32_t>(msize))
            return fail(E_BADGZIP, "Incorrect length of data produced");
        int c;
        while ((c = read_byte()) == 0) {
        }
        if (c <= -1000) return -1000 - c;
        if (c > 0) in_next--;
        state = S_HEADER;
        return 0;
    }

    // ---- block headers

    int block_header() {
        if (!in_eof && static_cast<size_t>(in_end - in_next) < 2048)
            if (int r = fill_input()) return r;
        if (int r = refill_careful()) return r;
        const uint32_t h = take(3);
        if (past_end()) return truncated();
        final_block = h & 1;
        switch (h >> 1) {
        case 0: {
            if (int r = align()) return r;
            uint8_t l[4];
            if (int r = read_exact(l, 4)) return r;
            const unsigned len = l[0] | l[1] << 8, nlen = l[2] | l[3] << 8;
            if (len != (~nlen & 0xffffu)) return zerr("invalid stored block lengths");
            stored_left = len;
            state = S_STORED;
            return 0;
        }
        case 1:
            if (!fixed_loaded) {
                uint8_t lens[NUM_LITLEN + NUM_DIST];
                unsigned i = 0;
                for (; i < 144; ++i) lens[i] = 8;
                for (; i < 256; ++i) lens[i] = 9;
                for (; i < 280; ++i) lens[i] = 7;
                for (; i < 288; ++i) lens[i] = 8;
                for (; i < 320; ++i) lens[i] = 5;
                build_table(litlen, LITLEN_CAP, lens, NUM_LITLEN, LITLEN_BITS, K_LITLEN);
                build_table(dist, DIST_CAP, lens + NUM_LITLEN, NUM_DIST, DIST_BITS, K_DIST);
                fixed_loaded = true;
            }
            state = S_HUFF;
            return 0;
        case 2:
            fixed_loaded = false;
            if (int r = dynamic_header()) return r;
            state = S_HUFF;
            return 0;
        default:
            return zerr("invalid block type");
        }
    }

    int dynamic_header() {
        if (int r = refill_careful()) return r;
        const unsigned nlen = take(5) + 257, ndist = take(5) + 1, ncode = take(4) + 4;
        if (past_end()) return truncated();
        if (nlen > 286 || ndist > 30) return zerr("too many length or distance symbols");
        uint8_t prelens[NUM_PRE] = {0};
        for (unsigned i = 0; i < ncode; ++i) {
            if (int r = refill_careful()) return r;
            prelens[kPreOrder[i]] = static_cast<uint8_t>(take(3));
        }
        if (past_end()) return truncated();
        if (!build_table(pre, 1u << PRE_BITS, prelens, NUM_PRE, PRE_BITS, K_PRE))
            return zerr("invalid code lengths set");
        uint8_t lens[NUM_LITLEN + NUM_DIST];
        const unsigned n = nlen + ndist;
        for (unsigned i = 0; i < n;) {
            if (int r = refill_careful()) return r;
            const uint32_t e = pre[low_bits(bitbuf, PRE_BITS)];
            take(ent_bits(e));
            const unsigned sym = e >> 16;
            if (sym < 16) {
                if (past_end()) return truncated();
                lens[i++] = static_cast<uint8_t>(sym);
                continue;
            }
            unsigned rep;
            uint8_t val = 0;
            if (sym == 16) {
                rep = 3 + take(2);
                if (past_end()) return truncated();
                if (i == 0) return zerr("invalid bit length repeat");
                val = lens[i - 1];
            } else if (sym == 17) {
                rep = 3 + take(3);
            } else {
                rep = 11 + take(7);
            }
            if (past_end()) return truncated();
            if (i + rep > n) return zerr("invalid bit length repeat");
            memset(lens + i, val, rep);
            i += rep;
        }
        if (lens[256] == 0) return zerr("invalid code -- missing end-of-block");
        if (!build_table(litlen, LITLEN_CAP, lens, nlen, LITLEN_BITS, K_LITLEN))
            return zerr("invalid literal/lengths set");
        if (!build_table(dist, DIST_CAP, lens + nlen, ndist, DIST_BITS, K_DIST))
            return zerr("invalid distances set");
        return 0;
    }

    // ---- Huffman blocks

    // a match's bytes one at a time, reaching into the history before this
    // call's output; at most what the output holds
    uint32_t copy_slow(uint8_t* dst, uint8_t* out_end, uint32_t d, uint32_t len) {
        const size_t room = static_cast<size_t>(out_end - dst);
        const uint32_t n = len < room ? len : static_cast<uint32_t>(room);
        for (uint32_t i = 0; i < n; ++i) {
            const ptrdiff_t src = (dst + i - member_base) - static_cast<ptrdiff_t>(d);
            dst[i] = src >= 0 ? member_base[src] : hist[static_cast<ptrdiff_t>(hist_len) + src];
        }
        return n;
    }
    bool too_far(uint8_t* out_next, uint32_t d) const {
        return d > static_cast<size_t>(out_next - member_base) + hist_len;
    }

    // one symbol, careful of both ends
    int careful_symbol(uint8_t*& out_next, uint8_t* out_end) {
        if (int r = refill_careful()) return r;
        uint32_t e = litlen[low_bits(bitbuf, LITLEN_BITS)];
        if (e & F_SUB) {
            take(LITLEN_BITS);
            e = litlen[(e >> 16) + low_bits(bitbuf, ent_cw(e))];
        }
        uint32_t extra = ent_extra(bitbuf, e);
        take(ent_bits(e));
        if (past_end()) return truncated();
        if (e & F_LIT) {
            *out_next++ = static_cast<uint8_t>(e >> 16);
            return R_GO;
        }
        if (e & F_EXC) return (e & F_EOB) ? R_EOB : zerr("invalid literal/length code");
        const uint32_t len = (e >> 16) + extra;
        if (int r = refill_careful()) return r;
        e = dist[low_bits(bitbuf, DIST_BITS)];
        if (e & F_SUB) {
            take(DIST_BITS);
            e = dist[(e >> 16) + low_bits(bitbuf, ent_cw(e))];
        }
        extra = ent_extra(bitbuf, e);
        take(ent_bits(e));
        if (past_end()) return truncated();
        if (e & F_EXC) return zerr("invalid distance code");
        const uint32_t d = (e >> 16) + extra;
        if (too_far(out_next, d)) return zerr("invalid distance too far back");
        const uint32_t done = copy_slow(out_next, out_end, d, len);
        out_next += done;
        if (done < len) {
            pend_len = len - done;
            pend_dist = d;
            return R_FULL;
        }
        return R_GO;
    }

    // The fast loop, while at least FAST_IN bytes of input and FAST_OUT of
    // output remain: R_GO at either margin, R_EOB, or an error.  Between
    // refills the bit buffer holds 56 bits, enough for three literals, or
    // two and a length, before the next entry is looked up; each
    // iteration looks up the next literal/length entry before its match is
    // copied, so the copy overlaps the lookup.
    int fast(uint8_t*& out_next_ref, uint8_t* const out_end) {
        const uint8_t* in = in_next;
        if (static_cast<size_t>(in_end - in) <= FAST_IN ||
            static_cast<size_t>(out_end - out_next_ref) <= FAST_OUT)
            return R_GO;
        const uint8_t* const in_fast = in_end - FAST_IN;
        uint8_t* const out_fast = out_end - FAST_OUT;
        uint8_t* out_next = out_next_ref;
        uint8_t* const base = member_base;
        const uint32_t* const lt = litlen;
        const uint32_t* const dt = dist;
        constexpr uint64_t LM = (1u << LITLEN_BITS) - 1, DM = (1u << DIST_BITS) - 1;
        uint64_t bb = bitbuf;
        unsigned bl = bitsleft;
        int status = R_GO;
        const char* bad = nullptr;
#define HPGQ_REFILL()                \
    do {                             \
        bb |= load64(in) << bl;      \
        in += (63 - bl) >> 3;        \
        bl |= 56;                    \
    } while (0)
#define HPGQ_CONSUME(e)              \
    do {                             \
        bb >>= ent_bits(e);          \
        bl -= ent_bits(e);           \
    } while (0)
        HPGQ_REFILL();
        uint32_t e = lt[bb & LM];
        do {
            uint64_t saved = bb;
            HPGQ_CONSUME(e);
            if (e & F_LIT) {
                uint8_t lit = static_cast<uint8_t>(e >> 16);
                e = lt[bb & LM];
                saved = bb;
                HPGQ_CONSUME(e);
                *out_next++ = lit;
                if (e & F_LIT) {
                    lit = static_cast<uint8_t>(e >> 16);
                    e = lt[bb & LM];
                    saved = bb;
                    HPGQ_CONSUME(e);
                    *out_next++ = lit;
                    if (e & F_LIT) {
                        lit = static_cast<uint8_t>(e >> 16);
                        e = lt[bb & LM];
                        HPGQ_REFILL();
                        *out_next++ = lit;
                        continue;
                    }
                }
            }
            if (e & F_EXC) {
                if (!(e & F_SUB)) {
                    if (e & F_EOB) status = R_EOB;
                    else bad = "invalid literal/length code";
                    break;
                }
                e = lt[(e >> 16) + low_bits(bb, ent_cw(e))];
                saved = bb;
                HPGQ_CONSUME(e);
                if (e & F_LIT) {
                    const uint8_t lit = static_cast<uint8_t>(e >> 16);
                    e = lt[bb & LM];
                    HPGQ_REFILL();
                    *out_next++ = lit;
                    continue;
                }
                if (e & F_EXC) {
                    if (e & F_EOB) status = R_EOB;
                    else bad = "invalid literal/length code";
                    break;
                }
            }
            const uint32_t len = (e >> 16) + ent_extra(saved, e);
            e = dt[bb & DM];
            if (bl < 39) HPGQ_REFILL();  // the distance (28) and a lookup (11)
            if (e & F_EXC) {
                if (!(e & F_SUB)) {
                    bad = "invalid distance code";
                    break;
                }
                HPGQ_CONSUME(e);
                e = dt[(e >> 16) + low_bits(bb, ent_cw(e))];
                if (e & F_EXC) {
                    bad = "invalid distance code";
                    break;
                }
            }
            saved = bb;
            HPGQ_CONSUME(e);
            const uint32_t d = (e >> 16) + ent_extra(saved, e);
            uint8_t* dst = out_next;
            e = lt[bb & LM];
            HPGQ_REFILL();
            if (d > static_cast<size_t>(dst - base)) {
                if (too_far(dst, d)) {
                    bad = "invalid distance too far back";
                    break;
                }
                out_next += copy_slow(dst, out_end, d, len);
                continue;
            }
            out_next += len;
            const uint8_t* src = dst - d;
            if (d >= 16) {
                copy16(dst, src);
                copy16(dst + 16, src + 16);
                for (dst += 32, src += 32; dst < out_next; dst += 16, src += 16) copy16(dst, src);
            } else if (d >= 8) {
                store64(dst, load64(src));
                store64(dst + 8, load64(src + 8));
                for (dst += 16, src += 16; dst < out_next; dst += 8, src += 8)
                    store64(dst, load64(src));
            } else {
                // a period under 8: repeat one 8-byte pattern, stepping by
                // the largest multiple of d within 8
                uint64_t v;
                if (d == 1) {
                    v = 0x0101010101010101ull * src[0];
                } else {
                    uint8_t pat[8];
                    for (unsigned i = 0; i < 8; ++i) pat[i] = src[kPatIdx[d][i]];
                    v = load64(pat);
                }
                const unsigned step = kPatStep[d];
                do {
                    store64(dst, v);
                    dst += step;
                } while (dst < out_next);
            }
        } while (in < in_fast && out_next < out_fast);
#undef HPGQ_REFILL
#undef HPGQ_CONSUME
        in_next = in;
        bitbuf = bb;
        bitsleft = bl;
        out_next_ref = out_next;
        return bad ? zerr(bad) : status;
    }

    int huffman(uint8_t*& out_next, uint8_t* const out_end) {
        if (pend_len) {  // a match cut at the end of the last call's output
            const uint32_t done = copy_slow(out_next, out_end, pend_dist, pend_len);
            out_next += done;
            pend_len -= done;
            if (pend_len) return R_FULL;
        }
        for (;;) {
            if (!in_eof && static_cast<size_t>(in_end - in_next) < IN_LOW)
                if (int r = fill_input()) return r;
            if (int r = fast(out_next, out_end)) return r;
            if (out_next >= out_end) return R_FULL;
            if (int r = careful_symbol(out_next, out_end)) return r;
        }
    }

    static inline void copy16(uint8_t* dst, const uint8_t* src) {
        uint64_t a, b;
        memcpy(&a, src, 8);
        memcpy(&b, src + 8, 8);
        memcpy(dst, &a, 8);
        memcpy(dst + 8, &b, 8);
    }

    int stored(uint8_t*& out_next, uint8_t* out_end) {
        while (stored_left && out_next < out_end) {
            if (in_next == in_end) {
                if (!in_eof)
                    if (int r = fill_input()) return r;
                if (in_next == in_end) return truncated();
            }
            size_t n = stored_left;
            if (n > static_cast<size_t>(out_end - out_next)) n = static_cast<size_t>(out_end - out_next);
            if (n > static_cast<size_t>(in_end - in_next)) n = static_cast<size_t>(in_end - in_next);
            memcpy(out_next, in_next, n);
            out_next += n;
            in_next += n;
            stored_left -= static_cast<uint32_t>(n);
        }
        return stored_left ? R_FULL : R_EOB;
    }

    // the member's last 32 KB of output, for the next call's matches
    void keep_history(uint8_t* out_next) {
        const size_t n = static_cast<size_t>(out_next - member_base);
        if (n >= WINDOW) {
            memcpy(hist, out_next - WINDOW, WINDOW);
            hist_len = WINDOW;
            return;
        }
        uint32_t keep = hist_len;
        if (keep > WINDOW - n) keep = static_cast<uint32_t>(WINDOW - n);
        memmove(hist, hist + hist_len - keep, keep);
        memcpy(hist + keep, member_base, n);
        hist_len = keep + static_cast<uint32_t>(n);
    }

    int64_t read(uint8_t* out, int64_t n) {
        if (err) return -err;
        uint8_t* out_next = out;
        uint8_t* const out_end = out + n;
        member_base = crc_from = out;
        int r = 0;
        while (out_next < out_end && state != S_DONE && !r) {
            switch (state) {
            case S_HEADER:
                r = header(out_next);
                break;
            case S_BLOCK:
                r = block_header();
                break;
            case S_HUFF:
            case S_STORED: {
                const int s = state == S_HUFF ? huffman(out_next, out_end) : stored(out_next, out_end);
                if (s == R_EOB) {
                    account(out_next);  // while the block's bytes are in cache
                    state = S_BLOCK;
                    if (final_block) state = S_TRAILER;
                } else if (s != R_FULL) {
                    r = s;
                }
                break;
            }
            case S_TRAILER:
                r = trailer(out_next);
                break;
            case S_DONE:
                break;
            }
        }
        // a member that ends exactly where the output does: check it now
        while (!r && out_next == out_end && state == S_TRAILER) r = trailer(out_next);
        account(out_next);
        keep_history(out_next);
        const int64_t produced = out_next - out;
        if (r) {
            err = r;
            if (!produced) return -err;
        }
        return produced;
    }
};

}  // namespace

extern "C" {

int hpgq_inflate_abi_version() { return kAbi; }

// A reader over the gzip file at path, or NULL (errno set).
void* hpgq_gz_open(const char* path) {
    const int fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return nullptr;
    Gz* g = new (std::nothrow) Gz;
    uint8_t* buf = static_cast<uint8_t*>(malloc(IN_CAP + IN_SLACK));
    if (!g || !buf) {
        delete g;
        free(buf);
        ::close(fd);
        errno = ENOMEM;
        return nullptr;
    }
    g->fd = fd;
    g->in_buf = buf;
    g->in_next = g->in_end = buf;
    return g;
}

// Fill out[0..n) with the next bytes of text: n of them unless the input
// ends or is bad.  Returns the count (0: the end), or a negated error class
// when an error comes before any byte; then hpgq_gz_message says why.
int64_t hpgq_gz_read(void* h, uint8_t* out, int64_t n) {
    if (n <= 0) return 0;
    return static_cast<Gz*>(h)->read(out, n);
}

const char* hpgq_gz_message(void* h) { return static_cast<Gz*>(h)->msg; }

void hpgq_gz_close(void* h) {
    Gz* g = static_cast<Gz*>(h);
    if (!g) return;
    ::close(g->fd);
    free(g->in_buf);
    delete g;
}

// gzip's CRC-32 (zlib.crc32's convention), for the tests
uint32_t hpgq_crc32(uint32_t crc, const uint8_t* p, int64_t n) {
    return crc32_update(crc, p, static_cast<size_t>(n));
}

}  // extern "C"
