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
// The parallel reader (hpgq_pgz_*) decodes the first member on a pool of
// threads, after pugz (Kerbiriou & Chikhi 2019) and rapidgzip (Knespel &
// Brunst 2023).  The member's compressed bytes are cut into chunks; a
// worker finds the first dynamic or stored block header at or after its
// chunk's offset and decodes from there with a window it does not know:
// 16-bit output whose values past 255 are markers naming a byte of that
// window, until 32 KB of output hold no marker, then bytes.  It stops at
// the first block boundary at or past the next chunk's offset.  The reader
// takes the chunks in order and accepts one only if it began where the
// chunk before it ended; its markers are then replaced from the 32 KB of
// text before it, and its CRC (folded on its worker past its 16-bit head)
// combined into the member's.  A chunk whose slot frees when every chunk
// before it is accepted (the reader's consumer setting the pace) starts
// where the last ended, with its window: bytes, no search, no markers.
// Every other chunk (a false header, a bad code, output past its cap), and
// all after the first member, is decoded by the sequential reader, resumed
// at the last confirmed block boundary with its window, CRC and length; so
// each error, and the bytes before it, are the sequential reader's.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -march=native inflate.cpp
// (hpgq_torch.io.native.inflate builds and loads it).

#include <cerrno>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <new>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

#if defined(__PCLMUL__) && defined(__SSE4_1__)
#include <immintrin.h>
#define HPGQ_CRC_FOLD 1
#endif

namespace {

constexpr int kAbi = 2;

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

// a(x) b(x) mod P, both reflected (bit 31 the coefficient of x^0)
uint32_t mul_mod_p(uint32_t a, uint32_t b) {
    uint32_t m = 1u << 31, p = 0;
    for (;;) {
        if (a & m) {
            p ^= b;
            if ((a & (m - 1)) == 0) break;
        }
        m >>= 1;
        b = (b & 1) ? (b >> 1) ^ 0xEDB88320u : b >> 1;
    }
    return p;
}

struct PowTable {
    uint32_t t[64];  // x^(2^k) mod P
    PowTable() {
        t[0] = 1u << 30;  // x
        for (int k = 1; k < 64; ++k) t[k] = mul_mod_p(t[k - 1], t[k - 1]);
    }
};
const PowTable kPow;

// The CRC-32 of A then B from crc_a, crc_b and B's length: crc_a times
// x^(8 len_b) mod P, plus crc_b.
uint32_t crc32_combine(uint32_t crc_a, uint32_t crc_b, uint64_t len_b) {
    uint32_t x = 1u << 31;  // 1
    for (unsigned k = 3; len_b; len_b >>= 1, ++k)
        if (len_b & 1) x = mul_mod_p(kPow.t[k & 63], x);
    return mul_mod_p(x, crc_a) ^ crc_b;
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

inline uint64_t load64(const void* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}
inline void store64(void* p, uint64_t v) { memcpy(p, &v, 8); }
// 16 bytes, loaded before any is stored
inline void copy16(void* dst, const void* src) {
    uint64_t a, b;
    memcpy(&a, src, 8);
    memcpy(&b, static_cast<const uint8_t*>(src) + 8, 8);
    memcpy(dst, &a, 8);
    memcpy(static_cast<uint8_t*>(dst) + 8, &b, 8);
}

constexpr size_t IN_CAP = 256 * 1024;  // input buffer
constexpr size_t IN_SLACK = 64;
constexpr size_t IN_KEEP = 8;          // bytes kept behind in_next on a refill
constexpr size_t IN_LOW = 4096;        // top up below this much input
constexpr size_t FAST_IN = 32;         // the fast loop's input margin
constexpr size_t FAST_OUT = 320;       // its output margin: an iteration writes < 2 + 258 + 16
constexpr uint32_t WINDOW = 32768;

enum State { S_HEADER, S_BLOCK, S_HUFF, S_STORED, S_TRAILER, S_DONE };
// besides error codes; R_STOP and R_FINAL from blocks() only
enum : int { R_GO = 0, R_EOB = -1, R_FULL = -2, R_STOP = -3, R_FINAL = -4 };
constexpr uint64_t NO_STOP = ~0ull;

// The decoder over output elements T: bytes, or (for a chunk whose window
// is not known) 16-bit values where 256 + i names byte i of that window.
// The gzip framing (header, trailer, read) is used with bytes only.
template <typename T>
struct Inflate {
    int fd = -1;
    uint8_t* in_buf = nullptr;
    const uint8_t* in_next = nullptr;
    const uint8_t* in_end = nullptr;
    bool in_eof = false;
    uint64_t buf_off = 0;  // the file's offset of in_buf[0]

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
    uint64_t stop_bit = NO_STOP;  // read() stops at a block boundary at or past it
    bool stopped = false;         // ... and says so here

    int err = 0;
    char msg[200] = {0};

    // this call's output
    T* member_base = nullptr;  // where the member's bytes of this call start
    T* crc_from = nullptr;     // first byte not yet in crc/msize

    T hist[WINDOW];
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
        buf_off += static_cast<uint64_t>(from - in_buf);
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
    // the input's bit position: bits before it are consumed
    uint64_t bitpos() const {
        return (buf_off + static_cast<uint64_t>(in_next - in_buf) + overread) * 8 - bitsleft;
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
    void account(T* out_next) {
        const size_t n = static_cast<size_t>(out_next - crc_from);
        if (n) {
            crc = crc32_update(crc, crc_from, n);
            msize += n;
            crc_from = out_next;
        }
    }

    // ---- gzip framing

    int header(T* out_next) {
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

    int trailer(T* out_next) {
        stop_bit = NO_STOP;  // the member is done: stop at none of the next's blocks
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
    uint32_t copy_slow(T* dst, T* out_end, uint32_t d, uint32_t len) {
        const size_t room = static_cast<size_t>(out_end - dst);
        const uint32_t n = len < room ? len : static_cast<uint32_t>(room);
        for (uint32_t i = 0; i < n; ++i) {
            const ptrdiff_t src = (dst + i - member_base) - static_cast<ptrdiff_t>(d);
            dst[i] = src >= 0 ? member_base[src] : hist[static_cast<ptrdiff_t>(hist_len) + src];
        }
        return n;
    }
    bool too_far(T* out_next, uint32_t d) const {
        return d > static_cast<size_t>(out_next - member_base) + hist_len;
    }

    // one symbol, careful of both ends
    int careful_symbol(T*& out_next, T* out_end) {
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
            *out_next++ = static_cast<T>(e >> 16);
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
    int fast(T*& out_next_ref, T* const out_end) {
        const uint8_t* in = in_next;
        if (static_cast<size_t>(in_end - in) <= FAST_IN ||
            static_cast<size_t>(out_end - out_next_ref) <= FAST_OUT)
            return R_GO;
        const uint8_t* const in_fast = in_end - FAST_IN;
        T* const out_fast = out_end - FAST_OUT;
        T* out_next = out_next_ref;
        T* const base = member_base;
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
            T* dst = out_next;
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
            const T* src = dst - d;
            if constexpr (sizeof(T) == 2) {
                // 16-bit output: eight or four values a copy, or under
                // four apart one pattern of four (three) values repeated
                uint64_t v;
                unsigned step = 4;
                if (d >= 8) {
                    do {
                        copy16(dst, src);
                        dst += 8;
                        src += 8;
                    } while (dst < out_next);
                    continue;
                } else if (d >= 4) {
                    do {
                        store64(dst, load64(src));
                        dst += 4;
                        src += 4;
                    } while (dst < out_next);
                    continue;
                } else if (d == 3) {
                    const T pat[4] = {src[0], src[1], src[2], src[0]};
                    v = load64(pat);
                    step = 3;
                } else {
                    const T pat[4] = {src[0], src[d - 1], src[0], src[d - 1]};
                    v = load64(pat);
                }
                do {
                    store64(dst, v);
                    dst += step;
                } while (dst < out_next);
            } else if (d >= 16) {
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

    int huffman(T*& out_next, T* const out_end) {
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

    int stored(T*& out_next, T* out_end) {
        while (stored_left && out_next < out_end) {
            if (in_next == in_end) {
                if (!in_eof)
                    if (int r = fill_input()) return r;
                if (in_next == in_end) return truncated();
            }
            size_t n = stored_left;
            if (n > static_cast<size_t>(out_end - out_next)) n = static_cast<size_t>(out_end - out_next);
            if (n > static_cast<size_t>(in_end - in_next)) n = static_cast<size_t>(in_end - in_next);
            if constexpr (sizeof(T) == 1) {
                memcpy(out_next, in_next, n);
            } else {
                for (size_t i = 0; i < n; ++i) out_next[i] = in_next[i];
            }
            out_next += n;
            in_next += n;
            stored_left -= static_cast<uint32_t>(n);
        }
        return stored_left ? R_FULL : R_EOB;
    }

    // the member's last 32 KB of output, for the next call's matches
    void keep_history(T* out_next) {
        const size_t n = static_cast<size_t>(out_next - member_base);
        if (n >= WINDOW) {
            memcpy(hist, out_next - WINDOW, WINDOW * sizeof(T));
            hist_len = WINDOW;
            return;
        }
        uint32_t keep = hist_len;
        if (keep > WINDOW - n) keep = static_cast<uint32_t>(WINDOW - n);
        memmove(hist, hist + hist_len - keep, keep * sizeof(T));
        memcpy(hist + keep, member_base, n * sizeof(T));
        hist_len = keep + static_cast<uint32_t>(n);
    }

    int64_t read(T* out, int64_t n) {
        if (err) return -err;
        T* out_next = out;
        T* const out_end = out + n;
        member_base = crc_from = out;
        int r = 0;
        while (out_next < out_end && state != S_DONE && !r && !stopped) {
            switch (state) {
            case S_HEADER:
                r = header(out_next);
                break;
            case S_BLOCK:
                if (bitpos() >= stop_bit) {
                    stopped = true;
                    break;
                }
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

    // ---- entry at a block boundary

    // Go on from bit `bit` of the file in state st (S_BLOCK or S_TRAILER)
    // as if the member's text so far had been read here: its last wlen
    // bytes w, its CRC and length; read() stops at the first block
    // boundary at or past `stop`.  An error is kept for the next read().
    int resume(uint64_t bit, State st, const uint8_t* w, uint32_t wlen, uint32_t crc_,
               uint64_t size, uint64_t stop) {
        if (::lseek(fd, static_cast<off_t>(bit / 8), SEEK_SET) < 0) {
            snprintf(msg, sizeof(msg), "%s", strerror(errno));
            return err = E_OS;
        }
        buf_off = bit / 8;
        in_next = in_end = in_buf;
        in_eof = false;
        bitbuf = 0;
        bitsleft = overread = 0;
        state = st;
        final_block = false;
        stored_left = pend_len = pend_dist = 0;
        fixed_loaded = false;
        crc = crc_;
        msize = size;
        memcpy(hist, w, wlen);
        hist_len = wlen;
        stop_bit = stop;
        stopped = false;
        if (bit % 8) {
            if (int r = refill_careful()) return err = r;
            take(bit % 8);
        }
        return 0;
    }

    // Read a file held in memory from bit `bit`, a block boundary.
    void set_memory(const uint8_t* data, size_t size, uint64_t bit) {
        in_buf = const_cast<uint8_t*>(data);
        in_next = data + bit / 8;
        in_end = data + size;
        in_eof = true;
        buf_off = 0;
        bitbuf = 0;
        bitsleft = overread = 0;
        state = S_BLOCK;
        refill_careful();  // no error from memory: zero bits past the end
        take(bit % 8);
    }

    // go on from where another decoder stopped, at a block boundary
    template <typename U>
    void take_input(const Inflate<U>& o) {
        in_buf = o.in_buf;
        in_next = o.in_next;
        in_end = o.in_end;
        in_eof = o.in_eof;
        buf_off = o.buf_off;
        bitbuf = o.bitbuf;
        bitsleft = o.bitsleft;
        overread = o.overread;
        state = S_BLOCK;
    }

    // From a block boundary of memory input into out, with member_base at
    // the start of the whole output: R_STOP at the first block boundary at
    // or past `stop`, R_FINAL after the final block, R_EOB after any other,
    // R_FULL with the output full, or an error.
    int blocks(T*& out_next, T* out_end, uint64_t stop) {
        if (state == S_BLOCK) {
            if (bitpos() >= stop) return R_STOP;
            if (int r = block_header()) return r;
        }
        const int s = state == S_HUFF ? huffman(out_next, out_end) : stored(out_next, out_end);
        if (s != R_EOB) return s;
        state = S_BLOCK;
        return final_block ? R_FINAL : R_EOB;
    }
};

using Gz = Inflate<uint8_t>;

// ---------------------------------------------------------------- block search

// LSB-first bits of memory from any bit position; zeros past the end
struct Peek {
    const uint8_t* data;
    size_t size;
    uint64_t get(uint64_t bit) const {  // at least 57 valid bits
        const size_t at = bit / 8;
        uint64_t v = 0;
        if (at + 8 <= size) {
            v = load64(data + at);
        } else {
            for (size_t i = 0; at + i < size && i < 8; ++i)
                v |= static_cast<uint64_t>(data[at + i]) << (8 * i);
        }
        return v >> (bit % 8);
    }
};

// A dynamic-Huffman block header at bit p, type 2 already seen in w (the
// bits from p): counts in range, the code-length code, the
// literal/length code and the distance code complete (a distance code of
// one codeword of length 1 as zlib allows), and an end-of-block length.
bool dynamic_at(const Peek& pk, uint64_t p, uint64_t w) {
    const unsigned nlen = ((w >> 3) & 31) + 257, ndist = ((w >> 8) & 31) + 1;
    const unsigned ncode = ((w >> 13) & 15) + 4;
    if (nlen > 286 || ndist > 30) return false;
    const uint64_t pl = pk.get(p + 17);
    uint8_t prelens[NUM_PRE] = {0};
    unsigned kraft = 0;
    for (unsigned i = 0; i < ncode; ++i) {
        const unsigned l = (pl >> (3 * i)) & 7;
        prelens[kPreOrder[i]] = static_cast<uint8_t>(l);
        if (l) kraft += 128u >> l;
    }
    if (kraft != 128) return false;
    uint32_t pre[1u << PRE_BITS];
    if (!build_table(pre, 1u << PRE_BITS, prelens, NUM_PRE, PRE_BITS, K_PRE)) return false;
    uint8_t lens[NUM_LITLEN + NUM_DIST];
    const unsigned n = nlen + ndist;
    uint64_t q = p + 17 + 3 * ncode;
    for (unsigned i = 0; i < n;) {
        const uint64_t v = pk.get(q);
        const uint32_t e = pre[low_bits(v, PRE_BITS)];
        const unsigned cw = ent_bits(e), sym = e >> 16;
        q += cw;
        if (sym < 16) {
            lens[i++] = static_cast<uint8_t>(sym);
            continue;
        }
        const uint64_t x = v >> cw;
        unsigned rep;
        uint8_t val = 0;
        if (sym == 16) {
            if (i == 0) return false;
            rep = 3 + (x & 3);
            q += 2;
            val = lens[i - 1];
        } else if (sym == 17) {
            rep = 3 + (x & 7);
            q += 3;
        } else {
            rep = 11 + (x & 127);
            q += 7;
        }
        if (i + rep > n) return false;
        memset(lens + i, val, rep);
        i += rep;
    }
    if (lens[256] == 0) return false;
    unsigned kl = 0, kd = 0, nd = 0;
    for (unsigned s = 0; s < nlen; ++s)
        if (lens[s]) kl += 32768u >> lens[s];
    for (unsigned s = 0; s < ndist; ++s)
        if (lens[nlen + s]) {
            kd += 32768u >> lens[nlen + s];
            ++nd;
        }
    return kl == 32768 && (kd == 32768 || (nd == 1 && kd == 16384));
}

// LEN and its complement NLEN at byte a
bool stored_lengths(const Peek& pk, uint64_t a) {
    if (a + 4 > pk.size) return false;
    const uint8_t* d = pk.data + a;
    return (d[0] | d[1] << 8) == (~(d[2] | d[3] << 8) & 0xffff);
}

// A stored block header at bit p, type 0 already seen: zero bits to the
// byte boundary, then LEN and its complement NLEN; and, not final, another
// dynamic or stored header right after its LEN bytes (a random LEN pair
// in Huffman data is met about once in a million bits).  A header one to
// five bits before a true one reads the same zeros and LEN, so two
// readings are passed over for the true one: a final header whose block
// does not end 8 bytes (the trailer) before the end of the file, since a
// set bit before a true header reads as one; and one whose LEN byte is
// itself a header with its own LEN after it, since a stored block of
// 65535 bytes at byte a (00 FF FF 00 00) reads from before it as LEN
// 0xFF00, NLEN 0x00FF.
bool stored_at(const Peek& pk, uint64_t p, bool final) {
    const uint64_t a = (p + 10) / 8;  // LEN's byte
    const unsigned pad = static_cast<unsigned>(8 * a - (p + 3));
    if (pk.get(p + 3) & ((1u << pad) - 1)) return false;
    if (!stored_lengths(pk, a)) return false;
    const uint8_t* d = pk.data + a;
    const uint64_t next = a + 4 + (d[0] | d[1] << 8);  // the next block's byte
    if (final) return next + 8 == pk.size;
    if (8 * a > p && (d[0] & 0xfe) == 0 && stored_lengths(pk, a + 1)) return false;
    const uint64_t w = pk.get(8 * next);
    if (next >= pk.size) return false;
    if ((w & 6) == 4) return dynamic_at(pk, 8 * next, w);
    return (w & 6) == 0 && stored_lengths(pk, next + 1);
}

constexpr uint64_t NOT_FOUND = ~0ull;

// The first bit in [from, to) where a dynamic or stored block header
// could start (fixed-Huffman blocks are not looked for), and whether it is
// a stored one not final; NOT_FOUND if none.  Final headers count too: the member's last
// block is one, and its chunk would otherwise always be read again.
uint64_t find_block(const uint8_t* data, size_t size, uint64_t from, uint64_t to, bool* stored) {
    const Peek pk{data, size};
    if (to > 8 * static_cast<uint64_t>(size)) to = 8 * static_cast<uint64_t>(size);
    for (uint64_t p = from; p < to; ++p) {
        const uint64_t w = pk.get(p);
        const unsigned h = w & 6;  // the type's bits; BFINAL either way
        if (h == 4) {
            if (((w >> 3) & 31) <= 29 && ((w >> 8) & 31) <= 29 && dynamic_at(pk, p, w)) {
                *stored = false;
                return p;
            }
        } else if (h == 0 && stored_at(pk, p, w & 1)) {
            *stored = (w & 1) == 0;
            return p;
        }
    }
    return NOT_FOUND;
}

// ---------------------------------------------------------------- parallel

struct Par;

// a chunk's decode: its outcome (J_BAD: no header found, or a bad code)
enum : int { J_OK, J_BAD, J_OVER };

// One chunk of a member: what its worker found and decoded, then (a
// second task) its markers replaced.  The buffers stay with the slot from
// one chunk to the next.
struct Job {
    Par* par = nullptr;
    uint64_t k = 0;
    bool resolving = false;  // the task: decode, or replace the markers
    bool known = false;      // decoded from a confirmed start with its window
    bool running = false, done = true;
    int status = J_OK;
    uint64_t start = 0, end = 0;  // bits: where its decode began and stopped
    bool final = false;           // it decoded the member's final block
    bool stored_start = false;    // its first block is stored, not final
    uint16_t* head = nullptr;     // WINDOW markers, then head_len values
    size_t head_len = 0;
    uint8_t* tail = nullptr;      // tail_pre bytes of history, then tail_len bytes
    size_t tail_pre = 0, tail_len = 0;
    uint32_t head_crc = 0, tail_crc = 0;  // of the head's bytes, of the tail's
    int64_t markers = 0;
    uint32_t win_len = 0;  // the text before the chunk, for its markers
    uint8_t win[WINDOW];   // (or, known, for its matches)
};

// The process's pool of decode threads, shared by every parallel reader.
struct Pool {
    std::mutex mu;
    std::condition_variable work, done;
    std::deque<Job*> q;
    int threads = 0;
    const pid_t pid = getpid();
    // chunk buffers of closed readers, kept for the next (their pages
    // mapped already): each a head, a tail and the cap they hold
    struct Spare {
        uint16_t* head;
        uint8_t* tail;
        size_t cap;
    };
    std::vector<Spare> spare;
};

void run_decode(Job& j);

// A byte for each 16-bit value: itself under 256, else the byte of the
// window (its last wlen bytes at w_end - wlen) that the marker names.
// Markers past the window's start are not looked up (accept() has ruled
// them out).
void fill_lut(uint8_t* lut, const uint8_t* w_end, uint32_t wlen) {
    for (uint32_t v = 0; v < 256; ++v) lut[v] = static_cast<uint8_t>(v);
    memset(lut + 256, 0, WINDOW - wlen);
    memcpy(lut + 256 + WINDOW - wlen, w_end - wlen, wlen);
}

// markers into the bytes of the window before the chunk, in place (byte i
// is written after value i is read), and the head's CRC
void run_resolve(Job& j) {
    uint8_t lut[256 + WINDOW];
    fill_lut(lut, j.win + j.win_len, j.win_len);
    const uint16_t* h = j.head + WINDOW;
    uint8_t* h8 = reinterpret_cast<uint8_t*>(j.head + WINDOW);
    int64_t m = 0;
    for (size_t i = 0; i < j.head_len; ++i) {
        const uint32_t v = h[i];
        m += v >> 8 != 0;
        h8[i] = lut[v];
    }
    j.markers = m;
    j.head_crc = crc32_update(0, h8, j.head_len);
}

void worker_main(Pool* p) {
    pthread_setname_np(pthread_self(), "hpgq-inflate");
    std::unique_lock<std::mutex> l(p->mu);
    for (;;) {
        p->work.wait(l, [p] { return !p->q.empty(); });
        Job* j = p->q.front();
        p->q.pop_front();
        j->running = true;
        l.unlock();
        if (j->resolving)
            run_resolve(*j);
        else
            run_decode(*j);
        l.lock();
        j->running = false;
        j->done = true;
        p->done.notify_all();
    }
}

std::mutex g_pool_mu;
Pool* g_pool = nullptr;  // never freed: its threads live as long as the process

// The pool with at least `threads` threads; a forked child, which has
// none of its parent's threads, gets a pool of its own.
Pool* the_pool(int threads) {
    std::lock_guard<std::mutex> g(g_pool_mu);
    if (!g_pool || g_pool->pid != getpid()) g_pool = new Pool;
    Pool* p = g_pool;
    std::lock_guard<std::mutex> l(p->mu);
    for (; p->threads < threads; ++p->threads) std::thread(worker_main, p).detach();
    return p;
}

struct Par {
    Gz* seq = nullptr;  // the sequential reader: restarts, errors, later members
    Pool* pool = nullptr;
    const uint8_t* map = nullptr;  // the whole file
    size_t size = 0;
    enum Mode { M_PAR, M_UNTIL, M_SEQ } mode = M_SEQ;
    // what seq does once the accepted chunks are handed out
    enum Then { T_NONE, T_CHUNK, T_REST, T_TRAILER } then = T_NONE;
    uint64_t then_stop = NO_STOP;
    uint64_t head_off = 0;    // the byte of the first member's first block
    uint64_t chunk = 0, nchunks = 0;
    size_t cap = 0;           // a chunk's most output; past it seq reads on
    std::vector<Job> jobs;    // chunk k in jobs[k % jobs.size()]
    uint64_t acc = 0;         // the next chunk to accept
    uint64_t until_next = 0;  // the chunk after the one seq re-decodes
    std::deque<Job*> ready;   // accepted, to hand out in order
    size_t cur_pos = 0;       // of ready.front()
    // the text accepted: the bit after it, its length and last bytes; the
    // CRC of the text handed out
    uint64_t pos = 0;
    uint64_t msize = 0;
    uint32_t crc = 0;
    uint32_t win_len = 0;
    uint8_t win[WINDOW];
    // chunks decoded from an unknown window and accepted, markers resolved,
    // chunks re-decoded by seq
    int64_t counts[3] = {0, 0, 0};

    uint64_t off(uint64_t k) const { return head_off + k * chunk; }
    // where chunk k's decode stops: the first block boundary at or past it
    uint64_t stop_of(uint64_t k) const { return k + 1 < nchunks ? 8 * off(k + 1) : NO_STOP; }
    Job& slot(uint64_t k) { return jobs[k % jobs.size()]; }

    void start(int workers, uint64_t chunk_bytes) {
        if (!map) return;
        // seq reads the first member's header; where it is bad, or no
        // block follows, seq reads everything from the start
        if (seq->header(nullptr) || seq->state != S_BLOCK || seq->bitpos() >= 8 * size) {
            seq->resume(0, S_HEADER, win, 0, 0, 0, NO_STOP);
            return;
        }
        const uint64_t h = seq->bitpos() / 8;
        head_off = h;
        chunk = chunk_bytes;
        nchunks = (size - h + chunk - 1) / chunk;
        cap = static_cast<size_t>(16 * chunk < (1u << 20) ? 1u << 20 : 16 * chunk);
        pos = 8 * h;
        pool = the_pool(workers);
        const uint64_t ring = 2 * static_cast<uint64_t>(workers);
        jobs.resize(static_cast<size_t>(nchunks < ring ? nchunks : ring));
        {
            std::lock_guard<std::mutex> l(pool->mu);
            for (Job& j : jobs) {
                for (size_t i = 0; i < pool->spare.size(); ++i) {
                    if (pool->spare[i].cap != cap) continue;
                    j.head = pool->spare[i].head;
                    j.tail = pool->spare[i].tail;
                    pool->spare.erase(pool->spare.begin() + static_cast<ptrdiff_t>(i));
                    break;
                }
            }
        }
        mode = M_PAR;
        for (uint64_t k = 0; k < jobs.size(); ++k) submit(k);
    }

    // Chunk k's decode.  Where every chunk before it is accepted already,
    // as when the pipeline behind the reader sets the pace, its start and
    // window are known: bytes from there, no search and no markers.
    void submit(uint64_t k) {
        Job& j = slot(k);
        j.par = this;
        j.k = k;
        j.resolving = false;
        j.known = mode == M_PAR && then == T_NONE && acc == k;
        if (j.known) {
            j.win_len = win_len;
            memcpy(j.win, win, win_len);
        }
        j.status = J_OK;
        j.start = j.known ? pos : 0;
        j.end = 0;
        j.final = j.stored_start = false;
        j.head_len = j.tail_pre = j.tail_len = 0;
        j.head_crc = j.tail_crc = 0;
        j.markers = 0;
        std::lock_guard<std::mutex> l(pool->mu);
        j.done = false;
        pool->q.push_back(&j);
        pool->work.notify_one();
    }

    // an accepted chunk's markers, ahead of every decode waiting
    void submit_resolve(Job& j) {
        j.resolving = true;
        std::lock_guard<std::mutex> l(pool->mu);
        j.done = false;
        pool->q.push_front(&j);
        pool->work.notify_one();
    }

    void wait(Job& j) {
        std::unique_lock<std::mutex> l(pool->mu);
        pool->done.wait(l, [&j] { return j.done; });
    }

    // chunk k's decode is done, without waiting
    bool decoded(uint64_t k) {
        Job& j = slot(k);
        std::lock_guard<std::mutex> l(pool->mu);
        return j.k == k && !j.resolving && j.done;
    }

    // a chunk's slot free: on to the chunk jobs.size() later, unless seq
    // is to read the rest
    void recycle(const Job& j) {
        const uint64_t k = j.k + jobs.size();
        if (mode != M_SEQ && then != T_REST && then != T_TRAILER && k < nchunks) submit(k);
    }

    // no more chunks: take this reader's queued tasks back, wait for the rest
    void drain() {
        if (!pool) return;
        std::unique_lock<std::mutex> l(pool->mu);
        for (auto it = pool->q.begin(); it != pool->q.end();) {
            if ((*it)->par == this) {
                (*it)->done = true;
                it = pool->q.erase(it);
            } else {
                ++it;
            }
        }
        pool->done.wait(l, [this] {
            for (const Job& j : jobs)
                if (j.running) return false;
            return true;
        });
    }

    // seq on from bit `bit` with the text handed out so far; to the end of
    // everything, or to the first block boundary at or past `stop`
    void to_seq(uint64_t bit, State st, uint64_t stop) {
        mode = stop == NO_STOP ? M_SEQ : M_UNTIL;
        then = T_NONE;
        if (mode == M_SEQ) drain();
        seq->resume(bit, st, win, win_len, crc, msize, stop);
    }

    // seq stopped at a block boundary: the chunks go on from there
    void from_seq() {
        pos = seq->bitpos();
        crc = seq->crc;
        msize = seq->msize;
        win_len = seq->hist_len;
        memcpy(win, seq->hist, win_len);
        seq->stopped = false;
        mode = M_PAR;
        acc = until_next;
    }

    // The window after chunk j from the one before it (win) and j's last
    // bytes, its markers read from win; false where a marker of j reaches
    // before the member's start (seq then finds the error).
    bool next_window(const Job& j) {
        const uint16_t* h = j.head ? j.head + WINDOW : nullptr;
        if (win_len < WINDOW)
            for (size_t i = 0; i < j.head_len; ++i)
                if (h[i] >= 256 && WINDOW - (h[i] - 256u) > win_len) return false;
        uint8_t nw[WINDOW];
        size_t n = j.tail_len < WINDOW ? j.tail_len : WINDOW;
        memcpy(nw + WINDOW - n, j.tail + j.tail_pre + j.tail_len - n, n);
        const size_t hc = j.head_len < WINDOW - n ? j.head_len : WINDOW - n;
        if (hc) {
            uint8_t lut[256 + WINDOW];
            fill_lut(lut, win + win_len, win_len);
            for (size_t i = 0; i < hc; ++i) nw[WINDOW - n - hc + i] = lut[h[j.head_len - hc + i]];
        }
        n += hc;
        const size_t wc = win_len < WINDOW - n ? win_len : WINDOW - n;
        memcpy(nw + WINDOW - n - wc, win + win_len - wc, wc);
        n += wc;
        memcpy(win, nw + WINDOW - n, n);
        win_len = static_cast<uint32_t>(n);
        return true;
    }

    // The next chunk in order: passed over where the chunk before reached
    // past it; accepted where it began where that one ended (its markers
    // then replaced on the pool); else re-decoded by seq once the chunks
    // before it are handed out.
    void accept() {
        const uint64_t k = acc++;
        Job& j = slot(k);
        wait(j);
        const uint64_t stop = stop_of(k);
        if (pos >= stop) {
            recycle(j);
            return;
        }
        // a stored header, not final, found up to 3 bits early reads the
        // same zero bits and LEN as the one at pos
        const bool joins = j.start == pos ||
                           (j.stored_start && j.start < pos && pos + 3 <= (j.start + 10) / 8 * 8);
        if (j.status == J_OK && joins) {
            j.win_len = win_len;
            memcpy(j.win, win, win_len);
            if (next_window(j)) {
                if (!j.known) ++counts[0];
                pos = j.end;
                msize += j.head_len + j.tail_len;
                if (j.head_len) submit_resolve(j);
                ready.push_back(&j);
                if (j.final) then = T_TRAILER;  // the trailer and all after it
                return;
            }
            memcpy(win, j.win, j.win_len);
            win_len = j.win_len;
        }
        ++counts[2];
        // past the cap: the member is more compressible than the chunks
        // allow for, so seq reads the rest of it
        then = j.status == J_OVER ? T_REST : T_CHUNK;
        then_stop = stop;
        until_next = k + 1;
        recycle(j);
    }

    // Hand out ready.front() (its markers replaced), as much as fits.
    // First accept the chunks decoded behind it: their markers are then
    // replaced while this waits, and a slot this frees may be decoded
    // from a known start.
    size_t emit(uint8_t* out, size_t n) {
        while (then == T_NONE && acc < nchunks && decoded(acc)) accept();
        Job& j = *ready.front();
        wait(j);
        if (cur_pos == 0) {
            crc = crc32_combine(crc, j.head_crc, j.head_len);
            crc = crc32_combine(crc, j.tail_crc, j.tail_len);
            counts[1] += j.markers;
        }
        const size_t total = j.head_len + j.tail_len;
        size_t done = 0;
        while (done < n && cur_pos < total) {
            const uint8_t* src;
            size_t avail;
            if (cur_pos < j.head_len) {
                src = reinterpret_cast<const uint8_t*>(j.head + WINDOW) + cur_pos;
                avail = j.head_len - cur_pos;
            } else {
                src = j.tail + j.tail_pre + (cur_pos - j.head_len);
                avail = total - cur_pos;
            }
            const size_t m = avail < n - done ? avail : n - done;
            memcpy(out + done, src, m);
            done += m;
            cur_pos += m;
        }
        if (cur_pos == total) {
            ready.pop_front();
            cur_pos = 0;
            recycle(j);
        }
        return done;
    }

    int64_t read(uint8_t* out, int64_t n) {
        int64_t got = 0;
        while (got < n) {
            if (mode == M_PAR) {
                if (!ready.empty()) {
                    got += static_cast<int64_t>(emit(out + got, static_cast<size_t>(n - got)));
                } else if (then == T_TRAILER) {
                    to_seq(pos, S_TRAILER, NO_STOP);
                } else if (then == T_CHUNK) {
                    to_seq(pos, S_BLOCK, then_stop);
                } else if (then == T_REST || acc >= nchunks) {
                    to_seq(pos, S_BLOCK, NO_STOP);  // past the last chunk, no final block
                } else {
                    accept();
                }
                continue;
            }
            const int64_t r = seq->read(out + got, n - got);
            if (r < 0) return got ? got : r;
            got += r;
            if (mode == M_UNTIL) {
                if (seq->stopped) {
                    from_seq();
                    continue;
                }
                if (seq->stop_bit == NO_STOP) {  // the member ended
                    mode = M_SEQ;
                    drain();
                }
            }
            if (r == 0) break;
        }
        return got;
    }

    ~Par() {
        drain();
        for (Job& j : jobs) {
            if (j.head && j.tail) {
                std::lock_guard<std::mutex> l(pool->mu);
                if (pool->spare.size() < 2 * static_cast<size_t>(pool->threads)) {
                    pool->spare.push_back({j.head, j.tail, cap});
                    continue;
                }
            }
            free(j.head);
            free(j.tail);
        }
        if (map) munmap(const_cast<uint8_t*>(map), size);
    }
};

// bytes into j.tail after `pre` bytes of history already there, with d
// positioned at a block boundary
void decode_bytes(Job& j, Gz& d, size_t pre, size_t room, uint64_t stop) {
    d.member_base = j.tail;
    d.hist_len = 0;
    uint8_t* out = j.tail + pre;
    int r;
    while ((r = d.blocks(out, j.tail + pre + room, stop)) == R_EOB) {
    }
    j.tail_pre = pre;
    j.tail_len = static_cast<size_t>(out - j.tail) - pre;
    if (r == R_FULL) {
        j.status = J_OVER;
    } else if (r == R_STOP || r == R_FINAL) {
        j.end = d.bitpos();
        j.final = r == R_FINAL;
        j.tail_crc = crc32_update(0, j.tail + pre, j.tail_len);
    } else {
        j.status = J_BAD;
    }
}

// Chunk j from bit j.start with the window before it unknown: 16-bit
// values, bytes once the last WINDOW of them hold no marker.
void decode_unknown(Job& j, const Par& p, uint64_t stop) {
    const size_t cap = p.cap;
    Inflate<uint16_t>* d = new (std::nothrow) Inflate<uint16_t>;
    if (!d) {
        j.status = J_BAD;
        return;
    }
    uint16_t* const h = j.head;
    for (uint32_t i = 0; i < WINDOW; ++i) h[i] = static_cast<uint16_t>(256 + i);
    d->set_memory(p.map, p.size, j.start);
    d->member_base = h;
    d->hist_len = 0;
    uint16_t* out = h + WINDOW;
    size_t scanned = WINDOW;   // values before this looked at for markers
    size_t last = WINDOW - 1;  // the last marker among them
    bool clean = false;        // the last WINDOW values hold no marker
    int r;
    while ((r = d->blocks(out, h + WINDOW + cap, stop)) == R_EOB) {
        const size_t n = static_cast<size_t>(out - h);
        for (size_t i = n; i > scanned; --i)
            if (h[i - 1] >= 256) {
                last = i - 1;
                break;
            }
        scanned = n;
        if (last + WINDOW < n) {
            clean = true;
            break;
        }
    }
    j.head_len = static_cast<size_t>(out - h) - WINDOW;
    if (clean) {  // on in bytes, the last WINDOW values as their history
        Gz* d8 = new (std::nothrow) Gz;
        if (d8) {
            d8->take_input(*d);
            for (uint32_t i = 0; i < WINDOW; ++i)
                j.tail[i] = static_cast<uint8_t>(out[static_cast<ptrdiff_t>(i) - WINDOW]);
            decode_bytes(j, *d8, WINDOW, cap - j.head_len, stop);
            delete d8;
        } else {
            j.status = J_BAD;
        }
    } else if (r == R_FULL) {
        j.status = J_OVER;
    } else if (r == R_STOP || r == R_FINAL) {
        j.end = d->bitpos();
        j.final = r == R_FINAL;
    } else {
        j.status = J_BAD;
    }
    delete d;
}

void run_decode(Job& j) {
    const Par& p = *j.par;
    const uint64_t stop = p.stop_of(j.k);
    const size_t cap = p.cap;
    if (!j.tail) j.tail = static_cast<uint8_t*>(malloc(WINDOW + cap));
    if (!j.tail) {
        j.status = J_BAD;
        return;
    }
    if (j.known) {  // chunk 0 from the member's header, or a confirmed start
        Gz* d = new (std::nothrow) Gz;
        if (!d) {
            j.status = J_BAD;
            return;
        }
        d->set_memory(p.map, p.size, j.start);
        memcpy(j.tail, j.win, j.win_len);
        decode_bytes(j, *d, j.win_len, cap, stop);
        delete d;
        return;
    }
    if (!j.head) j.head = static_cast<uint16_t*>(malloc((WINDOW + cap) * sizeof(uint16_t)));
    if (!j.head) {
        j.status = J_BAD;
        return;
    }
    // a decode that fails from a header found proves the header false:
    // look on from the bit after it
    for (uint64_t from = 8 * p.off(j.k);; from = j.start + 1) {
        j.start = find_block(p.map, p.size, from, stop, &j.stored_start);
        if (j.start == NOT_FOUND) {
            j.status = J_BAD;
            return;
        }
        j.status = J_OK;
        j.head_len = j.tail_pre = j.tail_len = 0;
        decode_unknown(j, p, stop);
        if (j.status != J_BAD) return;
    }
}

Gz* gz_new(int fd) {
    Gz* g = new (std::nothrow) Gz;
    uint8_t* buf = static_cast<uint8_t*>(malloc(IN_CAP + IN_SLACK));
    if (!g || !buf) {
        delete g;
        free(buf);
        return nullptr;
    }
    g->fd = fd;
    g->in_buf = buf;
    g->in_next = g->in_end = buf;
    return g;
}

void gz_delete(Gz* g) {
    if (!g) return;
    ::close(g->fd);
    free(g->in_buf);
    delete g;
}

}  // namespace

extern "C" {

int hpgq_inflate_abi_version() { return kAbi; }

// A reader over the gzip file at path, or NULL (errno set).
void* hpgq_gz_open(const char* path) {
    const int fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return nullptr;
    Gz* g = gz_new(fd);
    if (!g) {
        ::close(fd);
        errno = ENOMEM;
    }
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

void hpgq_gz_close(void* h) { gz_delete(static_cast<Gz*>(h)); }

// The parallel reader: the first member decoded in chunks of chunk_bytes
// compressed bytes on the process's pool, which it grows to `workers`
// threads; read, message and close as hpgq_gz_*.
void* hpgq_pgz_open(const char* path, int workers, int64_t chunk_bytes) {
    const int fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return nullptr;
    Par* p = new (std::nothrow) Par;
    Gz* g = p ? gz_new(fd) : nullptr;
    if (!g) {
        delete p;
        ::close(fd);
        errno = ENOMEM;
        return nullptr;
    }
    p->seq = g;
    struct stat st;
    if (fstat(fd, &st) == 0 && st.st_size > 0) {
        void* m = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ, MAP_PRIVATE, fd, 0);
        if (m != MAP_FAILED) {
            p->map = static_cast<const uint8_t*>(m);
            p->size = static_cast<size_t>(st.st_size);
        }
    }
    p->start(workers, chunk_bytes > 0 ? static_cast<uint64_t>(chunk_bytes) : 1);
    return p;
}

int64_t hpgq_pgz_read(void* h, uint8_t* out, int64_t n) {
    if (n <= 0) return 0;
    return static_cast<Par*>(h)->read(out, n);
}

const char* hpgq_pgz_message(void* h) { return static_cast<Par*>(h)->seq->msg; }

// chunks accepted, markers resolved, chunks re-decoded by the sequential
// reader, since the open
void hpgq_pgz_counts(void* h, int64_t* out) {
    memcpy(out, static_cast<Par*>(h)->counts, sizeof(int64_t) * 3);
}

void hpgq_pgz_close(void* h) {
    Par* p = static_cast<Par*>(h);
    if (!p) return;
    Gz* g = p->seq;
    delete p;
    gz_delete(g);
}

// gzip's CRC-32 (zlib.crc32's convention), for the tests
uint32_t hpgq_crc32(uint32_t crc, const uint8_t* p, int64_t n) {
    return crc32_update(crc, p, static_cast<size_t>(n));
}

// the CRC-32 of A then B, for the tests
uint32_t hpgq_crc32_combine(uint32_t crc_a, uint32_t crc_b, int64_t len_b) {
    return crc32_combine(crc_a, crc_b, static_cast<uint64_t>(len_b));
}

}  // extern "C"
