// hpgq native packer: FASTQ record indexing + padded-tensor packing.
//
// TPU-native replacement for the reference's native FASTQ parser layer
// (fastq_fread_se / fastq_read_t, call sites src/stats_fastq.c:183,353-360):
// instead of one heap object per read, one pass over a byte chunk yields
// line-offset tables, and a second OpenMP-parallel pass translates bases
// through a LUT into the engine's packed [N, L] int8/uint8 layout.
// Exposed as a plain C ABI for ctypes (no pybind11 in this toolchain).
//
// Build: see hpgq/io/native/__init__.py (g++ -O3 -fopenmp -shared).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif
#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>
#endif

namespace {

// Parallel regions of this thread's native calls whose team came up
// smaller than asked (OMP_THREAD_LIMIT, nesting, a dynamic runtime), since
// its last hpgq_team_short().  The output never depends on it: a team
// splits rows by iteration (omp for) or loops over every planned slice.
thread_local int64_t t_team_short = 0;

// Called in a region by its first thread (thread 0, which a static
// schedule gives the first iteration): counts a short team.
inline void note_team(int asked) {
#ifdef _OPENMP
    if (omp_get_thread_num() == 0 && omp_get_num_threads() < asked)
        ++t_team_short;
#else
    if (asked > 1) ++t_team_short;
#endif
}

// The offsets of the newlines in buf[lo, hi): counted, or written to
// `out` until `cap` are (returning how many).  32 bytes a step where the
// CPU has AVX2 (positions from one compare's bit mask: C's records put a
// newline every 58 bytes on average, where a memchr a line pays a call
// for little), else memchr.
#if defined(__x86_64__) && defined(__GNUC__)
__attribute__((target("avx2"))) int64_t newlines_avx2(
        const uint8_t* buf, int64_t lo, int64_t hi, int64_t* out,
        int64_t cap) {
    const __m256i nl = _mm256_set1_epi8('\n');
    int64_t cnt = 0;
    int64_t i = lo;
    for (; i + 32 <= hi; i += 32) {
        uint32_t m = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(
            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(buf + i)),
            nl));
        if (!out) {
            cnt += __builtin_popcount(m);
            continue;
        }
        for (; m; m &= m - 1) {
            if (cnt >= cap) return cnt;
            out[cnt++] = i + __builtin_ctz(m);
        }
    }
    for (; i < hi; ++i) {
        if (buf[i] != '\n') continue;
        if (out) {
            if (cnt >= cap) return cnt;
            out[cnt] = i;
        }
        ++cnt;
    }
    return cnt;
}

bool has_avx2() {
    static const bool yes = (__builtin_cpu_init(),
                             __builtin_cpu_supports("avx2") != 0);
    return yes;
}
#endif

int64_t newlines(const uint8_t* buf, int64_t lo, int64_t hi, int64_t* out,
                 int64_t cap) {
#if defined(__x86_64__) && defined(__GNUC__)
    if (has_avx2()) return newlines_avx2(buf, lo, hi, out, cap);
#endif
    int64_t cnt = 0;
    const uint8_t* p = buf + lo;
    const uint8_t* end = buf + hi;
    while (p < end) {
        const uint8_t* hit =
            static_cast<const uint8_t*>(memchr(p, '\n', end - p));
        if (!hit) break;
        if (out) {
            if (cnt >= cap) break;
            out[cnt] = hit - buf;
        }
        ++cnt;
        p = hit + 1;
    }
    return cnt;
}

}  // namespace

extern "C" {

// The calling thread's short teams since its last call (see note_team),
// and zero after it.
int64_t hpgq_team_short(void) {
    const int64_t n = t_team_short;
    t_team_short = 0;
    return n;
}

// to[0..n) = from[0..n) in up to `num_threads` contiguous pieces: a packed
// batch into its pinned staging buffer on the pack worker's team, a
// chunk behind the reader's carried tail on the index's.
void hpgq_copy(const void* from, void* to, int64_t n, int num_threads) {
    const uint8_t* src = static_cast<const uint8_t*>(from);
    uint8_t* dst = static_cast<uint8_t*>(to);
    if (num_threads < 1) num_threads = 1;
    const int64_t min_piece = 1 << 20;  // a team pays off past ~1 MB a thread
    int T = (int)((n + min_piece - 1) / min_piece);
    if (T > num_threads) T = num_threads;
    if (T <= 1) {
        if (n > 0) memcpy(dst, src, (size_t)n);
        return;
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(T)
#endif
    for (int s = 0; s < T; ++s) {
        if (s == 0) note_team(T);
        const int64_t lo = n * s / T;
        const int64_t hi = n * (s + 1) / T;
        memcpy(dst + lo, src + lo, (size_t)(hi - lo));
    }
}

// Scan `buf[0..n)` for newline positions, recording up to `max_lines` of
// them into `nl`.  Returns the number recorded.  (memchr-based: glibc's
// AVX2 memchr is ~an order of magnitude faster than a numpy == scan.)
int64_t hpgq_find_newlines(const uint8_t* buf, int64_t n, int64_t* nl,
                           int64_t max_lines) {
    return newlines(buf, 0, n, nl, max_lines);
}

// Pack `n` reads into codes[n*lmax] (int8 base codes, pad=5) and
// quals[n*lmax] (raw ASCII, pad=0).  seq_starts/q_starts/lens are per-read
// byte offsets into `buf` and sequence lengths.  `lut` is the 256-entry
// base-code table (A/a=0 C/c=1 G/g=2 T/t=3 N/n=4 other=5,
// old/chaos_game.c:51-72 semantics).
void hpgq_pack(const uint8_t* buf, const int64_t* seq_starts,
               const int64_t* q_starts, const int32_t* lens, int64_t n,
               int64_t lmax, const int8_t* lut, int8_t* codes,
               uint8_t* quals, int num_threads) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(num_threads)
#endif
    for (int64_t i = 0; i < n; ++i) {
        if (i == 0) note_team(num_threads);  // the first thread's row
        int8_t* crow = codes + i * lmax;
        uint8_t* qrow = quals + i * lmax;
        int64_t len = lens[i];
        if (len > lmax) len = lmax;
        const uint8_t* seq = buf + seq_starts[i];
        for (int64_t j = 0; j < len; ++j) crow[j] = lut[seq[j]];
        if (len < lmax) memset(crow + len, 5, lmax - len);
        memcpy(qrow, buf + q_starts[i], len);
        if (len < lmax) memset(qrow + len, 0, lmax - len);
    }
}

// The line tables of `nrec` FASTQ records whose text starts at buf[0],
// from the offsets `nl` of their newlines (4 a record): a line starts
// after the newline before it and ends at its own, moved back over a
// '\r' before it.  Returns the first record whose sequence and quality
// lengths differ, or whose header does not start with '@' or separator
// with '+', else -1 (the reader raises on it).
int64_t hpgq_record_table(const uint8_t* buf, const int64_t* nl,
                          int64_t nrec, int64_t* starts, int64_t* ends) {
    int64_t prev = -1;
    int64_t bad = -1;
    for (int64_t r = 0; r < nrec; ++r) {
        int64_t* s = starts + 4 * r;
        int64_t* e = ends + 4 * r;
        for (int k = 0; k < 4; ++k) {
            const int64_t end = nl[4 * r + k];
            s[k] = prev + 1;
            e[k] = end - (end > 0 && buf[end - 1] == '\r');
            prev = end;
        }
        if (bad < 0 && (e[1] - s[1] != e[3] - s[3] || buf[s[0]] != '@' ||
                        buf[s[2]] != '+'))
            bad = r;
    }
    return bad;
}

// Multi-threaded newline scan: segments of `buf` are counted and filled in
// parallel (newlines() per segment), results written contiguously via a prefix
// sum over per-segment counts.  Returns the total number of newlines, or
// the NEGATED total (with nothing written) when it exceeds `cap` — the
// caller then re-invokes with an exact-size buffer.
int64_t hpgq_find_newlines_mt(const uint8_t* buf, int64_t n, int64_t* nl,
                              int64_t cap, int num_threads) {
    if (num_threads < 1) num_threads = 1;
    const int64_t min_seg = 1 << 20;  // threading pays off past ~1 MB
    int nseg = (int)((n + min_seg - 1) / min_seg);
    if (nseg > num_threads) nseg = num_threads;
    if (nseg < 1) nseg = 1;
    std::vector<int64_t> counts((size_t)nseg, 0);
    std::vector<int64_t> seg_lo((size_t)nseg), seg_hi((size_t)nseg);
    for (int s = 0; s < nseg; ++s) {
        seg_lo[s] = n * s / nseg;
        seg_hi[s] = n * (s + 1) / nseg;
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(nseg)
#endif
    for (int s = 0; s < nseg; ++s) {
        if (s == 0) note_team(nseg);  // the first thread's segment
        counts[(size_t)s] = newlines(buf, seg_lo[s], seg_hi[s], nullptr, 0);
    }
    std::vector<int64_t> offs((size_t)nseg + 1, 0);
    for (int s = 0; s < nseg; ++s) offs[(size_t)s + 1] = offs[(size_t)s] + counts[(size_t)s];
    if (offs[(size_t)nseg] > cap) return -offs[(size_t)nseg];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(nseg)
#endif
    for (int s = 0; s < nseg; ++s) {
        if (s == 0) note_team(nseg);  // the first thread's segment
        newlines(buf, seg_lo[s], seg_hi[s], nl + offs[(size_t)s],
                 counts[(size_t)s]);
    }
    return offs[(size_t)nseg];
}

// Pack `n` reads straight into the fused4 wire layout (one uint8 row per
// read: [codes4 | quals | len_le32 | valid | pad3], row width W = L/2+L+8 —
// see hpgq.kernels.stats_jnp.wire_fuse).  This replaces the two-tensor pack
// + numpy nibble-pack + concatenate with ONE OpenMP pass from the chunk
// bytes to the transfer buffer: the host->device wire buffer is written
// exactly once.  Rows i >= n are padding (codes nibble 5 -> 0x55, quals 0,
// len 0, valid 0).
void hpgq_pack_fused(const uint8_t* buf, const int64_t* seq_starts,
                     const int64_t* q_starts, const int32_t* lens, int64_t n,
                     int64_t L, int64_t nrows, const int8_t* lut,
                     uint8_t* out, int num_threads) {
    const int64_t L2 = L / 2;
    const int64_t W = L2 + L + 8;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(num_threads)
#endif
    for (int64_t i = 0; i < nrows; ++i) {
        if (i == 0) note_team(num_threads);  // the first thread's row
        uint8_t* row = out + i * W;
        if (i >= n) {
            memset(row, 0x55, L2);      // BASE_OTHER=5 in both nibbles
            memset(row + L2, 0, L + 8); // quals, len, valid, pad
            continue;
        }
        const int64_t len_orig = lens[i];  // wire carries the unclipped
        int64_t len = len_orig;            // length (pack_block semantics)
        if (len > L) len = L;
        const uint8_t* seq = buf + seq_starts[i];
        // nibble-packed base codes, even position in the low nibble
        int64_t pairs = len / 2;
        for (int64_t j = 0; j < pairs; ++j) {
            row[j] = (uint8_t)(lut[seq[2 * j]] & 0xF) |
                     (uint8_t)((lut[seq[2 * j + 1]] & 0xF) << 4);
        }
        if (len & 1) {
            // odd tail: high nibble is padding (BASE_OTHER)
            row[pairs] = (uint8_t)(lut[seq[len - 1]] & 0xF) | 0x50;
            ++pairs;
        }
        if (pairs < L2) memset(row + pairs, 0x55, L2 - pairs);
        uint8_t* qrow = row + L2;
        memcpy(qrow, buf + q_starts[i], len);
        if (len < L) memset(qrow + len, 0, L - len);
        uint8_t* tail = row + L2 + L;
        uint32_t l32 = (uint32_t)len_orig;
        tail[0] = (uint8_t)(l32 & 0xFF);
        tail[1] = (uint8_t)((l32 >> 8) & 0xFF);
        tail[2] = (uint8_t)((l32 >> 16) & 0xFF);
        tail[3] = (uint8_t)((l32 >> 24) & 0xFF);
        tail[4] = 1;  // valid
        tail[5] = tail[6] = tail[7] = 0;
    }
}

// Pack `n` reads into the bitpack wire layout: one uint8 row per read of
// width W = 3L/8 + 7L/8 + 8 (L % 8 == 0):
//   [codes3 | quals7 | len_le32 | valid | pad3]
// codes are 3-bit (A..N,other = 0..5, pad 5), quals the raw 7-bit ASCII
// byte (pad 0), both little-endian bitstreams (value LSB first).  This is
// the minimum-byte transfer format for latency-/bandwidth-bound
// host->device links: ~31% fewer bytes than fused4 at equal information.
// Decoded on device by hpgq.kernels.stats_jnp.wire_unbits.
void hpgq_pack_bitwire(const uint8_t* buf, const int64_t* seq_starts,
                       const int64_t* q_starts, const int32_t* lens,
                       int64_t n, int64_t L, int64_t nrows, const int8_t* lut,
                       uint8_t* out, int num_threads) {
    const int64_t c3 = 3 * L / 8;
    const int64_t q7 = 7 * L / 8;
    const int64_t W = c3 + q7 + 8;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(num_threads)
#endif
    for (int64_t i = 0; i < nrows; ++i) {
        if (i == 0) note_team(num_threads);  // the first thread's row
        uint8_t* row = out + i * W;
        if (i >= n) {
            memset(row, 0, W);
            continue;
        }
        const int64_t len_orig = lens[i];
        int64_t len = len_orig;
        if (len > L) len = L;
        const uint8_t* seq = buf + seq_starts[i];
        const uint8_t* q = buf + q_starts[i];
        uint32_t reg = 0;
        int bits = 0;
        uint8_t* p = row;
        for (int64_t j = 0; j < L; ++j) {
            uint32_t v = j < len ? (uint32_t)(lut[seq[j]] & 7) : 5u;
            reg |= v << bits;
            bits += 3;
            if (bits >= 8) {
                *p++ = (uint8_t)(reg & 0xFF);
                reg >>= 8;
                bits -= 8;
            }
        }
        // L % 8 == 0 -> 3L % 8 == 0 -> bits == 0 here
        reg = 0;
        bits = 0;
        p = row + c3;
        for (int64_t j = 0; j < L; ++j) {
            uint32_t v = j < len ? (uint32_t)(q[j] & 0x7F) : 0u;
            reg |= v << bits;
            bits += 7;
            if (bits >= 8) {
                *p++ = (uint8_t)(reg & 0xFF);
                reg >>= 8;
                bits -= 8;
            }
        }
        uint8_t* tail = row + c3 + q7;
        uint32_t l32 = (uint32_t)len_orig;
        tail[0] = (uint8_t)(l32 & 0xFF);
        tail[1] = (uint8_t)((l32 >> 8) & 0xFF);
        tail[2] = (uint8_t)((l32 >> 16) & 0xFF);
        tail[3] = (uint8_t)((l32 >> 24) & 0xFF);
        tail[4] = 1;
        tail[5] = tail[6] = tail[7] = 0;
    }
}

// bitpack6 wire: 3-bit codes + 6-bit RE-BASED quals (value = qual - row
// qbase), then len_le32|valid|qbase|pad2 (+ optional pad column: the
// caller bumps W by one byte when 9L/8+8 collides with a valid 7-bit
// width — the decoder distinguishes the layouts by width alone).  A row
// fits iff its qual range spans < 64 values (qbase = row min); returns 1
// when every row fits, 0 on the first misfit (output is then partial
// garbage — the caller repacks 7-bit).  ~9% fewer wire bytes than
// bitpack at 100 bp; real sequencer quals span far less than 64 values.
int32_t hpgq_pack_bitwire6(const uint8_t* buf, const int64_t* seq_starts,
                           const int64_t* q_starts, const int32_t* lens,
                           int64_t n, int64_t L, int64_t nrows, int64_t W,
                           const int8_t* lut, uint8_t* out,
                           int num_threads) {
    const int64_t c3 = 3 * L / 8;
    const int64_t q6 = 6 * L / 8;
    volatile int misfit = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(num_threads)
#endif
    for (int64_t i = 0; i < nrows; ++i) {
        if (i == 0) note_team(num_threads);  // the first thread's row
        if (misfit) continue;
        uint8_t* row = out + i * W;
        if (i >= n) {
            memset(row, 0, W);
            continue;
        }
        const int64_t len_orig = lens[i];
        int64_t len = len_orig;
        if (len > L) len = L;
        const uint8_t* seq = buf + seq_starts[i];
        const uint8_t* q = buf + q_starts[i];
        uint8_t qmin = 255, qmax = 0;
        for (int64_t j = 0; j < len; ++j) {
            uint8_t v = q[j] & 0x7F;
            if (v < qmin) qmin = v;
            if (v > qmax) qmax = v;
        }
        if (len == 0) qmin = 0;
        if ((int)qmax - (int)qmin > 63) {
            misfit = 1;
            continue;
        }
        uint32_t reg = 0;
        int bits = 0;
        uint8_t* p = row;
        for (int64_t j = 0; j < L; ++j) {
            uint32_t v = j < len ? (uint32_t)(lut[seq[j]] & 7) : 5u;
            reg |= v << bits;
            bits += 3;
            if (bits >= 8) {
                *p++ = (uint8_t)(reg & 0xFF);
                reg >>= 8;
                bits -= 8;
            }
        }
        reg = 0;
        bits = 0;
        p = row + c3;
        for (int64_t j = 0; j < L; ++j) {
            uint32_t v = j < len ? (uint32_t)((q[j] & 0x7F) - qmin) : 0u;
            reg |= v << bits;
            bits += 6;
            if (bits >= 8) {
                *p++ = (uint8_t)(reg & 0xFF);
                reg >>= 8;
                bits -= 8;
            }
        }
        uint8_t* tail = row + c3 + q6;
        uint32_t l32 = (uint32_t)len_orig;
        tail[0] = (uint8_t)(l32 & 0xFF);
        tail[1] = (uint8_t)((l32 >> 8) & 0xFF);
        tail[2] = (uint8_t)((l32 >> 16) & 0xFF);
        tail[3] = (uint8_t)((l32 >> 24) & 0xFF);
        tail[4] = 1;
        tail[5] = qmin;
        tail[6] = tail[7] = 0;
        if (W > c3 + q6 + 8) row[W - 1] = 0;  // collision pad column
    }
    return misfit ? 0 : 1;
}

// bitpack2q wire: 3-bit codes + 2-bit indices into a per-row 4-entry
// QUALITY PALETTE (tail carries the palette ascending), then
// len_le32|valid|p0 p1 p2 p3|pad3 (+ pad columns: the caller bumps W
// past any valid 7-/6-bit width — the decoder distinguishes the three
// layouts by width alone).  A row fits iff it holds <= 4 distinct qual
// values — production Illumina corpora (NovaSeq/NextSeq RTA3 binning)
// emit exactly 4 levels, so this tier ships 5 bits/base (vs 9 for
// bitpack6, 10 for bitpack).  Returns 1 when every row fits, 0 on the
// first misfit (output is then partial garbage — the caller falls down
// the 6-bit -> 7-bit ladder).
int32_t hpgq_pack_bitwire2q(const uint8_t* buf, const int64_t* seq_starts,
                            const int64_t* q_starts, const int32_t* lens,
                            int64_t n, int64_t L, int64_t nrows, int64_t W,
                            const int8_t* lut, uint8_t* out,
                            int num_threads) {
    const int64_t c3 = 3 * L / 8;
    const int64_t q2 = L / 4;
    volatile int misfit = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(num_threads)
#endif
    for (int64_t i = 0; i < nrows; ++i) {
        if (i == 0) note_team(num_threads);  // the first thread's row
        if (misfit) continue;
        uint8_t* row = out + i * W;
        if (i >= n) {
            memset(row, 0, W);
            continue;
        }
        const int64_t len_orig = lens[i];
        int64_t len = len_orig;
        if (len > L) len = L;
        const uint8_t* seq = buf + seq_starts[i];
        const uint8_t* q = buf + q_starts[i];
        // distinct-value discovery via a 128-bit seen bitmap — one OR per
        // base, branch-free (the old per-base insertion scan made this
        // packer 3.4x slower than the 6-bit one); set-bit extraction
        // yields the palette already ascending
        uint64_t seen0 = 0, seen1 = 0;
        for (int64_t j = 0; j < len; ++j) {
            uint8_t v = q[j] & 0x7F;
            uint64_t bit = 1ull << (v & 63);
            if (v & 64) seen1 |= bit; else seen0 |= bit;
        }
        int np = __builtin_popcountll(seen0) + __builtin_popcountll(seen1);
        if (np > 4) {
            misfit = 1;
            continue;
        }
        uint8_t pal[4];
        int k = 0;
        for (uint64_t w = seen0; w; w &= w - 1)
            pal[k++] = (uint8_t)__builtin_ctzll(w);
        for (uint64_t w = seen1; w; w &= w - 1)
            pal[k++] = (uint8_t)(64 + __builtin_ctzll(w));
        for (; k < 4; ++k) pal[k] = np ? pal[np - 1] : 0;
        // 2-bit index per qual value via a 128-byte map (one load per
        // base instead of three compares)
        uint8_t qmap[128];
        memset(qmap, 0, sizeof(qmap));
        for (int m = 0; m < 4; ++m) qmap[pal[m]] = (uint8_t)(m < np ? m : np ? np - 1 : 0);
        uint32_t reg = 0;
        int bits = 0;
        uint8_t* p = row;
        for (int64_t j = 0; j < L; ++j) {
            uint32_t v = j < len ? (uint32_t)(lut[seq[j]] & 7) : 5u;
            reg |= v << bits;
            bits += 3;
            if (bits >= 8) {
                *p++ = (uint8_t)(reg & 0xFF);
                reg >>= 8;
                bits -= 8;
            }
        }
        reg = 0;
        bits = 0;
        p = row + c3;
        for (int64_t j = 0; j < L; ++j) {
            uint32_t v = j < len ? (uint32_t)qmap[q[j] & 0x7F] : 0u;
            reg |= v << bits;
            bits += 2;
            if (bits >= 8) {
                *p++ = (uint8_t)(reg & 0xFF);
                reg >>= 8;
                bits -= 8;
            }
        }
        uint8_t* tail = row + c3 + q2;
        uint32_t l32 = (uint32_t)len_orig;
        tail[0] = (uint8_t)(l32 & 0xFF);
        tail[1] = (uint8_t)((l32 >> 8) & 0xFF);
        tail[2] = (uint8_t)((l32 >> 16) & 0xFF);
        tail[3] = (uint8_t)((l32 >> 24) & 0xFF);
        tail[4] = 1;
        tail[5] = pal[0];
        tail[6] = pal[1];
        tail[7] = pal[2];
        tail[8] = pal[3];
        tail[9] = tail[10] = tail[11] = 0;
        for (int64_t b = c3 + q2 + 12; b < W; ++b) row[b] = 0;  // pads
    }
    return misfit ? 0 : 1;
}

// bitpack2c wire: 2-bit base codes + 2-bit qual-palette indices, then
// len_le32|valid|p0 p1 p2 p3|pad3 (+ pad columns past other families'
// widths — see hpgq.io.native.bitwire2c_width).  Bases A..T pack as
// 0..3; N and OTHER positions pack as 0 and are recorded in the
// exception sidecar `exc` as ((row * L + pos) << 1) | is_other, in
// row-major order — the device decode scatter-restores codes 4/5, so
// downstream kernels see EXACT codes.  Returns the exception count, or
// -1 when some row holds > 4 distinct qual values, or -2 when the
// exception capacity overflows (caller falls back to the 2q tier either
// way).  4.1 bits/base vs the 2q tier's 5 — the narrowest layout of
// the adaptive ladder.
int64_t hpgq_pack_bitwire2c(const uint8_t* buf, const int64_t* seq_starts,
                            const int64_t* q_starts, const int32_t* lens,
                            int64_t n, int64_t L, int64_t nrows, int64_t W,
                            const int8_t* lut, uint8_t* out, int32_t* exc,
                            int64_t exc_cap, int num_threads) {
    const int64_t c2 = L / 4;  // 2L/8 bytes of base codes
    const int64_t q2 = L / 4;  // 2L/8 bytes of qual indices
    if (num_threads < 1) num_threads = 1;
    // T exception slices keep the single pass parallel; each slice owns
    // a contiguous ascending row range, so concatenating the slices in
    // order yields the globally row-major list the device scatter wants
    // (sorted unique indices)
    int T = num_threads;
    if (T > 16) T = 16;
    if (nrows < T) T = (int)(nrows > 0 ? nrows : 1);
    std::vector<int64_t> counts((size_t)T, 0);
    const int64_t slice_cap = exc_cap / T;
    volatile int fail = 0;  // 1 = qual misfit, 2 = exception overflow
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(T)
#endif
    for (int t = 0; t < T; ++t) {  // every slice, whatever the team
        if (t == 0) note_team(T);
        // partition REAL rows over n (not nrows): the exception
        // slices are sized for an even spread of reads, and
        // padded rows carry none — splitting by nrows concentrated all
        // reads in the first threads and overflowed their slices when
        // nrows >> n (caught by the 2u differential tests)
        const int64_t lo = n * t / T;
        const int64_t hi = n * (t + 1) / T;
        const int64_t plo = n + (nrows - n) * t / T;
        const int64_t phi = n + (nrows - n) * (t + 1) / T;
        for (int64_t i = plo; i < phi; ++i) memset(out + i * W, 0, W);
        int32_t* my_exc = exc + t * slice_cap;
        int64_t my_cnt = 0;
        for (int64_t i = lo; i < hi && !fail; ++i) {
            uint8_t* row = out + i * W;
            const int64_t len_orig = lens[i];
            int64_t len = len_orig;
            if (len > L) len = L;
            const uint8_t* seq = buf + seq_starts[i];
            const uint8_t* q = buf + q_starts[i];
            uint64_t seen0 = 0, seen1 = 0;
            for (int64_t j = 0; j < len; ++j) {
                uint8_t v = q[j] & 0x7F;
                uint64_t bit = 1ull << (v & 63);
                if (v & 64) seen1 |= bit; else seen0 |= bit;
            }
            int np = __builtin_popcountll(seen0) + __builtin_popcountll(seen1);
            if (np > 4) {
                fail = 1;
                break;
            }
            uint8_t pal[4];
            int k = 0;
            for (uint64_t w = seen0; w; w &= w - 1)
                pal[k++] = (uint8_t)__builtin_ctzll(w);
            for (uint64_t w = seen1; w; w &= w - 1)
                pal[k++] = (uint8_t)(64 + __builtin_ctzll(w));
            for (; k < 4; ++k) pal[k] = np ? pal[np - 1] : 0;
            uint8_t qmap[128];
            memset(qmap, 0, sizeof(qmap));
            for (int m = 0; m < 4; ++m)
                qmap[pal[m]] = (uint8_t)(m < np ? m : np ? np - 1 : 0);
            // 2-bit base codes; N (4) / OTHER (5) emit an exception entry
            uint32_t reg = 0;
            int bits = 0;
            uint8_t* p = row;
            for (int64_t j = 0; j < L; ++j) {
                uint32_t c = 0;
                if (j < len) {
                    c = (uint32_t)(lut[seq[j]] & 7);
                    if (c >= 4) {
                        if (my_cnt >= slice_cap) {
                            fail = 2;
                            break;
                        }
                        my_exc[my_cnt++] =
                            (int32_t)((((i * L) + j) << 1) | (c == 5));
                        c = 0;
                    }
                }
                reg |= c << bits;
                bits += 2;
                if (bits >= 8) {
                    *p++ = (uint8_t)(reg & 0xFF);
                    reg >>= 8;
                    bits -= 8;
                }
            }
            if (fail) break;
            reg = 0;
            bits = 0;
            p = row + c2;
            for (int64_t j = 0; j < L; ++j) {
                uint32_t v = j < len ? (uint32_t)qmap[q[j] & 0x7F] : 0u;
                reg |= v << bits;
                bits += 2;
                if (bits >= 8) {
                    *p++ = (uint8_t)(reg & 0xFF);
                    reg >>= 8;
                    bits -= 8;
                }
            }
            uint8_t* tail = row + c2 + q2;
            uint32_t l32 = (uint32_t)len_orig;
            tail[0] = (uint8_t)(l32 & 0xFF);
            tail[1] = (uint8_t)((l32 >> 8) & 0xFF);
            tail[2] = (uint8_t)((l32 >> 16) & 0xFF);
            tail[3] = (uint8_t)((l32 >> 24) & 0xFF);
            tail[4] = 1;
            tail[5] = pal[0];
            tail[6] = pal[1];
            tail[7] = pal[2];
            tail[8] = pal[3];
            tail[9] = tail[10] = tail[11] = 0;
            for (int64_t b = c2 + q2 + 12; b < W; ++b) row[b] = 0;  // pads
        }
        counts[(size_t)t] = my_cnt;
    }
    if (fail) return fail == 1 ? -1 : -2;
    // compact the slices (serial; slices are small and ordered)
    int64_t total = counts[0];
    for (int t = 1; t < T; ++t) {
        if (counts[(size_t)t]) {
            memmove(exc + total, exc + (int64_t)t * slice_cap,
                    (size_t)counts[(size_t)t] * sizeof(int32_t));
        }
        total += counts[(size_t)t];
    }
    return total;
}

// bitpack2u wire ("uniform" tier): 2-bit base codes + 2-bit qual-palette
// indices as two bare bit-planes — NO per-row tail at all.  Applies when
// every read in the block has the SAME length Lu and the block-wide
// UNION of qual values fits one 4-entry palette (RTA3-binned uniform-
// length production runs — the overwhelmingly common shape).  Row width
// W = 4 * ceil(Lu/8) bytes (each plane padded to whole even bytes, spare
// bits zero); lengths, validity, and the palette travel as a tiny
// per-batch sidecar instead of 12+ bytes per row: 52 B per 100 bp read
// vs the 2c tier's 66.  N/OTHER positions pack as 0 with exception
// entries ((row * Lp + pos) << 1) | is_other where Lp = 8*ceil(Lu/8)
// (the decoder's padded field count).  Returns the exception count, or
// -1 (> 4 distinct quals in the union), -2 (exception overflow),
// -3 (non-uniform length) — caller falls back to the 2c tier.
int64_t hpgq_pack_bitwire2u(const uint8_t* buf, const int64_t* seq_starts,
                            const int64_t* q_starts, const int32_t* lens,
                            int64_t n, int64_t Lu, int64_t nrows,
                            const int8_t* lut, uint8_t* out, int32_t* exc,
                            int64_t exc_cap, uint8_t* pal_out,
                            int num_threads) {
    const int64_t L8 = (Lu + 7) / 8;
    const int64_t plane = 2 * L8;  // bytes per 2-bit plane
    const int64_t W = 4 * L8;
    const int64_t Lp = 8 * L8;
    if (num_threads < 1) num_threads = 1;
    int T = num_threads;
    if (T > 16) T = 16;
    if (nrows < T) T = (int)(nrows > 0 ? nrows : 1);
    // pass 1: block-wide qual-union bitmaps + uniform-length check
    std::vector<uint64_t> s0((size_t)T, 0), s1((size_t)T, 0);
    volatile int fail = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(T)
#endif
    for (int t = 0; t < T; ++t) {  // every slice, whatever the team
        if (t == 0) note_team(T);
        const int64_t lo = n * t / T;
        const int64_t hi = n * (t + 1) / T;
        uint64_t m0 = 0, m1 = 0;
        for (int64_t i = lo; i < hi && !fail; ++i) {
            if (lens[i] != Lu) {
                fail = 3;
                break;
            }
            const uint8_t* q = buf + q_starts[i];
            for (int64_t j = 0; j < Lu; ++j) {  // branch-free
                const uint32_t v = q[j] & 0x7F;
                m0 |= (uint64_t)(v < 64) << (v & 63);
                m1 |= (uint64_t)(v >> 6) << (v & 63);
            }
            // early bail: a single slice exceeding 4 distinct quals
            // already sinks the block-wide union — without this, every
            // batch of a uniform-length UNBINNED corpus (a very common
            // shape) paid a full n*Lu discovery scan per tier attempt
            if (__builtin_popcountll(m0) + __builtin_popcountll(m1) > 4) {
                fail = 1;
                break;
            }
        }
        s0[(size_t)t] = m0;
        s1[(size_t)t] = m1;
    }
    if (fail) return -fail;
    uint64_t seen0 = 0, seen1 = 0;
    for (int t = 0; t < T; ++t) {
        seen0 |= s0[(size_t)t];
        seen1 |= s1[(size_t)t];
    }
    int np = __builtin_popcountll(seen0) + __builtin_popcountll(seen1);
    if (np > 4) return -1;
    uint8_t pal[4];
    int k = 0;
    for (uint64_t w = seen0; w; w &= w - 1)
        pal[k++] = (uint8_t)__builtin_ctzll(w);
    for (uint64_t w = seen1; w; w &= w - 1)
        pal[k++] = (uint8_t)(64 + __builtin_ctzll(w));
    for (; k < 4; ++k) pal[k] = np ? pal[np - 1] : 0;
    for (int m = 0; m < 4; ++m) pal_out[m] = pal[m];
    uint8_t qmap[128];
    memset(qmap, 0, sizeof(qmap));
    for (int m = 0; m < 4; ++m)
        qmap[pal[m]] = (uint8_t)(m < np ? m : np ? np - 1 : 0);
    // pass 2: pack both planes + exceptions (T slices, row order)
    const int64_t full = Lu & ~(int64_t)3;  // bases in whole groups of four
    std::vector<int64_t> counts((size_t)T, 0);
    const int64_t slice_cap = exc_cap / T;
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(T)
#endif
    for (int t = 0; t < T; ++t) {  // every slice, whatever the team
        if (t == 0) note_team(T);
        // real rows partition over n; padded rows (exception-free) over
        // the remainder — see the matching comment in hpgq_pack_bitwire2c
        const int64_t lo = n * t / T;
        const int64_t hi = n * (t + 1) / T;
        const int64_t plo = n + (nrows - n) * t / T;
        const int64_t phi = n + (nrows - n) * (t + 1) / T;
        for (int64_t i = plo; i < phi; ++i) memset(out + i * W, 0, W);
        int32_t* my_exc = exc + t * slice_cap;
        int64_t my_cnt = 0;
        for (int64_t i = lo; i < hi && !fail; ++i) {
            uint8_t* row = out + i * W;
            const uint8_t* seq = buf + seq_starts[i];
            const uint8_t* q = buf + q_starts[i];
            // four 2-bit fields a byte, the first in the low bits; a
            // group of four bases inside the read takes the fast path
            // unless one is N or other (code 4 or 5: bit 2 set)
            uint8_t* p = row;
            int64_t j = 0;
            for (; j < full; j += 4) {
                uint32_t c[4] = {(uint32_t)(lut[seq[j]] & 7),
                                 (uint32_t)(lut[seq[j + 1]] & 7),
                                 (uint32_t)(lut[seq[j + 2]] & 7),
                                 (uint32_t)(lut[seq[j + 3]] & 7)};
                if ((c[0] | c[1] | c[2] | c[3]) & 4) {
                    for (int k = 0; k < 4; ++k) {
                        if (c[k] < 4) continue;
                        if (my_cnt >= slice_cap) {
                            fail = 2;
                            break;
                        }
                        my_exc[my_cnt++] = (int32_t)(
                            (((i * Lp) + j + k) << 1) | (c[k] == 5));
                        c[k] = 0;
                    }
                    if (fail) break;
                }
                *p++ = (uint8_t)(c[0] | c[1] << 2 | c[2] << 4 | c[3] << 6);
            }
            for (; j < Lp && !fail; j += 4) {  // the read's end, then pads
                uint32_t b = 0;
                for (int k = 0; k < 4; ++k) {
                    if (j + k >= Lu) break;
                    uint32_t c = (uint32_t)(lut[seq[j + k]] & 7);
                    if (c >= 4) {
                        if (my_cnt >= slice_cap) {
                            fail = 2;
                            break;
                        }
                        my_exc[my_cnt++] = (int32_t)(
                            (((i * Lp) + j + k) << 1) | (c == 5));
                        c = 0;
                    }
                    b |= c << (2 * k);
                }
                *p++ = (uint8_t)b;
            }
            if (fail) break;
            p = row + plane;
            for (j = 0; j < full; j += 4)
                *p++ = (uint8_t)(qmap[q[j] & 0x7F] |
                                 qmap[q[j + 1] & 0x7F] << 2 |
                                 qmap[q[j + 2] & 0x7F] << 4 |
                                 qmap[q[j + 3] & 0x7F] << 6);
            for (; j < Lp; j += 4) {
                uint32_t b = 0;
                for (int k = 0; k < 4 && j + k < Lu; ++k)
                    b |= (uint32_t)qmap[q[j + k] & 0x7F] << (2 * k);
                *p++ = (uint8_t)b;
            }
        }
        counts[(size_t)t] = my_cnt;
    }
    if (fail) return -(int64_t)fail;
    int64_t total = counts[0];
    for (int t = 1; t < T; ++t) {
        if (counts[(size_t)t]) {
            memmove(exc + total, exc + (int64_t)t * slice_cap,
                    (size_t)counts[(size_t)t] * sizeof(int32_t));
        }
        total += counts[(size_t)t];
    }
    return total;
}

// qn8 wire: one byte per base = (qual & 0x7F) | (is_N << 7), then
// len_le32|valid|pad3 (W = L + 8).  ASCII quality is always <= 126 so
// bit 7 is free to carry the N flag — the only thing the filter/edit
// verdict+trim kernels need from the sequence (stats_jnp.verdicts counts
// N via codes, every other criterion reads quality/length).  8 bits/base
// vs bitpack's 10 = ~20% fewer wire bytes for those commands.
void hpgq_pack_qnwire(const uint8_t* buf, const int64_t* seq_starts,
                      const int64_t* q_starts, const int32_t* lens,
                      int64_t n, int64_t L, int64_t nrows, const int8_t* lut,
                      uint8_t* out, int num_threads) {
    const int64_t W = L + 8;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(num_threads)
#endif
    for (int64_t i = 0; i < nrows; ++i) {
        if (i == 0) note_team(num_threads);  // the first thread's row
        uint8_t* row = out + i * W;
        if (i >= n) {
            memset(row, 0, W);
            continue;
        }
        const int64_t len_orig = lens[i];
        int64_t len = len_orig;
        if (len > L) len = L;
        const uint8_t* seq = buf + seq_starts[i];
        const uint8_t* q = buf + q_starts[i];
        for (int64_t j = 0; j < len; ++j) {
            row[j] = (uint8_t)((q[j] & 0x7F) |
                               ((lut[seq[j]] == 4 ? 1u : 0u) << 7));
        }
        if (len < L) memset(row + len, 0, (size_t)(L - len));
        uint8_t* tail = row + L;
        uint32_t l32 = (uint32_t)len_orig;
        tail[0] = (uint8_t)(l32 & 0xFF);
        tail[1] = (uint8_t)((l32 >> 8) & 0xFF);
        tail[2] = (uint8_t)((l32 >> 16) & 0xFF);
        tail[3] = (uint8_t)((l32 >> 24) & 0xFF);
        tail[4] = 1;
        tail[5] = tail[6] = tail[7] = 0;
    }
}

// Concatenate byte spans buf[starts[i]:ends[i]) into out.  Returns total
// bytes written.  The filter/edit writers express whole records (and
// trimmed record pieces) as span lists over the original chunk buffer, so
// output assembly is n memcpys instead of per-record Python string work.
int64_t hpgq_concat_spans(const uint8_t* buf, const int64_t* starts,
                          const int64_t* ends, int64_t n, uint8_t* out) {
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t len = ends[i] - starts[i];
        if (len <= 0) continue;
        memcpy(out + total, buf + starts[i], len);
        total += len;
    }
    return total;
}

int hpgq_abi_version(void) { return 10; }

}  // extern "C"
