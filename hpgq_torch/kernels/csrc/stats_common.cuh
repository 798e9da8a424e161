// What K1 (stats_k1.cu) and K2 (stats_k2.cu) share: the criteria struct,
// the fastq_filter verdict in 64-bit products, the per-read sums over a
// 16-byte chunk of codes and quals, and a few byte-lane (SWAR) helpers.
//
// Exactness: every helper here is exact for any byte value of codes and
// quals, so the kernels agree with the plain twin
// (stats_torch.fused_partials) on every integer field.  (Bit-plane tests
// that assume codes below 8 were tried and ran slower on the card.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HPGQ_QUAL_BINS 256
#define HPGQ_GC_BINS 101
#define HPGQ_MIN_LENGTH_INIT 100000  // reference init, src/stats_fastq.c:24

// scalar slots of the int64 output (the wrapper reads 0..5; 6 and 7 are
// the kernels' own scratch)
#define S_NUM_READS 0
#define S_ACC_LENGTH 1
#define S_MIN_LEN 2
#define S_MAX_LEN 3
#define S_NUM_PASSED 4
#define S_NUM_FAILED 5
#define S_DONE 6        // K1: blocks finished (the last one finalises)
#define S_NEG_MIN 7     // K1: max over blocks of (INIT - min length)

// Substituted filter criteria (hpgq_torch.options.FilterCriteria.
// substituted()), with an on/off flag per optional check.  `on` == 0 means
// no filter: every valid row passes and num_passed/num_failed stay 0.
// Mirrored by hpgq_torch.kernels.build.K1Crit.
struct K1Crit {
    int on;
    int min_len, max_len;
    int min_q, max_q;          // mean read quality bounds
    int oq_on, max_oq;         // max out-of-quality bases
    int qwin_on, begin, end;   // [D8] quality position window
    int left_len, min_lq, max_lq;    // left window (left_len 0 = off)
    int right_len, min_rq, max_rq;   // right window (right_len 0 = off)
    int max_n;
    int phred;
};

// True when the verdict needs more than the quality sum, the N count and
// the length: the window, out-of-quality and left/right checks, which the
// chunk sums then evaluate base by base.
__host__ __device__ inline bool crit_extra(const K1Crit& cr) {
    return cr.on && (cr.qwin_on || cr.oq_on || cr.left_len > 0 ||
                     cr.right_len > 0);
}

// Per-read sums over positions [0, min(len, L)).  32 bits: a K1 row has at
// most 4096 bases, a K2 chunk at most 512.
struct RowSums {
    int qsum, nn, ngc;   // quality sum, N count, G+C count
    int wq, wl, oq;      // quality-window sum and width, out-of-quality count
    int ls, rs;          // left / right window quality sums
};

__device__ __forceinline__ void add_u64(long long* p, long long v) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(v));
}

__device__ __forceinline__ bool in_bounds(long long qn, long long w, int lo,
                                          int hi) {
    return (long long)lo * w <= qn && qn <= (long long)hi * w;
}

// fastq_filter verdict [D2][D3][D8] in 64-bit products, so the MAX
// sentinel (100000) times any length cannot wrap.  Sums are 64-bit so K2's
// whole-read totals fit.
__device__ inline bool row_ok(long long qsum, long long nn, long long wq,
                              long long wl, long long oq, long long ls,
                              long long rs, int len, const K1Crit& cr) {
    const long long ph = cr.phred;
    bool ok = len >= cr.min_len && len <= cr.max_len;
    const long long wlen = cr.qwin_on ? wl : (long long)len;
    const long long wqs = cr.qwin_on ? wq : qsum;
    ok = ok && in_bounds(wqs - ph * wlen, wlen, cr.min_q, cr.max_q);
    if (cr.oq_on) ok = ok && oq <= cr.max_oq;
    if (cr.left_len > 0) {
        const long long w = min(len, cr.left_len);
        ok = ok && in_bounds(ls - ph * w, w, cr.min_lq, cr.max_lq);
    }
    if (cr.right_len > 0) {
        const long long w = min(len, cr.right_len);
        ok = ok && in_bounds(rs - ph * w, w, cr.min_rq, cr.max_rq);
    }
    return ok && nn <= cr.max_n;
}

// 0x80 in each byte of x that is zero, 0 elsewhere (exact: no carry crosses
// a byte, since (x & 0x7F) + 0x7F <= 0xFE).
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
    return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// 0xFF in the first k bytes of a word (k clamped to 0..4).
__device__ __forceinline__ unsigned byte_mask(int k) {
    return k <= 0 ? 0u : k >= 4 ? 0xFFFFFFFFu : (1u << (8 * k)) - 1u;
}

__device__ __forceinline__ int warp_sum(int v, unsigned mask = 0xffffffffu,
                                        int width = 32) {
    for (int o = width / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(mask, v, o, width);
    return v;
}

// Add the bases at positions p0..p0+15 with p < n (codes in cw[0..3],
// quals in qw[0..3], little-endian) to the read sums.  `extra`
// (crit_extra) adds the window and out-of-quality sums base by base.
__device__ __forceinline__ void add_chunk(RowSums& s, const unsigned cw[4],
                                          const unsigned qw[4], int p0, int n,
                                          int len, const K1Crit& cr,
                                          bool extra) {
    const int k = n - p0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const unsigned m = byte_mask(k - 4 * i);
        if (!m) break;
        s.qsum = (int)__dp4a(qw[i] & m, 0x01010101u, (unsigned)s.qsum);
        const unsigned c = cw[i] | ~m;  // masked bytes match no code
        s.nn += __popc(zero_bytes(c ^ 0x04040404u));
        s.ngc += __popc(zero_bytes(c ^ 0x01010101u) |
                        zero_bytes(c ^ 0x02020202u));
    }
    if (!extra) return;
    for (int j = 0; j < 16 && j < k; ++j) {
        const int p = p0 + j;
        const int q = (qw[j >> 2] >> (8 * (j & 3))) & 0xFF;
        if (!cr.qwin_on || (p >= cr.begin && p < cr.end)) {
            s.wq += q;
            s.wl += 1;
            const int nq = q - cr.phred;
            s.oq += (nq < cr.min_q) | (nq > cr.max_q);
        }
        // left window: p < min(len, left_len); right window:
        // p >= len - min(len, right_len), i.e. p >= len - right_len
        if (p < cr.left_len) s.ls += q;
        if (p >= len - cr.right_len) s.rs += q;
    }
}

// Per-position sums of four columns in byte lanes: cov and the five base
// counts in 8-bit lanes (at most 255 rows between unpacks), the quality
// sums in two 16-bit-lane words (even and odd columns, 257 rows).
struct PackedCols {
    unsigned cov, b[5], qe, qo;
};

__device__ __forceinline__ void packed_zero(PackedCols& a) {
    a.cov = a.qe = a.qo = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) a.b[k] = 0;
}

// One row's four columns: the first `k` of them count (k <= 0: none).
__device__ __forceinline__ void packed_add(PackedCols& a, unsigned cw,
                                           unsigned qw, int k) {
    const unsigned m = byte_mask(k);
    const unsigned c = cw | ~m;  // masked bytes match no code
    a.cov += m & 0x01010101u;
#pragma unroll
    for (int b = 0; b < 5; ++b)
        a.b[b] += zero_bytes(c ^ (0x01010101u * (unsigned)b)) >> 7;
    const unsigned q = qw & m;
    a.qe += q & 0x00FF00FFu;
    a.qo += (q >> 8) & 0x00FF00FFu;
}

// Column j (0..3) of the packed sums: cov, qual sum, base counts 0..4.
__device__ __forceinline__ void packed_col(const PackedCols& a, int j,
                                           int out[7]) {
    const int sh = 8 * j;
    out[0] = (a.cov >> sh) & 0xFF;
    out[1] = ((j & 1 ? a.qo : a.qe) >> (16 * (j >> 1))) & 0xFFFF;
#pragma unroll
    for (int b = 0; b < 5; ++b) out[2 + b] = (a.b[b] >> sh) & 0xFF;
}
