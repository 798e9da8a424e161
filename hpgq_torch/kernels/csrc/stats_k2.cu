// K2: fused per-batch stats + inline-filter partials for long reads.
//
// Replaces hpgq/kernels/stats_pallas.py:_stats_kernel_blockwise (the TPU
// kernel K2, wrapper batch_partials_pallas_long).  It has K1's contract
// (csrc/stats_k1.cu) for any read length:
//
//   in:  codes int8 [B, L], quals uint8 [B, L], lens int32 [B],
//        valid uint8 [B];  L <= lcap, any lcap (no 65536 limit: the TPU's
//        came from VMEM, and the card keeps the outputs in device memory).
//   out: int64 scalars [8] (num_reads, acc_length, min_len, max_len,
//        num_passed, num_failed), int64 histograms (length [lcap+1],
//        quality [256], GC [101]), int64 per-position sums (coverage [lcap],
//        quality [lcap], bases [5, lcap]), the f32 mean quality of each
//        passing read (0 elsewhere) [B], and the pass mask uint8 [B].
//
// What bounds it: the bytes.  Every base up to each read's length is needed
// once (2 bytes a base, about 8 M bases in a 512 x 32768 batch of random
// lengths), against O(10) integer operations per base; with criteria the
// passing reads are needed a second time, after their verdict.  Read
// lengths vary from 2 kb to 90 kb, so one block per read would leave the
// longest read as every launch's tail.  Instead:
//
// * Both launches cut the batch into tiles of K2_ROWS rows x 512 columns;
//   each warp of a block takes every 8th row of the tile and each lane 16
//   consecutive columns, read with 16-byte loads (byte loads when a row is
//   not 16-byte aligned), K2_UNROLL rows in flight per warp.  A 90 kb
//   read costs no more tail than a 512-base chunk, and a batch of a few
//   reads still fills the card.  Tiles past every read's length exit at
//   once.
// * Launch A (stats_k2_rows): each warp reduces its rows' chunk sums (dp4a
//   and exact zero-byte tests, 32-bit, at most 512 bases) and adds them to
//   an int64 [B, 8] scratch.  The last tile of a row band to finish (a
//   per-band counter after __threadfence) evaluates the band's verdicts in
//   64-bit products, writes the pass mask and the rows' f32 means (the
//   IEEE quotient of the round-to-nearest conversions, as torch's
//   .to(torch.float32) makes them), and adds the rows' scalars and
//   histogram keys (integer math, [D1]) to the int64 outputs.
// * Criteria off: the pass mask is `valid`, known before the launch, so
//   launch A also adds the per-position sums and the batch is read once.
// * Launch B (stats_k2_positions), criteria on only, after A on the same
//   stream: the same tiles over the passing rows.
// * Per-position sums: each lane counts its 16 columns in byte lanes over
//   its rows of the tile (at most 16); the 8 warps store their counts in
//   shared memory (no shared atomics: 28k of them per tile took as long as
//   the sweep), and each tile adds its 512 columns to the int64 outputs
//   once.
// * The f32 mean-quality sum is left to the wrapper (a fixed-order sum of
//   the per-row means), so it is the same every run.
//
// The ragged entry (hpgq_k2_launch_ragged) takes a long-read block as its
// host packs it, one ragged 6-bit wire (hpgq_torch.io.native.
// ragged_layout): the reads longest first, each at its own length rounded
// up to 8 columns, 3 bytes of 3-bit codes and 6 bytes of 6-bit qualities
// (less the row's qbase) an 8-column group, found by a row table of
// offsets, lengths, qbases and valid flags.  Its tiles are the plain
// entry's over those rows; each lane loads its 16 columns' 6 + 12 bytes by
// 32-bit words and spreads them into the byte lanes the plain entry loads,
// so the sums are the plain entry's code.  Rows come longest first, so a
// band's first row is its longest and every tile past it exits at once.
// The wire is read as the host sent it, about 1.1 bytes a base, where the
// plain entry reads 2 bytes a base that torch ops decoded and padded
// first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (no --use_fast_math: the mean must be the IEEE quotient).  The host entry
// point has a plain C ABI and returns cudaGetLastError().

#include <climits>

#include "stats_common.cuh"

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_ROWS 128          // rows per tile: 16 per warp (byte lanes)
#define K2_COLS 512          // columns per tile: 16 per lane
#define K2_FIELDS 8          // scratch sums per row
#define K2_UNROLL 4          // rows a warp has in flight

#define K2_BYTES 0      // plain entry, rows not 16-byte aligned
#define K2_VEC 1        // plain entry, 16-byte loads
#define K2_RAGGED 2     // ragged entry

namespace {

struct K2Args {
    const int8_t* codes;
    const uint8_t* quals;
    const int32_t* lens;
    const uint8_t* valid;
    const uint8_t* wire;      // ragged entry: the rows
    const long long* row_off; // ragged entry: each row's offset in `wire`
    const uint8_t* qbase;     // ragged entry: each row's quality base
    int B, L, lcap;
    K1Crit cr;
    long long* scalars;
    long long* length_hist;
    long long* quality_hist;
    long long* gc_hist;
    long long* cov;
    long long* qpn;
    long long* bpn;
    long long* row_sums;      // scratch [B, K2_FIELDS], zeroed
    unsigned* band_done;      // scratch [ceil(B / K2_ROWS)], zeroed
    float* row_mean;
    uint8_t* pass_out;
};

// Four 3-bit fields (12 bits) into the bytes of a word.
__device__ __forceinline__ unsigned spread3(unsigned b) {
    return (b & 7u) | ((b >> 3) & 7u) << 8 | ((b >> 6) & 7u) << 16 |
           ((b >> 9) & 7u) << 24;
}

// Four 6-bit fields (24 bits) into the bytes of a word.
__device__ __forceinline__ unsigned spread6(unsigned b) {
    return (b & 63u) | ((b >> 6) & 63u) << 8 | ((b >> 12) & 63u) << 16 |
           ((b >> 18) & 63u) << 24;
}

// Row `row`'s columns [c0, c0+16) from the ragged wire, c0 a multiple of
// 16 below the row's length: codes, 6 bytes at 6 k of the row (k = c0 /
// 16), and qualities, 12 bytes at 12 k of the row's 4-byte aligned
// qualities, by 32-bit loads (a read past the row's last group lands in
// the next row or the wire's tail; those columns are masked by n).
__device__ __forceinline__ void load16_ragged(const K2Args& a, int row,
                                              int c0, unsigned cw[4],
                                              unsigned qw[4]) {
    const int groups = (a.lens[row] + 7) >> 3;
    const uint8_t* base = a.wire + a.row_off[row];
    const int cb = 6 * (c0 >> 4);
    const unsigned* cp = reinterpret_cast<const unsigned*>(base + (cb & ~3));
    const unsigned long long c48 =
        (((unsigned long long)__ldg(cp + 1) << 32) | __ldg(cp)) >>
        (8 * (cb & 3));
    const unsigned* qp = reinterpret_cast<const unsigned*>(
        base + (3 * groups + 3) / 4 * 4 + 12 * (c0 >> 4));
    const unsigned q0 = __ldg(qp), q1 = __ldg(qp + 1), q2 = __ldg(qp + 2);
    const unsigned qb = 0x01010101u * a.qbase[row];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        cw[i] = spread3((unsigned)(c48 >> (12 * i)) & 0xFFFu);
    // no carry: a field is at most 63 and a qbase at most 127
    qw[0] = spread6(q0 & 0xFFFFFFu) + qb;
    qw[1] = spread6(((q0 >> 24) | (q1 << 8)) & 0xFFFFFFu) + qb;
    qw[2] = spread6(((q1 >> 16) | (q2 << 16)) & 0xFFFFFFu) + qb;
    qw[3] = spread6(q2 >> 8) + qb;
}

// Load 16 codes and quals at columns [c0, c0+16) of row `row` (positions
// at or past n load as 0 or as the row's padding; they are masked by n
// anyway).
template <int MODE>
__device__ __forceinline__ void load16(const K2Args& a, int row, int c0,
                                       int n, unsigned cw[4], unsigned qw[4]) {
    if (MODE == K2_RAGGED) {
        load16_ragged(a, row, c0, cw, qw);
        return;
    }
    const int8_t* crow = a.codes + (size_t)row * a.L;
    const uint8_t* qrow = a.quals + (size_t)row * a.L;
    if (MODE == K2_VEC) {
        const uint4 c4 = *reinterpret_cast<const uint4*>(crow + c0);
        const uint4 q4 = *reinterpret_cast<const uint4*>(qrow + c0);
        cw[0] = c4.x; cw[1] = c4.y; cw[2] = c4.z; cw[3] = c4.w;
        qw[0] = q4.x; qw[1] = q4.y; qw[2] = q4.z; qw[3] = q4.w;
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) cw[i] = qw[i] = 0;
        for (int j = 0; j < 16 && c0 + j < n; ++j) {
            cw[j >> 2] |= (unsigned)(uint8_t)crow[c0 + j] << (8 * (j & 3));
            qw[j >> 2] |= (unsigned)qrow[c0 + j] << (8 * (j & 3));
        }
    }
}

// One row's 16 columns into the lane's packed per-position sums.
__device__ __forceinline__ void add_positions(PackedCols pk[4],
                                              const unsigned cw[4],
                                              const unsigned qw[4], int k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) packed_add(pk[i], cw[i], qw[i], k - 4 * i);
}

// The tile's per-position sums: each warp stores its lanes' packed words
// in shared memory (no atomics), then each thread sums one column over the
// warps and adds it to the int64 outputs, once per non-zero field.
#define K2_PACKED 32  // words of PackedCols[4] per lane
__device__ __forceinline__ void flush_positions(
    const PackedCols pk[4], unsigned* s_st, int L, int lcap, int col0,
    long long* cov, long long* qpn, long long* bpn) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned* mine = s_st + warp * K2_PACKED * 32 + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        mine[(0 + i) * 32] = pk[i].cov;
#pragma unroll
        for (int b = 0; b < 5; ++b) mine[(4 + 4 * b + i) * 32] = pk[i].b[b];
        mine[(24 + i) * 32] = pk[i].qe;
        mine[(28 + i) * 32] = pk[i].qo;
    }
    __syncthreads();
    for (int c = tid; c < K2_COLS && col0 + c < L; c += K2_THREADS) {
        const int src = c >> 4, i = (c >> 2) & 3, j = c & 3;
        const int sh = 8 * j, qsh = 16 * (j >> 1);
        const unsigned* col = s_st + src;
        int v[7] = {0, 0, 0, 0, 0, 0, 0};
#pragma unroll
        for (int w = 0; w < K2_WARPS; ++w) {
            const unsigned* ws = col + w * K2_PACKED * 32;
            v[0] += (ws[i * 32] >> sh) & 0xFF;
            v[1] += (ws[((j & 1 ? 28 : 24) + i) * 32] >> qsh) & 0xFFFF;
#pragma unroll
            for (int b = 0; b < 5; ++b)
                v[2 + b] += (ws[(4 + 4 * b + i) * 32] >> sh) & 0xFF;
        }
        if (!v[0]) continue;  // no row covers the column
        add_u64(&cov[col0 + c], v[0]);
        add_u64(&qpn[col0 + c], v[1]);
#pragma unroll
        for (int b = 0; b < 5; ++b)
            if (v[2 + b]) add_u64(&bpn[(size_t)b * lcap + col0 + c], v[2 + b]);
    }
}

// Add 1 per lane of `mask` (all of which call this) to hist[key], one
// global atomic per distinct key (key < 0: nothing).
__device__ __forceinline__ void hist_add64(long long* hist, long long key,
                                           unsigned mask) {
    const unsigned same = __match_any_sync(mask, key);
    if ((threadIdx.x & 31) == __ffs(same) - 1 && key >= 0)
        add_u64(&hist[key], __popc(same));
}

// The verdicts and the row outputs of the band's rows [r0, r0+rows), one
// row per thread, from the summed scratch; scalars and histogram keys are
// aggregated per warp before they reach the int64 outputs.
__device__ void finish_band(const K2Args& a, int r0, int rows) {
    for (int base = 0; base < rows; base += K2_THREADS) {
        const int r = base + threadIdx.x;
        const int row = r0 + r;
        long long s[K2_FIELDS] = {0, 0, 0, 0, 0, 0, 0, 0};
        int len = 0;
        bool vrow = false;
        if (r < rows) {
            const long long* rs = a.row_sums + (size_t)row * K2_FIELDS;
#pragma unroll
            for (int k = 0; k < K2_FIELDS; ++k) s[k] = __ldcg(&rs[k]);
            len = a.lens[row];
            vrow = a.valid[row] != 0;
        }
        bool passed = vrow;
        int pass = 0, fail = 0;
        if (a.cr.on && vrow) {
            passed = row_ok(s[0], s[1], s[3], s[4], s[5], s[6], s[7], len,
                            a.cr);
            pass = passed;
            fail = !passed;
        }
        float mean = 0.f;
        if (passed && len > 0)
            mean = __fdiv_rn(__ll2float_rn(s[0]),
                             __ll2float_rn((long long)len));
        if (r < rows) {
            a.pass_out[row] = passed ? 1 : 0;
            a.row_mean[row] = mean;
        }
        // [D1] integer round-half-up of the rational mean; integer GC%,
        // none for zero-length reads
        const long long L64 = len;
        const long long qkey = passed
            ? min(max((2 * s[0] + L64) / max(2 * L64, 1LL), 0LL),
                  (long long)HPGQ_QUAL_BINS - 1) : -1;
        const long long gkey = passed && len > 0
            ? min(max((100 * s[2]) / L64, 0LL), (long long)HPGQ_GC_BINS - 1)
            : -1;
        const long long lkey = passed ? min(max(len, 0), a.lcap) : -1;
        hist_add64(a.length_hist, lkey, 0xffffffffu);
        hist_add64(a.quality_hist, qkey, 0xffffffffu);
        hist_add64(a.gc_hist, gkey, 0xffffffffu);
        int reads = passed, mn = passed ? len : HPGQ_MIN_LENGTH_INIT;
        int mx = passed ? len : 0;
        long long acc_len = passed ? len : 0;
        for (int o = 16; o > 0; o >>= 1) {
            reads += __shfl_xor_sync(0xffffffffu, reads, o);
            pass += __shfl_xor_sync(0xffffffffu, pass, o);
            fail += __shfl_xor_sync(0xffffffffu, fail, o);
            acc_len += __shfl_xor_sync(0xffffffffu, acc_len, o);
            mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
            mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        if ((threadIdx.x & 31) == 0) {
            if (reads) {
                add_u64(&a.scalars[S_NUM_READS], reads);
                add_u64(&a.scalars[S_ACC_LENGTH], acc_len);
                atomicMin(&a.scalars[S_MIN_LEN], (long long)mn);
                atomicMax(&a.scalars[S_MAX_LEN], (long long)mx);
            }
            if (pass) add_u64(&a.scalars[S_NUM_PASSED], pass);
            if (fail) add_u64(&a.scalars[S_NUM_FAILED], fail);
        }
    }
}

// The tile's rows into shared memory (length, min(length, L), and the
// valid flag, or the pass mask for launch B); true when any selected row
// reaches the tile's columns (the same answer in every thread).
__device__ __forceinline__ bool tile_rows(const K2Args& a, int r0, int col0,
                                          int* s_len, int* s_n, int* s_ok,
                                          bool by_pass) {
    const int r = threadIdx.x;
    int len = 0, ok = 0;
    if (r < K2_ROWS && r0 + r < a.B) {
        len = a.lens[r0 + r];
        ok = by_pass ? a.pass_out[r0 + r] : a.valid[r0 + r];
    }
    const int n = min(max(len, 0), a.L);
    if (r < K2_ROWS) {
        s_len[r] = len;
        s_n[r] = n;
        s_ok[r] = ok;
    }
    return __syncthreads_or(n > col0 && (ok || !by_pass));
}

// Launch A: per-row chunk sums (+ the per-position sums when POS, i.e.
// criteria off), then the band's verdicts in its last tile.  Each warp
// loads K2_UNROLL rows before it works on them, so several rows' loads
// are in flight.
template <int MODE, bool POS>
__global__ void __launch_bounds__(K2_THREADS)
stats_k2_rows(const K2Args a) {
    __shared__ unsigned s_st[POS ? K2_WARPS * K2_PACKED * 32 : 1];
    __shared__ int s_len[K2_ROWS], s_n[K2_ROWS], s_ok[K2_ROWS];
    __shared__ int s_last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r0 = blockIdx.y * K2_ROWS;
    const int col0 = blockIdx.x * K2_COLS;
    const int c0 = col0 + 16 * lane;
    const bool extra = crit_extra(a.cr);
    PackedCols pk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) packed_zero(pk[i]);
    const bool work = tile_rows(a, r0, col0, s_len, s_n, s_ok, false);
    for (int rb = warp; work && rb < K2_ROWS; rb += K2_WARPS * K2_UNROLL) {
        unsigned cw[K2_UNROLL][4], qw[K2_UNROLL][4];
#pragma unroll
        for (int u = 0; u < K2_UNROLL; ++u) {
            const int r = rb + u * K2_WARPS;
            const int n = r < K2_ROWS ? s_n[r] : 0;
            if (c0 < n) load16<MODE>(a, r0 + r, c0, n, cw[u], qw[u]);
        }
#pragma unroll
        for (int u = 0; u < K2_UNROLL; ++u) {
            const int r = rb + u * K2_WARPS;
            if (r >= K2_ROWS) break;
            const int n = s_n[r];
            if (n <= col0) continue;  // the whole warp: n is uniform
            RowSums s = {0, 0, 0, 0, 0, 0, 0, 0};
            if (c0 < n) {
                add_chunk(s, cw[u], qw[u], c0, n, s_len[r], a.cr, extra);
                if (POS && s_ok[r]) add_positions(pk, cw[u], qw[u], n - c0);
            }
            const int v[K2_FIELDS] = {s.qsum, s.nn, s.ngc, s.wq,
                                      s.wl, s.oq, s.ls, s.rs};
            long long* rs = a.row_sums + (size_t)(r0 + r) * K2_FIELDS;
#pragma unroll
            for (int k = 0; k < K2_FIELDS; ++k) {
                if (k >= 3 && !extra) break;
                const int t = warp_sum(v[k]);
                if (lane == 0 && t) add_u64(&rs[k], t);
            }
        }
    }
    if (POS && work)
        flush_positions(pk, s_st, a.L, a.lcap, col0, a.cov, a.qpn, a.bpn);

    // the band's last tile to finish evaluates its rows
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        s_last = atomicAdd(&a.band_done[blockIdx.y], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    finish_band(a, r0, min(K2_ROWS, a.B - r0));
}

// Launch B (criteria on): the per-position sums over the passing rows.
template <int MODE>
__global__ void __launch_bounds__(K2_THREADS)
stats_k2_positions(const K2Args a) {
    __shared__ unsigned s_st[K2_WARPS * K2_PACKED * 32];
    __shared__ int s_len[K2_ROWS], s_n[K2_ROWS], s_ok[K2_ROWS];
    const int warp = threadIdx.x >> 5;
    const int r0 = blockIdx.y * K2_ROWS;
    const int col0 = blockIdx.x * K2_COLS;
    const int c0 = col0 + 16 * (threadIdx.x & 31);
    if (!tile_rows(a, r0, col0, s_len, s_n, s_ok, true)) return;
    PackedCols pk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) packed_zero(pk[i]);
    for (int rb = warp; rb < K2_ROWS; rb += K2_WARPS * K2_UNROLL) {
        unsigned cw[K2_UNROLL][4], qw[K2_UNROLL][4];
        int k[K2_UNROLL];
#pragma unroll
        for (int u = 0; u < K2_UNROLL; ++u) {
            const int r = rb + u * K2_WARPS;
            const int n = r < K2_ROWS && s_ok[r] ? s_n[r] : 0;
            k[u] = n - c0;
            if (k[u] > 0) load16<MODE>(a, r0 + r, c0, n, cw[u], qw[u]);
        }
#pragma unroll
        for (int u = 0; u < K2_UNROLL; ++u)
            if (k[u] > 0) add_positions(pk, cw[u], qw[u], k[u]);
    }
    flush_positions(pk, s_st, a.L, a.lcap, col0, a.cov, a.qpn, a.bpn);
}

template <int MODE>
cudaError_t k2_launch(const K2Args& a, cudaStream_t s) {
    // at least one tile per band: with L == 0 it still gives the verdicts
    const dim3 grid(a.L > 0 ? (a.L + K2_COLS - 1) / K2_COLS : 1,
                    (a.B + K2_ROWS - 1) / K2_ROWS);
    if (a.cr.on) {
        stats_k2_rows<MODE, false><<<grid, K2_THREADS, 0, s>>>(a);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        stats_k2_positions<MODE><<<grid, K2_THREADS, 0, s>>>(a);
    } else {
        stats_k2_rows<MODE, true><<<grid, K2_THREADS, 0, s>>>(a);
    }
    return cudaGetLastError();
}

// The arguments both entries share; false when B, L or lcap are out of
// range.
bool k2_args(K2Args& a, const void* lens, const void* valid, int B, int L,
             int lcap, K1Crit crit, void* scalars, void* length_hist,
             void* quality_hist, void* gc_hist, void* cov, void* qpn,
             void* bpn, void* scratch, void* row_mean, void* pass_out) {
    const long long bands = ((long long)B + K2_ROWS - 1) / K2_ROWS;
    if (L < 0 || L > lcap || L > INT_MAX - K2_COLS || bands > 65535)
        return false;
    a = K2Args{};
    a.lens = (const int32_t*)lens;
    a.valid = (const uint8_t*)valid;
    a.B = B;
    a.L = L;
    a.lcap = lcap;
    a.cr = crit;
    a.scalars = (long long*)scalars;
    a.length_hist = (long long*)length_hist;
    a.quality_hist = (long long*)quality_hist;
    a.gc_hist = (long long*)gc_hist;
    a.cov = (long long*)cov;
    a.qpn = (long long*)qpn;
    a.bpn = (long long*)bpn;
    a.row_sums = (long long*)scratch;
    a.band_done = (unsigned*)((long long*)scratch + (size_t)B * K2_FIELDS);
    a.row_mean = (float*)row_mean;
    a.pass_out = (uint8_t*)pass_out;
    return true;
}

}  // namespace

extern "C" {

// Scratch K2 needs beside its outputs, in int64 slots: the [B, 8] row sums
// and the per-band counters (zeroed by the caller).
long long hpgq_k2_scratch_slots(int B) {
    const long long bands = ((long long)B + K2_ROWS - 1) / K2_ROWS;
    return (long long)B * K2_FIELDS + (bands + 1) / 2;
}

// Launch K2 on `stream`: launch A, and launch B when the criteria are on.
// The int64 outputs and the scratch must arrive zeroed, with
// scalars[S_MIN_LEN] = 100000; row_mean has B floats.  Returns
// cudaGetLastError() after the launches (0 = launched).
int hpgq_k2_launch(const void* codes, const void* quals, const void* lens,
                   const void* valid, int B, int L, int lcap, K1Crit crit,
                   void* scalars, void* length_hist, void* quality_hist,
                   void* gc_hist, void* cov, void* qpn, void* bpn,
                   void* scratch, void* row_mean, void* pass_out,
                   void* stream) {
    if (B <= 0) return (int)cudaSuccess;
    K2Args a;
    if (!k2_args(a, lens, valid, B, L, lcap, crit, scalars, length_hist,
                 quality_hist, gc_hist, cov, qpn, bpn, scratch, row_mean,
                 pass_out))
        return (int)cudaErrorInvalidValue;
    a.codes = (const int8_t*)codes;
    a.quals = (const uint8_t*)quals;
    const bool vec = L % 16 == 0 && (uintptr_t)codes % 16 == 0 &&
                     (uintptr_t)quals % 16 == 0;
    return (int)(vec ? k2_launch<K2_VEC>(a, (cudaStream_t)stream)
                     : k2_launch<K2_BYTES>(a, (cudaStream_t)stream));
}

// Launch K2's ragged entry on `stream` over a ragged 6-bit wire of B rows
// (hpgq_torch.io.native.ragged_layout): `wire` its rows (4-byte aligned,
// with 16 readable bytes after the last), `row_off` int64 [B], `lens`
// int32 [B] (at most L), `qbase` and `valid` uint8 [B]; the outputs as
// hpgq_k2_launch's.  Returns cudaGetLastError() after the launches.
int hpgq_k2_launch_ragged(const void* wire, const void* row_off,
                          const void* lens, const void* qbase,
                          const void* valid, int B, int L, int lcap,
                          K1Crit crit, void* scalars, void* length_hist,
                          void* quality_hist, void* gc_hist, void* cov,
                          void* qpn, void* bpn, void* scratch,
                          void* row_mean, void* pass_out, void* stream) {
    if (B <= 0) return (int)cudaSuccess;
    K2Args a;
    if ((uintptr_t)wire % 4 || (uintptr_t)row_off % 8 ||
        !k2_args(a, lens, valid, B, L, lcap, crit, scalars, length_hist,
                 quality_hist, gc_hist, cov, qpn, bpn, scratch, row_mean,
                 pass_out))
        return (int)cudaErrorInvalidValue;
    a.wire = (const uint8_t*)wire;
    a.row_off = (const long long*)row_off;
    a.qbase = (const uint8_t*)qbase;
    return (int)k2_launch<K2_RAGGED>(a, (cudaStream_t)stream);
}

}  // extern "C"
