// K1: fused per-batch stats + inline-filter partials for short reads.
//
// Replaces hpgq/kernels/stats_pallas.py:_stats_kernel (the TPU kernel K1,
// wrapper batch_partials_pallas).  Same contract, rethought for Hopper:
//
//   in (plain entry): codes int8 [B, ld], quals uint8 [B, ld] (ASCII <
//        128), lens int32 [B], valid uint8 [B];  L <= lcap <= 4096, any L,
//        the first L columns of each row read; rows ld bytes apart, ld a
//        multiple of 16 at least L, both arrays 16-byte aligned (the
//        wrapper pads a batch that is not).
//   in (2u entry): the 2u wire of hpgq_torch.io.packer.try_pack_block_2u:
//        planes uint8 [B, W] (2-bit codes | 2-bit palette indices, Lp =
//        2W fields each), the int32 exception sidecar ((row*Lp + pos) << 1
//        | is_other, ascending as the packers write it, padded with
//        sentinels >= B*Lp), the 4-entry palette, n_valid and the uniform
//        length L; rows < n_valid have length L, the rest are padding.
//   out: int64 scalars [8] (num_reads, acc_length, min_len, max_len,
//        num_passed, num_failed; 6-7 are scratch), int64 histograms
//        (length [lcap+1], quality [256], GC [101]), int64 per-position sums
//        (coverage [lcap], quality [lcap], bases [5, lcap]), int64 base
//        totals [5], f32 per-tile mean-quality partials and their sum, and
//        the per-read pass mask uint8 [B].
//
// What bounds it: every input byte is needed once (2*B*L bytes, 33.5 MB for
// the 131072 x 128 main-path batch, or 0.5 byte per base on the 2u wire),
// against O(10) integer operations per base, so at the main shape the
// bytes and the operations take about the same time (~10 us each).  The
// design:
//
// * Persistent blocks: a few per SM (occupancy, at most K1_BLOCKS_PER_SM),
//   each walking a contiguous run of row tiles in order, so the f32
//   partials have a fixed order and a block's 2u exceptions are one
//   contiguous run of the sidecar.
// * Tiles staged in shared memory: whole rows by 16-byte cp.async,
//   double-buffered so the next tile's copy overlaps this tile's work,
//   with the next tile's lengths loaded into registers meanwhile.  Rows
//   sit S bytes apart, S = 16*min(T,8) past a multiple of 128, so the T
//   threads of a row and the rows of a quarter-warp read disjoint banks.
//   The 2u entry stages the
//   wire itself (0.5 byte per base), decodes it in shared memory with two
//   256-entry tables, and applies the tile's exceptions from a window of
//   the sidecar staged one tile ahead (a 256-way search finds the run's
//   start once per block).
// * Phase 1, T = 256/TR threads per row: byte-lane sums of 16-byte chunks
//   (dp4a for the quality sum, exact zero-byte tests for N and G+C), a
//   segment shuffle, and the row's first thread evaluates the verdict in
//   64-bit products, the IEEE f32 mean (__fdiv_rn) and the histogram keys
//   (integer math, [D1]) into shared-memory histograms.
// * Phase 2, per-position sums over the tile's passing rows: each thread
//   owns four columns (one word) and a share of the rows, counts in byte
//   lanes, and keeps its column sums in registers for all of its tiles.
// * Sums and histograms stay in shared memory for the block's whole life
//   and go to the int64 outputs once per block, not once per tile; the
//   per-read scalars are per-thread registers, the histogram keys are
//   aggregated per warp.  The last block to finish sums the per-tile f32
//   partials in a fixed order, so acc_quality is the same every run, and
//   writes the minimum length.
// * On the H100 this reaches a quarter of the bytes bound (PERF.md): the
//   copy alone runs near 2.5 TB/s, but the per-base work does not overlap
//   it at 2 blocks of 8 warps per SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the mean must be the IEEE quotient).
// The host entry points have a plain C ABI and return cudaGetLastError().

#include "stats_common.cuh"

#define K1_THREADS 256
#define K1_MAX_LCAP 4096
#define K1_MAX_ROWS 8388608  // 8M rows x 255: int32 block sums cannot wrap
#define K1_BLOCKS_PER_SM 2   // one flush of atomics per block: few blocks
#define K1_STAGE_BYTES 49152 // target bytes of one staged tile
#define K1_SMEM_MAX 232448   // 227 KB of dynamic shared memory per block
#define K1_GC_PAD 104
#define K1_EXC_WINDOW 512  // 2u exceptions staged per tile

enum { K1_ROWS = 0, K1_WIRE_2U = 1 };

struct K1Args {
    const int8_t* codes;
    const uint8_t* quals;
    const int32_t* lens;
    const uint8_t* valid;
    const uint8_t* wire;   // 2u: planes [B, W]
    const int32_t* exc;    // 2u: exception sidecar [n_exc]
    const uint8_t* pal;    // 2u: palette [4]
    int n_exc, n_valid, W;
    int B, L, ld, lcap;    // ld: the plain entry's row stride
    int TR, nst;           // rows per tile, staged tiles
    K1Crit cr;
    long long* scalars;    // [8]
    long long* length_hist;
    long long* quality_hist;
    long long* gc_hist;
    long long* cov;
    long long* qpn;
    long long* bpn;        // [5, lcap]
    long long* base_totals;  // [5]
    float* tile_quality;   // [ntiles]
    float* acc_quality;    // [1]
    uint8_t* pass_out;     // [B]
};

__host__ __device__ inline int k1_round(int x, int m) {
    return (x + m - 1) / m * m;
}

// Shared-memory layout of one block (host and device agree).
struct K1Layout {
    int Ls, S, T;                  // staged row width, row stride, thr/row
    int tile, wire, pos, lh, qh, gh, rown, rowm, rowl, excw, lut, misc;
    int total;
};

__host__ __device__ inline K1Layout k1_layout(int mode, int L, int lcap,
                                              int W, int TR, int nst) {
    K1Layout s;
    s.Ls = k1_round(L > 0 ? L : 1, 16);
    s.T = K1_THREADS / TR;
    s.S = k1_round(s.Ls, 128) + 16 * (s.T < 8 ? s.T : 8);
    int o = 0;
    s.tile = o;  // codes rows then quals rows, per staged tile
    o += (mode == K1_WIRE_2U ? 1 : nst) * TR * s.S * 2;
    s.wire = o;  // 2u: the staged wire, 16 bytes of alignment slack
    if (mode == K1_WIRE_2U) o += nst * k1_round(TR * W + 16, 16);
    s.pos = o;
    o += 7 * s.Ls * 4;
    s.lh = o;
    o += k1_round((lcap + 1) * 4, 16);
    s.qh = o;
    o += HPGQ_QUAL_BINS * 4;
    s.gh = o;
    o += K1_GC_PAD * 4;
    s.rown = o;
    o += TR * 4;
    s.rowm = o;
    o += TR * 4;
    s.rowl = o;
    o += 2 * TR * 4;
    s.excw = o;
    if (mode == K1_WIRE_2U) o += 2 * K1_EXC_WINDOW * 4;
    s.lut = o;
    if (mode == K1_WIRE_2U) o += 2 * 256 * 4;
    s.misc = o;  // the last-block flag
    o += 16;
    s.total = o;
    return s;
}

// 16-byte asynchronous copy global -> shared (cp.async.cg: bypasses L1).
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the tile of rows [r0, r0+rows) into codes rows `sc` and quals rows
// `sq` (stride S): whole rows, so no copy waits on the lengths.
__device__ void stage_rows(const K1Args& a, const K1Layout& ly, int r0,
                           int rows, uint8_t* sc, uint8_t* sq) {
    // a fixed (row group, chunk) per thread: no division per chunk
    const int cr = ly.Ls / 16;  // <= 256
    const int gs = K1_THREADS / cr;
    const int g = threadIdx.x / cr, k = threadIdx.x % cr;
    for (int r = g; g < gs && r < rows; r += gs) {
        const size_t o = (size_t)(r0 + r) * a.ld + 16 * k;
        cp16(sc + r * ly.S + 16 * k, a.codes + o);
        cp16(sq + r * ly.S + 16 * k, a.quals + o);
    }
    cp_commit();
}

// Stage `nbytes` of the 2u wire from `src` into `dst` + (src & 15): the
// 16-byte-aligned middle with cp.async, the ragged head and tail by bytes.
__device__ void stage_span(uint8_t* dst, const uint8_t* src, int nbytes) {
    const int off = (int)((uintptr_t)src & 15);
    const uint8_t* base = src - off;
    const int nchunks = (off + nbytes + 15) / 16;
    for (int c = threadIdx.x; c < nchunks; c += K1_THREADS) {
        const int lo = 16 * c, hi = lo + 16;
        if (lo >= off && hi <= off + nbytes) {
            cp16(dst + lo, base + lo);
        } else {
            for (int b = max(lo, off); b < min(hi, off + nbytes); ++b)
                dst[b] = base[b];
        }
    }
    cp_commit();
}

// The window exc[cur, cur + K1_EXC_WINDOW) of the 2u exceptions into
// `win`, by 4-byte cp.async.
__device__ void stage_exc(const K1Args& a, int cur, int* win) {
    for (int e = threadIdx.x; e < K1_EXC_WINDOW && cur + e < a.n_exc;
         e += K1_THREADS) {
        const unsigned s = (unsigned)__cvta_generic_to_shared(win + e);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                     "l"(a.exc + cur + e));
    }
    cp_commit();
}

// First index of the ascending exc with exc[i] >= key: a 256-way search,
// one global load per thread and round.
__device__ int exc_lower_bound(const K1Args& a, long long key) {
    int lo = 0, hi = a.n_exc;
    while (lo < hi) {
        const long long span = hi - lo;
        const int idx = lo + (int)(span * threadIdx.x / K1_THREADS);
        const int c = __syncthreads_count((long long)a.exc[idx] < key);
        const int last = c ? lo + (int)(span * (c - 1) / K1_THREADS) : -1;
        const int next = c < K1_THREADS
            ? lo + (int)(span * c / K1_THREADS) : hi;
        if (c == 0) hi = lo;
        else {
            lo = last + 1;
            hi = next;
        }
    }
    return lo;
}

// Add `key` to a shared histogram once per distinct key among the lanes
// of `mask` (all of which call this), with the count of those lanes.
__device__ __forceinline__ void hist_add(int* hist, int key, unsigned mask) {
    const unsigned same = __match_any_sync(mask, key);
    if ((threadIdx.x & 31) == __ffs(same) - 1 && key >= 0)
        atomicAdd(&hist[key], __popc(same));
}

template <int MODE>
__global__ void __launch_bounds__(K1_THREADS)
stats_k1_kernel(const K1Args a) {
    extern __shared__ __align__(16) uint8_t sm[];
    const int tid = threadIdx.x, lane = tid & 31;
    const int TR = a.TR;
    const K1Layout ly = k1_layout(MODE, a.L, a.lcap, a.W, TR, a.nst);
    int* s_pos = (int*)(sm + ly.pos);
    int* s_lh = (int*)(sm + ly.lh);
    int* s_qh = (int*)(sm + ly.qh);
    int* s_gh = (int*)(sm + ly.gh);
    int* s_n = (int*)(sm + ly.rown);      // passing rows: min(len, L)
    float* s_mean = (float*)(sm + ly.rowm);
    int* s_len = (int*)(sm + ly.rowl);    // the tile's lengths and valid
    int* s_val = s_len + TR;
    int* s_excw = (int*)(sm + ly.excw);   // 2u: two exception windows
    int* s_flag = (int*)(sm + ly.misc);
    unsigned* lut_c = (unsigned*)(sm + ly.lut);
    unsigned* lut_q = lut_c + 256;
    const int Ls = ly.Ls, S = ly.S, T = ly.T;
    const K1Crit cr = a.cr;
    const bool extra = crit_extra(cr);
    const bool dbl = a.nst == 2;

    for (int i = tid; i < 7 * Ls; i += K1_THREADS) s_pos[i] = 0;
    for (int i = tid; i <= a.lcap; i += K1_THREADS) s_lh[i] = 0;
    for (int i = tid; i < HPGQ_QUAL_BINS; i += K1_THREADS) s_qh[i] = 0;
    for (int i = tid; i < K1_GC_PAD; i += K1_THREADS) s_gh[i] = 0;
    if (MODE == K1_WIRE_2U) {
        // byte v of a plane -> its four 2-bit fields, LSB first, as bytes
        const int v = tid;  // K1_THREADS == 256
        unsigned c = 0, q = 0;
        for (int j = 0; j < 4; ++j) {
            const int f = (v >> (2 * j)) & 3;
            c |= (unsigned)f << (8 * j);
            q |= (unsigned)a.pal[f] << (8 * j);
        }
        lut_c[v] = c;
        lut_q[v] = q;
    }

    // this block's tiles: a contiguous run, so its 2u exceptions are one
    // contiguous run of the sidecar too
    const int ntiles = (a.B + TR - 1) / TR;
    const int t0 = (int)((long long)blockIdx.x * ntiles / gridDim.x);
    const int t1 = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
    const long long Lp = 2LL * a.W;  // 2u fields per row
    // phase-2 ownership: one word (4 columns) per thread and pass; with a
    // single pass the thread keeps its word for all tiles, rows split in G
    const int Wd = Ls / 4;
    const int npass = (Wd + K1_THREADS - 1) / K1_THREADS;
    const int G = npass == 1 ? K1_THREADS / Wd : 1;
    const int my_w = npass == 1 ? tid % Wd : tid;
    const int my_g = npass == 1 ? tid / Wd : 0;
    const bool owner = npass > 1 || my_g < G;
    int acc[7][4];
#pragma unroll
    for (int f = 0; f < 7; ++f)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[f][j] = 0;
    // the per-read scalars, per thread over all of its rows
    int n_reads = 0, n_pass = 0, n_fail = 0;
    int mn = HPGQ_MIN_LENGTH_INIT, mx = 0;
    long long acc_len = 0;
    // the lanes that lead a row in phase 1
    unsigned lead = 0;
    for (int l = 0; l < 32; l += T) lead |= 1u << l;

    const int tile_bytes = TR * S * 2;
    auto wire_src = [&](int t) { return a.wire + (size_t)t * TR * a.W; };
    auto wire_dst = [&](int it) {
        return sm + ly.wire + (it % a.nst) * k1_round(TR * a.W + 16, 16);
    };
    auto stage = [&](int t, int it) {  // issue tile t's copy into slot it
        const int r0 = t * TR, rows = min(TR, a.B - r0);
        if (MODE == K1_WIRE_2U) {
            stage_span(wire_dst(it), wire_src(t), rows * a.W);
        } else {
            uint8_t* sc = sm + ly.tile + (it % a.nst) * tile_bytes;
            stage_rows(a, ly, r0, rows, sc, sc + TR * S);
        }
    };
    // tile t's length and valid flag of row `tid`, into registers: loaded
    // one tile ahead, so the loads land while this tile is worked on
    int pl = 0, pv = 0;
    auto load_rows = [&](int t) {
        const int row = t * TR + tid;
        pl = pv = 0;
        if (tid < TR && row < a.B) {
            if (MODE == K1_WIRE_2U) {
                pv = row < a.n_valid;
                pl = pv ? a.L : 0;
            } else {
                pl = a.lens[row];
                pv = a.valid[row] != 0;
            }
        }
    };

    int cur = 0;  // 2u: the next exception of this block's run
    if (t0 < t1) {
        if (dbl) stage(t0, 0);
        if (MODE == K1_WIRE_2U) {
            cur = exc_lower_bound(a, (t0 * (long long)TR * Lp) << 1);
            if (dbl) stage_exc(a, cur, s_excw);
        }
        load_rows(t0);
    }
    for (int t = t0, it = 0; t < t1; ++t, ++it) {
        const int r0 = t * TR, rows = min(TR, a.B - r0);
        int* win = s_excw + (dbl ? it % 2 : 0) * K1_EXC_WINDOW;
        if (!dbl) {
            stage(t, 0);
            if (MODE == K1_WIRE_2U) stage_exc(a, cur, win);
        }
        // the previous tile read these in phase 1, before its barrier
        if (tid < TR) {
            s_len[tid] = pl;
            s_val[tid] = pv;
        }
        cp_wait<0>();
        // every thread is past the previous tile: its staging slot is free
        __syncthreads();
        if (t + 1 < t1) {
            if (dbl) stage(t + 1, it + 1);
            load_rows(t + 1);
        }
        uint8_t* sc = sm + ly.tile + (dbl && MODE != K1_WIRE_2U
                                      ? (it % 2) * tile_bytes : 0);
        uint8_t* sq = sc + TR * S;

        if (MODE == K1_WIRE_2U) {
            // decode the staged planes into codes/quals rows
            const uint8_t* w = wire_dst(it) + ((uintptr_t)wire_src(t) & 15);
            const int half = a.W / 2, vrows = min(rows, a.n_valid - r0);
            // a fixed (row group, word) per thread, as in phase 2
            for (int pass = 0; pass < npass; ++pass) {
                const int k = my_w + pass * K1_THREADS;
                if (!owner || k >= Wd) break;
                for (int r = my_g; r < vrows; r += G) {
                    unsigned c = 0, q = 0;
                    if (k < half) {
                        c = lut_c[w[r * a.W + k]];
                        q = lut_q[w[r * a.W + half + k]];
                    }
                    *(unsigned*)(sc + r * S + 4 * k) = c;
                    *(unsigned*)(sq + r * S + 4 * k) = q;
                }
            }
            __syncthreads();
            // the tile's exceptions from the window at `cur`: scatter-max
            // of codes 4 (N), then 5 (OTHER), over the decoded 0-3 fields
            const long long key_hi = ((r0 + (long long)rows) * Lp) << 1;
            while (true) {
                const int wn = min(K1_EXC_WINDOW, a.n_exc - cur);
                for (int pass = 0; pass < 2; ++pass) {
                    for (int e = tid; e < wn; e += K1_THREADS) {
                        const int v = win[e];
                        if ((long long)v >= key_hi || (v & 1) != pass)
                            continue;
                        const long long idx = (long long)(v >> 1) - r0 * Lp;
                        const int r = (int)(idx / Lp);
                        const int p = (int)(idx - r * Lp);
                        if (p < Ls) sc[r * S + p] = (uint8_t)(4 + pass);
                    }
                    __syncthreads();
                }
                int cnt = 0;
                for (int e0 = 0; e0 < K1_EXC_WINDOW; e0 += K1_THREADS)
                    cnt += __syncthreads_count(
                        e0 + tid < wn && (long long)win[e0 + tid] < key_hi);
                cur += cnt;
                if (cnt < K1_EXC_WINDOW) break;
                // more than a window of exceptions in this tile: the next
                for (int e = tid; e < K1_EXC_WINDOW && cur + e < a.n_exc;
                     e += K1_THREADS)
                    win[e] = a.exc[cur + e];
                __syncthreads();
            }
            if (dbl && t + 1 < t1)
                stage_exc(a, cur, s_excw + ((it + 1) % 2) * K1_EXC_WINDOW);
        }

        // ---- phase 1: per-read sums and verdicts, T threads per row ----
        {
            const int r = tid / T, part = tid - r * T;
            const int len = s_len[r];
            const bool vrow = s_val[r] != 0;
            const int n = min(max(len, 0), a.L);  // 0 past the last row
            RowSums s = {0, 0, 0, 0, 0, 0, 0, 0};
            for (int ch = part; 16 * ch < n; ch += T) {
                const uint4 c4 = *(const uint4*)(sc + r * S + 16 * ch);
                const uint4 q4 = *(const uint4*)(sq + r * S + 16 * ch);
                const unsigned cw[4] = {c4.x, c4.y, c4.z, c4.w};
                const unsigned qw[4] = {q4.x, q4.y, q4.z, q4.w};
                add_chunk(s, cw, qw, 16 * ch, n, len, cr, extra);
            }
            if (T > 1) {
                s.qsum = warp_sum(s.qsum, 0xffffffffu, T);
                s.nn = warp_sum(s.nn, 0xffffffffu, T);
                s.ngc = warp_sum(s.ngc, 0xffffffffu, T);
                if (extra) {
                    s.wq = warp_sum(s.wq, 0xffffffffu, T);
                    s.wl = warp_sum(s.wl, 0xffffffffu, T);
                    s.oq = warp_sum(s.oq, 0xffffffffu, T);
                    s.ls = warp_sum(s.ls, 0xffffffffu, T);
                    s.rs = warp_sum(s.rs, 0xffffffffu, T);
                }
            }
            if (part == 0) {
                bool passed = vrow;
                if (cr.on && vrow) {
                    passed = row_ok(s.qsum, s.nn, s.wq, s.wl, s.oq, s.ls,
                                    s.rs, len, cr);
                    n_pass += passed;
                    n_fail += !passed;
                }
                if (r < rows) a.pass_out[r0 + r] = passed ? 1 : 0;
                s_n[r] = passed ? n : 0;
                s_mean[r] = (passed && len > 0)
                    ? __fdiv_rn((float)s.qsum, (float)len) : 0.f;
                if (passed) {
                    n_reads += 1;
                    acc_len += len;
                    mn = min(mn, len);
                    mx = max(mx, len);
                }
                // histogram keys, one shared atomic per distinct key and
                // warp: [D1] integer round-half-up of the rational mean;
                // integer GC%, none for zero-length reads
                const unsigned pm = __ballot_sync(lead, passed);
                if (passed) {
                    hist_add(s_lh, min(max(len, 0), a.lcap), pm);
                    const int qkey = (2 * s.qsum + len) / max(2 * len, 1);
                    hist_add(s_qh, min(max(qkey, 0), HPGQ_QUAL_BINS - 1), pm);
                    hist_add(s_gh, len > 0
                             ? min(max((100 * s.ngc) / len, 0),
                                   HPGQ_GC_BINS - 1) : -1, pm);
                }
            }
        }
        __syncthreads();

        // the tile's f32 mean-quality partial, in a fixed order
        if (tid < 32) {
            float v = 0.f;
            for (int r = tid; r < TR; r += 32) v += s_mean[r];
            for (int o = 16; o > 0; o >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, o);
            if (tid == 0) a.tile_quality[t] = v;
        }

        // ---- phase 2: per-position sums over the tile's passing rows ----
        for (int pass = 0; pass < npass; ++pass) {
            const int w = my_w + pass * K1_THREADS;
            if (!owner || w >= Wd) break;
            PackedCols pk;
            packed_zero(pk);
#pragma unroll 4
            for (int r = my_g; r < rows; r += G) {
                const int k = s_n[r] - 4 * w;
                if (k <= 0) continue;
                packed_add(pk, *(const unsigned*)(sc + r * S + 4 * w),
                           *(const unsigned*)(sq + r * S + 4 * w), k);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int col[7];
                packed_col(pk, j, col);
                if (npass == 1) {
#pragma unroll
                    for (int f = 0; f < 7; ++f) acc[f][j] += col[f];
                } else {
#pragma unroll
                    for (int f = 0; f < 7; ++f) s_pos[f * Ls + 4 * w + j] +=
                        col[f];
                }
            }
        }
    }
    __syncthreads();

    // ---- the block's sums -> the int64 outputs, once ----
    if (npass == 1 && owner) {
#pragma unroll
        for (int f = 0; f < 7; ++f)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (acc[f][j]) atomicAdd(&s_pos[f * Ls + 4 * my_w + j],
                                         acc[f][j]);
    }
    // the scalars: a warp reduction, then one global atomic per warp
    for (int o = 16; o > 0; o >>= 1) {
        n_reads += __shfl_xor_sync(0xffffffffu, n_reads, o);
        n_pass += __shfl_xor_sync(0xffffffffu, n_pass, o);
        n_fail += __shfl_xor_sync(0xffffffffu, n_fail, o);
        acc_len += __shfl_xor_sync(0xffffffffu, acc_len, o);
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
        if (n_reads) {
            add_u64(&a.scalars[S_NUM_READS], n_reads);
            add_u64(&a.scalars[S_ACC_LENGTH], acc_len);
            atomicMax(&a.scalars[S_MAX_LEN], (long long)mx);
            atomicMax(&a.scalars[S_NEG_MIN],
                      (long long)(HPGQ_MIN_LENGTH_INIT - mn));
        }
        if (n_pass) add_u64(&a.scalars[S_NUM_PASSED], n_pass);
        if (n_fail) add_u64(&a.scalars[S_NUM_FAILED], n_fail);
    }
    __syncthreads();
    long long bt[5] = {0, 0, 0, 0, 0};
    for (int c = tid; c < a.L; c += K1_THREADS) {
        const int cv = s_pos[c];
        if (!cv) continue;
        add_u64(&a.cov[c], cv);
        add_u64(&a.qpn[c], s_pos[Ls + c]);
#pragma unroll
        for (int b = 0; b < 5; ++b) {
            const int v = s_pos[(2 + b) * Ls + c];
            if (v) add_u64(&a.bpn[(size_t)b * a.lcap + c], v);
            bt[b] += v;
        }
    }
#pragma unroll
    for (int b = 0; b < 5; ++b) {
        long long v = bt[b];
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && v) add_u64(&a.base_totals[b], v);
    }
    for (int i = tid; i <= a.lcap; i += K1_THREADS)
        if (s_lh[i]) add_u64(&a.length_hist[i], s_lh[i]);
    for (int i = tid; i < HPGQ_QUAL_BINS; i += K1_THREADS)
        if (s_qh[i]) add_u64(&a.quality_hist[i], s_qh[i]);
    for (int i = tid; i < HPGQ_GC_BINS; i += K1_THREADS)
        if (s_gh[i]) add_u64(&a.gc_hist[i], s_gh[i]);

    // ---- the last block: acc_quality in tile order, the minimum length ----
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        const unsigned long long prev = atomicAdd(
            reinterpret_cast<unsigned long long*>(&a.scalars[S_DONE]), 1ull);
        *s_flag = prev == (unsigned long long)gridDim.x - 1;
    }
    __syncthreads();
    if (!*s_flag) return;
    __threadfence();
    // thread i sums tiles i, i+256, ... in order, then a fixed tree
    float* s_sum = (float*)sm;  // the staging area is free now
    float v = 0.f;
#pragma unroll 4
    for (int i = tid; i < ntiles; i += K1_THREADS)
        v += __ldcg(&a.tile_quality[i]);
    s_sum[tid] = v;
    __syncthreads();
    for (int h = K1_THREADS / 2; h > 0; h >>= 1) {
        if (tid < h) s_sum[tid] += s_sum[tid + h];
        __syncthreads();
    }
    if (tid == 0) {
        *a.acc_quality = s_sum[0];
        a.scalars[S_MIN_LEN] =
            HPGQ_MIN_LENGTH_INIT - __ldcg(&a.scalars[S_NEG_MIN]);
    }
}

namespace {

// Rows per tile and staged tiles for a batch: the largest power-of-two
// tile (8..128 rows, at most 32 threads per row) whose staged copy is
// near K1_STAGE_BYTES and whose layout fits, two staged tiles if they fit.
bool k1_plan(int mode, int L, int lcap, int W, int* TR, int* nst,
             K1Layout* ly) {
    for (int tr = 128; tr >= 8; tr /= 2) {
        for (int ns = 2; ns >= 1; --ns) {
            const K1Layout s = k1_layout(mode, L, lcap, W, tr, ns);
            if (s.total > K1_SMEM_MAX) continue;
            if (tr > 8 && tr * s.S * 2 > K1_STAGE_BYTES) break;
            *TR = tr;
            *nst = ns;
            *ly = s;
            return true;
        }
    }
    return false;
}

template <int MODE>
int k1_launch(K1Args a, void* stream) {
    K1Layout ly;
    if (!k1_plan(MODE, a.L, a.lcap, a.W, &a.TR, &a.nst, &ly))
        return (int)cudaErrorInvalidValue;
    const void* fn = (const void*)stats_k1_kernel<MODE>;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, ly.total);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, nsm = 0, bps = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
        return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &bps, fn, K1_THREADS, ly.total)) != cudaSuccess)
        return (int)e;
    const int ntiles = (a.B + a.TR - 1) / a.TR;
    const int per_sm = bps < 1 ? 1 : bps > K1_BLOCKS_PER_SM
                                         ? K1_BLOCKS_PER_SM : bps;
    const int grid = ntiles < nsm * per_sm ? ntiles : nsm * per_sm;
    stats_k1_kernel<MODE><<<grid, K1_THREADS, ly.total,
                            (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-tile f32 partial slots a launch writes (the rows of a tile depend on
// L, lcap and, for the 2u entry, the wire width W); -1: no layout fits.
int hpgq_k1_tiles(int wire2u, int B, int L, int lcap, int W) {
    int TR, nst;
    K1Layout ly;
    if (!k1_plan(wire2u ? K1_WIRE_2U : K1_ROWS, L, lcap, W, &TR, &nst,
                 &ly))
        return -1;
    return (B + TR - 1) / TR;
}

// Launch K1's plain entry on `stream`.  Every output must arrive zeroed;
// tile_quality has hpgq_k1_tiles(0, B, L, lcap, 0) floats.  Returns
// cudaGetLastError() after the launch (0 = launched).
int hpgq_k1_launch(const void* codes, const void* quals, const void* lens,
                   const void* valid, int B, int L, int ld, int lcap,
                   K1Crit crit,
                   void* scalars, void* length_hist, void* quality_hist,
                   void* gc_hist, void* cov, void* qpn, void* bpn,
                   void* base_totals, void* tile_quality, void* acc_quality,
                   void* pass_out, void* stream) {
    if (B <= 0) return (int)cudaSuccess;
    if (L < 0 || L > lcap || lcap > K1_MAX_LCAP || B > K1_MAX_ROWS ||
        ld % 16 != 0 || ld < k1_round(L > 0 ? L : 1, 16) ||
        (uintptr_t)codes % 16 != 0 || (uintptr_t)quals % 16 != 0)
        return (int)cudaErrorInvalidValue;
    K1Args a = {};
    a.codes = (const int8_t*)codes;
    a.quals = (const uint8_t*)quals;
    a.lens = (const int32_t*)lens;
    a.valid = (const uint8_t*)valid;
    a.B = B;
    a.L = L;
    a.ld = ld;
    a.lcap = lcap;
    a.cr = crit;
    a.scalars = (long long*)scalars;
    a.length_hist = (long long*)length_hist;
    a.quality_hist = (long long*)quality_hist;
    a.gc_hist = (long long*)gc_hist;
    a.cov = (long long*)cov;
    a.qpn = (long long*)qpn;
    a.bpn = (long long*)bpn;
    a.base_totals = (long long*)base_totals;
    a.tile_quality = (float*)tile_quality;
    a.acc_quality = (float*)acc_quality;
    a.pass_out = (uint8_t*)pass_out;
    return k1_launch<K1_ROWS>(a, stream);
}

// Launch K1's 2u entry on `stream`: the plain entry's outputs from the 2u
// wire (planes [B, W], exceptions [n_exc] ascending, palette [4]).
int hpgq_k1_launch_2u(const void* wire, const void* exc, int n_exc,
                      const void* pal, int n_valid, int B, int W, int L,
                      int lcap, K1Crit crit, void* scalars, void* length_hist,
                      void* quality_hist, void* gc_hist, void* cov, void* qpn,
                      void* bpn, void* base_totals, void* tile_quality,
                      void* acc_quality, void* pass_out, void* stream) {
    if (B <= 0) return (int)cudaSuccess;
    if (L < 0 || L > lcap || lcap > K1_MAX_LCAP || B > K1_MAX_ROWS ||
        W <= 0 || L > 2 * W || n_valid < 0 || n_valid > B || n_exc < 0 ||
        (long long)B * 2 * W >= (1LL << 30))
        return (int)cudaErrorInvalidValue;
    K1Args a = {};
    a.wire = (const uint8_t*)wire;
    a.exc = (const int32_t*)exc;
    a.pal = (const uint8_t*)pal;
    a.n_exc = n_exc;
    a.n_valid = n_valid;
    a.W = W;
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
    a.base_totals = (long long*)base_totals;
    a.tile_quality = (float*)tile_quality;
    a.acc_quality = (float*)acc_quality;
    a.pass_out = (uint8_t*)pass_out;
    return k1_launch<K1_WIRE_2U>(a, stream);
}

const char* hpgq_k1_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
