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
// What bounds it: the batch is read from device memory twice (2 * 2*B*L
// bytes; 59 MB per sweep for a 512 x 57344 batch) against O(1) integer work
// per byte, so it is memory-bound.  The TPU's sequential L-block grid and
// its VMEM scratch carry have no meaning here; instead:
//
// * Launch A (stats_k2_reads), one 256-thread block per read: the threads
//   stride over the read with 16-byte loads (byte loads when a row is not
//   16-byte aligned), sum in 32-bit registers (a thread sees at most
//   2^31/256 + 16 bases, so no sum can wrap), and reduce in 64 bits.
//   Thread 0 evaluates the verdict in 64-bit products (the MAX sentinel
//   100000 times any length cannot wrap), writes the pass mask and the
//   row's f32 mean (the IEEE quotient of the round-to-nearest conversions,
//   as torch's .to(torch.float32) makes them), and adds the row's scalars
//   and histogram keys (integer math, [D1]) to the int64 outputs with one
//   global atomic each.  With one block per read there is nothing to
//   privatise in shared memory; a scalar sees at most B atomics per launch.
//   The length histogram has lcap+1 bins, far past shared memory at long
//   lcap, so its bins are global atomics too (one per passing read).
// * Launch B (stats_k2_positions), after A on the same stream: a grid over
//   (256-column chunk, 256-row tile).  Each thread owns one column, loops
//   over the tile's passing rows (coalesced byte loads across the warp),
//   and adds coverage, quality sum and the five base counts with one int64
//   atomic per column, field and tile.  Reading the batch a second time
//   matches the TPU kernel's second sweep with criteria.
// * The f32 mean-quality sum is left to the wrapper (a fixed-order sum of
//   the per-row means), so it is the same every run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (no --use_fast_math: the mean must be the IEEE quotient).  The host entry
// point has a plain C ABI and returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_VEC 16
#define K2_COLS 256       // columns per block of launch B
#define K2_TILE_ROWS 256  // rows per block of launch B
#define K2_QUAL_BINS 256
#define K2_GC_BINS 101

#define S_NUM_READS 0
#define S_ACC_LENGTH 1
#define S_MIN_LEN 2
#define S_MAX_LEN 3
#define S_NUM_PASSED 4
#define S_NUM_FAILED 5

// The same criteria struct as csrc/stats_k1.cu (identical definition):
// substituted thresholds with an on/off flag per optional check.
struct K1Crit {
    int on;
    int min_len, max_len;
    int min_q, max_q;
    int oq_on, max_oq;
    int qwin_on, begin, end;
    int left_len, min_lq, max_lq;
    int right_len, min_rq, max_rq;
    int max_n;
    int phred;
};

namespace {

// Per-read sums over positions [0, min(len, L)).
struct RowSums {
    long long qsum, wq, ls, rs;  // quality, window, left, right sums
    long long nn, ngc, wl, oq;   // N, G+C, window width, out-of-quality
};

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ bool in_bounds(long long qn, long long w, int lo,
                                          int hi) {
    return (long long)lo * w <= qn && qn <= (long long)hi * w;
}

__device__ __forceinline__ void add_u64(long long* p, long long v) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(v));
}

// fastq_filter verdict [D2][D3][D8], every product in 64 bits.
__device__ bool row_ok(const RowSums& s, int len, const K1Crit& cr) {
    const long long ph = cr.phred;
    bool ok = len >= cr.min_len && len <= cr.max_len;
    const long long wlen = cr.qwin_on ? s.wl : (long long)len;
    const long long wqs = cr.qwin_on ? s.wq : s.qsum;
    ok = ok && in_bounds(wqs - ph * wlen, wlen, cr.min_q, cr.max_q);
    if (cr.oq_on) ok = ok && s.oq <= cr.max_oq;
    if (cr.left_len > 0) {
        const long long w = min(len, cr.left_len);
        ok = ok && in_bounds(s.ls - ph * w, w, cr.min_lq, cr.max_lq);
    }
    if (cr.right_len > 0) {
        const long long w = min(len, cr.right_len);
        ok = ok && in_bounds(s.rs - ph * w, w, cr.min_rq, cr.max_rq);
    }
    return ok && s.nn <= cr.max_n;
}

// 32-bit per-thread sums (see the header for why they cannot wrap).
struct ThreadSums {
    int qsum, wq, ls, rs, nn, ngc, wl, oq;
};

__device__ __forceinline__ void add_base(ThreadSums& s, int p, int c, int q,
                                         int len, const K1Crit& cr) {
    s.qsum += q;
    s.nn += (c == 4);
    s.ngc += (c == 1) | (c == 2);
    if (cr.on) {
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

template <bool VEC>
__global__ void __launch_bounds__(K2_THREADS)
stats_k2_reads(const int8_t* __restrict__ codes,
               const uint8_t* __restrict__ quals,
               const int32_t* __restrict__ lens,
               const uint8_t* __restrict__ valid, int L, int lcap, K1Crit cr,
               long long* __restrict__ scalars,
               long long* __restrict__ length_hist,
               long long* __restrict__ quality_hist,
               long long* __restrict__ gc_hist,
               float* __restrict__ row_mean,
               uint8_t* __restrict__ pass_out) {
    __shared__ long long s_red[K2_WARPS][8];
    const int row = blockIdx.x;
    const int tid = threadIdx.x;
    const int len = lens[row];
    const int n = min(max(len, 0), L);
    const int8_t* c_row = codes + (size_t)row * L;
    const uint8_t* q_row = quals + (size_t)row * L;

    ThreadSums t = {0, 0, 0, 0, 0, 0, 0, 0};
    if (VEC) {
        // rows are 16-byte aligned and L % 16 == 0, so base + 16 <= L
        for (int base = tid * K2_VEC; base < n; base += K2_THREADS * K2_VEC) {
            const uint4 cv = *reinterpret_cast<const uint4*>(c_row + base);
            const uint4 qv = *reinterpret_cast<const uint4*>(q_row + base);
            const unsigned cw[4] = {cv.x, cv.y, cv.z, cv.w};
            const unsigned qw[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
            for (int j = 0; j < K2_VEC; ++j) {
                const int p = base + j;
                if (p < n) {
                    const int sh = 8 * (j & 3);
                    add_base(t, p, (int)(int8_t)((cw[j >> 2] >> sh) & 0xFF),
                             (int)((qw[j >> 2] >> sh) & 0xFF), len, cr);
                }
            }
        }
    } else {
        for (int p = tid; p < n; p += K2_THREADS)
            add_base(t, p, c_row[p], q_row[p], len, cr);
    }

    // block reduction in 64 bits: warps by shuffle, then across warps
    const long long v[8] = {t.qsum, t.wq, t.ls, t.rs, t.nn, t.ngc, t.wl, t.oq};
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const long long w = warp_sum64(v[k]);
        if (lane == 0) s_red[warp][k] = w;
    }
    __syncthreads();
    if (tid != 0) return;
    long long tot[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int w = 0; w < K2_WARPS; ++w)
        for (int k = 0; k < 8; ++k) tot[k] += s_red[w][k];
    const RowSums s = {tot[0], tot[1], tot[2], tot[3],
                       tot[4], tot[5], tot[6], tot[7]};

    const bool vrow = valid[row] != 0;
    bool passed = vrow;
    if (cr.on && vrow) {
        passed = row_ok(s, len, cr);
        add_u64(&scalars[passed ? S_NUM_PASSED : S_NUM_FAILED], 1);
    }
    pass_out[row] = passed ? 1 : 0;
    float mean = 0.f;
    if (passed) {
        if (len > 0)
            mean = __fdiv_rn(__ll2float_rn(s.qsum),
                             __ll2float_rn((long long)len));
        add_u64(&scalars[S_NUM_READS], 1);
        add_u64(&scalars[S_ACC_LENGTH], len);
        atomicMin(&scalars[S_MIN_LEN], (long long)len);
        atomicMax(&scalars[S_MAX_LEN], (long long)len);
        add_u64(&length_hist[min(max(len, 0), lcap)], 1);
        // [D1] integer round-half-up of the rational mean
        const long long L64 = len;
        const long long qkey = (2 * s.qsum + L64) / max(2 * L64, 1LL);
        add_u64(&quality_hist[min(max(qkey, 0LL), (long long)K2_QUAL_BINS - 1)],
                1);
        // integer GC% key; zero-length reads take no key
        if (len > 0) {
            const long long gkey = (100 * s.ngc) / L64;
            add_u64(&gc_hist[min(max(gkey, 0LL), (long long)K2_GC_BINS - 1)],
                    1);
        }
    }
    row_mean[row] = mean;
}

__global__ void __launch_bounds__(K2_COLS)
stats_k2_positions(const int8_t* __restrict__ codes,
                   const uint8_t* __restrict__ quals,
                   const int32_t* __restrict__ lens,
                   const uint8_t* __restrict__ passed, int B, int L, int lcap,
                   long long* __restrict__ cov, long long* __restrict__ qpn,
                   long long* __restrict__ bpn) {
    __shared__ int s_n[K2_TILE_ROWS];
    __shared__ int s_max;
    const int row0 = blockIdx.y * K2_TILE_ROWS;
    const int rows = min(K2_TILE_ROWS, B - row0);
    if (threadIdx.x == 0) s_max = 0;
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += K2_COLS) {
        const int row = row0 + r;
        const int n = passed[row] ? min(max(lens[row], 0), L) : 0;
        s_n[r] = n;
        atomicMax(&s_max, n);
    }
    __syncthreads();
    const int col = blockIdx.x * K2_COLS + threadIdx.x;
    if (blockIdx.x * K2_COLS >= s_max) return;  // no passing read this long
    if (col >= L) return;
    int cv = 0, qv = 0, b0 = 0, b1 = 0, b2 = 0, b3 = 0, b4 = 0;
    for (int r = 0; r < rows; ++r) {
        if (col >= s_n[r]) continue;
        const size_t off = (size_t)(row0 + r) * L + col;
        const int c = codes[off];
        cv += 1;
        qv += quals[off];
        b0 += (c == 0);
        b1 += (c == 1);
        b2 += (c == 2);
        b3 += (c == 3);
        b4 += (c == 4);
    }
    if (cv) {
        add_u64(&cov[col], cv);
        add_u64(&qpn[col], qv);
        if (b0) add_u64(&bpn[0 * (size_t)lcap + col], b0);
        if (b1) add_u64(&bpn[1 * (size_t)lcap + col], b1);
        if (b2) add_u64(&bpn[2 * (size_t)lcap + col], b2);
        if (b3) add_u64(&bpn[3 * (size_t)lcap + col], b3);
        if (b4) add_u64(&bpn[4 * (size_t)lcap + col], b4);
    }
}

}  // namespace

extern "C" {

// Launch K2 (launch A, then launch B) on `stream`.  The int64 outputs must
// arrive zeroed, with scalars[S_MIN_LEN] = 100000; row_mean has B floats.
// Returns cudaGetLastError() after the launches (0 = launched).
int hpgq_k2_launch(const void* codes, const void* quals, const void* lens,
                   const void* valid, int B, int L, int lcap, K1Crit crit,
                   void* scalars, void* length_hist, void* quality_hist,
                   void* gc_hist, void* cov, void* qpn, void* bpn,
                   void* row_mean, void* pass_out, void* stream) {
    if (B <= 0) return (int)cudaSuccess;
    const long long tiles = ((long long)B + K2_TILE_ROWS - 1) / K2_TILE_ROWS;
    if (L < 0 || L > lcap || L > INT_MAX - K2_THREADS * K2_VEC ||
        tiles > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const bool vec = L % K2_VEC == 0 && (uintptr_t)codes % K2_VEC == 0 &&
                     (uintptr_t)quals % K2_VEC == 0;
    if (vec)
        stats_k2_reads<true><<<B, K2_THREADS, 0, s>>>(
            (const int8_t*)codes, (const uint8_t*)quals, (const int32_t*)lens,
            (const uint8_t*)valid, L, lcap, crit, (long long*)scalars,
            (long long*)length_hist, (long long*)quality_hist,
            (long long*)gc_hist, (float*)row_mean, (uint8_t*)pass_out);
    else
        stats_k2_reads<false><<<B, K2_THREADS, 0, s>>>(
            (const int8_t*)codes, (const uint8_t*)quals, (const int32_t*)lens,
            (const uint8_t*)valid, L, lcap, crit, (long long*)scalars,
            (long long*)length_hist, (long long*)quality_hist,
            (long long*)gc_hist, (float*)row_mean, (uint8_t*)pass_out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || L == 0) return (int)e;
    const dim3 grid((L + K2_COLS - 1) / K2_COLS, (unsigned)tiles);
    stats_k2_positions<<<grid, K2_COLS, 0, s>>>(
        (const int8_t*)codes, (const uint8_t*)quals, (const int32_t*)lens,
        (const uint8_t*)pass_out, B, L, lcap, (long long*)cov,
        (long long*)qpn, (long long*)bpn);
    return (int)cudaGetLastError();
}

}  // extern "C"
