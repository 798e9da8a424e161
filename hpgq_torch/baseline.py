"""The single-CPU oracle of ``tools/ab_torch.py``.

The port's own copy (it imports nothing of ``hpgq``) of exactly the
functions ``bench.py``'s oracle passes run: ``block_stats``,
``block_verdicts`` and ``block_trims`` of ``hpgq/oracle/baseline.py`` (with
the helpers they call) and ``fill_tables_loop`` of ``hpgq/oracle/cgr.py``,
kept equal to them (``tests/test_torch_baseline.py``).  They run on packed
``[N, L]`` batches (``hpgq_torch.io.packer.pack_block``): vectorised numpy
on one core for stats, the filter verdict and the trims, and the reference's
per-nucleotide loop for the chaos game.  Decision tags [D1]-[D8] are those
of ``hpgq/oracle/spec.py``.

``hpgq_torch/oracle.py`` is the other reference of the port: it works on
the generated records rather than on packed batches, so it checks the
reader and the packer too; this module is what a single-CPU run of the
same pipeline costs.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    BASE_A,
    BASE_C,
    BASE_G,
    BASE_N,
    BASE_T,
    CGR_EPSILON,
    KMER_K,
    MAX_VALUE,
    MIN_VALUE,
    PHRED33,
)
from .core.counters import GC_BINS, QUAL_BINS, StatsCounters
from .options import FilterCriteria


def _pos_mask(lens: np.ndarray, L: int) -> np.ndarray:
    return np.arange(L, dtype=np.int32)[None, :] < lens[:, None]


def block_read_reductions(codes, quals, lens):
    """Per-read reductions shared by stats and filter paths."""
    L = codes.shape[1]
    mask = _pos_mask(lens, L)
    q = quals.astype(np.int64)
    qsum = np.where(mask, q, 0).sum(axis=1)
    base_counts = np.stack(
        [((codes == c) & mask).sum(axis=1, dtype=np.int64) for c in range(5)]
    )  # [5, N]
    return mask, qsum, base_counts


def block_stats(
    codes, quals, lens, valid=None, kmers_on: bool = False, phred: int = PHRED33
) -> StatsCounters:
    """Stats for one packed batch → a partial StatsCounters."""
    n_rows, L = codes.shape
    if valid is None:
        valid = np.ones(n_rows, dtype=bool)
    sel = np.flatnonzero(valid)
    codes, quals, lens = codes[sel], quals[sel], lens[sel]
    n = codes.shape[0]

    c = StatsCounters(phred=phred, kmers_on=kmers_on)
    if n == 0:
        return c
    c.ensure_length(L)

    mask, qsum, base_counts = block_read_reductions(codes, quals, lens)

    c.num_reads = int(n)
    c.acc_length = int(lens.astype(np.int64).sum())
    c.min_length = int(lens.min())
    c.max_length = int(lens.max())

    mean_q32 = np.where(
        lens > 0, qsum.astype(np.float32) / lens.astype(np.float32), np.float32(0)
    ).astype(np.float32)  # [D1]
    c.acc_quality = float(mean_q32.astype(np.float64).sum())

    c.num_As = int(base_counts[0].sum())
    c.num_Cs = int(base_counts[1].sum())
    c.num_Gs = int(base_counts[2].sum())
    c.num_Ts = int(base_counts[3].sum())
    c.num_Ns = int(base_counts[4].sum())

    np.add.at(c.length_hist, lens, 1)
    # [D1] integer round-half-up of the rational mean (see oracle.spec)
    qkey = (2 * qsum.astype(np.int64) + lens) // np.maximum(2 * lens.astype(np.int64), 1)
    np.add.at(c.quality_hist, np.clip(qkey, 0, QUAL_BINS - 1), 1)
    # zero-length reads take no GC key (the reference would divide by zero)
    nz = lens > 0
    gckey = (100 * (base_counts[BASE_G][nz] + base_counts[BASE_C][nz])) // lens[nz]
    np.add.at(c.gc_hist, np.clip(gckey, 0, GC_BINS - 1), 1)

    c.count_quality_per_nt[:L] = mask.sum(axis=0, dtype=np.int64)
    c.acc_quality_per_nt[:L] = np.where(mask, quals.astype(np.int64), 0).sum(axis=0)
    for b in range(5):
        c.base_per_nt[b, :L] = ((codes == b) & mask).sum(axis=0, dtype=np.int64)

    if kmers_on and L >= KMER_K:
        kcodes, kvalid = kmer_window_codes(codes, lens)
        flat_codes = kcodes[kvalid]
        flat_pos = np.broadcast_to(
            np.arange(kcodes.shape[1], dtype=np.int64)[None, :], kcodes.shape
        )[kvalid]
        np.add.at(c.kmer_counts, flat_codes, 1)
        np.add.at(
            c.kmer_counts_by_pos.reshape(-1),
            flat_codes * c.lcap + flat_pos,
            1,
        )
    return c


def kmer_window_codes(codes, lens):
    """[D5] base-4 codes of all 5-mer windows → (codes [N, L-4], valid mask)."""
    N, L = codes.shape
    W = L - KMER_K + 1
    c64 = codes.astype(np.int64)
    kcodes = np.zeros((N, W), dtype=np.int64)
    ok = np.ones((N, W), dtype=bool)
    for i in range(KMER_K):
        part = c64[:, i : i + W]
        kcodes = kcodes * 4 + np.minimum(part, 3)
        ok &= part < 4
    pos = np.arange(W, dtype=np.int32)[None, :]
    ok &= (pos + KMER_K) <= lens[:, None]
    return kcodes, ok


def block_verdicts(
    codes, quals, lens, crit: FilterCriteria, phred: int = PHRED33
) -> np.ndarray:
    """[D2][D3] Vectorized fastq_filter predicate → bool [N]."""
    crit = crit.substituted()
    N, L = codes.shape
    mask = _pos_mask(lens, L)
    q = quals.astype(np.int64)
    lens64 = lens.astype(np.int64)
    qsum = np.where(mask, q, 0).sum(axis=1)
    nN = ((codes == BASE_N) & mask).sum(axis=1, dtype=np.int64)

    ok = (lens64 >= crit.min_read_length) & (lens64 <= crit.max_read_length)

    # [D8] legacy quality position window [begin, end): quality screens
    # evaluate only those positions (see oracle.spec.filter_verdict)
    if crit.quality_window_on:
        pos = np.arange(L, dtype=np.int64)[None, :]
        qwmask = mask & (pos >= crit.begin_quality_nt) & (pos < crit.end_quality_nt)
        wlen = qwmask.sum(axis=1, dtype=np.int64)
        wqsum = np.where(qwmask, q, 0).sum(axis=1)
    else:
        qwmask, wlen, wqsum = mask, lens64, qsum

    qn = wqsum - phred * wlen
    ok &= (crit.min_read_quality * wlen <= qn) & (qn <= crit.max_read_quality * wlen)

    if crit.max_out_of_quality != MAX_VALUE:
        nq = q - phred
        out = (
            ((nq < crit.min_read_quality) | (nq > crit.max_read_quality)) & qwmask
        ).sum(axis=1, dtype=np.int64)
        ok &= out <= crit.max_out_of_quality

    if crit.left_length > MIN_VALUE:
        w = np.minimum(lens64, crit.left_length)
        lmask = np.arange(L, dtype=np.int64)[None, :] < w[:, None]
        ls = np.where(lmask, q, 0).sum(axis=1)
        lqn = ls - phred * w
        ok &= (crit.min_left_quality * w <= lqn) & (lqn <= crit.max_left_quality * w)

    if crit.right_length > MIN_VALUE:
        w = np.minimum(lens64, crit.right_length)
        pos = np.arange(L, dtype=np.int64)[None, :]
        rmask = (pos >= (lens64 - w)[:, None]) & mask
        rs = np.where(rmask, q, 0).sum(axis=1)
        rqn = rs - phred * w
        ok &= (crit.min_right_quality * w <= rqn) & (rqn <= crit.max_right_quality * w)

    ok &= nN <= crit.max_N
    return ok


def block_trims(quals, lens, crit: FilterCriteria, phred: int = PHRED33):
    """[D4] Vectorized fastq_edit trim decision → (ltrim, rtrim) int32 [N]."""
    crit = crit.substituted()
    N, L = quals.shape
    q = quals.astype(np.int64)
    lens64 = lens.astype(np.int64)
    pos = np.arange(L, dtype=np.int64)[None, :]
    mask = pos < lens64[:, None]
    lt = np.zeros(N, dtype=np.int64)
    rt = np.zeros(N, dtype=np.int64)

    if crit.left_length > MIN_VALUE:
        w = np.minimum(lens64, crit.left_length)
        lmask = pos < w[:, None]
        ls = np.where(lmask, q, 0).sum(axis=1)
        lqn = ls - phred * w
        bad = (lqn < crit.min_left_quality * w) | (lqn > crit.max_left_quality * w)
        lt = np.where(bad, w, 0)

    if crit.right_length > MIN_VALUE:
        w = np.minimum(lens64, crit.right_length)
        rmask = (pos >= (lens64 - w)[:, None]) & mask
        rs = np.where(rmask, q, 0).sum(axis=1)
        rqn = rs - phred * w
        bad = (rqn < crit.min_right_quality * w) | (rqn > crit.max_right_quality * w)
        rt = np.where(bad, w, 0)

    rt = np.minimum(rt, lens64 - lt)
    return lt.astype(np.int32), rt.astype(np.int32)


def fill_tables_loop(codes, quals, lens, valid, k: int, phred: int,
                     f0: float = None):
    """(table_seq, table_q, fq_word_count) over packed [B, L] batches: the
    reference's chaos-game loop (``old/chaos_game.c:165-267``), one
    nucleotide at a time, coordinates carried across reads.

    ``codes``/``quals``/``lens``/``valid``: the engine's packed layout.
    ``f0``: initial coordinate (reference: dim/2, old/chaos_game.c:106-107).
    """
    dim = 1 << k
    table_seq = np.zeros((dim, dim), dtype=np.int64)
    table_q = np.zeros((dim, dim), dtype=np.int64)
    f_x = float(dim) * 0.5 if f0 is None else f0
    f_y = f_x
    sub = phred * k
    word_count = 0

    B, L = codes.shape
    for i in range(B):
        if not valid[i]:
            continue
        nt_word_count = 0
        acc_q = 0
        ln = int(lens[i])
        for j in range(ln):
            c = int(codes[i, j])
            q = int(quals[i, j])
            if c == BASE_A:
                f_x = f_x + (dim - f_x) * 0.5
                f_y = f_y * 0.5
            elif c == BASE_C:
                f_x = f_x * 0.5
                f_y = f_y * 0.5
            elif c == BASE_G:
                f_x = f_x * 0.5
                f_y = f_y + (dim - f_y) * 0.5
            elif c == BASE_T:
                f_x = f_x + (dim - f_x) * 0.5
                f_y = f_y + (dim - f_y) * 0.5
            elif c == BASE_N:
                nt_word_count = 0
                acc_q = 0
                continue
            else:
                # reference: non-ACGTN bytes fall through the switch with no
                # counter change (old/chaos_game.c:199-234 has no default)
                continue
            nt_word_count += 1
            acc_q += q

            if nt_word_count == k:
                co_x = int(f_x)
                co_y = int(f_y)
                if co_x == dim:
                    co_x = dim - 1
                    f_x -= CGR_EPSILON
                if co_y == dim:
                    co_y = dim - 1
                    f_y -= CGR_EPSILON
                table_seq[co_x, co_y] += 1
                word_count += 1
                nt_word_count -= 1
                table_q[co_x, co_y] += acc_q - sub
                acc_q -= int(quals[i, j - k + 1])
    return table_seq, table_q, word_count
