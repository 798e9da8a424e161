"""Plain numpy reference of ``stats`` (single-end and paired, with the
inline filter), of the ``filter`` verdict, of ``edit``'s trims and of
``cgr``'s tables.

It holds the port's results against the reads as they were generated: it
takes the ``(name, seq, qual)`` records that ``tests/gen.make_records``
returns, not the FASTQ file, so neither the shared reader nor the packer
is on its path, and it imports nothing of ``hpgq`` or of the port.  The
semantics are those of ``hpgq/oracle/baseline.py`` (``block_stats``,
``block_verdicts``, ``block_trims`` and ``kmer_window_codes``; decision
tags [D1]-[D5] of ``hpgq/oracle/spec.py``), without the legacy quality
position window, and of ``hpgq/oracle/cgr.py`` with any byte other than
A, C, G or T breaking a word ([D7]).

    want = reference_stats(records, read_quality_range=(20, 60), max_N=2)
    assert_counters_equal(got, want, "label")
    ok = reference_verdicts(records, read_quality_range=(20, 60), max_N=2)
    passed_fq = fastq_bytes(records, ok)
    lt, rt = reference_trims(records, left=(10, (28, 60)))
    edit_fq = trimmed_fastq_bytes(records, lt, rt)
    table_seq, table_q, words = reference_cgr(records, k=7)

Reads are taken in order of length, in chunks of about :data:`CHUNK_ELEMS`
padded bases, so a few long reads do not widen every chunk.

The thresholds are the keywords of :func:`hpgq_torch.stats`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MIN_VALUE, MAX_VALUE = 0, 100000  # threshold defaults, hpgq/constants.py
QUAL_BINS, GC_BINS = 256, 101     # hpgq/core/counters.py
BASE_C, BASE_G, BASE_N = 1, 2, 4
KMER_K, NUM_KMERS = 5, 1024       # hpgq/constants.py
CHUNK_ELEMS = 1 << 26             # padded bases per chunk (rows x width)

_LUT = np.full(256, 5, dtype=np.int8)  # A C G T N, either case; other 5
for _code, _ch in enumerate("ACGTN"):
    _LUT[ord(_ch)] = _LUT[ord(_ch.lower())] = _code

COUNTER_KEYS = ("num_reads", "num_passed", "num_failed", "acc_length",
                "min_length", "max_length", "num_As", "num_Cs", "num_Gs",
                "num_Ts", "num_Ns")
COUNTER_ARRAYS = ("length_hist", "quality_hist", "gc_hist",
                  "count_quality_per_nt", "acc_quality_per_nt", "base_per_nt")


@dataclasses.dataclass
class ReferenceCounters:
    """The fields of ``hpgq.core.counters.StatsCounters`` that ``stats``
    fills; arrays are as wide as the longest read, and the k-mer tables
    are None unless asked for."""

    num_reads: int = 0
    num_passed: int = 0
    num_failed: int = 0
    acc_length: int = 0
    min_length: int = 0
    max_length: int = 0
    num_As: int = 0
    num_Cs: int = 0
    num_Gs: int = 0
    num_Ts: int = 0
    num_Ns: int = 0
    acc_quality: float = 0.0
    length_hist: np.ndarray = None
    quality_hist: np.ndarray = None
    gc_hist: np.ndarray = None
    count_quality_per_nt: np.ndarray = None
    acc_quality_per_nt: np.ndarray = None
    base_per_nt: np.ndarray = None
    kmer_counts: np.ndarray = None
    kmer_counts_by_pos: np.ndarray = None


def _bounds(rng, lo=MIN_VALUE, hi=MAX_VALUE):
    """A ``(lo, hi)`` keyword (either end may be None) with the defaults
    of ``FilterCriteria.substituted``."""
    if rng is None:
        return lo, hi
    return (lo if rng[0] is None else int(rng[0]),
            hi if rng[1] is None else int(rng[1]))


def _window(spec):
    """``left``/``right`` keyword ``(length, (lo, hi))`` -> (length, lo, hi);
    length 0 turns the check off."""
    if spec is None:
        return 0, MIN_VALUE, MAX_VALUE
    length, rng = spec
    return (int(length),) + _bounds(rng)


def _padded(records, phred):
    """codes int8, quals int64 (phred not removed), lens int64 of a chunk."""
    lens = np.fromiter((len(r[1]) for r in records), dtype=np.int64,
                       count=len(records))
    width = max(int(lens.max()), 1)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pos = np.arange(width, dtype=np.int64)[None, :]
    mask = pos < lens[:, None]
    idx = np.where(mask, starts[:, None] + pos, 0)
    seq = np.frombuffer(b"".join(r[1] for r in records) or b"\0", np.uint8)
    qual = np.frombuffer(b"".join(r[2] for r in records) or b"\0", np.uint8)
    codes = np.where(mask, _LUT[seq[idx]], np.int8(5))
    quals = np.where(mask, qual[idx].astype(np.int64), 0)
    return codes, quals, lens, mask


def _verdicts(codes, quals, lens, mask, phred, thr):
    """``block_verdicts`` (hpgq/oracle/baseline.py:117-167) without the
    quality position window."""
    (min_len, max_len), (min_q, max_q) = thr["length"], thr["quality"]
    qsum = quals.sum(axis=1)
    ok = (lens >= min_len) & (lens <= max_len)
    qn = qsum - phred * lens
    ok &= (min_q * lens <= qn) & (qn <= max_q * lens)
    if thr["max_oq"] != MAX_VALUE:
        nq = quals - phred
        out = (((nq < min_q) | (nq > max_q)) & mask).sum(axis=1)
        ok &= out <= thr["max_oq"]
    for side in ("left", "right"):
        length, lo, hi = thr[side]
        if length > MIN_VALUE:
            wqn, w = _window_qn(side, length, quals, lens, mask, phred)
            ok &= (lo * w <= wqn) & (wqn <= hi * w)
    ok &= ((codes == BASE_N) & mask).sum(axis=1) <= thr["max_N"]
    return ok


def _window_qn(side, length, quals, lens, mask, phred):
    """(quality sum minus ``phred`` per base, width) of each read's
    ``length``-base window at its ``side`` end, clipped to the read [D3]."""
    pos = np.arange(quals.shape[1], dtype=np.int64)[None, :]
    w = np.minimum(lens, length)
    if side == "left":
        wmask = pos < w[:, None]
    else:
        wmask = (pos >= (lens - w)[:, None]) & mask
    return np.where(wmask, quals, 0).sum(axis=1) - phred * w, w


def _kmers(codes, lens):
    """[D5] (kmer, position) counts of a chunk's valid 5-mer windows,
    ``[NUM_KMERS, L - 4]``, by one ``np.bincount``."""
    W = codes.shape[1] - KMER_K + 1
    if W <= 0:
        return np.zeros((NUM_KMERS, 0), np.int64)
    # int32 keys while kmer * W + pos fits (W < 2M), int64 past that
    dt = np.int32 if NUM_KMERS * W < 2 ** 31 else np.int64
    kc = np.zeros(codes[:, :W].shape, dt)
    ok = np.ones(kc.shape, bool)
    for i in range(KMER_K):
        part = codes[:, i:i + W]
        kc *= 4
        kc += np.minimum(part, 3)
        ok &= part < 4
    ok &= np.arange(W)[None, :] + KMER_K <= lens[:, None]
    kc *= W
    kc += np.arange(W, dtype=dt)[None, :]
    return np.bincount(kc[ok], minlength=NUM_KMERS * W).reshape(NUM_KMERS, W)


def _thresholds(read_length_range=None, read_quality_range=None,
                max_N=None, max_out_of_quality=None, left=None, right=None):
    """(filter on?, thresholds) of the keywords of :func:`reference_stats`;
    with no threshold set the filter is off."""
    filter_on = any(v is not None for v in (
        read_length_range, read_quality_range, max_N, max_out_of_quality,
        left, right))
    return filter_on, {
        "length": _bounds(read_length_range),
        "quality": _bounds(read_quality_range),
        "max_oq": MAX_VALUE if max_out_of_quality is None
        else int(max_out_of_quality),
        "left": _window(left), "right": _window(right),
        "max_N": MAX_VALUE if max_N is None else int(max_N),
    }


def _chunks(records, phred, chunk):
    """(record indices, codes, quals, lens, mask) over chunks of reads in
    order of length, each no more than ``chunk`` padded bases."""
    lengths = np.fromiter((len(r[1]) for r in records), dtype=np.int64,
                          count=len(records))
    order = np.argsort(lengths, kind="stable")
    at = 0
    while at < len(records):
        # the rows of a chunk are no longer than its last (longest) read
        end = at + 1
        while (end < len(records)
               and (end + 1 - at) * max(int(lengths[order[end]]), 1) <= chunk):
            end += 1
        idx = order[at:end]
        yield (idx,) + _padded([records[i] for i in idx], phred)
        at = end


def reference_verdicts(records, phred: int = 33, chunk: int = CHUNK_ELEMS,
                       **thresholds) -> np.ndarray:
    """The ``filter`` verdict of each record, a bool array in input order
    (all True when no threshold is set).  The thresholds are the keywords
    of :func:`reference_stats`."""
    filter_on, thr = _thresholds(**thresholds)
    ok = np.ones(len(records), bool)
    if filter_on:
        for idx, codes, quals, lens, mask in _chunks(records, phred, chunk):
            ok[idx] = _verdicts(codes, quals, lens, mask, phred, thr)
    return ok


def fastq_bytes(records, select) -> bytes:
    """The records where ``select`` is True, in input order, as the FASTQ
    text ``tests/gen.write_fastq`` writes (``name\\nseq\\n+\\nqual\\n``):
    what a ``filter`` output file of those records must hold."""
    return b"".join(b"%s\n%s\n+\n%s\n" % r
                    for r, s in zip(records, select) if s)


def reference_trims(records, phred: int = 33, chunk: int = CHUNK_ELEMS,
                    left=None, right=None):
    """The ``edit`` trims of each record, ``(lt, rt)`` int64 arrays in
    input order ([D4], ``hpgq/oracle/baseline.py:block_trims``): a
    ``left``/``right`` window ``(length, (lo, hi))`` whose mean quality is
    outside ``[lo, hi]`` is cut whole, and the right cut never reaches into
    the left one."""
    lt = np.zeros(len(records), np.int64)
    rt = np.zeros(len(records), np.int64)
    for idx, _, quals, lens, mask in _chunks(records, phred, chunk):
        cut = {}
        for side, spec in (("left", left), ("right", right)):
            length, lo, hi = _window(spec)
            cut[side] = np.zeros(len(idx), np.int64)
            if length > MIN_VALUE:
                wqn, w = _window_qn(side, length, quals, lens, mask, phred)
                cut[side] = np.where((wqn < lo * w) | (wqn > hi * w), w, 0)
        lt[idx] = cut["left"]
        rt[idx] = np.minimum(cut["right"], lens - cut["left"])
    return lt, rt


def trimmed_records(records, lt, rt):
    """The records with ``lt`` bases cut from the left of the sequence and
    quality, ``rt`` from the right."""
    return [(n, s[a:len(s) - b], q[a:len(q) - b])
            for (n, s, q), a, b in zip(records, lt, rt)]


def trimmed_fastq_bytes(records, lt, rt, select=None) -> bytes:
    """What an ``edit`` output file of the trimmed records where
    ``select`` is True (all when None) must hold, in input order."""
    if select is None:
        select = np.ones(len(records), bool)
    return fastq_bytes(trimmed_records(records, lt, rt), select)


# the chaos game's x and y bit of each base code (A C G T N other)
_CGR_X = np.array([1, 0, 0, 1, 0, 0], np.int32)
_CGR_Y = np.array([0, 0, 1, 1, 0, 0], np.int32)


def reference_cgr(records, k: int, phred: int = 33, chunk: int = CHUNK_ELEMS):
    """``cgr``'s tables over ``records``: ``(table_seq, table_q, words)``,
    int64 ``[2^k, 2^k]`` tables and the word count.  A word is a window of
    k bases inside one read holding only A, C, G or T (either case; an N or
    any other byte breaks it, [D7]); its cell is the k-bit x and y codes of
    the chaos game's closed form (``hpgq/kernels/cgr.py:1-23``: the base at
    window offset ``t`` weighs ``2^t``, x set for A and T, y for G and T),
    and its quality weight is the window's quality sum minus ``phred*k``."""
    dim = 1 << k
    cell_of = _CGR_X * dim + _CGR_Y  # a base's bits as a cell offset
    table_seq = np.zeros(dim * dim, np.int64)
    table_q = np.zeros(dim * dim, np.int64)
    words = 0
    for _, codes, quals, lens, _ in _chunks(records, phred, chunk):
        W = codes.shape[1] - k + 1
        if W <= 0:
            continue
        q = quals.astype(np.int32)
        cell = np.zeros(codes[:, :W].shape, np.int32)  # k <= 15
        qsum = np.zeros(cell.shape, np.int32)
        ok = np.arange(W)[None, :] + k <= lens[:, None]
        for t in range(k):
            part = codes[:, t:t + W]
            cell += cell_of[part] << t
            qsum += q[:, t:t + W]
            ok &= part < 4
        words += int(ok.sum())
        table_seq += np.bincount(cell[ok], minlength=dim * dim)
        # float64 weights add exactly: a chunk's total stays far below 2^53
        table_q += np.rint(np.bincount(cell[ok], weights=qsum[ok] - phred * k,
                                       minlength=dim * dim)).astype(np.int64)
    return table_seq.reshape(dim, dim), table_q.reshape(dim, dim), words


def reference_paired_stats(records1, records2, phred: int = 33,
                           chunk: int = CHUNK_ELEMS, kmers: bool = False,
                           **thresholds):
    """Counters of paired ``stats`` for both mates, ``(c1, c2)``: each
    mate's statistics over the pairs where both mates pass; with a filter,
    ``num_passed``/``num_failed`` count pairs and are the same in both."""
    if len(records1) != len(records2):
        raise ValueError("mates hold %d and %d records"
                         % (len(records1), len(records2)))
    filter_on, _ = _thresholds(**thresholds)
    sel = (reference_verdicts(records1, phred, chunk, **thresholds)
           & reference_verdicts(records2, phred, chunk, **thresholds))
    out = []
    for records in (records1, records2):
        c = reference_stats([r for r, s in zip(records, sel) if s], phred,
                            chunk, kmers=kmers)
        if filter_on:
            c.num_passed, c.num_failed = int(sel.sum()), int((~sel).sum())
        out.append(c)
    return tuple(out)


def reference_stats(records, phred: int = 33, chunk: int = CHUNK_ELEMS,
                    read_length_range=None, read_quality_range=None,
                    max_N=None, max_out_of_quality=None, left=None,
                    right=None, kmers: bool = False) -> ReferenceCounters:
    """Counters of ``stats`` over ``records`` with the given thresholds,
    as the single-CPU oracle computes them: statistics over the passing
    reads only, integer histogram keys, and ``acc_quality`` the f64 sum of
    each read's f32 mean quality [D1].  With no threshold set the filter
    is off: every read counts, and the passed/failed counts stay 0.
    ``kmers`` adds ``kmer_counts`` and ``kmer_counts_by_pos``.  ``chunk``
    bounds the padded bases (rows x width) of one chunk."""
    filter_on, thr = _thresholds(read_length_range, read_quality_range,
                                 max_N, max_out_of_quality, left, right)
    width = max((len(r[1]) for r in records), default=0)
    c = ReferenceCounters(
        min_length=MAX_VALUE,
        length_hist=np.zeros(width + 1, np.int64),
        quality_hist=np.zeros(QUAL_BINS, np.int64),
        gc_hist=np.zeros(GC_BINS, np.int64),
        count_quality_per_nt=np.zeros(width, np.int64),
        acc_quality_per_nt=np.zeros(width, np.int64),
        base_per_nt=np.zeros((5, width), np.int64))
    if kmers:
        c.kmer_counts_by_pos = np.zeros((NUM_KMERS, width), np.int64)
    for _, codes, quals, lens, mask in _chunks(records, phred, chunk):
        ok = _verdicts(codes, quals, lens, mask, phred, thr) if filter_on \
            else np.ones(lens.shape, bool)
        c.num_reads += int(ok.sum())
        c.num_failed += int((~ok).sum())
        if not ok.any():
            continue
        codes, quals, lens, mask = codes[ok], quals[ok], lens[ok], mask[ok]
        L = codes.shape[1]
        qsum = quals.sum(axis=1)
        c.acc_length += int(lens.sum())
        c.min_length = min(c.min_length, int(lens.min()))
        c.max_length = max(c.max_length, int(lens.max()))
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(lens > 0, qsum.astype(np.float32)
                            / lens.astype(np.float32), np.float32(0))
        c.acc_quality += float(mean.astype(np.float64).sum())
        c.length_hist += np.bincount(lens, minlength=width + 1)
        qkey = (2 * qsum + lens) // np.maximum(2 * lens, 1)
        c.quality_hist += np.bincount(np.clip(qkey, 0, QUAL_BINS - 1),
                                      minlength=QUAL_BINS)
        per_base = [((codes == b) & mask) for b in range(5)]
        nz = lens > 0  # a read of length 0 takes no GC key
        gc = (per_base[BASE_G].sum(axis=1) + per_base[BASE_C].sum(axis=1))
        gckey = 100 * gc[nz] // lens[nz]
        c.gc_hist += np.bincount(np.clip(gckey, 0, GC_BINS - 1),
                                 minlength=GC_BINS)
        c.count_quality_per_nt[:L] += mask.sum(axis=0)
        c.acc_quality_per_nt[:L] += quals.sum(axis=0)
        for b in range(5):
            c.base_per_nt[b, :L] += per_base[b].sum(axis=0)
        c.num_As, c.num_Cs, c.num_Gs, c.num_Ts, c.num_Ns = (
            n + int(m.sum()) for n, m in zip(
                (c.num_As, c.num_Cs, c.num_Gs, c.num_Ts, c.num_Ns),
                per_base))
        if kmers:
            k2d = _kmers(codes, lens)
            c.kmer_counts_by_pos[:, :k2d.shape[1]] += k2d
    if kmers:
        c.kmer_counts = c.kmer_counts_by_pos.sum(axis=1)
    if filter_on:
        c.num_passed = c.num_reads
    else:
        c.num_failed = 0
    return c  # min_length stays MAX_VALUE when no read counts


def _has_kmers(c) -> bool:
    """A StatsCounters says so itself; a ReferenceCounters by its tables."""
    return bool(getattr(c, "kmers_on", c.kmer_counts is not None))


def assert_counters_equal(got, want, label: str,
                          rel_quality: float = 1e-3) -> None:
    """Every integer counter of ``got`` equals ``want`` (arrays compared
    after zero-padding to a common width), the k-mer tables too when
    ``want`` has them; ``acc_quality`` to ``rel_quality`` relative.  Raises
    AssertionError naming the field."""
    arrays = COUNTER_ARRAYS
    kmers = [_has_kmers(x) for x in (got, want)]
    if any(kmers):
        if not all(kmers):
            raise AssertionError("%s: kmer tables on one side only" % label)
        arrays += ("kmer_counts", "kmer_counts_by_pos")
    for key in COUNTER_KEYS:
        a, b = getattr(got, key), getattr(want, key)
        if a != b:
            raise AssertionError("%s: %s %r != reference %r"
                                 % (label, key, a, b))
    for key in arrays:
        a, b = getattr(got, key), getattr(want, key)
        m = max(a.shape[-1], b.shape[-1])
        a, b = (np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, m - x.shape[-1])])
                for x in (a, b))
        if not np.array_equal(a, b):
            raise AssertionError("%s: %s differs from the reference"
                                 % (label, key))
    a, b = got.acc_quality, want.acc_quality
    if abs(a - b) > rel_quality * max(1.0, abs(b)):
        raise AssertionError("%s: acc_quality %r vs reference %r"
                             % (label, a, b))
