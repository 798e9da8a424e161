"""Plain numpy reference of single-end ``stats`` with the inline filter.

It holds the port's results against the reads as they were generated: it
takes the ``(name, seq, qual)`` records that ``tests/gen.make_records``
returns, not the FASTQ file, so neither the shared reader nor the packer
is on its path, and it imports nothing of ``hpgq`` or of the port.  The
semantics are those of ``hpgq/oracle/baseline.py`` (``block_stats`` and
``block_verdicts``; decision tags [D1]-[D3] of ``hpgq/oracle/spec.py``),
without k-mers and without the legacy quality position window.

    want = reference_stats(records, read_quality_range=(20, 60), max_N=2)
    assert_counters_equal(got, want, "label")

The thresholds are the keywords of :func:`hpgq_torch.stats`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MIN_VALUE, MAX_VALUE = 0, 100000  # threshold defaults, hpgq/constants.py
QUAL_BINS, GC_BINS = 256, 101     # hpgq/core/counters.py
BASE_C, BASE_G, BASE_N = 1, 2, 4

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
    fills without k-mers; arrays are as wide as the longest read."""

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
    pos = np.arange(codes.shape[1], dtype=np.int64)[None, :]
    for side in ("left", "right"):
        length, lo, hi = thr[side]
        if length <= MIN_VALUE:
            continue
        w = np.minimum(lens, length)
        if side == "left":
            wmask = pos < w[:, None]
        else:
            wmask = (pos >= (lens - w)[:, None]) & mask
        wqn = np.where(wmask, quals, 0).sum(axis=1) - phred * w
        ok &= (lo * w <= wqn) & (wqn <= hi * w)
    ok &= ((codes == BASE_N) & mask).sum(axis=1) <= thr["max_N"]
    return ok


def reference_stats(records, phred: int = 33, chunk: int = 65536,
                    read_length_range=None, read_quality_range=None,
                    max_N=None, max_out_of_quality=None, left=None,
                    right=None) -> ReferenceCounters:
    """Counters of ``stats`` over ``records`` with the given thresholds,
    as the single-CPU oracle computes them: statistics over the passing
    reads only, integer histogram keys, and ``acc_quality`` the f64 sum of
    each read's f32 mean quality [D1].  With no threshold set the filter
    is off: every read counts, and the passed/failed counts stay 0."""
    filter_on = any(v is not None for v in (
        read_length_range, read_quality_range, max_N, max_out_of_quality,
        left, right))
    thr = {
        "length": _bounds(read_length_range),
        "quality": _bounds(read_quality_range),
        "max_oq": MAX_VALUE if max_out_of_quality is None
        else int(max_out_of_quality),
        "left": _window(left), "right": _window(right),
        "max_N": MAX_VALUE if max_N is None else int(max_N),
    }
    width = max((len(r[1]) for r in records), default=0)
    c = ReferenceCounters(
        min_length=MAX_VALUE,
        length_hist=np.zeros(width + 1, np.int64),
        quality_hist=np.zeros(QUAL_BINS, np.int64),
        gc_hist=np.zeros(GC_BINS, np.int64),
        count_quality_per_nt=np.zeros(width, np.int64),
        acc_quality_per_nt=np.zeros(width, np.int64),
        base_per_nt=np.zeros((5, width), np.int64))
    for at in range(0, len(records), chunk):
        codes, quals, lens, mask = _padded(records[at:at + chunk], phred)
        ok = _verdicts(codes, quals, lens, mask, phred, thr)
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
    if filter_on:
        c.num_passed = c.num_reads
    else:
        c.num_failed = 0
    return c  # min_length stays MAX_VALUE when no read counts


def assert_counters_equal(got, want, label: str,
                          rel_quality: float = 1e-3) -> None:
    """Every integer counter of ``got`` equals ``want`` (arrays compared
    after zero-padding to a common width); ``acc_quality`` to
    ``rel_quality`` relative.  Raises AssertionError naming the field."""
    for key in COUNTER_KEYS:
        a, b = getattr(got, key), getattr(want, key)
        if a != b:
            raise AssertionError("%s: %s %r != reference %r"
                                 % (label, key, a, b))
    for key in COUNTER_ARRAYS:
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
