"""The counters of ``stats`` with the inline filter, in plain numpy.

A frozen copy of the arithmetic of ``hpgq_torch/oracle.py``
(``reference_stats`` and its ``_verdicts``), kept here so that a later
change to the program cannot move the yardstick.  It reads the records as
the traffic generator made them (:class:`benchmark.traffic.generate.Corpus`:
flat bases, flat qualities and lengths), not the FASTQ file, so the
program's reader and packer are judged too.

Semantics: a read counts when it passes every threshold (length, mean
quality, N count); the statistics cover the passing reads only; keys of
the histograms are integers; ``acc_quality`` is the float64 sum of each
passing read's float32 mean quality.

The controls (:data:`CONTROLS`, :func:`lowered`) put one of those two
floats one precision step below what the configuration states:
``sum_float32`` sums the float32 means in a float32 running total, read by
read in input order; ``means_bfloat16`` takes each mean in bfloat16 (its
quality sum, its length and their quotient rounded to bfloat16) and sums
them in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MIN_VALUE, MAX_VALUE = 0, 100000   # threshold defaults
QUAL_BINS, GC_BINS = 256, 101
BASE_C, BASE_G, BASE_N = 1, 2, 4
CHUNK_ELEMS = 1 << 24              # padded bases per chunk (rows x width)
CONTROLS = ("sum_float32", "means_bfloat16")

# base byte -> code: A C G T N in either case, any other byte 5
_LUT = np.full(256, 5, dtype=np.int8)
for _code, _ch in enumerate("ACGTN"):
    _LUT[ord(_ch)] = _LUT[ord(_ch.lower())] = _code

# the integer fields, then the arrays, of the program's StatsCounters
SCALARS = ("num_reads", "num_passed", "num_failed", "acc_length",
           "min_length", "max_length", "num_As", "num_Cs", "num_Gs",
           "num_Ts", "num_Ns")
ARRAYS = ("length_hist", "quality_hist", "gc_hist", "count_quality_per_nt",
          "acc_quality_per_nt", "base_per_nt")


@dataclasses.dataclass
class Counters:
    """What ``stats`` counts; arrays as wide as the longest read."""

    phred: int = 33
    filter_on: bool = True
    num_reads: int = 0
    num_passed: int = 0
    num_failed: int = 0
    acc_length: int = 0
    min_length: int = MAX_VALUE
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
    # each passing read's quality sum and length, in input order: what
    # ``acc_quality`` is worked out from (compared through it alone)
    passed_quality_sums: np.ndarray = None
    passed_lengths: np.ndarray = None

    @property
    def lcap(self) -> int:
        return self.count_quality_per_nt.shape[0]

    def num_nucleotides(self) -> int:
        return self.num_As + self.num_Cs + self.num_Gs + self.num_Ts + self.num_Ns


def bfloat16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even), as
    float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def acc_quality(quality_sums, lengths, control=None) -> float:
    """The sum of each read's mean quality: float32 means summed in
    float64, or as the control ``control`` (one of :data:`CONTROLS`) has
    it."""
    q, n = quality_sums.astype(np.float32), lengths.astype(np.float32)
    if control == "means_bfloat16":
        q, n = bfloat16(q), bfloat16(n)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(lengths > 0, q / n, np.float32(0)).astype(np.float32)
    if control == "means_bfloat16":
        mean = bfloat16(mean)
    if control == "sum_float32":
        return float(np.cumsum(mean, dtype=np.float32)[-1]) if mean.size else 0.0
    return float(mean.astype(np.float64).sum())


def lowered(c: Counters, control: str) -> Counters:
    """The counters ``c`` as the control ``control`` gives them: the same
    integers, ``acc_quality`` one precision step lower."""
    if control not in CONTROLS:
        raise ValueError("no control named %r" % control)
    return dataclasses.replace(c, acc_quality=acc_quality(
        c.passed_quality_sums, c.passed_lengths, control))


def thresholds(filter_spec: dict) -> dict:
    """The thresholds of a configuration's ``filter`` object
    (``read_length_range``, ``read_quality_range``, ``max_N``), with the
    defaults of an unset one."""
    lo_len, hi_len = filter_spec.get("read_length_range") or (MIN_VALUE, MAX_VALUE)
    lo_q, hi_q = filter_spec.get("read_quality_range") or (MIN_VALUE, MAX_VALUE)
    max_n = filter_spec.get("max_N")
    return {"length": (int(lo_len), int(hi_len)),
            "quality": (int(lo_q), int(hi_q)),
            "max_N": MAX_VALUE if max_n is None else int(max_n)}


def _chunks(corpus, chunk):
    """(read indices, codes, quals, lens, mask) over chunks of reads in
    order of length, each no more than ``chunk`` padded bases."""
    lens = corpus.lens
    starts = corpus.starts
    order = np.argsort(lens, kind="stable")
    by_len = np.maximum(lens[order], 1)
    at, n = 0, len(lens)
    while at < n:
        # the rows of a chunk are no longer than its last (longest) read
        end = min(n, at + max(1, chunk // int(by_len[at])))
        while end - at > 1 and (end - at) * int(by_len[end - 1]) > chunk:
            end = at + max(1, chunk // int(by_len[end - 1]))
        idx = order[at:end]
        ln = lens[idx]
        width = max(int(ln.max()), 1)
        pos = np.arange(width, dtype=np.int64)[None, :]
        mask = pos < ln[:, None]
        gather = np.where(mask, starts[idx][:, None] + pos, 0)
        codes = np.where(mask, _LUT[corpus.seq[gather]], np.int8(5))
        quals = np.where(mask, corpus.qual[gather].astype(np.int64), 0)
        yield idx, codes, quals, ln, mask
        at = end


def _verdicts(codes, quals, lens, mask, phred, thr):
    """Which reads pass: length, mean quality (quality sum minus ``phred``
    per base, against the range times the length) and N count."""
    (min_len, max_len), (min_q, max_q) = thr["length"], thr["quality"]
    ok = (lens >= min_len) & (lens <= max_len)
    qn = quals.sum(axis=1) - phred * lens
    ok &= (min_q * lens <= qn) & (qn <= max_q * lens)
    ok &= ((codes == BASE_N) & mask).sum(axis=1) <= thr["max_N"]
    return ok


def reference_stats(corpus, filter_spec: dict, phred: int = 33,
                    chunk: int = CHUNK_ELEMS) -> Counters:
    """The counters of ``stats`` over ``corpus`` with the filter
    ``filter_spec`` (a configuration's ``filter`` object)."""
    thr = thresholds(filter_spec)
    width = int(corpus.lens.max()) if len(corpus.lens) else 0
    c = Counters(
        phred=phred,
        length_hist=np.zeros(width + 1, np.int64),
        quality_hist=np.zeros(QUAL_BINS, np.int64),
        gc_hist=np.zeros(GC_BINS, np.int64),
        count_quality_per_nt=np.zeros(width, np.int64),
        acc_quality_per_nt=np.zeros(width, np.int64),
        base_per_nt=np.zeros((5, width), np.int64))
    qsums = np.zeros(len(corpus.lens), np.int64)
    passed = np.zeros(len(corpus.lens), bool)
    for idx, codes, quals, lens, mask in _chunks(corpus, chunk):
        ok = _verdicts(codes, quals, lens, mask, phred, thr)
        c.num_reads += int(ok.sum())
        c.num_failed += int((~ok).sum())
        if not ok.any():
            continue
        passed[idx] = ok
        idx, codes, quals, lens, mask = idx[ok], codes[ok], quals[ok], lens[ok], mask[ok]
        L = codes.shape[1]
        qsum = quals.sum(axis=1)
        c.acc_length += int(lens.sum())
        c.min_length = min(c.min_length, int(lens.min()))
        c.max_length = max(c.max_length, int(lens.max()))
        qsums[idx] = qsum
        c.length_hist += np.bincount(lens, minlength=width + 1)
        qkey = (2 * qsum + lens) // np.maximum(2 * lens, 1)
        c.quality_hist += np.bincount(np.clip(qkey, 0, QUAL_BINS - 1),
                                      minlength=QUAL_BINS)
        per_base = [((codes == b) & mask) for b in range(5)]
        nz = lens > 0
        gc = per_base[BASE_G].sum(axis=1) + per_base[BASE_C].sum(axis=1)
        gckey = 100 * gc[nz] // lens[nz]
        c.gc_hist += np.bincount(np.clip(gckey, 0, GC_BINS - 1), minlength=GC_BINS)
        c.count_quality_per_nt[:L] += mask.sum(axis=0)
        c.acc_quality_per_nt[:L] += quals.sum(axis=0)
        for b in range(5):
            c.base_per_nt[b, :L] += per_base[b].sum(axis=0)
        c.num_As, c.num_Cs, c.num_Gs, c.num_Ts, c.num_Ns = (
            n + int(m.sum()) for n, m in zip(
                (c.num_As, c.num_Cs, c.num_Gs, c.num_Ts, c.num_Ns), per_base))
    c.num_passed = c.num_reads
    c.passed_quality_sums, c.passed_lengths = qsums[passed], corpus.lens[passed]
    c.acc_quality = acc_quality(c.passed_quality_sums, c.passed_lengths)
    return c
