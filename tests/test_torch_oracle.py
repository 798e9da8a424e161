"""``hpgq_torch.oracle``, the jax-free reference that ``chip_smoke.py``
holds the port against on the card, against ``hpgq``'s single-CPU oracle.

The same generated reads go through ``hpgq.oracle.baseline`` (by way of the
shared reader and packer) and through ``reference_stats`` (from the
records themselves); every integer counter must be equal, the k-mer
tables too when asked for, and ``acc_quality`` within 1e-9 relative (both
sum the same f32 means in f64, only in another order).  The trims equal
``block_trims`` and ``spec.trim_lengths``, the CGR tables the reference's
loop (``hpgq.oracle.cgr.fill_tables_loop``), exactly.
"""

import dataclasses

import numpy as np
import pytest

from gen import make_fastq

from hpgq.core.counters import StatsCounters
from hpgq.io.fastq import FastqReader
from hpgq.io.packer import pack_block
from hpgq.oracle import baseline as ob
from hpgq_torch.api import filter_criteria
from hpgq_torch.oracle import (
    assert_counters_equal,
    fastq_bytes,
    reference_cgr,
    reference_paired_stats,
    reference_stats,
    reference_trims,
    reference_verdicts,
    trimmed_fastq_bytes,
    trimmed_records,
)

CORPORA = {
    "golden": dict(n=400, min_len=0, max_len=60, n_prob=0.05,
                   lowercase_prob=0.05, seed=77),
    "binned": dict(n=1500, min_len=100, max_len=100, n_prob=0.01, seed=5,
                   qual_bins=(2, 12, 23, 37)),
    "varlong": dict(n=1200, min_len=60, max_len=190, n_prob=0.01, seed=6),
    "long": dict(n=40, min_len=3000, max_len=9000, n_prob=0.002, seed=13),
}
BENCH = dict(read_length_range=(50, 200), read_quality_range=(20, 60),
             max_N=2)
FILTERS = {
    "none": {},
    "bench": BENCH,
    "all": dict(BENCH, max_out_of_quality=30, left=(8, (10, 60)),
                right=(8, (10, 60))),
    "windows": dict(left=(8, (20, 60)), right=(8, (25, None))),
    "out_of_quality": dict(read_quality_range=(15, 40),
                           max_out_of_quality=30),
    # [D8] the legacy quality position window: on short reads, and past
    # 512 columns and past the read's end on the long ones
    "quality_window": dict(read_quality_range=(20, 23),
                           quality_window=(10, 40)),
    "window_oq": dict(read_quality_range=(15, 40), max_out_of_quality=5,
                      quality_window=(30, 5000)),
    "window_long": dict(read_quality_range=(21, 22),
                        quality_window=(500, 900)),
}


def _hpgq_oracle(path, crit, kmers=False):
    acc = StatsCounters(phred=33, kmers_on=kmers)
    n_passed = n_failed = 0
    with FastqReader(path, batch_size=512) as rd:
        for block in rd:
            codes, quals, lens, valid = pack_block(block)
            ok = valid
            if crit is not None:
                ok = ob.block_verdicts(codes, quals, lens, crit, 33) & valid
                n_passed += int(ok.sum())
                n_failed += int((valid & ~ok).sum())
            acc = acc.merge(ob.block_stats(codes, quals, lens, ok,
                                           kmers_on=kmers, phred=33))
    acc.num_passed, acc.num_failed = n_passed, n_failed
    return acc


def _records(tmp_path, name):
    kw = dict(CORPORA[name])
    path = str(tmp_path / ("%s.fq" % name))
    return path, make_fastq(path, kw.pop("n"), **kw)


@pytest.mark.parametrize("setting", list(FILTERS))
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_reference_equals_hpgq_oracle(tmp_path, corpus, setting):
    path, records = _records(tmp_path, corpus)
    kw = FILTERS[setting]
    want = _hpgq_oracle(path, filter_criteria(**kw))
    got = reference_stats(records, chunk=16384, **kw)
    assert_counters_equal(got, want, "%s/%s" % (corpus, setting),
                          rel_quality=1e-9)
    if kw:
        assert got.num_passed + got.num_failed == len(records)


@pytest.mark.parametrize("field", ["num_Gs", "gc_hist", "num_failed",
                                   "acc_quality"])
def test_reference_comparison_catches_one_wrong_field(tmp_path, field):
    _, records = _records(tmp_path, "varlong")
    want = reference_stats(records, **BENCH)
    value = getattr(want, field)
    if isinstance(value, np.ndarray):
        value = value.copy()
        value[int(np.argmax(value))] += 1
    elif isinstance(value, float):
        value *= 1.01
    else:
        value += 1
    got = dataclasses.replace(want, **{field: value})
    with pytest.raises(AssertionError, match=field):
        assert_counters_equal(got, want, "mutated")


@pytest.mark.parametrize("setting", ["none", "bench", "long"])
@pytest.mark.parametrize("corpus", ["golden", "varlong", "long"])
def test_reference_kmers_equal_hpgq_oracle(tmp_path, corpus, setting):
    """``kmers=True``: both k-mer tables equal the baseline's
    (``np.add.at`` there, one ``np.bincount`` per chunk here), over chunks
    of a few rows and over one chunk."""
    path, records = _records(tmp_path, corpus)
    kw = {"none": {}, "bench": BENCH,
          "long": dict(read_length_range=(4000, 8000), max_N=20)}[setting]
    want = _hpgq_oracle(path, filter_criteria(**kw), kmers=True)
    for chunk in (20000, 1 << 26):
        got = reference_stats(records, chunk=chunk, kmers=True, **kw)
        assert got.kmer_counts_by_pos.shape[1] == max(len(r[1])
                                                      for r in records)
        assert_counters_equal(got, want, "%s/%s kmers" % (corpus, setting),
                              rel_quality=1e-9)
    if corpus == "long" and setting == "none":
        assert int(got.kmer_counts.sum()) > 100000


def test_reference_comparison_needs_kmer_tables_on_both_sides(tmp_path):
    _, records = _records(tmp_path, "golden")
    with_k = reference_stats(records, kmers=True)
    without = reference_stats(records)
    with pytest.raises(AssertionError, match="one side only"):
        assert_counters_equal(without, with_k, "no tables")
    with_k.kmer_counts_by_pos[7, 3] += 1
    with pytest.raises(AssertionError, match="kmer_counts_by_pos"):
        assert_counters_equal(with_k, reference_stats(records, kmers=True),
                              "mutated")


def test_reference_counts_reads_over_100000_without_filter(tmp_path):
    """With no threshold set every read counts, also one longer than the
    MAX sentinel (100000) that a length check would reject."""
    path = str(tmp_path / "huge.fq")
    records = make_fastq(path, 3, min_len=100001, max_len=100100, seed=3)
    want = _hpgq_oracle(path, None)
    got = reference_stats(records)
    assert got.num_reads == 3 and got.max_length > 100000
    assert_counters_equal(got, want, "over 100000", rel_quality=1e-9)
    filtered = reference_stats(records, max_N=5)
    assert (filtered.num_reads, filtered.num_failed) == (0, 3)


@pytest.mark.parametrize("setting", list(FILTERS))
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_reference_verdicts_equal_block_verdicts(tmp_path, corpus, setting):
    """``reference_verdicts`` (in input order, computed in length-ordered
    chunks) equals ``hpgq.oracle.baseline.block_verdicts`` over the same
    records read back through the shared reader and packer."""
    path, records = _records(tmp_path, corpus)
    kw = FILTERS[setting]
    want = []
    crit = filter_criteria(**kw)
    with FastqReader(path, batch_size=512) as rd:
        for block in rd:
            codes, quals, lens, valid = pack_block(block)
            ok = valid if crit is None else \
                ob.block_verdicts(codes, quals, lens, crit, 33) & valid
            want.append(ok[:block.num_reads])
    want = np.concatenate(want)
    for chunk in (16384, 1 << 26):
        got = reference_verdicts(records, chunk=chunk, **kw)
        assert got.dtype == bool and got.shape == (len(records),)
        np.testing.assert_array_equal(got, want)
    if setting == "bench" and corpus != "long":
        assert 0 < int(want.sum()) < len(records)


@pytest.mark.parametrize("setting", ["none", "bench", "kmers"])
def test_reference_paired_stats_equal_hpgq(tmp_path, setting):
    """``reference_paired_stats`` equals ``hpgq``'s paired ``stats`` on the
    CPU: each mate's statistics over the pairs where both mates pass,
    passed/failed counted per pair in both counters; ``acc_quality`` to
    1e-6 relative (``hpgq`` sums f32 means in f32)."""
    import hpgq

    p1, r1 = _records(tmp_path, "varlong")
    p2 = str(tmp_path / "mate2.fq")
    kw = dict(CORPORA["varlong"], seed=16)
    r2 = make_fastq(p2, kw.pop("n"), **kw)
    th = {"none": {}, "bench": BENCH, "kmers": BENCH}[setting]
    kmers = setting == "kmers"
    want = hpgq.stats(p1, p2, outdir=str(tmp_path), kmers=kmers, **th)
    got = reference_paired_stats(r1, r2, kmers=kmers, **th)
    for mate, g, w in zip((1, 2), got, want):  # hpgq sums f32 on device
        assert_counters_equal(g, w, "mate %d" % mate, rel_quality=1e-6)
    if th:
        assert 0 < got[0].num_passed < len(r1)
        assert got[0].num_passed + got[0].num_failed == len(r1)
        assert (got[1].num_passed, got[1].num_failed) == \
            (got[0].num_passed, got[0].num_failed)
    with pytest.raises(ValueError, match="mates hold"):
        reference_paired_stats(r1, r2[:-1])


def test_fastq_bytes_is_the_written_file(tmp_path):
    """All records selected give the generated file's bytes; a selection
    keeps input order."""
    path, records = _records(tmp_path, "golden")
    with open(path, "rb") as f:
        assert fastq_bytes(records, np.ones(len(records), bool)) == f.read()
    sel = np.arange(len(records)) % 3 == 1
    assert fastq_bytes(records, sel) == b"".join(
        b"%s\n%s\n+\n%s\n" % records[i] for i in np.flatnonzero(sel))


TRIMS = {
    "left": dict(left=(10, (28, 60))),
    "right": dict(right=(12, (20, None))),
    "both": dict(left=(8, (28, 60)), right=(6, (28, 60))),
    "windows past the read": dict(left=(300, (25, None)),
                                  right=(200, (15, 40))),
}


@pytest.mark.parametrize("setting", list(TRIMS))
@pytest.mark.parametrize("corpus", ["golden", "varlong", "long"])
def test_reference_trims_equal_block_trims_and_spec(tmp_path, corpus,
                                                    setting):
    """``reference_trims`` (length-ordered chunks, input order out) equals
    ``baseline.block_trims`` over the packed blocks and the per-read
    ``spec.trim_lengths``."""
    from hpgq.oracle import spec

    path, records = _records(tmp_path, corpus)
    kw = TRIMS[setting]
    crit = filter_criteria(**kw)
    want = []
    with FastqReader(path, batch_size=512) as rd:
        for block in rd:
            codes, quals, lens, _ = pack_block(block)
            lt, rt = ob.block_trims(quals, lens, crit, 33)
            want.append(np.stack([lt, rt])[:, :block.num_reads])
    want = np.concatenate(want, axis=1)
    sub = crit.substituted()
    per_read = np.array([spec.trim_lengths(s, q, sub, 33)
                         for _, s, q in records]).T
    np.testing.assert_array_equal(per_read, want)
    for chunk in (4096, 1 << 26):
        lt, rt = reference_trims(records, chunk=chunk, **kw)
        np.testing.assert_array_equal(np.stack([lt, rt]), want)
    assert want.any()


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_trimmed_fastq_bytes_are_hpgq_edit_outputs(tmp_path, paired):
    """The trims and the post-filter verdict of the trimmed reads give
    ``hpgq.edit``'s ``edit`` and ``failed`` files byte for byte."""
    import hpgq

    path, r1 = _records(tmp_path, "varlong")
    inputs, recs = [path], [r1]
    if paired:
        inputs.append(str(tmp_path / "mate2.fq"))
        kw = dict(CORPORA["varlong"], seed=17)
        recs.append(make_fastq(inputs[1], kw.pop("n"), **kw))
    post = dict(read_quality_range=(20, 45), max_N=2)
    res = hpgq.edit(*inputs, outdir=str(tmp_path / "out"), left_length=8,
                    left_quality_range=(28, 60), right_length=6,
                    right_quality_range=(28, 60), filter_after=True, **post)
    trims = [reference_trims(r, **TRIMS["both"]) for r in recs]
    sel = np.ones(len(r1), bool)
    for r, (lt, rt) in zip(recs, trims):
        sel &= reference_verdicts(trimmed_records(r, lt, rt), **post)
    names = (["edit.fq"], ["failed.fq"]) if not paired else (
        ["edit_1.fq", "edit_2.fq"], ["failed_1.fq", "failed_2.fq"])
    for group, s in zip(names, (sel, ~sel)):
        for name, r, (lt, rt) in zip(group, recs, trims):
            with open(str(tmp_path / "out" / name), "rb") as f:
                assert f.read() == trimmed_fastq_bytes(r, lt, rt, s), name
    assert res["num_passed"] == int(sel.sum()) > 0
    assert res["num_edited"] == sum(int(((lt > 0) | (rt > 0)).sum())
                                    for lt, rt in trims)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_reference_cgr_equals_loop_oracle(tmp_path, k):
    """``reference_cgr`` equals the reference's CGR loop over the packed
    blocks, with code 5 (IUPAC bytes, planted here) mapped to N: the
    kernels treat such bytes as N ([D7])."""
    from gen import make_records, write_fastq
    from hpgq.oracle.cgr import fill_tables_loop

    records = make_records(250, min_len=0, max_len=90, n_prob=0.03,
                           lowercase_prob=0.05, seed=40 + k)
    rng = np.random.default_rng(k)
    for i in rng.choice(len(records), 60, replace=False):
        name, seq, qual = records[i]
        if seq:
            j = int(rng.integers(len(seq)))
            records[i] = (name, seq[:j] + b"R" + seq[j + 1:], qual)
    path = str(tmp_path / "cgr.fq")
    write_fastq(path, records)
    dim = 1 << k
    want = [np.zeros((dim, dim), np.int64), np.zeros((dim, dim), np.int64), 0]
    with FastqReader(path, batch_size=100) as rd:
        for block in rd:
            codes, quals, lens, valid = pack_block(block)
            codes = np.where(codes == 5, np.int8(4), codes)
            for i, x in enumerate(fill_tables_loop(codes, quals, lens, valid,
                                                   k, 33)):
                want[i] += x
    for chunk in (2000, 1 << 26):
        ts, tq, words = reference_cgr(records, k, chunk=chunk)
        np.testing.assert_array_equal(ts, want[0])
        np.testing.assert_array_equal(tq, want[1])
        assert words == want[2] > 0
