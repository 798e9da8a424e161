"""``hpgq_torch.oracle``, the jax-free reference that ``chip_smoke.py``
holds the port against on the card, against ``hpgq``'s single-CPU oracle.

The same generated reads go through ``hpgq.oracle.baseline`` (by way of the
shared reader and packer) and through ``reference_stats`` (from the
records themselves); every integer counter must be equal and
``acc_quality`` within 1e-9 relative (both sum the same f32 means in f64,
only in another order).
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
from hpgq_torch.oracle import assert_counters_equal, reference_stats

CORPORA = {
    "golden": dict(n=400, min_len=0, max_len=60, n_prob=0.05,
                   lowercase_prob=0.05, seed=77),
    "binned": dict(n=1500, min_len=100, max_len=100, n_prob=0.01, seed=5,
                   qual_bins=(2, 12, 23, 37)),
    "varlong": dict(n=1200, min_len=60, max_len=190, n_prob=0.01, seed=6),
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
}


def _hpgq_oracle(path, crit):
    acc = StatsCounters(phred=33)
    n_passed = n_failed = 0
    with FastqReader(path, batch_size=512) as rd:
        for block in rd:
            codes, quals, lens, valid = pack_block(block)
            ok = valid
            if crit is not None:
                ok = ob.block_verdicts(codes, quals, lens, crit, 33) & valid
                n_passed += int(ok.sum())
                n_failed += int((valid & ~ok).sum())
            acc = acc.merge(ob.block_stats(codes, quals, lens, ok, phred=33))
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
    got = reference_stats(records, chunk=256, **kw)
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
