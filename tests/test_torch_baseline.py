"""``hpgq_torch/baseline.py``, the single-CPU oracle of
``tools/ab_torch.py``, equals ``hpgq.oracle.baseline`` and
``hpgq.oracle.cgr`` on seeded numpy inputs: every counter, verdict, trim
and CGR cell exact, ``acc_quality`` to 1e-12 relative (both sum the same
f32 means in f64).
"""

import numpy as np
import pytest

import hpgq.oracle.baseline as hbl
from hpgq.oracle.cgr import fill_tables_loop as h_fill_tables_loop
from hpgq.options import FilterCriteria as HFilterCriteria
from hpgq_torch import baseline as pbl
from hpgq_torch.options import FilterCriteria


def _batch(seed, B=300, L=160, binned=False):
    """(codes int8, quals uint8, lens int32, valid bool), the packer's
    layout: code 5 and quality 0 past each read's length."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = 4
    if binned:
        quals = (np.array([2, 12, 23, 37])[rng.integers(0, 4, size=(B, L))]
                 + 33).astype(np.uint8)
    else:
        quals = rng.integers(35, 75, size=(B, L)).astype(np.uint8)
    inside = np.arange(L)[None, :] < lens[:, None]
    return (np.where(inside, codes, np.int8(5)),
            np.where(inside, quals, np.uint8(0)), lens, rng.random(B) < 0.9)


CRITERIA = {
    "none": {},
    "bench": dict(min_read_length=50, max_read_length=200,
                  min_read_quality=20, max_read_quality=60, max_N=2),
    "windows": dict(left_length=10, min_left_quality=28, max_left_quality=60,
                    right_length=6, min_right_quality=20,
                    max_out_of_quality=40),
    "quality window": dict(min_read_quality=15, max_read_quality=30,
                           begin_quality_nt=5, end_quality_nt=60,
                           max_out_of_quality=30),
}


def _counters_same(a, b):
    for name in vars(b):
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray) or isinstance(x, np.ndarray):
            assert np.array_equal(x, y), name
        elif isinstance(y, float):
            assert x == pytest.approx(y, rel=1e-12), name
        else:
            assert x == y, name


@pytest.mark.parametrize("binned", [False, True], ids=["uniform", "binned"])
@pytest.mark.parametrize("name", list(CRITERIA))
def test_baseline_copy_equals_hpgq(name, binned):
    """``block_verdicts``, ``block_stats`` (k-mers off and on) and
    ``block_trims`` of the port's copy equal ``hpgq.oracle.baseline``'s."""
    codes, quals, lens, valid = _batch(17 + binned, binned=binned)
    kw = CRITERIA[name]
    pc, hc = FilterCriteria(**kw), HFilterCriteria(**kw)
    ok = pbl.block_verdicts(codes, quals, lens, pc, 33)
    np.testing.assert_array_equal(ok, hbl.block_verdicts(codes, quals, lens,
                                                         hc, 33))
    for kmers in (False, True):
        _counters_same(pbl.block_stats(codes, quals, lens, ok & valid, kmers),
                       hbl.block_stats(codes, quals, lens, ok & valid, kmers))
    for got, want in zip(pbl.block_trims(quals, lens, pc, 33),
                         hbl.block_trims(quals, lens, hc, 33)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 4, 7])
def test_fill_tables_loop_copy_equals_hpgq(k):
    """The CGR loop's copy equals ``hpgq.oracle.cgr.fill_tables_loop``,
    codes of any kind (code 5 falls through) and invalid rows included."""
    codes, quals, lens, valid = _batch(40 + k, B=60, L=90)
    codes[::7, 3] = 5
    got = pbl.fill_tables_loop(codes, quals, lens, valid, k, 33)
    want = h_fill_tables_loop(codes, quals, lens, valid, k, 33)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2] > 0
