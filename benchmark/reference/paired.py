"""The counters of paired ``stats`` with the inline filter, in plain numpy.

A frozen copy of the paired semantics of ``hpgq_torch/oracle.py``
(``reference_paired_stats``), built on :mod:`benchmark.reference.stats`:
each mate's reads get the filter's verdicts (:func:`verdicts`), a pair
counts only when both mates pass, and each mate's statistics cover the
pairs that count.  ``num_reads`` of each mate is the pairs that count;
``num_passed`` and ``num_failed`` count pairs, the same in both mates.
"""

from __future__ import annotations

import numpy as np

from ..traffic.generate import Corpus
from .stats import (CHUNK_ELEMS, _chunks, _verdicts, reference_stats,
                    thresholds)

# thresholds that every read passes: the statistics of the selected reads
_EVERY_READ = {"read_length_range": (0, 1 << 40),
               "read_quality_range": (-(1 << 20), 1 << 20), "max_N": 1 << 40}


def verdicts(corpus, filter_spec: dict, phred: int = 33,
             chunk: int = CHUNK_ELEMS) -> np.ndarray:
    """Which reads of ``corpus`` pass the filter ``filter_spec``, in file
    order."""
    thr = thresholds(filter_spec)
    ok = np.zeros(len(corpus.lens), bool)
    for idx, codes, quals, lens, mask in _chunks(corpus, chunk):
        ok[idx] = _verdicts(codes, quals, lens, mask, phred, thr)
    return ok


def selected(corpus, keep: np.ndarray) -> Corpus:
    """The reads of ``corpus`` where ``keep`` is true, in file order."""
    every = np.repeat(keep, corpus.lens)
    return Corpus(lens=corpus.lens[keep], seq=corpus.seq[every],
                  qual=corpus.qual[every])


def reference_paired_stats(mate1, mate2, filter_spec: dict, phred: int = 33,
                           chunk: int = CHUNK_ELEMS):
    """``(counters of mate 1, counters of mate 2)`` of paired ``stats`` over
    the mates' records with the filter ``filter_spec`` (a configuration's
    ``filter`` object)."""
    if len(mate1.lens) != len(mate2.lens):
        raise ValueError("mates hold %d and %d records"
                         % (len(mate1.lens), len(mate2.lens)))
    both = (verdicts(mate1, filter_spec, phred, chunk)
            & verdicts(mate2, filter_spec, phred, chunk))
    out = []
    for mate in (mate1, mate2):
        c = reference_stats(selected(mate, both), _EVERY_READ, phred, chunk)
        c.num_reads = c.num_passed = int(both.sum())
        c.num_failed = int((~both).sum())
        out.append(c)
    return tuple(out)
