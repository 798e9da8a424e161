"""The traffic generator of Nanopore reads: :mod:`generate`'s file, with
each read's qualities drawn around a mean quality of its own.

``generate`` draws every base's quality from one distribution, so every
long read's mean quality lands near the same value and a mean-quality
filter decides nothing.  Here a configuration's ``quality`` gives the
recipe per read: each read's mean quality is drawn from a normal
(``read_mean``: ``median``, ``sd``, clipped to ``min``-``max``), and each
of its bases' qualities from a normal around that mean (``base_sd``),
rounded and clipped to ``min``-``max``.  Lengths (``generate.lengths``:
the same set for every seed), bases (uniform ACGT, N at ``n_rate``),
names and the gzip member are ``generate``'s.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.traffic.generate import (ALPHABET, PHRED, Corpus, _GzipMember,
                                        _pieces, fastq_text, lengths,
                                        read_count)


def read_means(config: dict, n: int, rng) -> np.ndarray:
    """Each read's drawn mean quality (float32), in file order."""
    m = config["quality"]["read_mean"]
    x = m["median"] + m["sd"] * rng.standard_normal(n, dtype=np.float32)
    return np.clip(x, m["min"], m["max"]).astype(np.float32)


def _draw(config, lens, means, rng):
    """The bases and qualities (ASCII) of reads of ``lens`` whose mean
    qualities are ``means``."""
    total = int(lens.sum())
    seq = ALPHABET[rng.integers(0, 4, total, dtype=np.uint8)]
    rate = float(config["n_rate"])
    if rate > 0:
        seq[rng.random(total, dtype=np.float32) < rate] = ord("N")
    q = config["quality"]
    x = np.repeat(means, lens) + np.float32(q["base_sd"]) * rng.standard_normal(
        total, dtype=np.float32)
    qual = (np.clip(np.rint(x), q["min"], q["max"]).astype(np.uint8)
            + np.uint8(PHRED))
    return seq, qual


def make_corpus(config: dict, traffic: dict, seed: int, directory: str) -> Corpus:
    """Draw one pass's file from ``seed`` and write it into ``directory``
    (``reads.fq``, or ``reads.fq.gz`` where the traffic's ``format`` is
    ``gzip``); return its records."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    lens = lengths(config, read_count(config, traffic), rng)
    means = read_means(config, len(lens), rng)
    gz = traffic.get("format", "plain") == "gzip"
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "reads.fq.gz" if gz else "reads.fq")
    seqs, quals = [], []
    with open(path, "wb") as f:
        member = (_GzipMember(f, int(traffic["gzip_level"]),
                              max(1, min(8, os.cpu_count() or 1)))
                  if gz else None)
        pieces = _pieces(lens)
        for i, (a, b) in enumerate(pieces):
            seq, qual = _draw(config, lens[a:b], means[a:b], rng)
            text = fastq_text(a, lens[a:b], seq, qual)
            if member is None:
                text.tofile(f)
            else:
                member.add(text.tobytes(), i == len(pieces) - 1)
            seqs.append(seq)
            quals.append(qual)
        if member is not None:
            member.close()
        f.flush()
        os.fsync(f.fileno())  # written back now, not during the window
    return Corpus(lens=lens, seq=np.concatenate(seqs), qual=np.concatenate(quals),
                  path=path)
