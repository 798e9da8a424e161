"""The traffic generator of paired-end reads: a sample's two files, R1 and
R2, with the records of :mod:`generate`'s recipe.

Both mates share the read lengths (``generate.lengths``) and the names
(``@read_<i> some description``, the same in both files, as BCL Convert
writes a pair); each mate's bases and qualities are drawn from the seed,
mate 1's with the configuration's ``quality`` and mate 2's with its
``quality2`` (read 2 runs at lower quality on the instrument).  Each file
is one gzip member, deflated in pieces as ``pigz`` does (``_GzipMember``),
or plain text.

The files are ``reads_1.fq.gz`` and ``reads_2.fq.gz``: each mate's report
is named after its file's basename, so the two must differ.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from benchmark.traffic.generate import (Corpus, _GzipMember, _draw, _pieces,
                                        fastq_text, lengths, read_count)

NAMES = ("reads_1.fq", "reads_2.fq")


@dataclasses.dataclass
class PairedCorpus:
    """The records of a pair of files: each mate's :class:`Corpus` (with
    its ``path``).  ``path`` is mate 1's file; ``reads`` and ``bases``
    count both mates, every read and base a pass reads."""

    mate1: Corpus
    mate2: Corpus

    @property
    def path(self) -> str:
        return self.mate1.path

    @property
    def path2(self) -> str:
        return self.mate2.path

    @property
    def reads(self) -> int:
        return self.mate1.reads + self.mate2.reads

    @property
    def bases(self) -> int:
        return self.mate1.bases + self.mate2.bases


def mate2_path(path: str) -> str:
    """The file of mate 2 beside mate 1's ``path``."""
    d, name = os.path.split(path)
    return os.path.join(d, name.replace(NAMES[0], NAMES[1], 1))


def make_corpus(config: dict, traffic: dict, seed: int,
                directory: str) -> PairedCorpus:
    """Draw one pass's pair of files from ``seed`` and write them into
    ``directory`` (``reads_1.fq`` and ``reads_2.fq``, each with ``.gz``
    where the traffic's ``format`` is ``gzip``); return their records."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    lens = lengths(config, read_count(config, traffic), rng)
    gz = traffic.get("format", "plain") == "gzip"
    os.makedirs(directory, exist_ok=True)
    paths = [os.path.join(directory, n + (".gz" if gz else "")) for n in NAMES]
    recipes = (config, dict(config, quality=config["quality2"]))
    threads = max(1, min(8, os.cpu_count() or 1) // 2)  # a pool each
    seqs, quals = ([], []), ([], [])
    files = [open(p, "wb") for p in paths]
    try:
        members = [_GzipMember(f, int(traffic["gzip_level"]), threads)
                   if gz else None for f in files]
        pieces = _pieces(lens)
        for i, (a, b) in enumerate(pieces):
            for m, (f, member, recipe) in enumerate(zip(files, members, recipes)):
                seq, qual = _draw(recipe, int(lens[a:b].sum()), rng)
                text = fastq_text(a, lens[a:b], seq, qual)
                if member is None:
                    text.tofile(f)
                else:
                    member.add(text.tobytes(), i == len(pieces) - 1)
                seqs[m].append(seq)
                quals[m].append(qual)
        for member in members:
            if member is not None:
                member.close()
        for f in files:
            f.flush()
            os.fsync(f.fileno())  # written back now, not during the window
    finally:
        for f in files:
            f.close()
    mates = [Corpus(lens=lens, seq=np.concatenate(seqs[m]),
                    qual=np.concatenate(quals[m]), path=paths[m])
             for m in range(2)]
    return PairedCorpus(*mates)
