"""The one traffic generator: a FASTQ file from a configuration, a traffic
mix and a seed, made with vectorized numpy.

The recipe is that of the repository's test corpora (``tests/gen.py``:
bases drawn uniformly from ACGT, N at a rate, qualities from a set of bins
or uniform in a range, names ``@read_<i> some description``), without its
loop over reads, and with two knobs of a configuration's ``quality``:
``percent``, how often each bin is drawn, and ``n_quality``, the quality
every N gets.  Read lengths come in groups (a configuration's
``read_groups``): each group's lengths are evenly spaced over its range
and shuffled by the seed, so every seed makes the same set of lengths in
another order, and so the same amount of work; reads of a later group sit
at evenly spaced places in the file.

:func:`make_corpus` returns the records (a :class:`Corpus`) for the
reference, and writes them as plain FASTQ or as one gzip member, deflated
in parallel pieces (the way ``pigz`` does) at the traffic's level.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import struct
import zlib

import numpy as np

PHRED = 33
ALPHABET = np.frombuffer(b"ACGT", np.uint8)
NAME_HEAD = b"@read_"
NAME_TAIL = b" some description\n"
PIECE_BASES = 1 << 23  # bases drawn and written per piece


@dataclasses.dataclass
class Corpus:
    """The records of one file: flat bases and qualities (ASCII), and each
    read's length; ``path`` is the file written."""

    lens: np.ndarray
    seq: np.ndarray
    qual: np.ndarray
    path: str = ""

    @property
    def starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lens)[:-1]]).astype(np.int64)

    @property
    def reads(self) -> int:
        return int(len(self.lens))

    @property
    def bases(self) -> int:
        return int(self.lens.sum())


def read_count(config: dict, traffic: dict) -> int:
    """Reads in one pass's file: the configuration's file size times the
    traffic's ``read_scale``."""
    return int(config["reads_per_file"]) * int(traffic.get("read_scale", 1))


def lengths(config: dict, n: int, rng) -> np.ndarray:
    """Each read's length, in file order."""
    groups = config["read_groups"]
    counts = [int(round(g["fraction"] * n)) for g in groups]
    counts[0] = n - sum(counts[1:])
    parts = []
    for g, k in zip(groups, counts):
        part = np.rint(np.linspace(g["min_len"], g["max_len"], k)).astype(np.int64)
        parts.append(rng.permutation(part))
    out = parts[0]
    for part in parts[1:]:  # evenly spaced through the file
        if len(part):
            step = len(out) // len(part) + 1
            at = np.arange(len(part)) * step + step // 2
            out = np.insert(out, np.minimum(at - np.arange(len(part)), len(out)), part)
    return out


def _pieces(lens):
    """(first read, end read) of pieces of about :data:`PIECE_BASES` bases."""
    ends = np.searchsorted(np.cumsum(lens), np.arange(1, 1 + int(lens.sum()) // PIECE_BASES + 1)
                           * PIECE_BASES, side="right")
    bounds = sorted({0, len(lens), *[int(e) for e in ends if 0 < e < len(lens)]})
    return list(zip(bounds[:-1], bounds[1:]))


def _draw(config, total, rng):
    """``total`` bases and qualities (ASCII)."""
    seq = ALPHABET[rng.integers(0, 4, total, dtype=np.uint8)]
    rate = float(config["n_rate"])
    if rate > 0:
        seq[rng.random(total, dtype=np.float32) < rate] = ord("N")
    q = config["quality"]
    if "bins" in q:  # each bin as often as its percent says
        table = np.repeat(np.asarray(q["bins"], np.uint8) + PHRED, q["percent"])
        qual = table[rng.integers(0, len(table), total, dtype=np.uint8)]
    else:
        qual = (rng.integers(q["min"], q["max"] + 1, total, dtype=np.uint8)
                + np.uint8(PHRED))
    if "n_quality" in q:
        qual[seq == ord("N")] = q["n_quality"] + PHRED
    return seq, qual


def _digits(ids):
    """How many decimal digits each id has."""
    ndig = np.ones(len(ids), np.int64)
    for p in range(1, 19):
        ndig += ids >= 10 ** p
    return ndig


def _fixed_text(ids, length, seq, qual) -> np.ndarray:
    """:func:`fastq_text` of reads of one length whose ids have one number
    of digits: every record is one row of the same width."""
    n, nd = len(ids), len(str(int(ids[0])))
    head = len(NAME_HEAD) + nd + len(NAME_TAIL)
    out = np.empty((n, head + 2 * length + 4), np.uint8)
    out[:, :len(NAME_HEAD)] = np.frombuffer(NAME_HEAD, np.uint8)
    for p in range(nd):
        out[:, len(NAME_HEAD) + p] = (ids // 10 ** (nd - 1 - p)) % 10 + ord("0")
    out[:, len(NAME_HEAD) + nd:head] = np.frombuffer(NAME_TAIL, np.uint8)
    out[:, head:head + length] = seq.reshape(n, length)
    out[:, head + length:head + length + 3] = np.frombuffer(b"\n+\n", np.uint8)
    out[:, head + length + 3:-1] = qual.reshape(n, length)
    out[:, -1] = ord("\n")
    return out.reshape(-1)


def fastq_text(first: int, lens, seq, qual) -> np.ndarray:
    """The FASTQ text of reads ``first, first + 1, ...`` as uint8:
    ``@read_<i> some description``, the bases, ``+``, the qualities."""
    n = len(lens)
    ids = np.arange(first, first + n, dtype=np.int64)
    ndig = _digits(ids)
    if n and (lens == lens[0]).all():
        cut = np.flatnonzero(np.diff(ndig)) + 1
        length = int(lens[0])
        return np.concatenate([
            _fixed_text(ids[a:b], length, seq[a * length:b * length],
                        qual[a * length:b * length])
            for a, b in zip([0, *cut], [*cut, n])])
    head = len(NAME_HEAD) + ndig + len(NAME_TAIL)
    rec = head + 2 * lens + 4
    start = np.concatenate([[0], np.cumsum(rec)[:-1]])
    out = np.empty(int(rec.sum()), np.uint8)
    for j, ch in enumerate(NAME_HEAD):
        out[start + j] = ch
    d0 = start + len(NAME_HEAD)
    for p in range(int(ndig.max())):  # digit p counted from the left
        have = ndig > p
        place = 10 ** (ndig[have] - 1 - p)
        out[d0[have] + p] = (ids[have] // place) % 10 + ord("0")
    t0 = d0 + ndig
    for j, ch in enumerate(NAME_TAIL):
        out[t0 + j] = ch
    s0 = start + head
    within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    out[np.repeat(s0, lens) + within] = seq
    out[s0 + lens] = ord("\n")
    out[s0 + lens + 1] = ord("+")
    out[s0 + lens + 2] = ord("\n")
    out[np.repeat(s0 + lens + 3, lens) + within] = qual
    out[s0 + 2 * lens + 3] = ord("\n")
    return out


class _GzipMember:
    """One gzip member written from pieces deflated on a thread pool: each
    piece is a raw deflate stream ended by a sync flush (the last by a
    finish), so their concatenation is one valid stream."""

    def __init__(self, f, level: int, threads: int):
        self.f = f
        self.level = level
        self.threads = threads
        self.pool = concurrent.futures.ThreadPoolExecutor(threads)
        self.pending = []
        self.crc = 0
        self.size = 0
        f.write(b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff")

    def _deflate(self, data: bytes, last: bool) -> bytes:
        co = zlib.compressobj(self.level, zlib.DEFLATED, -15)
        return co.compress(data) + co.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)

    def add(self, data: bytes, last: bool) -> None:
        self.crc = zlib.crc32(data, self.crc)
        self.size += len(data)
        self.pending.append(self.pool.submit(self._deflate, data, last))
        while len(self.pending) > 2 * self.threads:
            self.f.write(self.pending.pop(0).result())

    def close(self) -> None:
        for fut in self.pending:
            self.f.write(fut.result())
        self.pool.shutdown()
        self.f.write(struct.pack("<II", self.crc & 0xFFFFFFFF, self.size & 0xFFFFFFFF))


def make_corpus(config: dict, traffic: dict, seed: int, directory: str) -> Corpus:
    """Draw one pass's file from ``seed`` and write it into ``directory``
    (``reads.fq``, or ``reads.fq.gz`` where the traffic's ``format`` is
    ``gzip``); return its records."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    lens = lengths(config, read_count(config, traffic), rng)
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
            seq, qual = _draw(config, int(lens[a:b].sum()), rng)
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
