"""Record-aligned byte ranges of a FASTQ file, for concurrent shard readers.

Copies of ``_align_to_record``, ``range_splittable``,
``_open_logical``, ``count_newlines_in_range``, ``record_offsets``,
``split_paired_ranges`` and ``split_byte_ranges`` from
``hpgq/dist/mesh.py`` (``:325-504``), whose module imports jax at load
time.
"""

from __future__ import annotations

import os

from ..io.bgzf import BgzfFile, is_bgzf
from ..io.fastq import _find_newlines


def _align_to_record(f, pos: int, scan_limit: int = 1 << 30) -> int:
    """Scan forward from byte ``pos`` to the next FASTQ record start
    (copy of ``hpgq/dist/mesh.py:325-355``).

    A '@' line is a record start iff the line 2 lines below starts with '+'
    (quality lines may begin with '@', so the lookahead disambiguates).
    ``scan_limit`` only guards against scanning a non-FASTQ file forever."""
    if pos == 0:
        return 0
    f.seek(pos)
    f.readline()  # skip the (possibly partial) current line
    while True:
        start = f.tell()
        line = f.readline()
        if not line:
            return start
        if line.startswith(b"@"):
            after = f.tell()
            f.readline()  # sequence?
            plus = f.readline()
            if plus.startswith(b"+"):
                return start
            # '@' was a quality line: resume from the NEXT line, not past
            # the lookahead, or real headers get swallowed
            f.seek(after)
        if f.tell() - pos > scan_limit:
            raise ValueError("could not find a FASTQ record boundary")


def range_splittable(path: str) -> bool:
    """True when record-aligned byte ranges work: plain files, or BGZF
    (copy of ``hpgq/dist/mesh.py:358-367``)."""
    with open(path, "rb") as f:
        if f.read(2) != b"\x1f\x8b":
            return True
    return is_bgzf(path)


def _open_logical(path: str):
    """(file-like, logical_size): a ``BgzfFile`` for BGZF input, the plain
    file otherwise; offsets are decompressed-stream offsets either way."""
    with open(path, "rb") as probe:
        gz = probe.read(2) == b"\x1f\x8b"
    if gz:
        f = BgzfFile(path)
        return f, f.logical_size
    return open(path, "rb"), os.path.getsize(path)


def count_newlines_in_range(path: str, start: int, end: int) -> int:
    """Newlines in the logical byte range ``[start, end)``."""
    f, _ = _open_logical(path)
    try:
        f.seek(start)
        total = 0
        left = end - start
        while left > 0:
            data = f.read(min(left, 16 << 20))
            if not data:
                break
            total += int(len(_find_newlines(data)))
            left -= len(data)
        return total
    finally:
        f.close()


def record_offsets(path: str, record_indices) -> "list[int]":
    """Logical byte offset of the start of each requested record, by one
    streaming newline scan; indices past the end map to the file's end."""
    remaining = sorted({int(r) for r in record_indices if int(r) != 0})
    out = {0: 0}
    if remaining:
        f, _ = _open_logical(path)
        try:
            nl_seen = base = ri = 0
            while ri < len(remaining):
                data = f.read(16 << 20)
                if not data:
                    for r in remaining[ri:]:
                        out[r] = base
                    break
                nl = _find_newlines(data)
                while ri < len(remaining):
                    need = remaining[ri] * 4  # the newline ending record r-1
                    if need > nl_seen + len(nl):
                        break
                    out[remaining[ri]] = base + int(nl[need - nl_seen - 1]) + 1
                    ri += 1
                nl_seen += len(nl)
                base += len(data)
        finally:
            f.close()
    return [out[int(r)] for r in record_indices]


def split_paired_ranges(path1: str, path2: str, n_shards: int):
    """``[((s1, e1), (s2, e2)), ...]``: shard i covers the same record
    indices in both mate files.  Mate 1 is cut at record-aligned byte
    fractions; mate 2's cuts come from counting mate 1's records."""
    r1 = split_byte_ranges(path1, n_shards)
    counts = [count_newlines_in_range(path1, s, e) // 4 for s, e in r1]
    # a legal FASTQ may lack the final newline: its last shard then holds
    # 4N-1 newlines, and newlines // 4 would drop the final record and
    # misalign every mate-2 cut after it
    f, size = _open_logical(path1)
    try:
        if size:
            f.seek(size - 1)
            if f.read(1) != b"\n":
                # credit the last NONEMPTY shard (tiny files collapse
                # trailing shards to empty (size, size) ranges)
                for i in range(n_shards - 1, -1, -1):
                    if r1[i][0] < r1[i][1]:
                        counts[i] += 1
                        break
    finally:
        f.close()
    prefix = [0]
    for c in counts:
        prefix.append(prefix[-1] + c)
    offs2 = record_offsets(path2, prefix)
    return list(zip(r1, [(offs2[i], offs2[i + 1]) for i in range(n_shards)]))


def split_byte_ranges(path: str, n_shards: int):
    """[(start, end)] record-aligned byte ranges covering a FASTQ file;
    offsets are logical (decompressed) for BGZF inputs."""
    f, size = _open_logical(path)
    try:
        cuts = [0]
        for i in range(1, n_shards):
            cuts.append(_align_to_record(f, size * i // n_shards))
        cuts.append(size)
    finally:
        f.close()
    # ensure monotonicity (tiny files may collapse some shards to empty)
    for i in range(1, len(cuts)):
        cuts[i] = max(cuts[i], cuts[i - 1])
    return [(cuts[i], cuts[i + 1]) for i in range(n_shards)]
