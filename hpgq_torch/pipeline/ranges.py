"""Record-aligned byte ranges of a FASTQ file, for concurrent shard readers.

Jax-free copies of ``_align_to_record``, ``range_splittable`` and
``split_byte_ranges`` from ``hpgq/dist/mesh.py`` (``:325-367``,
``:477-504``), whose module imports jax at load time.
"""

from __future__ import annotations

import os


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
    from hpgq.io.bgzf import is_bgzf

    return is_bgzf(path)


def split_byte_ranges(path: str, n_shards: int):
    """[(start, end)] record-aligned byte ranges covering a FASTQ file;
    offsets are logical (decompressed) for BGZF inputs (copy of
    ``hpgq/dist/mesh.py:477-504``)."""
    with open(path, "rb") as probe:
        gz = probe.read(2) == b"\x1f\x8b"
    if gz:
        from hpgq.io.bgzf import BgzfFile

        f = BgzfFile(path)
        size = f.logical_size
    else:
        f = open(path, "rb")
        size = os.path.getsize(path)
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
