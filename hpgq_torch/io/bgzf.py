"""The port's own copy of ``hpgq/io/bgzf.py`` (the port imports nothing of
``hpgq``); its reader also times each member's inflate in a pass's stage
timers (the ``inflate`` stage, on the thread that inflates it).

BGZF (blocked gzip) support: random access into compressed FASTQ.

Plain gzip is not seekable, which forces the multi-host input split to
degrade to stream striping (every host decodes the whole file —
``hpgq.dist.run_dist.striped_blocks``).  BGZF — the bioinformatics-standard
framing produced by ``bgzip`` and emitted by most sequencers' pipelines — is
a sequence of independent <=64 KB gzip members, each carrying its compressed
size in a ``BC`` extra subfield.  Indexing the members (one tiny header read
per 64 KB) yields an exact compressed<->logical offset map, giving:

* true parallel multi-host decode: each host decompresses ONLY its
  record-aligned logical byte range (``split_byte_ranges`` works unchanged),
* checkpoint/resume into compressed inputs (logical ``seek`` is cheap).

``BgzfFile`` is a minimal file-like (read/readline/seek/tell in LOGICAL
coordinates) over the index, decompressing one member at a time with an
LRU-1 block cache — sequential reads decompress each block exactly once.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..utils.timers import NO_TIMERS

_SUB = struct.Struct("<BBH")     # si1, si2, slen


def is_bgzf(path: str) -> bool:
    """True if the file starts with a BGZF member (gzip + BC extra field)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"\x1f\x8b\x08\x04":
            return False
        xlen = struct.unpack_from("<H", head, 10)[0]
        extra = f.read(xlen)
    pos = 0
    while pos + 4 <= len(extra):
        si1, si2, slen = _SUB.unpack_from(extra, pos)
        if si1 == 66 and si2 == 67 and slen == 2:
            return True
        pos += 4 + slen
    return False


_INDEX_CACHE: dict = {}


def cached_index(path: str):
    """Per-process member-index cache keyed by (path, size, mtime) — sharded
    runs open the same BGZF several times (range split + per-shard readers);
    the index costs one header read per 64 KB member and need not repeat."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        if len(_INDEX_CACHE) > 16:
            _INDEX_CACHE.clear()
        idx = _INDEX_CACHE[key] = build_index(path)
    return idx


def build_index(path: str):
    """(c_offsets, l_offsets) int64 arrays of length n_blocks+1: compressed
    and logical (decompressed) start offsets of every member, with the file
    totals in the last slot."""
    c_offsets = [0]
    l_offsets = [0]
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        c = 0
        logical = 0
        while c < size:
            f.seek(c)
            head = f.read(12)
            if len(head) < 12:
                raise ValueError("truncated BGZF member header in %s" % path)
            if head[:4] != b"\x1f\x8b\x08\x04":
                raise ValueError(
                    "not a BGZF member at offset %d in %s" % (c, path)
                )
            xlen = struct.unpack_from("<H", head, 10)[0]
            extra = f.read(xlen)
            bsize = None
            pos = 0
            while pos + 4 <= len(extra):
                si1, si2, slen = _SUB.unpack_from(extra, pos)
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack_from("<H", extra, pos + 4)[0] + 1
                    break
                pos += 4 + slen
            if bsize is None:
                raise ValueError("BGZF member missing BC subfield in %s" % path)
            f.seek(c + bsize - 4)
            isize = struct.unpack("<I", f.read(4))[0]
            c += bsize
            logical += isize
            c_offsets.append(c)
            l_offsets.append(logical)
            if isize == 0 and c >= size:
                break
    return (np.asarray(c_offsets, dtype=np.int64),
            np.asarray(l_offsets, dtype=np.int64))


class BgzfFile:
    """Seekable (logical-coordinate) reader over a BGZF file.

    ``readahead`` > 0 enables block-parallel decompression: the next N
    members are decompressed on a thread pool while the caller consumes the
    current one (zlib releases the GIL), lifting sequential decode from
    single-thread zlib speed to ~N× — the BGZF framing is what makes the
    members independently decodable.  The pool has ``workers`` threads (0:
    one a member read ahead, at most one a core).  Each member's inflate is
    ``timers``' ``inflate`` stage."""

    def __init__(self, path: str, index=None, readahead: int = 8,
                 timers=NO_TIMERS, workers: int = 0):
        self.path = path
        self._timers = timers
        self._fh = open(path, "rb")
        self.c_offsets, self.l_offsets = index or cached_index(path)
        self.logical_size = int(self.l_offsets[-1])
        self._pos = 0          # logical position
        self._blk = -1         # cached block id
        self._blk_data = b""
        self._ra = int(readahead)
        self._workers = int(workers) or min(self._ra, os.cpu_count() or 1)
        self._pool = None
        self._futures = {}     # block id -> Future[bytes]

    # -- block machinery ----------------------------------------------------

    def _block_of(self, logical: int) -> int:
        i = int(np.searchsorted(self.l_offsets, logical, side="right")) - 1
        return max(0, min(i, len(self.c_offsets) - 2))

    def _raw_member(self, i: int) -> bytes:
        c0, c1 = int(self.c_offsets[i]), int(self.c_offsets[i + 1])
        self._fh.seek(c0)
        return self._fh.read(c1 - c0)

    def _check_block(self, i: int, data: bytes) -> bytes:
        want = int(self.l_offsets[i + 1] - self.l_offsets[i])
        if len(data) != want:
            raise ValueError(
                "corrupt BGZF member %d in %s: ISIZE says %d bytes, "
                "decompressed %d" % (i, self.path, want, len(data))
            )
        return data

    def _inflate(self, raw: bytes) -> bytes:
        with self._timers.stage("inflate"):
            return zlib.decompress(raw, 31)

    def _load_block(self, i: int):
        if i == self._blk:
            return
        if self._ra > 0:
            self._load_block_ra(i)
            return
        self._blk_data = self._check_block(i, self._inflate(self._raw_member(i)))
        self._blk = i

    def _load_block_ra(self, i: int):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self._workers,
                thread_name_prefix="bgzf",
            )
        n_blocks = len(self.c_offsets) - 1
        # submit [i, i+ra): raw file reads happen here (serial, cheap);
        # decompression runs on the pool
        for j in range(i, min(i + self._ra + 1, n_blocks)):
            if j not in self._futures:
                raw = self._raw_member(j)
                self._futures[j] = self._pool.submit(self._inflate, raw)
        self._blk_data = self._check_block(i, self._futures[i].result())
        self._blk = i
        # evict stale futures (random-access patterns won't grow the dict)
        for j in [j for j in self._futures if j <= i or j > i + self._ra]:
            if j != i:
                self._futures.pop(j).cancel()

    # -- file-like API ------------------------------------------------------

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.logical_size - self._pos
        out = []
        while n > 0 and self._pos < self.logical_size:
            i = self._block_of(self._pos)
            self._load_block(i)
            off = self._pos - int(self.l_offsets[i])
            take = self._blk_data[off : off + n]
            if not take:
                break
            out.append(take)
            self._pos += len(take)
            n -= len(take)
        return b"".join(out)

    def readline(self) -> bytes:
        out = []
        while self._pos < self.logical_size:
            i = self._block_of(self._pos)
            self._load_block(i)
            off = self._pos - int(self.l_offsets[i])
            nl = self._blk_data.find(b"\n", off)
            if nl >= 0:
                out.append(self._blk_data[off : nl + 1])
                self._pos += nl + 1 - off
                return b"".join(out)
            out.append(self._blk_data[off:])
            self._pos += len(self._blk_data) - off
        return b"".join(out)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos = self._pos + pos
        elif whence == 2:
            pos = self.logical_size + pos
        self._pos = max(0, min(int(pos), self.logical_size))
        return self._pos

    def tell(self) -> int:
        return self._pos

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_bgzf(path: str, data: bytes, block_size: int = 65280) -> str:
    """Write ``data`` as a BGZF file (test/tooling helper; bgzip-compatible
    layout incl. the 28-byte EOF member)."""
    def member(chunk: bytes) -> bytes:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12)+extra(6)+comp+crc(4)+isize(4)
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC" + struct.pack("<HH", 2, bsize - 1)
        )
        return (header + comp
                + struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF,
                              len(chunk)))

    with open(path, "wb") as f:
        for i in range(0, len(data), block_size):
            f.write(member(data[i : i + block_size]))
        f.write(member(b""))  # EOF marker member
    return path
