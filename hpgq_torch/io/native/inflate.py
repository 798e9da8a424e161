"""The port's gzip reader: ``inflate.cpp``, a DEFLATE decoder with gzip's
framing and checks, written by hand (no zlib), built on first use by
:func:`hpgq_torch.io.native.load` into ``_build/_inflate.so`` and bound
with ctypes.

:func:`open_gzip` gives a :class:`GzipReader` over a plain (non-BGZF) gzip
file, or None when the library cannot be built or loaded or
``HPGQ_NO_NATIVE`` is set: the caller then opens the file with
:mod:`gzip`, as the packer falls back to numpy.  A read fills a new
``bytes`` object in place, one native call a read with the GIL released,
so a 16 MB piece reaches the reader with no copy.  A corrupt, truncated or
padded input raises what :class:`gzip.GzipFile` raises on the same bytes
(``EOFError``, :class:`gzip.BadGzipFile`, ``zlib.error``).

Where the file holds at least two chunks of :data:`CHUNK_BYTES` and the
process may run on at least four cores, the first member is decoded on
several: chunks of the compressed bytes each decoded from the first block
header found in them with the window before them unknown, checked to join
up and resolved in order, or, where every chunk before one is accepted by
the time it starts, from that known start and window (``inflate.cpp``'s
parallel reader), on a pool of threads the process's readers share.  It
returns the same bytes and raises the same errors, after the same bytes, as
the one-thread decoder, which it hands every chunk it cannot confirm and all
after the first member."""

from __future__ import annotations

import ctypes
import gzip
import io
import os
import threading
import zlib

from . import load, new_bytes, plan

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "inflate.cpp")
_ABI = 2  # must match hpgq_inflate_abi_version() in inflate.cpp
CHUNK_BYTES = 4 << 20  # compressed bytes of one chunk on the parallel path

_ERRORS = {1: EOFError, 2: gzip.BadGzipFile, 3: zlib.error, 4: OSError}


def _bind(lib):
    lib.hpgq_gz_open.restype = ctypes.c_void_p
    lib.hpgq_gz_open.argtypes = [ctypes.c_char_p]
    lib.hpgq_gz_read.restype = ctypes.c_int64
    lib.hpgq_gz_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64]
    lib.hpgq_gz_message.restype = ctypes.c_char_p
    lib.hpgq_gz_message.argtypes = [ctypes.c_void_p]
    lib.hpgq_gz_close.restype = None
    lib.hpgq_gz_close.argtypes = [ctypes.c_void_p]
    lib.hpgq_pgz_open.restype = ctypes.c_void_p
    lib.hpgq_pgz_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64]
    lib.hpgq_pgz_read.restype = ctypes.c_int64
    lib.hpgq_pgz_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64]
    lib.hpgq_pgz_message.restype = ctypes.c_char_p
    lib.hpgq_pgz_message.argtypes = [ctypes.c_void_p]
    lib.hpgq_pgz_counts.restype = None
    lib.hpgq_pgz_counts.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.hpgq_pgz_close.restype = None
    lib.hpgq_pgz_close.argtypes = [ctypes.c_void_p]


def get_lib():
    """The loaded decoder library, or None if unavailable."""
    return load(_SRC, "_inflate.so", "hpgq_inflate_abi_version", _ABI, _bind,
                "inflate", "gzip")


def open_gzip(path: str, workers=None) -> "GzipReader | None":
    """A :class:`GzipReader` over ``path`` with ``workers`` decode threads
    (as the reader takes them), or None without the library."""
    lib = get_lib()
    return None if lib is None else GzipReader(lib, path, workers)


def _workers(path: str) -> int:
    """Decode threads for the file at ``path``: none (one-thread decoding)
    under two chunks, else the plan's gzip pool
    (:func:`hpgq_torch.io.native.plan`)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size < 2 * CHUNK_BYTES:
        return 0
    return plan("gzip").decode


# the parallel reader's counts (hpgq_pgz_counts), in its order
COUNTS = ("inflate-chunks", "inflate-markers", "inflate-restarts")


class GzipReader:
    """Read-only, forward-only file over a gzip file's text (every member
    in turn), decoded by the native library; the first member on several
    threads where the file and the cores allow.  ``workers``: the parallel
    reader's decode threads, at any size of file (0: the one-thread
    reader; None: :func:`_workers`), each chunk ``chunk_bytes`` of
    compressed bytes (0: :data:`CHUNK_BYTES`)."""

    COUNTER = "inflate-native-bytes"  # the stage timers' count of its bytes

    def __init__(self, lib, path: str, workers=None, chunk_bytes: int = 0):
        self._lib = lib
        self._io = threading.Lock()  # close waits for a read in progress
        self._pos = 0
        if workers is None:
            workers = _workers(path)
        self.parallel = workers > 0
        if self.parallel:
            self._h = lib.hpgq_pgz_open(os.fsencode(path), int(workers),
                                        int(chunk_bytes or CHUNK_BYTES))
            self._read, self._message, self._close = (
                lib.hpgq_pgz_read, lib.hpgq_pgz_message, lib.hpgq_pgz_close)
        else:
            self._h = lib.hpgq_gz_open(os.fsencode(path))
            self._read, self._message, self._close = (
                lib.hpgq_gz_read, lib.hpgq_gz_message, lib.hpgq_gz_close)
        if not self._h:
            err = ctypes.get_errno()
            raise OSError(err, os.strerror(err), path)
        self._counted = dict.fromkeys(COUNTS, 0)

    def _fill(self, ptr, n: int) -> int:
        with self._io:
            if not self._h:
                raise ValueError("I/O operation on closed file")
            got = self._read(self._h, ptr, n)
            if got < 0:
                msg = self._message(self._h).decode(errors="replace")
                raise _ERRORS[-got](msg)
        self._pos += got
        return got

    def take_counts(self) -> "dict[str, int]":
        """The parallel reader's counts since the last call (:data:`COUNTS`:
        chunks decoded from an unknown window and accepted, markers resolved,
        chunks re-decoded by one thread); empty on the one-thread path."""
        if not self.parallel:
            return {}
        got = (ctypes.c_int64 * 3)()
        with self._io:
            if not self._h:
                return dict.fromkeys(COUNTS, 0)
            self._lib.hpgq_pgz_counts(self._h, got)
        now = dict(zip(COUNTS, got))
        out = {k: now[k] - self._counted[k] for k in COUNTS}
        self._counted = now
        return out

    def read(self, n: int = -1) -> bytes:
        """Up to ``n`` bytes: exactly ``n`` unless the text ends (b'' at
        its end); all of the rest for ``n`` < 0."""
        if n is None or n < 0:
            parts = []
            while True:
                part = self.read(16 << 20)
                if not part:
                    return b"".join(parts)
                parts.append(part)
        if n == 0:
            return b""
        buf = new_bytes(None, n)
        got = self._fill(buf, n)
        return buf if got == n else buf[:got]

    def readinto(self, b) -> int:
        mv = memoryview(b).cast("B")
        if not len(mv):
            return 0
        return self._fill((ctypes.c_char * len(mv)).from_buffer(mv), len(mv))

    def seek(self, offset: int) -> int:
        """Forward only: the text up to ``offset`` is decoded and dropped
        (a resume's ``start_offset``)."""
        if offset < self._pos:
            raise io.UnsupportedOperation("gzip text cannot seek backwards")
        scratch = memoryview(bytearray(min(1 << 20, offset - self._pos)))
        while self._pos < offset:
            if not self.readinto(scratch[:min(len(scratch), offset - self._pos)]):
                break
        return self._pos

    def close(self) -> None:
        with self._io:
            if self._h:
                self._close(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
