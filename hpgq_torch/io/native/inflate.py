"""The port's gzip reader: ``inflate.cpp``, a streaming DEFLATE decoder
with gzip's framing and checks, written by hand (no zlib), built on first
use with the packer's g++ flags into ``_build/_inflate.so`` and bound with
ctypes.

:func:`open_gzip` gives a :class:`GzipReader` over a plain (non-BGZF) gzip
file, or None when the library cannot be built or loaded or
``HPGQ_NO_NATIVE`` is set: the caller then opens the file with
:mod:`gzip`, as the packer falls back to numpy.  A read fills a new
``bytes`` object in place, one native call a read with the GIL released,
so a 16 MB piece reaches the reader with no copy.  A corrupt, truncated or
padded input raises what :class:`gzip.GzipFile` raises on the same bytes
(``EOFError``, :class:`gzip.BadGzipFile`, ``zlib.error``)."""

from __future__ import annotations

import ctypes
import gzip
import io
import logging
import os
import threading
import zlib

from . import _BUILD, _HERE, _build

log = logging.getLogger(__name__)

_SRC = os.path.join(_HERE, "inflate.cpp")
_SO = os.path.join(_BUILD, "_inflate.so")
_ABI = 1  # must match hpgq_inflate_abi_version() in inflate.cpp

_lock = threading.Lock()
_lib = None
_tried = False

# a bytes object of n bytes left uninitialized, for the decoder to fill
# before anyone else sees it (the C API's documented way to build bytes);
# a private prototype, so ctypes.pythonapi's shared one stays as it is
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p,
                               ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))

_ERRORS = {1: EOFError, 2: gzip.BadGzipFile, 3: zlib.error, 4: OSError}


def _load():
    lib = ctypes.CDLL(_SO, use_errno=True)
    lib.hpgq_inflate_abi_version.restype = ctypes.c_int
    if lib.hpgq_inflate_abi_version() != _ABI:
        return None
    lib.hpgq_gz_open.restype = ctypes.c_void_p
    lib.hpgq_gz_open.argtypes = [ctypes.c_char_p]
    lib.hpgq_gz_read.restype = ctypes.c_int64
    lib.hpgq_gz_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64]
    lib.hpgq_gz_message.restype = ctypes.c_char_p
    lib.hpgq_gz_message.argtypes = [ctypes.c_void_p]
    lib.hpgq_gz_close.restype = None
    lib.hpgq_gz_close.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The loaded decoder library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("HPGQ_NO_NATIVE"):
            return None
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                _build(_SRC, _SO)
            lib = _load()
            if lib is None:  # a stale library the mtime check missed
                _build(_SRC, _SO)
                lib = _load()
            if lib is None:
                raise RuntimeError("native inflate ABI != %d" % _ABI)
        except Exception as e:  # no compiler / load / symbol failure
            log.info("native inflate unavailable (%s); using gzip", e)
            return None
        _lib = lib
        return _lib


def open_gzip(path: str) -> "GzipReader | None":
    """A :class:`GzipReader` over ``path``, or None without the library."""
    lib = get_lib()
    return None if lib is None else GzipReader(lib, path)


class GzipReader:
    """Read-only, forward-only file over a gzip file's text (every member
    in turn), decoded by the native library."""

    COUNTER = "inflate-native-bytes"  # the stage timers' count of its bytes

    def __init__(self, lib, path: str):
        self._lib = lib
        self._io = threading.Lock()  # close waits for a read in progress
        self._pos = 0
        self._h = lib.hpgq_gz_open(os.fsencode(path))
        if not self._h:
            err = ctypes.get_errno()
            raise OSError(err, os.strerror(err), path)

    def _fill(self, ptr, n: int) -> int:
        with self._io:
            if not self._h:
                raise ValueError("I/O operation on closed file")
            got = self._lib.hpgq_gz_read(self._h, ptr, n)
            if got < 0:
                msg = self._lib.hpgq_gz_message(self._h).decode(errors="replace")
                raise _ERRORS[-got](msg)
        self._pos += got
        return got

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
        buf = _new_bytes(None, n)
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
                self._lib.hpgq_gz_close(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
