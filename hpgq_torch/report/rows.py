"""The report writer's per-position files, one line a position: a line
format applied to each row of a few columns.

A format holds literal text and three conversions, each taking the next
column: ``%i`` (integers), ``%c`` (integers, the byte of their low 8 bits,
written as ``chr`` of it) and ``%0.2f`` (floats, as glibc's ``printf``
prints them, :func:`hpgq_torch.utils.cfmt.fmt2f`).  :func:`write_rows`
formats every row in one call of ``rows.cpp``, built on first use by
:func:`hpgq_torch.io.native.load` into ``io/native/_build/_rows.so`` and
bound with ctypes; without the library (no compiler, ``HPGQ_NO_NATIVE``) or where its
text would not fit, Python formats the same text (:func:`format_rows_py`).
The native text goes to the file's byte stream from a buffer kept per
thread, with no string made of it, where the file's encoding is
UTF-8 or ASCII and every ``%c`` byte is ASCII.
"""

from __future__ import annotations

import codecs
import ctypes
import os
import re
import threading

import numpy as np

from ..io.native import load
from ..utils.cfmt import fmt2f

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rows.cpp")
_ABI = 1  # must match hpgq_rows_abi_version() in rows.cpp

_CONV = re.compile(r"%(i|c|0\.2f)")

_local = threading.local()


def _bind(lib):
    lib.hpgq_format_rows.restype = ctypes.c_int64
    lib.hpgq_format_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]


def get_lib():
    """The loaded library, or None if unavailable."""
    return load(_SRC, "_rows.so", "hpgq_rows_abi_version", _ABI, _bind,
                "report rows", "Python")


def _columns(fmt: str, columns) -> list:
    """Each column as the C-contiguous array its conversion reads."""
    kinds = _CONV.findall(fmt)
    if len(kinds) != len(columns):
        raise ValueError("%d conversions, %d columns" % (len(kinds), len(columns)))
    return [np.ascontiguousarray(col, np.float64 if k == "0.2f" else np.int64)
            for k, col in zip(kinds, columns)]


def _room(nbytes: int) -> np.ndarray:
    """This thread's output buffer, at least ``nbytes`` long: kept from
    one file to the next, so its pages are touched once, not a file."""
    buf = getattr(_local, "buf", None)
    if buf is None or buf.shape[0] < nbytes:
        buf = _local.buf = np.empty(nbytes, np.uint8)
    return buf


def write_rows(f, fmt: str, *columns) -> None:
    """Write ``fmt`` applied to each row of ``columns`` (one a conversion,
    all of one length) to the text file ``f``, as
    ``f.write(format_rows_py(fmt, *columns))`` would."""
    cols = _columns(fmt, columns)
    n = len(cols[0]) if cols else 0
    lib = get_lib()
    if lib is None or n == 0 or not fmt.isascii():
        f.write(format_rows_py(fmt, *cols))
        return
    cap = n * (len(fmt) + 24 * len(cols)) + 512
    out = _room(cap)
    ptrs = (ctypes.c_void_p * len(cols))(*[c.ctypes.data for c in cols])
    got = lib.hpgq_format_rows(fmt.encode(), n, ptrs, len(cols),
                               out.ctypes.data, cap)
    if got < 0:  # a value too wide for the room given
        f.write(format_rows_py(fmt, *cols))
        return
    chars = [c for k, c in zip(_CONV.findall(fmt), cols) if k == "c"]
    if (codecs.lookup(f.encoding).name not in ("utf-8", "ascii")
            or any(((c & 0xFF) >= 0x80).any() for c in chars)):
        # the text file encodes chr() of each byte in its own way
        f.write(out[:got].tobytes().decode("latin-1"))
        return
    f.flush()
    f.buffer.write(memoryview(out)[:got])


def format_rows_py(fmt: str, *columns) -> str:
    """The text :func:`write_rows` writes, in Python: one ``%`` call for
    the whole file."""
    cols = _columns(fmt, columns)
    if not cols:
        return ""
    flat = [None] * (len(cols) * len(cols[0]))
    for j, (k, col) in enumerate(zip(_CONV.findall(fmt), cols)):
        if k == "0.2f":
            flat[j::len(cols)] = fmt2f(col)
        elif k == "c":
            flat[j::len(cols)] = [chr(v) for v in (col & 0xFF).tolist()]
        else:
            flat[j::len(cols)] = col.tolist()
    return (_CONV.sub(lambda m: "%i" if m.group(1) == "i" else "%s", fmt)
            * len(cols[0])) % tuple(flat)
