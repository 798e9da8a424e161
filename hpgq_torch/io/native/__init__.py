"""The port's own copy of ``hpgq/io/native/__init__.py`` (the port imports nothing of
``hpgq``); the library builds
from this directory's ``packer.cpp`` (a copy of ``hpgq``'s, same ABI) into
``_build/`` here, never into or from ``hpgq``'s directory.

Native (C++) packer: build-on-demand + ctypes bindings.

The shared library is compiled from ``packer.cpp`` on first use (g++ -O3
-fopenmp) and cached next to the source; if no compiler is available the
callers fall back to the pure-numpy packer transparently
(``hpgq_torch.io.packer.pack_block``).  Bindings use ctypes — this toolchain has
no pybind11 (see repo environment notes).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading

import numpy as np

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "packer.cpp")
_BUILD = os.path.join(_HERE, "_build")  # listed in .gitignore
_SO = os.path.join(_BUILD, "_packer.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build(src: str = _SRC, so: str = _SO) -> str:
    """Compile ``src`` (packer.cpp) -> ``so`` (_packer.so) (atomic rename,
    race-safe); ``inflate.cpp`` builds with the same flags."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
        "-march=native", src, "-o", tmp,
    ]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            # -march=native can be unsupported on exotic hosts; retry plain
            subprocess.run(
                [a for a in cmd if a != "-march=native"],
                check=True, capture_output=True, timeout=120,
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("HPGQ_NO_NATIVE"):
            return None
        def _load():
            lib = ctypes.CDLL(_SO)
            lib.hpgq_abi_version.restype = ctypes.c_int
            return lib

        try:
            if not os.path.exists(_SRC):
                # prebuilt .so shipped without source: usable iff the ABI
                # matches (the rebuild path below is unavailable)
                if not os.path.exists(_SO):
                    raise FileNotFoundError(_SRC)
                lib = _load()
                if lib.hpgq_abi_version() != _ABI:
                    raise RuntimeError(
                        "prebuilt native packer ABI %d != expected %d and "
                        "packer.cpp is absent" % (lib.hpgq_abi_version(), _ABI)
                    )
                _bind(lib)
                _lib = lib
                return _lib
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                _build()
            lib = _load()
            if lib.hpgq_abi_version() != _ABI:
                # a stale .so can out-date the mtime check (copied build
                # dirs, timestamp-preserving extraction): rebuild once, and
                # fall back to numpy rather than crash if still mismatched
                _build()
                lib = _load()
                if lib.hpgq_abi_version() != _ABI:
                    raise RuntimeError(
                        "native packer ABI %d != expected %d"
                        % (lib.hpgq_abi_version(), _ABI)
                    )
            _bind(lib)
        except Exception as e:  # no compiler / load / symbol failure
            log.info("native packer unavailable (%s); using numpy packer", e)
            return None
        _lib = lib
        return _lib


_ABI = 8  # must match hpgq_abi_version() in packer.cpp


def _bind(lib):
    """Declare restype/argtypes for every exported symbol (an AttributeError
    here means a stale library and routes to the numpy fallback)."""
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.hpgq_find_newlines.restype = ctypes.c_int64
    lib.hpgq_find_newlines.argtypes = [
        u8p, ctypes.c_int64, i64p, ctypes.c_int64,
    ]
    lib.hpgq_pack.restype = None
    lib.hpgq_pack.argtypes = [
        u8p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, i8p, i8p, u8p, ctypes.c_int,
    ]
    lib.hpgq_line_table.restype = None
    lib.hpgq_line_table.argtypes = [i64p, ctypes.c_int64, i64p, i64p]
    lib.hpgq_concat_spans.restype = ctypes.c_int64
    lib.hpgq_concat_spans.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64, u8p,
    ]
    lib.hpgq_find_newlines_mt.restype = ctypes.c_int64
    lib.hpgq_find_newlines_mt.argtypes = [
        u8p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.hpgq_pack_bitwire.restype = None
    lib.hpgq_pack_bitwire.argtypes = [
        u8p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i8p, u8p,
        ctypes.c_int,
    ]
    lib.hpgq_pack_qnwire.restype = None
    lib.hpgq_pack_qnwire.argtypes = [
        u8p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i8p, u8p,
        ctypes.c_int,
    ]
    lib.hpgq_pack_bitwire6.restype = ctypes.c_int32
    lib.hpgq_pack_bitwire6.argtypes = [
        u8p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i8p, u8p, ctypes.c_int,
    ]
    lib.hpgq_pack_bitwire2q.restype = ctypes.c_int32
    lib.hpgq_pack_bitwire2q.argtypes = [
        u8p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i8p, u8p, ctypes.c_int,
    ]
    lib.hpgq_pack_bitwire2c.restype = ctypes.c_int64
    lib.hpgq_pack_bitwire2c.argtypes = [
        u8p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i8p, u8p, i32p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.hpgq_pack_bitwire2u.restype = ctypes.c_int64
    lib.hpgq_pack_bitwire2u.argtypes = [
        u8p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i8p, u8p, i32p, ctypes.c_int64, u8p, ctypes.c_int,
    ]


def available() -> bool:
    return get_lib() is not None


_tl = threading.local()  # per-thread newline scratch (16 MB chunks would
# otherwise pay a fresh allocation + first-touch page faults per chunk)


def _nl_scratch(n: int) -> np.ndarray:
    buf = getattr(_tl, "nl_buf", None)
    if buf is None or buf.shape[0] < n:
        buf = np.empty(n, dtype=np.int64)
        _tl.nl_buf = buf
    return buf


def find_newlines(buf, num_threads: int = 0) -> np.ndarray:
    """All newline offsets in buf via parallel native memchr segments.

    Large buffers use the two-pass multi-threaded scan (count, prefix,
    fill); small ones the single-thread capacity-doubling path.

    NOTE: for large buffers the result is a view of a per-thread scratch
    that the NEXT find_newlines call on the same thread overwrites — every
    caller consumes the offsets before scanning its next chunk (the
    streaming readers are strictly sequential per thread)."""
    lib = get_lib()
    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    n = arr.shape[0]
    if n >= (1 << 21):
        if num_threads <= 0:
            num_threads = min(8, os.cpu_count() or 1)
        out = _nl_scratch(max(64, n // 8))
        # capacity-aware: the C side returns the negated true count (writing
        # nothing) when it exceeds cap; retry once with the exact size
        cnt = lib.hpgq_find_newlines_mt(arr, n, out, out.shape[0], num_threads)
        if cnt >= 0:
            return out[:cnt]
        out = _nl_scratch(-cnt)
        cnt2 = lib.hpgq_find_newlines_mt(arr, n, out, out.shape[0], num_threads)
        assert cnt2 == -cnt
        return out[:cnt2]
    cap = max(64, n // 16)
    chunks = []
    off = 0
    while True:
        out = np.empty(cap, dtype=np.int64)
        got = lib.hpgq_find_newlines(arr[off:], n - off, out, cap)
        if got:
            chunks.append(out[:got] + off)
        if got < cap:
            break
        off = int(chunks[-1][-1]) + 1
        cap *= 2
    if not chunks:
        return np.empty(0, dtype=np.int64)
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)


def line_table(nl: np.ndarray, nrec: int):
    lib = get_lib()
    starts = np.empty((nrec, 4), dtype=np.int64)
    ends = np.empty((nrec, 4), dtype=np.int64)
    lib.hpgq_line_table(np.ascontiguousarray(nl[: nrec * 4]), nrec,
                        starts.reshape(-1), ends.reshape(-1))
    return starts, ends


def concat_spans(buf, starts, ends) -> memoryview:
    """b"".join(buf[s:e] for s, e in zip(starts, ends)) via native memcpys."""
    lib = get_lib()
    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    total = int(np.maximum(ends - starts, 0).sum())
    out = np.empty(total, dtype=np.uint8)
    n = lib.hpgq_concat_spans(arr, starts, ends, len(starts), out)
    assert n == total, (n, total)
    return memoryview(out)  # zero-copy; file.write accepts buffers


def pack_bitwire(buf, seq_starts, q_starts, lens, L: int, nrows: int,
                 num_threads: int = 0) -> np.ndarray:
    """Bitpack wire buffer uint8 [nrows, 3L/8 + 7L/8 + 8] (L % 8 == 0)
    straight from chunk bytes — see hpgq_pack_bitwire / stats_jnp.wire_unbits."""
    lib = get_lib()
    assert L % 8 == 0, L
    n = len(lens)
    W = 3 * L // 8 + 7 * L // 8 + 8
    out = np.empty((nrows, W), dtype=np.uint8)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    from ..packer import BASE_LUT

    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    lib.hpgq_pack_bitwire(
        arr,
        np.ascontiguousarray(seq_starts, dtype=np.int64),
        np.ascontiguousarray(q_starts, dtype=np.int64),
        np.ascontiguousarray(lens, dtype=np.int32),
        n, L, nrows, BASE_LUT, out.reshape(-1), num_threads,
    )
    return out


def bitwire6_width(L: int) -> int:
    """Row width of the bitpack6 layout: 9L/8 + 8, bumped by one pad byte
    when that collides with a valid 7-bit bitpack width (the decoder
    distinguishes the layouts by width alone; valid 7-bit widths are 10
    apart, so at most one bump)."""
    W = 9 * L // 8 + 8
    body = (W - 8) * 8
    if body % 10 == 0 and (body // 10) % 8 == 0:
        W += 1
    return W


def pack_bitwire6(buf, seq_starts, q_starts, lens, L: int, nrows: int,
                  num_threads: int = 0):
    """Bitpack6 wire buffer uint8 [nrows, bitwire6_width(L)] (3-bit codes
    + 6-bit re-based quals + per-row qbase) — or None when some row's
    qual range spans >= 64 values (caller falls back to 7-bit bitpack).
    See hpgq_pack_bitwire6 / stats_jnp.wire_unbits."""
    lib = get_lib()
    assert L % 8 == 0, L
    n = len(lens)
    W = bitwire6_width(L)
    out = np.empty((nrows, W), dtype=np.uint8)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    from ..packer import BASE_LUT

    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    ok = lib.hpgq_pack_bitwire6(
        arr,
        np.ascontiguousarray(seq_starts, dtype=np.int64),
        np.ascontiguousarray(q_starts, dtype=np.int64),
        np.ascontiguousarray(lens, dtype=np.int32),
        n, L, nrows, W, BASE_LUT, out.reshape(-1), num_threads,
    )
    return out if ok else None


def bitwire2q_width(L: int) -> int:
    """Row width of the bitpack2q layout: 5L/8 + 12 (3-bit codes + 2-bit
    palette indices + len/valid/palette tail), bumped by pad bytes while
    it collides with a valid 7-bit OR a valid 6-bit width (the decoder
    distinguishes the three layouts by width alone; within any 5-byte
    window there is at most one width of each other family, so at most
    two bumps — consecutive 2q widths are 5 apart and stay disjoint)."""
    W = 5 * L // 8 + 12

    def _is7(w: int) -> bool:
        body = (w - 8) * 8
        return body % 10 == 0 and (body // 10) % 8 == 0

    def _is6(w: int) -> bool:
        L6 = ((w - 8) * 8 // 9) // 8 * 8
        return L6 > 0 and bitwire6_width(L6) == w

    while _is7(W) or _is6(W):
        W += 1
    return W


def pack_bitwire2q(buf, seq_starts, q_starts, lens, L: int, nrows: int,
                   num_threads: int = 0):
    """Bitpack2q wire buffer uint8 [nrows, bitwire2q_width(L)] (3-bit
    codes + 2-bit indices into a per-row 4-entry qual palette) — or None
    when some row holds > 4 distinct qual values (caller falls down the
    6-bit → 7-bit ladder).  Production Illumina corpora (NovaSeq/NextSeq
    RTA3 binning) emit exactly 4 distinct levels, fitting 5 bits/base.
    See hpgq_pack_bitwire2q / stats_jnp.wire_unbits."""
    lib = get_lib()
    assert L % 8 == 0, L
    n = len(lens)
    W = bitwire2q_width(L)
    out = np.empty((nrows, W), dtype=np.uint8)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    from ..packer import BASE_LUT

    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    ok = lib.hpgq_pack_bitwire2q(
        arr,
        np.ascontiguousarray(seq_starts, dtype=np.int64),
        np.ascontiguousarray(q_starts, dtype=np.int64),
        np.ascontiguousarray(lens, dtype=np.int32),
        n, L, nrows, W, BASE_LUT, out.reshape(-1), num_threads,
    )
    return out if ok else None


def bitwire2c_width(L: int) -> int:
    """Row width of the bitpack2c layout: 4L/8 + 12 (2-bit base codes +
    2-bit palette indices + len/valid/palette tail), bumped by pad bytes
    while it collides with a valid 7-bit, 6-bit, or 2q width (the decoder
    family is identified by width; 2c buffers additionally always travel
    with their exception sidecar, see ``pack_bitwire2c``)."""
    W = 4 * L // 8 + 12

    def _is7(w: int) -> bool:
        body = (w - 8) * 8
        return body % 10 == 0 and (body // 10) % 8 == 0

    def _is6(w: int) -> bool:
        L6 = ((w - 8) * 8 // 9) // 8 * 8
        return L6 > 0 and bitwire6_width(L6) == w

    def _is2q(w: int) -> bool:
        m = (w - 12) // 5
        for mm in (m, m - 1):
            if mm >= 1 and bitwire2q_width(8 * mm) == w:
                return True
        return False

    while _is7(W) or _is6(W) or _is2q(W):
        W += 1
    return W


# exception sidecar row bucket: padded to multiples of this many int32
# entries so the jitted decode compiles for a handful of shapes only
EXC_BUCKET = 8192


def exc_pad(exc: np.ndarray, nrows: int, L: int) -> np.ndarray:
    """Pad an exception list to the EXC_BUCKET grid with OOB sentinels
    (enc = (nrows*L) << 1 — past the flat [nrows*L] scatter target, so
    ``mode='drop'`` ignores them)."""
    cap = max(EXC_BUCKET, -(-max(len(exc), 1) // EXC_BUCKET) * EXC_BUCKET)
    out = np.full(cap, np.int32((nrows * L) << 1), dtype=np.int32)
    out[: len(exc)] = exc
    return out


def pack_bitwire2c(buf, seq_starts, q_starts, lens, L: int, nrows: int,
                   num_threads: int = 0):
    """Bitpack2c wire: ``(buf uint8 [nrows, bitwire2c_width(L)],
    exc int32 [E_padded])`` — 2-bit base codes (A..T = 0..3; N and OTHER
    positions packed as 0 and recorded in the exception sidecar) + 2-bit
    indices into a per-row 4-entry qual palette.  Exceptions are
    ``((row * L + pos) << 1) | is_other`` in row-major order; the device
    decode scatter-restores codes 4/5, so downstream kernels see EXACT
    codes (``stats_jnp.wire_unbits2c``).  Returns None when some row holds
    > 4 distinct qual values or the exception capacity (~6% of positions)
    overflows (caller falls back to the 2q tier).  4.1 bits/base vs 2q's
    5 — the narrowest layout of the adaptive ladder."""
    lib = get_lib()
    assert L % 8 == 0, L
    if nrows * L >= (1 << 30):  # exception encoding must fit int32 << 1
        return None
    n = len(lens)
    W = bitwire2c_width(L)
    out = np.empty((nrows, W), dtype=np.uint8)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    exc_cap = max(8192, n * L // 16)
    exc = np.empty(exc_cap, dtype=np.int32)
    from ..packer import BASE_LUT

    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    got = lib.hpgq_pack_bitwire2c(
        arr,
        np.ascontiguousarray(seq_starts, dtype=np.int64),
        np.ascontiguousarray(q_starts, dtype=np.int64),
        np.ascontiguousarray(lens, dtype=np.int32),
        n, L, nrows, W, BASE_LUT, out.reshape(-1), exc, exc_cap,
        num_threads,
    )
    if got < 0:
        return None
    return out, exc_pad(exc[:got], nrows, L)


def bitwire2u_width(Lu: int) -> int:
    """Row width of the bitpack2u (uniform) layout: two bare 2-bit planes
    padded to whole even bytes — 4 * ceil(Lu/8).  No tail: lengths,
    validity, and the palette travel as a per-batch sidecar, and the
    decode is dispatched explicitly (never width-sniffed), so no
    collision bumps are needed."""
    return 4 * ((Lu + 7) // 8)


def pack_bitwire2u(buf, seq_starts, q_starts, lens, Lu: int, nrows: int,
                   num_threads: int = 0):
    """Bitpack2u (uniform-tier) wire: ``(buf uint8 [nrows, 4*ceil(Lu/8)],
    exc int32 [E_padded], pal uint8 [4], n_valid)`` — applies when every
    read has the same length ``Lu`` and the block-wide union of qual
    values fits one 4-entry palette.  52 B per 100 bp read vs the 2c
    tier's 66 (the per-row len/valid/palette tail becomes a per-batch
    sidecar).  Returns None when the block misses the tier (non-uniform
    lengths, > 4 distinct quals in the union, or exception overflow);
    the caller falls back to 2c."""
    lib = get_lib()
    Lp = 8 * ((Lu + 7) // 8)
    if nrows * Lp >= (1 << 30):
        return None
    n = len(lens)
    W = bitwire2u_width(Lu)
    out = np.empty((nrows, W), dtype=np.uint8)
    pal = np.zeros(4, dtype=np.uint8)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    exc_cap = max(8192, n * Lu // 16)
    exc = np.empty(exc_cap, dtype=np.int32)
    from ..packer import BASE_LUT

    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    got = lib.hpgq_pack_bitwire2u(
        arr,
        np.ascontiguousarray(seq_starts, dtype=np.int64),
        np.ascontiguousarray(q_starts, dtype=np.int64),
        np.ascontiguousarray(lens, dtype=np.int32),
        n, Lu, nrows, BASE_LUT, out.reshape(-1), exc, exc_cap, pal,
        num_threads,
    )
    if got < 0:
        return None
    return out, exc_pad(exc[:got], nrows, Lp), pal, n


def pack_qnwire(buf, seq_starts, q_starts, lens, L: int, nrows: int,
                num_threads: int = 0) -> np.ndarray:
    """qn8 wire buffer uint8 [nrows, L + 8]: per base (qual & 0x7F) |
    (is_N << 7), then len_le32|valid|pad3 — the minimal wire for the
    filter/edit verdict+trim kernels (see hpgq_pack_qnwire /
    stats_jnp.wire_unqn8)."""
    lib = get_lib()
    n = len(lens)
    out = np.empty((nrows, L + 8), dtype=np.uint8)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    from ..packer import BASE_LUT

    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    lib.hpgq_pack_qnwire(
        arr,
        np.ascontiguousarray(seq_starts, dtype=np.int64),
        np.ascontiguousarray(q_starts, dtype=np.int64),
        np.ascontiguousarray(lens, dtype=np.int32),
        n, L, nrows, BASE_LUT, out.reshape(-1), num_threads,
    )
    return out


def pack_rows(buf, seq_starts, q_starts, lens, lmax: int, nrows: int,
              num_threads: int = 0):
    """codes/quals [nrows, lmax] from per-read offsets (rows >= len(lens)
    are padding: codes=5/quals=0/len=0)."""
    lib = get_lib()
    n = len(lens)
    codes = np.empty((nrows, lmax), dtype=np.int8)
    quals = np.empty((nrows, lmax), dtype=np.uint8)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    from ..packer import BASE_LUT

    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    lib.hpgq_pack(
        arr,
        np.ascontiguousarray(seq_starts, dtype=np.int64),
        np.ascontiguousarray(q_starts, dtype=np.int64),
        np.ascontiguousarray(lens, dtype=np.int32),
        n, lmax, BASE_LUT, codes.reshape(-1), quals.reshape(-1), num_threads,
    )
    if nrows > n:
        from ...constants import BASE_OTHER

        codes[n:] = BASE_OTHER  # matches the C memset pad (packer.cpp)
        quals[n:] = 0
    return codes, quals
