"""The port's own copy of ``hpgq/io/native/__init__.py`` (the port imports nothing of
``hpgq``); the library builds
from this directory's ``packer.cpp`` (grown from ``hpgq``'s: the same
buffers, an ABI of its own) into ``_build/`` here, never into or from
``hpgq``'s directory.

Native (C++) packer: build-on-demand + ctypes bindings.

The shared library is compiled from ``packer.cpp`` on first use (g++ -O3
-fopenmp) and cached next to the source; if no compiler is available the
callers fall back to the pure-numpy packer transparently
(``hpgq_torch.io.packer.pack_block``).  Bindings use ctypes — this toolchain has
no pybind11 (see repo environment notes).

:func:`load` builds and loads every g++ library of the port, this packer,
``inflate.cpp`` (:mod:`.inflate`) and ``report/rows.cpp``
(:mod:`hpgq_torch.report.rows`), all into ``_build/`` here.

:func:`plan` shares the process's host cores among a reader's stages: the
decode pool, the index's newline scan and the pack calls.  A call here that
is given no team size takes the user's (:func:`set_num_threads`), else its
thread's planned one (:func:`use_team`), else all the cores a lone caller
may use.
"""

from __future__ import annotations

import ctypes
import dataclasses
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

_libs: dict = {}  # .so path -> the loaded library, or None once it failed
_locks: dict = {}  # .so path -> the lock its first load runs under
_locks_lock = threading.Lock()


def _build(src: str, so: str) -> str:
    """Compile ``src`` -> ``so`` (atomic rename, race-safe); the port's
    three g++ libraries build with these flags."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
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


def _open(path: str, abi_symbol: str):
    """(the library at ``path``, the ABI version it reports); its calls
    keep ``errno`` for :func:`ctypes.get_errno`."""
    lib = ctypes.CDLL(path, use_errno=True)
    version = getattr(lib, abi_symbol)
    version.restype = ctypes.c_int
    return lib, version()


def _load(src, so, abi_symbol, abi, bind):
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        _build(src, so)
    lib, got = _open(so, abi_symbol)
    if got != abi:
        # a stale library the mtime check missed (copied build dirs,
        # timestamp-preserving extraction): rebuild once.  dlopen hands
        # back the library it already loaded under the same name, so the
        # rebuilt file (a new inode) is opened under another spelling
        _build(src, so)
        lib, got = _open(os.path.join(os.path.dirname(so), ".",
                                      os.path.basename(so)), abi_symbol)
        if got != abi:
            raise RuntimeError("ABI %d != expected %d" % (got, abi))
    bind(lib)
    return lib


def load(src: str, name: str, abi_symbol: str, abi: int, bind, what: str,
         fallback: str):
    """The g++ library ``_build/<name>`` built from ``src``, or None;
    decided once per library and process.

    None under ``HPGQ_NO_NATIVE``.  Else the library is built where it is
    missing or older than ``src``, loaded, held to ABI ``abi`` by its
    ``abi_symbol()`` (a mismatch rebuilds once), and ``bind(lib)``
    declares its functions.  On any failure (no compiler, a load, symbol
    or ABI error) it logs at info that the native ``what`` is unavailable
    and the caller uses ``fallback``, and gives None."""
    so = os.path.join(_BUILD, name)
    if so in _libs:
        return _libs[so]
    with _locks_lock:
        lock = _locks.setdefault(so, threading.Lock())
    with lock:
        if so not in _libs:
            lib = None
            if not os.environ.get("HPGQ_NO_NATIVE"):
                try:
                    lib = _load(src, so, abi_symbol, abi, bind)
                except Exception as e:  # no compiler / load / symbol failure
                    log.info("native %s unavailable (%s); using %s",
                             what, e, fallback)
            _libs[so] = lib
        return _libs[so]


def get_lib():
    """The loaded native packer, or None if unavailable."""
    return load(_SRC, "_packer.so", "hpgq_abi_version", _ABI, _bind,
                "packer", "numpy packer")


_ABI = 11  # must match hpgq_abi_version() in packer.cpp

# ---------------------------------------------------------------- the plan

_TEAM_MAX = 8  # the widest team a call gets unless the user asks for more
_explicit = 0  # the user's team size (--num-threads), 0 = planned
_team = threading.local()  # .size: the calling thread's planned team


def set_num_threads(n: int) -> None:
    """The user's team size for every native call and stage (the CLI's
    ``--num-threads``); 0 gives the choice back to :func:`plan`."""
    global _explicit
    _explicit = max(0, int(n))


def num_threads() -> int:
    """The user's team size, 0 where none was set."""
    return _explicit


def usable_cores() -> int:
    """The cores this process may use: its CPU affinity, shared among
    the host's local ranks (``LOCAL_WORLD_SIZE``), at least 1."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    try:
        ranks = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    except ValueError:
        ranks = 1
    return max(1, cores // ranks)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Threads of a reader's stages that run at once (:func:`plan`)."""

    cores: int     # usable cores (:func:`usable_cores`)
    pools: int     # decode pools: 0, 1 (gzip's, shared) or one a reader (BGZF)
    decode: int    # each decode pool's threads
    shards: int    # shard pipelines running at once, each as below
    mates: int     # a pipeline's readers, each indexing (2 for paired input)
    index: int     # each reader's newline-scan team
    packers: int   # a pipeline's pack workers, 0: its reader packs in turn
    pack: int      # each pack call's team
    intra_op: int  # threads of each packed batch's copy to pinned memory

    def threads(self) -> int:
        """The threads the plan runs at once."""
        if self.packers:
            work = self.mates * self.index + self.packers * self.pack
        else:
            work = self.mates * max(self.index, self.pack)
        return self.pools * self.decode + self.shards * work

    def __str__(self) -> str:
        return ("decode %d x %d, %d x (index %d x %d, pack %d x %d), "
                "intra-op %d: %d threads of %d cores" % (
                    self.pools, self.decode, self.shards, self.mates,
                    self.index, self.packers, self.pack, self.intra_op,
                    self.threads(), self.cores))


def plan(decoder: str = "", shards: int = 1, mates: int = 1,
         packers=None) -> Plan:
    """One plan of the process's host cores for a reader's stages, and the
    one place that sizes the decode pools.

    ``decoder``: the input's decode pool, ``""`` for none (plain text),
    ``"gzip"`` for the parallel gzip reader's (one pool, shared by the
    process's readers) or ``"bgzf"`` for a BGZF pool of each reader's own;
    ``shards``: pipelines of one or two readers that run at once (shard
    readers), each with ``mates`` readers (2 for paired input) and
    ``packers`` pack workers (None: as many as fit, at most 4; 0: the
    reader packs its own blocks in turn).

    The gzip pool gets half the cores if that is two threads or more,
    else there is none and the reader's own thread decodes; the BGZF
    pools share half the cores, each at least one thread and at most 8.
    Each pipeline takes an equal share of the rest, each reader keeps a
    core of it, the pack workers take what is left, each a team of
    ``(share - mates) // packers``, and the readers' scans what the
    workers leave.  Where fewer than two workers would fit, a single-end
    reader packs its own blocks on the whole share, and a paired one hands
    them to one worker.  Every team is 1 to 8 threads, and a pinned copy
    uses its pack team, so the threads that run at once
    (:meth:`Plan.threads`) stay within the usable cores wherever the
    decode pools, the readers (and a paired pipeline's one pack worker)
    fit, unless the user says otherwise: :func:`set_num_threads`
    (``--num-threads``) sets every team, ``HPGQ_PACK_THREADS`` the pack
    workers."""
    cores = usable_cores()
    shards, mates = max(1, int(shards)), max(1, int(mates))
    pools = decode = 0
    if decoder == "gzip" and cores // 2 >= 2:
        pools, decode = 1, cores // 2
    elif decoder == "bgzf":
        pools = shards * mates
        decode = max(1, min(8, cores // 2 // pools))
    share = max(1, (cores - pools * decode) // shards)
    fewest = 1 if mates > 1 else 0  # paired blocks are packed off the readers
    forced = int(os.environ.get("HPGQ_PACK_THREADS", "0") or 0)
    if forced > 0:
        packers = forced if forced > 1 else fewest
    elif packers is None or packers > 0:
        packers = min(4 if packers is None else int(packers), share - mates)
        if packers < 2:
            packers = fewest
    else:
        packers = fewest
    if packers:
        pack = max(1, (share - mates) // packers)
        index = max(1, (share - packers * pack) // mates)
    else:
        index = pack = share
    index, pack = min(index, _TEAM_MAX), min(pack, _TEAM_MAX)
    if _explicit:
        index = pack = _explicit
    return Plan(cores, pools, decode, shards, mates, index, packers, pack,
                pack)


def use_team(n: int) -> None:
    """The team size of the calling thread's native calls that are given
    none (a pack worker's share of the plan); 0 clears it."""
    _team.size = max(0, int(n))


def _threads(num_threads: int) -> int:
    """The team of a call given ``num_threads`` (<= 0: none)."""
    if num_threads > 0:
        return num_threads
    if _explicit:
        return _explicit
    return getattr(_team, "size", 0) or min(_TEAM_MAX, usable_cores())


def count_team_short(timers) -> None:
    """Add to ``timers``' count ``team-short`` the calling thread's native
    calls whose OpenMP team came up smaller than asked since it last did
    (nothing without the library)."""
    lib = get_lib()
    if lib is not None:
        timers.count("team-short", lib.hpgq_team_short())


def copy_into(dst: np.ndarray, src: np.ndarray, num_threads: int = 0) -> None:
    """``dst[...] = src`` for arrays of one shape and dtype, on a native
    team (``num_threads``, 0: the calling thread's) where both are
    contiguous."""
    lib = get_lib()
    if (lib is None or not dst.flags.c_contiguous
            or not src.flags.c_contiguous or dst.nbytes != src.nbytes):
        np.copyto(dst, src)
        return
    lib.hpgq_copy(src.ctypes.data, dst.ctypes.data, src.nbytes,
                  _threads(num_threads))


# a bytes object of n bytes left uninitialized, for native code to fill
# before anyone else sees it (the C API's documented way to build bytes);
# a private prototype, so ctypes.pythonapi's shared one stays as it is
new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p,
                              ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))


def _address(buf: bytes) -> int:
    """The address of a bytes object's first byte."""
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value


def join(head: bytes, tail: bytes, num_threads: int = 0) -> bytes:
    """``head + tail``, copied by native code with the interpreter lock
    released, ``tail`` on a team (``num_threads``, 0: the calling
    thread's); ``head + tail`` itself without the library."""
    lib = get_lib()
    if lib is None:
        return head + tail
    out = new_bytes(None, len(head) + len(tail))
    at = _address(out)
    lib.hpgq_copy(head, at, len(head), 1)
    lib.hpgq_copy(tail, at + len(head), len(tail), _threads(num_threads))
    return out


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
    lib.hpgq_pack_ragged6.restype = ctypes.c_int32
    lib.hpgq_pack_ragged6.argtypes = [
        u8p, i64p, i64p, i32p, i64p, ctypes.c_int64, i8p, u8p, u8p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.hpgq_team_short.restype = ctypes.c_int64
    lib.hpgq_team_short.argtypes = []
    lib.hpgq_copy.restype = None
    lib.hpgq_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_int]
    lib.hpgq_record_table.restype = ctypes.c_int64
    lib.hpgq_record_table.argtypes = [u8p, i64p, ctypes.c_int64, i64p,
                                      i64p]


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
        num_threads = _threads(num_threads)
        out = _nl_scratch(max(64, n // 8))
        if num_threads == 1:  # one pass, where the scratch holds them all
            cnt = lib.hpgq_find_newlines(arr, n, out, out.shape[0])
            if cnt < out.shape[0]:
                return out[:cnt]
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


def record_table(buf, nl: np.ndarray, nrec: int):
    """``(starts, ends, bad)``: the [nrec, 4] line tables of ``nrec``
    records of ``buf``, from their newline offsets, each line end moved
    back over a ``\\r`` before its newline, and the first record whose
    sequence and quality lengths differ or whose header is not ``@`` or
    separator not ``+`` (-1 for none); one native pass with the
    interpreter lock released."""
    lib = get_lib()
    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    starts = np.empty((nrec, 4), dtype=np.int64)
    ends = np.empty((nrec, 4), dtype=np.int64)
    bad = lib.hpgq_record_table(arr, np.ascontiguousarray(nl[: nrec * 4]),
                                nrec, starts.reshape(-1), ends.reshape(-1))
    return starts, ends, int(bad)


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
    num_threads = _threads(num_threads)
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
    num_threads = _threads(num_threads)
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
    num_threads = _threads(num_threads)
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
    num_threads = _threads(num_threads)
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
    num_threads = _threads(num_threads)
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


RAGGED_TAIL = 16  # zero bytes after the last row: a decode may read past it


def ragged_head(rows: int) -> int:
    """Bytes of the table before the rows of a ragged wire of ``rows``
    rows (:func:`ragged_layout`)."""
    return -(-14 * rows // 16) * 16


def ragged_layout(lens) -> "tuple[np.ndarray, int, int]":
    """``(off, head, total)`` of the ragged 6-bit wire of rows of ``lens``
    (int [R], in wire order): row i's codes at ``head + off[i]``, 3 bytes
    an 8-column group, its qualities after them from the next multiple of
    4 bytes, 6 bytes a group, then the next row from the next multiple of
    4 bytes; before the rows, its table, ``head`` bytes: ``off`` int64
    [R], the lengths int32 [R], ``qbase`` uint8 [R] and ``valid`` uint8
    [R], padded to 16 bytes; ``total`` bytes in all, with
    :data:`RAGGED_TAIL` after the rows."""
    R = len(lens)
    groups = (np.asarray(lens, dtype=np.int64).clip(0) + 7) // 8
    size = (3 * groups + 3) // 4 * 4 + (6 * groups + 3) // 4 * 4
    off = np.zeros(R, dtype=np.int64)
    np.cumsum(size[:-1], out=off[1:])
    head = ragged_head(R)
    return off, head, head + int(size.sum()) + RAGGED_TAIL


def ragged_table(buf: np.ndarray, R: int):
    """Views of the table at the front of a ragged wire of ``R`` rows:
    ``(off, lens, qbase, valid)`` (:func:`ragged_layout`)."""
    return (buf[:8 * R].view(np.int64), buf[8 * R:12 * R].view(np.int32),
            buf[12 * R:13 * R], buf[13 * R:14 * R])


def pack_ragged6(buf, seq_starts, q_starts, lens, lut=None, simd=True,
                 num_threads: int = 0):
    """The ragged 6-bit wire of the reads at ``seq_starts``/``q_starts``
    of ``lens`` bases, in that order (:func:`ragged_layout`): one uint8
    buffer, the table then the rows, every row ``valid`` and at its own
    length, its qualities re-based on its minimum (``qbase``).  None when
    a row's qualities span 64 values or more.  ``lut`` is the base-code
    table (``hpgq_torch.io.packer.BASE_LUT``); ``simd`` False packs by
    whole groups where the CPU has AVX2 too."""
    lib = get_lib()
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    R = len(lens)
    off, head, total = ragged_layout(lens)
    out = np.zeros(total, dtype=np.uint8)
    t_off, t_lens, qbase, valid = ragged_table(out, R)
    t_off[:] = off
    t_lens[:] = lens
    valid[:] = 1
    if lut is None:
        from ..packer import BASE_LUT as lut
    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    ok = lib.hpgq_pack_ragged6(
        arr,
        np.ascontiguousarray(seq_starts, dtype=np.int64),
        np.ascontiguousarray(q_starts, dtype=np.int64),
        lens, off, R, lut, qbase, out[head:], int(bool(simd)),
        _threads(num_threads),
    )
    return out if ok else None


def pack_qnwire(buf, seq_starts, q_starts, lens, L: int, nrows: int,
                num_threads: int = 0) -> np.ndarray:
    """qn8 wire buffer uint8 [nrows, L + 8]: per base (qual & 0x7F) |
    (is_N << 7), then len_le32|valid|pad3 — the minimal wire for the
    filter/edit verdict+trim kernels (see hpgq_pack_qnwire /
    stats_jnp.wire_unqn8)."""
    lib = get_lib()
    n = len(lens)
    out = np.empty((nrows, L + 8), dtype=np.uint8)
    num_threads = _threads(num_threads)
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
    num_threads = _threads(num_threads)
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
