"""The port's native gzip reader (``hpgq_torch.io.native.inflate``) held
to :mod:`gzip` on the same bytes: the text of every valid input byte for
byte, read in 16 MB pieces, one byte at a time and in odd sizes; on every
corrupt, truncated or padded input the exception class
:class:`gzip.GzipFile` raises; and the reader (``FastqReader``) over it
giving the blocks a plain file gives, counted by the stage timers.

Each case runs on the one-thread decoder and on the parallel one, forced
onto every input in small chunks; the parallel one also gives the
one-thread one's bytes, class and message before each error.  Cases of
its own hold it to streams whose chunks need the window before them (one
stream with no flush; pigz's primed pieces), to independent pieces, to
false block headers, and to errors in a later chunk.

The ASan/UBSan build of ``inflate.cpp`` over these inputs and a few
thousand mutated members, through each entry point, runs with
``HPGQ_SANITIZE=1``, as ``tests/test_sanitize.py`` does for the packer:

    HPGQ_SANITIZE=1 python -m pytest tests/test_torch_inflate.py -q
"""

import ctypes
import functools
import gzip
import io
import json
import os
import random
import struct
import subprocess
import sys
import tempfile
import zlib

import pytest

from gen import make_records

from hpgq_torch.io import fastq
from hpgq_torch.io.fastq import FastqReader, ReadaheadFile
from hpgq_torch.io.native import inflate
from hpgq_torch.utils.timers import StageTimers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECE = 16 << 20
READERS = ("sequential", "parallel")
# 3 workers, 4 KiB chunks: every input past a few kB is cut into chunks
PARALLEL = (3, 4096)


@pytest.fixture(scope="module")
def lib():
    got = inflate.get_lib()
    if got is None:
        pytest.skip("no C++ compiler: the native decoder is not built")
    return got


# ---------------------------------------------------------------- inputs


@functools.lru_cache(maxsize=None)
def _text() -> bytes:
    """FASTQ text, binned qualities (long runs of 'F'), ~300 KB."""
    recs = make_records(1500, min_len=60, max_len=120, seed=3, n_prob=0.01,
                        qual_bins=(2, 12, 23, 37))
    return b"".join(h + b"\n" + s + b"\n+\n" + q + b"\n" for h, s, q in recs)


RANDOM = random.Random(5).randbytes(150_000)
RUNS = b"F" * 200_000 + b"FFFF:F,FF" * 3000 + b"#" * 70_000


def _member(data: bytes, level: int = 6, wbits: int = 15,
            strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, 16 + wbits, 8, strategy)
    return co.compress(data) + co.flush()


def _raw(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _framed(raw: bytes, data: bytes, flags: int = 0, extra: bytes = b"xy",
            name: bytes = b"reads.fq", comment: bytes = b"a comment") -> bytes:
    """A member with the header fields ``flags`` asks for."""
    head = struct.pack("<BBBBIBB", 0x1F, 0x8B, 8, flags, 0, 0, 255)
    if flags & 4:
        head += struct.pack("<H", len(extra)) + extra
    if flags & 8:
        head += name + b"\0"
    if flags & 16:
        head += comment + b"\0"
    if flags & 2:
        head += struct.pack("<H", zlib.crc32(head) & 0xFFFF)
    return head + raw + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


def _generator_member(reads: int = 1200,
                      piece_bases: int = 1 << 14) -> "tuple[bytes, bytes]":
    """The benchmark generator's file: one member of sync-flushed pieces
    deflated in parallel, here with pieces of 2**14 bases."""
    sys.path.insert(0, ROOT)
    try:
        from benchmark.traffic import generate
    finally:
        sys.path.remove(ROOT)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "novaseq_se100_rta3.json")) as f:
        config = dict(json.load(f), reads_per_file=reads)
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "stats_filter_gzip.json")) as f:
        traffic = json.load(f)
    old = generate.PIECE_BASES
    generate.PIECE_BASES = piece_bases
    try:
        with tempfile.TemporaryDirectory() as d:
            corpus = generate.make_corpus(config, traffic, 2**31 + 12345, d)
            with open(corpus.path, "rb") as f:
                data = f.read()
    finally:
        generate.PIECE_BASES = old
    return data, gzip.decompress(data)


FLAGS = (("ftext", 1), ("fhcrc", 2), ("fextra", 4), ("fname", 8),
         ("fcomment", 16), ("fall", 31))
STRATEGIES = ("Z_FIXED", "Z_HUFFMAN_ONLY", "Z_RLE", "Z_FILTERED")
VALID_NAMES = (["generator"] + ["level%d" % v for v in range(10)]
               + list(STRATEGIES) + ["wbits%d" % w for w in range(9, 16)]
               + ["members", "empty"] + [f for f, _ in FLAGS]
               + ["fextra_empty", "padding", "random", "runs"])


@functools.lru_cache(maxsize=None)
def _valid_inputs() -> "dict[str, tuple[bytes, bytes]]":
    """name -> (gzip file, its text)."""
    text = _text()
    cases = {"generator": _generator_member()}
    for level in range(10):
        cases["level%d" % level] = (_member(text, level), text)
    for name in STRATEGIES:
        cases[name] = (_member(text, 6, strategy=getattr(zlib, name)), text)
    for wbits in range(9, 16):
        cases["wbits%d" % wbits] = (_member(text, 9, wbits), text)
    half = len(text) // 2
    cases["members"] = (_member(text[:half], 1) + _member(b"")
                        + _member(text[half:], 9) + _member(b"x", 0), text + b"x")
    cases["empty"] = (_member(b""), b"")
    raw = _raw(text)
    for flag, bit in FLAGS:
        cases[flag] = (_framed(raw, text, bit), text)
    cases["fextra_empty"] = (_framed(raw, text, 4, extra=b""), text)
    cases["padding"] = (_member(text) + _member(b"ab") + b"\0" * 1000, text + b"ab")
    cases["random"] = (_member(RANDOM, 6), RANDOM)
    cases["runs"] = (_member(RUNS, 1) + _member(RUNS, 9), RUNS + RUNS)
    assert sorted(cases) == sorted(VALID_NAMES)
    return cases


def _read_sizes(mode: str):
    if mode == "piece":
        while True:
            yield PIECE
    if mode == "odd":
        while True:
            yield from (997, 1, 65537, 4099, 2)
    # one byte at a time through 70 KB (the history's turns), then pieces
    for _ in range(70_000):
        yield 1
    while True:
        yield PIECE


def _open(path: str, reader: str = "sequential") -> inflate.GzipReader:
    workers, chunk = ((0, 0) if reader == "sequential" else PARALLEL
                      if reader == "parallel" else reader)
    return inflate.GzipReader(inflate.get_lib(), path, workers, chunk)


def _read(path: str, mode: str = "piece", reader: str = "sequential"):
    """The text, the error's class and message, and the parallel reader's
    counts, of reading ``path`` natively in the read sizes ``mode`` names
    (``reader``: sequential, parallel, or (workers, chunk bytes))."""
    out = bytearray()
    err = None
    with _open(path, reader) as r:
        try:
            for n in _read_sizes(mode):
                b = r.read(n)
                assert isinstance(b, bytes)
                assert len(b) <= n
                if not b:
                    break
                out += b
        except (EOFError, OSError, zlib.error) as e:
            err = e
        counts = r.take_counts()
    if err is None:
        return bytes(out), None, None, counts
    return bytes(out), type(err), str(err), counts


def _native(path: str, mode: str = "piece",
            reader: str = "sequential") -> "tuple[bytes, type | None]":
    """The text and the error of reading ``path`` natively, in the read
    sizes ``mode`` names."""
    return _read(path, mode, reader)[:2]


def _gzip(data: bytes) -> "tuple[bytes, type | None]":
    out = bytearray()
    try:
        with gzip.GzipFile(fileobj=io.BytesIO(data)) as g:
            while True:
                b = g.read(PIECE)
                if not b:
                    break
                out += b
    except (EOFError, OSError, zlib.error) as e:
        return bytes(out), type(e)
    return bytes(out), None


def _put(tmp_path, data: bytes, name: str = "in.gz") -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


# ---------------------------------------------------------------- valid


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("mode", ["piece", "odd", "byte"])
@pytest.mark.parametrize("case", VALID_NAMES)
def test_text_equals_gzip(lib, tmp_path, case, mode, reader):
    data, text = _valid_inputs()[case]
    assert gzip.decompress(data) == text
    got, err = _native(_put(tmp_path, data), mode, reader)
    assert err is None
    assert got == text


def test_piece_is_exact_and_bytes(lib, tmp_path):
    """Each read is exactly n bytes until the last, a bytes object, and
    read(-1) returns the rest."""
    data, text = _valid_inputs()["generator"]
    with inflate.open_gzip(_put(tmp_path, data)) as r:
        a = r.read(100_001)
        assert type(a) is bytes and len(a) == 100_001
        rest = r.read()
        assert a + rest == text
        assert r.read(10) == b""


def test_seek_forward_only(lib, tmp_path):
    text = _text()
    path = _put(tmp_path, _valid_inputs()["level6"][0])
    with inflate.open_gzip(path) as r:
        assert r.seek(123_457) == 123_457
        assert r.read(50) == text[123_457:123_507]
        with pytest.raises(io.UnsupportedOperation):
            r.seek(0)
        assert r.seek(10 ** 9) == len(text)
    with pytest.raises(ValueError, match="closed"):
        r.read(1)


def test_open_missing_file_raises_oserror(lib, tmp_path):
    with pytest.raises(FileNotFoundError):
        inflate.open_gzip(str(tmp_path / "nothing.gz"))


# ---------------------------------------------------------------- errors


class Bits:
    """A DEFLATE bit stream written by hand (fields LSB first, Huffman
    codes MSB first)."""

    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, value: int, nbits: int) -> "Bits":
        self.v |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        return self

    def code(self, code: int, nbits: int) -> "Bits":
        return self.put(int(format(code, "0%db" % nbits)[::-1], 2), nbits)

    def bytes(self) -> bytes:
        return self.v.to_bytes((self.n + 7) // 8, "little")


def _wrap(raw: bytes, text: bytes = b"") -> bytes:
    return _framed(raw, text)


def _multi() -> bytes:
    """A valid file of three members, stored blocks in one."""
    return (_member(_text()[:60_000], 6) + _member(_text()[:5000], 0)
            + _member(RUNS[:40_000], 1))


CUTS = ["cut%06d" % c for c in range(1, len(_multi()), 997)]
ERROR_NAMES = ["crc", "isize", "garbage", "garbage_after_padding",
               "one_byte_after", "second_header_cut", "no_trailer", "method",
               "header_cut", "fname_to_end", "block_type", "stored_lengths",
               "too_far", "distance_code", "litlen_code", "too_many", "precode",
               "repeat_first"] + CUTS


@functools.lru_cache(maxsize=None)
def _error_inputs() -> "dict[str, bytes]":
    text = _text()
    good = _member(text[:20_000])
    cases = {}
    b = bytearray(good)
    b[-8] ^= 1
    cases["crc"] = bytes(b)
    b = bytearray(good)
    b[-4] ^= 1
    cases["isize"] = bytes(b)
    cases["garbage"] = good + b"garbage!"
    cases["garbage_after_padding"] = good + b"\0\0\0x"
    cases["one_byte_after"] = good + b"\x1f"
    cases["second_header_cut"] = good + b"\x1f\x8b\x08\0"
    cases["no_trailer"] = good[:-8]
    cases["method"] = good[:2] + b"\x07" + good[3:]
    cases["header_cut"] = b"\x1f\x8b\x08"
    cases["fname_to_end"] = b"\x1f\x8b\x08\x08\0\0\0\0\0\xffreads"
    # BFINAL 1, BTYPE 3
    cases["block_type"] = _wrap(Bits().put(1, 1).put(3, 2).put(0, 5).bytes())
    # a stored block whose LEN and NLEN disagree
    cases["stored_lengths"] = _wrap(Bits().put(1, 1).put(0, 2).put(0, 5).bytes()
                                    + struct.pack("<HH", 5, 5) + b"hello")
    # fixed Huffman: a match (length 3, distance 1) before any byte
    cases["too_far"] = _wrap(Bits().put(1, 1).put(1, 2).code(1, 7).code(0, 5)
                             .code(0, 7).bytes())
    # fixed Huffman: literal 'a', then distance code 30
    cases["distance_code"] = _wrap(Bits().put(1, 1).put(1, 2).code(0x30 + 97, 8)
                                   .code(1, 7).code(30, 5).code(0, 7).bytes())
    # fixed Huffman: length/literal code 286
    cases["litlen_code"] = _wrap(Bits().put(1, 1).put(1, 2)
                                 .code(0xC0 + 286 - 280, 8).bytes())
    # dynamic: HLIT 30 (287 codes)
    cases["too_many"] = _wrap(Bits().put(1, 1).put(2, 2).put(30, 5).put(0, 5)
                              .put(0, 4).put(0, 64).bytes())
    # dynamic: an incomplete precode (one code of length 1)
    pre = Bits().put(1, 1).put(2, 2).put(0, 5).put(0, 5).put(0, 4)
    pre.put(1, 3).put(0, 3 * 3).put(0, 64)
    cases["precode"] = _wrap(pre.bytes())
    # dynamic: a repeat of the previous length before any length
    pre = Bits().put(1, 1).put(2, 2).put(0, 5).put(0, 5).put(0, 4)
    pre.put(1, 3).put(1, 3).put(0, 3).put(0, 3)  # codes 16 and 17, length 1
    pre.code(0, 1).put(0, 2).put(0, 64)          # 16 first
    cases["repeat_first"] = _wrap(pre.bytes())
    # a valid file cut at every 997th byte
    multi = _multi()
    for cut in range(1, len(multi), 997):
        cases["cut%06d" % cut] = multi[:cut]
    assert sorted(cases) == sorted(ERROR_NAMES)
    return cases


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("mode", ["piece", "odd"])
@pytest.mark.parametrize("case", ERROR_NAMES)
def test_error_class_equals_gzip(lib, tmp_path, case, mode, reader):
    data = _error_inputs()[case]
    want, want_err = _gzip(data)
    assert want_err is not None, "gzip reads this input"
    path = _put(tmp_path, data)
    got = _read(path, mode, reader)
    assert got[1] is want_err, (got[1], want_err)
    # what was read before the error is the same text
    n = min(len(got[0]), len(want))
    assert got[0][:n] == want[:n]
    # and the one-thread decoder's bytes, class and message
    assert got[:3] == _read(path, mode)[:3]


@pytest.mark.parametrize("reader", READERS)
def test_error_is_sticky_after_the_text_before_it(lib, tmp_path, reader):
    """Bytes decoded before a bad CRC come first; the error then repeats."""
    with _open(_put(tmp_path, _error_inputs()["crc"]), reader) as r:
        assert r.read(PIECE) == _text()[:20_000]
        for _ in range(2):
            with pytest.raises(gzip.BadGzipFile, match="CRC check failed"):
                r.read(PIECE)


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("seed", range(6))
def test_mutated_members_raise_gzip_class(lib, tmp_path, seed, reader):
    """Members with bytes flipped, dropped or inserted: the same class as
    gzip (or the same text), and no crash; the parallel reader the
    one-thread one's bytes, class and message."""
    rng = random.Random(seed)
    text = _text()[:30_000]
    bases = [_member(text, lv) for lv in (0, 1, 6, 9)] \
        + [_member(text, 6, strategy=zlib.Z_FIXED)]
    path = str(tmp_path / "m.gz")
    for i in range(60):
        data = bytearray(rng.choice(bases))
        for _ in range(rng.randint(1, 4)):
            at = rng.randrange(len(data))
            kind = rng.randrange(3)
            if kind == 0:
                data[at] ^= 1 << rng.randrange(8)
            elif kind == 1:
                del data[at]
            else:
                data.insert(at, rng.randrange(256))
        data = bytes(data)
        want, want_err = _gzip(data)
        with open(path, "wb") as f:
            f.write(data)
        got = _read(path, reader=reader)
        assert got[1] is want_err, (seed, i, got[1], want_err)
        if got[1] is None:
            assert got[0] == want
        if reader == "parallel":
            assert got[:3] == _read(path)[:3], (seed, i)


# ---------------------------------------------------------------- parallel

# 4 workers, 64 KiB chunks over a few MB: chunks of about 200 kB of text
BIG = (4, 1 << 16)


@functools.lru_cache(maxsize=None)
def _big_text() -> bytes:
    """FASTQ text as :func:`_text`'s, ~5 MB."""
    recs = make_records(25_000, min_len=60, max_len=120, seed=7, n_prob=0.01,
                        qual_bins=(2, 12, 23, 37))
    return b"".join(h + b"\n" + s + b"\n+\n" + q + b"\n" for h, s, q in recs)


def _pigz(text: bytes, level: int = 1, piece: int = 128 << 10) -> bytes:
    """pigz's layout: one member of pieces each primed with the 32 KB of
    text before it (a preset dictionary) and ended by a sync flush."""
    body = b""
    for at in range(0, len(text), piece):
        zdict = text[max(0, at - 32768):at]
        co = (zlib.compressobj(level, zlib.DEFLATED, -15, zdict=zdict) if zdict
              else zlib.compressobj(level, zlib.DEFLATED, -15))
        last = at + piece >= len(text)
        body += co.compress(text[at:at + piece]) + co.flush(
            zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)
    return _framed(body, text)


def _parallel(tmp_path, data: bytes, reader=BIG) -> "tuple[bytes, dict]":
    got, err, _, counts = _read(_put(tmp_path, data), reader=reader)
    assert err is None
    return got, counts


@pytest.mark.parametrize("case", ["flush_free", "pigz"])
def test_parallel_unknown_window(lib, tmp_path, case):
    """Chunks of one stream with no flush, and of pigz's primed pieces,
    reach back into the 32 KB before them: those decoded before that
    window is known (at least all but the first that the reader starts
    at its open) leave markers, resolved; the text byte for byte."""
    text = _big_text()
    data = _member(text, 1) if case == "flush_free" else _pigz(text)
    got, counts = _parallel(tmp_path, data)
    assert got == text
    assert counts["inflate-chunks"] > 0
    assert counts["inflate-markers"] > 0
    assert counts["inflate-restarts"] == 0


def test_parallel_independent_pieces(lib, tmp_path):
    """The benchmark generator's pieces, each one deflate block here: a
    chunk starts at a piece's first block (or at the sync flush before it)
    and needs nothing before it, so no marker is left to resolve."""
    data, text = _generator_member(reads=20_000, piece_bases=1 << 12)
    got, counts = _parallel(tmp_path, data)
    assert got == text
    assert counts["inflate-chunks"] > 0
    assert counts["inflate-markers"] == 0
    assert counts["inflate-restarts"] == 0


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_parallel_levels(lib, tmp_path, level):
    """Levels 1, 6 and 9, and stored blocks (level 0: 65,535-byte blocks,
    whose header a stored header a few bits before mimics)."""
    text = _big_text()
    got, counts = _parallel(tmp_path, _member(text, level))
    assert got == text
    assert counts["inflate-chunks"] > 0
    assert counts["inflate-restarts"] == 0
    assert (counts["inflate-markers"] > 0) == (level > 0)


def test_parallel_random(lib, tmp_path):
    """Random bytes at level 6 (stored blocks among Huffman ones)."""
    data = random.Random(9).randbytes(3 << 20)
    got, counts = _parallel(tmp_path, _member(data, 6))
    assert got == data
    assert counts["inflate-chunks"] > 0


def test_parallel_false_headers_restart(lib, tmp_path):
    """A stored stream of deflate data holds true dynamic headers at
    false places: chunks found there do not join up and are decoded again
    by one thread, counted, and the text comes out whole."""
    raw = _raw(_text()) * 4
    got, counts = _parallel(tmp_path, _member(raw, 0), (3, 20_000))
    assert got == raw
    assert counts["inflate-restarts"] > 0
    assert counts["inflate-chunks"] > 0


def _later_chunk_errors() -> "dict[str, bytes]":
    text = _big_text()
    good = _member(text, 1)
    crc, isize = bytearray(good), bytearray(good)
    crc[-8] ^= 1
    isize[-4] ^= 1
    return {"crc": bytes(crc), "isize": bytes(isize),
            "truncated": good[:len(good) * 7 // 10],
            "bad_code": good[:len(good) // 2] + b"\xff" * 64 + good[len(good) // 2 + 64:]}


@pytest.mark.parametrize("case", ["crc", "isize", "truncated", "bad_code"])
def test_parallel_errors_in_a_later_chunk(lib, tmp_path, case):
    """A CRC or ISIZE mismatch, a truncation and bad data inside a chunk
    past the first: gzip's class after the same text, and the one-thread
    decoder's bytes, class and message."""
    data = _later_chunk_errors()[case]
    want, want_err = _gzip(data)
    path = _put(tmp_path, data)
    got = _read(path, "odd", BIG)
    assert got[1] is want_err and want_err is not None
    n = min(len(got[0]), len(want))
    assert got[0][:n] == want[:n]
    assert got[:3] == _read(path, "odd")[:3]
    assert got[3]["inflate-chunks"] > 0


def test_parallel_two_members(lib, tmp_path):
    """The first member in chunks, the second by one thread."""
    text = _big_text()
    half = len(text) // 2
    got, counts = _parallel(tmp_path, _member(text[:half], 1) + _member(text[half:], 6))
    assert got == text
    assert counts["inflate-chunks"] > 0


def test_crc32_combine(lib):
    """The CRC of A then B from theirs and B's length, as zlib.crc32."""
    lib.hpgq_crc32_combine.restype = ctypes.c_uint32
    lib.hpgq_crc32_combine.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                       ctypes.c_int64]
    rng = random.Random(3)
    for n in (0, 1, 7, 4096, 1 << 20, 3_000_001):
        a, b = rng.randbytes(rng.randrange(100)), rng.randbytes(n)
        assert lib.hpgq_crc32_combine(zlib.crc32(a), zlib.crc32(b), n) == zlib.crc32(a + b)


@pytest.mark.parametrize("size,cores,ranks,want", [
    (8 << 20, 8, None, 4), ((8 << 20) - 1, 8, None, 0), (8 << 20, 3, None, 0),
    (8 << 20, 4, None, 2), (8 << 20, 8, "4", 0), (8 << 20, 16, "2", 4),
    (8 << 20, 32, "x", 16)])
def test_workers_rule(tmp_path, monkeypatch, size, cores, ranks, want):
    """Two chunks and four usable cores (the process's share of the host's
    among its local ranks) engage the parallel reader, with half of them:
    the plan's gzip pool."""
    path = tmp_path / "f.gz"
    with open(path, "wb") as f:
        f.truncate(size)
    monkeypatch.setattr(inflate.os, "sched_getaffinity", lambda pid: set(range(cores)))
    if ranks is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", ranks)
    assert inflate._workers(str(path)) == want


# ---------------------------------------------------------------- reader


def _blocks(path, batch_size=500, **kw):
    with FastqReader(path, batch_size=batch_size, **kw) as rd:
        return [(b.base_offset, b.end_offset, b.num_reads,
                 b.starts.tolist(), b.ends.tolist(),
                 bytes(b.buf[b.starts[0, 0]:b.end_offset - b.base_offset]))
                for b in rd]


def test_reader_blocks_equal_plain(lib, tmp_path, monkeypatch):
    """The reader over a gzip file gives a plain file's blocks (offsets,
    end offsets, records), in chunks that cross the decoder's calls, from
    the start and from a resume offset; its file is the native reader."""
    monkeypatch.setattr(fastq, "_CHUNK", 40_000)
    data, text = _valid_inputs()["generator"]
    plain = _put(tmp_path, text, "r.fq")
    gz = _put(tmp_path, data, "r.fq.gz")
    want = _blocks(plain)
    assert _blocks(gz) == want
    with FastqReader(gz, batch_size=500) as rd:
        assert isinstance(rd._fh, ReadaheadFile)
        assert isinstance(rd._fh._fh, inflate.GzipReader)
    resume = want[3][0]
    assert _blocks(gz, start_offset=resume) == _blocks(plain, start_offset=resume)


def test_reader_blocks_equal_plain_parallel(lib, tmp_path, monkeypatch):
    """As above with the parallel reader (engaged as a large file on enough
    cores engages it): the same blocks, from the start and from a resume
    offset, counted by the stage timers."""
    monkeypatch.setattr(fastq, "_CHUNK", 40_000)
    monkeypatch.setattr(inflate, "_workers", lambda path: 3)
    monkeypatch.setattr(inflate, "CHUNK_BYTES", 4096)
    text = _generator_member(reads=4000)[1]
    data = _member(text, 1)  # one stream: chunks with markers to resolve
    plain = _put(tmp_path, text, "r.fq")
    gz = _put(tmp_path, data, "r.fq.gz")
    want = _blocks(plain)
    t = StageTimers()
    assert _blocks(gz, timers=t) == want
    with FastqReader(gz, batch_size=500) as rd:
        assert rd._fh._fh.parallel
    resume = want[3][0]
    assert _blocks(gz, start_offset=resume) == _blocks(plain, start_offset=resume)
    assert t.counts["inflate-native-bytes"] == len(text)
    assert set(t.counts) == {"inflate-native-bytes", "team-short",
                             *inflate.COUNTS}
    assert t.counts["team-short"] == 0
    assert t.counts["inflate-chunks"] > 0 and t.counts["inflate-markers"] > 0
    assert t.counts["inflate-restarts"] == 0


@pytest.mark.parametrize("chunk", [150, 40_000])
@pytest.mark.parametrize("crlf", [False, True], ids=["lf", "crlf"])
def test_reader_blocks_joined(lib, tmp_path, monkeypatch, chunk, crlf):
    """The partial record each piece carries is joined to the next piece
    (natively), over several pieces where a record is longer than one:
    the blocks of a plain file."""
    monkeypatch.setattr(fastq, "_CHUNK", chunk)
    text = _generator_member(reads=2500)[1]
    if crlf:
        text = text.replace(b"\n", b"\r\n")
    plain = _put(tmp_path, text, "r.fq")
    gz = _put(tmp_path, _member(text, 1), "r.fq.gz")
    want = _blocks(plain)
    assert _blocks(gz) == want and len(want) > 10


def test_counts_native_bytes(lib, tmp_path):
    """The stage timers count the text the native decoder inflated, and no
    zlib bytes, beside the index's short teams (none); --t's report prints
    the count."""
    data, text = _valid_inputs()["generator"]
    t = StageTimers()
    with FastqReader(_put(tmp_path, data), batch_size=500, timers=t) as rd:
        assert sum(b.num_reads for b in rd) == 1200
    assert t.counts == {"inflate-native-bytes": len(text), "team-short": 0}
    assert t.totals["inflate"] > 0
    out = io.StringIO()
    t.report(out)
    assert "count inflate-native-bytes" in out.getvalue()
    merged = StageTimers()
    merged.merge_from(t)
    merged.merge_from(t)
    assert merged.counts == {"inflate-native-bytes": 2 * len(text),
                             "team-short": 0}


def test_counts_zlib_bytes_without_native(lib, tmp_path):
    """With HPGQ_NO_NATIVE the reader falls back to gzip, and the counts
    are the other way round."""
    data, text = _valid_inputs()["generator"]
    path = _put(tmp_path, data, "r.fq.gz")
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from hpgq_torch.io.fastq import FastqReader\n"
        "from hpgq_torch.utils.timers import StageTimers\n"
        "t = StageTimers()\n"
        "with FastqReader(%r, timers=t) as rd:\n"
        "    print(type(rd._fh._fh).__name__, sum(b.num_reads for b in rd))\n"
        "print(t.counts)\n" % (ROOT, path))
    env = dict(os.environ, HPGQ_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    kind, counts = r.stdout.splitlines()
    assert kind.split()[0] == "GzipFile"
    assert int(kind.split()[1]) == 1200
    assert eval(counts) == {"inflate-zlib-bytes": len(text)}


# ---------------------------------------------------------------- sanitizer

_CHECKER = r"""
#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" {
void* hpgq_gz_open(const char*);
int64_t hpgq_gz_read(void*, uint8_t*, int64_t);
void hpgq_gz_close(void*);
void* hpgq_pgz_open(const char*, int, int64_t);
int64_t hpgq_pgz_read(void*, uint8_t*, int64_t);
void hpgq_pgz_close(void*);
uint32_t hpgq_crc32(uint32_t, const uint8_t*, int64_t);
}

// argv: corpus (records of a little-endian u32 length and the bytes), a
// scratch path, and "parallel" for the parallel reader (3 workers, 4 KiB
// chunks).  Prints, a line per record: the error class (0: none), the
// bytes read and their CRC-32.
int main(int argc, char** argv) {
    const bool par = argc > 3;
    FILE* f = fopen(argv[1], "rb");
    const int64_t sizes[5] = {333, 1, 4099, 65536, 1 << 20};
    std::vector<uint8_t> rec;
    for (;;) {
        uint32_t n;
        if (fread(&n, 4, 1, f) != 1) break;
        rec.resize(n);
        if (n && fread(rec.data(), 1, n, f) != n) return 2;
        FILE* g = fopen(argv[2], "wb");
        if (n) fwrite(rec.data(), 1, n, g);
        fclose(g);
        void* h = par ? hpgq_pgz_open(argv[2], 3, 4096) : hpgq_gz_open(argv[2]);
        if (!h) return 3;
        int64_t total = 0, k, cls = 0;
        uint32_t crc = 0;
        for (int i = 0;; ++i) {
            std::vector<uint8_t> out(sizes[i % 5]);  // exact: ASan sees overruns
            k = par ? hpgq_pgz_read(h, out.data(), sizes[i % 5])
                    : hpgq_gz_read(h, out.data(), sizes[i % 5]);
            if (k <= 0) {
                cls = -k;
                break;
            }
            crc = hpgq_crc32(crc, out.data(), k);
            total += k;
        }
        if (par)
            hpgq_pgz_close(h);
        else
            hpgq_gz_close(h);
        printf("%lld %lld %u\n", (long long)cls, (long long)total, crc);
    }
    printf("sanitize-ok\n");
    return 0;
}
"""

_CLASSES = {0: None, 1: EOFError, 2: gzip.BadGzipFile, 3: zlib.error}


@pytest.mark.skipif(not os.environ.get("HPGQ_SANITIZE"),
                    reason="set HPGQ_SANITIZE=1 to run the ASan/UBSan "
                           "native-inflate check")
@pytest.mark.parametrize("entry", READERS)
@pytest.mark.parametrize("arch", ["native", "portable"])
def test_asan_ubsan_inflate(tmp_path, arch, entry):
    """Every input above and 3000 mutated members through an ASan/UBSan
    build (PCLMULQDQ CRC with -march=native, the table CRC without), by
    the one-thread reader or the parallel one on three workers: no
    sanitizer report, and gzip's class and text on each."""
    rng = random.Random(11)
    corpus = [d for d, _ in _valid_inputs().values()] + list(_error_inputs().values())
    if entry == "parallel":
        corpus += [_member(_big_text()[:1 << 20], 1), _pigz(_big_text()[:1 << 20]),
                   _member(_raw(_text()) * 2, 0)] + list(_later_chunk_errors().values())
    bases = [_member(_text()[:20_000], lv) for lv in (0, 1, 6, 9)] \
        + [_member(RUNS[:20_000], 1), _member(RANDOM[:5000], 6)]
    for _ in range(3000):
        data = bytearray(rng.choice(bases))
        for _ in range(rng.randint(1, 6)):
            at = rng.randrange(len(data))
            data[at] = rng.randrange(256)
        corpus.append(bytes(data))
    with open(tmp_path / "corpus", "wb") as f:
        for data in corpus:
            f.write(struct.pack("<I", len(data)) + data)
    main_cpp = tmp_path / "main.cpp"
    main_cpp.write_text(_CHECKER)
    exe = str(tmp_path / "checker")
    src = os.path.join(ROOT, "hpgq_torch", "io", "native", "inflate.cpp")
    flags = ["-march=native"] if arch == "native" else []
    subprocess.run(["g++", "-O1", "-g", "-std=c++17", *flags,
                    "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
                    "-fno-omit-frame-pointer", src, str(main_cpp), "-o", exe,
                    "-pthread"],
                   check=True, capture_output=True, timeout=300)
    r = subprocess.run([exe, str(tmp_path / "corpus"), str(tmp_path / "one.gz")]
                       + (["parallel"] if entry == "parallel" else []),
                       capture_output=True, timeout=1200,
                       env={**os.environ, "ASAN_OPTIONS": "detect_leaks=1"})
    assert r.returncode == 0, r.stderr.decode()[-4000:]
    assert b"runtime error" not in r.stderr
    lines = r.stdout.decode().splitlines()
    assert lines[-1] == "sanitize-ok"
    for data, line in zip(corpus, lines):
        cls, total, crc = map(int, line.split())
        want, want_err = _gzip(data)
        assert _CLASSES[cls] is want_err
        if want_err is None:
            assert (total, crc) == (len(want), zlib.crc32(want))
