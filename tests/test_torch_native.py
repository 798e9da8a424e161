"""``tests/test_native.py``'s cases on the port's own copies: its native
C++ packer (``hpgq_torch.io.native``) against its numpy fallback
(``hpgq_torch.io.packer``), byte for byte, and the reader on either.  The
``pack_block_fused`` cases stay out (the fused4 wire is not ported).  The
qn8 decode is the port's ``kernels/wire_torch.wire_unqn8``, held against
``hpgq``'s ``stats_jnp.wire_unqn8`` on the same buffer and against the
packed arrays.
"""

import os

import numpy as np
import pytest

from gen import make_fastq

from hpgq_torch.io import native
from hpgq_torch.io.fastq import FastqReader
from hpgq_torch.io.packer import pack_block

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native packer not built (no g++?)"
)


def _np_pack(block, max_len=0, pad_reads_to=0):
    """Force the numpy path regardless of native availability."""
    import hpgq_torch.io.native as n

    saved = n.available
    n.available = lambda: False
    try:
        return pack_block(block, max_len=max_len, pad_reads_to=pad_reads_to)
    finally:
        n.available = saved


def test_find_newlines_matches_numpy():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=100_000, dtype=np.uint8)
    buf = data.tobytes()
    got = native.find_newlines(buf)
    want = np.flatnonzero(data == 0x0A)
    np.testing.assert_array_equal(got, want)
    assert native.find_newlines(b"").shape == (0,)
    assert list(native.find_newlines(b"\n\n")) == [0, 1]


@pytest.mark.parametrize("varlen", [False, True])
def test_pack_block_matches_numpy(tmp_path, varlen):
    path = tmp_path / "r.fq"
    kw = dict(min_len=40, max_len=150) if varlen else dict(min_len=90, max_len=90)
    make_fastq(str(path), 3000, n_prob=0.01, lowercase_prob=0.1, seed=4, **kw)
    with FastqReader(str(path), batch_size=1024) as rd:
        for block in rd:
            for ml, pr in ((0, 0), (256, 4096)):
                a = pack_block(block, max_len=ml, pad_reads_to=pr)
                b = _np_pack(block, max_len=ml, pad_reads_to=pr)
                for x, y, name in zip(a, b, ("codes", "quals", "lens", "valid")):
                    np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("varlen", [False, True])
def test_pack_block_bitwire_matches_numpy(tmp_path, varlen):
    """Native single-pass bitpack wire == numpy pack + wire_bitpack_np
    (byte-exact): 3-bit codes, 7-bit quals, len/valid tail, row padding."""
    from hpgq_torch.io.packer import pack_block_bitwire, wire_bitpack_np

    path = tmp_path / "r.fq"
    kw = dict(min_len=41, max_len=151) if varlen else dict(min_len=90, max_len=90)
    make_fastq(str(path), 3000, n_prob=0.01, lowercase_prob=0.1, seed=6, **kw)
    with FastqReader(str(path), batch_size=1024) as rd:
        for block in rd:
            for L, pr in ((256, 0), (256, 4096), (128, 2048)):
                got = pack_block_bitwire(block, L, pad_reads_to=pr)
                want = wire_bitpack_np(*_np_pack(block, max_len=L, pad_reads_to=pr))
                np.testing.assert_array_equal(got, want)


def test_pack_bitwire2q_edge_quals(tmp_path):
    """2q palette packer edge cases vs the numpy oracle: qual values >= 64
    (the discovery bitmap's second word — the binned corpora used
    elsewhere stay below 64 and never exercise it), exactly-4-distinct
    palettes spanning the 63/64 boundary, single-value rows, zero-length
    reads, and rows longer than the wire width (truncation)."""
    from hpgq_torch.io.native import pack_bitwire2q
    from hpgq_torch.io.packer import wire_bitpack2q_np

    rows = [
        # (seq, quals as phred values)
        (b"ACGTN" * 8, [0, 63, 64, 93] * 10),       # spans both words
        (b"ACGT" * 10, [64] * 40),                  # single value >= 64
        (b"GGGG" * 25, [93] * 100),                 # max legal qual
        (b"", []),                                  # zero-length read
        (b"ACGT" * 50, [2, 12, 23, 37] * 50),       # longer than L=128
        (b"TTTT", [0, 0, 0, 0]),                    # min qual only
    ]
    path = tmp_path / "edge.fq"
    with open(path, "wb") as f:
        for i, (seq, qv) in enumerate(rows):
            q = bytes(33 + v for v in qv)
            f.write(b"@e%d\n%s\n+\n%s\n" % (i, seq, q))
    with FastqReader(str(path), batch_size=64) as rd:
        block = next(iter(rd))
    for L, pr in ((128, 0), (128, 64)):
        got = pack_bitwire2q(block.arr, block.starts[:, 1],
                             block.starts[:, 3], block.seq_lens, L,
                             max(pr, block.num_reads))
        want = wire_bitpack2q_np(
            *_np_pack(block, max_len=L, pad_reads_to=max(pr, block.num_reads)))
        assert got is not None and want is not None
        np.testing.assert_array_equal(got, want)

    # a 5-distinct row must misfit in both implementations
    with open(path, "ab") as f:
        q = bytes(33 + v for v in (0, 20, 40, 60, 80) * 8)
        f.write(b"@e9\n%s\n+\n%s\n" % (b"ACGT" * 10, q))
    with FastqReader(str(path), batch_size=64) as rd:
        block = next(iter(rd))
    got = pack_bitwire2q(block.arr, block.starts[:, 1], block.starts[:, 3],
                         block.seq_lens, 128, block.num_reads)
    want = wire_bitpack2q_np(*_np_pack(block, max_len=128))
    assert got is None and want is None


def test_reader_native_vs_numpy(tmp_path):
    path = tmp_path / "big.fq"
    make_fastq(str(path), 5000, min_len=60, max_len=200, seed=8)
    with FastqReader(str(path), batch_size=999) as rd:
        native_blocks = [
            (b.buf, b.starts.copy(), b.ends.copy()) for b in rd
        ]
    os.environ["HPGQ_NO_NATIVE"] = "1"
    try:
        import hpgq_torch.io.native as n

        saved = n.available
        n.available = lambda: False
        try:
            with FastqReader(str(path), batch_size=999) as rd:
                np_blocks = [(b.buf, b.starts.copy(), b.ends.copy()) for b in rd]
        finally:
            n.available = saved
    finally:
        del os.environ["HPGQ_NO_NATIVE"]
    assert len(native_blocks) == len(np_blocks)
    for (b1, s1, e1), (b2, s2, e2) in zip(native_blocks, np_blocks):
        assert b1 == b2
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(e1, e2)


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_find_newlines_mt_paths(threads):
    """The scan of >=2MB buffers (one pass on one thread, else counted and
    filled by segments) matches numpy, including the capacity-retry path,
    pathological all-newline input and a length no multiple of 32."""
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, size=(3 << 21) + 13, dtype=np.uint8)
    got = native.find_newlines(big, threads)
    want = np.flatnonzero(big == 0x0A)
    np.testing.assert_array_equal(got, want)

    dense = np.full(1 << 22, 0x0A, dtype=np.uint8)  # every byte a newline
    got = native.find_newlines(dense, threads)
    assert got.shape[0] == dense.shape[0]
    np.testing.assert_array_equal(got, np.arange(dense.shape[0]))


@pytest.mark.parametrize("varlen", [False, True])
def test_pack_block_qnwire_matches_numpy(tmp_path, varlen):
    """Native single-pass qn8 wire == numpy pack + wire_qn8_np (byte-exact):
    qual|isN<<7 bytes, len/valid tail, row padding."""
    from hpgq_torch.io.packer import pack_block_qnwire, wire_qn8_np

    path = tmp_path / "r.fq"
    kw = dict(min_len=41, max_len=151) if varlen else dict(min_len=90, max_len=90)
    make_fastq(str(path), 3000, n_prob=0.03, lowercase_prob=0.1, seed=9, **kw)
    with FastqReader(str(path), batch_size=1024) as rd:
        for block in rd:
            for L, pr in ((256, 0), (256, 4096), (128, 2048)):
                got = pack_block_qnwire(block, L, pad_reads_to=pr)
                want = wire_qn8_np(*_np_pack(block, max_len=L, pad_reads_to=pr))
                np.testing.assert_array_equal(got, want)


def test_wire_unqn8_roundtrip(tmp_path):
    """qn8 wire decode recovers quals/lens/valid and an is-N codes tensor
    that agrees with the packed codes' N positions."""
    import torch

    from hpgq.kernels.stats_jnp import wire_unqn8 as jnp_unqn8
    from hpgq_torch.io.packer import pack_block, pack_block_qnwire
    from hpgq_torch.kernels.wire_torch import wire_unqn8

    path = tmp_path / "r.fq"
    make_fastq(str(path), 700, min_len=30, max_len=140, n_prob=0.05, seed=10)
    with FastqReader(str(path), batch_size=512) as rd:
        for block in rd:
            buf = pack_block_qnwire(block, 256, pad_reads_to=1024)
            codes, quals, lens, valid = pack_block(block, max_len=256,
                                                   pad_reads_to=1024)
            dc, dq, dl, dv = (x.numpy() for x in
                              wire_unqn8(torch.from_numpy(buf)))
            for got, want in zip((dc, dq, dl, dv), jnp_unqn8(buf)):
                np.testing.assert_array_equal(got, np.asarray(want))
            np.testing.assert_array_equal(dl, np.where(valid, lens, 0))
            np.testing.assert_array_equal(dv, valid)
            # quals match inside each read's length
            pos = np.arange(256)[None, :]
            mask = (pos < dl[:, None])
            np.testing.assert_array_equal(
                np.where(mask, dq, 0), np.where(mask, quals & 0x7F, 0))
            np.testing.assert_array_equal(
                np.where(mask, dc, 0), np.where(mask, (codes == 4) * 4, 0))


# ------------------------------------------- the one loader of g++ libraries

def _library(name):
    """(module, ABI symbol, a run of the library's caller) of the packer,
    the gzip decoder or the report's row formatter.  The run gives what
    the caller gives, and whether it took the native library."""
    import gzip

    from hpgq_torch.io.fastq import open_maybe_gzip
    from hpgq_torch.io.native import inflate
    from hpgq_torch.report import rows

    def pack(tmp):
        path = str(tmp / "r.fq")
        make_fastq(path, 300, min_len=40, max_len=150, n_prob=0.01, seed=3)
        with FastqReader(path, batch_size=128) as rd:
            packed = [pack_block(b) for b in rd]
        return [a.tobytes() for p in packed for a in p], native.available()

    def read_gzip(tmp):
        path = str(tmp / "r.fq.gz")
        with gzip.open(path, "wb") as f:
            f.write(b"@r\nACGT\n+\nIIII\n" * 5000)
        with open_maybe_gzip(path) as f:
            return f.read(), not isinstance(f, gzip.GzipFile)

    def format_rows(tmp):
        path = str(tmp / "rows.txt")
        cols = (np.arange(2000), np.arange(2000) % 94 + 33,
                np.linspace(0, 41, 2000))
        with open(path, "w") as f:
            rows.write_rows(f, "%i\t%c\t%0.2f\n", *cols)
        with open(path) as f:
            text = f.read()
        assert text == rows.format_rows_py("%i\t%c\t%0.2f\n", *cols)
        return text, rows.get_lib() is not None

    return {"packer": (native, "hpgq_abi_version", pack),
            "inflate": (inflate, "hpgq_inflate_abi_version", read_gzip),
            "rows": (rows, "hpgq_rows_abi_version", format_rows)}[name]


@pytest.mark.parametrize("case", ["HPGQ_NO_NATIVE", "wrong ABI",
                                  "build fails"])
@pytest.mark.parametrize("name", ["packer", "inflate", "rows"])
def test_loader(tmp_path, monkeypatch, caplog, name, case):
    """``native.load`` behind each library's ``get_lib``, with the build
    directory moved under the test's: ``HPGQ_NO_NATIVE`` gives None and
    builds nothing; a library whose ABI version is wrong is rebuilt once
    and then loads (though the stale one stays loaded under its name); a
    build that fails gives None, logs why, and the caller's fallback gives
    the native library's result.  Each is decided once."""
    import logging
    import shutil
    import subprocess

    mod, symbol, run = _library(name)
    real = mod.get_lib()
    want, took_native = run(tmp_path)
    assert real is not None and took_native
    so_name = os.path.basename(real._name)
    build = tmp_path / "_build"
    built = []
    real_build = native._build

    def copy_real(src, so):  # the rebuild, without g++: the real library
        built.append(so)
        shutil.copy(real._name, so + ".part")
        os.replace(so + ".part", so)  # a new inode, as the real build gives
        return so

    def fail(src, so):
        built.append(so)
        raise subprocess.CalledProcessError(1, ["g++"])

    if case == "wrong ABI":
        stub = tmp_path / "stub.cpp"
        stub.write_text('extern "C" int %s(void) { return %d; }\n'
                        % (symbol, mod._ABI + 1))
        real_build(str(stub), str(build / so_name))
    monkeypatch.setattr(native, "_BUILD", str(build))
    if case == "HPGQ_NO_NATIVE":
        monkeypatch.setenv("HPGQ_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_build",
                        copy_real if case == "wrong ABI" else fail)
    caplog.set_level(logging.INFO, logger=native.__name__)

    lib = mod.get_lib()
    assert mod.get_lib() is lib
    got, took_native = run(tmp_path)
    assert got == want
    if case == "wrong ABI":
        assert lib is not None and took_native
        assert getattr(lib, symbol)() == mod._ABI
        assert built == [str(build / so_name)]
    else:
        assert lib is None and not took_native
        assert built == ([] if case == "HPGQ_NO_NATIVE"
                         else [str(build / so_name)])
        logged = "native %s unavailable" % {
            "packer": "packer", "inflate": "inflate",
            "rows": "report rows"}[name]
        assert (logged in caplog.text) == (case == "build fails")


# The packers under a runtime that grants fewer threads than asked: each
# native packer run in a subprocess under OMP_THREAD_LIMIT=2, asked for 8
# threads and for 1, on reads with padded rows (n < nrows) and many N and
# other bases (exceptions of the 2u and 2c wires).
_SHORT_TEAM = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from hpgq_torch.io import native

rng = np.random.default_rng(20)
n, L = 3000, 96
lib = native.get_lib()
assert lib is not None


def reads(kind):
    quals = {"2u": b"#-8F", "2c": b"#-8F", "2q": b"#-8F",
             "6bit": bytes(range(40, 100)), "ragged": bytes(range(40, 100)),
             "7bit": bytes(range(33, 127)),
             "plain": bytes(range(33, 127)), "qn": bytes(range(33, 127))}[kind]
    lens = (np.full(n, L) if kind == "2u" else rng.integers(1, L + 1, n))
    buf, seq_starts, q_starts = bytearray(), [], []
    for ln in lens:
        seq = rng.choice(np.frombuffer(b"ACGT" * 16 + b"NX", np.uint8), ln)
        seq_starts.append(len(buf))
        buf += seq.tobytes()
        q_starts.append(len(buf))
        pal = rng.choice(np.frombuffer(quals, np.uint8), 4, replace=False)
        buf += rng.choice(pal if kind in ("2c", "2q") else
                          np.frombuffer(quals, np.uint8), ln).tobytes()
    return (np.frombuffer(bytes(buf), np.uint8), np.array(seq_starts),
            np.array(q_starts), lens.astype(np.int32))


kind = sys.argv[2]
fn = {"2u": native.pack_bitwire2u, "2c": native.pack_bitwire2c,
      "2q": native.pack_bitwire2q, "6bit": native.pack_bitwire6,
      "7bit": native.pack_bitwire, "plain": native.pack_rows,
      "qn": native.pack_qnwire,
      "ragged": lambda b, s, q, lens, L, nrows, num_threads:
          native.pack_ragged6(b, s, q, lens, num_threads=num_threads)}[kind]
args = reads(kind) + (L, n + 700)
one = fn(*args, num_threads=1)
assert lib.hpgq_team_short() == 0
eight = fn(*args, num_threads=8)
short = lib.hpgq_team_short()
out = {}
for name, got in (("one", one), ("eight", eight)):
    assert got is not None, (kind, name)
    parts = got if isinstance(got, tuple) else (got,)
    for i, a in enumerate(parts):
        out["%s%d" % (name, i)] = np.asarray(a)
np.savez(sys.argv[3], short=short, **out)
"""


@pytest.mark.parametrize("kind", ["2u", "2c", "2q", "6bit", "7bit", "plain",
                                  "qn", "ragged"])
def test_packer_short_team(tmp_path, kind):
    """Asked for 8 threads where the runtime grants 2, every native packer
    gives its 1-thread buffers and exception list, byte for byte, and counts
    the short team (``team-short``)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "out.npz")
    env = dict(os.environ, OMP_THREAD_LIMIT="2")
    r = subprocess.run([sys.executable, "-c", _SHORT_TEAM, root, kind, out],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    with np.load(out) as z:
        assert int(z["short"]) >= 1
        ones = sorted(k for k in z.files if k.startswith("one"))
        assert ones and len(ones) == len(z.files) // 2
        for k in ones:
            np.testing.assert_array_equal(z["eight" + k[3:]], z[k], err_msg=k)


_RECORDS = {
    "lf": b"@r0\nACGT\n+\nIIII\n@r1\nAC\n+\nII\n",
    "crlf": b"@r0\r\nACGT\r\n+\r\nIIII\r\n@r1\r\nAC\r\n+r1\r\nII\r\n",
    "mixed": b"@r0\r\nACGT\n+\r\nIIII\n@r1\n\r\n+\n\n@\n\n+\n\n",
    "cr_in_seq": b"@r0\nAC\rGT\n+\nIIIII\n@r1\nA\r\r\n+\nII\r\n",
    "qual_short": b"@r0\nACGT\n+\nIIII\n@r1\nACGTACGT\n+\nIII\n",
    "bad_header": b"@r0\nACGT\n+\nIIII\nr1\nACGT\n+\nIIII\n",
    "bad_sep": b"@r0\r\nACGT\r\n+\r\nIIII\r\n@r1\r\nACGT\r\n-\r\nIIII\r\n",
    "first_empty": b"\nACGT\n+\nIIII\n",
}


@pytest.mark.parametrize("name", sorted(_RECORDS))
def test_record_table_matches_numpy(name):
    """The native record table (line tables, '\\r' before a newline
    dropped, the first desynced record) equals the numpy fallback's."""
    from hpgq_torch.io import fastq

    data = _RECORDS[name]
    nl = native.find_newlines(data).copy()
    nrec = len(nl) // 4
    starts, ends, bad = native.record_table(data, nl, nrec)
    want_s, want_e = fastq._index_lines(data, nl, nrec)
    want_bad = fastq._first_bad(data, want_s, want_e)
    np.testing.assert_array_equal(starts, want_s)
    np.testing.assert_array_equal(ends, want_e)
    assert bad == want_bad
    assert (bad >= 0) == (name in ("qual_short", "bad_header", "bad_sep",
                                   "first_empty"))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("sizes", [(0, 5), (7, 0), (300, 3 << 20)])
def test_join(threads, sizes):
    """The reader's tail joined to the next chunk by native copies is
    ``head + tail``, a new bytes object."""
    rng = np.random.default_rng(sum(sizes))
    head, tail = (rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                  for n in sizes)
    got = native.join(head, tail, threads)
    assert isinstance(got, bytes) and got == head + tail


@pytest.mark.parametrize("length", [1, 3, 4, 6, 37, 100, 101])
def test_pack_2u_matches_numpy(tmp_path, length):
    """The native 2u wire (four bases a byte, a group with an N or other
    base on the exception path, the read's last partial group and the
    pad) equals the numpy fallback's buffer, exceptions and palette, and
    ``hpgq``'s packer's on the same blocks, byte for byte."""
    import hpgq.io.fastq as h_fastq
    import hpgq.io.packer as h_packer
    from hpgq_torch.io.packer import try_pack_block_2u

    path = tmp_path / "r.fq"
    make_fastq(str(path), 2000, min_len=length, max_len=length, n_prob=0.05,
               seed=length, qual_bins=(2, 12, 23, 37))
    with FastqReader(str(path), batch_size=700) as rd, \
            h_fastq.FastqReader(str(path), batch_size=700) as hd:
        for block, hblock in zip(rd, hd):
            got = try_pack_block_2u(block, pad_reads_to=1024)
            saved = native.available
            native.available = lambda: False
            try:
                want = try_pack_block_2u(block, pad_reads_to=1024)
            finally:
                native.available = saved
            ref = h_packer.try_pack_block_2u(hblock, pad_reads_to=1024)
            assert got is not None and want is not None and ref is not None
            for g, w, r in zip(got, want, ref):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
                g, r = np.asarray(g), np.asarray(r)
                assert g.dtype == r.dtype and g.shape == r.shape
                assert g.tobytes() == r.tobytes()


# (lengths, bases, quality values) of the reads of each ragged-wire case
_RAGGED = {
    "1": ([1], b"ACGT", range(0, 41)),
    "7": ([7], b"ACGT", range(0, 41)),
    "8": ([8], b"ACGT", range(0, 41)),
    "9": ([9], b"ACGT", range(0, 41)),
    "1001": ([1001], b"ACGT", range(0, 41)),
    "126106": ([126106], b"ACGT" * 60 + b"N", range(0, 41)),
    "mixed lengths": ([40, 0, 4099, 33, 126106 // 8, 1, 96, 515, 8, 7],
                      b"ACGT" * 30 + b"N", range(2, 60)),
    "N and lowercase": ([5000, 999, 64, 31], b"ACGT" * 40 + b"Nacgtn",
                        range(0, 41)),
    "N and lowercase, strict": ([5000, 999, 64, 31], b"ACGT" * 40 + b"Nacgtn",
                                range(0, 41)),
    "other bytes": ([3000, 77], bytes(range(33, 127)) + b"ACGT" * 300,
                    range(0, 41)),
    "range 63": ([700, 300], b"ACGT", range(30, 94)),
    "range 64": ([700, 300], b"ACGT", range(30, 95)),
}


def _ragged_block(tmp_path, case):
    """A RecordBlock of the case's reads, each a stretch of 32 bases from
    one of the case's bases (so the vector path sees whole steps of ACGT
    and steps with others) and qualities drawn from its range, both ends
    of the range in every read of 2 bases or more."""
    lens, bases, qrange = _RAGGED[case]
    rng = np.random.default_rng(len(case))
    alphabet = np.frombuffer(bases, np.uint8)
    qv = np.array(list(qrange))
    path = tmp_path / "ragged.fq"
    with open(path, "wb") as f:
        for i, n in enumerate(lens):
            fast = rng.random(-(-n // 32)) < 0.5
            seq = np.where(np.repeat(fast, 32)[:n],
                           rng.choice(np.frombuffer(b"ACGT", np.uint8), n),
                           rng.choice(alphabet, n))
            q = rng.choice(qv, n)
            if n >= 2:
                q[rng.choice(n, 2, replace=False)] = qv[[0, -1]]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq.astype(np.uint8).tobytes(),
                                             (q + 33).astype(np.uint8).tobytes()))
    with FastqReader(str(path), batch_size=64) as rd:
        return next(iter(rd))


@pytest.mark.parametrize("simd", [True, False], ids=["avx2", "groups"])
@pytest.mark.parametrize("case", sorted(_RAGGED))
def test_pack_ragged6_matches_numpy(tmp_path, monkeypatch, case, simd):
    """The native ragged 6-bit wire (its vector path where the CPU has
    AVX2, and its path by whole groups) equals the numpy reference's
    bytes, table and rows, on reads of 1, 7, 8, 9 and up to 126,106
    bases, with N, lowercase under either case rule, and bytes that are no
    base; both give None on a read whose qualities span 64 values; and the
    twin decode gives back ``pack_block``'s rows, longest first."""
    import torch

    from hpgq_torch.constants import BASE_OTHER
    from hpgq_torch.io import packer
    from hpgq_torch.io.fastq import RecordBlock
    from hpgq_torch.io.packer import BASE_LUT, wire_ragged6_np
    from hpgq_torch.kernels.wire_torch import wire_unragged

    block = _ragged_block(tmp_path, case)
    lut = BASE_LUT.copy()
    if case.endswith("strict"):  # as HPGQ_STRICT_CASE=1 makes it
        lut[np.frombuffer(b"acgtn", np.uint8)] = BASE_OTHER
    order = np.argsort(-block.seq_lens, kind="stable")
    args = (block.arr, block.starts[order, 1], block.starts[order, 3],
            block.seq_lens[order])
    got = native.pack_ragged6(*args, lut=lut, simd=simd)
    want = wire_ragged6_np(*args, lut=lut)
    if case == "range 64":
        assert got is None and want is None
        return
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    R, L = block.num_reads, int(block.seq_lens.max())
    codes, quals, lens, valid = (t.numpy() for t in wire_unragged(
        torch.from_numpy(got), R, L))
    sorted_block = RecordBlock(block.buf, block.starts[order],
                               block.ends[order], block.base_offset)
    monkeypatch.setattr(packer, "BASE_LUT", lut)
    w_codes, w_quals, w_lens, _ = pack_block(sorted_block, max_len=L)
    np.testing.assert_array_equal(codes, w_codes)
    np.testing.assert_array_equal(quals, w_quals)
    np.testing.assert_array_equal(lens, w_lens)
    assert valid.all()
