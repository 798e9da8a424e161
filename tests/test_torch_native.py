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


def test_find_newlines_mt_paths():
    """The multi-threaded scan (>=2MB buffers) matches numpy, including the
    capacity-retry path and pathological all-newline input."""
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, size=3 << 21, dtype=np.uint8)
    got = native.find_newlines(big)
    want = np.flatnonzero(big == 0x0A)
    np.testing.assert_array_equal(got, want)

    dense = np.full(1 << 22, 0x0A, dtype=np.uint8)  # every byte a newline
    got = native.find_newlines(dense)
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
