"""``tests/test_io.py``'s cases on the port's own copies of the host
layers: ``hpgq_torch.io.fastq`` (reader, gzip read-ahead, writer, span
pump, coalescing), ``hpgq_torch.io.packer`` and, where a case drives a
command, ``hpgq_torch.pipeline.run`` and the port's CLI on the CPU
(``device="cpu"``, ``--device cpu``).  The cases and their data are
``hpgq``'s; only the modules differ, so the two copies are held to one
contract.
"""

import numpy as np
import pytest

from hpgq_torch.io.fastq import FastqReader
from hpgq_torch.io.packer import BASE_LUT, pack_block

from gen import make_fastq, make_records, write_fastq


def _read_all(path, batch_size):
    blocks = []
    with FastqReader(path, batch_size=batch_size) as rd:
        for b in rd:
            blocks.append(b)
    return blocks


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("batch_size", [7, 100, 10000])
def test_reader_roundtrip(tmp_path, gz, batch_size):
    path = str(tmp_path / ("a.fq" + (".gz" if gz else "")))
    records = make_fastq(path, 253, min_len=20, max_len=90, seed=1, n_prob=0.02)
    blocks = _read_all(path, batch_size)
    got = []
    for b in blocks:
        for i in range(b.num_reads):
            got.append((b.sequence(i), b.quality(i)))
    assert len(got) == len(records)
    for (seq, qual), (_, rseq, rqual) in zip(got, records):
        assert seq == rseq
        assert qual == rqual


def test_gzip_readahead_multichunk(tmp_path):
    """ReadaheadFile with tiny chunks: many queue handoffs, byte-exact
    stream, and the decode thread exits on early close."""
    import gzip as _gzip

    from hpgq_torch.io.fastq import ReadaheadFile

    path = str(tmp_path / "a.fq.gz")
    make_fastq(path, 2000, min_len=50, max_len=150, seed=7)
    want = _gzip.open(path, "rb").read()
    ra = ReadaheadFile(_gzip.open(path, "rb"), chunk_bytes=4096, depth=3)
    got = bytearray()
    while True:
        d = ra.read(1000)
        if not d:
            break
        assert isinstance(d, bytes)  # partial piece reads must not leak views
        got += d
    ra.close()
    assert bytes(got) == want

    # early close: the fill thread must not linger
    ra = ReadaheadFile(_gzip.open(path, "rb"), chunk_bytes=1024, depth=2)
    assert ra.read(10)
    ra.close()
    assert not ra._thread.is_alive()

    # reader path: .gz input goes through the readahead wrapper
    with FastqReader(path, batch_size=500) as rd:
        assert isinstance(rd._fh, ReadaheadFile)
        assert sum(b.num_reads for b in rd) == 2000


def test_reader_no_trailing_newline(tmp_path):
    path = str(tmp_path / "a.fq")
    records = make_records(3, min_len=10, max_len=10)
    write_fastq(path, records)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-1])  # strip final newline
    blocks = _read_all(path, 100)
    assert sum(b.num_reads for b in blocks) == 3
    assert blocks[-1].quality(blocks[-1].num_reads - 1) == records[-1][2]


def test_record_bytes_roundtrip(tmp_path):
    path = str(tmp_path / "a.fq")
    make_fastq(path, 11, min_len=5, max_len=30, seed=3)
    with open(path, "rb") as f:
        raw = f.read()
    blocks = _read_all(path, 4)
    rebuilt = b"".join(
        b.record_bytes(i) for b in blocks for i in range(b.num_reads)
    )
    assert rebuilt == raw


def test_pack_block(tmp_path):
    path = str(tmp_path / "a.fq")
    records = make_fastq(
        path, 37, min_len=10, max_len=130, seed=2, n_prob=0.05, lowercase_prob=0.1
    )
    (block,) = _read_all(path, 10000)
    codes, quals, lens, valid = pack_block(block, pad_reads_to=64)
    assert codes.shape == quals.shape == (64, 256)
    assert valid.sum() == 37
    for i, (_, seq, qual) in enumerate(records):
        n = len(seq)
        assert lens[i] == n
        np.testing.assert_array_equal(
            codes[i, :n], BASE_LUT[np.frombuffer(seq, dtype=np.uint8)]
        )
        np.testing.assert_array_equal(
            quals[i, :n], np.frombuffer(qual, dtype=np.uint8)
        )
        assert (codes[i, n:] == 5).all()
        assert (quals[i, n:] == 0).all()
    assert (lens[37:] == 0).all()


def test_write_selected_and_trimmed(tmp_path):
    path = str(tmp_path / "a.fq")
    records = make_fastq(path, 9, min_len=12, max_len=20, seed=4)
    (block,) = _read_all(path, 100)
    sel = np.array([i % 2 == 0 for i in range(9)])
    import io

    out = io.BytesIO()
    n = block.write_selected(out, sel)
    assert n == 5
    expected = b"".join(
        name + b"\n" + seq + b"\n+\n" + q + b"\n"
        for i, (name, seq, q) in enumerate(records)
        if sel[i]
    )
    assert out.getvalue() == expected

    out = io.BytesIO()
    lt = np.full(9, 3)
    rt = np.full(9, 2)
    block.write_trimmed(out, lt, rt)
    expected = b"".join(
        name + b"\n" + seq[3:-2] + b"\n+\n" + q[3:-2] + b"\n"
        for (name, seq, q) in records
    )
    assert out.getvalue() == expected


def test_empty_and_truncated_inputs(tmp_path):
    """Empty file -> explicit empty summary; trailing partial record is
    dropped with the complete records still processed (no crash)."""
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.pipeline.run import run_stats

    empty = tmp_path / "e.fq"
    empty.write_bytes(b"")
    trunc = tmp_path / "t.fq"
    trunc.write_bytes(b"@r1\nACGT\n+\nIIII\n@r2\nACG")

    for path, want_reads in ((empty, 0), (trunc, 1)):
        o = StatsOptions()
        o.in_filename = str(path)
        o.out_dirname = str(tmp_path)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        c = run_stats(o, device="cpu")
        assert c.num_reads == want_reads, path
    assert b"Number of reads: 0" in (tmp_path / "e.fq.summary.txt").read_bytes()
    assert b"Number of reads: 1" in (tmp_path / "t.fq.summary.txt").read_bytes()


def test_malformed_input_rejected(tmp_path):
    """Desynced/corrupt records raise a clear parse error instead of
    feeding out-of-bounds offsets to the packers: seq/qual length mismatch
    (incl. a truncated final quality line), bad '@' header marker, bad '+'
    separator.  (The reference parser would silently read garbage here;
    clean rejection is a deliberate quality-of-implementation deviation.)"""
    import pytest

    from hpgq_torch.io.fastq import FastqReader

    good = b"@r0\nACGT\n+\nIIII\n"
    for name, data in (
        ("qual_short", good + b"@r1\nACGTACGT\n+\nIII\n"),
        ("qual_trunc_eof", good + b"@r1\nACGT\n+\nII"),
        ("bad_header", good + b"r1\nACGT\n+\nIIII\n"),
        ("bad_sep", good + b"@r1\nACGT\n-\nIIII\n"),
    ):
        p = tmp_path / (name + ".fq")
        p.write_bytes(data)
        with pytest.raises(ValueError, match="malformed FASTQ"):
            with FastqReader(str(p), batch_size=10) as rd:
                list(rd)

    # CLI surface: clean reference-style error + exit -1, no traceback
    from hpgq_torch.cli.main import main

    bad = tmp_path / "qual_short.fq"
    assert main(["stats", "-f", str(bad), "-o", str(tmp_path),
                 "--device", "cpu"]) == -1


def test_crlf_input(tmp_path):
    """CRLF line endings: '\r' is terminator, not content; filter output
    preserves the original CRLF records byte-exactly."""
    import numpy as np

    from hpgq_torch.io.fastq import FastqReader, FastqWriter
    from hpgq_torch.io.packer import pack_block

    recs = b"".join(
        b"@r%d\r\nACGTACGTAC\r\n+\r\nIIIIIIIIII\r\n" % i for i in range(50)
    )
    path = tmp_path / "crlf.fq"
    path.write_bytes(recs)
    with FastqReader(str(path), batch_size=1000) as rd:
        (block,) = list(rd)
    assert block.num_reads == 50
    np.testing.assert_array_equal(block.seq_lens, np.full(50, 10))
    codes, quals, lens, valid = pack_block(block)
    assert int(np.asarray(codes)[:, :10].max()) <= 4  # no CR leaked into bases
    assert set(np.asarray(quals[:, :10]).ravel()) == {ord("I")}
    assert block.end_offset == len(recs)

    out = tmp_path / "sel.fq"
    with FastqWriter(str(out)) as w:
        block.write_selected(w, np.ones(50, bool))
    assert out.read_bytes() == recs  # byte-exact incl. CRLF

    trimmed = tmp_path / "trim.fq"
    with FastqWriter(str(trimmed)) as w:
        block.write_trimmed(w, np.full(50, 2), np.zeros(50, dtype=int))
    first = trimmed.read_bytes().split(b"\r\n")[:4]
    assert first == [b"@r0", b"GTACGTAC", b"+", b"IIIIIIII"]


def test_bucket_rows():
    """Device-row bucketing: 16384-multiples, capped, never below n."""
    from hpgq_torch.io.packer import bucket_rows

    assert bucket_rows(1, 131072) == 16384
    assert bucket_rows(16384, 131072) == 16384
    assert bucket_rows(16385, 131072) == 32768
    assert bucket_rows(64000, 131072) == 65536
    assert bucket_rows(131000, 131072) == 131072
    assert bucket_rows(300, 512) == 512      # small caps stay exact
    assert bucket_rows(5000, 0) == 5000      # no cap -> no padding


def test_coalesce_blocks(tmp_path):
    """Dispatch coalescing: same-chunk blocks merge zero-copy up to the
    target; record content/order and resume offsets are untouched."""
    from hpgq_torch.io.fastq import coalesce_blocks

    path = str(tmp_path / "c.fq")
    records = make_fastq(path, 1000, min_len=30, max_len=80, seed=5)
    small = _read_all(path, 100)  # 10 blocks, one shared chunk
    merged = list(coalesce_blocks(iter(small), 350))
    # 100-read blocks against a 350 target: groups of 3 (adding the 4th
    # would exceed), remainder 100 -> [300, 300, 300, 100]
    assert [b.num_reads for b in merged] == [300, 300, 300, 100]
    assert all(m.arr is small[0].arr for m in merged)  # zero-copy
    got = []
    for m in merged:
        for i in range(m.num_reads):
            got.append((m.sequence(i), m.quality(i)))
    assert got == [(r[1], r[2]) for r in records]
    # merged end_offset == last member's (a valid resume point)
    assert merged[0].end_offset == small[2].end_offset
    assert merged[-1].end_offset == small[-1].end_offset
    # span accounting survives the merge
    assert sum(m.span_bytes for m in merged) == sum(b.span_bytes for b in small)

    # a chunk boundary always flushes: blocks over different buffers never merge
    b_lo, b_hi = small[0], small[5]
    fake_hi = b_hi.slice(0, b_hi.num_reads)
    fake_hi.arr = b_hi.arr.copy()  # simulate a new chunk buffer
    out = list(coalesce_blocks(iter([b_lo, fake_hi]), 10_000))
    assert [b.num_reads for b in out] == [100, 100]


def test_coalesced_pipeline_equivalence(tmp_path, monkeypatch):
    """HPGQ_COALESCE-forced runs: identical stats counters and
    byte-identical filter outputs vs the uncoalesced run, with fewer
    device dispatches."""
    import os

    from hpgq_torch.options import FilterOptions, StatsOptions
    from hpgq_torch.pipeline.run import run_filter, run_stats
    from hpgq_torch.utils.timers import StageTimers

    path = str(tmp_path / "p.fq")
    make_fastq(path, 2000, min_len=40, max_len=120, seed=6, n_prob=0.02)

    def stats_opts(sub):
        o = StatsOptions()
        o.in_filename = path
        o.out_dirname = str(tmp_path / sub)
        os.makedirs(o.out_dirname, exist_ok=True)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 150
        o.batch_size_set = True
        return o

    monkeypatch.delenv("HPGQ_COALESCE", raising=False)
    t_plain = StageTimers()
    ref = run_stats(stats_opts("plain"), t_plain, device="cpu")

    monkeypatch.setenv("HPGQ_COALESCE", "600")
    t_co = StageTimers()
    got = run_stats(stats_opts("co"), t_co, device="cpu")
    assert got.equals(ref)
    assert t_co.num_batches < t_plain.num_batches
    # byte-identical reports
    name = "p.fq.summary.txt"
    assert (
        open(os.path.join(str(tmp_path / "co"), name), "rb").read()
        == open(os.path.join(str(tmp_path / "plain"), name), "rb").read()
    )

    def filter_opts(sub):
        o = FilterOptions()
        o.in_filename = path
        o.out_dirname = str(tmp_path / sub)
        os.makedirs(o.out_dirname, exist_ok=True)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 150
        o.batch_size_set = True
        o.criteria.min_read_quality = 18
        o.criteria.max_read_quality = 45
        return o

    monkeypatch.delenv("HPGQ_COALESCE", raising=False)
    rf = run_filter(filter_opts("fplain"), device="cpu")
    monkeypatch.setenv("HPGQ_COALESCE", "600")
    gf = run_filter(filter_opts("fco"), device="cpu")
    assert (gf["num_passed"], gf["num_failed"]) == (rf["num_passed"],
                                                    rf["num_failed"])
    for name in ("passed.fq", "failed.fq"):
        assert (
            open(os.path.join(str(tmp_path / "fco"), name), "rb").read()
            == open(os.path.join(str(tmp_path / "fplain"), name), "rb").read()
        )


def test_writer_resume_refuses_truncated_file(tmp_path):
    """Resuming (append_at) into a file shorter than the checkpointed size
    must raise — truncate() past EOF would silently zero-extend the output
    and corrupt it."""
    from hpgq_torch.io.fastq import FastqWriter

    p = str(tmp_path / "out.fq")
    with FastqWriter(p) as w:
        w.write(b"@r\nACGT\n+\n!!!!\n")
    size = len(b"@r\nACGT\n+\n!!!!\n")
    # normal resume at or below the current size works
    with FastqWriter(p, append_at=size) as w:
        w.write(b"@s\nA\n+\n!\n")
    open(p, "wb").close()  # simulate operator truncation
    with pytest.raises(ValueError, match="truncated or replaced"):
        FastqWriter(p, append_at=size)


def test_async_span_pump_equivalence(tmp_path):
    """AsyncSpanPump (threaded) vs sync writes: byte-identical outputs for
    both selected and trimmed span shapes, interleaved across two files in
    one pump (cross-file write order is preserved by the single thread)."""
    import numpy as np

    from gen import make_fastq
    from hpgq_torch.io.fastq import AsyncSpanPump, FastqReader, FastqWriter

    fq = str(tmp_path / "p.fq")
    make_fastq(fq, 700, min_len=20, max_len=90, seed=21)
    rng = np.random.default_rng(3)

    def run(sync):
        d = tmp_path / ("sync" if sync else "async")
        d.mkdir()
        a, b = str(d / "a.fq"), str(d / "b.fq")
        with FastqReader(fq, batch_size=100) as rd, \
             FastqWriter(a) as wa, FastqWriter(b) as wb, \
             AsyncSpanPump(sync=sync) as pump:
            for block in rd:
                n = block.num_reads
                sel = rng.random(n) < 0.6
                lt = rng.integers(0, 5, n).astype(np.int32)
                rt = rng.integers(0, 5, n).astype(np.int32)
                block.write_selected(wa, sel, pump=pump)
                block.write_selected(wb, ~sel, pump=pump)
                block.write_trimmed(wa, lt, rt, select=~sel, pump=pump)
                pump.drain()  # sizes must be final after a drain
            pump.close()
        return open(a, "rb").read(), open(b, "rb").read()

    rng = np.random.default_rng(3)
    got_sync = run(True)
    rng = np.random.default_rng(3)
    got_async = run(False)
    assert got_sync == got_async
    assert len(got_sync[0]) > 0 and len(got_sync[1]) > 0


def test_async_span_pump_error_propagates(tmp_path):
    """A writer-side failure (closed file) re-raises on the submitting
    thread at the next submit/drain/close instead of being swallowed."""
    import numpy as np

    from gen import make_fastq
    from hpgq_torch.io.fastq import AsyncSpanPump, FastqReader, FastqWriter

    fq = str(tmp_path / "e.fq")
    make_fastq(fq, 50, min_len=30, max_len=30, seed=5)
    with FastqReader(fq, batch_size=1000) as rd:
        (block,) = list(rd)
    w = FastqWriter(str(tmp_path / "out.fq"))
    w.close()  # writes into it must fail
    pump = AsyncSpanPump()
    with pytest.raises(ValueError):
        block.write_selected(w, np.ones(block.num_reads, bool), pump=pump)
        pump.drain()
    pump.close()
