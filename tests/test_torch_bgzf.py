"""``tests/test_bgzf.py``'s cases on the port's own copies:
``hpgq_torch.io.bgzf`` (BGZF block-gzip: index, random access), the
reader over it (``hpgq_torch.io.fastq``) and the byte-range split
(``hpgq_torch.dist.mesh``).  The cases and their data are ``hpgq``'s.
"""

import gzip

import numpy as np

from gen import make_fastq

from hpgq_torch.io.bgzf import BgzfFile, is_bgzf, write_bgzf
from hpgq_torch.io.fastq import FastqReader


def _bgzf_fastq(tmp_path, n=2000, name="b.fq.bgz", **kw):
    plain = tmp_path / "plain.fq"
    make_fastq(str(plain), n, **kw)
    data = plain.read_bytes()
    path = str(tmp_path / name)
    write_bgzf(path, data, block_size=4096)
    return path, data


def test_detection(tmp_path):
    path, data = _bgzf_fastq(tmp_path, n=100, min_len=50, max_len=60)
    assert is_bgzf(path)
    gz = str(tmp_path / "g.fq.gz")
    with gzip.open(gz, "wb") as f:
        f.write(data)
    assert not is_bgzf(gz)
    plain = str(tmp_path / "p.fq")
    open(plain, "wb").write(data)
    assert not is_bgzf(plain)


def test_bgzf_is_valid_gzip(tmp_path):
    path, data = _bgzf_fastq(tmp_path, n=300, min_len=50, max_len=90)
    with gzip.open(path, "rb") as f:
        assert f.read() == data


def test_random_access(tmp_path):
    path, data = _bgzf_fastq(tmp_path, n=1000, min_len=50, max_len=120, seed=4)
    f = BgzfFile(path)
    assert f.logical_size == len(data)
    rng = np.random.default_rng(0)
    for _ in range(50):
        pos = int(rng.integers(0, len(data)))
        ln = int(rng.integers(1, 5000))
        f.seek(pos)
        assert f.read(ln) == data[pos : pos + ln]
    # readline across block boundaries
    f.seek(0)
    lines = []
    while True:
        line = f.readline()
        if not line:
            break
        lines.append(line)
    assert b"".join(lines) == data


def test_reader_on_bgzf_matches_plain(tmp_path):
    path, data = _bgzf_fastq(tmp_path, n=1500, min_len=40, max_len=100, seed=7)
    plain = str(tmp_path / "p2.fq")
    open(plain, "wb").write(data)
    with FastqReader(path, batch_size=333) as rb:
        got = [(b.buf, b.starts.copy()) for b in rb]
    with FastqReader(plain, batch_size=333) as rp:
        want = [(b.buf, b.starts.copy()) for b in rp]
    assert len(got) == len(want)
    for (b1, s1), (b2, s2) in zip(got, want):
        assert b1 == b2
        np.testing.assert_array_equal(s1, s2)


def test_byte_range_split_on_bgzf(tmp_path):
    """Sharded logical byte ranges over BGZF partition all records exactly."""
    from hpgq_torch.dist.mesh import range_splittable, split_byte_ranges

    path, data = _bgzf_fastq(tmp_path, n=2000, min_len=60, max_len=80, seed=9)
    assert range_splittable(path)
    total = 0
    ranges = split_byte_ranges(path, 4)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(data)
    for start, end in ranges:
        with FastqReader(path, batch_size=10**9, start_offset=start,
                         end_offset=end) as rd:
            for b in rd:
                total += b.num_reads
    assert total == 2000

    # plain gzip is NOT splittable
    gz = str(tmp_path / "x.fq.gz")
    with gzip.open(gz, "wb") as f:
        f.write(data)
    assert not range_splittable(gz)


def test_checkpoint_offsets_on_bgzf(tmp_path):
    """Resume offsets are logical: seek into BGZF mid-file works."""
    path, data = _bgzf_fastq(tmp_path, n=800, min_len=50, max_len=50, seed=2)
    with FastqReader(path, batch_size=100) as rd:
        blocks = list(rd)
    off = blocks[2].end_offset
    with FastqReader(path, batch_size=10**9, start_offset=off) as rd:
        rest = sum(b.num_reads for b in rd)
    assert rest == 800 - sum(b.num_reads for b in blocks[:3])
