"""The plan of the host's cores (``hpgq_torch.io.native.plan``): every
stage gets a thread, the threads that run at once stay within the usable
cores, the user's overrides win, and a pass counts the same whatever teams
the plan gives.
"""

import io

import numpy as np
import pytest
import torch

from gen import make_fastq

from hpgq_torch.io import fastq, native
from hpgq_torch.io.native import inflate
from hpgq_torch.options import StatsOptions
from hpgq_torch.pipeline import run as prun
from hpgq_torch.utils.timers import StageTimers

torch.set_num_threads(2)


@pytest.fixture
def host(monkeypatch):
    """``host(cores, ranks)``: the affinity and ``LOCAL_WORLD_SIZE`` the
    plan reads, and no override."""
    monkeypatch.delenv("HPGQ_PACK_THREADS", raising=False)
    monkeypatch.delenv("HPGQ_READ_SHARDS", raising=False)
    monkeypatch.setattr(native, "_explicit", 0)

    def set_host(cores, ranks=1):
        monkeypatch.setattr(native.os, "sched_getaffinity",
                            lambda pid: set(range(cores)))
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(ranks))

    return set_host


# (shards, mates, packers): a lone reader with the plan's pool or one of
# 1-4 workers asked, a reader that packs its own blocks, the shard readers
# of a plain file (as many as run._read_shards gives), two mates
PIPELINES = [(1, 1, None), (1, 1, 1), (1, 1, 2), (1, 1, 3), (1, 1, 4),
             (1, 1, 0), ("shards", 1, 0), ("shards", 1, None), (1, 2, None)]


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("decoder", ["", "gzip", "bgzf"])
@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("cores", [1, 4, 8])
def test_plan_fits_cores(host, cores, ranks, decoder, pipeline):
    """Each stage gets at least one thread and at most 8; the gzip pool
    half the cores where that is two threads, every BGZF reader a pool of
    at least one; the threads that run at once stay within the process's
    share of the cores wherever its decode pools and readers (and a paired
    pipeline's one pack worker) fit in it, else every team is one
    thread."""
    host(cores, ranks)
    shards, mates, packers = pipeline
    if shards == "shards":
        shards = prun._read_shards()
        assert shards == max(1, min(4, cores // ranks // 2))
    p = native.plan(decoder, shards, mates, packers)
    share = max(1, cores // ranks)
    assert p.cores == share
    if decoder == "gzip" and share >= 4:
        assert (p.pools, p.decode) == (1, share // 2)
    elif decoder == "bgzf":
        assert p.pools == shards * mates
        assert 1 <= p.decode <= 8
        assert p.pools * p.decode <= max(p.pools, share // 2)
    else:
        assert p.pools == p.decode == 0
    assert 1 <= p.index <= 8 and 1 <= p.pack <= 8
    assert p.intra_op == p.pack
    assert (p.shards, p.mates) == (shards, mates)
    assert p.packers == 0 or p.packers >= (1 if mates > 1 else 2)
    if packers is not None:
        assert p.packers <= max(packers, 1 if mates > 1 else 0)
    if shards * (mates + (mates > 1)) <= share - p.pools * p.decode:
        assert p.threads() <= share
    else:
        assert p.index == p.pack == 1
    assert "of %d cores" % share in str(p)


def test_plan_of_the_gzip_cell(host):
    """One gzip reader on 8 cores with a 4-thread decode pool: one index
    thread and three one-thread pack workers, 8 threads."""
    host(8)
    p = native.plan("gzip")
    assert (p.pools, p.decode, p.index, p.packers, p.pack,
            p.intra_op) == (1, 4, 1, 3, 1, 1)
    assert p.threads() == 8
    assert str(p) == ("decode 1 x 4, 1 x (index 1 x 1, pack 3 x 1), "
                      "intra-op 1: 8 threads of 8 cores")


def test_plan_of_the_paired_gzip_cell(host):
    """The two gzip readers of a pair on 8 cores share one 4-thread decode
    pool; each indexes on one thread and two one-thread pack workers pack
    the pairs: 8 threads, within the cores."""
    host(8)
    p = native.plan("gzip", mates=2)
    assert (p.pools, p.decode, p.mates, p.index, p.packers, p.pack,
            p.intra_op) == (1, 4, 2, 1, 2, 1, 1)
    assert p.threads() == 8 <= p.cores
    assert str(p) == ("decode 1 x 4, 1 x (index 2 x 1, pack 2 x 1), "
                      "intra-op 1: 8 threads of 8 cores")


@pytest.mark.parametrize("shards,mates,want", [
    (1, 1, "decode 1 x 4, 1 x (index 1 x 1, pack 3 x 1), intra-op 1: "
           "8 threads of 8 cores"),
    (4, 2, "decode 8 x 1, 4 x (index 2 x 1, pack 1 x 1), intra-op 1: "
           "20 threads of 8 cores")])
def test_plan_of_bgzf_readers(host, tmp_path, shards, mates, want):
    """Every BGZF reader keeps a decode pool of at least one thread, where
    there are more readers than half the cores too, the plan counts each
    pool's threads, and a reader opens its file with its pool's size."""
    from hpgq_torch.io.bgzf import write_bgzf

    host(8)
    p = native.plan("bgzf", shards, mates)
    assert str(p) == want
    path = str(tmp_path / "r.fq.bgz")
    make_fastq(str(tmp_path / "r.fq"), 200, min_len=60, max_len=140,
               seed=21)
    with open(str(tmp_path / "r.fq"), "rb") as f:
        write_bgzf(path, f.read())
    with fastq.FastqReader(path, 100, shards=shards, mates=mates) as rd:
        assert rd.plan == p
        assert rd._fh._workers == p.decode
        assert sum(b.num_reads for b in rd) == 200


@pytest.mark.parametrize("explicit", [1, 3, 12])
def test_num_threads_wins(host, explicit):
    """``--num-threads`` sets every team, past the cores too, and every
    call given no size; 0 gives the choice back to the plan."""
    host(8)
    native.set_num_threads(explicit)
    try:
        p = native.plan("gzip")
        assert p.index == p.pack == p.intra_op == explicit
        assert native._threads(0) == explicit
        native.use_team(2)
        assert native._threads(0) == explicit
        assert native._threads(5) == 5
    finally:
        native.set_num_threads(0)
        native.use_team(0)
    assert native.plan("gzip").index == 1


@pytest.mark.parametrize("forced,want", [("1", 0), ("2", 2), ("6", 6),
                                         ("16", 16)])
def test_pack_threads_wins(host, monkeypatch, forced, want):
    """``HPGQ_PACK_THREADS`` sets the pack workers (1: the reader packs its
    own blocks), past the cores too; the teams stay at least one."""
    host(8)
    monkeypatch.setenv("HPGQ_PACK_THREADS", forced)
    p = native.plan("gzip")
    assert p.packers == want
    assert p.pack >= 1 and p.index >= 1


def test_thread_team_default(host):
    """A call given no team size takes the calling thread's planned team,
    else the cores a lone caller may use, at most 8."""
    host(6)
    assert native._threads(0) == 6
    host(32)
    assert native._threads(0) == 8
    native.use_team(3)
    try:
        assert native._threads(0) == 3
    finally:
        native.use_team(0)
    assert native._threads(0) == 8


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("size", [0, 7, 3 << 20])
def test_copy_into(threads, size):
    """The pinned copy's native team copies every byte, and a strided
    source falls back to numpy's copy."""
    rng = np.random.default_rng(size)
    src = rng.integers(0, 2**31, size // 4 + 1, dtype=np.int32)
    dst = np.zeros_like(src)
    native.copy_into(dst, src, threads)
    np.testing.assert_array_equal(dst, src)
    strided = src[::2]
    dst = np.zeros_like(strided)
    native.copy_into(dst, strided, threads)
    np.testing.assert_array_equal(dst, strided)


def _stats(path, outdir, timers=None):
    opts = StatsOptions(in_filename=path, out_dirname=outdir,
                        quality_encoding_name="phred33", batch_size=300)
    return prun.run_stats(opts, timers, report=False, device="cpu")


@pytest.mark.parametrize("teams", [1, 8])
def test_stats_equal_under_teams(tmp_path, monkeypatch, teams):
    """``stats`` over a gzip file whose decode pool engages counts the same
    under the plan as under forced 1-thread and 8-thread teams; ``--t``
    prints the reader's plan and no short team."""
    if not native.available() or inflate.get_lib() is None:
        pytest.skip("native libraries not built (no g++?)")
    monkeypatch.setattr(fastq, "_CHUNK", 60_000)
    monkeypatch.setattr(inflate, "CHUNK_BYTES", 8192)
    monkeypatch.setattr(inflate, "_workers", lambda path: 2)
    monkeypatch.setattr(native.os, "sched_getaffinity",
                        lambda pid: set(range(8)))
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("HPGQ_PACK_THREADS", raising=False)
    path = str(tmp_path / "r.fq.gz")
    make_fastq(path, 3000, min_len=60, max_len=140, n_prob=0.02, seed=20)
    t = StageTimers()
    want = _stats(path, str(tmp_path), t)
    assert t.counts["team-short"] == 0
    assert t.counts["inflate-chunks"] > 0
    out = io.StringIO()
    t.report(out)
    assert "plan r.fq.gz: %s" % native.plan("gzip") in out.getvalue()
    native.set_num_threads(teams)
    try:
        got = _stats(path, str(tmp_path))
    finally:
        native.set_num_threads(0)
    assert got.equals(want)
