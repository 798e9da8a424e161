"""The port's ``--sharded`` layer (``hpgq_torch.dist``) in one process.

Mirrors of ``tests/test_dist.py`` at world size 1, where no launcher set
up a process group: the byte ranges and stripes, ``run_stats_sharded``
(with k-mers), ``run_cgr_sharded`` and the resume of stats, paired stats
and cgr from the rotating checkpoints, each against ``hpgq``'s
single-process result on the same seeded input.  Also: the ``--sharded``
CLI of every command byte-equal to ``hpgq``'s, the backend rule of
``initialize_distributed``, and ``--profile-dir`` taken by ``--sharded``
and ``cgr`` with no trace written, as in ``hpgq``.  The
multi-process runs are in ``tests/test_torch_multiproc*.py``.

Tolerance: every integer field and output byte exact; ``acc_quality`` as
``StatsCounters.equals`` compares it (1e-5 relative).
"""

import os

import numpy as np
import pytest
import torch

from gen import make_fastq

import hpgq.pipeline.cgr_run as hcgr_run
import hpgq.pipeline.run as hrun
from hpgq.options import CgrOptions as HCgrOptions
from hpgq.options import StatsOptions as HStatsOptions
from hpgq_torch.dist import mesh, run_dist
from hpgq_torch.io.fastq import FastqReader
from hpgq_torch.options import CgrOptions, StatsOptions
from hpgq_torch.pipeline.cgr_run import run_cgr
from hpgq_torch.pipeline import run as prun
from test_torch_pipeline import _assert_cli_identical

torch.set_num_threads(2)

CRIT = dict(min_read_quality=20, max_read_quality=40, max_N=2)


def _opts(cls, inputs, outdir, batch_size, crit=None, **kw):
    """Options of either package (``cls``) over ``inputs``."""
    o = cls()
    o.in_filename = inputs[0]
    o.in_filename2 = inputs[1] if len(inputs) > 1 else None
    o.out_dirname = str(outdir)
    os.makedirs(o.out_dirname, exist_ok=True)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = batch_size
    if crit:
        for k, v in crit.items():
            setattr(o.criteria, k, v)
        o.filter_on = True
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def _report(outdir, path):
    with open(os.path.join(str(outdir), os.path.basename(path)
                           + ".summary.txt"), "rb") as f:
        return f.read().replace(os.path.abspath(str(outdir)).encode(), b"@")


def test_byte_range_shard_invariance(tmp_path):
    """stats(file) == the merge of stats(byte-range shard i), for 2 and 5
    shards, each shard run as a rank runs it (an explicit range)."""
    path = str(tmp_path / "a.fq")
    make_fastq(path, 1001, min_len=30, max_len=70, n_prob=0.02, seed=52)
    whole = hrun.run_stats(_opts(HStatsOptions, [path], tmp_path / "h", 100),
                           report=False)
    for n in (2, 5):
        ranges = mesh.split_byte_ranges(path, n)
        assert ranges[0][0] == 0
        merged = None
        for rng in ranges:
            o = _opts(StatsOptions, [path], tmp_path / "p", 100,
                      input_range=rng)
            part = prun.run_stats(o, report=False, device="cpu")
            merged = part if merged is None else merged.merge(part)
        assert merged.num_reads == 1001
        assert merged.equals(whole), n


def test_split_ranges_cover_and_align(tmp_path):
    path = str(tmp_path / "a.fq")
    make_fastq(path, 100, min_len=20, max_len=40, seed=53)
    size = os.path.getsize(path)
    ranges = mesh.split_byte_ranges(path, 4)
    assert ranges[0][0] == 0 and ranges[-1][1] == size
    for (_, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1
    with open(path, "rb") as f:
        for s, _ in ranges:
            if 0 < s < size:
                f.seek(s)
                assert f.readline().startswith(b"@")


def test_striped_blocks_partition(tmp_path):
    """Striping covers every block of a plain-gzip stream exactly once."""
    fq = str(tmp_path / "s.fq.gz")
    make_fastq(fq, 1000, min_len=50, max_len=50, seed=2)
    seen = []
    for stripe in range(3):
        with FastqReader(fq, batch_size=128) as rd:
            seen += [b.num_reads for b in
                     run_dist.striped_blocks(rd, stripe, 3)]
    assert sum(seen) == 1000 and len(seen) == 8


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filter"])
def test_run_stats_sharded_pipeline(tmp_path, filtered):
    """World size 1 with no launcher: no group, and the counters and the
    report of ``hpgq``'s single-process run."""
    fq = str(tmp_path / "in.fq")
    make_fastq(fq, 3000, min_len=40, max_len=120, n_prob=0.01, seed=9)
    crit = CRIT if filtered else None
    single = hrun.run_stats(_opts(HStatsOptions, [fq], tmp_path / "a", 700,
                                  crit))
    assert mesh.initialize_distributed("cpu") == mesh.RankGroup(
        0, 1, torch.device("cpu"))
    sharded = run_dist.run_stats_sharded(
        _opts(StatsOptions, [fq], tmp_path / "b", 700, crit), device="cpu")
    assert sharded.equals(single)
    assert (sharded.num_passed, sharded.num_failed) == (single.num_passed,
                                                        single.num_failed)
    assert _report(tmp_path / "b", fq) == _report(tmp_path / "a", fq)


def test_sharded_kmers(tmp_path):
    fq = str(tmp_path / "k.fq")
    make_fastq(fq, 800, min_len=40, max_len=80, seed=33)
    single = hrun.run_stats(_opts(HStatsOptions, [fq], tmp_path / "a", 256,
                                  kmers_on=True))
    sharded = run_dist.run_stats_sharded(
        _opts(StatsOptions, [fq], tmp_path / "b", 256, kmers_on=True),
        device="cpu")
    assert sharded.equals(single)
    np.testing.assert_array_equal(sharded.kmer_counts, single.kmer_counts)
    name = "k.fq.kmers.txt"
    assert (tmp_path / "b" / name).read_bytes() == (
        tmp_path / "a" / name).read_bytes()


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_run_cgr_sharded_equals_local(tmp_path, paired):
    inputs = [str(tmp_path / "c1.fq"), str(tmp_path / "c2.fq")][:1 + paired]
    for i, p in enumerate(inputs):
        make_fastq(p, 1500, min_len=40, max_len=100, n_prob=0.02,
                   seed=13 + i)
    local = hcgr_run.run_cgr(_opts(HCgrOptions, inputs, tmp_path / "a", 333,
                                   k=4, write_gs=True))
    sharded = run_dist.run_cgr_sharded(
        _opts(CgrOptions, inputs, tmp_path / "b", 333, k=4, write_gs=True),
        device="cpu")
    assert sharded["fq_word_count"] == local["fq_word_count"]
    np.testing.assert_array_equal(sharded["table_seq"], local["table_seq"])
    np.testing.assert_array_equal(sharded["table_q"], local["table_q"])
    for suffix in ("_FG.pgm", "_QQ.pgm", ".gs"):
        name = "c1.fq_k=4" + suffix
        assert (tmp_path / "b" / name).read_bytes() == (
            tmp_path / "a" / name).read_bytes(), name


class _Boom(Exception):
    pass


def _crash_after(monkeypatch, cls, method, n):
    """``cls.method`` raises after ``n`` calls (a killed run)."""
    real = getattr(cls, method)
    calls = {"n": 0}

    def limited(self, *a, **k):
        if calls["n"] >= n:
            raise _Boom()
        calls["n"] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(cls, method, limited)


@pytest.mark.parametrize("command", ["stats", "paired", "cgr"])
def test_sharded_resume(tmp_path, monkeypatch, command):
    """A sharded run killed after its checkpoints resumes from the newest
    slot (``<path>.a``/``.b`` at world size 1) and ends as an uninterrupted
    run; the slots are removed."""
    from hpgq_torch.pipeline.cgr_run import CgrSession
    from hpgq_torch.pipeline.session import PairedStatsSession, StatsSession

    inputs = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    for i, p in enumerate(inputs):
        make_fastq(p, 2200, min_len=40, max_len=100, n_prob=0.01,
                   seed=81 + i)
    if command != "paired":
        inputs = inputs[:1]
    if command == "cgr":
        def opts(out, ck=None):
            return _opts(CgrOptions, inputs, out, 200, k=4,
                         checkpoint_path=ck, checkpoint_every=1)
        run = run_dist.run_cgr_sharded
        cls, method = CgrSession, "feed_block"
    else:
        def opts(out, ck=None):
            return _opts(StatsOptions, inputs, out, 250, CRIT,
                         checkpoint_path=ck, checkpoint_every=1)
        run = run_dist.run_stats_sharded
        cls, method = ((PairedStatsSession, "feed_pair_packed")
                       if command == "paired"
                       else (StatsSession, "feed_packed"))
    full = run(opts(tmp_path / "a"), device="cpu")
    ck = str(tmp_path / "sh.ck.npz")
    with monkeypatch.context() as m:
        _crash_after(m, cls, method, 4)
        with pytest.raises(_Boom):
            run(opts(tmp_path / "b", ck), device="cpu")
    assert os.path.exists(ck + ".a") and os.path.exists(ck + ".b")
    got = run(opts(tmp_path / "b", ck), device="cpu")
    assert not os.path.exists(ck + ".a") and not os.path.exists(ck + ".b")
    if command == "cgr":
        assert got["fq_word_count"] == full["fq_word_count"]
        np.testing.assert_array_equal(got["table_seq"], full["table_seq"])
        np.testing.assert_array_equal(got["table_q"], full["table_q"])
        return
    for g, w in zip(got if command == "paired" else [got],
                    full if command == "paired" else [full]):
        assert g.equals(w)
        assert (g.num_passed, g.num_failed) == (w.num_passed, w.num_failed)
    assert _report(tmp_path / "b", inputs[0]) == _report(tmp_path / "a",
                                                         inputs[0])


def test_iter_lockstep_is_plain_iteration_at_world_size_one():
    from hpgq_torch.utils.timers import StageTimers

    pg = mesh.initialize_distributed("cpu")
    timers = StageTimers()
    assert list(run_dist.iter_lockstep(pg, iter([1, 2]), True, timers)) \
        == [1, 2]
    assert "vote" not in timers.totals
    assert mesh.vote_max_vec(pg, [3, -1]).tolist() == [3, -1]
    assert mesh.vote_sum(pg, 5).tolist() == [5]


@pytest.mark.parametrize("env,ncards,device", [
    # a hand-launched run: no LOCAL_RANK, so RANK picks the card
    (dict(RANK="1", WORLD_SIZE="2"), 2, "cuda:1"),
    (dict(RANK="1", WORLD_SIZE="2"), 1, "cuda:0"),
    # torchrun: 4 ranks of 8 on this host, 4 cards
    (dict(RANK="5", WORLD_SIZE="8", LOCAL_RANK="1", LOCAL_WORLD_SIZE="4"),
     4, "cuda:1"),
    (dict(RANK="0", WORLD_SIZE="1"), 0, "cpu"),
], ids=["own-cards", "shared-card", "torchrun", "cpu"])
def test_backend_rule(monkeypatch, env, ncards, device):
    """The group is gloo wherever the ranks run (each on a card of its
    own, sharing one, or on the CPU), and gets the rank, the world size
    and the timeout from the launcher's variables; a rank on CUDA runs on
    ``cuda:LOCAL_RANK % device_count``."""
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    if ncards:
        monkeypatch.setattr(mesh, "resolve_device",
                            lambda d: torch.device("cuda", 0))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: ncards)
        monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    pg = mesh.initialize_distributed("cuda" if ncards else "cpu")
    assert pg == mesh.RankGroup(int(env["RANK"]), int(env["WORLD_SIZE"]),
                                torch.device(device))
    assert calls == [(("gloo",), dict(
        init_method="env://", rank=int(env["RANK"]),
        world_size=int(env["WORLD_SIZE"]), timeout=mesh.TIMEOUT))]


@pytest.mark.parametrize("backend,ok", [
    ("gloo", True), ("cpu:gloo,cuda:nccl", True), ("nccl", False)])
def test_caller_group_must_hold_gloo(monkeypatch, backend, ok):
    """A group the caller made is used as it is when it holds gloo, and
    refused when it does not: every collective is on CPU tensors."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: backend)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 3)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: pytest.fail("made a second group"))
    if ok:
        assert mesh.initialize_distributed("cpu") == mesh.RankGroup(
            1, 3, torch.device("cpu"))
    else:
        with pytest.raises(ValueError, match="gloo"):
            mesh.initialize_distributed("cpu")


def test_leave_group_destroys_only_the_group_it_made(monkeypatch, tmp_path):
    """The group ``initialize_distributed`` made over ``env://`` (world
    size 1, port 0) is gone after ``leave_group``; a group the caller made
    stays."""
    import torch.distributed as dist

    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)
    try:
        assert mesh.initialize_distributed("cpu") == mesh.RankGroup(
            0, 1, torch.device("cpu"))
        assert dist.get_backend() == "gloo"
        mesh.leave_group()
        assert not dist.is_initialized()
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method="file://%s" % (tmp_path / "pg"))
        mesh.initialize_distributed("cpu")
        mesh.leave_group()
        assert dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_profile_dir_still_raises_naming_its_item(tmp_path):
    """``--profile-dir`` no longer raises: ``--sharded`` (stats, filter)
    and ``cgr`` take the flag and, as in ``hpgq``, write no trace; the
    counters, tables and outputs are those of the run without it."""
    from hpgq_torch.options import FilterOptions

    path = str(tmp_path / "p.fq")
    make_fastq(path, 500, min_len=40, max_len=60, n_prob=0.02, seed=4)
    prof = str(tmp_path / "prof")
    got = {}
    for label, kw in (("plain", {}), ("profiled", dict(profile_dir=prof))):
        stats = run_dist.run_stats_sharded(
            _opts(StatsOptions, [path], tmp_path / label, 100, CRIT, **kw),
            device="cpu")
        filt = run_dist.run_filter_sharded(
            _opts(FilterOptions, [path], tmp_path / label, 100, CRIT, **kw),
            device="cpu")
        cgr = run_cgr(_opts(CgrOptions, [path], tmp_path / label, 100, k=4,
                            **kw), device="cpu")
        cgr_sh = run_dist.run_cgr_sharded(
            _opts(CgrOptions, [path], tmp_path / label, 100, k=4, **kw),
            device="cpu")
        got[label] = (stats, filt, cgr, cgr_sh)
        assert stats.num_passed > 0 and filt["num_failed"] > 0
    (s0, f0, c0, d0), (s1, f1, c1, d1) = got["plain"], got["profiled"]
    assert s1.equals(s0) and (s1.num_passed, s1.num_failed) == (
        s0.num_passed, s0.num_failed)
    assert (f1["num_passed"], f1["num_failed"]) == (f0["num_passed"],
                                                    f0["num_failed"])
    for name in ("passed.fq", "failed.fq"):
        assert (tmp_path / "profiled" / name).read_bytes() == (
            tmp_path / "plain" / name).read_bytes()
    for a, b in ((c1, c0), (d1, d0)):
        assert a["fq_word_count"] == b["fq_word_count"]
        np.testing.assert_array_equal(a["table_seq"], b["table_seq"])
        np.testing.assert_array_equal(a["table_q"], b["table_q"])
    assert not os.path.exists(prof)


CLI_CASES = {
    "stats": ["--read-quality-range", "20,40", "--max-N", "2", "--kmers"],
    "filter": ["--read-quality-range", "20,40", "--max-N", "2"],
    "edit": ["--left-length", "8", "--left-quality-range", "28,60",
             "--read-quality-range", "20,45"],
    "prepro": ["--ltrim-nts", "5", "--rtrim-nts", "3", "--min-quality",
               "27", "--max-quality", "64"],
    "cgr": ["--k", "5", "--write-gs"],
}


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("command", list(CLI_CASES))
def test_cli_sharded_identical_to_hpgq(tmp_path, command, paired):
    """``<command> --sharded`` at world size 1: the console and every
    output file byte-equal to ``hpgq``'s ``--sharded`` run (its 8-device
    CPU mesh)."""
    inputs = []
    for i in range(1 + paired):
        inputs.append(str(tmp_path / ("m%d.fq" % (i + 1))))
        make_fastq(inputs[-1], 600, min_len=40, max_len=120, n_prob=0.02,
                   seed=60 + i)
    _assert_cli_identical(tmp_path, tuple(inputs) if paired else inputs[0],
                          False, CLI_CASES[command] + ["--sharded",
                                                       "--batch-size", "150"],
                          command=command)


def test_output_sharded_needs_a_seekable_input(tmp_path, capsys):
    """Byte ranges cannot cut a plain-gzip file: a multi-process `filter`
    refuses it before writing anything."""
    from hpgq_torch.options import FilterOptions, OptionsError

    fq = str(tmp_path / "z.fq.gz")
    make_fastq(fq, 100, min_len=40, max_len=60, seed=5)
    o = _opts(FilterOptions, [fq], tmp_path / "o", 50, CRIT)
    pg = mesh.RankGroup(0, 2, torch.device("cpu"))
    with pytest.raises(OptionsError):
        run_dist._run_output_sharded(o, None, pg, "filter", prun.run_filter,
                                     ("num_passed", "num_failed"))
    assert "needs a byte-seekable input" in capsys.readouterr().err
    assert os.listdir(tmp_path / "o") == []
