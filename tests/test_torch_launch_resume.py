"""The port's local launcher (``hpgq_torch.dist.launch``) when a rank
fails or the parent is stopped, how many ranks an unlaunched ``--sharded``
run gets (``mesh.rank_devices``), and a resume across the packages.

A failed rank or SIGTERM to the parent: the parent exits non-zero
within 60 s, every rank is gone, the launcher's temporary directory too,
and no report is written.  The world sizes: a launcher present, the CPU,
one card, four cards, checkpoint sets of one and of several processes,
plain gzip.  Then ``hpgq``'s one-process mesh is interrupted as
``tests/test_dist.py::test_sharded_stats_resume`` interrupts it, and the
port resumes its checkpoint in one process and ends with ``hpgq``'s
uninterrupted counters and report.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from gen import make_fastq

import hpgq.dist.run_dist as hdist
import hpgq_torch
from hpgq.options import StatsOptions as HStatsOptions
from hpgq_torch.dist import mesh
from hpgq_torch.options import CgrOptions, FilterOptions, StatsOptions
from hpgq_torch.utils.checkpoint import save_counters_checkpoint
from test_torch_multiproc import assert_same_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def _alive(pid: int) -> bool:
    """A process that runs (not gone, not a zombie)."""
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


STOPS = {  # how: (the signal to the parent, the rank target, its args)
    "rank 1 raises": (None, "fail_on_rank_one",
                      "StatsOptions(in_filename=FQ, out_dirname=OUT, "
                      "batch_size=300), PIDS"),
    "SIGTERM to the parent": (signal.SIGTERM, "wait_forever", "PIDS"),
}


@pytest.mark.parametrize("how", list(STOPS))
def test_a_failure_stops_every_rank(tmp_path, how):
    """Two CPU ranks; rank 1 raises while rank 0 waits in the merge, or
    both wait and the parent gets SIGTERM.  The parent exits non-zero in
    under 60 s, leaves no rank running and no temporary directory, and no
    report is written."""
    fq = str(tmp_path / "in.fq")
    make_fastq(fq, 2000, min_len=40, max_len=110, seed=9)
    out, pids, tmp = tmp_path / "out", tmp_path / "pids", tmp_path / "tmp"
    for d in (out, pids, tmp):
        d.mkdir()
    sig, target, args = STOPS[how]
    code = ("import sys\n"
            "sys.path[:0] = [%r, %r]\n"
            "for n in ('jax', 'jaxlib', 'hpgq'):\n"
            "    sys.modules[n] = None\n"
            "from hpgq_torch.dist.launch import launch\n"
            "from hpgq_torch.options import StatsOptions\n"
            "from torch_rank_targets import fail_on_rank_one, wait_forever\n"
            "FQ, OUT, PIDS = %r, %r, %r\n"
            "launch(%s, (%s,), ['cpu', 'cpu'])\n"
            % (REPO, TESTS, fq, str(out), str(pids), target, args))
    env = dict(os.environ, TMPDIR=str(tmp))
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-c", code], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        if sig is not None:
            while len(os.listdir(pids)) < 2:
                assert p.poll() is None and time.perf_counter() - t0 < 50
                time.sleep(0.1)
            p.send_signal(sig)
        _, err = p.communicate(timeout=60 - (time.perf_counter() - t0))
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode != 0, err[-2000:]
    assert time.perf_counter() - t0 < 60
    ranks = [int((pids / n).read_text()) for n in sorted(os.listdir(pids))]
    if sig is None:
        assert "rank 1 fails on purpose" in err
        assert "RankFailed" in err
    assert len(ranks) in (1, 2) and not any(_alive(r) for r in ranks)
    assert os.listdir(tmp) == []
    assert not [n for n in os.listdir(out) if n.endswith(".summary.txt")]


def _rotating(ck, nprocs):
    """One slot of a ``stats-sharded`` checkpoint set of ``nprocs``."""
    path = ("%s.rank0" % ck if nprocs > 1 else ck) + ".a"
    save_counters_checkpoint(path, None, 0, json.dumps(
        {"cmd": "stats-sharded", "rank": 0, "nprocs": nprocs}),
        extra={"ordinal": 0})


def _output_rank(ck, path, rank, nprocs):
    """Rank ``rank``'s ``filter`` checkpoint of a run of ``nprocs``."""
    rng = mesh.split_byte_ranges(path, nprocs)[rank]
    save_counters_checkpoint("%s.rank%04d" % (ck, rank), None, rng[0],
                             json.dumps({"cmd": "filter", "range": list(rng),
                                         "range2": None}))


def _cuda(*idx):
    return ["cuda:%d" % i for i in idx]


# id: (command, gzip, checkpoint set, env, device, cards, devices, reason)
WORLDS = {
    "launcher": ("stats", False, None, dict(RANK="0", WORLD_SIZE="2"),
                 "cuda", 4, ["cuda"], "one rank of a launched run"),
    "cpu": ("stats", False, None, {}, "cpu", 4, ["cpu"], "on the cpu"),
    "one card": ("filter", False, None, {}, "cuda", 1, ["cuda"],
                 "one visible card"),
    "four cards": ("edit", False, None, {}, "cuda", 4, _cuda(0, 1, 2, 3),
                   "one per card"),
    "4-rank checkpoint, 2 cards": ("stats", False, ("rotating", 4), {},
                                   "cuda", 2, _cuda(0, 1, 0, 1),
                                   "resuming a 4-rank checkpoint"),
    "3-rank filter checkpoint": ("filter", False, ("output", 3), {}, "cuda",
                                 4, _cuda(0, 1, 2),
                                 "resuming a 3-rank checkpoint"),
    "one-process checkpoint": ("stats", False, ("rotating", 1), {}, "cuda",
                               4, ["cuda"],
                               "resuming a one-process checkpoint"),
    "one-process filter checkpoint": ("filter", False, ("output", 1), {},
                                      "cuda", 4, ["cuda"],
                                      "resuming a one-process checkpoint"),
    "fresh checkpoint": ("stats", False, ("none", 0), {}, "cuda", 4,
                         _cuda(0, 1, 2, 3), "one per card"),
    "gzip with checkpoint": ("stats", True, ("none", 0), {}, "cuda", 4,
                             ["cuda"], "plain gzip input with --checkpoint"),
    "gzip stats": ("stats", True, None, {}, "cuda", 4, _cuda(0, 1, 2, 3),
                   "one per card"),
    "gzip cgr": ("cgr", True, None, {}, "cuda", 4, _cuda(0, 1, 2, 3),
                 "one per card"),
    "gzip filter": ("filter", True, None, {}, "cuda", 4, ["cuda"],
                    "filter splits only by byte range"),
    "gzip paired stats": ("stats paired", True, None, {}, "cuda", 4,
                          ["cuda"], "paired stats splits only by byte range"),
}


@pytest.mark.parametrize("case", list(WORLDS))
def test_world_size_of_an_unlaunched_run(tmp_path, monkeypatch, caplog,
                                         case):
    """``rank_devices``' table: the devices it gives and the reason it
    logs at INFO."""
    cmd, gz, ck_set, env, device, cards, want, why = WORLDS[case]
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    paths = [str(tmp_path / ("m%d.fq%s" % (i, ".gz" if gz else "")))
             for i in (1, 2)]
    for i, p in enumerate(paths):
        make_fastq(p, 300, min_len=40, max_len=90, seed=3 + i)
    cls = {"stats": StatsOptions, "stats paired": StatsOptions,
           "filter": FilterOptions, "edit": FilterOptions,
           "cgr": CgrOptions}[cmd]
    opts = cls(in_filename=paths[0],
               in_filename2=paths[1] if cmd == "stats paired" else None)
    if ck_set is not None:
        opts.checkpoint_path = ck = str(tmp_path / "ck")
        kind, n = ck_set
        if kind == "rotating":
            _rotating(ck, n)
        elif kind == "output" and n == 1:
            save_counters_checkpoint(ck, None, 0, "{}")
        elif kind == "output":
            _output_rank(ck, paths[0], 1, n)
    with caplog.at_level(logging.INFO, logger="hpgq"):
        got = mesh.rank_devices(opts, device)
    assert [str(d) for d in got] == want
    assert any(why in r.getMessage() for r in caplog.records), caplog.text


def test_hpgq_one_process_checkpoint_resumes_in_one_process(
        tmp_path, monkeypatch, caplog):
    """``hpgq``'s one-process mesh dies after four batches with
    ``<ck>.{a,b}`` written; on a host of four cards the port would resume
    it in one process, and resumed here (``stats(..., sharded=True)``) it
    ends with ``hpgq``'s uninterrupted counters and report, and removes
    the checkpoint."""
    fq = str(tmp_path / "r.fq")
    make_fastq(fq, 2500, min_len=40, max_len=100, n_prob=0.01, seed=55)

    def hopts(out, **kw):
        o = HStatsOptions(in_filename=fq, out_dirname=str(out),
                          quality_encoding_value=33,
                          quality_encoding_name="phred33", batch_size=256,
                          **kw)
        os.makedirs(o.out_dirname, exist_ok=True)
        return o

    full = hdist.run_stats_sharded(hopts(tmp_path / "a"))
    ck = str(tmp_path / "sh.ck.npz")

    class Boom(Exception):
        pass

    real = hdist.ShardedStatsSession.feed_block
    calls = {"n": 0}

    def limited(self, block, **kw):
        if calls["n"] >= 4:
            raise Boom()
        calls["n"] += 1
        return real(self, block, **kw)

    monkeypatch.setattr(hdist.ShardedStatsSession, "feed_block", limited)
    with pytest.raises(Boom):
        hdist.run_stats_sharded(hopts(tmp_path / "b", checkpoint_path=ck,
                                      checkpoint_every=1))
    monkeypatch.undo()
    assert os.path.exists(ck + ".a") or os.path.exists(ck + ".b")

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 4)
        with caplog.at_level(logging.INFO, logger="hpgq"):
            devs = mesh.rank_devices(StatsOptions(in_filename=fq,
                                                  checkpoint_path=ck), "cuda")
    assert [str(d) for d in devs] == ["cuda"]
    assert "1 process on cuda: resuming a one-process checkpoint" \
        in caplog.text

    out = tmp_path / "port"
    out.mkdir()
    got = hpgq_torch.stats(fq, outdir=str(out), batch_size=256,
                           checkpoint=ck, sharded=True, device="cpu")
    assert got.equals(full)
    assert (got.num_passed, got.num_failed) == (full.num_passed,
                                                full.num_failed)
    assert not os.path.exists(ck + ".a") and not os.path.exists(ck + ".b")
    assert_same_tree(str(out), str(tmp_path / "a"), reports=True)
