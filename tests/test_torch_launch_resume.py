"""How many ranks an unlaunched ``--sharded`` run gets
(``mesh.rank_devices``), a launched run that Ctrl-C stopped and its resume,
and a resume across the packages; a failed rank and a stopped parent are
in ``tests/test_torch_launch_signals.py``.

The world sizes: a launcher present, the CPU, one card, four cards,
checkpoint sets of one and of several processes, plain gzip.  Then
``hpgq``'s one-process mesh is interrupted as
``tests/test_dist.py::test_sharded_stats_resume`` interrupts it, and the
port resumes its checkpoint in one process and ends with ``hpgq``'s
uninterrupted counters and report.
"""

import glob
import json
import logging
import os
import signal

import pytest
import torch

from gen import make_fastq

import hpgq.dist.run_dist as hdist
import hpgq_torch
from hpgq.options import StatsOptions as HStatsOptions
from hpgq_torch.dist import launch, mesh
from hpgq_torch.options import CgrOptions, FilterOptions, StatsOptions
from hpgq_torch.pipeline import run as prun
from hpgq_torch.utils.checkpoint import save_counters_checkpoint
from test_torch_launch_signals import _nothing_left, _stopped_launch
from test_torch_multiproc import assert_same_tree


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


def test_ctrl_c_then_resume(tmp_path):
    """A launched ``stats`` with ``--checkpoint-every 1`` gets Ctrl-C (SIGINT
    to the group) once both ranks hold their first rotating checkpoint:
    nothing is left running and no report is written, but the checkpoint
    set stays.  A second launch resumes it, finishes, deletes the set,
    and writes the report of an uninterrupted run byte for byte."""
    from torch_rank_targets import run_jobs

    ck = str(tmp_path / "ck")
    opts = ("StatsOptions(in_filename=FQ, out_dirname=OUT, batch_size=300, "
            "checkpoint_path=CK, checkpoint_every=1), PIDS")
    code, err, secs, ranks, tmp = _stopped_launch(
        tmp_path, "stats_then_wait", opts, signal.SIGINT, group=True)
    _nothing_left(code, err, secs, ranks, tmp, tmp_path / "out")
    assert sorted(os.path.basename(p) for p in glob.glob(ck + ".rank*")) \
        == ["ck.rank0.a", "ck.rank1.a"]

    fq = str(tmp_path / "in.fq")
    resumed = StatsOptions(in_filename=fq, out_dirname=str(tmp_path / "out"),
                           batch_size=300, checkpoint_path=ck,
                           checkpoint_every=1)
    got = launch.launch(run_jobs, ([("stats", resumed)],), ["cpu", "cpu"])
    assert not glob.glob(ck + "*")
    (tmp_path / "whole").mkdir()
    want = prun.run_stats(StatsOptions(in_filename=fq,
                                       out_dirname=str(tmp_path / "whole"),
                                       batch_size=300), device="cpu")
    assert got["stats"][0].equals(want)
    assert_same_tree(str(tmp_path / "out"), str(tmp_path / "whole"))
