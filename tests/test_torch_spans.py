"""The port's stage spans: each piece of the pipeline's work timed on the
thread that runs it (``inflate``, ``index``, ``pack``, ``h2d``), the
consumer's wait split by what it waits on (``wait-reader``,
``wait-pack``, inside ``read``), the fold inside ``compute``; each stage a
``stage.<name>`` range of a running torch profiler's trace, and no range
entered with no profiler running."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from gen import make_fastq

import hpgq_torch
from hpgq_torch.api import filter_criteria
from hpgq_torch.io.bgzf import write_bgzf
from hpgq_torch.io.fastq import FastqReader
from hpgq_torch.options import StatsOptions
from hpgq_torch.pipeline.run import _all_threads, run_stats
from hpgq_torch.utils.timers import StageTimers

FILTER = dict(read_length_range=(50, 200), read_quality_range=(20, 60),
              max_N=2)


@pytest.fixture
def pool(monkeypatch):
    """Two pack threads: the CPU runs the pack pool as a card's host does."""
    monkeypatch.setenv("HPGQ_PACK_THREADS", "2")


def _fastq(tmp_path, kind: str) -> str:
    """2000 reads of 60-120 bp, plain, gzip (level 1) or BGZF."""
    plain = str(tmp_path / "r.fq")
    if not os.path.exists(plain):
        make_fastq(plain, 2000, min_len=60, max_len=120, n_prob=0.01, seed=15)
    if kind == "plain":
        return plain
    with open(plain, "rb") as f:
        data = f.read()
    if kind == "bgzf":
        return write_bgzf(plain + ".bgz", data)
    with gzip.open(plain + ".gz", "wb", compresslevel=1) as g:
        g.write(data)
    return plain + ".gz"


def _opts(path: str, out: str, **kw) -> StatsOptions:
    os.makedirs(out, exist_ok=True)
    opts = StatsOptions(in_filename=path, out_dirname=out,
                        quality_encoding_name="phred33",
                        criteria=filter_criteria(**FILTER), filter_on=True,
                        **kw)
    opts.batch_size, opts.batch_size_set = 400, True
    return opts


def _stats(path: str, out: str, **kw):
    timers = StageTimers()
    counters = run_stats(_opts(path, out, **kw), timers, report=False,
                         device="cpu")
    return counters, timers.totals


def test_gzip_stats_times_every_stage(tmp_path, pool):
    """A gzip ``stats`` with a filter enters every stage of the pipeline;
    the consumer's two waits lie inside its ``read``, the fold inside
    ``compute``."""
    _, t = _stats(_fastq(tmp_path, "gzip"), str(tmp_path / "o"))
    for name in ("inflate", "index", "pack", "h2d", "read", "wait-reader",
                 "wait-pack", "compute", "fold"):
        assert t.get(name, 0) > 0, (name, t)
    assert t["wait-reader"] + t["wait-pack"] <= t["read"] + 1e-6, t
    assert t["fold"] <= t["compute"], t


@pytest.mark.parametrize("kind,inflates", [("plain", False), ("bgzf", True)])
def test_inflate_is_timed_where_the_input_is_compressed(tmp_path, pool, kind,
                                                        inflates):
    """A plain input has no ``inflate`` stage; a BGZF one has it, from the
    member pool, beside the index of the same chunks."""
    _, t = _stats(_fastq(tmp_path, kind), str(tmp_path / "o"))
    assert ("inflate" in t) == inflates, t
    assert t["index"] > 0 and t["pack"] > 0


def test_counters_equal_with_and_without_timers(tmp_path, pool):
    """The same blocks from a reader with and without timers, and the same
    counters from a pass that hands timers down, under a running profiler,
    as from the API's pass."""
    path = _fastq(tmp_path, "gzip")
    with FastqReader(path, batch_size=300) as bare, \
            FastqReader(path, batch_size=300, timers=StageTimers()) as timed:
        for a, b in zip(bare, timed, strict=True):
            assert a.buf[a.starts[0, 0]:] == b.buf[b.starts[0, 0]:]
            np.testing.assert_array_equal(a.starts, b.starts)
            np.testing.assert_array_equal(a.ends, b.ends)
    want = hpgq_torch.stats(path, outdir=str(tmp_path / "api"), device="cpu",
                            report=False, **FILTER)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got, _ = _stats(path, str(tmp_path / "o"))
    assert got.equals(want)


def test_no_profiler_no_range(tmp_path, pool, monkeypatch):
    """With no profiler running, a pass enters no ``record_function``;
    with one running, a stage does."""
    def refuse(name, *a, **k):
        raise RuntimeError("record_function entered: %s" % name)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, t = _stats(_fastq(tmp_path, "gzip"), str(tmp_path / "o"))
    assert t["inflate"] > 0 and t["wait-pack"] > 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="stage.fold"):
            with StageTimers().stage("fold"):
                pass


def test_profile_dir_puts_each_stage_on_its_thread(tmp_path, pool):
    """``--profile-dir`` on the CPU: the trace holds the program's
    ``stage.*`` ranges, the inflate, the index and the pack on threads
    other than the consumer's ``stage.read``, and each wait inside a
    ``stage.read`` of the consumer's thread."""
    if _all_threads() is None:
        pytest.skip("this torch traces the calling thread only")
    prof = str(tmp_path / "prof")
    _stats(_fastq(tmp_path, "gzip"), str(tmp_path / "o"), profile_dir=prof)
    (name,) = os.listdir(prof)
    with open(os.path.join(prof, name)) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("stage."):
            spans.setdefault(e["name"][6:], []).append(
                (e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    (consumer,) = {tid for tid, _, _ in spans["read"]}
    for stage in ("inflate", "index", "pack", "h2d"):
        assert consumer not in {tid for tid, _, _ in spans[stage]}, stage
    for stage in ("wait-reader", "wait-pack"):
        for tid, a, b in spans[stage]:
            assert tid == consumer
            assert any(r0 <= a and b <= r1 for _, r0, r1 in spans["read"])
