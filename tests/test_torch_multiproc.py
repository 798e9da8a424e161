"""Two ranks of the port's ``--sharded`` runs over gloo on the CPU.

Mirrors of ``tests/test_multiproc.py``: two subprocesses, each one rank of
a ``torch.distributed`` group made with a ``file://`` rendezvous under the
test's directory (so parallel test workers never race for a TCP port) and
a timeout, with ``jax``, ``jaxlib`` and ``hpgq`` blocked in both.  Each
run must give ``hpgq``'s single-process result on the same seeded input
(run here, JAX on the CPU): the same counters on both ranks (every
integer field exact, ``acc_quality`` as ``StatsCounters.equals``
compares it), the report that rank 0 alone writes byte-equal (the ``Mean
quality`` line to 1e-3 relative, as ``tests/test_torch_pipeline.py``
allows), every `filter`, `edit` and `prepro` output byte-equal, and the
CGR tables, PGM and ``.gs`` files equal.

New cases: tiers that differ by rank (rank 0 on the 2u wire, rank 1 on
6-bit), a rank with an empty range, a rank that fails, and the rule that a
rank's runner never opens its own shard readers.  The output commands
and ``cgr`` are in ``tests/test_torch_multiproc_output.py``, the resume
cases in ``tests/test_torch_multiproc_resume.py`` (one file each keeps
each test worker's share short).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gen import make_fastq, make_records, write_fastq

import hpgq.pipeline.run as hrun
from hpgq import options as hoptions
from hpgq_torch.utils.checkpoint import load_counters_checkpoint
from test_torch_pipeline import _normalize, _same_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import datetime, importlib, json, os, sys

repo, init_file, rank, world, job_file = sys.argv[1:6]
rank, world = int(rank), int(world)
for name in ("jax", "jaxlib", "hpgq"):  # the port needs none of them
    sys.modules[name] = None
sys.path.insert(0, repo)
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init_file,
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from hpgq_torch import options
from hpgq_torch.dist import run_dist
from hpgq_torch.kernels import step
from hpgq_torch.pipeline import run as prun
from hpgq_torch.utils.checkpoint import save_counters_checkpoint
from hpgq_torch.utils.timers import StageTimers

job = json.load(open(job_file))
cmd = job["cmd"]
o = getattr(options, job["options"])()
for k, v in job["opts"].items():
    setattr(o, k, v)
for k, v in job.get("crit", {}).items():
    setattr(o.criteria, k, v)
if job.get("batch_sizes"):
    o.batch_size = job["batch_sizes"][rank]
if cmd == "prepro":
    o.apply_trim_windows()
crash = job.get("crash")
if crash and crash["rank"] in (None, rank):
    holder = importlib.import_module(crash["module"])
    for part in crash["attr"].split(".")[:-1]:
        holder = getattr(holder, part)
    name = crash["attr"].split(".")[-1]
    real = getattr(holder, name)
    calls = [0]

    def limited(*a, **k):
        if calls[0] >= crash["after"]:
            if crash["how"] == "exit":
                print("CRASHING", flush=True)
                os._exit(3)
            raise RuntimeError("rank %d fails on purpose" % rank)
        calls[0] += 1
        return real(*a, **k)

    setattr(holder, name, limited)
if job.get("no_nested"):
    # shard readers would pay off here (forced), so a runner that ignored
    # its rank's range would split the whole file again: make it fail
    os.environ["HPGQ_READ_SHARDS"] = "3"
    prun._PARALLEL_MIN_BYTES = 0
    assert prun._output_parallel_eligible(o, torch.device("cpu"))

    def nested(*a, **k):
        raise AssertionError("shard readers nested inside a rank")

    for fn in ("_run_output_parallel", "_run_stats_parallel",
               "_run_stats_parallel_paired"):
        setattr(prun, fn, nested)
runner = {"stats": run_dist.run_stats_sharded,
          "filter": run_dist.run_filter_sharded,
          "edit": run_dist.run_edit_sharded,
          "prepro": run_dist.run_edit_sharded,
          "cgr": run_dist.run_cgr_sharded}[cmd]
timers = StageTimers()
res = runner(o, timers, device="cpu")
out = {"rank": rank, "tiers": dict(step.WIRE_BATCHES),
       "batches": timers.num_batches}
dump = os.path.join(job["dump"], "rank%d.npz" % rank)
if cmd == "stats":
    c1, c2 = res if isinstance(res, tuple) else (res, None)
    save_counters_checkpoint(dump, c1, 0, "dump", counters2=c2)
elif cmd == "cgr":
    np.savez(dump, table_seq=res["table_seq"], table_q=res["table_q"],
             words=res["fq_word_count"])
else:
    out.update({k: v for k, v in res.items() if k.startswith("num_")})
print(json.dumps(out))
dist.destroy_process_group()  # not left to the interpreter's exit
"""


def run_ranks(tmp_path, name, cmd, opts, crit=None, world=2,
              expect_fail=False, env=None, **job):
    """Run ``cmd`` as ``world`` ranks (subprocesses, gloo, ``file://``
    rendezvous); returns each rank's printed result and ``stderr``, with
    ``counters`` (stats: a ``(c1, c2)`` pair, c2 None single-end) or
    ``tables`` (cgr) loaded from its dump, or each rank's exit code when
    ``expect_fail``."""
    work = tmp_path / ("ranks_" + name)
    work.mkdir()
    worker = work / "worker.py"
    worker.write_text(_WORKER)
    options = {"stats": "StatsOptions", "filter": "FilterOptions",
               "edit": "EditOptions", "prepro": "PreproOptions",
               "cgr": "CgrOptions"}[cmd]
    (work / "job.json").write_text(json.dumps(dict(
        job, cmd=cmd, options=options, opts=opts, crit=crit or {},
        dump=str(work))))
    penv = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                         "LOCAL_WORLD_SIZE", "HPGQ_READ_SHARDS")}
    penv.update(HPGQ_CHARTS="off", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), REPO, str(work / "rendezvous"), str(r),
         str(world), str(work / "job.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=penv,
        cwd=str(work)) for r in range(world)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            if expect_fail:
                results.append(p.returncode)
                continue
            assert p.returncode == 0, err.decode()[-3000:]
            results.append(json.loads(out.decode().strip().splitlines()[-1]))
            results[-1]["stderr"] = err.decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for res in ([] if expect_fail else results):
        dump = str(work / ("rank%d.npz" % res["rank"]))
        if cmd == "stats":
            c1, _, extra = load_counters_checkpoint(dump, "dump")
            res["counters"] = (c1, extra.get("__counters2__"))
        elif cmd == "cgr":
            with np.load(dump) as z:
                res["tables"] = (z["table_seq"], z["table_q"],
                                 int(z["words"]))
    return results


def hpgq_opts(cmd, opts, crit=None):
    o = {"stats": hoptions.StatsOptions, "filter": hoptions.FilterOptions,
         "edit": hoptions.EditOptions, "prepro": hoptions.PreproOptions,
         "cgr": hoptions.CgrOptions}[cmd]()
    for k, v in opts.items():
        setattr(o, k, v)
    for k, v in (crit or {}).items():
        setattr(o.criteria, k, v)
    if cmd == "prepro":
        o.apply_trim_windows()
    os.makedirs(o.out_dirname, exist_ok=True)
    return o


def base_opts(inputs, outdir, batch_size=300, **kw):
    os.makedirs(str(outdir), exist_ok=True)
    return dict(in_filename=inputs[0],
                in_filename2=inputs[1] if len(inputs) > 1 else None,
                out_dirname=str(outdir), quality_encoding_value=33,
                quality_encoding_name="phred33", batch_size=batch_size, **kw)


def assert_same_counters(results, want):
    """Every rank's counters (both mates when paired) equal ``want``."""
    want = want if isinstance(want, tuple) else (want, None)
    for res in results:
        for got, w in zip(res["counters"], want):
            if w is None:
                assert got is None
                continue
            assert got.equals(w), res["rank"]
            assert (got.num_passed, got.num_failed) == (w.num_passed,
                                                        w.num_failed)


def assert_same_tree(got_dir, want_dir, reports=False):
    """The files of ``got_dir`` byte-equal to ``want_dir``'s (stats
    reports: after the output dir's name, and a ``Mean quality`` line to
    1e-3 relative)."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as f:
            got = _normalize(f.read(), got_dir)
        with open(os.path.join(want_dir, name), "rb") as f:
            want = _normalize(f.read(), want_dir)
        if reports:
            _same_report(got, want, name)
        else:
            assert got == want, name


CRIT = dict(min_read_quality=18, max_read_quality=40)


@pytest.mark.parametrize("mode", ["plain", "filtered"])
@pytest.mark.parametrize("compression", ["plain", "bgzf", "gzip"])
def test_two_rank_sharded_stats(tmp_path, mode, compression):
    """Byte ranges of a plain and a BGZF file, stripes of a plain-gzip
    one: the counters of both ranks and rank 0's report equal ``hpgq``'s
    single-process run."""
    fq = str(tmp_path / "in.fq")
    make_fastq(fq, 2500, min_len=40, max_len=110, n_prob=0.02, seed=17)
    if compression == "bgzf":
        from hpgq_torch.io.bgzf import write_bgzf

        with open(fq, "rb") as f:
            data = f.read()
        fq = str(tmp_path / "in.fq.bgz")
        write_bgzf(fq, data, block_size=8192)
    elif compression == "gzip":
        fq = str(tmp_path / "in.fq.gz")
        make_fastq(fq, 2500, min_len=40, max_len=110, n_prob=0.02, seed=17)
    crit = CRIT if mode == "filtered" else None
    opts = base_opts([fq], tmp_path / "out", filter_on=crit is not None)
    results = run_ranks(tmp_path, "s", "stats", opts, crit)
    ref = dict(opts, out_dirname=str(tmp_path / "ref"), batch_size=512)
    want = hrun.run_stats(hpgq_opts("stats", ref, crit))
    assert_same_counters(results, want)
    assert_same_tree(opts["out_dirname"], ref["out_dirname"], reports=True)


@pytest.mark.parametrize("corpus", ["2u+6bit", "2c"])
def test_two_rank_tiers_differ_by_rank(tmp_path, corpus):
    """The port's invariance test for ``hpgq``'s tier vote: each rank
    picks its own wire tier.  ``2u+6bit``: the first half of the file is
    RTA3-binned reads of one length (rank 0: the 2u wire), the second
    unbinned reads of many lengths (rank 1: 6-bit).  ``2c``: binned reads
    of many lengths with Ns on both ranks.  Merged counters equal
    ``hpgq``'s single-process ones, wire off."""
    fq = str(tmp_path / "in.fq")
    if corpus == "2u+6bit":
        recs = (make_records(1200, min_len=100, max_len=100, n_prob=0.02,
                             seed=41, qual_bins=(2, 12, 23, 37))
                + make_records(1200, min_len=40, max_len=110, n_prob=0.02,
                               seed=42))
        write_fastq(fq, recs)
        tiers = [{"2u"}, {"6bit"}]
    else:
        make_fastq(fq, 2400, min_len=40, max_len=110, n_prob=0.03, seed=43,
                   qual_bins=(2, 12, 23, 37))
        tiers = [{"2c"}, {"2c"}]
    opts = base_opts([fq], tmp_path / "out", filter_on=True)
    results = run_ranks(tmp_path, "t", "stats", opts, CRIT,
                        env={"HPGQ_WIRE": "bitpack"})
    assert [set(r["tiers"]) for r in results] == tiers
    ref = dict(opts, out_dirname=str(tmp_path / "ref"), batch_size=512)
    assert_same_counters(results, hrun.run_stats(hpgq_opts("stats", ref,
                                                           CRIT)))


@pytest.mark.parametrize("wire", ["bitpack", "off"])
def test_two_rank_unequal_batches_and_lengths(tmp_path, wire):
    """Mirror of ``test_two_process_voted_trimmed_shapes``: the ranks see
    different length regimes (rank 1 grows past 128 columns) and read in
    different batch sizes; nothing needs them to agree."""
    recs = (make_records(1200, min_len=40, max_len=70, seed=71)
            + make_records(1200, min_len=90, max_len=200, n_prob=0.02,
                           seed=72))
    fq = str(tmp_path / "v.fq")
    write_fastq(fq, recs)
    opts = base_opts([fq], tmp_path / "out")
    results = run_ranks(tmp_path, "v", "stats", opts,
                        batch_sizes=[250, 700], env={"HPGQ_WIRE": wire})
    ref = dict(opts, out_dirname=str(tmp_path / "ref"), batch_size=512)
    assert_same_counters(results, hrun.run_stats(hpgq_opts("stats", ref)))


@pytest.mark.parametrize("kmers", [False, True], ids=["plain", "kmers"])
def test_two_rank_sharded_paired_stats(tmp_path, kmers):
    """Mate ranges that cover the same records, the pair-consistent
    filter: both mates' counters and reports equal ``hpgq``'s paired
    run."""
    fq1, fq2 = str(tmp_path / "m1.fq"), str(tmp_path / "m2.fq")
    make_fastq(fq1, 2000, min_len=40, max_len=110, n_prob=0.02, seed=41)
    make_fastq(fq2, 2000, min_len=35, max_len=120, n_prob=0.02, seed=42)
    opts = base_opts([fq1, fq2], tmp_path / "out", filter_on=True,
                     kmers_on=kmers)
    results = run_ranks(tmp_path, "p", "stats", opts, CRIT)
    ref = dict(opts, out_dirname=str(tmp_path / "ref"), batch_size=512)
    assert_same_counters(results, hrun.run_stats(hpgq_opts("stats", ref,
                                                           CRIT)))
    assert_same_tree(opts["out_dirname"], ref["out_dirname"], reports=True)


OUTPUT_CASES = {
    "filter": dict(min_read_quality=18, max_read_quality=40, max_N=3),
    "edit": dict(left_length=8, min_left_quality=24, max_left_quality=60,
                 min_read_quality=18, max_read_quality=45),
    "prepro": {},
}


@pytest.mark.parametrize("cmd", ["stats", "filter"])
def test_rank_with_an_empty_range(tmp_path, cmd):
    """A file of one record over two ranks: rank 1's range is empty, yet
    it joins the merge (or the concatenation) and both give the
    single-process result."""
    from hpgq_torch.dist.mesh import split_byte_ranges

    fq = str(tmp_path / "one.fq")
    make_fastq(fq, 1, min_len=80, max_len=80, seed=3)
    (s, e), (s1, e1) = split_byte_ranges(fq, 2)
    assert s < e and s1 == e1
    crit = dict(min_read_quality=5, max_read_quality=60)
    opts = base_opts([fq], tmp_path / "out",
                     **({"filter_on": True} if cmd == "stats" else {}))
    results = run_ranks(tmp_path, "e", cmd, opts, crit)
    ref = dict(opts, out_dirname=str(tmp_path / "ref"))
    if cmd == "stats":
        want = hrun.run_stats(hpgq_opts(cmd, ref, crit))
        assert want.num_reads == 1
        assert_same_counters(results, want)
    else:
        hrun.run_filter(hpgq_opts(cmd, ref, crit))
        assert [r["num_passed"] + r["num_failed"] for r in results] == [1, 1]
    assert_same_tree(opts["out_dirname"], ref["out_dirname"],
                     reports=cmd == "stats")


@pytest.mark.parametrize("cmd", ["stats", "filter"])
def test_ranks_never_nest_shard_readers(tmp_path, cmd):
    """With shard readers forced on, a rank's runner still reads only its
    own range with one reader: the explicit range turns the in-process
    shard path off (nesting would split the whole file again)."""
    fq = str(tmp_path / "n.fq")
    make_fastq(fq, 2000, min_len=40, max_len=110, n_prob=0.02, seed=19)
    crit = OUTPUT_CASES["filter"]
    opts = base_opts([fq], tmp_path / "out",
                     **({"filter_on": True} if cmd == "stats" else {}))
    results = run_ranks(tmp_path, "n", cmd, opts, crit, no_nested=True)
    ref = dict(opts, out_dirname=str(tmp_path / "ref"), batch_size=512)
    if cmd == "stats":
        assert_same_counters(results, hrun.run_stats(hpgq_opts(cmd, ref,
                                                               crit)))
    else:
        hrun.run_filter(hpgq_opts(cmd, ref, crit))
        assert_same_tree(opts["out_dirname"], ref["out_dirname"])


def test_a_failing_rank_does_not_hang_the_other(tmp_path):
    """Rank 1 raises after two batches; rank 0, which finishes its range
    and waits at the merge, fails too (its peer's connection closes, or
    the group's timeout ends the wait) instead of waiting for ever."""
    fq = str(tmp_path / "f.fq")
    make_fastq(fq, 2000, min_len=40, max_len=110, seed=21)
    rcs = run_ranks(tmp_path, "f", "stats", base_opts([fq], tmp_path / "out",
                                                      batch_size=200),
                    expect_fail=True, crash=dict(
                        module="hpgq_torch.pipeline.session",
                        attr="StatsSession.feed_packed", after=2, rank=1,
                        how="raise"))
    assert all(rc != 0 for rc in rcs), rcs
    assert not any(n.endswith(".summary.txt")
                   for n in os.listdir(tmp_path / "out"))
