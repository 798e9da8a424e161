"""Two ranks of the port's ``--sharded`` runs killed and resumed (gloo on
the CPU), and resumed across the two packages.

Mirrors of ``tests/test_multiproc.py``'s resume tests: both ranks die
mid-run after some checkpoints (``os._exit``); a second two-rank run
resumes from the rotating per-rank slots (``<path>.rank<i>.{a,b}``) at the
newest ordinal both ranks hold (stats, paired stats, cgr), or each rank
from its own ``<path>.rankNNNN`` (filter), and must end with ``hpgq``'s
single-process result, leaving no checkpoint behind.  Then the sharded
stats checkpoint crosses packages in both directions: ``hpgq``'s two JAX
processes write it and the port's two ranks resume it, and the other way
round.  The harness is ``tests/test_torch_multiproc.py``'s.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gen import make_fastq

import hpgq.pipeline.cgr_run as hcgr_run
import hpgq.pipeline.run as hrun
from hpgq_torch.utils.checkpoint import load_counters_checkpoint
from test_multiproc import _free_port
from test_torch_multiproc import (
    REPO,
    assert_same_counters,
    assert_same_tree,
    base_opts,
    hpgq_opts,
    run_ranks,
)

CRIT = dict(min_read_quality=18, max_read_quality=40)
CRASHES = {  # what dies, after how many calls, in each command
    "stats": ("hpgq_torch.pipeline.session", "StatsSession.feed_packed", 3),
    "paired": ("hpgq_torch.pipeline.session",
               "PairedStatsSession.feed_pair_packed", 3),
    "cgr": ("hpgq_torch.pipeline.cgr_run", "CgrSession.feed_block", 3),
    # two writes a block: at least two checkpoints before it dies
    "filter": ("hpgq_torch.io.fastq", "RecordBlock.write_selected", 6),
}


def _crash(command):
    module, attr, after = CRASHES[command]
    return dict(module=module, attr=attr, after=after, rank=None,
                how="exit")


@pytest.mark.parametrize("command", list(CRASHES))
def test_two_rank_crash_and_resume(tmp_path, command):
    inputs = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    for i, p in enumerate(inputs):
        make_fastq(p, 2400, min_len=40, max_len=110, n_prob=0.02,
                   seed=61 + i)
    if command != "paired":
        inputs = inputs[:1]
    cmd = "stats" if command == "paired" else command
    crit = None if command == "cgr" else CRIT
    extra = {"k": 4} if command == "cgr" else {}
    if cmd == "stats":
        extra["filter_on"] = True
    ck = str(tmp_path / "mp.ck.npz")
    opts = base_opts(inputs, tmp_path / "out", batch_size=200,
                     checkpoint_path=ck, checkpoint_every=1, **extra)
    rcs = run_ranks(tmp_path, "crash", cmd, opts, crit, expect_fail=True,
                    crash=_crash(command))
    assert 3 in rcs and all(rc != 0 for rc in rcs), rcs
    assert glob.glob(ck + ".rank*")
    results = run_ranks(tmp_path, "resume", cmd, opts, crit)
    assert not glob.glob(ck + ".rank*")
    ref = dict(opts, out_dirname=str(tmp_path / "ref"), batch_size=512,
               checkpoint_path=None)
    if cmd == "stats":
        assert_same_counters(results, hrun.run_stats(hpgq_opts(cmd, ref,
                                                               crit)))
        assert_same_tree(opts["out_dirname"], ref["out_dirname"],
                         reports=True)
    elif cmd == "cgr":
        want = hcgr_run.run_cgr(hpgq_opts(cmd, ref))
        for res in results:
            np.testing.assert_array_equal(res["tables"][0],
                                          want["table_seq"])
            np.testing.assert_array_equal(res["tables"][1], want["table_q"])
            assert res["tables"][2] == want["fq_word_count"]
        assert_same_tree(opts["out_dirname"], ref["out_dirname"])
    else:
        hrun.run_filter(hpgq_opts(cmd, ref, crit))
        assert_same_tree(opts["out_dirname"], ref["out_dirname"])
    # the resumed ranks read less than all of their ranges again
    assert all(r["batches"] < 6 for r in results), results


_HPGQ_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, fq, outdir, repo, ck, crash_after = sys.argv[1:8]
jax.distributed.initialize(coord, 2, int(pid))
sys.path.insert(0, repo)
from hpgq.dist import run_dist
from hpgq.options import StatsOptions

o = StatsOptions()
o.in_filename = fq
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
o.batch_size = 200
o.checkpoint_path = ck
o.checkpoint_every = 1
real = run_dist.ShardedStatsSession.feed_block
fed = [0]


def counted(self, block, **kw):
    if fed[0] >= int(crash_after):
        os._exit(3)
    fed[0] += 1
    return real(self, block, **kw)


run_dist.ShardedStatsSession.feed_block = counted
c = run_dist.run_stats_sharded(o)
print(json.dumps({"fed": fed[0], "num_reads": c.num_reads,
                  "acc_length": c.acc_length, "num_As": c.num_As,
                  "min_length": c.min_length, "max_length": c.max_length,
                  "qph_sum": int(c.acc_quality_per_nt.sum())}))
"""


def _hpgq_ranks(tmp_path, fq, ck, crash_after):
    """``hpgq``'s sharded stats as two JAX processes; each dies after
    ``crash_after`` blocks.  Returns the results or the exit codes."""
    worker = tmp_path / "hpgq_worker.py"
    worker.write_text(_HPGQ_WORKER)
    coord = "localhost:%d" % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    outdir = str(tmp_path / "hpgq_out")
    os.makedirs(outdir, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), coord, str(i), fq, outdir, REPO, ck,
         str(crash_after)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env) for i in range(2)]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=240)
            out.append((p.returncode, so.decode(), se.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


def _key(fq, rank):
    """The config key of ``hpgq``'s sharded stats checkpoint, no filter
    (``hpgq/dist/run_dist.py:1504-1509``)."""
    return json.dumps({"cmd": "stats-sharded", "in": os.path.abspath(fq),
                       "phred": 33, "kmers": False, "crit": None,
                       "rank": rank, "nprocs": 2}, sort_keys=True)


def _slots_hold_hpgq_keys(fq, ck):
    ordinals = []
    for rank in range(2):
        for slot in ("a", "b"):
            path = "%s.rank%d.%s" % (ck, rank, slot)
            if os.path.exists(path):
                _, _, extra = load_counters_checkpoint(path, _key(fq, rank))
                ordinals.append(int(extra["ordinal"]))
    return ordinals


@pytest.mark.parametrize("writer", ["hpgq", "port"])
def test_cross_package_sharded_resume(tmp_path, writer):
    """One package's two ranks die mid-run; the other package's two ranks
    resume their checkpoint (``hpgq``'s keys and slot names, the global
    carry added once) and end with the single-process counters, having
    fed fewer blocks than a whole range."""
    fq = str(tmp_path / "x.fq")
    make_fastq(fq, 2000, min_len=50, max_len=100, seed=61)
    ck = str(tmp_path / "x.ck.npz")
    opts = base_opts([fq], tmp_path / "out", batch_size=200,
                     checkpoint_path=ck, checkpoint_every=1)
    if writer == "hpgq":
        rcs = [rc for rc, _, _ in _hpgq_ranks(tmp_path, fq, ck, 3)]
    else:
        rcs = run_ranks(tmp_path, "crash", "stats", opts, expect_fail=True,
                        crash=_crash("stats"))
    assert 3 in rcs and all(rc != 0 for rc in rcs), rcs
    assert max(_slots_hold_hpgq_keys(fq, ck)) >= 1
    want = hrun.run_stats(hpgq_opts("stats", dict(
        opts, out_dirname=str(tmp_path / "ref"), batch_size=512,
        checkpoint_path=None)), report=False)
    if writer == "hpgq":
        results = run_ranks(tmp_path, "resume", "stats", opts)
        assert_same_counters(results, want)
        assert all(r["batches"] < 5 for r in results), results
    else:
        runs = _hpgq_ranks(tmp_path, fq, ck, 10 ** 6)
        for rc, so, se in runs:
            assert rc == 0, se[-3000:]
            got = json.loads(so.strip().splitlines()[-1])
            assert got.pop("fed") < 5, got
            assert got == {"num_reads": want.num_reads,
                           "acc_length": want.acc_length,
                           "num_As": want.num_As,
                           "min_length": want.min_length,
                           "max_length": want.max_length,
                           "qph_sum": int(want.acc_quality_per_nt.sum())}
    assert not glob.glob(ck + ".rank*")


def test_striped_input_runs_without_checkpoints(tmp_path):
    """Plain gzip over two ranks is striped, and a stripe cannot resume:
    the run logs ``hpgq``'s warning, writes no checkpoint and still gives
    the single-process counters."""
    fq = str(tmp_path / "s.fq.gz")
    make_fastq(fq, 1500, min_len=40, max_len=100, seed=5)
    ck = str(tmp_path / "s.ck.npz")
    opts = base_opts([fq], tmp_path / "out", batch_size=200,
                     checkpoint_path=ck, checkpoint_every=1)
    results = run_ranks(tmp_path, "g", "stats", opts)
    assert all("--checkpoint is not supported for striped (plain-gzip) "
               "multi-host input; running without checkpoints" in r["stderr"]
               for r in results)
    assert not glob.glob(ck + "*")
    assert_same_counters(results, hrun.run_stats(hpgq_opts("stats", dict(
        opts, out_dirname=str(tmp_path / "ref"), checkpoint_path=None))))
