#!/usr/bin/env python3
"""A/B and profile studies of the hpgq_torch port on one device: the
port's counterpart of ``hpgq``'s seven measurement tools.

    python3 tools/ab_torch.py --study all                     # on cuda
    python3 tools/ab_torch.py --study wire2c --command stats,filter
    python3 tools/ab_torch.py --study all --device cpu --reads 2000 --rounds 2

Each study keeps its ``hpgq`` tool's corpus recipe (reads, lengths,
``n_prob``, seed, quality bins, file name under :data:`BENCH_DIR`:
``HPGQ_BENCH_DIR``, default the gitignored ``.bench/``), its command,
options and arms:

* ``engine_cfg`` (``tools/ab_engine_cfg.py``): ``HPGQ_READ_SHARDS`` 4/8/4/2
  x batch (reads and device rows) 131072/131072/262144/262144; ``stats`` +
  ``CRIT`` over the bench corpus, 1M x 100 bp RTA3-binned;
* ``coalesce`` (``tools/ab_coalesce.py``): ``HPGQ_COALESCE`` 0 vs 131072 at
  an explicit ``--batch-size`` 10000; ``stats`` with no filter and no
  report over 500k x 100 bp unbinned (seed 11); prints the dispatches;
* ``wire2c`` (``tools/ab_wire2c.py``): ``HPGQ_WIRE2C`` 0 vs 1; ``stats`` +
  ``CRIT`` over 1M x 100 bp RTA3-binned (seed 31); prints the wire bytes a
  read of the 2c, 2q and 2u packs of the first block;
* ``wire6`` (``tools/ab_wire6.py``): ``HPGQ_WIRE6`` 0 vs 1; ``stats`` with no
  filter over 1M x 60-160 bp (seed 29; ``--binned`` adds RTA3 bins);
* ``writer`` (``tools/ab_writer.py``): ``HPGQ_ASYNC_WRITES`` 0 vs 1;
  ``filter`` (quality 20-60, max N 2) and ``edit`` (left 10, quality
  28-60) over 500k x 60-160 bp (seed 17) at batch 131072;
* ``fixed`` (``tools/profile_fixed.py``): ``stats`` + ``CRIT`` over the
  bench corpus at 1/20, 1/5 and all of ``--reads`` (50k, 200k, 1M) and
  over the largest as gzip and BGZF; seconds, reads/s and stage totals of
  each, and the least-squares line of seconds against reads over the plain
  ones (flat cost a pass, marginal reads/s, residual);
* ``paired`` (``tools/profile_paired.py``): single-end against paired
  ``stats`` + ``CRIT`` over the 200k bench corpus (mate 2 seed 13): stage
  totals and batches of each, ``paired_vs_single_per_read``.

``--command`` runs an arm study's arms over other commands (``stats``,
``paired``, ``filter``, ``edit``, ``cgr``), each through this file's
pass of that command (``engine_*``, the port's production path) on the study's corpus (paired: its mate-2 twin, seed
13): ``stats`` and ``paired`` with the study's filter, ``filter`` with
``FILTER_CRIT``, ``edit`` (alone, no stats after) with ``EDIT_CRIT``,
``cgr`` the tables at k=7.  ``fixed`` and ``paired`` take no
``--command``.

Every arm runs one warm pass (the kernel build, the allocator, the page
cache), then ``--rounds`` rounds in turns, forward then backward.  Knobs are
set only inside ``mock.patch.dict(os.environ, ...)``, which puts the
environment back as it was.  A pass is timed on the host clock around work
that ends in ``torch.cuda.synchronize()``.  Each (study, command, corpus)
result is computed once by the single-CPU oracle (``oracle_*``:
``hpgq_torch/baseline.py``'s functions over the native packer pinned to
one thread; CGR by ``hpgq_torch.oracle.reference_cgr``), and every pass,
warm ones included, is held against it (counters equal, ``acc_quality`` to
1e-3 relative; output files byte-equal; tables equal): a mismatch raises
:class:`BenchMismatch` and exits 1.

Output, one JSON object a line: the card (``nvidia-smi``'s name and
power limit; null on the CPU); per study the corpus, each arm's warm pass
with the knobs the pipeline read under it (``knobs``) and the wire tiers
its passes took (``tiers``: ``step.WIRE_BATCHES`` of the stats sessions,
``session.FN_BATCHES`` of the verdict and trim steps, ``cgr_run.BATCHES``);
one line a round (every arm's reads/s and its ratio to the first arm); and
a ``summary`` line (each arm's median, spread and median same-round
ratio).  ``HPGQ_STRICT_CASE`` is read once, at import, so it is no arm.
"""

import argparse
import collections
import contextlib
import dataclasses
import filecmp
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]  # tests/gen.py: corpora

import numpy as np  # noqa: E402

from hpgq_torch.constants import DEFAULT_BATCH_SIZE  # noqa: E402
from hpgq_torch.core.accumulator import resolve_wire  # noqa: E402
from hpgq_torch.device import (  # noqa: E402
    gpu_name_and_power_limit,
    resolve_device,
)
from hpgq_torch.io.fastq import FastqReader  # noqa: E402
from hpgq_torch.io.packer import (  # noqa: E402
    round_up,
    try_pack_block_2c,
    try_pack_block_2u,
    try_pack_block_palette,
    wire_len,
)
from hpgq_torch.kernels import stats_cuda, step  # noqa: E402
from hpgq_torch.options import FilterCriteria, StatsOptions  # noqa: E402
from hpgq_torch.pipeline import cgr_run, run as pipeline, session  # noqa: E402
from hpgq_torch.utils.timers import StageTimers  # noqa: E402

BENCH_DIR = (os.environ.get("HPGQ_BENCH_DIR")
             or os.path.join(REPO, ".bench"))
PHRED = 33
RTA3_BINS = (2, 12, 23, 37)  # NovaSeq/NextSeq 4-level quality binning
CRIT = FilterCriteria(min_read_length=50, max_read_length=200,
                      min_read_quality=20, max_read_quality=60, max_N=2)
FILTER_CRIT = FilterCriteria(min_read_quality=20, max_read_quality=60,
                             max_N=2)  # the filter mode's subset of CRIT
EDIT_CRIT = FilterCriteria(left_length=10, min_left_quality=28,
                           max_left_quality=60)
CGR_K = 7


class BenchMismatch(Exception):
    """The engine's result differs from the oracle's."""


# ------------------------------------------------------------ corpora

def _make(path, n, **kw):
    """``tests/gen.make_fastq`` into ``path`` once (written under a
    temporary name, so a killed run leaves no partial corpus)."""
    from gen import make_fastq

    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part%d" % os.getpid()
        make_fastq(tmp, n, **kw)
        os.replace(tmp, path)
    return path


def recipe(n, read_len, shape, seed=7):
    """``make_records`` keywords of bench.py's corpus (``bench.py:77-89``)."""
    return dict(min_len=read_len, max_len=read_len, n_prob=0.005, seed=seed,
                qual_bins=RTA3_BINS if shape == "rta3" else None)


def gz_corpus(plain):
    import gzip

    path = plain + ".gz"
    if not os.path.exists(path):
        with open(plain, "rb") as f, gzip.open(path + ".part", "wb", 6) as g:
            shutil.copyfileobj(f, g, 4 << 20)
        os.replace(path + ".part", path)
    return path


def bgzf_corpus(plain):
    from hpgq_torch.io.bgzf import write_bgzf

    path = plain + ".bgz"
    if not os.path.exists(path):
        with open(plain, "rb") as f:
            write_bgzf(path + ".part", f.read())
        os.replace(path + ".part", path)
    return path


# ------------------------------------------------------------ the oracle

@contextlib.contextmanager
def single_cpu_pack():
    """The denominator is one CPU: the native packer's thread pool must
    not widen the oracle's pack (``bench.py:121-134``)."""
    from hpgq_torch.io import packer

    saved = packer._NUM_THREADS
    packer.set_num_threads(1)
    try:
        yield
    finally:
        packer._NUM_THREADS = saved


def _packed_blocks(path, batch_size):
    from hpgq_torch.io.fastq import FastqReader
    from hpgq_torch.io.packer import pack_block

    with single_cpu_pack(), FastqReader(path, batch_size=batch_size) as rd:
        for block in rd:
            yield block, pack_block(block)


def _filtered_stats(acc, packed, crit):
    """Fold one packed block's stats over the reads ``crit`` passes (every
    valid read, and no passed/failed tally, when ``crit`` is None)."""
    from hpgq_torch import baseline as bl

    codes, quals, lens, valid = packed
    if crit is None:
        return acc.merge(bl.block_stats(codes, quals, lens, valid,
                                        phred=PHRED)), valid
    ok = bl.block_verdicts(codes, quals, lens, crit, PHRED) & valid
    acc = acc.merge(bl.block_stats(codes, quals, lens, ok, phred=PHRED))
    acc.num_passed += int(ok.sum())
    acc.num_failed += int((valid & ~ok).sum())
    return acc, ok


def oracle_stats(path, batch_size, crit=CRIT):
    """``stats`` + ``crit``, one CPU: (reads, counters)."""
    from hpgq_torch.core.counters import StatsCounters

    acc = StatsCounters(phred=PHRED)
    n = 0
    for block, packed in _packed_blocks(path, batch_size):
        acc, _ = _filtered_stats(acc, packed, crit)
        n += block.num_reads
    return n, acc


def lockstep_pairs(r1, r2):
    """Both mates' blocks re-sliced to common record ranges on this thread
    (``bench.py:454-474``): the oracle's pairs, without the engine's
    read-ahead threads."""
    i1, i2 = iter(r1), iter(r2)
    b1 = b2 = None
    p1 = p2 = 0
    while True:
        if b1 is None or p1 >= b1.num_reads:
            b1 = next(i1, None)
            p1 = 0
        if b2 is None or p2 >= b2.num_reads:
            b2 = next(i2, None)
            p2 = 0
        if b1 is None or b2 is None:
            return
        n = min(b1.num_reads - p1, b2.num_reads - p2)
        yield b1.slice(p1, p1 + n), b2.slice(p2, p2 + n)
        p1 += n
        p2 += n


def oracle_paired(path1, path2, batch_size, crit=CRIT):
    """Paired ``stats`` + ``crit``, one CPU: (reads of both mates, (c1,
    c2)); a pair counts when both mates pass, tallies per pair (every
    pair counts, and no tally, when ``crit`` is None)."""
    from hpgq_torch import baseline as bl
    from hpgq_torch.core.counters import StatsCounters
    from hpgq_torch.io.fastq import FastqReader
    from hpgq_torch.io.packer import pack_block

    acc = [StatsCounters(phred=PHRED), StatsCounters(phred=PHRED)]
    pairs = passed = 0
    with single_cpu_pack(), FastqReader(path1, batch_size=batch_size) as r1, \
            FastqReader(path2, batch_size=batch_size) as r2:
        for b1, b2 in lockstep_pairs(r1, r2):
            p = [pack_block(b1), pack_block(b2)]
            both = p[0][3] & p[1][3]
            for codes, quals, lens, _ in p:
                if crit is not None:
                    both &= bl.block_verdicts(codes, quals, lens, crit, PHRED)
            for i, (codes, quals, lens, _) in enumerate(p):
                acc[i] = acc[i].merge(bl.block_stats(codes, quals, lens, both,
                                                     phred=PHRED))
            pairs += b1.num_reads
            passed += int(both.sum())
    if crit is not None:
        for c in acc:
            c.num_passed, c.num_failed = passed, pairs - passed
    return 2 * pairs, tuple(acc)


def _emit_spans(fh, block, starts, ends):
    fh.write(b"".join(block.buf[int(s):int(e)] for s, e in zip(starts, ends)))


def oracle_filter(path, batch_size, outdir):
    """``filter`` with ``FILTER_CRIT``, one CPU, writing both files
    (``bench.py:399-421``): (reads, {name: path})."""
    from hpgq_torch import baseline as bl

    files = {"passed.fq": os.path.join(outdir, "o_passed.fq"),
             "failed.fq": os.path.join(outdir, "o_failed.fq")}
    n = 0
    with open(files["passed.fq"], "wb") as pw, \
            open(files["failed.fq"], "wb") as fw:
        for block, (codes, quals, lens, valid) in _packed_blocks(
                path, batch_size):
            ok = bl.block_verdicts(codes, quals, lens, FILTER_CRIT,
                                   PHRED) & valid
            for sel, fh in ((ok, pw), (~ok, fw)):
                starts, ends, k = block.selected_spans(sel[:block.num_reads])
                if k:
                    _emit_spans(fh, block, starts, ends)
            n += block.num_reads
    return n, files


def oracle_edit(path, batch_size, outdir, restats=True):
    """Config #3, one CPU: trim with ``EDIT_CRIT``, write ``edit.fq``,
    then the stats of what was written (``bench.py:424-451``): (reads,
    ({"edit.fq": path}, counters)); ``restats=False`` stops after the
    trims (counters None), the ``edit`` command alone."""
    from hpgq_torch import baseline as bl
    from hpgq_torch.core.counters import StatsCounters

    epath = os.path.join(outdir, "o_edit.fq")
    n = 0
    with open(epath, "wb") as ew:
        for block, (_, quals, lens, _) in _packed_blocks(path, batch_size):
            lt, rt = bl.block_trims(quals, lens, EDIT_CRIT, PHRED)
            starts, ends, k = block.trimmed_spans(lt[:block.num_reads],
                                                  rt[:block.num_reads])
            if k:
                _emit_spans(ew, block, starts, ends)
            n += block.num_reads
    if not restats:
        return n, ({"edit.fq": epath}, None)
    acc = StatsCounters(phred=PHRED)
    for _, (codes, quals, lens, valid) in _packed_blocks(epath, batch_size):
        acc = acc.merge(bl.block_stats(codes, quals, lens, valid,
                                       phred=PHRED))
    return n, ({"edit.fq": epath}, acc)


def oracle_cgr(path):
    """The CGR tables at k=7 by the reference's per-nucleotide loop, one
    CPU: (reads, (table_seq, table_q, words))."""
    from hpgq_torch.baseline import fill_tables_loop

    ts = tq = None
    words = n = 0
    for block, (codes, quals, lens, valid) in _packed_blocks(path, 10_000):
        a, b, w = fill_tables_loop(codes, quals, lens, valid, CGR_K, PHRED)
        ts, tq = (a, b) if ts is None else (ts + a, tq + b)
        words += w
        n += block.num_reads
    return n, (ts, tq, words)


def oracle_cgr_tables(path):
    """The CGR tables at k=7 of every read of the plain FASTQ ``path`` by
    the vectorised reference (``hpgq_torch.oracle.reference_cgr``, held
    equal to the loop by the tests): for corpora too large for the loop's
    ~5,000 reads/s.  (reads, (table_seq, table_q, words))."""
    from hpgq_torch.oracle import reference_cgr

    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    records = list(zip(lines[0::4], lines[1::4], lines[3::4]))
    return len(records), reference_cgr(records, CGR_K, PHRED)


# ------------------------------------------------------------ the engine

def _options(cls, path, outdir, batch_size, crit=None, path2=None, **kw):
    o = cls(in_filename=path, in_filename2=path2, out_dirname=outdir,
            quality_encoding_value=PHRED, quality_encoding_name="phred33",
            batch_size=batch_size, **kw)
    if crit is not None:
        o.criteria = dataclasses.replace(crit)
        o.filter_on = True
    return o


def engine_stats(path, outdir, batch_size, batch_reads, dev, crit=CRIT,
                 timers=None, report=True, **kw):
    """The headline's pass (``bench.py:172-198``): ``run_stats`` with
    ``crit``, reports written unless ``report=False``; ``kw`` are more
    ``StatsOptions`` fields.  (reads, counters)."""
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.pipeline.run import run_stats

    c = run_stats(_options(StatsOptions, path, outdir, batch_size, crit,
                           device_batch_reads=batch_reads, **kw), timers,
                  report=report, device=dev)
    return c.num_reads + c.num_failed, c


def engine_paired(path1, path2, outdir, batch_size, dev, crit=CRIT,
                  timers=None, **kw):
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.pipeline.run import run_stats

    c1, c2 = run_stats(_options(StatsOptions, path1, outdir, batch_size, crit,
                                path2=path2, **kw), timers, device=dev)
    return 2 * (c1.num_reads + c1.num_failed), (c1, c2)


def engine_filter(path, outdir, batch_size, dev, timers=None, **kw):
    from hpgq_torch.options import FilterOptions
    from hpgq_torch.pipeline.run import run_filter

    r = run_filter(_options(FilterOptions, path, outdir, batch_size,
                            FILTER_CRIT, **kw), timers, device=dev)
    return r["num_passed"] + r["num_failed"], {
        "passed.fq": r["passed_filename"], "failed.fq": r["failed_filename"]}


def engine_edit(path, outdir, batch_size, dev, timers=None, restats=True,
                **kw):
    """Config #3 (``bench.py:530-559``): ``run_edit`` then ``run_stats``
    over ``edit.fq``; ``restats=False`` runs ``edit`` alone (counters
    None)."""
    from hpgq_torch.options import EditOptions, StatsOptions
    from hpgq_torch.pipeline.run import run_edit, run_stats
    from hpgq_torch.utils.timers import StageTimers

    timers = timers or StageTimers()
    r = run_edit(_options(EditOptions, path, outdir, batch_size, EDIT_CRIT,
                          filter_on=False, **kw), timers, device=dev)
    files = {"edit.fq": r["edit_filename"]}
    if not restats:
        return timers.total_reads, (files, None)
    c = run_stats(_options(StatsOptions, r["edit_filename"], outdir,
                           batch_size), device=dev)
    return c.num_reads, (files, c)


def engine_cgr(path, batch_size, dev):
    """The CGR tables at k=7 through ``CgrSession`` over the reader's
    blocks (``bench.py:596-610``): (reads, (table_seq, table_q, words))."""
    from hpgq_torch.io.fastq import FastqReader
    from hpgq_torch.pipeline.cgr_run import CgrSession
    from hpgq_torch.utils.timers import StageTimers

    timers = StageTimers()
    sess = CgrSession(CGR_K, PHRED, batch_size, dev)
    with FastqReader(path, batch_size=batch_size) as rd:
        sess.feed_all(rd, timers)
    return timers.total_reads, (sess.table_seq, sess.table_q,
                                sess.word_count)


# ------------------------------------------------------------ the checks

def check_counters(got, want, label):
    from hpgq_torch.oracle import assert_counters_equal

    try:
        assert_counters_equal(got, want, label)
    except AssertionError as e:
        raise BenchMismatch(str(e)) from None


def check_files(got, want, label):
    """``got`` and ``want`` map file names to paths: the same names, and
    every file byte-equal."""
    if sorted(got) != sorted(want):
        raise BenchMismatch("%s: files %s, the oracle's %s"
                            % (label, sorted(got), sorted(want)))
    for name in want:
        if not filecmp.cmp(got[name], want[name], shallow=False):
            raise BenchMismatch("%s: %s differs from the oracle's"
                                % (label, name))


def check_tables(got, want, label):
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and int(got[2]) == int(want[2])):
        raise BenchMismatch("%s: CGR tables or word count differ from the "
                            "oracle's" % label)


def check_result(cmd, got, want, label):
    """Raises :class:`BenchMismatch` unless a pass of ``cmd`` ("stats",
    "paired", "filter", "edit" or "cgr") gave the oracle's result."""
    if cmd == "stats":
        check_counters(got, want, label)
    elif cmd == "paired":
        for mate, g, w in zip((1, 2), got, want):
            check_counters(g, w, "%s, mate %d" % (label, mate))
    elif cmd == "filter":
        check_files(got, want, label)
    elif cmd == "edit":
        check_files(got[0], want[0], label)
        if want[1] is not None:
            check_counters(got[1], want[1], label + ", stats over edit.fq")
    else:
        check_tables(got, want, label)


def sync(dev):
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def timed(fn, dev):
    """(seconds, reads, result) of ``fn() -> (reads, result)``."""
    t0 = time.perf_counter()
    n, res = fn()
    sync(dev)
    return time.perf_counter() - t0, n, res


# ------------------------------------------------------------ studies

COMMANDS = ("stats", "paired", "filter", "edit", "cgr")
B131, B262 = 131072, 262144
MATE2_SEED = 13  # bench.py's mate 2


@dataclasses.dataclass
class Corpus:
    """A generated FASTQ under :data:`BENCH_DIR`, written once."""

    name: str
    n: int
    kw: dict
    mate2_name: str = None

    def path(self):
        return _make(os.path.join(BENCH_DIR, self.name), self.n, **self.kw)

    def mate2(self):
        name = self.mate2_name or self.name[:-3] + "_mate2.fq"
        return _make(os.path.join(BENCH_DIR, name), self.n,
                     **dict(self.kw, seed=MATE2_SEED))


def bench_corpus(n):
    """``bench.py``'s corpus, ``n`` x 100 bp RTA3-binned, and its mate-2
    file."""
    return Corpus("bench_%d_100_rta3.fq" % n, n, recipe(n, 100, "rta3"),
                  "bench_mate2_%d_rta3.fq" % n)


@dataclasses.dataclass
class Arm:
    label: str
    env: dict
    kw: dict = dataclasses.field(default_factory=dict)  # pass settings


@dataclasses.dataclass
class Study:
    """One ``hpgq`` tool's work: corpus, command(s), pass settings, arms."""

    name: str
    ports: str
    reads: int
    corpus: object          # reads -> Corpus
    commands: tuple
    arms: list
    crit: object = dataclasses.field(  # the filter of stats and paired
        default_factory=lambda: CRIT)
    settings: dict = dataclasses.field(default_factory=dict)


def _shards(label, n, batch):
    return Arm(label, {"HPGQ_READ_SHARDS": str(n)},
               {"batch_size": batch, "batch_reads": batch})


def studies(binned=False):
    """The five arm studies, by name."""
    pair = (("off", "0"), ("on", "1"))
    return {s.name: s for s in (
        Study("engine_cfg", "tools/ab_engine_cfg.py", 1_000_000, bench_corpus,
              ("stats",), [_shards("sh4_b131", 4, B131),
                           _shards("sh8_b131", 8, B131),
                           _shards("sh4_b262", 4, B262),
                           _shards("sh2_b262", 2, B262)]),
        Study("coalesce", "tools/ab_coalesce.py", 500_000,
              lambda n: Corpus("abco_%d.fq" % n, n, dict(
                  min_len=100, max_len=100, n_prob=0.005, seed=11)),
              ("stats",), [Arm("off", {"HPGQ_COALESCE": "0"}),
                           Arm("auto", {"HPGQ_COALESCE": "131072"})],
              crit=None, settings=dict(batch_size=10000, batch_size_set=True,
                                       report=False)),
        Study("wire2c", "tools/ab_wire2c.py", 1_000_000,
              lambda n: Corpus("ab2c_%d_rta3.fq" % n, n, dict(
                  min_len=100, max_len=100, n_prob=0.005, seed=31,
                  qual_bins=RTA3_BINS)),
              ("stats",), [Arm(a, {"HPGQ_WIRE2C": v}) for a, v in pair]),
        Study("wire6", "tools/ab_wire6.py", 1_000_000,
              lambda n: Corpus("abw6_%d%s.fq" % (n, "_rta3" * binned), n, dict(
                  min_len=60, max_len=160, n_prob=0.005, seed=29,
                  qual_bins=RTA3_BINS if binned else None)),
              ("stats",), [Arm(a, {"HPGQ_WIRE6": v}) for a, v in pair],
              crit=None),
        Study("writer", "tools/ab_writer.py", 500_000,
              lambda n: Corpus("abw_%d.fq" % n, n, dict(
                  min_len=60, max_len=160, n_prob=0.005, seed=17)),
              ("filter", "edit"),
              [Arm(a, {"HPGQ_ASYNC_WRITES": v}) for a, v in pair],
              settings=dict(batch_size=B131, batch_size_set=True)),
    )}


# ------------------------------------------------------------ passes

def _split(settings):
    """(batch size, device rows, reports on?, the rest as options
    fields)."""
    kw = dict(settings)
    return (kw.pop("batch_size", DEFAULT_BATCH_SIZE),
            kw.pop("batch_reads", 0), kw.pop("report", True), kw)


def engine(cmd, study_crit, paths, out, dev, settings, timers):
    """The ``engine_*`` pass of ``cmd``: (reads, result)."""
    batch, rows, report, kw = _split(settings)
    if cmd == "stats":
        return engine_stats(paths[0], out, batch, rows, dev, study_crit,
                            timers, report=report, **kw)
    if cmd == "paired":
        return engine_paired(paths[0], paths[1], out, batch, dev,
                             study_crit, timers, device_batch_reads=rows,
                             **kw)
    if cmd == "filter":
        return engine_filter(paths[0], out, batch, dev, timers,
                             device_batch_reads=rows, **kw)
    if cmd == "edit":
        return engine_edit(paths[0], out, batch, dev, timers,
                           restats=False, device_batch_reads=rows, **kw)
    return engine_cgr(paths[0], batch, dev)


def oracle(cmd, study_crit, paths, out):
    """The single-CPU oracle's result of ``cmd``."""
    if cmd == "stats":
        return oracle_stats(paths[0], B131, study_crit)[1]
    if cmd == "paired":
        return oracle_paired(paths[0], paths[1], B131, study_crit)[1]
    if cmd == "filter":
        return oracle_filter(paths[0], B131, out)[1]
    if cmd == "edit":
        return oracle_edit(paths[0], B131, out, restats=False)[1]
    return oracle_cgr_tables(paths[0])[1]


def knobs(cmd, paths, dev, settings):
    """What the pipeline reads of the knobs, under the environment as it
    is now, for a pass of ``cmd`` (its own functions decide)."""
    seen = {"wire": resolve_wire(None, dev) or "plain"}
    if cmd == "cgr":
        return seen
    batch, rows, _, kw = _split(settings)
    opts = _options(StatsOptions, paths[0], None, batch,
                    path2=paths[1] if cmd == "paired" else None,
                    device_batch_reads=rows, **kw)
    seen.update(read_shards=pipeline._read_shards(),
                sharded=pipeline._output_parallel_eligible(opts, dev),
                coalesce_reads=pipeline._coalesce_reads(opts, dev),
                pack_threads=pipeline._pack_workers())
    return seen


def _snapshot():
    """The tier and launch counters as they stand (never reset here: a
    caller may be counting launches over a whole run)."""
    tiers = collections.Counter()
    for what, counter in (("stats", step.WIRE_BATCHES),
                          ("fn", session.FN_BATCHES),
                          ("cgr", cgr_run.BATCHES)):
        for key, n in list(counter.items()):
            tier = key[-1] if isinstance(key, tuple) else key
            tiers["%s %s" % (what, tier)] += n
    launches = collections.Counter({
        "K1": stats_cuda.LAUNCHES, "K1 2u": stats_cuda.LAUNCHES_2U,
        "K2": stats_cuda.LAUNCHES_K2})
    return tiers, launches


class Runner:
    """One run's device, rounds and output."""

    def __init__(self, dev, rounds, emit=None):
        self.dev = dev
        self.rounds = rounds
        self.emit = emit or (lambda obj: print(json.dumps(obj), flush=True))
        self.tmp = tempfile.mkdtemp(prefix="hpgq_torch_ab_")
        self.oracles = {}
        self.launches = collections.Counter()

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)

    def outdir(self, *parts):
        d = os.path.join(self.tmp, *parts)
        os.makedirs(d, exist_ok=True)
        return d

    def want(self, cmd, crit, paths):
        """The oracle's result of (command, filter, corpus), once."""
        key = (cmd, None if crit is None else dataclasses.astuple(crit),
               tuple(paths))
        if key not in self.oracles:
            out = self.outdir("oracle%d" % len(self.oracles))
            self.oracles[key] = oracle(cmd, crit, paths, out)
        return self.oracles[key]

    def one(self, cmd, crit, paths, out, env, settings, label):
        """One pass under ``env``, held against the oracle: (seconds,
        reads, timers, knobs seen, tiers, launches)."""
        want = self.want(cmd, crit, paths)
        timers = StageTimers()
        with mock.patch.dict(os.environ, env):
            seen = knobs(cmd, paths, self.dev, settings)
            t0, l0 = _snapshot()
            secs, n, got = timed(lambda: engine(
                cmd, crit, paths, out, self.dev, settings, timers), self.dev)
            t1, l1 = _snapshot()
        check_result(cmd, got, want, label)
        self.launches.update(l1 - l0)
        return secs, n, timers, seen, dict(t1 - t0), dict(l1 - l0)

    # -------------------------------------------------------- arm studies

    def arm_study(self, st, reads, cmd):
        """``st``'s arms over ``cmd``; returns the summary line."""
        corpus = st.corpus(reads)
        paths = [corpus.path()] + ([corpus.mate2()] if cmd == "paired"
                                   else [])
        self.emit({"study": st.name, "ports": st.ports, "command": cmd,
                   "corpus": [os.path.basename(p) for p in paths],
                   "reads": corpus.n})
        if st.name == "wire2c":
            self.emit(dict(wire_bytes(paths[0]), study="wire2c"))
        tiers = {a.label: collections.Counter() for a in st.arms}
        launches = {a.label: collections.Counter() for a in st.arms}
        batches = {a.label: [] for a in st.arms}

        def run(arm, rnd):
            settings = dict(st.settings, **arm.kw)
            s, n, timers, seen, t, k = self.one(
                cmd, st.crit, paths, self.outdir(st.name, cmd, arm.label),
                arm.env, settings, "%s %s %s round %s" % (st.name, cmd,
                                                          arm.label, rnd))
            tiers[arm.label].update(t)
            launches[arm.label].update(k)
            batches[arm.label].append(timers.num_batches)
            return s, n, seen

        for arm in st.arms:
            s, n, seen = run(arm, "warm")
            self.emit({"study": st.name, "command": cmd, "arm": arm.label,
                       "env": arm.env, "warm_s": round(s, 4), "reads": n,
                       "knobs": seen, "tiers": dict(tiers[arm.label]),
                       "dispatches": batches[arm.label][-1]})
        rps = {a.label: [] for a in st.arms}
        first = st.arms[0].label
        for r in range(self.rounds):
            row = {}
            for arm in in_turns(st.arms, r):
                s, n, _ = run(arm, r)
                row[arm.label] = n / s
                rps[arm.label].append(n / s)
            self.emit({"study": st.name, "command": cmd, "round": r,
                       "reads_per_sec": {a: round(v, 1)
                                         for a, v in row.items()},
                       "ratio": {a: round(v / row[first], 4)
                                 for a, v in row.items()}})
        summary = {"summary": st.name, "command": cmd, "rounds": self.rounds,
                   "reads": corpus.n, "first_arm": first, "arms": {}}
        for arm in st.arms:
            v = rps[arm.label]
            summary["arms"][arm.label] = {
                "env": arm.env,
                "median_reads_per_sec": _med(v),
                "spread": [round(min(v), 1), round(max(v), 1)] if v else None,
                "median_ratio": _med([x / y for x, y in zip(v, rps[first])],
                                     4),
                "tiers": dict(tiers[arm.label]),
                "launches": {k: n for k, n in launches[arm.label].items()
                             if n},
                "dispatches": sorted(set(batches[arm.label])),
            }
        self.emit(summary)
        return summary

    # -------------------------------------------------------- profiles

    def profile(self, cmd, paths, out, label, batch=B131):
        s, n, timers, _, tiers, _ = self.one(
            cmd, CRIT, paths, out, {},
            {"batch_size": batch, "batch_reads": batch}, label)
        return {"reads": n, "s": round(s, 4), "reads_per_sec": round(n / s, 1),
                "stages": {k: round(v, 4)
                           for k, v in sorted(timers.totals.items())},
                "batches": timers.num_batches, "tiers": tiers}

    def fixed(self, reads):
        """``tools/profile_fixed.py``: a pass's flat cost and marginal
        rate; returns the summary line."""
        sizes = sorted({max(1, reads // 20), max(1, reads // 5), reads})
        plain = {n: bench_corpus(n).path() for n in sizes}
        big = plain[sizes[-1]]
        corpora = dict(("%d" % n, p) for n, p in plain.items())
        corpora.update(gz=gz_corpus(big), bgzf=bgzf_corpus(big))
        self.emit({"study": "fixed", "ports": "tools/profile_fixed.py",
                   "command": "stats", "corpus": {
                       k: os.path.basename(p) for k, p in corpora.items()}})
        out = self.outdir("fixed")
        items = list(corpora.items())
        for tag, p in items:
            w = self.profile("stats", [p], out, "fixed stats %s warm" % tag)
            self.emit({"study": "fixed", "corpus": tag, "warm": w})
        runs = {tag: [] for tag, _ in items}
        for r in range(self.rounds):
            row = {"study": "fixed", "round": r}
            for tag, p in in_turns(items, r):
                row[tag] = self.profile("stats", [p], out,
                                        "fixed stats %s round %d" % (tag, r))
                runs[tag].append(row[tag])
            self.emit(row)
        summary = {"summary": "fixed", "rounds": self.rounds, "sizes": {}}
        for tag, rr in runs.items():
            summary["sizes"][tag] = {
                "reads": rr[0]["reads"] if rr else None,
                "median_s": _med([x["s"] for x in rr], 4),
                "median_reads_per_sec": _med([x["reads_per_sec"]
                                              for x in rr]),
                "spread": _spread([x["reads_per_sec"] for x in rr]),
                "median_stages": _median_stages(rr)}
        summary["fit"] = fit([(x["reads"], x["s"]) for n in sizes
                              for x in runs["%d" % n]])
        self.emit(summary)
        return summary

    def paired(self, reads):
        """``tools/profile_paired.py``: single-end against paired, by
        stage; returns the summary line."""
        corpus = bench_corpus(reads)
        paths = [corpus.path(), corpus.mate2()]
        self.emit({"study": "paired", "ports": "tools/profile_paired.py",
                   "command": "stats, paired stats",
                   "corpus": [os.path.basename(p) for p in paths],
                   "reads": corpus.n})
        out = self.outdir("paired")
        arms = [("single", "stats", paths[:1]), ("paired", "paired", paths)]
        for tag, cmd, p in arms:
            self.emit({"study": "paired", "arm": tag,
                       "warm": self.profile(cmd, p, out,
                                            "paired %s %s warm" % (cmd, tag))})
        runs = {"single": [], "paired": []}
        for r in range(self.rounds):
            row = {"study": "paired", "round": r}
            for tag, cmd, p in in_turns(arms, r):
                row[tag] = self.profile(cmd, p, out, "paired %s %s round %d"
                                        % (cmd, tag, r))
                runs[tag].append(row[tag])
            row["paired_vs_single_per_read"] = round(
                row["single"]["reads_per_sec"]
                / row["paired"]["reads_per_sec"], 4)
            self.emit(row)
        summary = {"summary": "paired", "rounds": self.rounds,
                   "paired_vs_single_per_read": _med(
                       [a["reads_per_sec"] / b["reads_per_sec"] for a, b in
                        zip(runs["single"], runs["paired"])], 4)}
        for tag, rr in runs.items():
            summary[tag] = {
                "median_reads_per_sec": _med([x["reads_per_sec"]
                                              for x in rr]),
                "spread": _spread([x["reads_per_sec"] for x in rr]),
                "median_stages": _median_stages(rr),
                "batches": sorted({x["batches"] for x in rr})}
        self.emit(summary)
        return summary


# ------------------------------------------------------------ helpers

def in_turns(items, r):
    """``items`` forward on even rounds, backward on odd ones."""
    return list(items) if r % 2 == 0 else list(items)[::-1]


def _med(v, nd=1):
    return round(statistics.median(v), nd) if v else None


def _spread(v):
    return [round(min(v), 1), round(max(v), 1)] if v else None


def _median_stages(runs):
    keys = sorted({k for x in runs for k in x["stages"]})
    return {k: _med([x["stages"].get(k, 0.0) for x in runs], 4) for k in keys}


def fit(points):
    """Least squares of seconds against reads: the flat seconds a pass
    pays, the marginal reads/s, and the residual's root mean square and
    largest size."""
    if len({n for n, _ in points}) < 2:
        return None
    x = np.array([n for n, _ in points], float)
    y = np.array([s for _, s in points], float)
    slope, flat = np.polyfit(x, y, 1)
    res = y - (flat + slope * x)
    return {"flat_s": round(float(flat), 4),
            "s_per_million_reads": round(float(slope) * 1e6, 4),
            "marginal_reads_per_sec": (round(float(1 / slope), 1)
                                       if slope > 0 else None),
            "residual_rms_s": round(float(np.sqrt(np.mean(res ** 2))), 4),
            "residual_max_s": round(float(np.abs(res).max()), 4),
            "points": len(points)}


def wire_bytes(path):
    """Wire bytes a read of the first reader block packed as 2c, 2q and
    2u (what ``HPGQ_WIRE2C`` switches between; ``ab_wire2c.py:69-86``)."""
    with mock.patch.dict(os.environ, {"HPGQ_WIRE2C": "1"}), \
            FastqReader(path, batch_size=B131) as rd:
        first = next(iter(rd))
        wl = wire_len(first.max_len(), round_up(first.max_len(), 128))
        p2c = try_pack_block_2c(first, wl)
        p2q = try_pack_block_palette(first, wl)
        p2u = try_pack_block_2u(first)
    n = first.num_reads
    out = {"wire_block_reads": n}
    if p2c is not None:
        out["wire_bytes_per_read_2c"] = round((p2c[0].nbytes
                                               + p2c[1].nbytes) / n, 3)
    if p2q is not None:
        out["wire_bytes_per_read_2q"] = round(p2q.nbytes / n, 3)
    if p2u is not None:
        out["wire_bytes_per_read_2u"] = round(sum(
            a.nbytes for a in p2u[:3]) / n, 3)
    if p2c is not None and p2q is not None:
        out["bytes_ratio_2q_vs_2c"] = round(
            out["wire_bytes_per_read_2q"] / out["wire_bytes_per_read_2c"], 4)
    return out


def run(study, dev, rounds=10, reads=None, commands=None, binned=False,
        emit=None):
    """Run ``study`` (a name or "all") on ``dev``; returns the summary
    lines and the kernel launches of every pass, by kernel."""
    arm_studies = studies(binned)
    names = (list(arm_studies) + ["fixed", "paired"] if study == "all"
             else [study])
    r = Runner(dev, rounds, emit)
    out = []
    try:
        with mock.patch.dict(os.environ, {"HPGQ_CHARTS": os.environ.get(
                "HPGQ_CHARTS", "gnuplot")}):
            for name in names:
                if name == "fixed":
                    out.append(r.fixed(reads or 1_000_000))
                elif name == "paired":
                    out.append(r.paired(reads or 200_000))
                else:
                    st = arm_studies[name]
                    for cmd in commands or st.commands:
                        out.append(r.arm_study(st, reads or st.reads, cmd))
    finally:
        r.close()
    return out, dict(r.launches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--study", default="all",
                    choices=["all", "engine_cfg", "coalesce", "wire2c",
                             "wire6", "writer", "fixed", "paired"])
    ap.add_argument("--command", default=None,
                    help="comma-separated commands for the arm studies, of "
                         "%s (default: the study's own)" % ", ".join(COMMANDS))
    ap.add_argument("--reads", type=int, default=None,
                    help="reads of every study's corpus (default: each "
                         "hpgq tool's own; fixed's largest size)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--binned", action="store_true",
                    help="wire6: RTA3-binned qualities (ab_wire6.py's "
                         "--binned)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    commands = None
    if args.command:
        commands = args.command.split(",")
        bad = sorted(set(commands) - set(COMMANDS))
        if bad:
            ap.error("unknown command(s) %s" % ", ".join(bad))
    dev = resolve_device(args.device)
    card = (gpu_name_and_power_limit().splitlines()[0].strip()
            if dev.type == "cuda" else None)
    print(json.dumps({"card": card, "backend": "torch-" + dev.type}),
          flush=True)
    try:
        run(args.study, dev, args.rounds, args.reads, commands, args.binned)
    except BenchMismatch as e:
        print(json.dumps({"error": "BenchMismatch: %s" % e}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
