#!/usr/bin/env python3
"""Benchmark of the hpgq_torch port: the twin of ``bench.py`` and
``bench_scaling.py`` for one NVIDIA GPU (or the CPU, when asked for).

    python3 bench_torch.py                        # --mode all, on cuda
    python3 bench_torch.py --mode filter          # one line
    python3 bench_torch.py --device cpu --reads 6000 --ranks 1   # small

The corpora, criteria and workloads are ``bench.py``'s: the corpora are
``tests/gen.make_fastq`` with its seeds and RTA3 bins (byte-identical
files, cached under ``HPGQ_BENCH_DIR``, default the gitignored ``.bench/``),
and each line runs the port's production path:

* ``stats_filter_reads_per_sec``, the headline, printed last: ``stats``
  with the inline filter ``CRIT`` through ``run_stats`` over ``--reads`` x
  ``--len`` bp (the 2u wire and K1's 2u entry on the card);
* ``paired_stats_filter_reads_per_sec``: paired ``stats`` + ``CRIT``, mate
  2 the same recipe with seed 13, reads of both mates per second;
* ``stats_gz_reads_per_sec``, ``stats_bgzf_reads_per_sec``: the headline's
  work over the corpus as plain gzip (inflated on one thread) and as BGZF
  (split into byte ranges);
* ``cgr_reads_per_sec``: the CGR tables at k=7 over 200k reads;
* ``filter_reads_per_sec``: ``filter`` with ``FILTER_CRIT``, 200k reads;
* ``edit_reads_per_sec``: config #3, ``edit`` with ``EDIT_CRIT`` and then
  ``stats`` over ``edit.fq``, 200k reads of 60-160 bp (seed 11);
* ``device_step_compute_reads_per_sec`` (card only): rows per second of
  K1's 2u entry over the corpus' first batch, already on the card, timed
  with CUDA events over many launches;
* ``scaling_efficiency``: ``stats --sharded`` + ``CRIT`` over
  ``torch.distributed`` (gloo), one rank per card started by the port's
  launcher (``hpgq_torch.dist.launch``), at world size 1 and at
  ``min(--ranks, cards)``; ``rate_N / (N * rate_1)``, "not measured" on one
  card (two ranks on one card say nothing about scaling over cards).

Every line carries ``backend`` ("torch-cuda" or "torch-cpu"), ``card``
(``nvidia-smi``'s name and power limit, None on the CPU), ``rounds`` (each
round's oracle and engine rates) and ``spread`` (the lowest and highest
engine rate).

How it measures.  Each round runs the single-CPU oracle pass over the
same file (``hpgq_torch/baseline.py``, the functions of ``bench.py``'s
denominator, with the native packer pinned to one thread), then the
engine pass, on the host clock around work that ends in
``torch.cuda.synchronize()``.  The engine's result is held against the
oracle's every round: counters equal (``acc_quality`` to 1e-3 relative),
``filter`` and ``edit`` files byte-equal, CGR tables equal.  A mismatch
ends the run with exit code 1 and an error line: a faster wrong run
counts for nothing.  ``value`` is the median engine rate of the warm
rounds (one engine pass warms up first) and ``vs_baseline`` that median
over the median oracle rate.  ``bench.py`` reports the best same-round
pair, a choice made for a TPU link that swung tenfold; on a card the
median with its spread is the honest figure.  The CGR oracle is the
reference's per-nucleotide loop: as in ``bench.py`` it times 5,000 reads,
whose tables the engine must also equal, and the engine's timed passes are
held against ``hpgq_torch.oracle.reference_cgr`` of the generated reads.

On stderr: ``breakdown`` (``hpgq_torch.breakdown``'s stages: read, pack,
pinned copy, device steps, busy share; and a pinned host-to-device probe
of the wire buffer the engine ships, timed with CUDA events, against which
``engine_vs_h2d_ceiling`` puts the headline), the mode rounds and
``bench_phase_seconds``.  On the CPU no device number is printed.

Truncation guard (``tests/test_torch_bench.py``): a SIGTERM or SIGALRM
(armed at 1.15 x ``HPGQ_BENCH_BUDGET_S``, default 600 s) at any point
leaves ``bench_phase_seconds`` on stderr and, as the last stdout line, the
headline measured so far, or a zero-value headline with an ``error``.
"""

import argparse
import contextlib
import dataclasses
import filecmp
import json
import os
import shutil
import signal
import statistics
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]  # tests/gen.py: corpora

import numpy as np  # noqa: E402

from hpgq_torch.options import FilterCriteria  # noqa: E402

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
SMALL = 200_000     # reads of the cgr, filter and edit corpora
CGR_K = 7
CGR_ORACLE_READS = 5_000
HEADLINE = "stats_filter_reads_per_sec"


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


def corpus(n, read_len, shape):
    tag = "" if shape == "uniform" else "_" + shape
    return _make(os.path.join(BENCH_DIR, "bench_%d_%d%s.fq"
                              % (n, read_len, tag)),
                 n, **recipe(n, read_len, shape))


def mate2_corpus(n, read_len, shape):
    return _make(os.path.join(BENCH_DIR, "bench_mate2_%d_%s.fq" % (n, shape)),
                 n, **recipe(n, read_len, shape, seed=13))


def var_corpus(n, shape):
    """Config #3's corpus: 60-160 bp, seed 11 (``bench.py:1308-1322``)."""
    return _make(os.path.join(BENCH_DIR, "bench_var_%d_%s.fq" % (n, shape)),
                 n, min_len=60, max_len=160, n_prob=0.005, seed=11,
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


# ------------------------------------------------------------ measurement

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


def measure(engine, oracle, check, dev, rounds, deadline, on_round=None):
    """One warm-up engine pass, then ``rounds`` rounds of (oracle pass,
    engine pass), each engine result held against that round's oracle
    result by ``check(got, want)``; a round that would end past
    ``deadline`` is not started, once one has run.  Returns the rounds'
    rates (each pass's reads over its seconds)."""
    timed(engine, dev)
    fx = []
    last = 0.0
    for i in range(rounds):
        if fx and time.perf_counter() + last > deadline:
            break
        t0 = time.perf_counter()
        o_s, n_o, want = timed(oracle, dev)
        e_s, n_e, got = timed(engine, dev)
        check(got, want)
        last = time.perf_counter() - t0
        fx.append({"round": i, "oracle_rps": round(n_o / o_s, 1),
                   "engine_rps": round(n_e / e_s, 1),
                   "oracle_s": round(o_s, 3), "engine_s": round(e_s, 3)})
        if on_round is not None:
            on_round(fx)
    return fx


class Bench:
    """One run's settings and what it has measured so far."""

    def __init__(self, args, dev):
        self.args = args
        self.dev = dev
        self.backend = "torch-" + dev.type
        self.card = None
        if dev.type == "cuda":
            from hpgq_torch.device import gpu_name_and_power_limit

            self.card = gpu_name_and_power_limit().splitlines()[0].strip()
        self.t_start = time.perf_counter()
        self.budget = float(os.environ.get("HPGQ_BENCH_BUDGET_S", "600"))
        self.phase_s = {}
        self.cur = None
        self.headline = None
        self.tmps = []
        self.lock = threading.RLock()
        self.bailed = False

    def phase(self, name):
        """Close the running phase, recording its seconds, and open
        ``name`` (None only closes)."""
        now = time.perf_counter()
        if self.cur is not None:
            self.phase_s[self.cur[0]] = round(now - self.cur[1], 1)
        self.cur = None if name is None else (name, now)

    def left(self):
        return self.budget - (time.perf_counter() - self.t_start)

    def mktmp(self):
        self.tmps.append(tempfile.mkdtemp(prefix="hpgq_torch_bench_"))
        return self.tmps[-1]

    def emit(self, obj, err=False):
        with self.lock:
            stream = sys.stderr if err else sys.stdout
            print(json.dumps(obj), file=stream, flush=True)

    def line(self, metric, fx):
        """A metric line of the rounds ``fx``: the median engine rate."""
        e = [r["engine_rps"] for r in fx]
        o = [r["oracle_rps"] for r in fx]
        value = statistics.median(e)
        return {"metric": metric, "value": round(value, 1), "unit": "reads/s",
                "vs_baseline": round(value / statistics.median(o), 3),
                "qual_shape": self.args.qual_shape, "backend": self.backend,
                "card": self.card, "rounds": fx,
                "spread": [min(e), max(e)]}

    def zero_headline(self, error):
        return {"metric": HEADLINE, "value": 0.0, "unit": "reads/s",
                "vs_baseline": 0.0, "qual_shape": self.args.qual_shape,
                "backend": self.backend, "card": self.card, "error": error}

    def bail(self, sig, frame=None):
        """The truncation guard: the phases so far on stderr, the headline
        so far (or a zero one) as the last stdout line, exit 0."""
        with self.lock:
            if self.bailed:
                os._exit(0)
            self.bailed = True
            with contextlib.suppress(OSError, ValueError):
                sys.stdout.write("\n")  # closes a line cut by the signal
            if self.cur is not None:
                self.phase_s[self.cur[0] + "@kill"] = round(
                    time.perf_counter() - self.cur[1], 1)
            self.emit({"bench_phase_seconds": self.phase_s,
                       "truncated_by": sig}, err=True)
            self.emit(self.headline or self.zero_headline(
                "truncated before first measurement"))
            os._exit(0)

    def arm(self):
        for s in (signal.SIGTERM, signal.SIGALRM):
            signal.signal(s, self.bail)
        signal.alarm(max(1, int(self.budget * 1.15)))
        # a signal handler runs between the main thread's bytecodes only;
        # this thread bails even while the main thread waits in native code
        wd = threading.Timer(self.budget * 1.3 + 10.0, self.bail, args=(0,))
        wd.daemon = True
        wd.start()
        return wd


def run_headline(b: Bench, path):
    """The headline rounds; sets ``b.headline`` after every round.
    Returns (the rounds, the oracle's counters)."""
    a = b.args
    out = b.mktmp()
    got = {}

    def oracle():
        n, c = oracle_stats(path, a.batch_size)
        got["oracle"] = c
        return n, c

    def on_round(fx):
        b.headline = b.line(HEADLINE, fx)

    fx = measure(lambda: engine_stats(path, out, a.batch_size, a.batch_reads,
                                      b.dev),
                 oracle, lambda g, w: check_counters(g, w, "stats"), b.dev,
                 rounds=5, deadline=time.perf_counter() + 0.4 * b.left(),
                 on_round=on_round)
    return fx, got["oracle"]


def breakdown(b: Bench, path, engine_rps):
    """The stage breakdown on stderr; on CUDA also the busy share and the
    device probes (returned, else None)."""
    import io

    from hpgq_torch import breakdown as bd

    res = bd.stages(path, b.dev, out=io.StringIO())
    if b.dev.type != "cuda":
        b.emit({"breakdown": res, "backend": b.backend}, err=True)
        return None
    busy = res.pop("busy")
    if busy is not None:
        res["busy_share"] = busy[0] / busy[2]
        res["busy_ms"], res["stats_kernels_ms"], res["wall_ms"] = busy
    probe = device_probes(path, b.args.batch_reads, b.dev)
    res.update(probe)
    res["engine_vs_h2d_ceiling"] = round(engine_rps / probe["h2d_reads_per_sec"],
                                         3)
    b.emit({"breakdown": res, "backend": b.backend, "card": b.card},
           err=True)
    return probe


def device_probes(path, batch_reads, dev, iters=50):
    """The first batch packed as the engine packs it: its pinned copy to
    the card, and K1's 2u entry over it on the card (the plain entry over
    the decoded batch when the corpus does not take the 2u wire), each
    timed with CUDA events over ``iters`` calls."""
    import torch

    from hpgq_torch.breakdown import _arrays
    from hpgq_torch.io.fastq import FastqReader
    from hpgq_torch.kernels import stats_cuda
    from hpgq_torch.kernels.step import unwire
    from hpgq_torch.pipeline.session import StatsSession, to_device

    with FastqReader(path, batch_size=batch_reads) as rd:
        block = next(iter(rd))
    sess = StatsSession(PHRED, CRIT, batch_reads=batch_reads, device=dev)
    packed = sess.pack(block, batch_reads)
    pinned = [torch.from_numpy(a).pin_memory() for a in _arrays(packed)
              if isinstance(a, np.ndarray)]
    nbytes = sum(t.numel() * t.element_size() for t in pinned)

    def events(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize(dev)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize(dev)
        return t0.elapsed_time(t1) / iters

    h2d_ms = events(lambda: [t.to(dev, non_blocking=True) for t in pinned])
    args = to_device(packed, dev)
    payload = args[0] if len(args) == 1 else args
    lcap = max(128, -(-block.max_len() // 128) * 128)
    if isinstance(payload[0], str):
        _, buf, exc, pal, nv, L = payload
        entry = "K1 2u entry"
        step_ms = events(lambda: stats_cuda.batch_partials_2u(
            buf, exc, pal, nv, L, lcap, PHRED, CRIT))
    else:
        codes, quals, lens, valid = unwire(payload, lcap)
        entry = "K1 plain entry"
        step_ms = events(lambda: stats_cuda.batch_partials_cuda(
            codes, quals, lens, valid, lcap, PHRED, CRIT))
    n = block.num_reads
    return {"h2d_bytes": nbytes, "h2d_ms": round(h2d_ms, 4),
            "h2d_mb_s": round(nbytes / h2d_ms / 1e3, 1),
            "h2d_reads_per_sec": round(n / h2d_ms * 1e3, 1),
            "step_entry": entry, "step_rows": n,
            "step_ms": round(step_ms, 4),
            "step_reads_per_sec": round(n / step_ms * 1e3, 1)}


def modes(b: Bench, path, which):
    """The mode lines of ``which``, each printed when measured."""
    a = b.args
    n_small = min(a.reads, SMALL)

    def setup_paired():
        mate2 = mate2_corpus(a.reads, a.len, a.qual_shape)
        out = b.mktmp()
        return (lambda: engine_paired(path, mate2, out, a.batch_size, b.dev),
                lambda: oracle_paired(path, mate2, a.batch_size),
                lambda g, w: check_result("paired", g, w, "paired stats"))

    def setup_compressed(cpath, label):
        out = b.mktmp()
        return (lambda: engine_stats(cpath, out, a.batch_size, a.batch_reads,
                                     b.dev),
                lambda: oracle_stats(cpath, a.batch_size),
                lambda g, w: check_counters(g, w, label))

    def setup_cgr():
        from gen import make_records
        from hpgq_torch.oracle import reference_cgr

        # the loop times 5,000 reads (its rate is per read, as bench.py's);
        # the engine must equal it on those, and the vectorised reference
        # on the timed corpus
        ocorpus = corpus(CGR_ORACLE_READS, a.len, a.qual_shape)
        check_tables(engine_cgr(ocorpus, a.batch_size, b.dev)[1],
                     oracle_cgr(ocorpus)[1], "cgr over the oracle's corpus")
        small = corpus(n_small, a.len, a.qual_shape)
        want = reference_cgr(make_records(
            n_small, **recipe(n_small, a.len, a.qual_shape)), CGR_K)
        return (lambda: engine_cgr(small, a.batch_size, b.dev),
                lambda: oracle_cgr(ocorpus),
                lambda g, _: check_tables(g, want, "cgr"))

    def setup_filter():
        small = corpus(n_small, a.len, a.qual_shape)
        eout, oout = b.mktmp(), b.mktmp()
        return (lambda: engine_filter(small, eout, a.batch_size, b.dev),
                lambda: oracle_filter(small, a.batch_size, oout),
                lambda g, w: check_files(g, w, "filter"))

    def setup_edit():
        vpath = var_corpus(n_small, a.qual_shape)
        eout, oout = b.mktmp(), b.mktmp()
        return (lambda: engine_edit(vpath, eout, a.batch_size, b.dev),
                lambda: oracle_edit(vpath, a.batch_size, oout),
                lambda g, w: check_result("edit", g, w, "edit"))

    setups = {  # bench.py's order: the tightest ratios first
        "paired": ("paired_stats_filter_reads_per_sec", setup_paired),
        "gz": ("stats_gz_reads_per_sec",
               lambda: setup_compressed(gz_corpus(path), "stats, gzip")),
        "cgr": ("cgr_reads_per_sec", setup_cgr),
        "filter": ("filter_reads_per_sec", setup_filter),
        "edit": ("edit_reads_per_sec", setup_edit),
        "bgzf": ("stats_bgzf_reads_per_sec",
                 lambda: setup_compressed(bgzf_corpus(path), "stats, BGZF")),
    }
    for name, (metric, setup) in setups.items():
        if name not in which:
            continue
        if b.left() <= 0:
            b.emit({"mode_skipped": name, "reason": "budget spent"},
                   err=True)
            continue
        b.phase("mode_" + name)
        engine, oracle, check = setup()
        fx = measure(engine, oracle, check, b.dev, rounds=3,
                     deadline=time.perf_counter() + b.left()
                     / (len(which) - which.index(name)))
        b.emit({"mode_rounds": name, "rounds": fx}, err=True)
        b.emit(b.line(metric, fx))


# ------------------------------------------------------------ scaling

def rank_pass(job):
    """One rank of the scaling line, a target of the port's launcher
    (``hpgq_torch.dist.launch``): one warm-up and one timed ``stats
    --sharded`` pass with ``CRIT``; dumps its counters and the timed
    pass's seconds."""
    from hpgq_torch.dist import mesh
    from hpgq_torch.dist.run_dist import run_stats_sharded
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.utils.checkpoint import save_counters_checkpoint

    pg = mesh.initialize_distributed(job["device"])
    out = os.path.join(job["dir"], "out.rank%d" % pg.rank)
    os.makedirs(out, exist_ok=True)
    opts = _options(StatsOptions, job["path"], out, job["batch_size"], CRIT,
                    sharded=True)
    secs = []
    for _ in range(2):  # a warm-up pass, then the timed one
        mesh.barrier(pg)
        t0 = time.perf_counter()
        c = run_stats_sharded(opts, device=pg.device)
        sync(pg.device)
        secs.append(time.perf_counter() - t0)
    dump = os.path.join(job["dir"], "c.rank%d" % pg.rank)
    save_counters_checkpoint(dump + ".npz", c, 0, "dump")
    with open(dump + ".json", "w") as f:
        json.dump({"rank": pg.rank, "world": pg.world_size,
                   "device": str(pg.device), "secs": secs[-1]}, f)


def run_ranks(b: Bench, world, path, want):
    """``world`` ranks of :func:`rank_pass`, started by the port's
    launcher (one per card on CUDA, all on the CPU otherwise; they die
    with this process, so the truncation guard leaves none behind); every
    rank's counters must equal the oracle's ``want``.  Returns reads/s of
    the timed pass (the slowest rank's seconds)."""
    from hpgq_torch.dist.launch import launch
    from hpgq_torch.utils.checkpoint import load_counters_checkpoint

    work = b.mktmp()
    devices = (["cuda:%d" % r for r in range(world)] if b.dev.type == "cuda"
               else ["cpu"] * world)
    launch(rank_pass, ({"device": b.dev.type, "dir": work, "path": path,
                        "batch_size": b.args.batch_size},), devices)
    secs = []
    for r in range(world):
        dump = os.path.join(work, "c.rank%d" % r)
        with open(dump + ".json") as f:
            secs.append(json.load(f)["secs"])
        c, _, _ = load_counters_checkpoint(dump + ".npz", "dump")
        check_counters(c, want, "stats --sharded, world size %d, rank %d"
                       % (world, r))
    return want.num_passed + want.num_failed, max(secs)


def scaling(b: Bench, path, want):
    """The scaling line: world size 1 and ``N = min(--ranks, cards)`` (on
    the CPU, ``--ranks`` processes), one rank per card."""
    import torch

    n_cards = torch.cuda.device_count() if b.dev.type == "cuda" else None
    world = min(b.args.ranks, n_cards) if n_cards else b.args.ranks
    n, s1 = run_ranks(b, 1, path, want)
    rates = {"1": round(n / s1, 1)}
    line = {"metric": "scaling_efficiency", "value": "not measured",
            "unit": "fraction@%dx" % world, "world_sizes": rates,
            "backend": b.backend, "card": b.card, "cards": n_cards,
            "mode": "stats --sharded + CRIT, one rank per card, gloo"}
    if world > 1:
        n, sn = run_ranks(b, world, path, want)
        rates[str(world)] = round(n / sn, 1)
        line["value"] = round(s1 / (world * sn), 4)
    else:
        line["reason"] = ("one card: ranks sharing it say nothing about "
                          "scaling over cards")
    b.emit(line)


# ------------------------------------------------------------ main

def run(b: Bench):
    a = b.args
    wd = b.arm()
    b.phase("corpus")
    path = corpus(a.reads, a.len, a.qual_shape)
    if a.mode in ("all", "stats"):
        b.phase("headline")
        fx, want = run_headline(b, path)
        rps = b.headline["value"]
        b.phase("breakdown")
        probe = breakdown(b, path, rps)
        if probe is not None:
            b.emit({"metric": "device_step_compute_reads_per_sec",
                    "value": probe["step_reads_per_sec"], "unit": "reads/s",
                    "vs_baseline": round(probe["step_reads_per_sec"]
                                         / statistics.median(
                                             r["oracle_rps"] for r in fx), 3),
                    "entry": probe["step_entry"], "rows": probe["step_rows"],
                    "qual_shape": a.qual_shape, "backend": b.backend,
                    "card": b.card})
    which = (["paired", "gz", "cgr", "filter", "edit", "bgzf"]
             if a.mode == "all" else [a.mode] if a.mode != "stats" else [])
    modes(b, path, which)
    if a.mode == "all":
        b.phase("scaling")
        scaling(b, path, want)
    b.phase(None)
    signal.alarm(0)
    wd.cancel()
    b.emit({"bench_phase_seconds": b.phase_s}, err=True)
    if a.mode in ("all", "stats"):
        b.emit(b.headline)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="all",
                    choices=["all", "stats", "filter", "edit", "cgr"],
                    help="all = every line of bench.py and the scaling line")
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--len", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=131_072)
    ap.add_argument("--batch-reads", type=int, default=131_072)
    ap.add_argument("--oracle-reads", type=int, default=0,
                    help="accepted for bench.py's command lines; the oracle "
                         "always reads the engine's own file")
    ap.add_argument("--qual-shape", default="rta3",
                    choices=["rta3", "uniform"],
                    help="rta3 = NovaSeq 4-level binning (default); "
                         "uniform = unbinned 2..41")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks of the scaling line's second run (capped at "
                         "the cards on cuda; default 4)")
    args = ap.parse_args(argv)
    os.environ.setdefault("HPGQ_CHARTS", "gnuplot")  # bench.py:41-48
    from hpgq_torch.device import resolve_device

    b = Bench(args, resolve_device(args.device))
    try:
        run(b)
    except BaseException as e:
        if isinstance(e, SystemExit):
            raise
        with b.lock:
            b.emit({"bench_error": repr(e)[:600]}, err=True)
            b.emit({"bench_phase_seconds": b.phase_s}, err=True)
            b.emit(b.zero_headline("%s: %s" % (type(e).__name__,
                                               str(e)[:300])))
        return 1
    finally:
        for d in b.tmps:
            shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
