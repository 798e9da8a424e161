"""The `stats`, `filter` and `edit` pipelines, single-end and paired-end.

The port of ``hpgq/pipeline/run.py``'s ``run_stats`` (``:463-602``),
``run_filter`` (``:756-860``) and ``run_edit`` (``:951-1152``, which
`prepro` runs too) with their helpers: the concurrent shard
readers of ``_run_stats_parallel`` / ``_run_stats_parallel_paired``
(``:356-460``) and ``_run_output_parallel`` (``:609-753``), the lockstep
mate iterator and ``_OutputCheckpointer`` (``:863-944``).  What changed on
the way:

* Every ``jax.default_backend()`` test is a test of the run's device.
* ``jax.device_put`` became a pinned host buffer and a ``non_blocking``
  copy on a side stream, issued from the packing pool thread.  The copy
  records a CUDA event; the stream that runs the step waits on it, and the
  pinned buffers stay referenced until the step has been enqueued.
* Each shard thread runs its steps on its own ``torch.cuda.Stream``; each
  filter pool thread runs its verdicts on its own stream too
  (:class:`~hpgq_torch.pipeline.session.ShapeCachedFn`).
* Reads of any length run on CUDA: K1 up to a 4096-column bucket, K2
  above it; ``--kmers`` rides on either kernel's pass mask.

Paired-end: mates stream in lockstep, and a pair counts (stats with a
filter) or passes (filter, edit's post-filter) only when both mates pass.
``--sharded`` runs go through :mod:`hpgq_torch.dist.run_dist`, which runs
these pipelines on each rank's part of the input.  ``--profile-dir`` wraps
a ``torch.profiler`` trace around the streaming loop of `stats`, `filter`
and `edit` (:class:`_Profiler`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import shutil
import tempfile
import threading
from typing import Optional

import torch

from ..constants import DEFAULT_BATCH_SIZE
from ..io.fastq import (
    AsyncSpanPump,
    FastqReader,
    FastqWriter,
    coalesce_blocks,
)
from ..io.packer import round_up
from ..options import EditOptions, FilterOptions, StatsOptions
from ..pipeline.prefetch import prefetched
from ..report.stats_report import stats_report
from ..utils.checkpoint import (
    load_counters_checkpoint,
    save_counters_checkpoint,
)
from ..utils.timers import StageTimers

from ..device import resolve_device
from ..kernels.stats_torch import apply_trims, trims, verdicts
from .ranges import range_splittable, split_byte_ranges, split_paired_ranges
from .session import (
    PairedStatsSession,
    ShapeCachedFn,
    ShapeCachedPairFn,
    StatsSession,
    to_device,
)

_PARALLEL_MIN_BYTES = 32 << 20  # below this, shard setup outweighs the win


def _batch_reads(opts, device) -> int:
    # an explicit --device-batch-reads is the user's device-memory cap
    if int(opts.device_batch_reads):
        return int(opts.device_batch_reads)
    return max(256, round_up(max(int(opts.batch_size),
                                 _reader_batch(opts, device),
                                 _coalesce_reads(opts, device)), 256))


def _reader_batch(opts, device) -> int:
    """Reader block size in reads: accelerator-sized (131072) when the
    batch knobs were left untouched on CUDA, else ``--batch-size``
    (the conditions of ``hpgq/pipeline/run.py:47-74``)."""
    if (int(opts.device_batch_reads) == 0
            and not getattr(opts, "batch_size_set", False)
            and int(opts.batch_size) == DEFAULT_BATCH_SIZE
            and not getattr(opts, "checkpoint_path", None)
            and device.type != "cpu"):
        return 131072
    return int(opts.batch_size)


def _coalesce_reads(opts, device) -> int:
    """Dispatch-coalescing target in reads, 0 = off (the conditions of
    ``hpgq/pipeline/run.py:77-107``; ``HPGQ_COALESCE`` overrides)."""
    env = os.environ.get("HPGQ_COALESCE")
    if env is not None:
        return max(0, int(env))
    if (getattr(opts, "checkpoint_path", None) or int(opts.device_batch_reads)
            or _reader_batch(opts, device) >= 65536 or device.type == "cpu"):
        return 0
    return 131072


def _coalesced(opts, reader, device):
    tgt = _coalesce_reads(opts, device)
    if not tgt:
        return reader
    return coalesce_blocks(iter(reader), tgt)


def _pack_workers() -> int:
    """Transform-pool width (HPGQ_PACK_THREADS; 0/unset = auto)."""
    n = int(os.environ.get("HPGQ_PACK_THREADS", "0") or 0)
    if n > 0:
        return n
    return max(1, min(4, (os.cpu_count() or 2) - 1))


def _read_shards() -> int:
    """Concurrent byte-range readers (HPGQ_READ_SHARDS; 0/unset = auto)."""
    n = int(os.environ.get("HPGQ_READ_SHARDS", "0") or 0)
    if n > 0:
        return n
    return max(1, min(4, (os.cpu_count() or 2) // 2))


def _count(timers, block) -> None:
    timers.num_batches += 1
    timers.total_reads += block.num_reads
    timers.total_bytes += block.span_bytes


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for a in x:
            yield from _tensors(a)


def _device_batches(items, pack, dev, timers, depth: int = 0,
                    workers: int = 0):
    """(item, device args) with ``pack(item)`` (host numpy arrays) and the
    host-to-device copy of the next items running in a thread pool while
    the current step runs.  On CUDA the copy is a pinned ``non_blocking``
    one on a side stream: the consumer's current stream waits on its
    event, and the pinned buffers stay referenced until the consumer asks
    for the next item, by which time its step is enqueued.  ``timers`` get
    the ``pack`` and ``h2d`` stages on the thread that runs them and the
    consumer's wait split by what it waits on (:func:`prefetched`)."""
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def transform(item):
        with timers.stage("pack"):
            packed = pack(item)
        if copy_stream is None:
            with timers.stage("h2d"):
                return item, to_device(packed, dev), None, None
        keep = []
        with timers.stage("h2d"), torch.cuda.stream(copy_stream):
            arrs = to_device(packed, dev, non_blocking=True, keep=keep)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return item, arrs, done, keep

    workers = workers or _pack_workers()
    for item, arrs, done, keep in prefetched(
            iter(items), depth=depth or (workers + 2), transform=transform,
            workers=workers, timers=timers):
        if done is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            for t in _tensors(arrs):  # allocated on the copy stream
                t.record_stream(cur)
        yield item, arrs
        del keep


def _iter_blocks(reader, timers, depth: int = 3):
    """The reader's blocks, read and indexed ``depth`` blocks ahead on a
    producer thread (``hpgq/pipeline/run.py:120-134``); the ``read`` stage
    is the wait for the next block."""
    it = prefetched(iter(reader), depth=depth)
    while True:
        with timers.stage("read"):
            block = next(it, None)
        if block is None:
            return
        _count(timers, block)
        yield block


def _iter_packed(reader, sess, batch_reads: int, timers, depth: int = 0,
                 workers: int = 0):
    """(block, device args for ``sess.feed_packed``)."""
    it = _device_batches(reader, lambda b: sess.pack(b, batch_reads),
                         sess.device, timers, depth, workers)
    while True:
        with timers.stage("read"):
            item = next(it, None)
        if item is None:
            return
        _count(timers, item[0])
        yield item


def _iter_blocks_paired(r1, r2, timers):
    """Lockstep mate blocks, re-sliced to common record counts: the mate
    files hold the same number of records in different byte layouts, so
    their readers' blocks disagree in size; every yielded pair covers the
    same record range.  Raises on unequal record counts."""
    i1 = prefetched(iter(r1), depth=2)
    i2 = prefetched(iter(r2), depth=2)
    b1 = b2 = None
    p1 = p2 = 0
    while True:
        with timers.stage("read"):
            if b1 is None or p1 >= b1.num_reads:
                b1 = next(i1, None)
                p1 = 0
            if b2 is None or p2 >= b2.num_reads:
                b2 = next(i2, None)
                p2 = 0
        if b1 is None and b2 is None:
            return
        if b1 is None or b2 is None:
            raise ValueError("paired-end inputs have mismatched record "
                             "counts; both mates must pair up 1:1")
        n = min(b1.num_reads - p1, b2.num_reads - p2)
        s1 = b1.slice(p1, p1 + n)
        s2 = b2.slice(p2, p2 + n)
        p1 += n
        p2 += n
        timers.num_batches += 1
        timers.total_reads += 2 * n
        timers.total_bytes += s1.span_bytes + s2.span_bytes
        yield s1, s2


def _iter_packed_paired(pairs, sess, timers):
    """(b1, b2, in1, in2): both mates packed and copied in the pool (the
    reads are counted by :func:`_iter_blocks_paired`)."""
    for (b1, b2), (in1, in2) in _device_batches(
            pairs, lambda p: sess.pack_pair(*p), sess.device, timers):
        yield b1, b2, in1, in2


def _iter_with(items, fn, timers, depth: int = 0):
    """(item, fn(item)) with ``fn`` (the device verdict) running in the
    pool, so the pack, copy and verdict of the next items overlap the
    writes of this one; items come out in input order."""
    workers = _pack_workers()

    def transform(item):
        with timers.stage("compute"):
            return item, fn(item)

    return prefetched(iter(items), depth=depth or (workers + 2),
                      transform=transform, workers=workers)


def _stats_config_key(opts, crit) -> str:
    """Checkpoint fingerprint, the same string ``hpgq`` writes."""
    return json.dumps({
        "cmd": "stats",
        "in": os.path.abspath(opts.in_filename),
        "phred": opts.quality_encoding_value,
        "kmers": opts.kmers_on,
        "crit": dataclasses.astuple(crit) if crit is not None else None,
    }, sort_keys=True)


def _output_parallel_eligible(opts, device) -> bool:
    """Shard readers pay off only on an accelerator (on the CPU torch
    already uses every core): no checkpoint, no explicit range, byte-
    seekable input files (both mates when paired), the first of at least
    32 MiB.  HPGQ_READ_SHARDS forces."""
    inputs = [opts.in_filename]
    if opts.paired_end:
        inputs.append(opts.in_filename2)
    if (opts.checkpoint_path
            or getattr(opts, "input_range", None) is not None
            or _read_shards() <= 1
            or not all(p and os.path.exists(p) for p in inputs)
            or os.path.getsize(opts.in_filename) < _PARALLEL_MIN_BYTES):
        return False
    if not os.environ.get("HPGQ_READ_SHARDS") and device.type == "cpu":
        return False
    return all(range_splittable(p) for p in inputs)


def _stream_ctx(device):
    """A fresh CUDA stream as the current one on a CUDA device, else a
    no-op context."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


def _in_threads(work, items, name: str):
    """``work(i, item)`` for each item on a thread of its own; returns the
    results in item order and the first error raised (or None)."""
    results = [None] * len(items)
    errors = []

    def run(i, item):
        try:
            results[i] = work(i, item)
        except BaseException as e:  # handed to the caller, which raises it
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, item), daemon=True,
                                name="%s%d" % (name, i))
               for i, item in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, (errors[0] if errors else None)


def _report_pair(c1, c2, opts, timers) -> None:
    with timers.stage("reporting"):
        stats_report(c1, opts)
        stats_report(c2, dataclasses.replace(opts,
                                             in_filename=opts.in_filename2))


def _run_stats_parallel(opts, timers, crit, br, nshards: int, device):
    """Single-end stats over ``nshards`` concurrent byte-range readers,
    each with its own session (and CUDA stream); host counters merge in
    shard order, so every integer field is deterministic."""
    def work(i, rng):
        t = StageTimers()
        with _stream_ctx(device):
            sess = StatsSession(opts.quality_encoding_value, crit,
                                batch_reads=br, device=device,
                                kmers_on=opts.kmers_on, timers=t)
            with FastqReader(opts.in_filename,
                             batch_size=_reader_batch(opts, device),
                             start_offset=rng[0], end_offset=rng[1],
                             timers=t) as rd:
                for _, arrs in _iter_packed(_coalesced(opts, rd, device),
                                            sess, br, t, workers=1):
                    with t.stage("compute"):
                        sess.feed_packed(*arrs)
            with t.stage("compute"), t.stage("fold"):
                return sess.finish(), t

    results, err = _in_threads(
        work, split_byte_ranges(opts.in_filename, nshards),
        "hpgq-torch-shard")
    if err is not None:
        raise err
    counters = None
    for res, t in results:
        timers.merge_from(t)
        counters = res if counters is None else counters.merge(res)
    return counters


def _run_stats_parallel_paired(opts, timers, device):
    """Paired stats over concurrent shard pairs that cover the same record
    indices in both mates (``split_paired_ranges``): each shard thread runs
    the serial paired loop on its own CUDA stream, counters merge in shard
    order, one report per mate."""
    def work(i, rp):
        local = dataclasses.replace(opts)
        local.input_range, local.input_range2 = rp
        t = StageTimers()
        with _stream_ctx(device):
            return _stream_stats(local, t, device), t

    results, err = _in_threads(
        work, split_paired_ranges(opts.in_filename, opts.in_filename2,
                                  _read_shards()),
        "hpgq-torch-pshard")
    if err is not None:
        raise err
    c1 = c2 = None
    for (r1, r2), t in results:
        timers.merge_from(t)
        c1 = r1 if c1 is None else c1.merge(r1)
        c2 = r2 if c2 is None else c2.merge(r2)
    return c1, c2


def _warn_no_pallas(opts) -> None:
    """``--no-pallas`` is accepted for ``hpgq``'s command lines and changes
    nothing here."""
    if not getattr(opts, "use_pallas", True):
        logging.getLogger("hpgq").warning(
            "--no-pallas has no effect in hpgq_torch: CUDA runs the K1/K2 "
            "kernels, the CPU their plain twin")


class _Profiler:
    """A ``torch.profiler`` trace around a command's streaming loop
    (``--profile-dir``; the counterpart of ``hpgq/pipeline/run.py:
    320-337``): the host's operators of every thread of the run (the shard
    readers and pools too, where this torch can trace other threads), the
    program's ``stage.<name>`` ranges on the threads that enter them
    (inflate, index, pack, h2d, the consumer's read with its wait-reader
    and wait-pack, compute with its fold; :mod:`hpgq_torch.utils.timers`)
    and, on CUDA, the card's kernels and copies, all on one clock.  On
    exit it writes one Chrome trace,
    ``<dir>/hpgq_torch.<pid>.<random>.pt.trace.json``, named so that runs
    writing into one directory at once cannot clash.  Shapes, stacks and
    memory are not recorded: one pass over a million reads makes tens of
    thousands of events already."""

    def __init__(self, profile_dir, device):
        self.dir = profile_dir
        self.device = device
        self.prof = None

    def __enter__(self):
        if self.dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities,
                                experimental_config=_all_threads())
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        os.makedirs(self.dir, exist_ok=True)
        fd, path = tempfile.mkstemp(prefix="hpgq_torch.%d." % os.getpid(),
                                    suffix=".pt.trace.json", dir=self.dir)
        os.close(fd)
        self.prof.export_chrome_trace(path)


def _all_threads():
    """Kineto's ``profile_all_threads`` setting, or None where this torch
    has no such setting (its trace then holds the host operators of the
    calling thread only)."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def run_stats(opts: StatsOptions, timers: Optional[StageTimers] = None,
              report: bool = True, device="cuda"):
    """The `stats` command on ``device`` ("cuda" or "cpu").  Returns the
    merged :class:`~hpgq_torch.core.counters.StatsCounters`, a
    ``(counters1, counters2)`` pair for paired input."""
    dev = resolve_device(device)
    _warn_no_pallas(opts)
    timers = timers or StageTimers()
    with _Profiler(opts.profile_dir, dev):
        counters = _stream_stats(opts, timers, dev)
    if report and opts.paired_end:
        _report_pair(*counters, opts, timers)
    elif report:
        with timers.stage("reporting"):
            stats_report(counters, opts)
    return counters


def _stream_stats(opts, timers, dev):
    """The counters of `stats` (a pair for paired input), no report."""
    crit = opts.criteria if opts.filter_on else None
    br = _batch_reads(opts, dev)
    if opts.paired_end:
        if _output_parallel_eligible(opts, dev):
            return _run_stats_parallel_paired(opts, timers, dev)
        return _run_stats_paired(opts, timers, crit, br, dev)
    if _output_parallel_eligible(opts, dev):
        return _run_stats_parallel(opts, timers, crit, br, _read_shards(),
                                   dev)

    ck_path = opts.checkpoint_path
    ck_every = opts.checkpoint_every or 50
    ck_key = _stats_config_key(opts, crit) if ck_path else None
    start = 0
    resumed = None
    if ck_path:
        loaded = load_counters_checkpoint(ck_path, ck_key)
        if loaded:
            resumed, start, _ = loaded

    sess = StatsSession(opts.quality_encoding_value, crit, batch_reads=br,
                        device=dev,
                        lcap=max(128, resumed.lcap) if resumed else 128,
                        kmers_on=opts.kmers_on, timers=timers)
    if resumed:
        resumed.ensure_length(sess.lcap)
        sess.acc.counters = resumed
    nb = 0
    rng = getattr(opts, "input_range", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts, dev),
                     start_offset=max(start, rng[0]), end_offset=rng[1],
                     timers=timers) as rd:
        for block, arrs in _iter_packed(
                _coalesced(opts, rd, dev), sess, br, timers,
                depth=getattr(opts, "batch_list_size", 0)):
            with timers.stage("compute"):
                sess.feed_packed(*arrs)
            nb += 1
            if ck_path and nb % ck_every == 0:
                with timers.stage("checkpoint"):
                    with timers.stage("fold"):
                        sess.acc.flush()
                    save_counters_checkpoint(ck_path, sess.acc.counters,
                                             block.end_offset, ck_key)
    with timers.stage("compute"), timers.stage("fold"):
        counters = sess.finish()
    if ck_path and os.path.exists(ck_path):
        os.unlink(ck_path)  # run completed; a stale resume would re-read
    return counters


def _run_stats_paired(opts, timers, crit, br, dev):
    """The serial paired branch of `stats` (``hpgq/pipeline/run.py:
    532-602``): both mates' steps per batch, the checkpoint key of
    ``hpgq``, and the pair tallies copied into both counters."""
    sess = PairedStatsSession(opts.quality_encoding_value, crit,
                              batch_reads=br, device=dev,
                              kmers_on=opts.kmers_on, timers=timers)
    ck_path = opts.checkpoint_path
    ck_every = opts.checkpoint_every or 50
    ck_key = (_stats_config_key(opts, crit) + "|paired:%s"
              % os.path.abspath(opts.in_filename2) if ck_path else None)
    start1 = start2 = 0
    if ck_path:
        loaded = load_counters_checkpoint(ck_path, ck_key)
        if loaded:
            sess.counters1, start1, extra = loaded
            sess.counters2 = extra["__counters2__"]
            for c in (sess.counters1, sess.counters2):
                c.ensure_length(sess.lcap)
            start2 = int(extra["offset2"])
            # the pair tallies ride in counters1: nothing else to restore
    nb = 0
    rng1 = getattr(opts, "input_range", None) or (0, None)
    rng2 = getattr(opts, "input_range2", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts, dev),
                     start_offset=max(start1, rng1[0]), end_offset=rng1[1],
                     timers=timers) as r1, \
            FastqReader(opts.in_filename2,
                        batch_size=_reader_batch(opts, dev),
                        start_offset=max(start2, rng2[0]),
                        end_offset=rng2[1], timers=timers) as r2:
        for b1, b2, in1, in2 in _iter_packed_paired(
                _iter_blocks_paired(_coalesced(opts, r1, dev),
                                    _coalesced(opts, r2, dev), timers),
                sess, timers):
            with timers.stage("compute"):
                sess.feed_pair_packed(in1, in2)
            nb += 1
            if ck_path and nb % ck_every == 0:
                with timers.stage("checkpoint"):
                    with timers.stage("fold"):
                        sess.flush()
                    save_counters_checkpoint(
                        ck_path, sess.counters1, b1.end_offset, ck_key,
                        extra={"offset2": b2.end_offset},
                        counters2=sess.counters2)
    with timers.stage("compute"), timers.stage("fold"):
        c1, c2 = sess.finish()
    if ck_path and os.path.exists(ck_path):
        os.unlink(ck_path)
    for c in (c1, c2):
        c.filter_on = crit is not None
        c.num_passed, c.num_failed = sess.num_passed, sess.num_failed
    return c1, c2


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

_SHARD_OWNER = ".hpgq-owner"  # pid marker inside each .pshard dir


def _read_shard_owner(sd: str):
    try:
        with open(os.path.join(sd, _SHARD_OWNER)) as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return None  # pre-marker or corrupt dir: treat as stale


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _run_output_parallel(opts, timers, runner, count_keys, device):
    """An output command over concurrent record-aligned shards (range
    pairs for paired input): each shard thread runs the serial pipeline
    (``runner(opts, timers, device)``) into a private ``.pshardNNNN`` dir,
    and the final files are the shard files concatenated in shard order,
    byte-identical to a serial run."""
    nshards = _read_shards()
    if opts.paired_end:
        ranges = split_paired_ranges(opts.in_filename, opts.in_filename2,
                                     nshards)
    else:
        ranges = [(r, None) for r in split_byte_ranges(opts.in_filename,
                                                       nshards)]
    out_dir = opts.out_dirname or "."

    def work(i, rng):
        local = dataclasses.replace(opts)
        sd = os.path.join(out_dir, ".pshard%04d" % i)
        if os.path.isdir(sd):
            # a stale dir from a killed run must not be concatenated, but
            # one a live run still writes must not be deleted under it
            owner = _read_shard_owner(sd)
            if owner is not None and owner != os.getpid() \
                    and _pid_alive(owner):
                raise RuntimeError("%s is in use by a concurrent run (pid "
                                   "%d) — choose a different --out-dir"
                                   % (sd, owner))
            shutil.rmtree(sd)
        os.makedirs(sd)
        with open(os.path.join(sd, _SHARD_OWNER), "w") as fh:
            fh.write(str(os.getpid()))
        local.out_dirname = sd
        local.input_range, local.input_range2 = rng
        t = StageTimers()
        return runner(local, t, device), t, sd

    results, err = _in_threads(work, ranges, "hpgq-torch-oshard")
    if err is not None:
        for i in range(nshards):  # never a dir a live concurrent run owns
            sd = os.path.join(out_dir, ".pshard%04d" % i)
            owner = _read_shard_owner(sd)
            if owner is None or owner == os.getpid() or not _pid_alive(owner):
                shutil.rmtree(sd, ignore_errors=True)
        raise err

    out = {k: 0 for k in count_keys}
    names = sorted(n for n in os.listdir(results[0][2]) if n != _SHARD_OWNER)
    with timers.stage("write"):
        for name in names:
            with open(os.path.join(out_dir, name), "wb") as dst:
                for _, _, sd in results:
                    p = os.path.join(sd, name)
                    if os.path.exists(p):
                        with open(p, "rb") as src:
                            shutil.copyfileobj(src, dst, 16 << 20)
    for res, t, sd in results:
        timers.merge_from(t)
        for k in count_keys:
            out[k] += int(res.get(k, 0))
        shutil.rmtree(sd, ignore_errors=True)
    base = dict(results[0][0])  # output paths and flags
    for k, v in base.items():
        if isinstance(v, str) and ".pshard" in v:
            base[k] = os.path.join(out_dir, os.path.basename(v))
    base.update(out)
    return base


def run_filter(opts: FilterOptions, timers: Optional[StageTimers] = None,
               device="cuda"):
    """The `filter` command on ``device``: passed/failed FASTQ files
    (``passed.fq``/``failed.fq``, or ``passed_1.fq``, ``passed_2.fq``,
    ``failed_1.fq``, ``failed_2.fq`` for paired input, where a pair passes
    only when both mates do; ``opts.out_names`` overrides the names).
    Returns the counts and the output paths."""
    dev = resolve_device(device)
    _warn_no_pallas(opts)
    with _Profiler(opts.profile_dir, dev):
        return _filter(opts, timers or StageTimers(), dev)


def _filter(opts, timers, dev):
    if _output_parallel_eligible(opts, dev):
        return _run_output_parallel(opts, timers, _filter,
                                    ("num_passed", "num_failed"), dev)
    crit = opts.criteria
    phred = opts.quality_encoding_value
    br = _batch_reads(opts, dev)
    out = {"num_passed": 0, "num_failed": 0}
    if opts.paired_end:
        return _run_filter_paired(opts, timers, crit, phred, br, dev, out)

    vfn = ShapeCachedFn(
        lambda c, q, l, v: verdicts(c, q, l, crit, phred) & v, br, dev,
        qn_ok=True)
    names = getattr(opts, "out_names", None) or ("passed.fq", "failed.fq")
    passed_path = os.path.join(opts.out_dirname, names[0])
    failed_path = os.path.join(opts.out_dirname, names[1])
    ck = _OutputCheckpointer(
        opts, "filter", crit, {"passed": passed_path, "failed": failed_path},
        out, ("num_passed", "num_failed"))
    start, sizes = ck.resume()
    rng = getattr(opts, "input_range", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts, dev),
                     start_offset=max(start, rng[0]), end_offset=rng[1],
                     timers=timers) as rd, \
            FastqWriter(passed_path, append_at=sizes.get("passed")) as pw, \
            FastqWriter(failed_path, append_at=sizes.get("failed")) as fw, \
            AsyncSpanPump() as pump:
        for block, ok in _iter_with(_coalesced(opts, rd, dev), vfn, timers,
                                    depth=getattr(opts, "batch_list_size",
                                                  0)):
            _count(timers, block)
            with timers.stage("write"):
                out["num_passed"] += block.write_selected(pw, ok, pump=pump)
                out["num_failed"] += block.write_selected(fw, ~ok, pump=pump)
            ck.step(block, {"passed": pw, "failed": fw}, timers,
                    pre_save=pump.drain)
        pump.close()
    ck.complete()
    out["passed_filename"] = passed_path
    out["failed_filename"] = failed_path
    return out


def _run_filter_paired(opts, timers, crit, phred, br, dev, out):
    """The paired branch of `filter` (``hpgq/pipeline/run.py:811-860``)."""
    pvfn = ShapeCachedPairFn(
        lambda c1, q1, l1, v1, c2, q2, l2, v2:
        (verdicts(c1, q1, l1, crit, phred) & v1)
        & (verdicts(c2, q2, l2, crit, phred) & v2),
        br, dev, qn_ok=True)
    names = getattr(opts, "out_names", None) or (
        "passed_1.fq", "passed_2.fq", "failed_1.fq", "failed_2.fq")
    paths = dict(zip(("passed_1", "passed_2", "failed_1", "failed_2"),
                     (os.path.join(opts.out_dirname, n) for n in names)))
    ck = _OutputCheckpointer(opts, "filter-paired", crit, paths, out,
                             ("num_passed", "num_failed"))
    start1, sizes, aux = ck.resume(aux_keys=("offset2",))
    rng1 = getattr(opts, "input_range", None) or (0, None)
    rng2 = getattr(opts, "input_range2", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts, dev),
                     start_offset=max(start1, rng1[0]), end_offset=rng1[1],
                     timers=timers) as r1, \
            FastqReader(opts.in_filename2,
                        batch_size=_reader_batch(opts, dev),
                        start_offset=max(aux.get("offset2", 0), rng2[0]),
                        end_offset=rng2[1], timers=timers) as r2, \
            FastqWriter(paths["passed_1"],
                        append_at=sizes.get("passed_1")) as p1, \
            FastqWriter(paths["passed_2"],
                        append_at=sizes.get("passed_2")) as p2, \
            FastqWriter(paths["failed_1"],
                        append_at=sizes.get("failed_1")) as f1, \
            FastqWriter(paths["failed_2"],
                        append_at=sizes.get("failed_2")) as f2, \
            AsyncSpanPump() as pump:
        writers = {"passed_1": p1, "passed_2": p2, "failed_1": f1,
                   "failed_2": f2}
        pairs = _iter_blocks_paired(_coalesced(opts, r1, dev),
                                    _coalesced(opts, r2, dev), timers)
        for (b1, b2), both in _iter_with(pairs, lambda p: pvfn(*p), timers):
            with timers.stage("write"):
                out["num_passed"] += b1.write_selected(p1, both, pump=pump)
                b2.write_selected(p2, both, pump=pump)
                out["num_failed"] += b1.write_selected(f1, ~both, pump=pump)
                b2.write_selected(f2, ~both, pump=pump)
            ck.step(b1, writers, timers, aux={"offset2": b2.end_offset},
                    pre_save=pump.drain)
        pump.close()
    ck.complete()
    out.update(paths)
    return out


class _OutputCheckpointer:
    """Checkpoint/resume for append-only output commands (the port of
    ``hpgq/pipeline/run.py:863-944``, with the same key, so the two
    packages resume each other's checkpoints).  State = input offset,
    each output's byte size and the counts; a resume truncates each
    output to its checkpointed size and appends from there, so the result
    is byte-identical to an uninterrupted run."""

    def __init__(self, opts, cmd: str, crit, paths: dict, counts: dict,
                 count_keys: tuple):
        self.path = opts.checkpoint_path
        self.every = opts.checkpoint_every or 50
        self.paths = paths
        self.counts = counts
        self.count_keys = count_keys
        self.nb = 0

        def _rng(name):
            r = getattr(opts, name, None)
            return r and [int(r[0]), None if r[1] is None else int(r[1])]

        self.key = json.dumps({
            "cmd": cmd,
            "in": os.path.abspath(opts.in_filename),
            "phred": opts.quality_encoding_value,
            "crit": dataclasses.astuple(crit) if crit is not None else None,
            "outs": sorted(paths),
            # a resume under other shard ranges must be refused
            "range": _rng("input_range"),
            "range2": _rng("input_range2"),
        }, sort_keys=True) if self.path else None

    def resume(self, aux_keys: tuple = ()):
        """(input_start_offset, {name: output_append_at or None}[, aux])."""
        if not self.path:
            return (0, {}, {}) if aux_keys else (0, {})
        loaded = load_counters_checkpoint(self.path, self.key)
        if not loaded:
            return (0, {}, {k: 0 for k in aux_keys}) if aux_keys else (0, {})
        _, offset, extra = loaded
        sizes = {n: int(extra["bytes_" + n]) for n in self.paths}
        for k in self.count_keys:
            self.counts[k] = int(extra[k])
        if aux_keys:
            return offset, sizes, {k: int(extra["aux_" + k])
                                   for k in aux_keys}
        return offset, sizes

    def step(self, block, writers: dict, timers, aux: dict = None,
             pre_save=None):
        if not self.path:
            return
        self.nb += 1
        if self.nb % self.every:
            return
        if pre_save is not None:
            pre_save()  # in-flight async writes land before the sizes
        with timers.stage("checkpoint"):
            extra = {}
            for name, w in writers.items():
                w.flush()
                extra["bytes_" + name] = w.tell()
            for k in self.count_keys:
                extra[k] = self.counts[k]
            for k, v in (aux or {}).items():
                extra["aux_" + k] = int(v)
            save_counters_checkpoint(self.path, None, block.end_offset,
                                     self.key, extra=extra)

    def complete(self):
        if self.path and os.path.exists(self.path):
            os.unlink(self.path)


# ---------------------------------------------------------------------------
# edit (and prepro, which is an edit run with its own output names)
# ---------------------------------------------------------------------------

def _edit_one(opts):
    """The trim + post-filter of one mate (``hpgq/pipeline/run.py:
    957-966``): ``(lt, rt, ok)``, where ``ok`` is the verdict of the
    trimmed read under the criteria without their windows, or ``valid``
    when the post-filter is off."""
    crit = opts.criteria
    phred = opts.quality_encoding_value
    filter_on = opts.filter_on
    post_crit = crit.without_windows()

    def one(codes, quals, lens, valid):
        lt, rt = trims(quals, lens, crit, phred)
        if not filter_on:
            return lt, rt, valid
        nc, nq, nl = apply_trims(codes, quals, lens, lt, rt)
        return lt, rt, verdicts(nc, nq, nl, post_crit, phred) & valid

    return one


def _make_edit_fn(opts, br: int, dev):
    return ShapeCachedFn(_edit_one(opts), br, dev, qn_ok=True)


def _make_edit_pair_fn(opts, br: int, dev):
    """Both mates in one call; a pair is kept only when both mates pass
    the post-filter."""
    one = _edit_one(opts)

    def fn(c1, q1, l1, v1, c2, q2, l2, v2):
        lt1, rt1, ok1 = one(c1, q1, l1, v1)
        lt2, rt2, ok2 = one(c2, q2, l2, v2)
        return lt1, rt1, lt2, rt2, ok1 & ok2

    return ShapeCachedPairFn(fn, br, dev, qn_ok=True)


_EDIT_COUNTS = ("num_edited", "num_passed", "num_failed")


def _num_edited(lt, rt) -> int:
    return int(((lt > 0) | (rt > 0)).sum())


def run_edit(opts: EditOptions, timers: Optional[StageTimers] = None,
             device="cuda"):
    """The `edit` command on ``device``: ``edit.fq`` (and ``failed.fq``
    with the post-filter), or ``edit_1.fq``/``edit_2.fq`` (and
    ``failed_1.fq``/``failed_2.fq``) for paired input, where a pair is
    discarded when either mate fails; ``opts.out_names`` overrides the
    edit names (`prepro` writes ``<input>.valid``).  Returns the counts
    and the output paths."""
    dev = resolve_device(device)
    _warn_no_pallas(opts)
    with _Profiler(opts.profile_dir, dev):
        return _edit(opts, timers or StageTimers(), dev)


def _edit(opts, timers, dev):
    if _output_parallel_eligible(opts, dev):
        return _run_output_parallel(opts, timers, _edit, _EDIT_COUNTS, dev)
    br = _batch_reads(opts, dev)
    out = {k: 0 for k in _EDIT_COUNTS}
    if opts.paired_end:
        return _run_edit_paired(opts, timers, br, dev, out)

    efn = _make_edit_fn(opts, br, dev)
    names = getattr(opts, "out_names", None) or ("edit.fq",)
    edit_path = os.path.join(opts.out_dirname, names[0])
    failed_path = os.path.join(opts.out_dirname, "failed.fq")
    out["edit_filename"] = edit_path
    out["failed_filename"] = failed_path if opts.filter_on else None
    paths = {"edit": edit_path}
    if opts.filter_on:
        paths["failed"] = failed_path
    ck = _OutputCheckpointer(opts, "edit", opts.criteria, paths, out,
                             _EDIT_COUNTS)
    start, sizes = ck.resume()
    rng = getattr(opts, "input_range", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts, dev),
                     start_offset=max(start, rng[0]), end_offset=rng[1],
                     timers=timers) as rd, \
            contextlib.ExitStack() as stack:
        writers = {k: stack.enter_context(FastqWriter(
            p, append_at=sizes.get(k))) for k, p in paths.items()}
        pump = stack.enter_context(AsyncSpanPump())
        for block, (lt, rt, ok) in _iter_with(
                _coalesced(opts, rd, dev), efn, timers,
                depth=getattr(opts, "batch_list_size", 0)):
            _count(timers, block)
            with timers.stage("write"):
                out["num_edited"] += _num_edited(lt, rt)
                if opts.filter_on:
                    out["num_passed"] += block.write_trimmed(
                        writers["edit"], lt, rt, select=ok, pump=pump)
                    out["num_failed"] += block.write_trimmed(
                        writers["failed"], lt, rt, select=~ok, pump=pump)
                else:
                    block.write_trimmed(writers["edit"], lt, rt, pump=pump)
            ck.step(block, writers, timers, pre_save=pump.drain)
        pump.close()
    ck.complete()
    return out


def _run_edit_paired(opts, timers, br, dev, out):
    """The paired branch of `edit` (``hpgq/pipeline/run.py:1079-1152``).
    The writers open (truncating) only after both readers have opened, so
    a bad mate-2 path leaves the previous run's outputs as they were."""
    names = getattr(opts, "out_names", None) or ("edit_1.fq", "edit_2.fq")
    paths = {"edit_1": os.path.join(opts.out_dirname, names[0]),
             "edit_2": os.path.join(opts.out_dirname, names[1])}
    if opts.filter_on:
        paths["failed_1"] = os.path.join(opts.out_dirname, "failed_1.fq")
        paths["failed_2"] = os.path.join(opts.out_dirname, "failed_2.fq")
    ck = _OutputCheckpointer(opts, "edit-paired", opts.criteria, paths, out,
                             _EDIT_COUNTS)
    start1, sizes, aux = ck.resume(aux_keys=("offset2",))
    rng1 = getattr(opts, "input_range", None) or (0, None)
    rng2 = getattr(opts, "input_range2", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts, dev),
                     start_offset=max(start1, rng1[0]), end_offset=rng1[1],
                     timers=timers) as r1, \
            FastqReader(opts.in_filename2,
                        batch_size=_reader_batch(opts, dev),
                        start_offset=max(aux.get("offset2", 0), rng2[0]),
                        end_offset=rng2[1], timers=timers) as r2, \
            contextlib.ExitStack() as stack:
        w = {k: stack.enter_context(FastqWriter(p, append_at=sizes.get(k)))
             for k, p in paths.items()}
        pump = stack.enter_context(AsyncSpanPump())
        pefn = _make_edit_pair_fn(opts, br, dev)
        pairs = _iter_blocks_paired(_coalesced(opts, r1, dev),
                                    _coalesced(opts, r2, dev), timers)
        for (b1, b2), (lt1, rt1, lt2, rt2, both) in _iter_with(
                pairs, lambda p: pefn(*p), timers):
            with timers.stage("write"):
                out["num_edited"] += _num_edited(lt1, rt1) + _num_edited(
                    lt2, rt2)
                if opts.filter_on:
                    out["num_passed"] += b1.write_trimmed(
                        w["edit_1"], lt1, rt1, select=both, pump=pump)
                    b2.write_trimmed(w["edit_2"], lt2, rt2, select=both,
                                     pump=pump)
                    out["num_failed"] += b1.write_trimmed(
                        w["failed_1"], lt1, rt1, select=~both, pump=pump)
                    b2.write_trimmed(w["failed_2"], lt2, rt2, select=~both,
                                     pump=pump)
                else:
                    b1.write_trimmed(w["edit_1"], lt1, rt1, pump=pump)
                    b2.write_trimmed(w["edit_2"], lt2, rt2, pump=pump)
            ck.step(b1, w, timers, aux={"offset2": b2.end_offset},
                    pre_save=pump.drain)
        pump.close()
    ck.complete()
    out.update(paths)
    return out
