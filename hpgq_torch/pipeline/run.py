"""The `stats` pipeline, single-end: read -> pack -> copy -> step -> report.

The port of ``hpgq/pipeline/run.py``'s single-end ``run_stats``
(``:463-525``) with its helpers and the concurrent shard readers of
``_run_stats_parallel`` (``:356-411``).  What changed on the way:

* Every ``jax.default_backend()`` test is a test of the session's device.
* ``jax.device_put`` became a pinned host buffer and a ``non_blocking``
  copy on a side stream, issued from the packing pool thread.  The copy
  records a CUDA event; the stream that runs the step waits on it, and the
  pinned buffers stay referenced until the step has been enqueued.
* Each shard thread runs its steps on its own ``torch.cuda.Stream``.

Paired input, ``--kmers``, ``--sharded``, ``--profile-dir`` and reads over
4096 on CUDA raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
from typing import Optional

import torch

from hpgq.constants import DEFAULT_BATCH_SIZE
from hpgq.io.fastq import FastqReader
from hpgq.io.packer import round_up
from hpgq.options import StatsOptions
from hpgq.pipeline.prefetch import prefetched
from hpgq.report.stats_report import stats_report
from hpgq.utils.timers import StageTimers

from ..device import resolve_device
from .ranges import range_splittable, split_byte_ranges
from .session import StatsSession, to_device

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
    from hpgq.io.fastq import coalesce_blocks

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


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for a in x:
            yield from _tensors(a)


def _iter_packed(reader, sess, batch_reads: int, timers, depth: int = 0,
                 workers: int = 0):
    """(block, device args for ``sess.feed_packed``) with the host pack and
    the host-to-device copy of the next batches running in a thread pool
    while the current step runs."""
    dev = sess.device
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def transform(block):
        packed = sess.pack(block, batch_reads)
        if copy_stream is None:
            return block, to_device(packed, dev), None, None
        keep = []
        with torch.cuda.stream(copy_stream):
            arrs = to_device(packed, dev, non_blocking=True, keep=keep)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return block, arrs, done, keep

    workers = workers or _pack_workers()
    it = prefetched(iter(reader), depth=depth or (workers + 2),
                    transform=transform, workers=workers)
    while True:
        with timers.stage("read"):
            item = next(it, None)
        if item is None:
            return
        block, arrs, done, keep = item
        if done is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            for t in _tensors(arrs):  # allocated on the copy stream
                t.record_stream(cur)
        timers.num_batches += 1
        timers.total_reads += block.num_reads
        timers.total_bytes += block.span_bytes
        yield block, arrs
        del keep  # the step that reads these copies is enqueued by now


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
    already uses every core): no checkpoint, no explicit range, a
    byte-seekable input of at least 32 MiB.  HPGQ_READ_SHARDS forces."""
    if (opts.checkpoint_path
            or getattr(opts, "input_range", None) is not None
            or _read_shards() <= 1
            or not (opts.in_filename and os.path.exists(opts.in_filename))
            or os.path.getsize(opts.in_filename) < _PARALLEL_MIN_BYTES):
        return False
    if not os.environ.get("HPGQ_READ_SHARDS") and device.type == "cpu":
        return False
    return range_splittable(opts.in_filename)


def _stream_ctx(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def _run_stats_parallel(opts, timers, crit, br, nshards: int, device,
                        report: bool = True):
    """Single-end stats over ``nshards`` concurrent byte-range readers,
    each with its own session (and CUDA stream); host counters merge in
    shard order, so every integer field is deterministic."""
    ranges = split_byte_ranges(opts.in_filename, nshards)
    results = [None] * nshards
    errors = []

    def work(i: int, start: int, end: int):
        try:
            t = StageTimers()
            stream = torch.cuda.Stream(device) if device.type == "cuda" \
                else None
            with _stream_ctx(stream):
                sess = StatsSession(opts.quality_encoding_value, crit,
                                    batch_reads=br, device=device)
                with FastqReader(opts.in_filename,
                                 batch_size=_reader_batch(opts, device),
                                 start_offset=start, end_offset=end) as rd:
                    for _, arrs in _iter_packed(_coalesced(opts, rd, device),
                                                sess, br, t, workers=1):
                        with t.stage("compute"):
                            sess.feed_packed(*arrs)
                with t.stage("compute"):
                    results[i] = (sess.finish(), t)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i, s, e), daemon=True,
                                name="hpgq-torch-shard%d" % i)
               for i, (s, e) in enumerate(ranges)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    counters = None
    for res, t in results:
        timers.merge_from(t)
        counters = res if counters is None else counters.merge(res)
    if report:
        with timers.stage("reporting"):
            stats_report(counters, opts)
    return counters


def _check_ported(opts) -> None:
    missing = [
        (opts.paired_end, "paired-end input", 7),
        (opts.kmers_on, "--kmers", 8),
        (getattr(opts, "sharded", False), "--sharded", 14),
        (getattr(opts, "profile_dir", None), "--profile-dir", 16),
    ]
    for cond, what, item in missing:
        if cond:
            raise NotImplementedError(
                "hpgq_torch stats: %s is not ported yet (ROADMAP.md queue 1 "
                "item %d); use hpgq for it" % (what, item))
    if not getattr(opts, "use_pallas", True):
        logging.getLogger("hpgq").warning(
            "--no-pallas has no effect in hpgq_torch: CUDA runs the K1 "
            "kernel, the CPU its plain twin")


def run_stats(opts: StatsOptions, timers: Optional[StageTimers] = None,
              report: bool = True, device="cuda"):
    """The `stats` command, single-end, on ``device`` ("cuda" or "cpu").
    Returns the merged :class:`~hpgq.core.counters.StatsCounters`."""
    from hpgq.utils.checkpoint import (
        load_counters_checkpoint,
        save_counters_checkpoint,
    )

    dev = resolve_device(device)
    _check_ported(opts)
    timers = timers or StageTimers()
    crit = opts.criteria if opts.filter_on else None
    br = _batch_reads(opts, dev)
    if _output_parallel_eligible(opts, dev):
        return _run_stats_parallel(opts, timers, crit, br, _read_shards(),
                                   dev, report=report)

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
                        lcap=max(128, resumed.lcap) if resumed else 128)
    if resumed:
        resumed.ensure_length(sess.lcap)
        sess.acc.counters = resumed
    nb = 0
    rng = getattr(opts, "input_range", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts, dev),
                     start_offset=max(start, rng[0]),
                     end_offset=rng[1]) as rd:
        for block, arrs in _iter_packed(
                _coalesced(opts, rd, dev), sess, br, timers,
                depth=getattr(opts, "batch_list_size", 0)):
            with timers.stage("compute"):
                sess.feed_packed(*arrs)
            nb += 1
            if ck_path and nb % ck_every == 0:
                with timers.stage("checkpoint"):
                    sess.acc.flush()
                    save_counters_checkpoint(ck_path, sess.acc.counters,
                                             block.end_offset, ck_key)
    with timers.stage("compute"):
        counters = sess.finish()
    if ck_path and os.path.exists(ck_path):
        os.unlink(ck_path)  # run completed; a stale resume would re-read
    if report:
        with timers.stage("reporting"):
            stats_report(counters, opts)
    return counters
