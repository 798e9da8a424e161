"""Stage breakdown of the port's ``stats --filter`` path on one device.

    python -m hpgq_torch.breakdown reads.fq [--device cuda] [--turns 4]

First end to end: the default configuration against fewer shard readers
and the plain wire (``HPGQ_READ_SHARDS``, ``HPGQ_WIRE``), the arms run in
turns (forward, then backward, ...) so that drift on a shared host falls
on every arm alike; every pass's time is printed, then the best and the
median.  Then each stage alone, one thread, over the whole file: read with
its newline index, the session's pack, the pinned copy, and the device
steps over batches already on the device.  On CUDA also the device's busy
share over one profiled default pass.  The filter is the bench's
(``bench.py:58-61``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys
import tempfile
import time

import torch

from .api import _common
from .constants import DEFAULT_BATCH_SIZE
from .io.fastq import FastqReader
from .options import StatsOptions
from .utils.timers import StageTimers

from .api import filter_criteria
from .device import resolve_device
from .pipeline.run import run_stats
from .pipeline.session import StatsSession, to_device

BENCH_FILTER = dict(read_length_range=(50, 200), read_quality_range=(20, 60),
                    max_N=2)
ARMS = [  # (label, environment)
    ("default", {}),
    ("1 shard", {"HPGQ_READ_SHARDS": "1"}),
    ("2 shards", {"HPGQ_READ_SHARDS": "2"}),
    ("plain wire", {"HPGQ_WIRE": "off"}),
    ("plain wire, 1 shard", {"HPGQ_WIRE": "off", "HPGQ_READ_SHARDS": "1"}),
]
READER_BATCH = 131072


@contextlib.contextmanager
def environ(env):
    """Set the environment variables of ``env`` for the block."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _opts(path, outdir):
    opts = _common(StatsOptions(), path, None, outdir, "phred33",
                   DEFAULT_BATCH_SIZE, None, False)
    opts.criteria = filter_criteria(**BENCH_FILTER)
    opts.filter_on = True
    return opts


def _pass(path, outdir, dev, timers=None):
    t0 = time.perf_counter()
    counters = run_stats(_opts(path, outdir), timers, device=dev)
    _sync(dev)
    return time.perf_counter() - t0, counters.num_passed + counters.num_failed


def end_to_end(path, outdir, dev, turns: int, out=None):
    """Wall seconds of every pass, by arm, the arms run in turns; printed
    to ``out`` (``sys.stdout`` as it is at the call)."""
    out = out or sys.stdout
    _pass(path, outdir, dev)  # warm: kernel build, allocator, page cache
    times = {label: [] for label, _ in ARMS}
    n = 0
    for turn in range(turns):
        for label, env in (ARMS if turn % 2 == 0 else ARMS[::-1]):
            with environ(env):
                dt, n = _pass(path, outdir, dev)
            times[label].append(dt)
    for label, ts in times.items():
        print("e2e %-20s passes %s s; best %.0f reads/s, median %.0f reads/s"
              % (label, " ".join("%.3f" % t for t in ts), n / min(ts),
                 n / statistics.median(ts)), file=out, flush=True)
    timers = StageTimers()
    _pass(path, outdir, dev, timers)
    print("stage timers of one default pass (summed over shard threads):",
          file=out, flush=True)
    timers.report(out)
    return times


def stages(path, dev, out=None) -> dict:
    """Each stage alone, one thread, over the whole file; prints each to
    ``out`` (``sys.stdout`` as it is at the call) and returns the numbers
    (``busy`` only on CUDA: the profiled steps' ``(device ms, K1/K2 ms,
    wall ms)``, None where the profiler saw no device)."""
    out = out or sys.stdout
    res = {}
    t0 = time.perf_counter()
    with FastqReader(path, batch_size=READER_BATCH) as rd:
        blocks = list(rd)
    dt = time.perf_counter() - t0
    n = sum(b.num_reads for b in blocks)
    res["read_reads_per_sec"] = n / dt
    print("read + newline index: %.3f s = %.0f reads/s (%d blocks)"
          % (dt, n / dt, len(blocks)), file=out, flush=True)

    sess = StatsSession(33, filter_criteria(**BENCH_FILTER),
                        batch_reads=READER_BATCH, device=dev)
    t0 = time.perf_counter()
    packed = [sess.pack(b, READER_BATCH) for b in blocks]
    dt = time.perf_counter() - t0
    nbytes = sum(a.nbytes for p in packed for a in _arrays(p))
    res.update(pack_reads_per_sec=n / dt, wire_bytes_per_read=nbytes / n)
    print("pack (wire %s): %.3f s = %.0f reads/s, %.1f wire bytes/read"
          % (sess.acc.wire, dt, n / dt, nbytes / n), file=out, flush=True)

    _sync(dev)
    t0 = time.perf_counter()
    on_dev = [to_device(p, dev) for p in packed]
    _sync(dev)
    dt = time.perf_counter() - t0
    res["copy_mb_per_sec"] = nbytes / dt / 1e6
    print("pin + copy to %s: %.3f s = %.0f MB/s"
          % (dev, dt, nbytes / dt / 1e6), file=out, flush=True)

    for args in on_dev[:2]:  # warm
        sess.feed_packed(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for args in on_dev:
        sess.feed_packed(*args)
    _sync(dev)
    dt = time.perf_counter() - t0
    res["steps_ms_per_batch"] = dt * 1e3 / len(on_dev)
    print("device steps (decode, pad, K1/K2, merge), %d batches on the "
          "device: "
          "%.3f ms = %.3f ms/batch wall" % (len(on_dev), dt * 1e3,
                                           dt * 1e3 / len(on_dev)),
          file=out, flush=True)
    if dev.type == "cuda":
        res["busy"] = _device_ms(lambda: [sess.feed_packed(*a)
                                          for a in on_dev], dev)
        print("  of which device time %s" % _fmt_busy(res["busy"]),
              file=out, flush=True)
    return res


def _arrays(x):
    if isinstance(x, tuple):
        for a in x:
            yield from _arrays(a)
    elif hasattr(x, "nbytes"):
        yield x


def _device_ms(fn, dev):
    """(total device ms of kernels and copies, the stats kernels' ms (K1
    and K2), wall ms) of one profiled call of ``fn``, or None where the
    profiler saw no device."""
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    total = k1 = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        total += us
        if "stats_k1_kernel" in ev.key or "stats_k2_" in ev.key:
            k1 += us
    if not total:
        return None
    return total / 1e3, k1 / 1e3, wall * 1e3


def _fmt_busy(busy):
    if busy is None:
        return "not measured (the profiler saw no device time)"
    total, k1, wall = busy
    return ("%.3f ms (K1/K2 %.3f ms) in %.3f ms wall: busy share %.4f"
            % (total, k1, wall, total / wall))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("fastq")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--turns", type=int, default=4,
                    help="end-to-end passes per arm, in turns (default 4)")
    args = ap.parse_args(argv)
    os.environ.setdefault("HPGQ_CHARTS", "off")
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="hpgq_torch_breakdown_") as out:
        end_to_end(args.fastq, out, dev, args.turns)
        stages(args.fastq, dev)
        if dev.type == "cuda":
            busy = _device_ms(lambda: _pass(args.fastq, out, dev), dev)
            print("one profiled default pass: device %s" % _fmt_busy(busy),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
