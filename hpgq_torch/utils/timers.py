"""The port's stage timers: a copy of ``hpgq/utils/timers.py`` (the port
imports nothing of ``hpgq``) grown into the port's one tracing system.

Per-stage wall-clock timers (the reference's --t instrumentation,
``old/main_hpg_fastq_old.c:49-80,741-763``), entered on the thread that
does each piece of work:

* ``inflate`` (the ``hpgq-gunzip`` thread, or a BGZF member on the
  ``bgzf`` pool), ``index`` (the newline index, line table and record
  check of a chunk, on the reader thread: ``hpgq-reader`` or
  ``hpgq-producer``), ``pack`` and ``h2d`` (a block packed and copied to
  the device, on an ``hpgq-pack`` thread or a shard's producer);
* ``read``, the consumer's wait for its next block, which on a pack pool
  splits into ``wait-reader`` (the reader had not handed the block over)
  and ``wait-pack`` (its pack and copy were not done);
* ``wait-mate-1`` and ``wait-mate-2``, on paired input the wait of the
  thread that pairs the mates' blocks (a pack pool's ``hpgq-reader``)
  for each mate's next block;
* ``compute`` (the consumer feeding the device step) with ``fold`` (the
  device's partials folded into the host counters) and ``grow`` (a stats
  session's growth to wider reads: the fold and a wider accumulator)
  inside it, ``write``,
  ``checkpoint`` and ``reporting``; a sharded run's ``vote`` and
  ``finish-merge``, and a launched rank's ``launch-*`` start-up split.

Each stage's first entry is stamped (``first``: a launched rank's first
batch ends its start-up split).  While a torch profiler runs, each stage
is also a ``stage.<name>`` range of its trace, on the thread that entered
it and on the clock of the device's kernels and copies; with no profiler
a stage costs two clock reads, a lock and the profiler flag's test.

Besides the stages, counts: integers summed under the same lock
(``count``), such as the bytes each gzip piece inflated to, under the
decoder that inflated it (``inflate-native-bytes``, or
``inflate-zlib-bytes`` where the native library is not built), or a
stats session's growths (``grow``), its long-read blocks sent as one
ragged wire (``long-ragged``) or as length classes (``long-fallback``)
and their bytes (``long-bytes``, of them ``long-pad-bytes`` past the
reads' ends), or the
native calls whose OpenMP team came up smaller than the plan of the host's
cores asked (``team-short``, counted by the threads that index and pack),
or the pairs of mate blocks cut short because one mate's block ended
before the other's (``pair-cuts``);
``--t`` prints them after the stages, then the notes: each reader's plan
of the host's cores (:func:`hpgq_torch.io.native.plan`)."""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager, nullcontext

# the stages of --t's report in pipeline order, then any other in the
# order first entered
ORDER = ("inflate", "index", "pack", "h2d", "read", "wait-mate-1",
         "wait-mate-2", "wait-reader", "wait-pack", "compute", "fold",
         "grow", "write", "checkpoint", "reporting")


def _profiling() -> bool:
    """True while a torch profiler runs in this process, on any thread
    (torch's process-wide flag; with torch not loaded none can run)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _range(name: str):
    import torch.profiler

    return torch.profiler.record_function("stage." + name)


class StageTimers:
    def __init__(self):
        self.totals = {}
        self.counts = {}  # name -> an integer summed over the pass
        self.notes = []  # lines --t prints last (each reader's plan)
        self.num_batches = 0
        self.total_reads = 0
        self.total_bytes = 0
        self.first = {}  # stage -> wall-clock time of its first entry
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()  # stages accumulate from pool workers

    @contextmanager
    def stage(self, name: str):
        if name not in self.first:
            self.first.setdefault(name, time.time())
        t = time.perf_counter()
        try:
            if _profiling():
                with _range(name):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the count ``name`` (from any thread)."""
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + int(n)

    def note(self, text: str) -> None:
        """Keep a line for the report (from any thread)."""
        with self._lock:
            self.notes.append(text)

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def merge_from(self, other: "StageTimers") -> None:
        """Fold a worker's timers in (parallel shard readers): stage totals
        and counts are summed CPU-time-style, so per-batch columns stay
        meaningful; wall-clock `total()` remains this timer's own."""
        for k, v in other.totals.items():
            self.totals[k] = self.totals.get(k, 0.0) + v
        for k, v in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + v
        for k, v in other.first.items():
            self.first[k] = min(v, self.first.get(k, v))
        self.notes.extend(other.notes)
        self.num_batches += other.num_batches
        self.total_reads += other.total_reads
        self.total_bytes += other.total_bytes

    def report(self, out=None) -> None:
        import sys

        out = out or sys.stdout
        total = self.total()
        nb = max(self.num_batches, 1)
        print("", file=out)
        print("number of batches     : \t%10i\n" % self.num_batches, file=out)
        if self.num_batches:
            print(
                "mean reads per batch  : \t%10.2f" % (self.total_reads / nb), file=out
            )
            print(
                "mean batch size (KB)  : \t%10.2f\n"
                % (self.total_bytes / nb / 1024),
                file=out,
            )
        print("total time            (s): \t%10.5f" % total, file=out)
        print("", file=out)
        for name in ORDER + tuple(k for k in self.totals if k not in ORDER):
            if name in self.totals:
                t = self.totals[name]
                print(
                    "total %-15s (s): \t%10.5f\t\tper batch: %10.5f"
                    % (name + " time", t, t / nb),
                    file=out,
                )
        for name in sorted(self.counts):
            print("count %-21s: \t%10i" % (name, self.counts[name]), file=out)
        for text in self.notes:
            print(text, file=out)
        if self.total_reads and total > 0:
            print("", file=out)
            print(
                "throughput            : \t%10.0f reads/s" % (self.total_reads / total),
                file=out,
            )


class _NoTimers:
    """Timers that time nothing: the default of the readers, which run
    without a pass's timers in the tools and tests."""

    def stage(self, name: str):
        return nullcontext()

    def count(self, name: str, n: int) -> None:
        pass

    def note(self, text: str) -> None:
        pass


NO_TIMERS = _NoTimers()
