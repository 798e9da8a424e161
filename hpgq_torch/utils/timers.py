"""The port's own copy of ``hpgq/utils/timers.py`` (the port imports nothing of
``hpgq``), with two additions: each stage's first entry is stamped
(``first``: a launched rank's first batch ends its start-up split), and
the report also prints the stages beyond the reference's list (a sharded
run's ``vote``, ``finish-merge`` and ``launch-*`` stages).

Per-stage wall-clock timers (the reference's --t instrumentation,
``old/main_hpg_fastq_old.c:49-80,741-763``) adapted to the TPU pipeline's
stages: read, pack, h2d (device transfer+dispatch), compute (device sync),
write, reporting."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class StageTimers:
    def __init__(self):
        self.totals = {}
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
            yield
        finally:
            dt = time.perf_counter() - t
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def merge_from(self, other: "StageTimers") -> None:
        """Fold a worker's timers in (parallel shard readers): stage totals
        are summed CPU-time-style, so per-batch columns stay meaningful;
        wall-clock `total()` remains this timer's own."""
        for k, v in other.totals.items():
            self.totals[k] = self.totals.get(k, 0.0) + v
        for k, v in other.first.items():
            self.first[k] = min(v, self.first.get(k, v))
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
        named = ("read", "pack", "h2d", "compute", "write", "checkpoint",
                 "reporting")
        for name in named + tuple(k for k in self.totals if k not in named):
            if name in self.totals:
                t = self.totals[name]
                print(
                    "total %-15s (s): \t%10.5f\t\tper batch: %10.5f"
                    % (name + " time", t, t / nb),
                    file=out,
                )
        if self.total_reads and total > 0:
            print("", file=out)
            print(
                "throughput            : \t%10.0f reads/s" % (self.total_reads / total),
                file=out,
            )
