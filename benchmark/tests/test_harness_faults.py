"""A run with the timed path broken underneath it comes out not correct.

Each case drives the rest of a run on the CPU (the look for a card
skipped) with one fault planted in the program of this process, rank 0:
a step that leaves its state unchanged, half of each batch left out, an
answer altered where it is produced (a counter, the quality sum, a report
byte), and in the sharded cell the exchange between ranks left out."""

import os

import pytest

from conftest import drive


def _state_unchanged(monkeypatch):
    from hpgq_torch.pipeline.session import StatsSession

    monkeypatch.setattr(StatsSession, "feed_packed", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from hpgq_torch.pipeline.session import StatsSession

    pack = StatsSession.pack
    monkeypatch.setattr(StatsSession, "pack", lambda self, block, batch_reads=0: pack(
        self, block.slice(0, max(1, block.num_reads // 2)), batch_reads))


def _counter_altered(monkeypatch):
    from hpgq_torch.pipeline.session import StatsSession

    finish = StatsSession.finish

    def altered(self):
        c = finish(self)
        c.num_Ts += 1
        return c

    monkeypatch.setattr(StatsSession, "finish", altered)


def _quality_altered(monkeypatch):
    from hpgq_torch.pipeline.session import StatsSession

    finish = StatsSession.finish

    def altered(self):
        c = finish(self)
        c.acc_quality *= 1 + 1e-3
        return c

    monkeypatch.setattr(StatsSession, "finish", altered)


def _report_altered(monkeypatch):
    from hpgq_torch.pipeline import run
    from hpgq_torch.dist import run_dist

    def altered(report):
        def write(counters, opts, *a):
            counters.max_length -= 1
            report(counters, opts, *a)
            counters.max_length += 1
        return write

    monkeypatch.setattr(run, "stats_report", altered(run.stats_report))
    monkeypatch.setattr(run_dist, "stats_report", altered(run_dist.stats_report))


def _exchange_left_out(monkeypatch):
    from hpgq_torch.dist import run_dist

    merge = run_dist.sharded_counters

    def local(pg, c):
        merge(pg, c)  # the other ranks still meet this rank
        return c

    monkeypatch.setattr(run_dist, "sharded_counters", local)


FAULTS = [_state_unchanged, _half_batch, _counter_altered, _quality_altered,
          _report_altered]
CASES = ([("se100_stats_filter", None, f) for f in FAULTS]
         + [("long_reads_stats_filter", None, f) for f in FAULTS]
         + [("se100_stats_filter_4card", 2, f) for f in FAULTS + [_exchange_left_out]])


@pytest.mark.parametrize("workload,world", [
    ("se100_stats_filter", None), ("long_reads_stats_filter", None),
    ("se100_gz_stats_filter", None), ("se100_stats_filter_4card", 2)])
def test_sound_run_is_correct(small_root, workload, world):
    rc, result = drive(small_root, workload, trace=1, world=world)
    assert rc == 0 and result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert not _children(), "the run left processes behind"


def _children():
    """The pids of this process's children that are still there."""
    pids = []
    for d in os.listdir("/proc"):
        try:
            with open("/proc/%s/stat" % d) as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == os.getpid():
                    pids.append(int(d))
        except (OSError, ValueError, IndexError):
            continue
    return pids


@pytest.mark.parametrize("workload,world,fault", CASES,
                         ids=["%s-%s" % (w, f.__name__.strip("_")) for w, _, f in CASES])
def test_fault_is_caught(small_root, monkeypatch, workload, world, fault):
    fault(monkeypatch)
    rc, result = drive(small_root, workload, world=world)
    assert rc == 0 and not result["correct"] and result["failed"] > 0
