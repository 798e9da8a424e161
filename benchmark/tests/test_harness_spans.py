"""The pipeline's span metrics: a traced run of the gzip cell reports each
of them, from the stages the program enters on its own threads, and each
reader reads nothing from a run whose program has not its stage."""

import pytest

from benchmark.harness import cell as run_cell, spec
from conftest import drive

SPANS = {"reader_wait_share": "wait-reader", "pack_wait_share": "wait-pack",
         "inflate_busy_share": "inflate", "index_busy_share": "index"}


def test_traced_gzip_cell_reports_the_spans(small_root, monkeypatch):
    """The consumer's wait split by what it waits on, within the wait it
    splits, and the inflate and index threads' busy shares within 100%.
    Two pack threads, so that the CPU runs the pool as a card's host
    does."""
    monkeypatch.setenv("HPGQ_PACK_THREADS", "2")
    rc, result = drive(small_root, "se100_gz_stats_filter", trace=1)
    assert rc == 0 and result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPANS) <= set(got), got
    assert all(got[k] > 0 for k in SPANS), got
    assert got["reader_wait_share"] + got["pack_wait_share"] \
        <= got["input_wait_share"] + 1e-6
    assert got["inflate_busy_share"] <= 100 and got["index_busy_share"] <= 100


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_reads_nothing_without_its_stage(metric):
    """A run of a program that enters only the consumer's stages (as the
    program did before these spans) reads None, and does not raise."""
    stages = {"read": 2.0, "compute": 1.0, "reporting": 0.1}
    run = run_cell.Run(stages=stages, rank_stages=[stages], window_s=3.5,
                       world=1)
    read = spec.reader(metric)
    assert read(run) is None
    run.stages = dict(stages, **{SPANS[metric]: 0.5})
    assert read(run) > 0
