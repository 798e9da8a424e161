"""Each control comes out not correct: the reference put in the program's
place with one float of ``acc_quality`` one precision step lower (its sum
a float32 running total, or each read's mean in bfloat16), against the
limits the cells commit.  The files hold 300,000 reads, where a float32
running total already drifts past the limit; at the cells' own sizes the
drift is larger (``PERF.md``)."""

import pytest

from benchmark.commands import stats
from benchmark.harness import spec
from benchmark.harness.cell import correct
from benchmark.reference.stats import CONTROLS
from benchmark.traffic.generate import make_corpus, read_count
from conftest import make_root

CELLS = ("se100_stats_filter", "se100_gz_stats_filter", "se100_stats_filter_4card")
READS = 300_000


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tmp_path, workload):
    root = make_root(tmp_path / "checkout", reads={})
    cell = spec.load(workload, root)
    cell.config["reads_per_file"] = READS // read_count(
        dict(cell.config, reads_per_file=1), cell.traffic)
    corpus = make_corpus(cell.config, cell.traffic, 123456789012, str(tmp_path))
    assert corpus.reads == READS
    controls = stats.control(cell, corpus, str(tmp_path / "out"))
    assert set(controls) == set(CONTROLS)
    for name, numbers in controls.items():
        assert numbers["counter_fields_off"]["value"] == 0, name
        assert not correct(numbers), name
