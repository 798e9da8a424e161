"""The Nanopore cell, ``ont_chunk_gz_stats_filter``: its generator draws
the configuration's chunk (read N50 10.6 kb, the same lengths for every
seed, 8-15% of reads under mean Q7, no N), a run of it is correct on the
CPU and reports ``grow_share`` beside the pipeline's metrics, both
controls fail its limit, and on a card it runs as on the CPU."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from benchmark.commands import stats
from benchmark.harness import cell as run_cell, spec
from benchmark.reference.stats import CONTROLS
from benchmark.traffic import generate_ont
from benchmark.traffic.generate import lengths
from conftest import SMALL_READS, drive, make_root

CELL = "ont_chunk_gz_stats_filter"
SEEDS = (7, 2**31 + 12345, 98765432109)


def _n50(lens) -> int:
    x = np.sort(lens)[::-1]
    c = np.cumsum(x)
    return int(x[np.searchsorted(c, c[-1] / 2)])


@pytest.fixture
def ont_root(tmp_path, monkeypatch):
    """A checkout whose chunk holds 40 reads; no PNG charts (the check
    reads none, and drawing 10k-bar charts takes the CPU minutes)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("HPGQ_CHARTS", "off")
    return make_root(tmp_path / "checkout",
                     reads={**SMALL_READS, "minion_r94_na12878_chunk": 40})


def test_chunk_lengths_hold_the_read_n50():
    """One chunk's read N50 is 10.6 kb within 3%, and every seed draws the
    same set of lengths in another order."""
    cell = spec.load(CELL)
    n = cell.config["reads_per_file"]
    drawn = [lengths(cell.config, n, np.random.default_rng(s)) for s in SEEDS]
    assert abs(_n50(drawn[0]) - 10600) <= 0.03 * 10600
    for d in drawn[1:]:
        assert np.array_equal(np.sort(d), np.sort(drawn[0]))
        assert not np.array_equal(d, drawn[0])
    chunk = cell.config["one_chunk"]
    assert (chunk["read_n50"], chunk["max_length"], chunk["bases"]) == (
        _n50(drawn[0]), int(drawn[0].max()), int(drawn[0].sum()))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_chunk_qualities_split_at_q7(tmp_path, seed):
    """A whole chunk: 8-15% of its reads under mean Q7, qualities Q1-Q40,
    no N."""
    cell = spec.load(CELL)
    corpus = generate_ont.make_corpus(cell.config, dict(cell.traffic, format="plain"),
                                      seed, str(tmp_path))
    q = corpus.qual.astype(np.int64) - 33
    assert q.min() >= 1 and q.max() <= 40
    under = np.add.reduceat(q, corpus.starts) < 7 * corpus.lens
    assert 0.08 <= under.mean() <= 0.15
    assert not (corpus.seq == ord("N")).any()


@pytest.mark.parametrize("trace", (0, 1))
def test_cell_runs_correct(ont_root, trace):
    """A CPU run of the cell ends correct; traced, it reports the
    pipeline's metrics and ``grow_share`` (every pass grows at least from
    the first 128 columns)."""
    rc, result = drive(ont_root, CELL, trace=trace)
    assert rc == 0 and result["correct"], result
    assert result["run"]["reads_per_pass"] == 40
    got = set(result["metrics"])
    if trace:
        assert {"grow_share", "inflate_busy_share", "report_share",
                "input_wait_share"} <= got, got
        assert 0 < result["metrics"]["grow_share"]["value"] < 100
    else:
        assert got == {"bases_per_s", "setup_s"}


def test_grow_share_reads_nothing_without_its_stage():
    """A run whose program enters no ``grow`` stage reads None, and does
    not raise."""
    stages = {"read": 2.0, "compute": 1.0, "reporting": 0.1}
    run = run_cell.Run(stages=stages, rank_stages=[stages], window_s=4.0, world=1)
    read = spec.reader("grow_share")
    assert read(run) is None
    run.stages = dict(stages, grow=0.2)
    assert read(run) == pytest.approx(5.0)


def test_both_controls_fail_the_limit(tmp_path):
    """Each control, one float of the quality sum one precision step
    lower, is not correct against the cell's limit, by orders of
    magnitude; 400 reads, a tenth of a chunk."""
    cell = spec.load(CELL)
    cell.config["reads_per_file"] = 400
    corpus = generate_ont.make_corpus(cell.config, cell.traffic, 123456789012,
                                      str(tmp_path))
    controls = stats.control(cell, corpus, str(tmp_path / "out"))
    assert set(controls) == set(CONTROLS)
    for name, numbers in controls.items():
        assert numbers["counter_fields_off"]["value"] == 0, name
        assert not run_cell.correct(numbers), name
        gap = numbers["acc_quality_gap"]
        assert gap["value"] > 1000 * gap["limit"], (name, gap)


@pytest.mark.card
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_on_card(cards, tmp_path, trace):
    """The cell at its full size on a card: correct, on the card."""
    if cards < 1:
        pytest.skip("needs a CUDA card, this machine has none")
    root = make_root(tmp_path / "checkout", reads={})
    import run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", "918273645",
                       "--seconds", "2", "--trace", str(trace)], root=root)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert "grow_share" in result["metrics"]
        assert result["metrics"]["kernel_roofline_share"]["value"] <= 100
