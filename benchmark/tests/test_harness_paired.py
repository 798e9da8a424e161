"""The paired-end cell, ``pe150_gz_stats_filter``: a run of it is correct
on the CPU, counts both mates' reads and bases and reports
``mate_wait_share`` beside the pipeline's metrics, and on a card it runs
as on the CPU.  Its generator, reference and controls are held on the
CPU by ``tests/test_torch_paired_chunk.py``."""

import io
import json
from contextlib import redirect_stdout

import pytest

from benchmark.harness import cell as run_cell, spec
from conftest import SMALL_READS, drive, make_root

CELL = "pe150_gz_stats_filter"
PAIRS = 1500


@pytest.fixture
def pe_root(tmp_path, monkeypatch):
    """A checkout whose pair of files holds :data:`PAIRS` pairs; two pack
    threads, so that the CPU runs the pack pool as a card's host does."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("HPGQ_PACK_THREADS", "2")
    return make_root(tmp_path / "checkout",
                     reads={**SMALL_READS, "novaseq_pe150_rta3": PAIRS})


@pytest.mark.parametrize("trace", (0, 1))
def test_cell_runs_correct(pe_root, trace):
    """A CPU run of the cell ends correct over both mates; traced, it
    reports ``mate_wait_share`` and the pipeline's metrics, the
    consumer's waits within its ``read``."""
    rc, result = drive(pe_root, CELL, trace=trace)
    assert rc == 0 and result["correct"], result
    assert result["run"]["reads_per_pass"] == 2 * PAIRS
    assert result["run"]["bases_per_pass"] == 2 * PAIRS * 151
    assert all(c["value"] == 0 for k, c in result["checks"].items()
               if k != "acc_quality_gap")
    got = {k: v["value"] for k, v in result["metrics"].items()}
    if trace:
        assert {"mate_wait_share", "input_wait_share", "reader_wait_share",
                "pack_wait_share", "report_share"} <= set(got), got
        assert 0 < got["mate_wait_share"] <= 100
        assert got["reader_wait_share"] + got["pack_wait_share"] \
            <= got["input_wait_share"] + 1e-6
    else:
        assert set(got) == {"bases_per_s", "setup_s"}


def test_mate_wait_share_reads_nothing_without_its_stages():
    """A run whose program enters no ``wait-mate-*`` stage (a single-end
    run, or the program before these stages) reads None, and does not
    raise; otherwise both mates' waits over the window."""
    stages = {"read": 2.0, "compute": 1.0, "reporting": 0.1}
    run = run_cell.Run(stages=stages, rank_stages=[stages], window_s=4.0, world=1)
    read = spec.reader("mate_wait_share")
    assert read(run) is None
    run.stages = dict(stages, **{"wait-mate-1": 0.2, "wait-mate-2": 0.6})
    assert read(run) == pytest.approx(20.0)


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
        assert "mate_wait_share" in result["metrics"]
        assert result["metrics"]["kernel_roofline_share"]["value"] <= 100
