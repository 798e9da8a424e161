"""Each cell on the cards, briefly: the run ends correct with a result
that names the card."""

import io
import json
from contextlib import redirect_stdout

import pytest

from benchmark.harness import spec
from conftest import make_root

CELLS = ("se100_stats_filter", "long_reads_stats_filter", "se100_gz_stats_filter",
         "se100_stats_filter_4card")


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_on_cards(cards, tmp_path, workload, trace):
    root = make_root(tmp_path / "checkout", reads={})
    chips = spec.load(workload, root).chips
    if cards < chips:
        pytest.skip("needs %d CUDA cards, this machine has %d" % (chips, cards))
    import run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", "918273645",
                       "--seconds", "2", "--trace", str(trace)], root=root)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == chips
