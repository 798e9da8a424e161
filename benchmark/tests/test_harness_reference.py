"""The plain reference against the program on the CPU, the comparison's
teeth, and the traffic generator."""

import copy
import gzip
import os

import numpy as np
import pytest

from benchmark.commands import stats as command
from benchmark.harness import spec
from benchmark.harness.cell import correct
from benchmark.reference.report import report_files
from benchmark.reference.stats import reference_stats
from benchmark.traffic.generate import make_corpus

CELLS = ("se100_stats_filter", "long_reads_stats_filter", "se100_gz_stats_filter")


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_program(small_root, tmp_path, workload):
    """The reference's counters and report equal ``hpgq_torch.stats`` on
    the CPU over a small file of each configuration."""
    import hpgq_torch

    cell = spec.load(workload, small_root)
    corpus = make_corpus(cell.config, cell.traffic, 20261017, str(tmp_path))
    out = str(tmp_path / "out")
    f = cell.config["filter"]
    got = hpgq_torch.stats(corpus.path, outdir=out, device="cpu",
                           read_length_range=tuple(f["read_length_range"]),
                           read_quality_range=tuple(f["read_quality_range"]),
                           max_N=f["max_N"])
    want = reference_stats(corpus, f)
    assert 0 < want.num_reads < corpus.reads  # the filter splits the file
    assert command.fields_off(got, want) == 0
    assert command.quality_gap(got, want) < 1e-6
    assert command.report_off(out, report_files(want, corpus.path, out, f["max_N"])) == 0


def _sound(small_root, tmp_path, passes=3):
    cell = spec.load("se100_stats_filter", small_root)
    corpus = make_corpus(cell.config, cell.traffic, 77, str(tmp_path))
    want = reference_stats(corpus, cell.config["filter"])
    out = str(tmp_path / "out")
    os.makedirs(out)
    for name, data in report_files(want, corpus.path, out, 2).items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    return cell, corpus, [copy.deepcopy(want) for _ in range(passes)], out


def test_sound_passes_are_correct(small_root, tmp_path):
    cell, corpus, results, out = _sound(small_root, tmp_path)
    numbers, failed = command.judge(cell, corpus, results, len(results), out)
    assert failed == 0 and correct(numbers)


def _counter_off_by_one(results, out):
    results[1].num_Gs += 1


def _histogram_off_by_one(results, out):
    results[2].base_per_nt[4, 7] += 1


def _wrong_quality(results, out):
    results[0].acc_quality *= 1 + 1e-4


def _dropped_pass(results, out):
    results.pop()


def _pass_without_counters(results, out):
    results[1] = None


def _report_byte(results, out):
    name = next(n for n in sorted(os.listdir(out)) if n.endswith("summary.txt"))
    with open(os.path.join(out, name), "ab") as f:
        f.write(b" ")


@pytest.mark.parametrize("fault", [
    _counter_off_by_one, _histogram_off_by_one, _wrong_quality, _dropped_pass,
    _pass_without_counters, _report_byte], ids=lambda f: f.__name__.strip("_"))
def test_comparison_fails_on(small_root, tmp_path, fault):
    cell, corpus, results, out = _sound(small_root, tmp_path)
    fault(results, out)
    numbers, failed = command.judge(cell, corpus, results, 3, out)
    assert failed > 0 and not correct(numbers)


@pytest.mark.parametrize("workload", CELLS)
def test_generator_is_deterministic(small_root, tmp_path, workload):
    cell = spec.load(workload, small_root)
    big = 2 ** 31 + 10 ** 9  # past 32 signed bits
    a = make_corpus(cell.config, cell.traffic, big, str(tmp_path / "a"))
    b = make_corpus(cell.config, cell.traffic, big, str(tmp_path / "b"))
    c = make_corpus(cell.config, cell.traffic, big + 1, str(tmp_path / "c"))
    with open(a.path, "rb") as fa, open(b.path, "rb") as fb, open(c.path, "rb") as fc:
        ta, tb, tc = fa.read(), fb.read(), fc.read()
    if workload == "se100_gz_stats_filter":
        ta, tb, tc = (gzip.decompress(t) for t in (ta, tb, tc))
    assert ta == tb and ta != tc
    assert np.array_equal(a.seq, b.seq) and not np.array_equal(a.seq, c.seq)
    # every seed draws the same set of lengths, in another order
    assert np.array_equal(np.sort(a.lens), np.sort(c.lens))


def test_file_holds_the_records(small_root, tmp_path):
    """The file is the records as ``tests/gen.py`` writes them: plain, and
    as one gzip member."""
    for workload in ("se100_stats_filter", "se100_gz_stats_filter",
                     "long_reads_stats_filter"):
        cell = spec.load(workload, small_root)
        corpus = make_corpus(cell.config, cell.traffic, 5, str(tmp_path / workload))
        starts = corpus.starts
        want = b"".join(
            b"@read_%d some description\n%s\n+\n%s\n" % (
                i, corpus.seq[s:s + n].tobytes(), corpus.qual[s:s + n].tobytes())
            for i, (s, n) in enumerate(zip(starts, corpus.lens)))
        with open(corpus.path, "rb") as f:
            data = f.read()
        if corpus.path.endswith(".gz"):
            assert data[3] == 0  # no extra field: plain gzip, not BGZF
            data = gzip.decompress(data)
        assert data == want
