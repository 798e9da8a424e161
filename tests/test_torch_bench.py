"""``bench_torch.py``, the port's bench, on the CPU at a tiny size.

* The truncation guard of ``tests/test_bench_guard.py`` (``bench.py``'s),
  as one parametrised test: a run cut at once, a run whose budget runs out
  mid-way and a run that completes each leave a parsable headline line
  last on stdout, with ``backend: "torch-cpu"``, and
  ``bench_phase_seconds`` on stderr.
* ``hpgq_torch/baseline.py``, the bench's single-CPU denominator, equals
  ``hpgq.oracle.baseline`` and ``hpgq.oracle.cgr`` on seeded numpy inputs:
  every counter, verdict, trim and CGR cell exact, ``acc_quality`` to
  1e-12 relative (both sum the same f32 means in f64).
* The bench's engine-against-oracle check bites: a byte planted in a
  ``filter`` output, a counter or a CGR cell changed makes it raise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gen import make_fastq

import bench_torch
import hpgq.oracle.baseline as hbl
from hpgq.oracle.cgr import fill_tables_loop as h_fill_tables_loop
from hpgq.options import FilterCriteria as HFilterCriteria
from hpgq_torch import baseline as pbl
from hpgq_torch.options import FilterCriteria

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _bench(tmp_path, budget_s, extra=()):
    from hpgq_torch.io import native

    native.get_lib()  # built here, not inside the run's budget
    env = dict(os.environ, HPGQ_BENCH_BUDGET_S=str(budget_s),
               HPGQ_BENCH_DIR=str(tmp_path / "benchdir"), HPGQ_CHARTS="off")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--device",
         "cpu", "--reads", "6000", "--ranks", "1"] + list(extra),
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=env)


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("case", ["killed at once", "budget runs out",
                                  "completed"])
def test_truncation_guard(tmp_path, case):
    budget = {"killed at once": 1, "budget runs out": 8, "completed": 600}
    r = _bench(tmp_path, budget[case])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    head = json.loads(lines[-1])
    assert head["metric"] == "stats_filter_reads_per_sec"
    assert head["backend"] == "torch-cpu" and head["card"] is None
    assert "value" in head and "vs_baseline" in head, head
    phases = [x["bench_phase_seconds"] for x in _json_lines(r.stderr)
              if "bench_phase_seconds" in x]
    assert phases and phases[-1], r.stderr[-3000:]
    if case != "killed at once":
        assert head["value"] > 0 and head["vs_baseline"] > 0, head
        assert head["rounds"] and len(head["spread"]) == 2
    if case == "completed":
        metrics = [x["metric"] for x in _json_lines(r.stdout)]
        assert metrics == [
            "paired_stats_filter_reads_per_sec", "stats_gz_reads_per_sec",
            "cgr_reads_per_sec", "filter_reads_per_sec", "edit_reads_per_sec",
            "stats_bgzf_reads_per_sec", "scaling_efficiency",
            "stats_filter_reads_per_sec"], metrics  # no device line on cpu
        for line in _json_lines(r.stdout):
            assert line["backend"] == "torch-cpu", line
            if line["metric"] != "scaling_efficiency":
                assert line["value"] > 0 and len(line["rounds"]) >= 1, line
        assert _json_lines(r.stdout)[-2]["value"] == "not measured"
        bd = [x for x in _json_lines(r.stderr) if "breakdown" in x]
        assert bd and "h2d_mb_s" not in bd[0]["breakdown"]
        assert "busy" not in json.dumps(bd[0])


def _batch(seed, B=300, L=160, binned=False):
    """(codes int8, quals uint8, lens int32, valid bool), the packer's
    layout: code 5 and quality 0 past each read's length."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = 4
    if binned:
        quals = (np.array([2, 12, 23, 37])[rng.integers(0, 4, size=(B, L))]
                 + 33).astype(np.uint8)
    else:
        quals = rng.integers(35, 75, size=(B, L)).astype(np.uint8)
    inside = np.arange(L)[None, :] < lens[:, None]
    return (np.where(inside, codes, np.int8(5)),
            np.where(inside, quals, np.uint8(0)), lens, rng.random(B) < 0.9)


CRITERIA = {
    "none": {},
    "bench": dict(min_read_length=50, max_read_length=200,
                  min_read_quality=20, max_read_quality=60, max_N=2),
    "windows": dict(left_length=10, min_left_quality=28, max_left_quality=60,
                    right_length=6, min_right_quality=20,
                    max_out_of_quality=40),
    "quality window": dict(min_read_quality=15, max_read_quality=30,
                           begin_quality_nt=5, end_quality_nt=60,
                           max_out_of_quality=30),
}


def _counters_same(a, b):
    for name in vars(b):
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray) or isinstance(x, np.ndarray):
            assert np.array_equal(x, y), name
        elif isinstance(y, float):
            assert x == pytest.approx(y, rel=1e-12), name
        else:
            assert x == y, name


@pytest.mark.parametrize("binned", [False, True], ids=["uniform", "binned"])
@pytest.mark.parametrize("name", list(CRITERIA))
def test_baseline_copy_equals_hpgq(name, binned):
    """``block_verdicts``, ``block_stats`` (k-mers off and on) and
    ``block_trims`` of the port's copy equal ``hpgq.oracle.baseline``'s."""
    codes, quals, lens, valid = _batch(17 + binned, binned=binned)
    kw = CRITERIA[name]
    pc, hc = FilterCriteria(**kw), HFilterCriteria(**kw)
    ok = pbl.block_verdicts(codes, quals, lens, pc, 33)
    np.testing.assert_array_equal(ok, hbl.block_verdicts(codes, quals, lens,
                                                         hc, 33))
    for kmers in (False, True):
        _counters_same(pbl.block_stats(codes, quals, lens, ok & valid, kmers),
                       hbl.block_stats(codes, quals, lens, ok & valid, kmers))
    for got, want in zip(pbl.block_trims(quals, lens, pc, 33),
                         hbl.block_trims(quals, lens, hc, 33)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 4, 7])
def test_fill_tables_loop_copy_equals_hpgq(k):
    """The CGR loop's copy equals ``hpgq.oracle.cgr.fill_tables_loop``,
    codes of any kind (code 5 falls through) and invalid rows included."""
    codes, quals, lens, valid = _batch(40 + k, B=60, L=90)
    codes[::7, 3] = 5
    got = pbl.fill_tables_loop(codes, quals, lens, valid, k, 33)
    want = h_fill_tables_loop(codes, quals, lens, valid, k, 33)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2] > 0


@pytest.mark.parametrize("plant", ["filter byte", "stats counter",
                                   "cgr cell"])
def test_engine_oracle_check_bites(tmp_path, plant):
    """The bench's checks pass on the engine's real result and raise
    :class:`bench_torch.BenchMismatch` once one byte, one counter or one
    CGR cell is planted wrong."""
    path = str(tmp_path / "in.fq")
    make_fastq(path, 2500, min_len=100, max_len=100, n_prob=0.005, seed=7,
               qual_bins=(2, 12, 23, 37))
    os.makedirs(tmp_path / "e")
    os.makedirs(tmp_path / "o")
    if plant == "filter byte":
        _, got = bench_torch.engine_filter(path, str(tmp_path / "e"), 1000,
                                           CPU)
        _, want = bench_torch.oracle_filter(path, 1000, str(tmp_path / "o"))
        bench_torch.check_files(got, want, "filter")
        with open(got["passed.fq"], "r+b") as f:
            f.seek(os.path.getsize(got["passed.fq"]) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(b"A" if byte != b"A" else b"C")
        check = (bench_torch.check_files, got, want)
    elif plant == "stats counter":
        _, got = bench_torch.engine_stats(path, str(tmp_path / "e"), 1000, 0,
                                          CPU)
        _, want = bench_torch.oracle_stats(path, 1000)
        bench_torch.check_counters(got, want, "stats")
        got.gc_hist[got.gc_hist.argmax()] += 1
        check = (bench_torch.check_counters, got, want)
    else:
        _, got = bench_torch.engine_cgr(path, 1000, CPU)
        _, want = bench_torch.oracle_cgr(path)
        bench_torch.check_tables(got, want, "cgr")
        got[1][0, 0] += 1
        check = (bench_torch.check_tables, got, want)
    fn, got, want = check
    with pytest.raises(bench_torch.BenchMismatch):
        fn(got, want, plant)
