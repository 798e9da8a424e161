"""``tools/ab_torch.py``, the port's A/B and profile studies, on the CPU
at a tiny size.

* Every study (``--study all``, 2,000 reads, two rounds): each pass equals
  the single-CPU oracle (the tool raises otherwise), the arms of a study
  give equal counters and byte-equal output files, every output line is
  JSON and names its study's arms, the environment is as it was, the
  ``wire2c`` and ``wire6`` arms ride different wire tiers, the
  ``engine_cfg`` and ``coalesce`` arms are read by the pipeline, ``fixed``
  fits its line and ``paired`` compares per read.
* The CLI prints the card line first (null here) and exits 0.
* A pass corrupted on purpose (one counter, one output byte) raises
  ``ab_torch.BenchMismatch``, and the CLI exits 1.
* The tool's checks pass on the engine's real result and bite on one byte
  of a ``filter`` output, one counter or one CGR cell planted wrong.
"""

import copy
import json
import os
import sys

import pytest
import torch

from gen import make_fastq
from hpgq_torch.oracle import assert_counters_equal

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import ab_torch  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def bench_dir(tmp_path, monkeypatch):
    """Corpora under the test's directory; the bitpack wire, so that the
    wire arms have tiers to switch between on the CPU."""
    monkeypatch.setattr(ab_torch, "BENCH_DIR", str(tmp_path / "bench"))
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    for knob in ("HPGQ_READ_SHARDS", "HPGQ_COALESCE", "HPGQ_WIRE2C",
                 "HPGQ_WIRE6", "HPGQ_ASYNC_WRITES"):
        monkeypatch.delenv(knob, raising=False)
    return tmp_path


def _digest(cmd, got):
    """What must agree between arms: counters, or the bytes of every
    output file, or the tables."""
    if cmd == "stats":
        return copy.deepcopy(got)
    if cmd == "paired":
        return tuple(copy.deepcopy(c) for c in got)
    if cmd in ("filter", "edit"):
        files = got if cmd == "filter" else got[0]
        return {name: open(p, "rb").read() for name, p in files.items()}
    return tuple(x.copy() if hasattr(x, "copy") else x for x in got)


def _same(cmd, a, b, label):
    if cmd == "stats":
        assert_counters_equal(a, b, label)
    elif cmd == "paired":
        for x, y in zip(a, b):
            assert_counters_equal(x, y, label)
    elif cmd in ("filter", "edit"):
        assert a == b, label
    else:
        assert all((x == y).all() if hasattr(x, "all") else x == y
                   for x, y in zip(a, b)), label


def test_every_study_on_cpu(bench_dir, monkeypatch, capsys):
    """``--study all`` at 2,000 reads: see the module docstring."""
    seen = {}
    real_check = ab_torch.check_result

    def recording_check(cmd, got, want, label):
        real_check(cmd, got, want, label)
        study, command, arm = label.split()[:3]
        seen.setdefault((study, command), {}).setdefault(
            arm, []).append(_digest(cmd, got))

    monkeypatch.setattr(ab_torch, "check_result", recording_check)
    env = dict(os.environ)
    _, launches = ab_torch.run("all", CPU, rounds=2, reads=2000)
    assert dict(os.environ) == env
    assert launches == {}  # no kernel launches on the CPU

    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    by_study = {}
    for line in lines:
        if "summary" in line:
            by_study.setdefault(line["summary"], []).append(line)
    assert sorted(by_study) == sorted(["engine_cfg", "coalesce", "wire2c",
                                       "wire6", "writer", "fixed", "paired"])
    assert [s["command"] for s in by_study["writer"]] == ["filter", "edit"]
    arms = ab_torch.studies()
    for name, st in arms.items():
        for summary in by_study[name]:
            assert list(summary["arms"]) == [a.label for a in st.arms]
            for arm in summary["arms"].values():
                assert arm["median_reads_per_sec"] > 0
                assert arm["spread"][0] <= arm["spread"][1]
        rounds = [x for x in lines if x.get("study") == name
                  and "round" in x]
        assert len(rounds) == 2 * len(st.commands)
        assert all(sorted(r["reads_per_sec"]) == sorted(
            a.label for a in st.arms) for r in rounds)

    # every pass of an arm study gave what its first arm's warm pass gave;
    # fixed and paired (a corpus or a command each) pass after pass
    for (study, command), by_arm in seen.items():
        first = next(iter(by_arm.values()))[0]
        for arm, digests in by_arm.items():
            assert len(digests) == 3  # warm + two rounds
            for d in digests:
                _same(command, d, first if study in arms else digests[0],
                      "%s %s %s" % (study, command, arm))
    assert sorted(seen) == sorted(
        [(name, c) for name, st in arms.items() for c in st.commands]
        + [("fixed", "stats"), ("paired", "stats"), ("paired", "paired")])
    assert all(len(seen[name, c]) == len(st.arms)
               for name, st in arms.items() for c in st.commands)

    def tiers(name):
        return {a: tuple(sorted(v["tiers"]))
                for a, v in by_study[name][0]["arms"].items()}

    assert tiers("wire2c") == {"off": ("stats 2q",), "on": ("stats 2u",)}
    assert tiers("wire6") == {"off": ("stats 7bit",), "on": ("stats 6bit",)}
    warm = {(x["study"], x["arm"]): x["knobs"] for x in lines
            if "warm_s" in x}
    for arm in arms["engine_cfg"].arms:
        assert warm["engine_cfg", arm.label]["read_shards"] == int(
            arm.env["HPGQ_READ_SHARDS"])
    assert warm["coalesce", "off"]["coalesce_reads"] == 0
    assert warm["coalesce", "auto"]["coalesce_reads"] == 131072
    wire = next(x for x in lines if "wire_block_reads" in x)
    assert wire["bytes_ratio_2q_vs_2c"] > 0
    fixed = by_study["fixed"][0]
    assert sorted(fixed["sizes"]) == ["100", "2000", "400", "bgzf", "gz"]
    assert fixed["fit"]["points"] == 6 and "flat_s" in fixed["fit"]
    paired = by_study["paired"][0]
    assert paired["paired_vs_single_per_read"] > 0
    assert paired["paired"]["median_stages"]


def test_cli_prints_the_card_line_first(bench_dir, capsys):
    assert ab_torch.main(["--study", "wire6", "--device", "cpu", "--reads",
                          "300", "--rounds", "1", "--command",
                          "cgr,paired"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"card": None, "backend": "torch-cpu"}
    assert [x["command"] for x in lines if "summary" in x] == ["cgr",
                                                               "paired"]


@pytest.mark.parametrize("plant", ["stats counter", "filter byte"])
def test_corrupted_pass_fails(bench_dir, monkeypatch, capsys, plant):
    """One counter or one output byte planted wrong in the engine's pass
    raises ``BenchMismatch``; through the CLI it exits 1."""
    if plant == "stats counter":
        real = ab_torch.engine_stats

        def bad(*a, **kw):
            n, c = real(*a, **kw)
            c.gc_hist[c.gc_hist.argmax()] += 1
            return n, c

        monkeypatch.setattr(ab_torch, "engine_stats", bad)
        study = "wire6"
    else:
        real = ab_torch.engine_filter

        def bad(*a, **kw):
            n, files = real(*a, **kw)
            with open(files["passed.fq"], "r+b") as f:
                f.seek(os.path.getsize(files["passed.fq"]) // 2)
                byte = f.read(1)
                f.seek(-1, 1)
                f.write(b"A" if byte != b"A" else b"C")
            return n, files

        monkeypatch.setattr(ab_torch, "engine_filter", bad)
        study = "writer"
    with pytest.raises(ab_torch.BenchMismatch):
        ab_torch.run(study, CPU, rounds=1, reads=400)
    assert ab_torch.main(["--study", study, "--device", "cpu", "--reads",
                          "400", "--rounds", "1"]) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["error"].startswith("BenchMismatch")


@pytest.mark.parametrize("plant", ["filter byte", "stats counter",
                                   "cgr cell"])
def test_engine_oracle_check_bites(tmp_path, plant):
    """The tool's checks pass on the engine's real result and raise
    :class:`ab_torch.BenchMismatch` once one byte, one counter or one
    CGR cell is planted wrong."""
    path = str(tmp_path / "in.fq")
    make_fastq(path, 2500, min_len=100, max_len=100, n_prob=0.005, seed=7,
               qual_bins=(2, 12, 23, 37))
    os.makedirs(tmp_path / "e")
    os.makedirs(tmp_path / "o")
    if plant == "filter byte":
        _, got = ab_torch.engine_filter(path, str(tmp_path / "e"), 1000, CPU)
        _, want = ab_torch.oracle_filter(path, 1000, str(tmp_path / "o"))
        ab_torch.check_files(got, want, "filter")
        with open(got["passed.fq"], "r+b") as f:
            f.seek(os.path.getsize(got["passed.fq"]) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(b"A" if byte != b"A" else b"C")
        check = (ab_torch.check_files, got, want)
    elif plant == "stats counter":
        _, got = ab_torch.engine_stats(path, str(tmp_path / "e"), 1000, 0,
                                       CPU)
        _, want = ab_torch.oracle_stats(path, 1000)
        ab_torch.check_counters(got, want, "stats")
        got.gc_hist[got.gc_hist.argmax()] += 1
        check = (ab_torch.check_counters, got, want)
    else:
        _, got = ab_torch.engine_cgr(path, 1000, CPU)
        _, want = ab_torch.oracle_cgr(path)
        ab_torch.check_tables(got, want, "cgr")
        got[1][0, 0] += 1
        check = (ab_torch.check_tables, got, want)
    fn, got, want = check
    with pytest.raises(ab_torch.BenchMismatch):
        fn(got, want, plant)
