"""``--sharded`` with no torchrun: the port's local launcher
(``hpgq_torch.dist.launch``) starting two ranks on the CPU.

On a host with cards, ``--sharded`` starts one rank per card; here the
ranks are given ``["cpu", "cpu"]``.  Each rank is a new interpreter
(``spawn``), the group forms over ``file://`` in a private temporary
directory, and rank 0's return value comes back to the caller.  One launch
runs every command in turn (every CPU rank imports torch, so launches are
few), and each case is held against ``hpgq``'s one-process mesh on the
conftest's 8 CPU devices and against the port's one-process run: the
counters equal (every integer field exact, ``acc_quality`` as
``StatsCounters.equals`` compares it), every output file byte-equal (the
report's ``Mean quality`` line to 1e-3 relative, as
``tests/test_torch_pipeline.py`` allows).  Then the entry points: the CLI
and the API reach the launcher, parse once in the parent and print one
RESULTS block; a bad option starts no rank.  The choice of the world size
and resume are in ``tests/test_torch_launch_resume.py``; failures and
signals in ``tests/test_torch_launch_signals.py``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gen import make_fastq

import hpgq.dist.run_dist as hdist
import hpgq_torch
from hpgq_torch import options as poptions
from hpgq_torch.cli.main import main as port_main
from hpgq_torch.dist import launch, mesh
from hpgq_torch.pipeline import run as prun
from test_torch_multiproc import (
    OUTPUT_CASES,
    assert_same_tree,
    base_opts,
    hpgq_opts,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU2 = ["cpu", "cpu"]
CRIT = dict(min_read_quality=18, max_read_quality=40)
PREPRO = dict(ltrim_nts=5, rtrim_nts=3, min_quality=27, max_quality=64)

# name: (command, paired, criteria, options beyond base_opts)
CASES = {
    "stats": ("stats", False, CRIT, dict(filter_on=True)),
    "stats paired kmers": ("stats", True, CRIT,
                           dict(filter_on=True, kmers_on=True)),
    "filter": ("filter", False, OUTPUT_CASES["filter"], {}),
    "filter paired": ("filter", True, OUTPUT_CASES["filter"], {}),
    "edit": ("edit", False, OUTPUT_CASES["edit"], dict(filter_on=True)),
    "edit paired": ("edit", True, OUTPUT_CASES["edit"], dict(filter_on=True)),
    "prepro": ("prepro", False, None, PREPRO),
    "prepro paired": ("prepro", True, None, PREPRO),
    "cgr": ("cgr", False, None, dict(k=4, write_gs=True)),
}


def port_opts(cmd, opts, crit=None):
    """The port's options of ``cmd`` from ``base_opts``' dict."""
    o = {"stats": poptions.StatsOptions, "filter": poptions.FilterOptions,
         "edit": poptions.EditOptions, "prepro": poptions.PreproOptions,
         "cgr": poptions.CgrOptions}[cmd]()
    for k, v in opts.items():
        setattr(o, k, v)
    for k, v in (crit or {}).items():
        setattr(o.criteria, k, v)
    if cmd == "prepro":
        o.apply_trim_windows()
    return o


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    paths = [str(d / "m1.fq"), str(d / "m2.fq")]
    for i, p in enumerate(paths):
        make_fastq(p, 2400, min_len=40, max_len=110, n_prob=0.02,
                   seed=51 + i)
    return d, paths


def case_opts(d, paths, name, where):
    cmd, paired, crit, extra = CASES[name]
    opts = base_opts(paths[:1 + paired], d / where / name, **extra)
    return cmd, crit, opts


@pytest.fixture(scope="module")
def launched(corpus):
    """Every case run by two CPU ranks in one launch: rank 0's
    ``{name: (result, rank, world size, jax loaded)}``."""
    from torch_rank_targets import run_jobs

    d, paths = corpus
    jobs = []
    for name in CASES:
        cmd, crit, opts = case_opts(d, paths, name, "ranks")
        jobs.append((name, port_opts(cmd, opts, crit)))
    return launch.launch(run_jobs, (jobs,), CPU2)


def test_ranks_joined_one_group(launched):
    """Rank 0 of a group of two answered for every case, with neither
    ``jax`` nor ``hpgq`` loaded in the rank."""
    assert sorted(launched) == sorted(CASES)
    for res, rank, world, jax_loaded in launched.values():
        assert (rank, world, jax_loaded) == (0, 2, False)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][0] == "stats"])
def test_launched_stats(corpus, launched, name):
    """Single-end, and paired with ``--kmers``: rank 0's counters equal
    ``hpgq``'s ``run_stats_sharded`` and the port's one-process run, and
    so do the reports that rank 0 alone wrote."""
    d, paths = corpus
    cmd, crit, opts = case_opts(d, paths, name, "ranks")
    got = launched[name][0]
    _, _, ref = case_opts(d, paths, name, "hpgq")
    want = hdist.run_stats_sharded(hpgq_opts(cmd, ref, crit))
    _, _, one = case_opts(d, paths, name, "one")
    alone = prun.run_stats(port_opts(cmd, one, crit), device="cpu")
    got, want, alone = (x if isinstance(x, tuple) else (x,)
                        for x in (got, want, alone))
    for g, w, a in zip(got, want, alone):
        assert g.equals(w) and g.equals(a)
        assert (g.num_passed, g.num_failed) == (w.num_passed, w.num_failed)
    assert_same_tree(opts["out_dirname"], ref["out_dirname"], reports=True)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][0]
                                  in ("filter", "edit", "prepro")])
def test_launched_output_commands(corpus, launched, name):
    """``filter``, ``edit`` and ``prepro``, single-end and paired: the
    ranks' shards concatenated byte-equal to ``hpgq``'s one-process mesh
    output, the counts equal."""
    d, paths = corpus
    cmd, crit, opts = case_opts(d, paths, name, "ranks")
    got = launched[name][0]
    _, _, ref = case_opts(d, paths, name, "hpgq")
    runner = hdist.run_filter_sharded if cmd == "filter" \
        else hdist.run_edit_sharded
    want = runner(hpgq_opts(cmd, ref, crit))
    for k in ("num_passed", "num_failed", "num_edited"):
        assert got.get(k) == want.get(k), k
    assert_same_tree(opts["out_dirname"], ref["out_dirname"])


def test_launched_cgr(corpus, launched):
    """``cgr`` k=4: the tables and word count equal ``hpgq``'s
    ``run_cgr_sharded``; the PGM and ``.gs`` bytes too."""
    d, paths = corpus
    cmd, crit, opts = case_opts(d, paths, "cgr", "ranks")
    got = launched["cgr"][0]
    _, _, ref = case_opts(d, paths, "cgr", "hpgq")
    want = hdist.run_cgr_sharded(hpgq_opts(cmd, ref))
    np.testing.assert_array_equal(got["table_seq"], want["table_seq"])
    np.testing.assert_array_equal(got["table_q"], want["table_q"])
    assert got["fq_word_count"] == want["fq_word_count"]
    assert_same_tree(opts["out_dirname"], ref["out_dirname"])


def _two_ranks(monkeypatch):
    """``--sharded`` here starts two CPU ranks, as it would two cards."""
    monkeypatch.setattr(mesh, "rank_devices",
                        lambda opts, device="cuda": [torch.device(d)
                                                     for d in CPU2])


def test_cli_launches_ranks(corpus, tmp_path):
    """``python -m hpgq_torch stats --sharded --t`` where ``rank_devices``
    plans two CPU ranks: exit 0, one PARAMETERS block, one RESULTS
    block and one timer report (rank 0's batches, and its start-up split
    into the ``launch-*`` stages, which fit in the run's time), one log
    file with rank 0's lines after the parent's choice, and a report equal
    to the one-process run's."""
    d, paths = corpus
    log = str(tmp_path / "log")
    argv = ["stats", "-f", paths[0], "--read-quality-range", "18,40",
            "--batch-size", "300", "--device", "cpu", "--sharded", "--t",
            "-o", str(tmp_path / "ranks"), "--log-file", log]
    code = ("import sys, torch\n"
            "sys.path.insert(0, %r)\n"
            "for n in ('jax', 'jaxlib', 'hpgq'):\n"
            "    sys.modules[n] = None\n"
            "from hpgq_torch.dist import mesh\n"
            "mesh._rank_plan = lambda opts, device: "
            "([torch.device('cpu')] * 2, 'as on two cards')\n"
            "from hpgq_torch.cli.main import main\n"
            "sys.exit(main(%r))\n" % (REPO, argv))
    for name in ("ranks", "one"):
        (tmp_path / name).mkdir()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    for line in ("PARAMETERS", "RESULTS", "total time"):
        assert p.stdout.count(line) == 1, (line, p.stdout)
    # the timer report counts rank 0's reads: those of its byte range
    start, end = mesh.split_byte_ranges(paths[0], 2)[0]
    n0 = mesh.count_newlines_in_range(paths[0], start, end) // 4
    batches = int(p.stdout.split("number of batches     : ")[1].split()[0])
    mean = float(p.stdout.split("mean reads per batch  : ")[1].split()[0])
    assert 0 < n0 < 2400 and round(batches * mean) == n0, p.stdout
    secs = {ln.split()[1]: float(ln.split()[4])
            for ln in p.stdout.splitlines() if ln.startswith("total launch-")}
    assert list(secs) == ["launch-start"] + [s[0] for s in launch.STAGES]
    total = float(p.stdout.split("total time            (s): ")[1].split()[0])
    chain = [secs[s[0]] for s in launch.STAGES]
    # the process's start is read to 0.01 s; the other stamps are exact
    assert min(chain[:2]) > -0.02 and min(chain[2:]) >= 0, secs
    assert 0 < sum(chain) < total and secs["launch-start"] < total, secs
    with open(log) as f:
        text = f.read()
    assert text.index("--sharded: 2 ranks, as on two cards: cpu, cpu") \
        < text.index("rank 0 of 2")
    assert "rank 1 of 2" not in text
    assert text.rstrip().endswith("Done !")
    port_main(["stats"] + argv[1:9] + ["-o", str(tmp_path / "one"),
                                       "--log-file", log])
    assert_same_tree(str(tmp_path / "ranks"), str(tmp_path / "one"),
                     reports=True)


def test_process_start_stamp(tmp_path):
    """A new interpreter's ``_process_start()`` falls between the moment
    its parent started it and the child's first stamp of its own (to the
    0.01 s that ``/proc`` gives); ``startup_stages`` splits a rank's
    stamps in order, and the stages sum to its launch-to-first-batch
    time."""
    code = ("import sys, time\n"
            "t = time.time()\n"
            "sys.path.insert(0, %r)\n"
            "from hpgq_torch.dist.launch import _process_start\n"
            "print(t, _process_start())\n" % REPO)
    t0 = time.time()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    first, start = map(float, p.stdout.split())
    assert t0 - 0.02 < start < first + 0.02, (t0, start, first)

    stamps = dict(launch=10.0, process=10.25, main=12.0, join=12.5,
                  cuda=13.0, load=13.25, first_batch=14.0)
    got = launch.startup_stages(stamps)
    assert list(got) == [s[0] for s in launch.STAGES]
    assert list(got.values()) == [0.25, 1.75, 0.5, 0.5, 0.25, 0.75]
    assert sum(got.values()) == stamps["first_batch"] - stamps["launch"]
    del stamps["first_batch"]
    assert "launch-first-batch" not in launch.startup_stages(stamps)


def test_api_launches_ranks(corpus, tmp_path, monkeypatch):
    """``hpgq_torch.cgr(..., sharded=True)`` through the launcher returns
    rank 0's dict, as one process returns it."""
    d, paths = corpus
    _two_ranks(monkeypatch)
    got = hpgq_torch.cgr(paths[0], paths[1], outdir=str(tmp_path / "ranks"),
                         k=3, sharded=True, batch_size=300, device="cpu")
    want = hpgq_torch.cgr(paths[0], paths[1], outdir=str(tmp_path / "one"),
                          k=3, batch_size=300, device="cpu")
    assert got["fq_word_count"] == want["fq_word_count"]
    np.testing.assert_array_equal(got["table_seq"], want["table_seq"])
    np.testing.assert_array_equal(got["table_q"], want["table_q"])
    assert [os.path.basename(p) for p in got["pgm_files"]] == [
        os.path.basename(p) for p in want["pgm_files"]]
    assert_same_tree(str(tmp_path / "ranks"), str(tmp_path / "one"))


ENTRY_POINTS = {  # name: (command, CLI argv or API call)
    "cli stats": ("stats", ["stats", "--read-quality-range", "18,40"]),
    "cli filter": ("filter", ["filter", "--max-N", "2"]),
    "cli edit": ("edit", ["edit", "--left-length", "8",
                          "--left-quality-range", "24,60"]),
    "cli prepro": ("prepro", ["prepro", "--ltrim-nts", "5"]),
    "cli cgr": ("cgr", ["cgr", "--k", "3"]),
    "legacy --qc": ("stats", ["--qc"]),
    "legacy --filter": ("filter", ["--filter", "--max-N", "2"]),
    "legacy --prep": ("prepro", ["--prep", "--ltrim-nts", "5"]),
    "legacy --cg": ("cgr", ["--cg", "--k", "3"]),
    "api stats": ("stats", ("stats", dict(read_quality_range=(18, 40)))),
    "api filter_reads": ("filter", ("filter_reads", dict(max_N=2))),
    "api edit": ("edit", ("edit", dict(left_length=8,
                                       left_quality_range=(24, 60)))),
    "api prepro": ("prepro", ("prepro", dict(ltrim_nts=5))),
    "api cgr": ("cgr", ("cgr", dict(k=3))),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_every_entry_point_asks_for_ranks(corpus, tmp_path, monkeypatch,
                                          entry):
    """Every command, through the subcommands, the legacy single-binary
    flags and the API, asks ``rank_devices`` how many ranks to start when
    ``--sharded``, once, and not without it (here it answers one, so the
    run stays in this process)."""
    d, paths = corpus
    asked = []

    def one(opts, device="cuda"):
        asked.append(opts.command_name)
        return [torch.device(device)]

    monkeypatch.setattr(mesh, "rank_devices", one)
    command, what = ENTRY_POINTS[entry]
    for sharded in (False, True):
        out = str(tmp_path / ("out%d" % sharded))
        os.makedirs(out)  # a missing -o falls back to the working directory
        if isinstance(what, list):
            io = ["--fq", paths[0], "--outdir", out]
            argv = what + io + ["--device", "cpu", "--log-file",
                                str(tmp_path / "log")]
            assert port_main(argv + ["--sharded"] * sharded) == 0
        else:
            fn, kw = what
            getattr(hpgq_torch, fn)(paths[0], outdir=out, sharded=sharded,
                                    device="cpu", **kw)
    assert asked == [command]


def test_bad_option_starts_no_rank(corpus, tmp_path, monkeypatch, capfd):
    """An inverted range with ``--sharded``: the parent prints its one
    error and exits 255 (``SystemExit(-1)``) before any rank starts."""
    d, paths = corpus
    _two_ranks(monkeypatch)
    monkeypatch.setattr(launch, "launch",
                        lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(SystemExit) as e:
        port_main(["stats", "-f", paths[0], "-o", str(tmp_path),
                   "--read-quality-range", "40,20", "--sharded",
                   "--device", "cpu", "--log-file", str(tmp_path / "log")])
    assert e.value.code == -1
    out, err = capfd.readouterr()
    errors = [ln for ln in (out + err).splitlines() if ln.strip()]
    assert len(errors) == 1 and "greater than minimum value" in errors[0], \
        out + err
