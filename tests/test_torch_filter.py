"""The port's `filter` command end to end on the CPU, against ``hpgq``.

The same generated corpora and flags go through ``hpgq``'s CLI (JAX on the
CPU) and ``hpgq_torch``'s with ``--device cpu``: the console output and
every FASTQ output must be byte-identical, single-end and paired, over
each wire tier the verdict can ride (2c, 2q, qn8, the plain bitpack
ladder, no wire).  Resume, shard readers and long reads are held to the
same bytes.
"""

import os

import pytest
import torch

from gen import make_fastq

from hpgq.io.fastq import FastqReader
from hpgq.options import FilterOptions
from hpgq_torch.pipeline import run as prun
from hpgq_torch.pipeline import session
from test_torch_pipeline import (
    _assert_cli_identical,
    _CrashAfter,
    _Killed,
)

torch.set_num_threads(2)

BINS = (2, 12, 23, 37)
FILTER = ["--read-length-range", "50,140", "--read-quality-range", "15,60",
          "--max-N", "2"]
KW = dict(read_length_range=(50, 140), read_quality_range=(15, 60), max_N=2)
CORPORA = {
    "binned": dict(n=900, min_len=60, max_len=150, n_prob=0.01, seed=51,
                   qual_bins=BINS),
    "unbinned": dict(n=900, min_len=60, max_len=150, n_prob=0.01, seed=52),
}
# wire tier -> (corpus, environment, the tier's FN_BATCHES name(s))
TIERS = {
    "2c": ("binned", {"HPGQ_WIRE": "bitpack"}, {"2c"}),
    "2q": ("binned", {"HPGQ_WIRE": "bitpack", "HPGQ_WIRE2C": "0"}, {"2q"}),
    "qn8": ("unbinned", {"HPGQ_WIRE": "bitpack"}, {"qn8"}),
    "bitpack": ("unbinned", {"HPGQ_WIRE": "bitpack", "HPGQ_QN_WIRE": "0"},
                {"6bit", "7bit"}),
    "off": ("unbinned", {"HPGQ_WIRE": "off"}, {"plain"}),
}


def _corpus(tmp_path, name, mate=0):
    kw = dict(CORPORA[name])
    kw["seed"] += 100 * mate
    path = str(tmp_path / ("%s%s.fq" % (name, "_%d" % mate if mate else "")))
    make_fastq(path, kw.pop("n"), **kw)
    return path


def _inputs(tmp_path, name, paired):
    if paired:
        return (_corpus(tmp_path, name, 1), _corpus(tmp_path, name, 2))
    return _corpus(tmp_path, name)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _outputs(outdir):
    return {n: _read(os.path.join(outdir, n)) for n in sorted(
        os.listdir(outdir)) if n.endswith(".fq")}


def test_golden_filter_identical(tmp_path):
    """``tests/golden/filter`` (the corpus and flags of
    ``tests/test_golden.py:88``) byte for byte."""
    from hpgq_torch.cli.main import main

    path = str(tmp_path / "in.fq")
    make_fastq(path, 300, min_len=40, max_len=60, n_prob=0.02,
               lowercase_prob=0.05, seed=77)
    out = tmp_path / "out"
    out.mkdir()
    assert main(["filter", "-f", path, "-o", str(out), "--read-quality-range",
                 "20,40", "--max-N", "2", "--device", "cpu"]) == 0
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden", "filter")
    assert sorted(os.listdir(out)) == sorted(os.listdir(golden))
    for name in os.listdir(golden):
        assert _read(str(out / name)) == _read(os.path.join(golden, name)), \
            name


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_filter_identical_to_hpgq(tmp_path, monkeypatch, tier, paired):
    """Console and every output file byte-identical to ``hpgq``'s, with the
    verdict batches on the tier the environment selects."""
    corpus, env, names = TIERS[tier]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    session.FN_BATCHES.clear()
    files = _assert_cli_identical(tmp_path, _inputs(tmp_path, corpus, paired),
                                  False, FILTER, command="filter")
    assert files == (["failed_1.fq", "failed_2.fq", "passed_1.fq",
                      "passed_2.fq"] if paired
                     else ["failed.fq", "passed.fq"])
    tiers = {t for dev, t in session.FN_BATCHES}
    assert tiers and tiers <= names, session.FN_BATCHES
    assert {dev for dev, _ in session.FN_BATCHES} == {"cpu"}
    passed = _read(str(tmp_path / "port" / files[-1]))
    failed = _read(str(tmp_path / "port" / files[0]))
    assert passed and failed


def _filter_opts(inputs, outdir, ck=None, batch=100):
    from hpgq.api import _common, _criteria

    opts = _common(FilterOptions(), inputs[0],
                   inputs[1] if len(inputs) > 1 else None, outdir, "phred33",
                   batch, ck, False)
    _criteria(opts, KW["read_length_range"], KW["read_quality_range"],
              KW["max_N"], None, None, None)
    opts.checkpoint_every = 2
    return opts


@pytest.mark.parametrize("resumer", ["port", "hpgq"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_filter_resume(tmp_path, monkeypatch, paired, resumer):
    """A port run killed after its second checkpoint, resumed by the port
    or by ``hpgq`` (same checkpoint key): outputs byte-identical to an
    uninterrupted run, and the checkpoint removed."""
    from hpgq.pipeline.run import run_filter as hpgq_filter

    inputs = _inputs(tmp_path, "unbinned", paired)
    inputs = inputs if paired else (inputs,)
    want_dir, got_dir = str(tmp_path / "want"), str(tmp_path / "got")
    for d in (want_dir, got_dir):
        os.makedirs(d)
    want = prun.run_filter(_filter_opts(inputs, want_dir), device="cpu")
    ck = str(tmp_path / "ck.npz")
    monkeypatch.setattr(prun, "FastqReader", _CrashAfter(5, prun.FastqReader))
    with pytest.raises(_Killed):
        prun.run_filter(_filter_opts(inputs, got_dir, ck), device="cpu")
    monkeypatch.undo()
    assert os.path.exists(ck)
    opts = _filter_opts(inputs, got_dir, ck)
    got = (prun.run_filter(opts, device="cpu") if resumer == "port"
           else hpgq_filter(opts))
    assert (got["num_passed"], got["num_failed"]) == (want["num_passed"],
                                                      want["num_failed"])
    assert _outputs(got_dir) == _outputs(want_dir)
    assert not os.path.exists(ck)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_filter_parallel_shards_match_serial(tmp_path, monkeypatch, paired):
    """Three shard readers (forced on the CPU) write the serial run's
    bytes, and leave no ``.pshard`` dir behind."""
    inputs = _inputs(tmp_path, "binned", paired)
    inputs = inputs if paired else (inputs,)
    serial, par = str(tmp_path / "serial"), str(tmp_path / "par")
    for d in (serial, par):
        os.makedirs(d)
    want = prun.run_filter(_filter_opts(inputs, serial), device="cpu")
    monkeypatch.setattr(prun, "_PARALLEL_MIN_BYTES", 0)
    monkeypatch.setenv("HPGQ_READ_SHARDS", "3")
    calls = []
    real = prun._run_output_parallel
    monkeypatch.setattr(prun, "_run_output_parallel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = prun.run_filter(_filter_opts(inputs, par), device="cpu")
    assert calls == [1]
    assert (got["num_passed"], got["num_failed"]) == (want["num_passed"],
                                                      want["num_failed"])
    assert _outputs(par) == _outputs(serial)
    assert sorted(os.listdir(par)) == sorted(os.listdir(serial))
    for k in ("passed_filename",) if not paired else ("passed_1", "failed_2"):
        assert os.path.dirname(got[k]) == par


@pytest.mark.parametrize("owner", ["dead", "live"])
def test_stale_pshard_dir(tmp_path, monkeypatch, owner):
    """A ``.pshard`` dir left by a dead run is cleaned before the shards
    write; one owned by a live process is refused, not deleted."""
    path = _corpus(tmp_path, "binned")
    out = str(tmp_path / "out")
    sd = os.path.join(out, ".pshard0001")
    os.makedirs(sd)
    with open(os.path.join(sd, "passed.fq"), "wb") as f:
        f.write(b"@stale\nACGT\n+\nIIII\n")
    pid = os.getppid() if owner == "live" else 2 ** 22 + 12345
    with open(os.path.join(sd, prun._SHARD_OWNER), "w") as f:
        f.write(str(pid))
    serial = str(tmp_path / "serial")
    os.makedirs(serial)
    prun.run_filter(_filter_opts((path,), serial), device="cpu")
    monkeypatch.setattr(prun, "_PARALLEL_MIN_BYTES", 0)
    monkeypatch.setenv("HPGQ_READ_SHARDS", "3")
    if owner == "live":
        with pytest.raises(RuntimeError, match="in use by a concurrent run"):
            prun.run_filter(_filter_opts((path,), out), device="cpu")
        assert os.path.exists(os.path.join(sd, "passed.fq"))
        return
    prun.run_filter(_filter_opts((path,), out), device="cpu")
    assert _outputs(out) == _outputs(serial)
    assert not [n for n in os.listdir(out) if n.startswith(".pshard")]


def test_long_read_filter_identical_to_hpgq(tmp_path, monkeypatch):
    """Reads of 4.5-9 kb on the qn8 wire, NanoFilt-style thresholds:
    byte-identical to ``hpgq`` (run with a small --batch-size to keep its
    CPU rows small; the outputs do not depend on it)."""
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    path = str(tmp_path / "long.fq")
    make_fastq(path, 60, min_len=4500, max_len=9000, n_prob=0.002, seed=8)
    session.FN_BATCHES.clear()
    _assert_cli_identical(tmp_path, path, False,
                          ["--batch-size", "24", "--read-length-range",
                           "5000,8500", "--read-quality-range", "15,60",
                           "--max-N", "20"], command="filter")
    assert set(session.FN_BATCHES) == {("cpu", "qn8")}


def test_long_read_blocks_pad_to_64_rows(tmp_path):
    """A verdict block of long reads pads its rows to a multiple of 64,
    not to a 16,384-row bucket; short reads keep their buckets."""
    shapes = []

    def fn(codes, quals, lens, valid):
        shapes.append(tuple(codes.shape))
        return valid

    long_ = str(tmp_path / "long.fq")
    make_fastq(long_, 40, min_len=5000, max_len=12000, seed=12)
    short = _corpus(tmp_path, "binned")
    for path in (long_, short):
        vfn = session.ShapeCachedFn(fn, 131072, "cpu", qn_ok=True)
        with FastqReader(path, batch_size=10000) as rd:
            for block in rd:
                out = vfn(block)
                assert out.shape == (block.num_reads,) and out.all()
    assert shapes[0][0] == 64 and shapes[0][1] > 4096
    assert shapes[-1][0] == 16384


def test_palette_miss_is_sticky(tmp_path, monkeypatch):
    """On unbinned reads the 2c and 2q attempts stop after three misses in
    a row; every block then goes over qn8 at once."""
    tries = []
    real = session.try_pack_block_2c
    monkeypatch.setattr(session, "try_pack_block_2c",
                        lambda *a, **k: tries.append(1) or real(*a, **k))
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    path = _corpus(tmp_path, "unbinned")
    vfn = session.ShapeCachedFn(lambda c, q, l, v: v, 512, "cpu",
                                qn_ok=True)
    session.FN_BATCHES.clear()
    with FastqReader(path, batch_size=100) as rd:
        n = sum(1 for block in rd if vfn(block).all())
    assert n == 9 and len(tries) == 3
    assert session.FN_BATCHES[("cpu", "qn8")] == 9


def test_filter_without_criteria_exits_as_hpgq(tmp_path, capsys):
    """No threshold: both CLIs exit -1 with the same message after the
    PARAMETERS block; both APIs raise ValueError."""
    import hpgq
    import hpgq_torch
    from hpgq.cli.main import main as hpgq_main
    from hpgq_torch.cli.main import main as port_main

    path = _corpus(tmp_path, "binned")
    runs = []
    for fn, extra in ((hpgq_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            fn(["filter", "-f", path, "-o", str(tmp_path)] + extra)
        runs.append((e.value.code, capsys.readouterr()))
    (rc_ref, ref), (rc_port, port) = runs
    assert rc_ref == rc_port == -1
    assert port.err == ref.err and "Nothing to filter" in port.err
    assert port.out == ref.out
    assert not os.path.exists(os.path.join(str(tmp_path), "passed.fq"))
    for api, kw in ((hpgq.filter_reads, {}),
                    (hpgq_torch.filter_reads, {"device": "cpu"})):
        with pytest.raises(ValueError, match="nothing to filter"):
            api(path, outdir=str(tmp_path), **kw)


def test_cuda_request_raises_here_for_filter_and_paired(tmp_path, capsys):
    """Without a GPU, ``filter`` and paired ``stats`` on cuda raise (API)
    or exit non-zero before printing anything (CLI); nothing runs on the
    CPU instead."""
    import hpgq_torch
    from hpgq_torch.cli.main import main as port_main
    from hpgq_torch.device import DeviceUnavailable

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    p1, p2 = _inputs(tmp_path, "binned", True)
    with pytest.raises(DeviceUnavailable):
        hpgq_torch.filter_reads(p1, outdir=str(tmp_path), max_N=2)
    with pytest.raises(DeviceUnavailable):
        hpgq_torch.stats(p1, p2, outdir=str(tmp_path))
    for argv in (["filter", "--fq1", p1, "--fq2", p2, "--max-N", "2"],
                 ["stats", "--fq1", p1, "--fq2", p2]):
        assert port_main(argv + ["-o", str(tmp_path)]) != 0
        captured = capsys.readouterr()
        assert captured.out == ""
        assert "CUDA is not available" in captured.err
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith(("passed", "failed"))
                or n.endswith(".summary.txt")]
