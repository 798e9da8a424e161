"""The port's `edit` and `prepro` against ``hpgq``, on the CPU.

The same seeded inputs go through ``hpgq`` (jnp on the CPU) and the port:

* ``stats_torch.trims`` / ``apply_trims`` against ``stats_jnp``'s on the
  same numpy batches;
* the edit step's ``(lt, rt, ok)`` against ``hpgq``'s ``_make_edit_fn`` /
  ``_make_edit_pair_fn`` on every wire tier the step can ride;
* the CLI: console (RESULTS block included) and every output file
  byte-identical to ``hpgq``'s, single-end and paired, and to
  ``tests/golden/{edit,prepro}``;
* resume across the two packages, shard readers and a bad mate-2 path.

Tolerance: none.  Every trim, verdict, count and byte must be equal.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from gen import make_fastq

import hpgq.pipeline.run as hrun
from hpgq.io.fastq import FastqReader as HReader
from hpgq.kernels import stats_jnp
from hpgq.options import EditOptions as HEditOptions
from hpgq.options import FilterCriteria as HCrit
from hpgq_torch.io.fastq import FastqReader
from hpgq_torch.kernels import stats_torch
from hpgq_torch.options import EditOptions, FilterCriteria
from hpgq_torch.pipeline import run as prun
from hpgq_torch.pipeline import session
from test_torch_pipeline import _assert_cli_identical, _CrashAfter, _Killed

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
BINS = (2, 12, 23, 37)
EDIT_FLAGS = ["--left-length", "8", "--left-quality-range", "28,60",
              "--right-length", "6", "--right-quality-range", "28,60"]
POST_FLAGS = ["--read-quality-range", "20,45", "--max-N", "2"]
CORPORA = {
    "binned": dict(n=900, min_len=40, max_len=150, n_prob=0.01, seed=61,
                   qual_bins=BINS),
    "unbinned": dict(n=900, min_len=40, max_len=150, n_prob=0.01, seed=62,
                     lowercase_prob=0.03),
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
    return (_corpus(tmp_path, name),)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _outputs(outdir):
    return {n: _read(os.path.join(outdir, n))
            for n in sorted(os.listdir(outdir))}


# ---------------------------------------------------------------- trims

def _batch(B, L, seed, lens=None, phred=33, lo=2, hi=41):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=B) if lens is None else lens
    lens = np.asarray(lens, dtype=np.int32)
    pos = np.arange(L)[None, :]
    inside = pos < lens[:, None]
    codes = np.where(inside, rng.integers(0, 5, size=(B, L)), 5)
    quals = np.where(inside, rng.integers(lo, hi + 1, size=(B, L)) + phred, 0)
    return codes.astype(np.int8), quals.astype(np.uint8), lens


TRIM_CASES = {
    # name: (batch keywords, criteria keywords, phred)
    "left only": (dict(B=200, L=256, seed=1),
                  dict(left_length=10, min_left_quality=20,
                       max_left_quality=30), 33),
    "right only": (dict(B=200, L=256, seed=2),
                   dict(right_length=12, min_right_quality=18,
                        max_right_quality=40), 33),
    "both": (dict(B=200, L=256, seed=3),
             dict(left_length=8, min_left_quality=28, max_left_quality=60,
                  right_length=6, min_right_quality=28,
                  max_right_quality=60), 33),
    # unset bounds: MIN becomes qn >= 0 (qualities below the offset
    # fail), MAX is skipped
    "MIN and MAX sentinels": (dict(B=200, L=128, seed=4, lo=-5, hi=10),
                              dict(left_length=5, max_left_quality=6,
                                   right_length=5, min_right_quality=3), 33),
    "windows longer than the read": (dict(B=200, L=128, seed=5),
                                     dict(left_length=300,
                                          min_left_quality=25,
                                          right_length=200,
                                          min_right_quality=15), 33),
    "length 0": (dict(B=64, L=128, seed=6, lens=[0] * 32 + [1] * 16
                      + [7] * 16),
                 dict(left_length=4, min_left_quality=20,
                      right_length=4, min_right_quality=20), 33),
    "phred64": (dict(B=200, L=256, seed=7, phred=64),
                dict(left_length=10, min_left_quality=20,
                     right_length=10, min_right_quality=22), 64),
    "reads of 20,000 bp": (dict(B=6, L=20096, seed=8,
                                lens=[20000, 19999, 20096, 5000, 0, 20000]),
                           dict(left_length=5000, min_left_quality=22,
                                right_length=7000, min_right_quality=22),
                           33),
}


@pytest.mark.parametrize("case", list(TRIM_CASES))
def test_trims_and_apply_trims_match_jnp(case):
    """Exact: the cuts, and the shifted codes, qualities and lengths."""
    bkw, ckw, phred = TRIM_CASES[case]
    codes, quals, lens = _batch(**bkw)
    lt_j, rt_j = stats_jnp.trims(quals, lens, HCrit(**ckw), phred)
    t = [torch.from_numpy(a) for a in (codes, quals, lens)]
    lt, rt = stats_torch.trims(t[1], t[2], FilterCriteria(**ckw), phred)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lt_j))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rt_j))
    assert (lt + rt <= t[2]).all()
    want = stats_jnp.apply_trims(codes, quals, lens, lt_j, rt_j)
    got = stats_torch.apply_trims(*t, lt, rt)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(((lt > 0) | (rt > 0)).any())  # the case cuts something


# ---------------------------------------------------------------- edit step

def _edit_opts(cls, inputs, outdir, filter_on=True, batch=150, ck=None):
    o = cls()
    o.in_filename = inputs[0]
    o.in_filename2 = inputs[1] if len(inputs) > 1 else None
    o.out_dirname = str(outdir)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = batch
    o.checkpoint_path = ck
    o.checkpoint_every = 2
    c = o.criteria
    c.left_length, c.min_left_quality, c.max_left_quality = 8, 28, 60
    c.right_length, c.min_right_quality, c.max_right_quality = 6, 28, 60
    if filter_on:
        c.min_read_quality, c.max_read_quality, c.max_N = 20, 45, 2
    o.filter_on = filter_on
    return o


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_edit_step_matches_hpgq(tmp_path, monkeypatch, tier, paired):
    """``(lt, rt, ok)`` block by block equal to ``hpgq``'s edit functions,
    with the blocks on the tier the environment selects."""
    corpus, env, names = TIERS[tier]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    inputs = _inputs(tmp_path, corpus, paired)
    ho = _edit_opts(HEditOptions, inputs, tmp_path)
    po = _edit_opts(EditOptions, inputs, tmp_path)
    if paired:
        hfn, pfn = (hrun._make_edit_pair_fn(ho, 1024),
                    prun._make_edit_pair_fn(po, 1024, torch.device("cpu")))
    else:
        hfn, pfn = (hrun._make_edit_fn(ho, 1024),
                    prun._make_edit_fn(po, 1024, torch.device("cpu")))
    session.FN_BATCHES.clear()
    n = 0
    with contextlib.ExitStack() as stack:
        readers = [stack.enter_context(cls(p, batch_size=300))
                   for cls in (FastqReader, HReader) for p in inputs]
        for blocks in zip(*readers):
            got = pfn(*blocks[:len(inputs)])
            want = hfn(*blocks[len(inputs):])
            assert len(got) == len(want) == (5 if paired else 3)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))
            n += 1
    assert n == 3
    tiers = {t for dev, t in session.FN_BATCHES}
    assert tiers and tiers <= names, session.FN_BATCHES
    assert sum(session.FN_BATCHES.values()) == n * len(inputs)


# ---------------------------------------------------------------- CLI

@pytest.mark.parametrize("command,filtered", [
    ("edit", False), ("edit", True), ("prepro", False)],
    ids=["edit", "edit+filter", "prepro"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_cli_identical_to_hpgq(tmp_path, monkeypatch, corpus, paired,
                               command, filtered):
    """Console (RESULTS block included) and every output file
    byte-identical to ``hpgq``'s."""
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    inputs = _inputs(tmp_path, corpus, paired)
    if command == "prepro":
        flags = ["--ltrim-nts", "6", "--rtrim-nts", "4", "--min-quality",
                 "25", "--max-quality", "64"]
    else:
        flags = EDIT_FLAGS + (POST_FLAGS if filtered else [])
    files = _assert_cli_identical(tmp_path, inputs if paired else inputs[0],
                                  False, flags, command=command)
    if command == "prepro":
        assert files == sorted(os.path.basename(p) + ".valid"
                               for p in inputs)
    else:
        want = ["edit.fq"] if not paired else ["edit_1.fq", "edit_2.fq"]
        if filtered:
            want += ["failed.fq"] if not paired else ["failed_1.fq",
                                                      "failed_2.fq"]
        assert files == sorted(want)
    assert all(_read(str(tmp_path / "port" / f)) for f in files)


@pytest.mark.parametrize("command", ["edit", "prepro"])
def test_golden_identical(tmp_path, command):
    """``tests/golden/<command>`` (the corpus and flags of
    ``tests/test_golden.py``) byte for byte, through the port's CLI."""
    from hpgq_torch.cli.main import main

    path = str(tmp_path / "in.fq")
    make_fastq(path, 300, min_len=40, max_len=60, n_prob=0.02,
               lowercase_prob=0.05, seed=77)
    out = tmp_path / "out"
    out.mkdir()
    flags = (["--left-length", "8", "--left-quality-range", "28,60",
              "--right-length", "6", "--right-quality-range", "28,60",
              "--read-quality-range", "20,45"] if command == "edit" else
             ["--ltrim-nts", "5", "--rtrim-nts", "3", "--min-quality", "27",
              "--max-quality", "64"])
    assert main([command, "-f", path, "-o", str(out), "--device", "cpu",
                 "--log-file", str(tmp_path / "log")] + flags) == 0
    assert _outputs(str(out)) == _outputs(os.path.join(GOLDEN, command))


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_api_matches_hpgq_api(tmp_path, paired):
    """``hpgq_torch.edit`` and ``prepro`` return ``hpgq``'s counts and
    write its bytes."""
    import hpgq
    import hpgq_torch

    inputs = _inputs(tmp_path, "unbinned", paired)
    kw = dict(left_length=9, left_quality_range=(25, 60), right_length=7,
              right_quality_range=(20, None), filter_after=True,
              read_length_range=(30, 140), max_N=1)
    pkw = dict(ltrim_nts=4, rtrim_nts=9, min_quality=5, max_quality=80)
    for fn, kws in (("edit", kw), ("prepro", pkw)):
        want = getattr(hpgq, fn)(*inputs, outdir=str(tmp_path / ("h" + fn)),
                                 batch_size=200, **kws)
        got = getattr(hpgq_torch, fn)(*inputs,
                                      outdir=str(tmp_path / ("p" + fn)),
                                      batch_size=200, device="cpu", **kws)
        for k in ("num_edited", "num_passed", "num_failed"):
            assert got[k] == want[k], (fn, k)
        assert got["num_edited"] > 0
        assert _outputs(str(tmp_path / ("p" + fn))) == \
            _outputs(str(tmp_path / ("h" + fn)))


def test_long_read_edit_identical_to_hpgq(tmp_path, monkeypatch):
    """Reads of 4.5-9 kb on the qn8 wire, a 50-base right window and a
    NanoFilt-style post-filter: byte-identical to ``hpgq`` (run with a
    small --batch-size to keep its CPU rows small)."""
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    path = str(tmp_path / "long.fq")
    make_fastq(path, 60, min_len=4500, max_len=9000, n_prob=0.002, seed=8)
    session.FN_BATCHES.clear()
    _assert_cli_identical(tmp_path, path, False, [
        "--batch-size", "24", "--right-length", "50",
        "--right-quality-range", "21,60", "--read-length-range",
        "5000,8500", "--read-quality-range", "15,60", "--max-N", "20"],
        command="edit")
    assert set(session.FN_BATCHES) == {("cpu", "qn8")}
    assert _read(str(tmp_path / "port" / "failed.fq"))


def test_nothing_to_edit_exits_as_hpgq(tmp_path, capsys):
    """No trim window: both CLIs exit -1 with the same message after the
    same PARAMETERS block; both APIs raise ValueError."""
    import hpgq
    import hpgq_torch
    from hpgq.cli.main import main as hpgq_main
    from hpgq_torch.cli.main import main as port_main

    path = _corpus(tmp_path, "binned")
    runs = []
    for fn, extra in ((hpgq_main, []), (port_main, ["--device", "cpu"])):
        for argv in (["edit", "--max-N", "2"], ["prepro"]):
            with pytest.raises(SystemExit) as e:
                fn(argv + ["-f", path, "-o", str(tmp_path), "--log-file",
                           str(tmp_path / "log")] + extra)
            runs.append((e.value.code, capsys.readouterr()))
    for (rc_ref, ref), (rc_port, port) in zip(runs[:2], runs[2:]):
        assert rc_ref == rc_port == -1
        assert port.err == ref.err and "Nothing to" in port.err
        assert port.out == ref.out
    for api, kw in ((hpgq, {}), (hpgq_torch, {"device": "cpu"})):
        with pytest.raises(ValueError, match="nothing to edit"):
            api.edit(path, outdir=str(tmp_path), **kw)
        with pytest.raises(ValueError, match="nothing to preprocess"):
            api.prepro(path, outdir=str(tmp_path), **kw)
    assert not [n for n in os.listdir(tmp_path) if n.endswith((".fq",
                                                                ".valid"))
                and n != "binned.fq"]


def test_prepro_quarter_rule_as_hpgq(tmp_path, capsys):
    """``--ltrim-nts`` above a quarter of ``--min-read-length``: both CLIs
    refuse with the same message."""
    from hpgq.cli.main import main as hpgq_main
    from hpgq_torch.cli.main import main as port_main

    path = _corpus(tmp_path, "binned")
    errs = []
    for fn, extra in ((hpgq_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            fn(["prepro", "-f", path, "-o", str(tmp_path), "--ltrim-nts",
                "13", "--log-file", str(tmp_path / "log")] + extra)
        assert e.value.code == -1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "1/4" in errs[1]


# ---------------------------------------------------------------- resume

def _run(pkg, opts):
    if pkg == "port":
        return prun.run_edit(opts, device="cpu")
    return hrun.run_edit(opts)


@pytest.mark.parametrize("writer,resumer", [
    ("port", "port"), ("port", "hpgq"), ("hpgq", "port")])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_edit_resume(tmp_path, monkeypatch, paired, writer, resumer):
    """A run killed after its second checkpoint (written by ``writer``)
    and resumed by ``resumer`` (the same key, ``edit`` or
    ``edit-paired``): outputs and counts byte-identical to an
    uninterrupted run, the checkpoint removed."""
    inputs = _inputs(tmp_path, "unbinned", paired)
    want_dir, got_dir = tmp_path / "want", tmp_path / "got"
    want_dir.mkdir()
    got_dir.mkdir()
    cls = {"port": EditOptions, "hpgq": HEditOptions}
    want = prun.run_edit(_edit_opts(EditOptions, inputs, want_dir, batch=100),
                         device="cpu")
    ck = str(tmp_path / "ck.npz")
    mod = prun if writer == "port" else hrun
    monkeypatch.setattr(mod, "FastqReader", _CrashAfter(5, mod.FastqReader))
    with pytest.raises(_Killed):
        _run(writer, _edit_opts(cls[writer], inputs, got_dir, batch=100,
                                ck=ck))
    monkeypatch.undo()
    assert os.path.exists(ck)
    got = _run(resumer, _edit_opts(cls[resumer], inputs, got_dir, batch=100,
                                   ck=ck))
    for k in ("num_edited", "num_passed", "num_failed"):
        assert got[k] == want[k], k
    assert _outputs(str(got_dir)) == _outputs(str(want_dir))
    assert not os.path.exists(ck)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_edit_shard_readers_match_serial(tmp_path, monkeypatch, paired):
    """``HPGQ_READ_SHARDS=2`` (forced on the CPU) writes the serial run's
    bytes and counts, and leaves no ``.pshard`` dir behind."""
    inputs = _inputs(tmp_path, "binned", paired)
    serial, par = tmp_path / "serial", tmp_path / "par"
    serial.mkdir()
    par.mkdir()
    want = prun.run_edit(_edit_opts(EditOptions, inputs, serial),
                         device="cpu")
    monkeypatch.setattr(prun, "_PARALLEL_MIN_BYTES", 0)
    monkeypatch.setenv("HPGQ_READ_SHARDS", "2")
    calls = []
    real = prun._run_output_parallel
    monkeypatch.setattr(prun, "_run_output_parallel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = prun.run_edit(_edit_opts(EditOptions, inputs, par), device="cpu")
    assert calls == [1]
    for k in ("num_edited", "num_passed", "num_failed"):
        assert got[k] == want[k], k
    assert _outputs(str(par)) == _outputs(str(serial))
    key = "edit_2" if paired else "edit_filename"
    assert got[key] == os.path.join(str(par), os.path.basename(want[key]))


def test_paired_edit_bad_mate_preserves_outputs(tmp_path):
    """A paired edit whose mate 2 fails to open leaves the previous run's
    outputs as they were (``tests/test_api.py:290``)."""
    inputs = _inputs(tmp_path, "binned", True)
    prun.run_edit(_edit_opts(EditOptions, inputs, tmp_path), device="cpu")
    names = ("edit_1.fq", "edit_2.fq", "failed_1.fq", "failed_2.fq")
    before = {n: _read(str(tmp_path / n)) for n in names}
    assert all(before.values())
    with pytest.raises(FileNotFoundError):
        prun.run_edit(_edit_opts(EditOptions, (inputs[0],
                                               str(tmp_path / "missing.fq")),
                                 tmp_path), device="cpu")
    assert {n: _read(str(tmp_path / n)) for n in names} == before


def test_cuda_request_raises_here(tmp_path, capsys):
    """Without a GPU, ``edit``, ``prepro`` and ``cgr`` on cuda raise (API)
    or exit non-zero before printing anything (CLI)."""
    import hpgq_torch
    from hpgq_torch.cli.main import main as port_main
    from hpgq_torch.device import DeviceUnavailable

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    path = _corpus(tmp_path, "binned")
    for fn, kw in ((hpgq_torch.edit, dict(left_length=5)),
                   (hpgq_torch.prepro, dict(ltrim_nts=5)),
                   (hpgq_torch.cgr, {})):
        with pytest.raises(DeviceUnavailable):
            fn(path, outdir=str(tmp_path), **kw)
    for argv in (["edit", "--left-length", "5"], ["prepro", "--ltrim-nts",
                                                  "5"], ["cgr"]):
        assert port_main(argv + ["-f", path, "-o", str(tmp_path)]) != 0
        captured = capsys.readouterr()
        assert captured.out == ""
        assert "CUDA is not available" in captured.err
    assert sorted(os.listdir(tmp_path)) == ["binned.fq"]
