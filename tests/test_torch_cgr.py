"""The port's `cgr` against ``hpgq``, on the CPU.

The same seeded inputs go through ``hpgq`` (the jnp one-hot matmul tables
with their two int32 quality limbs) and the port (int64 ``index_add_``):

* ``cgr_torch.cgr_batch_tables`` against ``hpgq.kernels.cgr``'s with
  ``combine_quality_limbs``, for k 1-8 and 10, with N and other bytes
  ([D7]), quality bytes below the offset, reads shorter than k, and on the
  wire entry; one quality cell past 2^31;
* ``from_jax_cgr_acc`` turning a JAX accumulator into the port's;
* the CLI: console (RESULTS block, diff mean and stddev included) and the
  PGM and ``.gs`` files byte-identical to ``hpgq``'s, single-end and
  paired, and to ``tests/golden/{cgr,cgr_gs,cgr_diff}``;
* resume across the two packages.

Tolerance: none.  Every table cell, count and byte must be equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gen import make_fastq

import hpgq.pipeline.cgr_run as hcgr_run
from hpgq.kernels import cgr as hcgr
from hpgq.options import CgrOptions as HCgrOptions
from hpgq_torch.core.accumulator import from_jax_cgr_acc
from hpgq_torch.io.fastq import FastqReader
from hpgq_torch.io.packer import pack_block_wire
from hpgq_torch.kernels import cgr_torch
from hpgq_torch.options import CgrOptions
from hpgq_torch.pipeline import cgr_run
from test_torch_pipeline import _assert_cli_identical, _CrashAfter, _Killed

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _batch(B, L, seed, n_prob=0.02, other_prob=0.0, qlo=33, qhi=74,
           min_len=1):
    """(codes int8, quals uint8, lens int32, valid bool), packer layout."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, L + 1, size=B).astype(np.int32)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_prob] = 4
    codes[rng.random((B, L)) < other_prob] = 5
    inside = np.arange(L)[None, :] < lens[:, None]
    codes = np.where(inside, codes, np.int8(5))
    quals = np.where(inside, rng.integers(qlo, qhi + 1, size=(B, L)),
                     0).astype(np.uint8)
    valid = rng.random(B) < 0.9
    return codes, quals, lens, valid


def _jax_tables(arrs, k, phred=33):
    ts, hi, lo, w = hcgr.cgr_batch_tables(*arrs, k, phred)
    return (np.asarray(ts, np.int64), hcgr.combine_quality_limbs(hi, lo),
            int(w))


def _port_tables(arrs, k, phred=33):
    ts, tq, w = cgr_torch.cgr_batch_tables(
        *(torch.from_numpy(a) for a in arrs), k, phred)
    assert ts.dtype == tq.dtype == torch.int64
    return ts.numpy(), tq.numpy(), int(w)


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 10])
def test_batch_tables_match_jax(k):
    arrs = _batch(40, 128 if k < 10 else 64, seed=k, other_prob=0.01)
    want = _jax_tables(arrs, k)
    _assert_tables_equal(_port_tables(arrs, k), want)
    assert want[2] > 0


@pytest.mark.parametrize("case", ["other bytes as N", "qualities below the "
                                  "offset", "reads shorter than k",
                                  "phred64"])
def test_batch_tables_edge_cases_match_jax(case):
    """[D7] code-5 bytes inside reads break words like N; negative quality
    weights; no word at all; phred 64."""
    k, phred = 5, 33
    if case == "other bytes as N":
        arrs = _batch(120, 96, seed=91, other_prob=0.05)
    elif case == "qualities below the offset":
        arrs = _batch(120, 96, seed=92, qlo=28, qhi=38)
    elif case == "reads shorter than k":
        arrs = _batch(50, 128, seed=93)
        arrs[2][:] = np.minimum(arrs[2], k - 1)
    else:
        arrs, phred = _batch(120, 96, seed=94, qlo=66, qhi=104), 64
    want = _jax_tables(arrs, k, phred)
    got = _port_tables(arrs, k, phred)
    _assert_tables_equal(got, want)
    if case == "other bytes as N":
        from hpgq.oracle.cgr import fill_tables_loop

        as_n = np.where(arrs[0] == 5, np.int8(4), arrs[0])
        _assert_tables_equal(got, fill_tables_loop(as_n, *arrs[1:], k, 33))
    if case == "qualities below the offset":
        assert got[1].min() < 0
    if case == "reads shorter than k":
        assert got[2] == 0 and not got[0].any() and not got[1].any()


def test_quality_cell_past_int32():
    """``tests/test_cgr.py:241-261``: 3000 poly-A reads of 4096 at quality
    126, k=2; one quality cell holds 3000 * 4095 * 186 > 2^31, exact, and
    equal to the JAX tables' two limbs combined."""
    k, B, L = 2, 3000, 4096
    arrs = (np.zeros((B, L), np.int8), np.full((B, L), 126, np.uint8),
            np.full(B, L, np.int32), np.ones(B, bool))
    got = _port_tables(arrs, k)
    nwin = B * (L - k + 1)
    assert got[2] == nwin == got[0][3, 0] == got[0].sum()
    assert got[1][3, 0] == got[1].sum() == nwin * (2 * 126 - 2 * 33)
    assert got[1][3, 0] > 2 ** 31
    _assert_tables_equal(got, _jax_tables(arrs, k))


@pytest.mark.parametrize("tier", ["2q", "6bit", "7bit"])
def test_wire_entry_matches_plain(tmp_path, monkeypatch, tier):
    """``make_cgr_step(wire='bitpack')`` over the 2q, 6-bit and 7-bit
    buffers equals the plain step and ``hpgq``'s tables."""
    from hpgq.io.fastq import FastqReader as HReader
    from hpgq.io.packer import pack_block as h_pack_block
    from hpgq_torch.kernels.wire_torch import bitwire_kind

    if tier == "7bit":
        monkeypatch.setenv("HPGQ_WIRE6", "0")
    path = str(tmp_path / "w.fq")
    make_fastq(path, 400, min_len=30, max_len=90, n_prob=0.03, seed=14,
               lowercase_prob=0.03,
               qual_bins=(2, 12, 23, 37) if tier == "2q" else None)
    k = 4
    plain = cgr_torch.make_cgr_step(k, 33)
    wire = cgr_torch.make_cgr_step(k, 33, wire="bitpack")
    with FastqReader(path, batch_size=150) as rd, \
            HReader(path, batch_size=150) as hrd:
        for block, hblock in zip(rd, hrd):
            buf = pack_block_wire(block, "bitpack", 96, pad_reads_to=256,
                                  allow6=True)
            assert {2: "2q", 6: "6bit", 7: "7bit"}[
                bitwire_kind(buf.shape[1])[0]] == tier
            got = wire(cgr_torch.zero_cgr_acc(k, "cpu"), torch.from_numpy(buf))
            want = _jax_tables(h_pack_block(hblock, max_len=128), k)
            arrs = [torch.from_numpy(a) for a in h_pack_block(hblock)]
            ref = plain(cgr_torch.zero_cgr_acc(k, "cpu"), *arrs)
            for acc in (got, ref):
                np.testing.assert_array_equal(acc["table_seq"].numpy(),
                                              want[0])
                np.testing.assert_array_equal(acc["table_q"].numpy(),
                                              want[1])
                assert int(acc["words"]) == want[2]


def test_from_jax_cgr_acc():
    """Two batches through ``hpgq``'s step, carried over with
    ``from_jax_cgr_acc``, equal two batches through the port's step; a
    third batch then adds onto the converted accumulator."""
    k = 6
    b1, b2, b3 = (_batch(64, 128, seed=s, qlo=30) for s in (1, 2, 3))
    hstep = hcgr.make_cgr_step(k, 33, jit=False)
    hacc = hcgr.zero_cgr_acc(k)
    for b in (b1, b2):
        hacc = hstep(hacc, *b)
    conv = from_jax_cgr_acc({key: np.asarray(v) for key, v in hacc.items()},
                            "cpu")
    step = cgr_torch.make_cgr_step(k, 33)
    acc = cgr_torch.zero_cgr_acc(k, "cpu")
    for b in (b1, b2):
        acc = step(acc, *(torch.from_numpy(a) for a in b))
    assert set(conv) == set(acc)
    for key in acc:
        assert conv[key].dtype == torch.int64
        assert torch.equal(conv[key], acc[key]), key
    conv = step(conv, *(torch.from_numpy(a) for a in b3))
    hacc = hstep(hacc, *b3)
    np.testing.assert_array_equal(
        conv["table_q"].numpy(),
        hcgr.combine_quality_limbs(hacc["table_q_hi"], hacc["table_q_lo"]))


# ---------------------------------------------------------------- CLI

def _golden_corpus(tmp_path, name, seed):
    path = str(tmp_path / name)
    make_fastq(path, 300, min_len=40, max_len=60, n_prob=0.02,
               lowercase_prob=0.05, seed=seed)
    return path


def _tree(d):
    out = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


def test_golden_identical(tmp_path):
    """``tests/golden/cgr``, ``cgr_gs`` and ``cgr_diff`` (the corpora and
    flags of ``tests/test_golden.py``) byte for byte, through the port's
    CLI."""
    from hpgq_torch.cli.main import main

    runs = [("cgr", "cg.fq", 78, []), ("cgr_gs", "ga.fq", 79, ["--write-gs"]),
            ("cgr_diff", "gb.fq", 80,
             ["--gs-filename", str(tmp_path / "cgr_gs" / "ga.fq_k=5.gs")])]
    for sub, name, seed, extra in runs:
        out = tmp_path / sub
        out.mkdir()
        assert main(["cgr", "-f", _golden_corpus(tmp_path, name, seed), "-o",
                     str(out), "--k", "5", "--device", "cpu", "--log-file",
                     str(tmp_path / "log")] + extra) == 0
        assert _tree(str(out)) == _tree(os.path.join(GOLDEN, sub)), sub


CORPUS = dict(n=700, min_len=30, max_len=160, n_prob=0.01, seed=71,
              lowercase_prob=0.02)


def _inputs(tmp_path, paired, **kw):
    out = []
    for mate in (1, 2) if paired else (0,):
        c = dict(CORPUS, **kw)
        c["seed"] += 100 * mate
        out.append(str(tmp_path / ("c%d.fq" % mate)))
        make_fastq(out[-1], c.pop("n"), **c)
    return tuple(out)


@pytest.mark.parametrize("wire", ["off", "bitpack"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("k", [3, 7])
def test_cli_identical_to_hpgq(tmp_path, monkeypatch, k, paired, wire):
    """Console and every PGM and ``.gs`` byte-identical to ``hpgq``'s, then
    a second run against a reference signature: the ``_FG_dif.pgm`` and
    the ``Diff matrix mean`` / ``stddev`` lines too."""
    monkeypatch.setenv("HPGQ_WIRE", wire)
    inputs = _inputs(tmp_path, paired)
    arg = inputs if paired else inputs[0]
    cgr_run.BATCHES.clear()
    files = _assert_cli_identical(tmp_path / "a", arg, False,
                                  ["--k", str(k), "--write-gs"],
                                  command="cgr")
    assert files == sorted("c%d.fq_k=%d%s" % (1 if paired else 0, k, s)
                           for s in ("_FG.pgm", "_QQ.pgm", ".gs"))
    tiers = {t for _, t in cgr_run.BATCHES}
    assert tiers and tiers <= ({"plain"} if wire == "off"
                               else {"2q", "6bit", "7bit"}), tiers
    ref = _inputs(tmp_path / "a", False, seed=5)[0]
    gs = str(tmp_path / "gs")
    assert hcgr_run_cli(["cgr", "-f", ref, "-o", gs, "--k", str(k),
                         "--write-gs", "--log-file", str(tmp_path / "log")])
    files = _assert_cli_identical(
        tmp_path / "b", arg, False,
        ["--k", str(k), "--gs-filename",
         os.path.join(gs, "c0.fq_k=%d.gs" % k)], command="cgr")
    assert any(f.endswith("_FG_dif.pgm") for f in files)


def hcgr_run_cli(argv):
    from hpgq.cli.main import main

    os.makedirs(argv[argv.index("-o") + 1], exist_ok=True)
    return main(argv) == 0


def test_self_diff_is_zero(tmp_path):
    """A file against its own signature: an all-zero ``_FG_dif.pgm``, mean
    and stddev 0 (the SKILL.md flow)."""
    import hpgq_torch

    path = _inputs(tmp_path, False)[0]
    a = hpgq_torch.cgr(path, outdir=str(tmp_path / "a"), k=4, write_gs=True,
                       device="cpu")
    b = hpgq_torch.cgr(path, outdir=str(tmp_path / "b"), k=4,
                       gs_filename=a["gs_file"], device="cpu")
    with open(b["pgm_files"][-1], "rb") as f:
        assert set(f.read().split(b"\n", 3)[3]) == {0}
    assert b["mean_dif"] == 0.0 and b["std_dif"] == 0.0


def test_api_matches_hpgq_api(tmp_path):
    import hpgq
    import hpgq_torch

    inputs = _inputs(tmp_path, True)
    want = hpgq.cgr(*inputs, outdir=str(tmp_path / "h"), k=6, batch_size=200)
    got = hpgq_torch.cgr(*inputs, outdir=str(tmp_path / "p"), k=6,
                         batch_size=200, device="cpu")
    np.testing.assert_array_equal(got["table_seq"], want["table_seq"])
    np.testing.assert_array_equal(got["table_q"], want["table_q"])
    assert got["fq_word_count"] == want["fq_word_count"] > 0


def test_checkpointed_cgr_reads_ahead(tmp_path):
    """The resumable loop reads through the prefetching iterator, as
    ``hpgq``'s does: its ``--t`` report has a ``read`` line, and the tables
    equal those of a run with no checkpoint."""
    import contextlib
    import io

    from hpgq_torch.utils.timers import StageTimers

    path = _inputs(tmp_path, False, n=1200)[0]
    want = cgr_run.run_cgr(_opts(CgrOptions, [path], tmp_path / "w", None),
                           device="cpu")
    timers = StageTimers()
    got = cgr_run.run_cgr(_opts(CgrOptions, [path], tmp_path / "c",
                                str(tmp_path / "ck.npz")), timers,
                          device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        timers.report()
    assert "total read time" in out.getvalue()
    assert timers.num_batches == 12
    np.testing.assert_array_equal(got["table_seq"], want["table_seq"])
    np.testing.assert_array_equal(got["table_q"], want["table_q"])
    assert got["fq_word_count"] == want["fq_word_count"]


def test_pool_threads_lose_no_table(tmp_path, monkeypatch):
    """More pool threads than cores and a short switch interval: the
    tables equal a serial run and every block is counted once."""
    import hpgq_torch
    from hpgq_torch.utils.timers import StageTimers

    path = _inputs(tmp_path, False, n=2000)[0]
    want = hpgq_torch.cgr(path, outdir=str(tmp_path / "s"), k=5,
                          batch_size=2000, device="cpu")
    monkeypatch.setenv("HPGQ_PACK_THREADS", str(2 * (os.cpu_count() or 4)))
    opts = CgrOptions(in_filename=path, out_dirname=str(tmp_path), k=5)
    opts.batch_size = 50
    cgr_run.BATCHES.clear()
    timers = StageTimers()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = cgr_run.run_cgr(opts, timers, device="cpu")
    finally:
        sys.setswitchinterval(interval)
    assert sum(cgr_run.BATCHES.values()) == timers.num_batches == 40
    np.testing.assert_array_equal(got["table_seq"], want["table_seq"])
    np.testing.assert_array_equal(got["table_q"], want["table_q"])
    assert got["fq_word_count"] == want["fq_word_count"]


# ---------------------------------------------------------------- resume

def _opts(cls, inputs, outdir, ck):
    o = cls()
    o.in_filename = inputs[0]
    o.in_filename2 = inputs[1] if len(inputs) > 1 else None
    o.out_dirname = str(outdir)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 100
    o.k = 5
    o.checkpoint_path = ck
    o.checkpoint_every = 2
    return o


@pytest.mark.parametrize("writer,resumer", [
    ("port", "port"), ("port", "hpgq"), ("hpgq", "port")])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_cgr_resume(tmp_path, monkeypatch, paired, writer, resumer):
    """A run killed after its checkpoints (in mate 2's file when paired),
    resumed by the other package or the same one: the tables and PGMs of
    an uninterrupted run, the checkpoint removed."""
    inputs = _inputs(tmp_path, paired, n=500)
    want = cgr_run.run_cgr(_opts(CgrOptions, inputs, tmp_path / "w", None),
                           device="cpu")
    ck = str(tmp_path / "ck.npz")
    mod = cgr_run if writer == "port" else hcgr_run
    crash = _CrashAfter(3)
    if paired:  # mate 1 whole, then mate 2 dies after 3 blocks
        real = crash.__call__
        crash = (lambda path, *a, **k: real(path, *a, **k)
                 if path == inputs[1] else _CrashAfter(10 ** 9)(path, *a,
                                                                **k))
    monkeypatch.setattr(mod, "FastqReader", crash)
    cls = {"port": CgrOptions, "hpgq": HCgrOptions}
    with pytest.raises(_Killed):
        run = (cgr_run.run_cgr if writer == "port" else hcgr_run.run_cgr)
        kw = {"device": "cpu"} if writer == "port" else {}
        run(_opts(cls[writer], inputs, tmp_path / "g", ck), **kw)
    monkeypatch.undo()
    assert os.path.exists(ck)
    o = _opts(cls[resumer], inputs, tmp_path / "g", ck)
    got = (cgr_run.run_cgr(o, device="cpu") if resumer == "port"
           else hcgr_run.run_cgr(o))
    np.testing.assert_array_equal(got["table_seq"], want["table_seq"])
    np.testing.assert_array_equal(got["table_q"], want["table_q"])
    assert got["fq_word_count"] == want["fq_word_count"]
    assert _tree(str(tmp_path / "g")) == _tree(str(tmp_path / "w"))
    assert not os.path.exists(ck)
