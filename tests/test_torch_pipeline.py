"""The port's `stats` command end to end on the CPU, against ``hpgq``.

The same generated corpus and flags go through ``hpgq``'s CLI (JAX on the
CPU) and ``hpgq_torch``'s CLI with ``--device cpu``: the report trees must
be byte-identical after ``tests/test_golden.py``'s normalisation, and the
console output must match.  One exception is allowed by design: the
``Mean quality`` report line comes from the f32 ``acc_quality`` sum, whose
last bits depend on summation order, so where that line differs it is
compared as a number to 1e-3 relative instead of as bytes.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gen import make_fastq

from hpgq.cli.main import main as hpgq_main
from hpgq.core.counters import StatsCounters
from hpgq.io.fastq import FastqReader
from hpgq.io.packer import pack_block
from hpgq.options import FilterCriteria
from hpgq.oracle import baseline as ob
from hpgq_torch.cli.main import main as port_main
from hpgq_torch.core.accumulator import resolve_wire
from hpgq_torch.device import DeviceUnavailable, resolve_device
from hpgq_torch.pipeline import run as prun
from hpgq_torch.pipeline.ranges import range_splittable, split_byte_ranges
from hpgq_torch.pipeline.session import StatsSession, to_device

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTER_FLAGS = ["--read-length-range", "45,140", "--read-quality-range",
                "20,60", "--max-N", "2"]
CRIT = FilterCriteria(min_read_length=45, max_read_length=140,
                      min_read_quality=20, max_read_quality=60, max_N=2)
CORPORA = {
    # the golden corpus shape: short variable reads, lowercase, Ns
    "golden": dict(n=300, min_len=40, max_len=60, n_prob=0.02,
                   lowercase_prob=0.05, seed=77),
    # uniform binned reads: the 2u wire tier under HPGQ_WIRE=bitpack
    "uniform": dict(n=2500, min_len=100, max_len=100, n_prob=0.01,
                    seed=5, qual_bins=(2, 12, 23, 37)),
    # variable unbinned reads over two length buckets
    "varlong": dict(n=1500, min_len=60, max_len=190, n_prob=0.01, seed=6),
}
# long reads past K1's 4096 columns (K2 on the card), unbinned qualities
LONG_CORPUS = dict(n=60, min_len=4500, max_len=9000, n_prob=0.002, seed=8)


def _corpus(tmp_path, name):
    kw = dict(LONG_CORPUS if name == "long" else CORPORA[name])
    path = str(tmp_path / ("%s.fq" % name))
    make_fastq(path, kw.pop("n"), **kw)
    return path


def _normalize(data: bytes, outdir: str) -> bytes:
    """tests/test_golden.py:_normalize — the run's output dir as a
    placeholder, so two runs in two directories compare."""
    return data.replace(os.path.abspath(outdir).encode(),
                        b"<OUTDIR>").replace(outdir.encode(), b"<OUTDIR>")


_MEANQ = re.compile(rb"^Mean quality = (\d+) \[.\]$")


def _same_report(a: bytes, b: bytes, name: str):
    """Byte equality, except that a differing ``Mean quality`` line (f32
    acc_quality, see the module docstring) is compared to 1e-3 relative."""
    if a == b:
        return
    la, lb = a.split(b"\n"), b.split(b"\n")
    assert len(la) == len(lb), name
    for x, y in zip(la, lb):
        if x == y:
            continue
        mx, my = _MEANQ.match(x), _MEANQ.match(y)
        assert mx and my, "%s: %r != %r" % (name, x, y)
        qx, qy = int(mx.group(1)), int(my.group(1))
        assert abs(qx - qy) <= 1e-3 * max(abs(qy), 1), (name, x, y)


def _run_cli(fn, args, outdir, command="stats"):
    os.makedirs(outdir, exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn([command, "-o", outdir] + args)
    assert rc == 0
    return buf.getvalue()


def _inputs(path):
    """CLI input flags of one file or of a ``(mate 1, mate 2)`` pair."""
    if isinstance(path, tuple):
        return ["--fq1", path[0], "--fq2", path[1]]
    return ["-f", path]


def _assert_cli_identical(tmp_path, path, filtered, extra=(),
                          command="stats"):
    """``hpgq`` and ``hpgq_torch --device cpu`` on the same input and flags:
    the same console output and byte-identical output trees (after the
    normalisation above).  Returns the output file names."""
    args = _inputs(path) + ["--log-file", str(tmp_path / "log")] + list(extra)
    args += FILTER_FLAGS if filtered else []
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    out_ref = _run_cli(hpgq_main, args, ref_dir, command)
    out_port = _run_cli(port_main, args + ["--device", "cpu"], port_dir,
                        command)
    assert out_port.replace(port_dir, "<OUTDIR>") == \
        out_ref.replace(ref_dir, "<OUTDIR>")
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as f:
            a = _normalize(f.read(), ref_dir)
        with open(os.path.join(port_dir, name), "rb") as f:
            b = _normalize(f.read(), port_dir)
        if command == "stats":
            _same_report(b, a, name)
        else:
            assert a == b, name
    if command == "stats":
        assert any(n.endswith(".summary.txt") for n in names)
    return names


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filter"])
@pytest.mark.parametrize("wire", ["off", "bitpack"])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_cli_output_identical_to_hpgq(tmp_path, monkeypatch, corpus, wire,
                                      filtered):
    monkeypatch.setenv("HPGQ_WIRE", wire)
    _assert_cli_identical(tmp_path, _corpus(tmp_path, corpus), filtered)


@pytest.mark.parametrize("kind", ["empty", "gzip", "bgzf"])
def test_cli_edge_inputs_identical_to_hpgq(tmp_path, monkeypatch, kind):
    """An empty file, plain gzip (not range-splittable) and BGZF input."""
    from hpgq.io.bgzf import write_bgzf

    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    if kind == "empty":
        path = str(tmp_path / "empty.fq")
        open(path, "wb").close()
    elif kind == "gzip":
        path = str(tmp_path / "in.fq.gz")
        make_fastq(path, 800, min_len=60, max_len=150, n_prob=0.01, seed=3)
    else:
        plain = _corpus(tmp_path, "uniform")
        path = plain + ".bgz"
        with open(plain, "rb") as f:
            write_bgzf(path, f.read())
    _assert_cli_identical(tmp_path, path, filtered=True)


def _oracle(path, crit=None):
    acc = StatsCounters(phred=33)
    n_passed = n_failed = 0
    with FastqReader(path, batch_size=4096) as rd:
        for block in rd:
            codes, quals, lens, valid = pack_block(block)
            ok = valid
            if crit is not None:
                ok = ob.block_verdicts(codes, quals, lens, crit, 33) & valid
                n_passed += int(ok.sum())
                n_failed += int((valid & ~ok).sum())
            acc = acc.merge(ob.block_stats(codes, quals, lens, ok, phred=33))
    acc.num_passed, acc.num_failed = n_passed, n_failed
    acc.filter_on = crit is not None
    return acc


def _api(path, outdir, **kw):
    import hpgq_torch

    return hpgq_torch.stats(
        path, outdir=outdir, device="cpu", report=False,
        read_length_range=(45, 140), read_quality_range=(20, 60), max_N=2,
        **kw)


def test_api_matches_hpgq_api_and_oracle(tmp_path):
    import hpgq

    path = _corpus(tmp_path, "varlong")
    got = _api(path, str(tmp_path))
    ref = hpgq.stats(path, outdir=str(tmp_path / "ref"),
                     read_length_range=(45, 140),
                     read_quality_range=(20, 60), max_N=2)
    assert got.equals(ref)
    assert got.equals(_oracle(path, CRIT))
    assert (got.num_passed, got.num_failed) == (ref.num_passed,
                                                ref.num_failed)


@pytest.mark.parametrize("wire", ["off", "bitpack"])
def test_batch_size_invariance(tmp_path, monkeypatch, wire):
    monkeypatch.setenv("HPGQ_WIRE", wire)
    path = _corpus(tmp_path, "varlong")
    want = _oracle(path, CRIT)
    for bs in (97, 600, 5000):
        got = _api(path, str(tmp_path), batch_size=bs)
        assert got.equals(want), bs
        assert (got.num_passed, got.num_failed) == (want.num_passed,
                                                    want.num_failed)


class _Killed(Exception):
    pass


class _CrashAfter:
    """Stand-in for ``reader`` (the FastqReader of the module it replaces
    one in) that dies after ``n`` blocks (a killed run); its other
    attributes (the port's reader's ``plan``) are the reader's."""

    def __init__(self, n, reader=FastqReader):
        self.n = n
        self.reader = reader

    def __call__(self, *a, **k):
        reader = self.reader(*a, **k)
        n = self.n

        class Wrapped:
            def __enter__(self):
                reader.__enter__()
                return self

            def __exit__(self, *exc):
                return reader.__exit__(*exc)

            def __iter__(self):
                for i, block in enumerate(reader):
                    if i == n:
                        raise _Killed("simulated kill")
                    yield block

            def __getattr__(self, name):
                return getattr(reader, name)

        return Wrapped()


def _ck_run(path, outdir, ck):
    """run_stats with a checkpoint every 2 blocks of 200 reads."""
    from hpgq.api import _common, _criteria
    from hpgq.options import StatsOptions

    opts = _common(StatsOptions(), path, None, outdir, "phred33", 200, ck,
                   False)
    opts.filter_on = _criteria(opts, (45, 140), (20, 60), 2, None, None,
                               None)
    opts.checkpoint_every = 2
    return prun.run_stats(opts, report=False, device="cpu")


def test_checkpoint_resume(tmp_path, monkeypatch):
    """A run killed after its second checkpoint resumes from it and ends
    with the counters of an uninterrupted run; the checkpoint is removed."""
    from hpgq.utils.checkpoint import load_counters_checkpoint

    path = _corpus(tmp_path, "varlong")
    ck = str(tmp_path / "ck.npz")
    want = _api(path, str(tmp_path), batch_size=200)
    monkeypatch.setattr(prun, "FastqReader", _CrashAfter(5, prun.FastqReader))
    with pytest.raises(_Killed):
        _ck_run(path, str(tmp_path), ck)
    with np.load(ck) as z:
        key = json.loads(bytes(z["__meta__"].tobytes()))["config_key"]
    part, offset, _ = load_counters_checkpoint(ck, key)
    assert part.num_passed + part.num_failed == 4 * 200 and offset > 0
    monkeypatch.undo()
    got = _ck_run(path, str(tmp_path), ck)
    assert got.equals(want)
    assert (got.num_passed, got.num_failed) == (want.num_passed,
                                                want.num_failed)
    assert not os.path.exists(ck)


def test_parallel_shards_match_serial(tmp_path, monkeypatch):
    """The shard-reader path (forced on the CPU, more shard threads than
    cores, a short switch interval) merges to the serial result, and the
    shared tier counter loses no update."""
    from hpgq.api import _common, _criteria
    from hpgq.options import StatsOptions
    from hpgq.utils.timers import StageTimers
    from hpgq_torch.kernels import step

    path = _corpus(tmp_path, "varlong")
    want = _api(path, str(tmp_path))
    monkeypatch.setattr(prun, "_PARALLEL_MIN_BYTES", 0)
    monkeypatch.setenv("HPGQ_READ_SHARDS", str(2 * (os.cpu_count() or 4)))
    calls = []
    real = prun._run_stats_parallel
    monkeypatch.setattr(prun, "_run_stats_parallel",
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    opts = _common(StatsOptions(), path, None, str(tmp_path), "phred33", 40,
                   None, False)
    opts.filter_on = _criteria(opts, (45, 140), (20, 60), 2, None, None,
                               None)
    step.WIRE_BATCHES.clear()
    timers = StageTimers()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = prun.run_stats(opts, timers, report=False, device="cpu")
    finally:
        sys.setswitchinterval(interval)
    assert calls == [2 * (os.cpu_count() or 4)]
    assert sum(step.WIRE_BATCHES.values()) == timers.num_batches > 30
    assert got.equals(want)
    assert (got.num_passed, got.num_failed) == (want.num_passed,
                                                want.num_failed)


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_split_byte_ranges_match_jax_package(tmp_path, n):
    from hpgq.dist import mesh

    path = _corpus(tmp_path, "golden")
    assert split_byte_ranges(path, n) == mesh.split_byte_ranges(path, n)
    assert range_splittable(path) and mesh.range_splittable(path)


def test_session_length_growth(tmp_path):
    """Blocks of short reads then long ones: the session rebuilds its
    accumulator wider and the counters carry over (== oracle)."""
    short = str(tmp_path / "s.fq")
    make_fastq(short, 400, min_len=50, max_len=90, seed=31)
    long_ = str(tmp_path / "l.fq")
    make_fastq(long_, 400, min_len=200, max_len=300, seed=32)
    sess = StatsSession(33, batch_reads=512, device="cpu", wire="bitpack")
    want = StatsCounters(phred=33)
    for p in (short, long_):
        with FastqReader(p, batch_size=150) as rd:
            for block in rd:
                sess.feed_packed(*to_device(sess.pack(block), sess.device))
        want.merge(_oracle(p))
    assert sess.lcap == 384
    got = sess.finish()
    assert got.equals(want)


def test_resolve_wire_precedence(monkeypatch):
    monkeypatch.delenv("HPGQ_WIRE", raising=False)
    assert resolve_wire("auto", "cpu") is None
    assert resolve_wire(None, "cuda") == "bitpack"
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    assert resolve_wire(None, "cpu") == "bitpack"
    assert resolve_wire("off", "cpu") is None  # explicit beats the env
    monkeypatch.setenv("HPGQ_WIRE", "off")
    assert resolve_wire("auto", "cuda") is None
    with pytest.raises(ValueError, match="fused4"):
        resolve_wire("fused4", "cuda")


_NO_JAX_RUN = r"""
import ast, importlib, os, pkgutil, sys

repo, path, outdir = sys.argv[1:4]
sys.path[:0] = [repo, os.path.join(repo, "tests")]
import chip_smoke

for name in chip_smoke.BLOCKED:  # any import of jax or hpgq now raises
    sys.modules[name] = None
os.environ.update(HPGQ_CHARTS="off", HPGQ_WIRE="bitpack")

import gen, hpgq_torch
from hpgq_torch.oracle import assert_counters_equal, reference_stats


def imported(py):
    # every module a file names, at any depth: import statements, also
    # inside functions, and import_module / __import__ of a literal
    with open(py) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


sources = [os.path.join(repo, f) for f in ("chip_smoke.py",
                                          "tools/fuzz_torch.py",
                                          "tools/ab_torch.py")]
for root, _, files in os.walk(os.path.join(repo, "hpgq_torch")):
    sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
named = {(os.path.relpath(py, repo), m) for py in sources
         for m in imported(py) if m.split(".")[0] in chip_smoke.BLOCKED}
assert not named, sorted(named)
assert len(sources) > 20, sources
names = {m.name for m in pkgutil.walk_packages(hpgq_torch.__path__,
                                               "hpgq_torch.")
         if not m.name.endswith("__main__")}
for name in sorted(names):
    importlib.import_module(name)
records = gen.make_fastq(path, 3000, min_len=100, max_len=100, n_prob=0.01,
                         seed=9, qual_bins=(2, 12, 23, 37))
got = hpgq_torch.stats(path, outdir=outdir, device="cpu",
                       **chip_smoke.BENCH_FILTER)
assert_counters_equal(got, reference_stats(records, **chip_smoke.BENCH_FILTER),
                      "no-jax run")
assert 0 < got.num_passed < 3000
from hpgq_torch.kernels import step
assert step.WIRE_BATCHES.get("2u"), step.WIRE_BATCHES
# chip_smoke's long-read check (phase 8), small: k-mers and the long filter
lpath = os.path.join(outdir, "long.fq")
lrec = chip_smoke.long_read_corpus(lpath, n=30, n_huge=2,
                                   lengths=(2000, 6000), huge=(8000, 9000))
runs = chip_smoke.long_read_runs(lpath, lrec, outdir, "cpu")
assert runs["kmers"][0].kmer_counts.sum() > 0
assert runs["kmers"][0].max_length > 8000, runs["kmers"][0].max_length
# phase 9 small: paired stats against the paired reference, both on 2u
m2 = os.path.join(outdir, "m2.fq")
rec2 = gen.make_fastq(m2, 3000, min_len=100, max_len=100, n_prob=0.01,
                      seed=10, qual_bins=(2, 12, 23, 37))
pruns = chip_smoke.paired_runs(path, records, m2, rec2, outdir, "cpu")
for run, (pair, n, tiers, _) in pruns.items():  # no launch on the CPU
    assert set(tiers) == {"2u"} and not any(n.values()), (run, tiers, n)
assert pruns["filter"][0][0].num_passed > 0
# phase 10 small: every filter output equals the reference's selection
lkw = dict(read_length_range=(3000, 100000), read_quality_range=(10, 60),
           max_N=20)
fruns = chip_smoke.filter_runs(
    [("single-end", (path,), (records,), chip_smoke.BENCH_FILTER),
     ("paired", (path, m2), (records, rec2), chip_smoke.BENCH_FILTER),
     ("long reads", (lpath,), (lrec,), lkw)], outdir, "cpu")
tiers = {label: set(b) for label, (_, b, _) in fruns.items()}
assert tiers == {"single-end": {("cpu", "2c")}, "paired": {("cpu", "2c")},
                 "long reads": {("cpu", "qn8")}}, tiers
assert 0 < fruns["long reads"][0]["num_passed"] < len(lrec)
# phase 11 small: edit and prepro outputs equal the reference's, then
# stats over the trimmed edit.fq equals the reference over the kept reads
eruns = chip_smoke.edit_runs(
    [("trim only", "edit", (path,), (records,), chip_smoke.EDIT_TRIM),
     ("golden settings", "edit", (path,), (records,), chip_smoke.EDIT_GOLDEN),
     ("paired", "edit", (path, m2), (records, rec2), chip_smoke.EDIT_GOLDEN),
     ("prepro", "prepro", (path,), (records,), chip_smoke.PREPRO),
     ("long reads", "edit", (lpath,), (lrec,),
      dict(chip_smoke.LONG_EDIT, **lkw))], outdir, "cpu")
for label, (res, batches, _, _, _) in eruns.items():
    assert batches and {d for d, _ in batches} == {"cpu"}, (label, batches)
    assert res["num_edited"] > 0, label
for label in ("golden settings", "paired", "long reads"):
    assert eruns[label][0]["num_passed"] > 0, label
    assert eruns[label][0]["num_failed"] > 0, label
for label, recs in (("trim only", records), ("long reads", lrec)):
    res, _, _, trims, sel = eruns[label]
    got, _ = chip_smoke.edit_then_stats(res, recs, trims[0], sel, outdir,
                                        "cpu")
    assert got.num_reads == int(sel.sum()), label
# phase 12 small: tables, PGMs and .gs equal the reference's, paired too;
# the self-diff is zero; the direct checks at k=10 and the poly-A case
from hpgq_torch.pipeline import cgr_run
gs = {}
for label, paths, recs in (("single-end", (path,), (records,)),
                           ("paired", (path, m2), (records, rec2))):
    cgr_run.BATCHES.clear()
    res = hpgq_torch.cgr(*paths, outdir=os.path.join(outdir, label), k=7,
                         write_gs=True, device="cpu")
    assert chip_smoke.cgr_check(res, recs, 7, outdir, label) > 0
    assert {d for d, _ in cgr_run.BATCHES} == {"cpu"}, cgr_run.BATCHES
    gs[label] = res["gs_file"]
chip_smoke.cgr_self_diff(path, gs["single-end"], 7,
                         os.path.join(outdir, "self"), "cpu")
cells = chip_smoke.cgr_direct_checks("cpu", n_overflow=4)
assert max(cells.values()) == 4 * 4095 * 186, cells
# phase 8's window run and phase 9's paired long reads, small
assert 0 < runs["window"][0].num_passed < len(lrec)
got, _, tiers = chip_smoke.paired_long_run(
    *chip_smoke.long_pairs(outdir, n=20, n_huge=2), outdir, "cpu")
assert 0 < got[0].num_passed < 22 and sum(tiers.values()) == 2, tiers
# phase 13 small: sharded stats at world size 1 (no group, then launched),
# the legacy --qc --filter run, and two ranks over gloo (the port's
# launcher)
_, _, res = chip_smoke.sharded_world1(path, records,
                                      os.path.join(outdir, "w1"), "cpu",
                                      outdir)
assert res["world"] == 1, res
assert chip_smoke.legacy_qc_filter(path, records,
                                   os.path.join(outdir, "legacy"),
                                   "cpu")[0] > 0
res2 = chip_smoke.sharded_ranks(((path, records), (m2, rec2),
                                 (lpath, lrec)),
                                os.path.join(outdir, "w2"), "cpu", outdir)
assert len(res2) == 7, sorted(res2)
# and the launcher's own paths: one launched rank, the CLI with no
# launcher variables, a rank that raises
one = chip_smoke.launched_world1(path, records, os.path.join(outdir, "w1l"),
                                 "cpu", outdir)
assert chip_smoke.startup_s(one["stats"]) > 0, one
said, _ = chip_smoke.cli_sharded(path, records, os.path.join(outdir, "cli"),
                                 "cpu")
assert chip_smoke.start_failing_rank(outdir, ["cpu", "cpu"])() < 60
# phase 14 small: gzip and BGZF input, cgr over gzip, filter over BGZF, the
# coalesced run and the profiled runs; phase 15 small: fuzz rounds
iruns = chip_smoke.input_runs(path, records, outdir, "cpu",
                              n_coalesced=25000)
assert iruns["coalesced stats"][2] == (3, 1), iruns["coalesced stats"]
assert iruns["stats, profiled"][2]["all"] > 0, iruns["stats, profiled"]
fz = chip_smoke.fuzz_rounds("cpu", rounds=4, seed=chip_smoke.FUZZ_SEED,
                            max_n=800)
assert sorted(c["cmd"] for c, _, _ in fz) == ["cgr", "edit", "filter",
                                              "stats"]
import fuzz_torch, ab_torch
print("ok", len(names))
"""



def test_imports_load_no_jax(tmp_path):
    """No file of the port and not chip_smoke.py names a module of jax or
    ``hpgq`` anywhere (also inside functions, where no run may reach). With
    every import of jax and of ``hpgq`` made to fail, as chip_smoke.py
    makes them: every module of the port loads, and
    chip_smoke's end-to-end check (the bench filter over 2u-wire batches,
    held against ``hpgq_torch.oracle``), its long-read check (k-mers and
    a long-read filter), its paired-stats check (phase 9), its filter
    check (phase 10), its edit and prepro checks (phase 11), its CGR
    checks (phase 12), the long-read window run and paired long reads
    (phases 8-9) and its ``--sharded`` and legacy CLI checks (phase 13:
    world size 1 with and without the launcher's variables, two ranks
    over gloo and one started by ``hpgq_torch.dist.launch``, ``stats
    --sharded`` through the CLI, a rank that raises), its gzip, BGZF, coalesced and profiled runs (phase 14)
    and fuzz rounds (phase 15) run small on the CPU; ``tools/fuzz_torch.py``
    and ``tools/ab_torch.py`` are walked and loaded too."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, REPO, str(tmp_path / "in.fq"),
         str(tmp_path)], capture_output=True, text=True, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr
    ok, n = out.stdout.strip().splitlines()[-1].split()
    assert ok == "ok" and int(n) > 20


def test_cuda_request_raises_here(tmp_path, capsys):
    """Without a GPU, asking for cuda raises (API) or exits
    non-zero with an error (CLI, before printing anything); it never runs
    on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(DeviceUnavailable):
        resolve_device("cuda")
    path = _corpus(tmp_path, "golden")
    import hpgq_torch

    with pytest.raises(DeviceUnavailable):
        hpgq_torch.stats(path, outdir=str(tmp_path))
    rc = port_main(["stats", "-f", path, "-o", str(tmp_path)])
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out == ""
    assert "CUDA is not available" in captured.err
    assert not any(n.endswith(".summary.txt") for n in os.listdir(tmp_path))


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filter"])
@pytest.mark.parametrize("corpus", ["varlong", "long"])
def test_cli_kmers_output_identical_to_hpgq(tmp_path, monkeypatch, corpus,
                                            filtered):
    """``--kmers`` on short reads (K1's contract) and on long reads (K2's):
    the summary and every k-mer report byte-identical to ``hpgq``'s.  The
    long corpus runs with a small --batch-size so that ``hpgq`` on the CPU
    stays small; results do not depend on it."""
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    path = _corpus(tmp_path, corpus)
    extra = ["--kmers"]
    if corpus == "long":
        extra += ["--batch-size", "24"]
        if filtered:  # a long-read filter that passes some reads
            extra += ["--read-length-range", "5000,8500",
                      "--read-quality-range", "15,60", "--max-N", "20"]
    elif filtered:
        extra += FILTER_FLAGS
    _assert_cli_identical(tmp_path, path, False, extra)
    names = os.listdir(tmp_path / "port")
    for suffix in (".kmers.txt", ".kmers.per.nt.data", ".summary.txt"):
        assert any(n.endswith(suffix) for n in names), suffix


def test_long_read_block_packs_few_rows(tmp_path):
    """A block of 40 reads of 5-12 kb (the K2 path) packs to at most 64
    rows, not to a 16,384-row bucket: on the bitpack wire as one ragged
    wire of a row a read, each at its own length, and on the plain wire
    as its length classes (5-8 kb and 8-12 kb), each at its own width;
    the counters still equal ``hpgq``'s and the oracle's."""
    import hpgq

    path = str(tmp_path / "long.fq")
    make_fastq(path, 40, min_len=5000, max_len=12000, n_prob=0.002, seed=12)
    sess = StatsSession(33, batch_reads=10240, device="cpu", wire="bitpack")
    with FastqReader(path, batch_size=10000) as rd:
        blocks = list(rd)
    assert len(blocks) == 1
    tag, buf, rows, L = sess.pack(blocks[0])[0]
    assert tag == "ragged" and rows == 40 <= 64
    assert L == blocks[0].max_len()
    # 9 bits a base, with the table and each read's last group
    assert buf.nbytes < 1.2 * int(blocks[0].seq_lens.sum())
    tag, *parts = StatsSession(33, batch_reads=10240, device="cpu",
                               wire="off").pack(blocks[0])[0]
    lens = np.sort(blocks[0].seq_lens)[::-1]
    wide = int((lens > 8192).sum())
    assert [p[0].shape for p in parts] == [
        (-(-wide // 8) * 8, -(-int(lens[0]) // 128) * 128),
        (-(-(40 - wide) // 8) * 8, -(-int(lens[wide]) // 128) * 128)]
    got = _api(path, str(tmp_path))
    ref = hpgq.stats(path, outdir=str(tmp_path / "ref"), batch_size=40,
                     read_length_range=(45, 140),
                     read_quality_range=(20, 60), max_N=2)
    assert got.equals(ref)
    assert got.equals(_oracle(path, CRIT))
    want = hpgq.stats(path, outdir=str(tmp_path / "ref"), batch_size=40,
                      report=False)
    import hpgq_torch

    assert hpgq_torch.stats(path, outdir=str(tmp_path), device="cpu",
                            report=False).equals(want)


@pytest.mark.parametrize("wire", ["off", "bitpack"])
def test_short_read_batches_keep_bucket_rows(tmp_path, monkeypatch, wire):
    """The main path (lcap <= 4096) still pads to hpgq's 16,384-row
    buckets: the 2u and plain batches keep their shapes."""
    from hpgq.io.packer import bucket_rows

    monkeypatch.setenv("HPGQ_WIRE", wire)
    path = _corpus(tmp_path, "uniform")
    sess = StatsSession(33, batch_reads=131072, device="cpu")
    with FastqReader(path, batch_size=100000) as rd:
        block = next(iter(rd))
    packed = sess.pack(block)
    rows = bucket_rows(block.num_reads, 131072)
    assert rows == 16384
    if wire == "bitpack":
        assert packed[0][0] == "2u"
        assert packed[0][1].shape[0] == rows
    else:
        assert packed[0].shape == (rows, 128)


# ------------------------------------------------------------ paired stats

BINS = (2, 12, 23, 37)
PAIRED_MATES = {
    # both mates on the 2u tier (under HPGQ_WIRE=bitpack), 100 and 96 bp
    "2u+2u": (dict(n=900, min_len=100, max_len=100, n_prob=0.01, seed=41,
                   qual_bins=BINS),
              dict(n=900, min_len=96, max_len=96, n_prob=0.01, seed=42,
                   qual_bins=BINS)),
    # mate 1 on 2u, mate 2 variable and unbinned over two length buckets
    "2u+varlen": (dict(n=900, min_len=100, max_len=100, n_prob=0.01,
                       seed=43, qual_bins=BINS),
                  dict(n=900, min_len=60, max_len=190, n_prob=0.01,
                       seed=44)),
}


def _pair(tmp_path, name):
    out = []
    for i, kw in enumerate(PAIRED_MATES[name], 1):
        kw = dict(kw)
        out.append(str(tmp_path / ("m%d.fq" % i)))
        make_fastq(out[-1], kw.pop("n"), **kw)
    return tuple(out)


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filter"])
@pytest.mark.parametrize("wire", ["off", "bitpack"])
@pytest.mark.parametrize("mates", list(PAIRED_MATES))
def test_paired_cli_output_identical_to_hpgq(tmp_path, monkeypatch, mates,
                                             wire, filtered):
    """Paired ``stats``: the console and both mates' report sets
    byte-identical to ``hpgq``'s; the mates may ride different tiers."""
    from hpgq_torch.kernels import step

    monkeypatch.setenv("HPGQ_WIRE", wire)
    step.WIRE_BATCHES.clear()
    names = _assert_cli_identical(tmp_path, _pair(tmp_path, mates), filtered)
    for m in ("m1.fq", "m2.fq"):
        assert m + ".summary.txt" in names
    tiers = set(step.WIRE_BATCHES)
    if wire == "off":
        assert tiers == {"plain"}
    elif mates == "2u+2u":
        assert tiers == {"2u"}
    else:
        assert "2u" in tiers and len(tiers) > 1


def test_paired_cli_kmers_identical_to_hpgq(tmp_path, monkeypatch):
    """Paired ``--kmers`` with the filter: every k-mer report of both mates
    byte-identical to ``hpgq``'s (the k-mers ride on the pair selection)."""
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    names = _assert_cli_identical(tmp_path, _pair(tmp_path, "2u+varlen"),
                                  True, ["--kmers"])
    for m in ("m1.fq", "m2.fq"):
        assert m + ".kmers.txt" in names


def _paired_api(p1, p2, **kw):
    import hpgq_torch

    kw = dict(dict(read_length_range=(45, 140), read_quality_range=(15, 60),
                   max_N=2), **kw)
    return hpgq_torch.stats(p1, p2, outdir=os.path.dirname(p1),
                            device="cpu", report=False, **kw)


def test_paired_blocks_reslice_on_uneven_chunks(tmp_path, monkeypatch):
    """Mate files with different byte layouts give the readers blocks of
    different sizes (tiny chunks forced); the pairs re-slice to common
    record ranges: paired stats equal ``hpgq``'s, and paired filter
    outputs pair up line for line (``tests/test_cli.py:247``)."""
    import hpgq
    import hpgq_torch
    import hpgq_torch.io.fastq as fastq_mod
    from gen import make_records, write_fastq

    n = 400
    r1 = make_records(n, min_len=60, max_len=60, seed=1)
    r2 = [(b"@mate2_" + b"x" * 60 + b"_%d" % i, s, q)
          for i, (_, s, q) in enumerate(make_records(n, min_len=90,
                                                     max_len=90, seed=2))]
    f1, f2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    write_fastq(f1, r1)
    write_fastq(f2, r2)
    monkeypatch.setattr(fastq_mod, "_CHUNK", 4096)
    got = _paired_api(f1, f2, batch_size=64)
    want = hpgq.stats(f1, f2, outdir=str(tmp_path / "ref"), batch_size=64,
                      read_length_range=(45, 140),
                      read_quality_range=(15, 60), max_N=2)
    for g, w in zip(got, want):
        assert g.equals(w)
    assert got[0].num_passed + got[0].num_failed == n
    res = hpgq_torch.filter_reads(f1, f2, outdir=str(tmp_path / "out"),
                                  batch_size=64, read_quality_range=(15, 45),
                                  device="cpu")
    assert res["num_passed"] + res["num_failed"] == n
    for kind in ("passed", "failed"):
        counts = []
        for m in (1, 2):
            with open(res["%s_%d" % (kind, m)], "rb") as f:
                counts.append(f.read().count(b"\n") // 4)
        assert counts[0] == counts[1] == res["num_" + kind]


def test_paired_mismatched_record_counts_raise(tmp_path):
    p1, _ = _pair(tmp_path, "2u+2u")
    short = str(tmp_path / "short.fq")
    make_fastq(short, 899, min_len=96, max_len=96, seed=42)
    with pytest.raises(ValueError, match="mismatched record counts"):
        _paired_api(p1, short)


def _paired_ck_opts(p1, p2, ck):
    """Paired stats options with a checkpoint every 2 pair batches of 200."""
    from hpgq.api import _common, _criteria
    from hpgq.options import StatsOptions

    opts = _common(StatsOptions(), p1, p2, os.path.dirname(p1), "phred33",
                   200, ck, False)
    opts.filter_on = _criteria(opts, (45, 140), (15, 60), 2, None, None,
                               None)
    opts.checkpoint_every = 2
    return opts


def test_paired_checkpoint_resume(tmp_path, monkeypatch):
    """A paired run killed after its second checkpoint resumes from it and
    ends with both mates' counters of an uninterrupted run.  The
    checkpoint carries ``hpgq``'s key, so ``hpgq`` would resume it too."""
    from hpgq.pipeline.run import _stats_config_key
    from hpgq.utils.checkpoint import load_counters_checkpoint

    p1, p2 = _pair(tmp_path, "2u+varlen")
    ck = str(tmp_path / "ck.npz")
    want = _paired_api(p1, p2, batch_size=200)
    opts = _paired_ck_opts(p1, p2, ck)
    monkeypatch.setattr(prun, "FastqReader", _CrashAfter(4, prun.FastqReader))
    with pytest.raises(_Killed):
        prun.run_stats(opts, report=False, device="cpu")
    monkeypatch.undo()
    key = _stats_config_key(opts, opts.criteria) + "|paired:%s" \
        % os.path.abspath(p2)
    part, offset, extra = load_counters_checkpoint(ck, key)
    assert part.num_passed + part.num_failed == 4 * 200 and offset > 0
    assert int(extra["offset2"]) > 0
    got = prun.run_stats(_paired_ck_opts(p1, p2, ck), report=False,
                         device="cpu")
    for g, w in zip(got, want):
        assert g.equals(w)
    assert not os.path.exists(ck)


def test_paired_parallel_shards_match_serial(tmp_path, monkeypatch):
    """Paired stats over 3 shard pairs (forced on the CPU) merge to the
    serial counters of both mates."""
    p1, p2 = _pair(tmp_path, "2u+varlen")
    want = _paired_api(p1, p2, batch_size=100)
    monkeypatch.setattr(prun, "_PARALLEL_MIN_BYTES", 0)
    monkeypatch.setenv("HPGQ_READ_SHARDS", "3")
    calls = []
    real = prun._run_stats_parallel_paired
    monkeypatch.setattr(prun, "_run_stats_parallel_paired",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _paired_api(p1, p2, batch_size=100)
    assert calls == [1]
    for g, w in zip(got, want):
        assert g.equals(w)


def test_parallel_eligibility_checks_both_mates(tmp_path, monkeypatch):
    """Shard readers need byte-seekable input: a plain-gzip mate 2 keeps a
    paired run serial even when mate 1 could be split (the port used to
    look at mate 1 only)."""
    from hpgq.options import StatsOptions

    monkeypatch.setattr(prun, "_PARALLEL_MIN_BYTES", 0)
    monkeypatch.setenv("HPGQ_READ_SHARDS", "3")
    p1, _ = _pair(tmp_path, "2u+2u")
    gz = str(tmp_path / "m2.fq.gz")
    make_fastq(gz, 900, min_len=96, max_len=96, seed=42)
    opts = StatsOptions(in_filename=p1)
    cpu = torch.device("cpu")
    assert prun._output_parallel_eligible(opts, cpu)
    opts.in_filename2 = gz
    assert not prun._output_parallel_eligible(opts, cpu)
    opts.in_filename2 = str(tmp_path / "missing.fq")
    assert not prun._output_parallel_eligible(opts, cpu)
