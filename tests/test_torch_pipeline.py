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


def _corpus(tmp_path, name):
    kw = dict(CORPORA[name])
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


def _run_cli(fn, args, outdir):
    os.makedirs(outdir, exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(["stats", "-o", outdir] + args)
    assert rc == 0
    return buf.getvalue()


def _assert_cli_identical(tmp_path, path, filtered):
    args = ["-f", path, "--log-file", str(tmp_path / "log")]
    args += FILTER_FLAGS if filtered else []
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    out_ref = _run_cli(hpgq_main, args, ref_dir)
    out_port = _run_cli(port_main, args + ["--device", "cpu"], port_dir)
    assert out_port.replace(port_dir, "<OUTDIR>") == \
        out_ref.replace(ref_dir, "<OUTDIR>")
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names
    assert any(n.endswith(".summary.txt") for n in names)
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as f:
            a = _normalize(f.read(), ref_dir)
        with open(os.path.join(port_dir, name), "rb") as f:
            b = _normalize(f.read(), port_dir)
        _same_report(b, a, name)


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
    """FastqReader stand-in that dies after ``n`` blocks (a killed run)."""

    def __init__(self, n):
        self.n = n

    def __call__(self, *a, **k):
        reader = FastqReader(*a, **k)
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
    monkeypatch.setattr(prun, "FastqReader", _CrashAfter(5))
    with pytest.raises(_Killed):
        _ck_run(path, str(tmp_path), ck)
    with np.load(ck) as z:
        key = json.loads(bytes(z["__meta__"].tobytes()))["config_key"]
    part, offset, _ = load_counters_checkpoint(ck, key)
    assert part.num_passed + part.num_failed == 4 * 200 and offset > 0
    monkeypatch.setattr(prun, "FastqReader", FastqReader)
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


def test_cuda_lcap_over_k1_limit_raises():
    with pytest.raises(NotImplementedError, match="K2"):
        StatsSession(33, device="cuda", lcap=4224)


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
for name in ("jax", "jaxlib"):  # any import of jax now raises
    sys.modules[name] = None
sys.path[:0] = [repo, os.path.join(repo, "tests")]
os.environ.update(HPGQ_CHARTS="off", HPGQ_WIRE="bitpack")

import chip_smoke, gen, hpgq_torch
from hpgq_torch.oracle import assert_counters_equal, reference_stats


def hpgq_imports(py):
    with open(py) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Import):
            yield from (a.name for a in node.names)


direct = {m for m in hpgq_imports(os.path.join(repo, "chip_smoke.py"))
          if m.split(".")[0] == "hpgq"}
assert not direct, direct
names = {m.name for m in pkgutil.walk_packages(hpgq_torch.__path__,
                                               "hpgq_torch.")
         if not m.name.endswith("__main__")}
for root, _, files in os.walk(os.path.join(repo, "hpgq_torch")):
    for f in files:
        if f.endswith(".py"):
            names |= {m for m in hpgq_imports(os.path.join(root, f))
                      if m.split(".")[0] == "hpgq"}
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
print("ok", len(names))
"""


def test_imports_load_no_jax(tmp_path):
    """With every import of jax made to fail: chip_smoke.py imports nothing
    of ``hpgq`` directly; every module of the port and every ``hpgq``
    module the port imports anywhere (also inside functions) loads; and
    chip_smoke's end-to-end check (the bench filter over 2u-wire batches,
    held against ``hpgq_torch.oracle``) runs on the CPU."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, REPO, str(tmp_path / "in.fq"),
         str(tmp_path)], capture_output=True, text=True, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr
    ok, n = out.stdout.split()
    assert ok == "ok" and int(n) > 20


def test_breakdown_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """``python -m hpgq_torch.breakdown`` at a small size: every arm and
    stage reports, and the arms restore the environment."""
    from hpgq_torch import breakdown

    monkeypatch.delenv("HPGQ_WIRE", raising=False)
    monkeypatch.delenv("HPGQ_READ_SHARDS", raising=False)
    path = _corpus(tmp_path, "uniform")
    assert breakdown.main([path, "--device", "cpu", "--turns", "2"]) == 0
    text = capsys.readouterr().out
    for label, _ in breakdown.ARMS:
        assert re.search(r"^e2e %s +passes \S+ \S+ s; best \d+ reads/s"
                         % re.escape(label), text, re.M), label
    for stage in ("read + newline index:", "pack (wire None):",
                  "pin + copy to cpu:", "device steps"):
        assert stage in text
    assert "HPGQ_WIRE" not in os.environ
    assert "HPGQ_READ_SHARDS" not in os.environ


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


@pytest.mark.parametrize("command", ["filter", "edit", "prepro", "cgr"])
def test_unported_commands_exit_nonzero(tmp_path, capsys, command):
    path = _corpus(tmp_path, "golden")
    rc = port_main([command, "-f", path, "-o", str(tmp_path)])
    assert rc != 0
    assert "not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("kw,what", [
    (dict(kmers=True), "--kmers"),
    (dict(in_path2="mate2.fq"), "paired-end"),
    (dict(sharded=True), "--sharded"),
], ids=["kmers", "paired", "sharded"])
def test_unported_options_raise(tmp_path, kw, what):
    path = _corpus(tmp_path, "golden")
    if "in_path2" in kw:
        kw = dict(in_path2=path)
    import hpgq_torch

    with pytest.raises(NotImplementedError, match=what):
        hpgq_torch.stats(path, outdir=str(tmp_path), device="cpu", **kw)
