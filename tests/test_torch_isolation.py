"""The port stands alone: it imports nothing of ``hpgq``, and its copies of
``hpgq``'s host modules behave as the originals do.

* With ``jax``, ``jaxlib`` and ``hpgq`` blocked in ``sys.modules`` (as
  ``chip_smoke.py`` blocks them), a subprocess imports every module of
  ``hpgq_torch`` and runs the port's ``stats`` (CLI and API),
  ``filter_reads``, and the ``edit``, ``prepro`` and ``cgr`` CLI commands
  on the CPU over the corpora of ``tests/test_golden.py``; the files they
  write equal ``hpgq``'s frozen outputs in ``tests/golden/``.
* The port's packer and ``hpgq``'s give byte-identical buffers and
  sidecars on every wire tier, over the same blocks.
* The port's report writer and ``hpgq``'s write byte-identical files from
  the same counters.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gen import make_fastq

import hpgq.io.fastq as h_fastq
import hpgq.io.packer as h_packer
import hpgq.report.stats_report as h_report
import hpgq_torch.io.fastq as t_fastq
import hpgq_torch.io.packer as t_packer
import hpgq_torch.report.stats_report as t_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
GOLDEN_CORPUS = dict(min_len=40, max_len=60, n_prob=0.02,
                     lowercase_prob=0.05, seed=77)  # tests/test_golden.py

_ISOLATED_RUN = r"""
import json, os, pkgutil, importlib, sys

repo, path = sys.argv[1:3]
outs, corpora = json.loads(sys.argv[3]), json.loads(sys.argv[4])
out_stats, out_filter = outs["stats"], outs["filter"]
sys.path[:0] = [repo, os.path.join(repo, "tests")]
import chip_smoke

for name in chip_smoke.BLOCKED:
    sys.modules[name] = None
import hpgq_torch

names = sorted(m.name for m in pkgutil.walk_packages(hpgq_torch.__path__,
                                                     "hpgq_torch.")
               if not m.name.endswith("__main__"))
for name in names:
    importlib.import_module(name)
from hpgq_torch.cli.main import main

# the CLI writes the options into the summary, as the golden run did
assert main(["stats", "-f", path, "-o", out_stats, "--kmers",
             "--read-length-range", "45,58", "--max-N", "3",
             "--device", "cpu"]) == 0
c = hpgq_torch.stats(path, outdir=out_stats, kmers=True,
                     read_length_range=(45, 58), max_N=3, report=False,
                     device="cpu")
hpgq_torch.filter_reads(path, outdir=out_filter, read_quality_range=(20, 40),
                        max_N=2, device="cpu")
# the CLI flows of tests/test_golden.py:97-141
for name, argv in (
        ("edit", ["edit", "-f", path, "--left-length", "8",
                  "--left-quality-range", "28,60", "--right-length", "6",
                  "--right-quality-range", "28,60", "--read-quality-range",
                  "20,45"]),
        ("prepro", ["prepro", "-f", path, "--ltrim-nts", "5", "--rtrim-nts",
                    "3", "--min-quality", "27", "--max-quality", "64"]),
        ("cgr", ["cgr", "-f", corpora["cgr"], "--k", "5"]),
        ("cgr_gs", ["cgr", "-f", corpora["cgr_gs"], "--k", "5",
                    "--write-gs"]),
        ("cgr_diff", ["cgr", "-f", corpora["cgr_diff"], "--k", "5",
                      "--gs-filename",
                      os.path.join(outs["cgr_gs"], "ga.fq_k=5.gs")])):
    assert main(argv + ["-o", outs[name], "--device", "cpu"]) == 0, argv
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in chip_smoke.BLOCKED
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok", len(names), c.num_passed, c.num_failed)
"""


def _normalize(data: bytes, outdir: str) -> bytes:
    """tests/test_golden.py:_normalize."""
    return data.replace(os.path.abspath(outdir).encode(),
                        b"<OUTDIR>").replace(outdir.encode(), b"<OUTDIR>")


def _same_tree(outdir: str, want_dir: str, normalize: bool = True):
    got, want = sorted(os.listdir(outdir)), sorted(os.listdir(want_dir))
    assert got == want
    for name in want:
        with open(os.path.join(outdir, name), "rb") as f:
            g = f.read()
        with open(os.path.join(want_dir, name), "rb") as f:
            w = f.read()
        if normalize:
            g = _normalize(g, outdir)
        assert g == w, name


@pytest.fixture(scope="module")
def isolated_run(tmp_path_factory):
    """The port's stats and filter outputs, written by a process that
    cannot import jax or hpgq."""
    tmp = tmp_path_factory.mktemp("isolated")
    path = str(tmp / "in.fq")
    make_fastq(path, 300, **GOLDEN_CORPUS)
    corpora = {}
    for sub, name, seed in (("cgr", "cg.fq", 78), ("cgr_gs", "ga.fq", 79),
                            ("cgr_diff", "gb.fq", 80)):
        corpora[sub] = str(tmp / name)
        make_fastq(corpora[sub], 300, **dict(GOLDEN_CORPUS, seed=seed))
    outs = {k: str(tmp / k) for k in COMMANDS}
    for d in outs.values():
        os.makedirs(d)
    env = dict(os.environ, HPGQ_CHARTS="off")
    res = subprocess.run(
        [sys.executable, "-c", _ISOLATED_RUN, REPO, path, json.dumps(outs),
         json.dumps(corpora)], capture_output=True, text=True, cwd=str(tmp),
        env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    ok, n, passed, failed = res.stdout.split()[-4:]
    assert ok == "ok" and int(n) > 20
    # the API's counters: tests/golden/stats/in.fq.summary.txt processes
    # 190 of the 300 reads
    assert (int(passed), int(failed)) == (190, 110)
    return outs


COMMANDS = ("stats", "filter", "edit", "prepro", "cgr", "cgr_gs",
            "cgr_diff")


@pytest.mark.parametrize("command", COMMANDS)
def test_isolated_port_writes_golden_outputs(isolated_run, command):
    _same_tree(isolated_run[command], os.path.join(GOLDEN, command))


# ---------------------------------------------------------------- packers

def _blocks(tmp_path, fastq_mod, binned: bool, uniform: bool):
    path = str(tmp_path / ("b%d_u%d.fq" % (binned, uniform)))
    if not os.path.exists(path):
        make_fastq(path, 700, min_len=100 if uniform else 37, max_len=100,
                   n_prob=0.01, seed=31,
                   qual_bins=(2, 12, 23, 37) if binned else None)
    with fastq_mod.FastqReader(path, batch_size=300) as rd:
        return list(rd)


TIERS = {  # tier: (binned corpus, uniform lengths, pack(packer, block))
    "2u": (True, True,
           lambda pk, b: pk.try_pack_block_2u(b, pad_reads_to=512)),
    "2c": (True, False,
           lambda pk, b: pk.pack_block_bitwire_tier(b, 104, -1,
                                                    pad_reads_to=512)),
    "2q": (True, False,
           lambda pk, b: pk.pack_block_bitwire_tier(b, 104, 0,
                                                    pad_reads_to=512)),
    "6bit": (False, False,
             lambda pk, b: pk.pack_block_bitwire_tier(b, 104, 1,
                                                      pad_reads_to=512)),
    "7bit": (False, False,
             lambda pk, b: pk.pack_block_bitwire_tier(b, 104, 2,
                                                      pad_reads_to=512)),
    "plain": (False, False,
              lambda pk, b: pk.pack_block(b, max_len=128, pad_reads_to=512)),
    "qn8": (False, False,
            lambda pk, b: pk.pack_block_qnwire(b, 104, pad_reads_to=512)),
}


def _flat(x):
    if isinstance(x, tuple):
        for a in x:
            yield from _flat(a)
    else:
        yield x


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_packers_byte_identical(tmp_path, tier):
    """The same blocks through ``hpgq.io.packer`` and the port's copy: the
    same buffers, sidecars and side values, byte for byte."""
    binned, uniform, pack = TIERS[tier]
    hb = _blocks(tmp_path, h_fastq, binned, uniform)
    tb = _blocks(tmp_path, t_fastq, binned, uniform)
    assert len(hb) == len(tb) > 1
    for h, t in zip(hb, tb):
        want, got = pack(h_packer, h), pack(t_packer, t)
        assert want is not None, tier  # the corpus fits the tier
        w, g = list(_flat(want)), list(_flat(got))
        assert len(w) == len(g)
        for a, b in zip(w, g):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
            else:
                assert a == b


# ---------------------------------------------------------------- reports

@pytest.mark.parametrize("kmers", [False, True])
def test_report_writers_byte_identical(tmp_path, kmers):
    """``hpgq_torch.report.stats_report`` and ``hpgq``'s original write the
    same files from the same counters (the port's, on the CPU)."""
    import hpgq_torch
    from hpgq_torch.api import _common
    from hpgq_torch.options import StatsOptions

    path = str(tmp_path / "in.fq")
    make_fastq(path, 300, **GOLDEN_CORPUS)
    counters = hpgq_torch.stats(path, outdir=str(tmp_path), kmers=kmers,
                                max_N=3, report=False, device="cpu")
    outs = []
    for name, mod in (("hpgq", h_report), ("port", t_report)):
        out = str(tmp_path / name)
        opts = _common(StatsOptions(), path, None, out, "phred33", 10000,
                       None, False)
        opts.kmers_on = kmers
        mod.stats_report(counters, opts)
        outs.append(out)
    # the output directory is part of the .gnuplot scripts: compare each
    # file with its own directory taken out
    for d in outs:
        for name in os.listdir(d):
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                data = _normalize(f.read(), d)
            with open(p, "wb") as f:
                f.write(data)
    _same_tree(outs[1], outs[0], normalize=False)
    assert any(n.endswith("summary.txt") for n in os.listdir(outs[0]))
