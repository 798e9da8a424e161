"""Paired-end Illumina reads through the port on the CPU: a sample's pair
of files (R1, R2) of the benchmark's ``novaseq_pe150_rta3`` recipe
(``benchmark/traffic/generate_pe.py``), cut to a few thousand pairs, held
to the benchmark's numpy reference (``benchmark/reference/paired.py``),
which is held to the oracle's paired semantics; the controls against the
cell's limit; the paired pipeline's spans (``wait-mate-1``,
``wait-mate-2``, the consumer's ``read``) and its count ``pair-cuts``;
and two gzip members decoded at once on the shared decode pool."""

import gzip
import json
import os
import struct
import sys
import threading
import types

import numpy as np
import pytest

from gen import make_fastq

import hpgq_torch
from hpgq_torch import oracle
from hpgq_torch.api import filter_criteria
from hpgq_torch.io import native
from hpgq_torch.io.fastq import FastqReader
from hpgq_torch.io.native import inflate
from hpgq_torch.options import StatsOptions
from hpgq_torch.pipeline import run as prun
from hpgq_torch.utils.timers import StageTimers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "pe150_gz_stats_filter"
PAIRS = 3000


def _bench():
    """The benchmark's modules this file uses, by name: ``spec``,
    ``generate_pe``, ``stats_paired`` (its paired command), ``paired`` (its
    paired reference), ``reference`` (its single-end reference) and
    ``report_files`` (its report writer)."""
    sys.path.insert(0, ROOT)
    try:
        from benchmark.commands import stats_paired
        from benchmark.harness import spec
        from benchmark.reference import paired
        from benchmark.reference import stats as reference
        from benchmark.reference.report import report_files
        from benchmark.traffic import generate_pe
    finally:
        sys.path.remove(ROOT)
    return types.SimpleNamespace(spec=spec, generate_pe=generate_pe,
                                 stats_paired=stats_paired, paired=paired,
                                 reference=reference,
                                 report_files=report_files)


def _cell(pairs: int):
    cell = _bench().spec.load(CELL, ROOT)
    cell.config = dict(cell.config, reads_per_file=pairs)
    return cell


def _keywords(config):
    f = config["filter"]
    return {"read_length_range": tuple(f["read_length_range"]),
            "read_quality_range": tuple(f["read_quality_range"]),
            "max_N": f["max_N"]}


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """(cell, corpus) of a pair of gzip members of :data:`PAIRS` pairs."""
    cell = _cell(PAIRS)
    d = tmp_path_factory.mktemp("pe")
    corpus = _bench().generate_pe.make_corpus(cell.config, cell.traffic,
                                              2**34 + 21, str(d))
    return cell, corpus


def _records(mate):
    """The oracle's records of one mate: (name, bases, qualities)."""
    out = []
    for i, (a, n) in enumerate(zip(mate.starts, mate.lens)):
        out.append((b"@read_%d some description" % i,
                    mate.seq[a:a + n].tobytes(), mate.qual[a:a + n].tobytes()))
    return out


def test_pair_is_two_members_of_151_base_reads(sample):
    """Two files, one gzip member each, of one record count; every read
    151 bases; each mate's qualities drawn from the four bins at its own
    shares (N at the lowest)."""
    cell, corpus = sample
    assert os.path.basename(corpus.path) == "reads_1.fq.gz"
    assert os.path.basename(corpus.path2) == "reads_2.fq.gz"
    for mate, recipe in ((corpus.mate1, "quality"), (corpus.mate2, "quality2")):
        with open(mate.path, "rb") as f:
            raw = f.read()
        text = gzip.decompress(raw)
        # one member: the last trailer's size is the whole text's
        assert raw[:2] == b"\x1f\x8b"
        assert struct.unpack("<I", raw[-4:])[0] == len(text) & 0xFFFFFFFF
        lines = text.split(b"\n")[:-1]
        assert len(lines) == 4 * PAIRS
        assert {len(s) for s in lines[1::4]} == {151}
        assert mate.reads == PAIRS and (mate.lens == 151).all()
        q = cell.config[recipe]
        not_n = mate.seq != ord("N")
        share = np.bincount(mate.qual[not_n] - 33, minlength=38)[q["bins"]]
        share = share / not_n.sum()
        # with each bin's share as the recipe has it, N aside (Q2)
        assert np.abs(share - np.asarray(q["percent"]) / 100).max() < 0.01
        assert (mate.qual[~not_n] == 33 + q["n_quality"]).all()
    assert corpus.reads == 2 * PAIRS and corpus.bases == 2 * 151 * PAIRS
    assert corpus.path2 == _bench().generate_pe.mate2_path(corpus.path)
    # one name a pair, in both files; the mates' bases drawn apart
    names = [gzip.decompress(open(p, "rb").read()).split(b"\n")[0::4][:-1]
             for p in (corpus.path, corpus.path2)]
    assert names[0] == names[1] and len(names[0]) == PAIRS
    assert not np.array_equal(corpus.mate1.seq, corpus.mate2.seq)


def test_paired_reference_matches_oracle(sample):
    """The benchmark's frozen paired reference gives, field by field, what
    the oracle's ``reference_paired_stats`` gives on the same records."""
    b = _bench()
    cell, corpus = sample
    want = oracle.reference_paired_stats(
        _records(corpus.mate1), _records(corpus.mate2),
        **_keywords(cell.config))
    got = b.paired.reference_paired_stats(corpus.mate1, corpus.mate2,
                                          cell.config["filter"])
    assert 0 < got[0].num_passed < PAIRS
    for g, w in zip(got, want):
        for k in b.reference.SCALARS:
            assert getattr(g, k) == getattr(w, k), k
        for k in b.reference.ARRAYS:
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k), k)
        assert g.acc_quality == w.acc_quality
    assert got[0].num_passed == got[1].num_passed
    assert got[0].num_failed == got[1].num_failed


def _no_native(monkeypatch):
    """Every g++ library of the port unloaded, as ``HPGQ_NO_NATIVE`` has
    it in a new process."""
    monkeypatch.setenv("HPGQ_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_libs", {})


@pytest.mark.parametrize("path", ["native", "HPGQ_NO_NATIVE"])
def test_stats_matches_reference(sample, tmp_path, path, monkeypatch):
    """``hpgq_torch.stats`` over the pair with the configuration's filter
    on the CPU: every integer counter of both mates equal to the paired
    reference's, ``acc_quality`` within the cell's limit, both mates'
    report files byte-equal to the reference's, each named after its
    file."""
    b = _bench()
    cell, corpus = sample
    if path == "HPGQ_NO_NATIVE":
        _no_native(monkeypatch)
        assert native.get_lib() is None and inflate.get_lib() is None
    out = str(tmp_path / "out")
    got = hpgq_torch.stats(corpus.path, corpus.path2, outdir=out,
                           device="cpu", **_keywords(cell.config))
    want = b.paired.reference_paired_stats(corpus.mate1, corpus.mate2,
                                           cell.config["filter"])
    judge = b.stats_paired
    for g, w in zip(got, want):
        assert judge.fields_off(g, w) == 0
        assert judge.quality_gap(g, w) <= cell.limits["acc_quality_gap"]
    files = {}
    for c, mate in zip(want, (corpus.mate1, corpus.mate2)):
        files.update(b.report_files(c, mate.path, out,
                                    cell.config["filter"]["max_N"]))
    assert any(f.startswith("reads_2.fq.gz") for f in files)
    assert judge.report_off(out, files) == 0


@pytest.fixture(scope="module")
def controls(tmp_path_factory):
    """The cell's cut-down numbers of each control on 300,000 pairs, where
    a float32 running total has passed 2^23."""
    b = _bench()
    cell = _cell(300_000)
    d = tmp_path_factory.mktemp("pe_controls")
    corpus = b.generate_pe.make_corpus(
        cell.config, dict(cell.traffic, format="plain"), 918273645012, str(d))
    return b.stats_paired.control(cell, corpus, str(d / "out"))


@pytest.mark.parametrize("control", ["sum_float32", "means_bfloat16"])
def test_control_fails_the_limit(controls, control):
    """Each control (the reference with each mate's quality sum in
    float32, or each read's mean in bfloat16) fails the cell's limit."""
    numbers = controls[control]
    assert numbers["counter_fields_off"]["value"] == 0
    gap = numbers["acc_quality_gap"]
    assert gap["value"] > gap["limit"], gap


def _opts(corpus, out, cell, **kw):
    os.makedirs(out, exist_ok=True)
    opts = StatsOptions(in_filename=corpus.path, in_filename2=corpus.path2,
                        out_dirname=out, quality_encoding_name="phred33",
                        criteria=filter_criteria(**_keywords(cell.config)),
                        filter_on=True, **kw)
    opts.batch_size, opts.batch_size_set = 500, True
    return opts


def test_paired_spans_and_counts(sample, tmp_path, monkeypatch):
    """A paired pass with timers (two pack threads, as a card's host runs
    the pool): the pairing thread's ``wait-mate-1`` and ``wait-mate-2``,
    the count ``pair-cuts``, and a ``read`` that is the consumer's own,
    with ``wait-reader`` and ``wait-pack`` inside it; ``--t``'s report
    prints each."""
    monkeypatch.setenv("HPGQ_PACK_THREADS", "2")
    cell, corpus = sample
    timers = StageTimers()
    c1, c2 = prun.run_stats(_opts(corpus, str(tmp_path / "o"), cell), timers,
                            report=False, device="cpu")
    t = timers.totals
    for name in ("wait-mate-1", "wait-mate-2", "read", "wait-reader",
                 "wait-pack", "compute", "pack"):
        assert t.get(name, 0) > 0, (name, t)
    assert t["wait-reader"] + t["wait-pack"] <= t["read"] + 1e-6, t
    assert "pair-cuts" in timers.counts
    assert c1.num_passed + c1.num_failed == PAIRS
    from io import StringIO

    out = StringIO()
    timers.report(out)
    text = out.getvalue()
    for line in ("total wait-mate-1 time", "total wait-mate-2 time",
                 "count pair-cuts", "plan reads_1.fq.gz: ",
                 "plan reads_2.fq.gz: "):
        assert line in text, text


def test_wait_mate_spans_are_on_the_pairing_thread(sample, tmp_path,
                                                   monkeypatch):
    """``--profile-dir`` on the CPU: the ``stage.wait-mate-*`` ranges lie on
    a thread other than the consumer's, which holds every ``stage.read``
    and, inside them, each ``wait-reader`` and ``wait-pack``."""
    if prun._all_threads() is None:
        pytest.skip("this torch traces the calling thread only")
    monkeypatch.setenv("HPGQ_PACK_THREADS", "2")
    cell, corpus = sample
    prof = str(tmp_path / "prof")
    prun.run_stats(_opts(corpus, str(tmp_path / "o"), cell, profile_dir=prof),
                   StageTimers(), report=False, device="cpu")
    (name,) = os.listdir(prof)
    with open(os.path.join(prof, name)) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("stage."):
            spans.setdefault(e["name"][6:], []).append(
                (e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    (consumer,) = {tid for tid, _, _ in spans["read"]}
    pairing = {tid for s in ("wait-mate-1", "wait-mate-2")
               for tid, _, _ in spans[s]}
    assert len(pairing) == 1 and consumer not in pairing
    for stage in ("wait-reader", "wait-pack"):
        for tid, a, b in spans[stage]:
            assert tid == consumer
            assert any(r0 <= a and b <= r1 for _, r0, r1 in spans["read"])


def test_pair_cuts_count_blocks_cut_short(tmp_path):
    """Mate readers whose blocks end at different records (300 and 400
    reads a block over 1,000 pairs): every pair of blocks covers the same
    records of both mates, and a pair that does not end both mates'
    blocks counts one ``pair-cuts``: five of six here."""
    path = str(tmp_path / "m.fq")
    make_fastq(path, 1000, min_len=60, max_len=120, seed=4)
    timers = StageTimers()
    with FastqReader(path, batch_size=300) as r1, \
            FastqReader(path, batch_size=400) as r2:
        pairs = list(prun._iter_blocks_paired(r1, r2, timers))
    assert [a.num_reads for a, _ in pairs] == [300, 100, 200, 200, 100, 100]
    for a, b in pairs:
        assert a.num_reads == b.num_reads
        assert bytes(a.buf[a.starts[0, 0]:a.ends[-1, 3]]) == \
            bytes(b.buf[b.starts[0, 0]:b.ends[-1, 3]])
    assert timers.counts["pair-cuts"] == 5
    assert timers.totals["wait-mate-1"] > 0 and timers.totals["wait-mate-2"] > 0
    assert "read" not in timers.totals


def test_two_members_at_once_on_the_shared_pool(sample):
    """Two parallel gzip readers (two workers, 16 KiB chunks) read from
    two threads at once, one member each, on the process's one decode
    pool: each gives its own member's bytes, exactly."""
    _, corpus = sample
    lib = inflate.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler: the decoder cannot be built")
    paths = (corpus.path, corpus.path2)
    want = [gzip.decompress(open(p, "rb").read()) for p in paths]
    got = [bytearray(), bytearray()]
    chunks = [None, None]
    start = threading.Barrier(2)

    def read(i):
        with inflate.GzipReader(lib, paths[i], 2, 16 << 10) as r:
            assert r.parallel
            start.wait()
            while True:
                b = r.read(100_003)
                if not b:
                    break
                got[i] += b
            chunks[i] = r.take_counts()["inflate-chunks"]

    threads = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert bytes(got[0]) == want[0] and bytes(got[1]) == want[1]
    assert want[0] != want[1]
    assert all(c and c > 1 for c in chunks), chunks


def test_configuration_keeps_its_sources():
    """The configuration names its source, cuts only the file size, keeps
    151 bases a read and the key ``quality`` the yardstick reads, and
    lists what it assumes."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "novaseq_pe150_rta3.json")) as f:
        config = json.load(f)
    assert config["reduced"] == ["reads_per_file"]
    assert config["reads_per_file"] == 1_000_000
    assert len(config["source"]) <= 200 and "2 x 150" in config["source"]
    assert config["read_groups"] == [{"fraction": 1.0, "min_len": 151,
                                      "max_len": 151}]
    assert config["quality"]["bins"] == config["quality2"]["bins"] == [2, 12, 23, 37]
    mean_q37 = (config["quality"]["percent"][3]
                + config["quality2"]["percent"][3]) / 2
    assert mean_q37 == 85
    assert "pairing" in config["guarantees"] and len(config["assumed"]) >= 6
