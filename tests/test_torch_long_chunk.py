"""Nanopore long reads through the port on the CPU: a chunk of the
benchmark's ``minion_r94_na12878_chunk`` recipe (``benchmark/traffic/
generate_ont.py``), cut to 200 reads of at most ~20 kb, held to the
benchmark's numpy reference (``benchmark/reference/stats.py``); the
float64 carry of ``acc_quality`` that the configuration's guarantee asks
for, which a float32 sum fails; and the ``grow`` span and the long-read
counts of the sessions' timers."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import hpgq_torch
from hpgq_torch.api import filter_criteria
from hpgq_torch.core.accumulator import from_jax_partials
from hpgq_torch.kernels import stats_torch
from hpgq_torch.options import StatsOptions
from hpgq_torch.pipeline.run import run_stats
from hpgq_torch.pipeline.session import StatsSession
from hpgq_torch.utils.timers import StageTimers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ont_chunk_gz_stats_filter"
CUT_LEN = 20063  # the last read group kept: reads of at most ~20 kb


def _bench():
    """The benchmark's modules this file uses, by name: ``spec``,
    ``generate_ont``, ``stats`` (its ``stats`` command), ``reference``
    (its reference counters) and ``report_files`` (its report writer)."""
    sys.path.insert(0, ROOT)
    try:
        from benchmark.commands import stats
        from benchmark.harness import spec
        from benchmark.reference import stats as reference
        from benchmark.reference.report import report_files
        from benchmark.traffic import generate_ont
    finally:
        sys.path.remove(ROOT)
    return types.SimpleNamespace(spec=spec, generate_ont=generate_ont,
                                 stats=stats, reference=reference,
                                 report_files=report_files)


def _cell(reads: int, groups=None):
    """The benchmark cell with its configuration cut to ``reads`` reads,
    the read groups up to :data:`CUT_LEN` (or ``groups``)."""
    cell = _bench().spec.load(CELL, ROOT)
    cut = [g for g in cell.config["read_groups"] if g["max_len"] <= CUT_LEN]
    cell.config = dict(cell.config, reads_per_file=reads,
                       read_groups=groups or cut)
    return cell


def _keywords(config):
    f = config["filter"]
    return {"read_length_range": tuple(f["read_length_range"]),
            "read_quality_range": tuple(f["read_quality_range"]),
            "max_N": f["max_N"]}


@pytest.fixture(scope="module")
def chunk(tmp_path_factory):
    """(cell, corpus) of a 200-read gzip chunk."""
    cell = _cell(200)
    d = tmp_path_factory.mktemp("ont")
    corpus = _bench().generate_ont.make_corpus(cell.config, cell.traffic,
                                               2**33 + 17, str(d))
    return cell, corpus


def test_chunk_is_long_reads(chunk):
    """The cut chunk still takes the long-read path: reads past K1's 4096
    columns, up to ~20 kb, no N."""
    _, corpus = chunk
    assert corpus.reads == 200 and corpus.path.endswith(".fq.gz")
    assert 4096 < corpus.lens.max() <= CUT_LEN
    assert not (corpus.seq == ord("N")).any()


@pytest.mark.parametrize("wire", ["auto", "bitpack"])
def test_stats_matches_reference(chunk, tmp_path, wire, monkeypatch):
    """``hpgq_torch.stats`` with the configuration's filter on the CPU, over
    the CPU's plain tensors (``auto``) and over the card's bitpack wire,
    decoded by the plain-torch decoders: every integer counter and every
    report file equal to the reference's, ``acc_quality`` within the
    cell's limit."""
    monkeypatch.setenv("HPGQ_WIRE", wire)
    b = _bench()
    cell, corpus = chunk
    got = hpgq_torch.stats(corpus.path, outdir=str(tmp_path), device="cpu",
                           **_keywords(cell.config))
    want = b.reference.reference_stats(corpus, cell.config["filter"])
    assert 0 < want.num_passed < corpus.reads
    assert got.count_quality_per_nt.shape[0] > 4096
    assert b.stats.fields_off(got, want) == 0
    assert b.stats.quality_gap(got, want) <= cell.limits["acc_quality_gap"]
    assert b.stats.report_off(str(tmp_path), b.report_files(
        want, corpus.path, str(tmp_path), cell.config["filter"]["max_N"])) == 0


@pytest.mark.parametrize("control", ["sum_float32", "means_bfloat16"])
def test_control_fails_the_limit(tmp_path, control):
    """Each control (the reference with the quality sum in float32, or
    each read's mean in bfloat16) fails the cell's limit on 4,000 reads of
    1-2 kb: one batch of a chunk, where a float32 batch sum is the whole
    file's."""
    b = _bench()
    cell = _cell(4000, [{"fraction": 1.0, "min_len": 1000, "max_len": 2000}])
    corpus = b.generate_ont.make_corpus(
        cell.config, dict(cell.traffic, format="plain"), 918273645012,
        str(tmp_path))
    numbers = b.stats.control(cell, corpus, str(tmp_path / "out"))[control]
    assert numbers["counter_fields_off"]["value"] == 0
    gap = numbers["acc_quality_gap"]
    assert gap["value"] > 100 * gap["limit"], gap


def test_grow_span_and_counts(chunk, tmp_path):
    """``run_stats`` with a pass's timers: the ``grow`` stage and count,
    and the long-read blocks' bytes with their padding past the reads,
    printed by ``--t``'s report; under a profiler the growth is a
    ``stage.grow`` range."""
    cell, corpus = chunk
    opts = StatsOptions(in_filename=corpus.path, out_dirname=str(tmp_path),
                        quality_encoding_name="phred33",
                        criteria=filter_criteria(**_keywords(cell.config)),
                        filter_on=True)
    timers = StageTimers()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run_stats(opts, timers, report=False, device="cpu")
    assert timers.totals["grow"] > 0 and timers.counts["grow"] >= 1
    long_bytes, pad = timers.counts["long-bytes"], timers.counts["long-pad-bytes"]
    assert 0 < pad < long_bytes
    # codes and quals a column each: at least two bytes a base
    assert long_bytes - pad >= 2 * corpus.bases
    assert any(e.name == "stage.grow" for e in prof.events())
    from io import StringIO

    out = StringIO()
    timers.report(out)
    text = out.getvalue()
    for line in ("total grow time", "count grow ", "count long-bytes",
                 "count long-pad-bytes"):
        assert line in text, text


@pytest.mark.parametrize("path", ["ragged", "classes", "kmers"])
def test_long_block_paths_match_reference(chunk, monkeypatch, path):
    """``run_stats`` over the chunk in blocks of 64 reads, each past K1's
    columns: on the bitpack wire each block goes as one ragged 6-bit wire
    through the plain twin of K2's ragged entry (``ragged``), on the plain
    wire (``classes``) and with ``--kmers`` (``kmers``) as its length
    classes; every integer counter equal to the reference's and
    ``acc_quality`` within the cell's limit on each path, the blocks
    counted as ``long-ragged`` or ``long-fallback``, and the ragged wire's
    bytes past the reads' ends under 2% of its bytes."""
    b = _bench()
    cell, corpus = chunk
    monkeypatch.setenv("HPGQ_WIRE", "off" if path == "classes" else "bitpack")
    opts = StatsOptions(in_filename=corpus.path, quality_encoding_name="phred33",
                        criteria=filter_criteria(**_keywords(cell.config)),
                        filter_on=True, batch_size=64,
                        kmers_on=path == "kmers")
    timers = StageTimers()
    got = run_stats(opts, timers, report=False, device="cpu")
    want = b.reference.reference_stats(corpus, cell.config["filter"])
    assert b.stats.fields_off(got, want) == 0
    assert b.stats.quality_gap(got, want) <= cell.limits["acc_quality_gap"]
    assert timers.num_batches == 4
    # a block past K1's columns goes long, and so may one within them
    # that is packed after the session grew
    long_own = sum(int(corpus.lens[i:i + 64].max()) > 4096
                   for i in range(0, corpus.reads, 64))
    counts = timers.counts
    ragged, fallback = counts["long-ragged"], counts["long-fallback"]
    assert long_own <= ragged + fallback <= timers.num_batches
    if path == "ragged":
        assert fallback == 0
        assert 0 < 50 * counts["long-pad-bytes"] < counts["long-bytes"]
        # 9 bits a base, the table and the pad
        assert counts["long-bytes"] < 1.2 * corpus.bases
    else:
        assert ragged == 0


def test_long_parts_are_length_classes(chunk):
    """A long block goes to the device as its length classes: together
    they hold each of its reads once; inside one, every width rounds up to
    the same power of two times 128; they come widest first; and packed
    each at its own width, under half of their bytes lie past the reads'
    ends, and they are under half the bytes of the block packed whole at
    its widest read's width."""
    from hpgq_torch.io.fastq import FastqReader
    from hpgq_torch.pipeline.session import batch_rows, long_parts, pack_payload

    _, corpus = chunk
    with FastqReader(corpus.path) as rd:
        block = next(iter(rd))
    assert block.max_len() > 4096
    parts = long_parts(block)
    assert len(parts) > 3
    got = np.sort(np.concatenate([p.starts[:, 0] for p in parts]))
    assert np.array_equal(got, np.sort(block.starts[:, 0]))
    classes = [np.unique(np.ceil(np.log2(np.maximum(p.seq_lens, 1) / 128)).clip(0))
               for p in parts]
    assert all(len(c) == 1 for c in classes)
    assert [c[0] for c in classes] == sorted((c[0] for c in classes), reverse=True)
    timers = StageTimers()
    sess = StatsSession(33, device="cpu", lcap=8192, timers=timers)
    sess.pack(block)
    long_bytes, pad = timers.counts["long-bytes"], timers.counts["long-pad-bytes"]
    assert 2 * pad < long_bytes
    L = (block.max_len() + 127) // 128 * 128
    whole = pack_payload(block, L, batch_rows(block.num_reads, L, 16384), None)
    assert 2 * long_bytes < sum(a.nbytes for a in whole)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_short_reads_count_no_long_bytes(tmp_path, paired):
    """A session, single-end or paired, fed blocks within its width and
    K1's counts no growth and no long-read bytes."""
    from gen import make_fastq

    from hpgq_torch.io.fastq import FastqReader
    from hpgq_torch.pipeline.session import PairedStatsSession, to_device

    timers = StageTimers()
    path = str(tmp_path / "r.fq")
    make_fastq(path, 50, min_len=90, max_len=110, seed=3)
    if paired:
        sess = PairedStatsSession(33, device="cpu", timers=timers)
        with FastqReader(path) as r1, FastqReader(path) as r2:
            for b1, b2 in zip(r1, r2):
                sess.feed_pair_packed(*to_device(sess.pack_pair(b1, b2),
                                                 torch.device("cpu")))
        assert sess.finish()[0].num_reads == 50
    else:
        sess = StatsSession(33, device="cpu", timers=timers)
        with FastqReader(path) as rd:
            for block in rd:
                sess.feed_packed(*(torch.from_numpy(a) for a in sess.pack(block)))
        assert sess.finish().num_reads == 50
    assert "long-bytes" not in timers.counts and "grow" not in timers.counts


def test_accumulator_carries_float64():
    """The device accumulator's quality sum is float64, fed by the plain
    twin's float64 batch sum and by a float32 batch sum (K1's) alike."""
    acc = stats_torch.zero_partials(128, device="cpu")
    assert acc["acc_quality"].dtype == torch.float64
    assert "acc_quality_comp" not in acc
    rng = np.random.default_rng(5)
    B, L = 64, 128
    codes = torch.from_numpy(rng.integers(0, 4, (B, L)).astype(np.int8))
    quals = torch.from_numpy(rng.integers(35, 70, (B, L)).astype(np.uint8))
    lens = torch.from_numpy(rng.integers(1, L + 1, B).astype(np.int32))
    valid = torch.ones(B, dtype=torch.bool)
    p = stats_torch.fused_partials(codes, quals, lens, valid, L, 33)
    assert p["acc_quality"].dtype == torch.float64
    p.pop("_passed_mask")
    stats_torch.merge_into(acc, p)
    p["acc_quality"] = torch.tensor(1.0 + 2**-30, dtype=torch.float32)
    stats_torch.merge_into(acc, p)
    assert acc["acc_quality"].dtype == torch.float64
    mean = (quals.to(torch.int64) * (torch.arange(L) < lens[:, None])).sum(1)
    want = (mean.float() / lens.float()).double().sum().item()
    want += float(np.float32(1.0 + 2**-30))
    assert acc["acc_quality"].item() == pytest.approx(want, rel=1e-15)


def test_from_jax_partials_folds_the_kahan_term():
    """A JAX accumulator's float32 sum and Kahan term become one float64
    carry: the sum less the term."""
    host = {k: np.asarray(v.numpy()) for k, v in
            stats_torch.zero_partials(8, device="cpu").items()}
    host["acc_quality"] = np.float32(1000.0)
    host["acc_quality_comp"] = np.float32(-2**-14)
    acc = from_jax_partials(host, "cpu")
    assert set(acc) == set(host) - {"acc_quality_comp"}
    assert acc["acc_quality"].dtype == torch.float64
    assert acc["acc_quality"].item() == 1000.0 + 2**-14
    assert all(v.dtype == torch.int64 for k, v in acc.items()
               if k != "acc_quality")


def test_configuration_keeps_its_sources():
    """The configuration names its sources, cuts nothing and lists what it
    assumes."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "minion_r94_na12878_chunk.json")) as f:
        config = json.load(f)
    assert config["reduced"] == [] and config["reads_per_file"] == 4000
    assert "doi:10.1038/nbt.4060" in config["source"]
    assert len(config["source"]) <= 200 and len(config["assumed"]) >= 8
    assert config["n_rate"] == 0 and len(config["read_groups"]) >= 12
    assert config["filter"]["read_quality_range"] == [7, 60]


def _python_rows(monkeypatch):
    """The report's rows formatted by Python: the native library unloaded,
    as without a compiler."""
    from hpgq_torch.report import rows

    monkeypatch.setattr(rows, "get_lib", lambda: None)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", ["long", "edges"])
def test_report_writer_matches_hpgq_over_long_reads(tmp_path, case, native,
                                                    monkeypatch):
    """The port's report writer, which works out its per-position files
    over whole arrays and formats them with ``rows.cpp`` (``native``) or in
    Python, writes the bytes of ``hpgq``'s per-position loops: over
    130,000 positions of falling coverage (``long``), and over positions
    whose base total is zero, whose GC share is at most 1% and whose mean
    quality lies on a half (``edges``)."""
    import hpgq.report.stats_report as h_report
    import hpgq_torch.report.stats_report as t_report
    from hpgq_torch.core.counters import StatsCounters
    from hpgq_torch.report import rows

    if native and rows.get_lib() is None:
        pytest.skip("no C++ compiler: the rows library cannot be built")
    if not native:
        _python_rows(monkeypatch)

    rng = np.random.default_rng(11)
    n = 130_000 if case == "long" else 400
    c = StatsCounters(phred=33)
    c.filter_on = True
    c.ensure_length(n)
    cov = np.maximum(1, 4000 * np.exp(-np.arange(n) / 9000)).astype(np.int64)
    c.count_quality_per_nt[:] = cov
    c.acc_quality_per_nt[:] = cov * rng.integers(34, 74, n)
    c.base_per_nt[:] = rng.multinomial(1, [0.3, 0.2, 0.2, 0.29, 0.01],
                                       (n,)).T * cov
    c.base_per_nt[:, rng.random(n) < 0.5] += rng.integers(0, 50, (5, 1))
    if case == "edges":
        c.base_per_nt[:, ::7] = 0  # no A/C/G/T/N counted: 0/0 shares
        c.base_per_nt[1:3, 3::11] = 0  # no C or G: GC 0%
        c.count_quality_per_nt[::5] = 2
        c.acc_quality_per_nt[::5] = 2 * 41 + 1  # a mean of 41.5: Q8.5
    c.length_hist[rng.integers(1, n, 300)] += 1
    c.num_reads = c.num_passed = 4000
    c.num_failed = 500
    c.acc_length, c.min_length, c.max_length = 25_000_000, 1000, n
    c.num_As = c.num_Cs = c.num_Gs = c.num_Ts = 6_000_000
    c.acc_quality = 4000 * 43.25
    c.quality_hist[40:50] = 400
    c.gc_hist[40:60] = 200
    opts = StatsOptions(in_filename="in.fq", quality_encoding_name="phred33",
                        criteria=filter_criteria(read_quality_range=(7, 60)),
                        filter_on=True, read_quality_range="7,60")
    files = []
    for name, mod in (("hpgq", h_report), ("port", t_report)):
        opts.out_dirname = str(tmp_path / name)
        os.makedirs(opts.out_dirname)
        mod.stats_report(c, opts)
        files.append({f: open(os.path.join(opts.out_dirname, f), "rb").read()
                      for f in os.listdir(opts.out_dirname)
                      if not f.endswith(".gnuplot")})
    assert sorted(files[0]) == sorted(files[1])
    for f in files[0]:
        assert files[0][f] == files[1][f], f
    if case == "edges":
        assert b"nan" in files[1]["in.fq.nucleotides.data"]



_EDGES = [0.49999999999999994, 0.5, -0.5, 1.5, 2.5, -2.5, -0.3, -0.0, 0.0,
          4503599627370495.5, 2.0**53 + 2, -7.5, 1e300, float("inf"),
          -float("inf"), float("nan"), -float("nan")]


@pytest.mark.parametrize("func", ["c_round", "f32div", "f32pct", "fmt2f"])
def test_cfmt_arrays_match_hpgq_scalars(func):
    """Each of the port's C-formatting helpers gives, over an array, what
    ``hpgq``'s one-value helper (C ``round()`` bound from libm) gives for
    each element, and the same for one value: half-way and 1-ulp values,
    signed zeros, infinities, NaNs of either sign, 0/0 and counts past
    2^24."""
    import hpgq.utils.cfmt as h
    import hpgq_torch.utils.cfmt as t

    rng = np.random.default_rng(5)
    if func in ("c_round", "fmt2f"):
        x = np.array(_EDGES + list(rng.normal(0, 50, 2000))
                     + list(np.round(rng.normal(0, 50, 500) * 2) / 2)
                     + [0.005, 0.015, 0.125, 1.005, -0.005, 2.675])
        args = (x,)
    else:
        a = np.concatenate([rng.integers(0, 5000, 2000), [0, 0, 7, 16777217,
                                                          16777216, 2**40]])
        b = np.concatenate([rng.integers(0, 5000, 2000), [0, 3, 0, 16778056,
                                                          16778056, 3]])
        args = (a, b)
    got = getattr(t, func)(*args)
    want = [getattr(h, func)(*(float(v) if func == "c_round" or func == "fmt2f"
                               else int(v) for v in vs))
            for vs in zip(*args)]
    one = [getattr(t, func)(*(v.item() for v in vs)) for vs in zip(*args)]
    if func == "fmt2f":
        assert got == want and one == want
    else:
        w = np.array(want)
        assert np.array_equal(got, w, equal_nan=True)
        assert np.array_equal(np.signbit(got), np.signbit(w))
        assert np.array_equal(np.array(one), w, equal_nan=True)
        assert all(type(v) is float for v in one)


_F2 = [0.0, -0.0, 0.005, 0.015, 0.125, 0.375, 0.625, 1.005, 2.675, 99.995,
       100.0, -0.001, -0.125, -2.5, 1e-300, 5e-324, -5e-324, 0.004999999999,
       123456789.125, 999999999999999.9, 1e15, -1e15, 2.0**60, 1e300,
       float("inf"), -float("inf"), float("nan"), -float("nan")]
_ROWS = {
    "floats": "%i\t%0.2f\n",
    "ints": "%i\t%i\n",
    "positions": "\tpos. %i: %i [%c]\t" * 5 + "\n",
    "nucleotides": "%i" + "\t%0.2f" * 5 + "\n",
}


def _rows_columns(fmt, n, rng):
    """Columns for ``fmt``'s conversions, ``n`` rows: integers of either
    sign (INT_MIN among them), bytes past ASCII for ``%c``, and for
    ``%0.2f`` the edge values of :data:`_F2` among values on a half-cent,
    a quarter-cent and anywhere."""
    from hpgq_torch.report.rows import _CONV

    cols = []
    for k in _CONV.findall(fmt):
        if k == "0.2f":
            x = rng.choice([rng.normal(0, 50, n), np.round(rng.normal(0, 50, n) * 200) / 200,
                            np.round(rng.normal(0, 50, n) * 400) / 400, rng.random(n) * 100])
            x[rng.integers(0, n, len(_F2))] = _F2
            cols.append(x)
        elif k == "c":
            cols.append(rng.integers(-300, 300, n))
        else:
            col = rng.integers(-2**40, 2**40, n)
            col[: 3] = [-(1 << 31), 0, 2**63 - 1]
            cols.append(col)
    return cols


@pytest.mark.parametrize("fmt", sorted(_ROWS))
def test_rows_native_matches_python(tmp_path, fmt):
    """``rows.cpp`` writes what Python's ``%`` and ``cfmt.fmt2f`` write, on
    every kind of row the report has: glibc's ``%0.2f`` at ties on the
    exact binary value, tiny, subnormal, huge (1e15 and up), signed zero,
    infinite and NaN values of either sign; integers of either sign; and
    ``%c`` bytes past ASCII, which the text file encodes."""
    from hpgq_torch.report import rows

    if rows.get_lib() is None:
        pytest.skip("no C++ compiler: the rows library cannot be built")
    rng = np.random.default_rng(23)
    cols = _rows_columns(_ROWS[fmt], 5000, rng)
    want = rows.format_rows_py(_ROWS[fmt], *cols)
    path = tmp_path / "rows.txt"
    with open(path, "w", newline="\n") as f:
        f.write("head\n")
        rows.write_rows(f, _ROWS[fmt], *cols)
        f.write("tail\n")
    with open(path, newline="") as f:  # a %c byte may be a carriage return
        assert f.read() == "head\n" + want + "tail\n"
    if fmt == "floats":
        assert "\t0.12\n" in want and "\t-nan\n" in want and "\t0.38\n" in want


def test_rows_ascii_bytes_go_straight_to_the_file(tmp_path, monkeypatch):
    """An ASCII row text reaches the file's byte stream with no string made
    of it; one with a ``%c`` byte past ASCII is written as text, so the file
    holds its UTF-8 encoding, as ``hpgq``'s ``chr()`` does."""
    from hpgq_torch.report import rows

    if rows.get_lib() is None:
        pytest.skip("no C++ compiler: the rows library cannot be built")
    texts = []
    monkeypatch.setattr(rows, "format_rows_py",
                        lambda *a: texts.append(a) or "")
    for codes, want in (([65, 66], b"[A][B]"), ([65, 200], "[A][\u00c8]".encode())):
        path = tmp_path / "c.txt"
        with open(path, "w", newline="\n", encoding="utf-8") as f:
            rows.write_rows(f, "[%c]", np.array(codes))
        assert path.read_bytes() == want
    assert texts == []
