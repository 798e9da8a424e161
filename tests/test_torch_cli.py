"""The port's legacy single-binary invocations against ``hpgq``'s, and
its ``--profile-dir``.

Mirrors of ``tests/test_cli.py:701-988``: each legacy command line (action
flags such as ``--qc``, ``--filter``, ``--prep`` and ``--cg`` with no
subcommand, the legacy filter spellings, ``--conf`` files, the
``--flag=value`` form) goes through ``hpgq``'s CLI (JAX on the CPU) and
the port's with ``--device cpu``, each into its own output directory: the
exit codes and the console output must be the same (after the directory's
name), and every output file byte-equal, stats reports with their ``Mean
quality`` line to 1e-3 relative (``tests/test_torch_pipeline.py``).

``--profile-dir``: each command that writes a trace writes one
non-empty Chrome trace and the same console and bytes as without it.
"""

import contextlib
import io
import json
import os

import pytest

from gen import make_fastq

from hpgq.cli.main import main as hpgq_main
from hpgq_torch.cli.main import main as port_main
from test_torch_pipeline import _normalize, _same_report


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _tree(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _legacy_identical(tmp_path, argv, label):
    """``argv(outdir)`` through both CLIs; returns (port's outdir, its exit
    code, its console output)."""
    ref, port = str(tmp_path / (label + "_ref")), str(tmp_path / label)
    os.makedirs(ref)
    os.makedirs(port)
    log = ["--log-file", str(tmp_path / "log")]
    rc_ref, out_ref, _ = _run(hpgq_main, argv(ref) + log)
    rc, out, _ = _run(port_main, argv(port) + log + ["--device", "cpu"])
    assert rc == rc_ref, label
    if rc == 0:
        assert out.replace(port, "<OUTDIR>") == out_ref.replace(ref,
                                                                "<OUTDIR>")
    assert _tree(port) == _tree(ref), label
    for name in _tree(ref):
        with open(os.path.join(ref, name), "rb") as f:
            want = _normalize(f.read(), ref)
        with open(os.path.join(port, name), "rb") as f:
            got = _normalize(f.read(), port)
        _same_report(got, want, "%s: %s" % (label, name))
    return port, rc, out


def _fastq(tmp_path, name="in.fq", n=300, **kw):
    path = str(tmp_path / name)
    make_fastq(path, n, **kw)
    return path


def test_cli_filter_legacy_flags(tmp_path):
    """Legacy getopt filter spellings (old/README:121-142) write what the
    modern range strings write, and what ``hpgq`` writes; the legacy
    quality bounds are clamped to 10-70."""
    path = _fastq(tmp_path, n=400, min_len=40, max_len=80, n_prob=0.02,
                  seed=91)
    legacy = ["--min-read-length", "45", "--max-read-length", "75",
              "--min-quality", "20", "--max-quality", "65",
              "--max-n-per-read", "1", "--max-nts-mismatch", "30",
              "--lfilter-nts", "10", "--rfilter-nts", "5"]
    a, _, _ = _legacy_identical(
        tmp_path, lambda o: ["filter", "-f", path, "-o", o] + legacy,
        "legacy")
    b, _, _ = _legacy_identical(tmp_path, lambda o: [
        "filter", "-f", path, "-o", o, "--read-length-range", "45,75",
        "--read-quality-range", "20,65", "--max-N", "1",
        "--max-out-of-quality", "30", "--left-length", "10",
        "--left-quality-range", "20,65", "--right-length", "5",
        "--right-quality-range", "20,65"], "modern")
    for name in ("passed.fq", "failed.fq"):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    _, _, out = _legacy_identical(tmp_path, lambda o: [
        "filter", "-f", path, "-o", o, "--min-quality", "5",
        "--max-quality", "99"], "clamp")
    assert "Read quality range  : 10,70" in out


def test_cli_legacy_invocation_style(tmp_path):
    """Legacy single-binary invocations (old/README's examples): `prepro`,
    `filter` with ``<input>.valid``/``.invalid``, ``--qc --chaos-game``
    with a byte-valued ``--batch-size``, and a combination the legacy
    binary did not run (-1)."""
    path = _fastq(tmp_path, n=200, min_len=60, max_len=80, seed=92)
    d, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--prep", "--rtrim-nts", "3", "--ltrim-nts", "5", "--outdir", o,
        "--fq", path, "--phred-quality", "33", "--min-quality", "27",
        "--max-quality", "64"], "prep")
    assert _tree(d) == ["in.fq.valid"]
    d, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--filter", "--lfilter-nts", "10", "--outdir", o, "--fq", path,
        "--min-quality", "20", "--max-quality", "65"], "filt")
    assert _tree(d) == ["in.fq.invalid", "in.fq.valid"]
    d, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--qc", "--fq", path, "--outdir", o, "--kmers", "--batch-size",
        "50000000", "--chaos-game", "--k", "4", "--write-gs"], "qccg")
    for name in ("in.fq.summary.txt", "in.fq_k=4_FG.pgm", "in.fq_k=4.gs",
                 "in.fq.kmers.txt"):
        assert name in _tree(d), name
    _, rc, _ = _legacy_identical(tmp_path, lambda o: [
        "--filter", "--prep", "--fq", path, "--outdir", o], "conflict")
    assert rc == -1


def test_cli_legacy_qc_filter_combo(tmp_path):
    """``--qc --filter``: filter, then stats over both output sets, not
    filtered again (old/README:144)."""
    path = _fastq(tmp_path, n=200, min_len=50, max_len=70, n_prob=0.02,
                  seed=93)
    d, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--qc", "--filter", "--fq", path, "--outdir", o, "--min-quality",
        "20", "--max-quality", "60", "--max-n-per-read", "2"], "combo")
    with open(os.path.join(d, "in.fq.valid.summary.txt")) as f:
        summary = f.read()
    assert "Filter         : Disabled" in summary
    with open(os.path.join(d, "in.fq.valid"), "rb") as fp, \
            open(os.path.join(d, "in.fq.invalid"), "rb") as ff:
        n_pass, n_fail = (x.read().count(b"@read_") for x in (fp, ff))
    assert n_pass + n_fail == 200 and 0 < n_pass < 200
    assert "Number of reads: %d" % n_pass in summary


def test_legacy_filter_valid_invalid_names(tmp_path):
    """Legacy ``--filter`` output names (old/README:126-131): the bytes of
    the modern ``passed``/``failed`` files, single-end and paired."""
    path = _fastq(tmp_path, n=300, min_len=40, max_len=80, n_prob=0.02,
                  seed=94)
    flags = ["--min-quality", "20", "--max-quality", "60",
             "--max-n-per-read", "2"]
    lg, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--filter", "--fq", path, "--outdir", o] + flags, "lg")
    md, _, _ = _legacy_identical(tmp_path, lambda o: [
        "filter", "-f", path, "-o", o] + flags, "md")
    pairs = [("in.fq.valid", "passed.fq"), ("in.fq.invalid", "failed.fq")]
    p1 = _fastq(tmp_path, "p1.fq", n=200, min_len=40, max_len=70, seed=95)
    p2 = _fastq(tmp_path, "p2.fq", n=200, min_len=40, max_len=70, seed=96)
    lgp, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--filter", "--fq1", p1, "--fq2", p2, "--outdir", o] + flags, "lgp")
    mdp, _, _ = _legacy_identical(tmp_path, lambda o: [
        "filter", "--fq1", p1, "--fq2", p2, "-o", o] + flags, "mdp")
    pairs_p = [("p1.fq.valid", "passed_1.fq"), ("p2.fq.valid", "passed_2.fq"),
               ("p1.fq.invalid", "failed_1.fq"),
               ("p2.fq.invalid", "failed_2.fq")]
    for (a, b), (da, db) in ([(p, (lg, md)) for p in pairs]
                             + [(p, (lgp, mdp)) for p in pairs_p]):
        with open(os.path.join(da, a), "rb") as fa, \
                open(os.path.join(db, b), "rb") as fb:
            assert fa.read() == fb.read(), (a, b)
    assert "passed.fq" not in _tree(lg)


def test_legacy_qc_filter_combo_conf_input(tmp_path):
    """``--qc --filter`` with the input in a ``--conf`` file: the stats
    legs look for the ``<input>.valid``/``.invalid`` names the filter leg
    wrote."""
    fq = _fastq(tmp_path, "cx.fq", n=200, min_len=50, max_len=70, seed=97)
    conf = tmp_path / "in.conf"
    conf.write_text("fq = %s ;\nmin-quality = 20 ;\nmax-quality = 60 ;\n"
                    % fq)
    d, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--qc", "--filter", "--conf", str(conf), "--outdir", o], "conf")
    for name in ("cx.fq.valid", "cx.fq.invalid", "cx.fq.valid.summary.txt",
                 "cx.fq.invalid.summary.txt"):
        assert name in _tree(d), name


def test_legacy_misc_flags(tmp_path, capsys):
    """``--quality-control``, ``--v``, the inert GPU geometry knobs, and a
    negative quality window refused cleanly."""
    fq = _fastq(tmp_path, "lg.fq", n=300, min_len=50, max_len=90, seed=3)
    d, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--quality-control", "--fq", fq, "--outdir", o, "--gpu-num-threads",
        "512", "--gpu-num-blocks", "16", "--gpu-num-devices", "1", "--v"],
        "misc")
    assert "lg.fq.summary.txt" in _tree(d)
    with pytest.raises(SystemExit):
        port_main(["stats", "-f", fq, "-o", str(tmp_path),
                   "--start-quality-nt", "-5", "--device", "cpu"])
    assert "must not be negative" in capsys.readouterr().err


def test_legacy_quality_nt_window(tmp_path):
    """[D8] ``--start-quality-nt``/``--end-quality-nt`` (and the banner's
    ``--begin-quality-nt=`` form) split as ``hpgq`` splits, and not as the
    whole read would."""
    fq = _fastq(tmp_path, "w.fq", n=400, min_len=30, max_len=100, seed=77)
    win, _, _ = _legacy_identical(tmp_path, lambda o: [
        "filter", "-f", fq, "-o", o, "--read-quality-range", "20,23",
        "--start-quality-nt", "10", "--end-quality-nt", "40"], "window")
    whole, _, _ = _legacy_identical(tmp_path, lambda o: [
        "filter", "-f", fq, "-o", o, "--read-quality-range", "20,23"],
        "whole")
    with open(os.path.join(win, "passed.fq"), "rb") as a, \
            open(os.path.join(whole, "passed.fq"), "rb") as b:
        n_win = a.read().count(b"@read_")
        assert n_win != b.read().count(b"@read_")
    d, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--filter", "--fq", fq, "--outdir", o, "--min-quality", "20",
        "--max-quality", "23", "--begin-quality-nt=10",
        "--end-quality-nt=40"], "legacy")
    with open(os.path.join(d, "w.fq.valid"), "rb") as f:
        assert f.read().count(b"@read_") == n_win


def test_legacy_conf_filter_keys(tmp_path):
    """Legacy ``--conf`` keys reach the filter criteria, as the equivalent
    explicit flags do."""
    fq = _fastq(tmp_path, "cf.fq", n=400, min_len=40, max_len=110,
                n_prob=0.02, seed=13)
    conf = tmp_path / "legacy.conf"
    conf.write_text("min-quality = 18 ;\nmax-quality = 45 ;\n"
                    "min-read-length = 50 ;\nmax-n-per-read = 3 ;\n")
    a, _, _ = _legacy_identical(tmp_path, lambda o: [
        "filter", "--fq", fq, "-o", o, "--conf", str(conf)], "conf")
    b, _, _ = _legacy_identical(tmp_path, lambda o: [
        "filter", "--fq", fq, "-o", o, "--read-quality-range", "18,45",
        "--read-length-range", "50,", "--max-N", "3"], "flags")
    for name in ("passed.fq", "failed.fq"):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_legacy_qc_with_filter_aliases_and_eq_form(tmp_path):
    """A legacy QC line with filter aliases in the ``--flag=value`` form
    filters inline."""
    fq = _fastq(tmp_path, "lq.fq", n=400, min_len=40, max_len=110,
                n_prob=0.02, seed=15)
    d, _, _ = _legacy_identical(tmp_path, lambda o: [
        "--qc", "--fq", fq, "--outdir=%s" % o, "--min-quality=18",
        "--max-quality=45"], "eq")
    with open(os.path.join(d, "lq.fq.summary.txt")) as f:
        summary = f.read()
    assert "Filter" in summary and "18" in summary and "45" in summary


PROFILED = {  # command lines of every command that writes a trace
    "stats": ["stats", "--read-quality-range", "20,40", "--max-N", "2",
              "--kmers"],
    "stats-paired": ["stats", "--read-quality-range", "20,40", "--max-N",
                     "2"],
    "filter": ["filter", "--read-quality-range", "20,40", "--max-N", "2"],
    "edit": ["edit", "--left-length", "8", "--left-quality-range", "28,60",
             "--read-quality-range", "20,45"],
}


@pytest.mark.parametrize("case", list(PROFILED))
def test_profile_dir_writes_one_trace(tmp_path, case):
    """``--profile-dir D`` on the CPU: one non-empty Chrome trace in ``D``
    (``hpgq_torch.<pid>.<random>.pt.trace.json``), and the console and
    every output file byte-equal to the same run without the flag."""
    m1 = _fastq(tmp_path, "m1.fq", n=600, min_len=40, max_len=120,
                n_prob=0.02, seed=31)
    inputs = ["-f", m1]
    if case.endswith("paired"):
        inputs = ["--fq1", m1, "--fq2", _fastq(
            tmp_path, "m2.fq", n=600, min_len=40, max_len=120, n_prob=0.02,
            seed=32)]
    prof = str(tmp_path / "prof")
    runs = {}
    for label, extra in (("plain", []), ("profiled", ["--profile-dir",
                                                      prof])):
        out = str(tmp_path / label)
        os.makedirs(out)
        rc, console, _ = _run(port_main, PROFILED[case] + inputs + [
            "-o", out, "--batch-size", "150", "--device", "cpu",
            "--log-file", str(tmp_path / "log")] + extra)
        assert rc == 0, (label, console)
        files = {}
        for name in _tree(out):
            with open(os.path.join(out, name), "rb") as f:
                files[name] = _normalize(f.read(), out)
        runs[label] = (console.replace(out, "<OUTDIR>"), files)
    assert runs["plain"][1], "no output written"
    assert runs["profiled"] == runs["plain"]
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].startswith(
        "hpgq_torch.%d." % os.getpid()), traces
    assert traces[0].endswith(".pt.trace.json")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("ph") == "X" for ev in events), events[:5]
