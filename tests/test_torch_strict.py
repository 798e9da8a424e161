"""The strict-compat knobs of ``hpgq/oracle/spec.py`` in the port.

* ``HPGQ_STRICT_CASE=1`` ([D6]): only uppercase bases count.  Both
  packers and ``hpgq``'s spec read the knob at import, so each mode runs
  in a subprocess of its own, over ``tests/test_report.py``'s lowercase
  corpus (400 reads of 50-80 bp, 30% lowercase, seed 31) and its twin with
  Ns (so that a lowercase ``n`` meets the max-N screen).  In each mode the
  port's ``stats --kmers``, ``filter`` and ``cgr`` (k=4) on the CPU equal
  ``hpgq_torch.oracle`` (counters, output bytes, tables) and ``hpgq`` on
  the CPU; strict counts fall below folded ones.
* ``HPGQ_STRICT_EMPTY=1``: the port's twin of
  ``tests/test_report.py::test_empty_input_summary_modes``.
"""

import json
import os
import subprocess
import sys

from hpgq_torch.core.counters import StatsCounters
from hpgq_torch.options import StatsOptions
from hpgq_torch.report.stats_report import stats_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPORA = {  # tests/test_report.py:194's corpus, and with Ns
    "lowercase": dict(min_len=50, max_len=80, lowercase_prob=0.3, seed=31),
    "lowercase_n": dict(min_len=50, max_len=80, lowercase_prob=0.3, seed=31,
                        n_prob=0.05),
}
FILTER = dict(read_quality_range=(20, 60), max_N=2)

_MODE_RUN = r"""
import json, os, sys
repo, out = sys.argv[1], sys.argv[2]
sys.path[:0] = [repo, os.path.join(repo, "tests")]
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import hpgq
import hpgq_torch
from gen import make_fastq
from hpgq_torch import oracle

corpora, filt = json.loads(sys.argv[3]), json.loads(sys.argv[4])
filt["read_quality_range"] = tuple(filt["read_quality_range"])
res = {}
for name, kw in corpora.items():
    fq = os.path.join(out, name + ".fq")
    records = make_fastq(fq, 400, **kw)
    d = {s: os.path.join(out, name, s) for s in ("port", "hpgq", "fp", "fh",
                                                  "cp", "ch")}
    for p in d.values():
        os.makedirs(p)
    # stats --kmers
    got = hpgq_torch.stats(fq, outdir=d["port"], kmers=True, device="cpu")
    oracle.assert_counters_equal(got, oracle.reference_stats(records,
                                                             kmers=True),
                                 name + ": port stats vs its oracle")
    oracle.assert_counters_equal(got, hpgq.stats(fq, outdir=d["hpgq"],
                                                 kmers=True),
                                 name + ": port stats vs hpgq")
    # filter: both files, byte for byte
    fp = hpgq_torch.filter_reads(fq, outdir=d["fp"], device="cpu", **filt)
    fh = hpgq.filter_reads(fq, outdir=d["fh"], **filt)
    ok = oracle.reference_verdicts(records, **filt)
    for key, sel in (("passed_filename", ok), ("failed_filename", ~ok)):
        mine = open(fp[key], "rb").read()
        assert mine == oracle.fastq_bytes(records, sel), (name, key, "oracle")
        assert mine == open(fh[key], "rb").read(), (name, key, "hpgq")
    # cgr k=4
    cp = hpgq_torch.cgr(fq, outdir=d["cp"], k=4, device="cpu")
    ch = hpgq.cgr(fq, outdir=d["ch"], k=4)
    ts, tq, words = oracle.reference_cgr(records, 4)
    for got_c, who in ((ch, "hpgq"), ((ts, tq, words), "oracle")):
        if isinstance(got_c, dict):
            got_c = (got_c["table_seq"], got_c["table_q"],
                     got_c["fq_word_count"])
        assert np.array_equal(cp["table_seq"], got_c[0]), (name, who)
        assert np.array_equal(cp["table_q"], got_c[1]), (name, who)
        assert cp["fq_word_count"] == got_c[2], (name, who)
    res[name] = {"acgtn": got.num_As + got.num_Cs + got.num_Gs + got.num_Ts
                 + got.num_Ns, "Ns": got.num_Ns,
                 "passed": int(fp["num_passed"]),
                 "words": int(cp["fq_word_count"])}
print("RESULT " + json.dumps(res))
"""


def _run_mode(tmp_path, strict: bool) -> dict:
    env = dict(os.environ, HPGQ_CHARTS="off")
    env.pop("HPGQ_STRICT_CASE", None)
    if strict:
        env["HPGQ_STRICT_CASE"] = "1"
    out = tmp_path / ("strict" if strict else "folded")
    out.mkdir()
    r = subprocess.run(
        [sys.executable, "-c", _MODE_RUN, REPO, str(out), json.dumps(CORPORA),
         json.dumps(FILTER)], capture_output=True, text=True, env=env,
        timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(r.stdout.split("RESULT ", 1)[1])


def test_strict_case_port_equals_oracle_and_hpgq(tmp_path):
    """In both modes the port equals its oracle and ``hpgq`` (inside each
    subprocess); under the knob lowercase bases leave the base counts,
    lowercase ``n`` leaves the N count and stops failing the max-N screen,
    and lowercase bases break CGR words."""
    folded, strict = _run_mode(tmp_path, False), _run_mode(tmp_path, True)
    for name in CORPORA:
        f, s = folded[name], strict[name]
        assert 0 < s["acgtn"] < f["acgtn"], name
        assert 0 < s["words"] < f["words"], name
    f, s = folded["lowercase_n"], strict["lowercase_n"]
    assert s["Ns"] < f["Ns"] and s["passed"] > f["passed"]
    assert folded["lowercase"]["Ns"] == strict["lowercase"]["Ns"] == 0


def test_empty_input_summary_modes(tmp_path, monkeypatch):
    """Zero processed reads in the port's report writer: the default mode
    writes the explicit empty summary; ``HPGQ_STRICT_EMPTY=1`` writes the
    reference's unguarded bytes (``tests/golden/empty_strict``), and the
    full writer set like the reference."""
    fq = str(tmp_path / "empty.fq")
    open(fq, "wb").close()
    counters = StatsCounters(phred=33)
    opts = StatsOptions(in_filename=fq, out_dirname=str(tmp_path))

    monkeypatch.delenv("HPGQ_STRICT_EMPTY", raising=False)
    stats_report(counters, opts)
    default = open(fq + ".summary.txt").read()
    assert "Number of reads: 0" in default
    assert "no reads processed" in default

    monkeypatch.setenv("HPGQ_STRICT_EMPTY", "1")
    stats_report(counters, opts)
    golden = os.path.join(REPO, "tests", "golden", "empty_strict",
                          "empty.fq.summary.txt")
    assert open(fq + ".summary.txt", "rb").read() == open(golden, "rb").read()
    assert os.path.exists(fq + ".length.histogram.data")
    assert os.path.getsize(fq + ".length.histogram.data") == 0
