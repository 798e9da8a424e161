"""The ``stats`` command over a pair of files (R1, R2) with the
configuration's inline filter: one pass, and the comparison that decides
``correct``.

A pass is ``hpgq_torch.stats(path, path2, ...)``, where ``path2`` is the
file of mate 2 beside ``path`` (:func:`benchmark.traffic.generate_pe.
mate2_path`); with the harness's timers it is ``run_stats`` given them.
It returns a pair of counters, one a mate, and leaves one report a mate
in the output directory, each named after its mate's file.

Every pass's pair of counters is held against the plain reference's
(:mod:`benchmark.reference.paired`: a pair counts only when both mates
pass, each mate's statistics over the pairs that count, the pair tallies
in both), and the report files the last pass left against the reference's
report of each mate (:mod:`benchmark.reference.report`).  The numbers
compared are :mod:`benchmark.commands.stats`'s, over both mates:

``counter_fields_off``
    integer counters that differ from the reference's, summed over the
    mates and the passes; exact, limit 0;
``acc_quality_gap``
    the wider of the mates' relative gaps of ``acc_quality``, the widest
    over the passes;
``report_files_off``
    report files of either mate that are missing, extra or not
    byte-equal; exact, limit 0;
``passes_unchecked``
    passes run that returned no counters; exact, limit 0.

:func:`control` reads the same numbers for each control: the reference
with one float of each mate's ``acc_quality`` computed one precision step
lower (:data:`benchmark.reference.stats.CONTROLS`).
"""

from __future__ import annotations

import os

from benchmark.commands.stats import (_keywords, _numbers, fields_off,
                                      quality_gap, report_off)
from benchmark.reference.paired import reference_paired_stats
from benchmark.reference.report import report_files
from benchmark.reference.stats import CONTROLS, lowered
from benchmark.traffic.generate_pe import mate2_path


def one_pass(runner, path: str, outdir: str, timers=None):
    """One pass on ``runner.device`` over ``path`` and its mate: the API
    call, or with ``timers`` the runner it calls, given the timers."""
    import hpgq_torch

    keywords = _keywords(runner.cell.config)
    path2 = mate2_path(path)
    if timers is None:
        return hpgq_torch.stats(path, path2, outdir=outdir,
                                device=runner.device, **keywords)
    from hpgq_torch.api import filter_criteria
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.pipeline.run import run_stats

    opts = StatsOptions(in_filename=path, in_filename2=path2,
                        out_dirname=outdir, quality_encoding_name="phred33",
                        criteria=filter_criteria(**keywords), filter_on=True)
    os.makedirs(outdir, exist_ok=True)
    return run_stats(opts, timers, report=True, device=runner.device)


def _want(cell, corpus):
    phred = int(cell.config.get("phred", 33))
    return reference_paired_stats(corpus.mate1, corpus.mate2,
                                  cell.config["filter"], phred)


def _report(pair, corpus, out_dir: str, max_n) -> dict:
    """Both mates' report files, each named after its mate's file."""
    files = {}
    for c, mate in zip(pair, (corpus.mate1, corpus.mate2)):
        files.update(report_files(c, mate.path, out_dir, max_n))
    return files


def _pair_numbers(got, want):
    """(integer fields off, widest quality gap) of a pass's pair."""
    off = sum(fields_off(g, w) for g, w in zip(got, want))
    gap = max(quality_gap(g, w) for g, w in zip(got, want))
    return off, gap


def judge(cell, corpus, results, passes_run: int, out_dir: str):
    """``(numbers, failed passes)`` of a run whose passes returned
    ``results`` (one pair of counters per pass run, in order) and left
    their reports in ``out_dir``."""
    want = _want(cell, corpus)
    off, gap, bad = 0, 0.0, []
    for got in results:
        if got is None:
            bad.append(True)
            continue
        n, g = _pair_numbers(got, want)
        off, gap = off + n, max(gap, g)
        bad.append(n > 0 or g > cell.limits["acc_quality_gap"])
    files = report_off(out_dir, _report(want, corpus, out_dir,
                                        cell.config["filter"].get("max_N")))
    if files and bad:  # the reports are the last pass's
        bad[-1] = True
    unchecked = passes_run - sum(r is not None for r in results)
    failed = sum(bad) + max(0, passes_run - len(results))
    return _numbers(cell.limits, off, gap, files, unchecked), failed


def control(cell, corpus, out_dir: str = "out") -> dict:
    """``{control: numbers}`` on ``corpus`` for each control: the reference
    with one float of each mate one precision step lower, and the reports
    of its counters, in the program's place."""
    want = _want(cell, corpus)
    max_n = cell.config["filter"].get("max_N")
    ours = _report(want, corpus, out_dir, max_n)
    out = {}
    for name in CONTROLS:
        low = tuple(lowered(c, name) for c in want)
        theirs = _report(low, corpus, out_dir, max_n)
        files = sum(theirs.get(k) != v for k, v in ours.items())
        off, gap = _pair_numbers(low, want)
        out[name] = _numbers(cell.limits, off, gap, files, 0)
    return out
