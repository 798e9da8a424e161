"""The ``stats`` command with the configuration's inline filter: one pass,
and the comparison that decides ``correct``.

A pass is ``hpgq_torch.stats`` over the file (sharded where the traffic
says so); with the harness's timers it is the runner that call drives,
``run_stats`` or ``run_sharded(run_stats_sharded, ...)``, given them.

Every pass of a run, the warm one too, returns the program's counters;
each is held against the plain reference's counters of the same records
(:mod:`benchmark.reference.stats`), and the report files the last pass
left are held against the reference's report of them
(:mod:`benchmark.reference.report`).  The numbers compared, each with the
limit a cell's ``benchmark/checks/<cell>.json`` gives it:

``counter_fields_off``
    integer counters (11 scalars and 6 arrays a pass) that differ from the
    reference's, summed over the passes; exact, limit 0;
``acc_quality_gap``
    the widest gap of ``acc_quality`` (the sum of each passing read's mean
    quality) from the reference's, relative, over the passes;
``report_files_off``
    report files (``summary.txt``, ``.data``, ``.gnuplot``) that are
    missing, extra or not byte-equal; exact, limit 0;
``passes_unchecked``
    passes run that returned no counters; exact, limit 0.

:func:`control` reads the same numbers for each control: the reference
put in the program's place with one float of ``acc_quality`` computed one
precision step lower (:data:`benchmark.reference.stats.CONTROLS`: the
sum in float32, or each read's mean in bfloat16).
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.reference.report import report_files
from benchmark.reference.stats import (ARRAYS, CONTROLS, SCALARS, lowered,
                                       reference_stats)

NAMES = ("counter_fields_off", "acc_quality_gap", "report_files_off",
         "passes_unchecked")


def _keywords(config: dict) -> dict:
    f = config["filter"]
    return {"read_length_range": tuple(f["read_length_range"]),
            "read_quality_range": tuple(f["read_quality_range"]),
            "max_N": f["max_N"]}


def one_pass(runner, path: str, outdir: str, timers=None):
    """One pass on ``runner.device``: the API call, or with ``timers`` the
    runner it calls, given the timers."""
    import hpgq_torch

    sharded = bool(runner.cell.traffic.get("sharded"))
    keywords = _keywords(runner.cell.config)
    if timers is None:
        return hpgq_torch.stats(path, outdir=outdir, device=runner.device,
                                sharded=sharded, **keywords)
    from hpgq_torch.api import filter_criteria
    from hpgq_torch.dist.launch import run_sharded
    from hpgq_torch.dist.run_dist import run_stats_sharded
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.pipeline.run import run_stats

    opts = StatsOptions(in_filename=path, out_dirname=outdir,
                        quality_encoding_name="phred33",
                        criteria=filter_criteria(**keywords),
                        filter_on=True, sharded=sharded)
    os.makedirs(outdir, exist_ok=True)
    if sharded:
        return run_sharded(run_stats_sharded, opts, timers, runner.device)
    return run_stats(opts, timers, report=True, device=runner.device)


def fields_off(got, want) -> int:
    """How many integer counters of ``got`` differ from ``want``'s (arrays
    compared after zero-padding to a common width)."""
    off = sum(getattr(got, k) != getattr(want, k) for k in SCALARS)
    for k in ARRAYS:
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        m = max(a.shape[-1], b.shape[-1])
        pad = lambda x: np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, m - x.shape[-1])])
        off += a.shape[:-1] != b.shape[:-1] or not np.array_equal(pad(a), pad(b))
    return int(off)


def quality_gap(got, want) -> float:
    return abs(float(got.acc_quality) - want.acc_quality) / max(1.0, abs(want.acc_quality))


def report_off(out_dir: str, want_files: dict) -> int:
    """Report files in ``out_dir`` (PNG charts aside) that differ from
    ``want_files``, or are on one side only."""
    have = {f for f in os.listdir(out_dir) if not f.endswith(".png")} \
        if os.path.isdir(out_dir) else set()
    off = 0
    for name in have | set(want_files):
        if name not in have or name not in want_files:
            off += 1
            continue
        with open(os.path.join(out_dir, name), "rb") as f:
            off += f.read() != want_files[name]
    return off


def _numbers(limits, off, gap, files, unchecked) -> dict:
    values = dict(zip(NAMES, (off, gap, files, unchecked)))
    return {k: {"value": values[k], "limit": limits[k]} for k in NAMES}


def judge(cell, corpus, results, passes_run: int, out_dir: str):
    """``(numbers, failed passes)`` of a run whose passes returned
    ``results`` (one per pass run, in order) and left their report in
    ``out_dir``."""
    phred = int(cell.config.get("phred", 33))
    want = reference_stats(corpus, cell.config["filter"], phred)
    off, gap, bad = 0, 0.0, []
    for got in results:
        if got is None:
            bad.append(True)
            continue
        n, g = fields_off(got, want), quality_gap(got, want)
        off, gap = off + n, max(gap, g)
        bad.append(n > 0 or g > cell.limits["acc_quality_gap"])
    files = report_off(out_dir, report_files(want, corpus.path, out_dir,
                                             cell.config["filter"].get("max_N")))
    if files and bad:  # the report is the last pass's
        bad[-1] = True
    unchecked = passes_run - sum(r is not None for r in results)
    failed = sum(bad) + max(0, passes_run - len(results))
    return _numbers(cell.limits, off, gap, files, unchecked), failed


def control(cell, corpus, out_dir: str = "out") -> dict:
    """``{control: numbers}`` on ``corpus`` for each control: the reference
    with one float one precision step lower, and the report of its
    counters, in the program's place."""
    phred = int(cell.config.get("phred", 33))
    want = reference_stats(corpus, cell.config["filter"], phred)
    max_n = cell.config["filter"].get("max_N")
    ours = report_files(want, corpus.path, out_dir, max_n)
    out = {}
    for name in CONTROLS:
        low = lowered(want, name)
        theirs = report_files(low, corpus.path, out_dir, max_n)
        files = sum(theirs.get(k) != v for k, v in ours.items())
        out[name] = _numbers(cell.limits, fields_off(low, want),
                             quality_gap(low, want), files, 0)
    return out
