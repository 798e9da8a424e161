#!/usr/bin/env python3
"""Smoke run of the hpgq_torch port on one CUDA card.

    python3 chip_smoke.py            # phases 1-5 and 7-15 (one NVIDIA GPU)
    python3 chip_smoke.py --phases 1,2,3

Phases, each printing its own lines:

1. The card: ``nvidia-smi`` name and power limit, torch's device name.
2. The build: compile the K1 and K2 kernels from
   ``hpgq_torch/kernels/csrc`` (one nvcc per source, in parallel).
3. K1 against its plain PyTorch twin on the same CUDA tensors.  The plain
   entry: the 131072 x 128 main-path batch (also with the k-mer
   ride-along), ragged, all-invalid, 4096-wide, empty and any-byte-code
   batches.  The 2u entry against ``wire_unbits2u`` + the twin: the
   131072 x 52-byte main-path wire (78k exceptions), ragged ``n_valid``
   with all-N rows, every base N, 37, 150 and 1500 bp, and an empty
   batch.  Five filter
   settings each.  Integer fields and the pass mask must match exactly;
   ``acc_quality`` to 1e-4 relative (per-tile f32 sums are added in
   another order than torch's).  Then both entries timed against the
   twin: device ms (the profiler's kernel records, and CUDA events
   around the raw launches alone, which the row takes where the trace is
   incomplete; never the wrapper's time), bytes needed, GB/s, the bound
   and its share.
4. End to end: ``hpgq_torch.stats`` with the bench's inline filter over a
   generated 1,000,000 x 100 bp RTA3-binned corpus on ``cuda``, held
   against ``hpgq_torch.oracle``, a plain numpy reference computed from
   the generated reads themselves (every integer counter exact,
   ``acc_quality`` to 1e-3); every batch on the 2u tier must go to K1's
   2u entry, none decoded on the card.
5. The other wire tiers (2c, 2q, 6-bit, 7-bit, plain) on 200k reads of
   60-150 bp, each held against the reference, and one ``kmers=True`` run
   (K1 + the k-mer ride-along, k-mer tables exact).
7. K2 against its plain twin on CUDA tensors, from lcap 4224 to 66048,
   ragged, empty, all-invalid and any-byte-code batches, one to seven
   reads with lengths on and off the 512-column tile edges, a width that
   is no multiple of 16, five filter settings (and a minimum quality
   alone at 24576, where the MAX sentinel times the length passes int32;
   the legacy quality window [D8] across the 512-column tile edge, 500-900,
   and past every read's end, 4000-40000), k-mers off and on; every
   integer field and the pass mask exact,
   ``acc_quality`` to 1e-4.  Also at phase 8's batch shape (512 x 89472,
   mixed lengths, padding rows), on the 512 x 32768 timed batch, with
   the NanoFilt-style filter too, and at the block shape of the
   benchmark's Nanopore cell (1280 x 126208: 1,250 reads of log-normal
   lengths up to 126,106 and 30 padding rows, per-read mean qualities,
   the cell's filter; K2's launches counted from zero just before it).
   Then K2 timed against the twin on the last three, as in phase 3.
8. Long reads end to end: about 10,000 reads of 2-30 kb plus a few dozen
   of 66-90 kb (lcap past 65536), unbinned qualities; ``hpgq_torch.stats``
   with ``kmers=True``, with a NanoFilt-style filter and with a mean
   quality screen over the [D8] window 500-900 (``--start-quality-nt`` /
   ``--end-quality-nt``), each held against the reference (k-mer tables
   too), with K2 launches required.
9. Paired stats: 1,000,000 pairs of 2 x 100 bp (mate 1 is phase 4's
   corpus, mate 2 the same recipe with seed 8); ``hpgq_torch.stats(m1,
   m2)`` with the bench filter and with none, both mates held against
   ``oracle.reference_paired_stats`` (statistics over the pairs where both
   mates pass, tallies per pair), every mate batch on the 2u tier: with
   the filter decoded for the pair verdict and sent to K1's plain entry,
   without it sent to the 2u entry.  Then 2,008 pairs of long reads with
   the NanoFilt-style filter: every mate batch launches K2, both mates
   equal to the reference.
10. Filter: ``hpgq_torch.filter_reads`` single-end over phase 4's corpus
    (2c tier), paired over phase 9's pairs, and with the NanoFilt-style
    thresholds over phase 8's long reads (qn8 tier); every output file
    byte-equal to the records ``oracle.reference_verdicts`` selects, every
    verdict batch on the card.

11. Edit and prepro: ``hpgq_torch.edit`` over phase 4's corpus with
    ``bench.py``'s ``EDIT_CRIT`` (trim only) and with the golden settings
    (two windows and a post-filter), paired over phase 9's pairs,
    ``prepro`` (5 and 3 bases at quality 27-64), and over phase 8's long
    reads with a 50-base right window and the NanoFilt-style post-filter:
    every output file byte-equal to ``oracle.trimmed_fastq_bytes`` of
    ``oracle.reference_trims`` (and the post-filter's selection), the
    counts equal, every batch on the card.  Then ``stats`` over the
    trim-only and the long-read ``edit.fq`` (the ``bench.py:530-551``
    chain), held against ``reference_stats`` over the kept trimmed reads:
    the first must launch K1, the second K2.
12. CGR: ``hpgq_torch.cgr`` at k=7 with ``write_gs`` over phase 4's
    corpus and over phase 9's pairs (one signature): the tables, the word
    count and the PGM and ``.gs`` bytes equal to ``oracle.reference_cgr``
    and what ``report.pgm`` writes from it; a second run against its own
    ``.gs`` gives a zero diff.  ``cgr_batch_tables`` on the card at k=10
    and on the poly-A batch whose quality cell passes 2^31, exact.
13. ``--sharded``: ``hpgq_torch.stats(..., sharded=True)`` with the bench
    filter over phase 4's corpus at world size 1: in this process with no
    launcher (no process group), in one subprocess with torch's launcher
    variables (a gloo group of one over ``env://``), and as one rank
    started by the port's launcher, ``hpgq_torch.dist.launch`` (a first
    and a warm pass); the legacy ``python -m hpgq_torch --qc --filter``
    run, whose ``.valid``/``.invalid`` files equal phase 10's selection
    and whose two summaries equal the reports of the reference over each;
    ``python -m hpgq_torch stats --sharded`` with no launcher variables,
    which must log one process on one card (a rank per card on several)
    and write the reference's report; then ranks started by the launcher
    (two sharing the card, one per card on several), each a new
    interpreter that imports this script first (which blocks jax and
    ``hpgq`` there): ``stats``, paired ``stats`` (phase 9's pairs),
    long-read ``stats`` (phase 8's, K2), ``filter`` and ``edit`` (the CLI,
    concatenated outputs byte-equal to the reference's), ``cgr`` k=7
    (tables, PGM and ``.gs``); every rank equal, rank 0 alone writes the
    reports; and a launch whose rank 1 raises, whose parent must exit
    non-zero within 60 s with no rank left.  Reads/s of one warm pass at
    world size 1 (in this process and through the launcher) and at the
    ranks', the seconds from each launch to its first batch, and rank 0's
    start-up split by stage at world size 1 and at the ranks' (the
    launcher's stamps: spawn, imports, join, CUDA context, kernel library
    and packer, first batch; their sum must be rank 0's own
    launch-to-first-batch time within 0.1 s).
    ``--ranks N`` runs N ranks, round-robin over the cards.
14. Inputs: phase 4's corpus as plain gzip and as BGZF, ``stats`` with the
    bench filter over each (counters equal to the reference, every report
    file equal to the plain input's but where it names the input), ``cgr``
    k=7 over the gzip file (``BASELINE.json`` config 5: tables, PGM and
    ``.gs`` against the reference), ``filter`` over the BGZF file (bytes
    against the reference's selection); ``tools/validate_device.py``'s
    ``check_coalesced`` (100,000 reads of 100 bp in blocks of an explicit
    10,000, ``HPGQ_COALESCE=131072``: counters equal to the reference, fewer
    K1 launches than reader blocks); ``stats`` with and without
    ``--profile-dir`` (counters and report bytes equal, the trace holds
    K1's kernel) and ``filter`` with it.
15. Fuzz: 12 rounds of ``tools/fuzz_torch.py`` (seed 4, every command
    among them, sharded, paired and interrupted rounds too) on the card,
    each held against the reference.

There is no phase 6 or 16: ``benchmark/`` measures the port's speed end
to end, and ``tools/ab_torch.py`` runs the A/B studies.  Phases 3 and 7
time each kernel alone for the kernels line; phase 13 prints the rates of
its checked warm passes beside the start-up split.

Phases 9-14 reuse the corpora of phases 4 and 8, and write them when
those phases are not selected; each phase prints its seconds (PERF.md
§5 keeps the last default run's, on an NVIDIA H100 80GB HBM3 at 700 W).
Alone, a phase pays for the corpora it needs: ``--phases 9,10`` took
about 135 s of command time, ``--phases 11,12`` about 235 s,
``--phases 14,15`` 185 s (the 1M-read corpus, then its gzip and BGZF
files).  The
kernels line gives K1's plain and 2u entries and K2 with their launches
on the paths that drive them (phase 4, 9's unfiltered run and 13's
sharded stats, 14's gzip, BGZF and profiled stats for the 2u entry;
phases 5, 9's filtered run, 11's stats over the trimmed short reads, 13's
sharded paired stats and 14's coalesced run for the plain entry; phase 8,
9's long pairs, 11's stats over the trimmed long reads and 13's sharded
long-read stats for K2; phase 15's fuzz rounds for either K1 entry).

Imports nothing of jax and nothing of the JAX package ``hpgq``: the run
and every rank it starts block ``import jax`` and ``import hpgq``, so a
path that needed either would fail here.  Any failure exits non-zero
before the result lines; the last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCKED = ("jax", "jaxlib", "hpgq")  # the port needs none of them
if __name__ == "__mp_main__":
    # a rank that hpgq_torch.dist.launch started (spawn imports this script
    # under that name before the rank's target): block them there too
    for _name in BLOCKED:
        sys.modules[_name] = None
TILE = 64  # rows per K1 block, for the ragged shapes

INT_KEYS = ("num_reads", "acc_length", "min_length", "max_length",
            "base_totals", "length_hist", "quality_hist", "gc_hist",
            "cov_per_nt", "qual_per_nt", "base_per_nt", "_passed_mask")
OPTIONAL_KEYS = ("_num_passed", "_num_failed", "kmer_counts", "kmer_per_nt")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print("[%s] %s" % (phase, msg), flush=True)


# ---------------------------------------------------------------- inputs

def make_batch(B, L, seed, lens=None, valid_frac=1.0, binned=True,
               any_byte=False):
    """(codes int8, quals uint8, lens int32, valid bool) numpy, packer
    layout: codes 5 / quals 0 beyond each read's length; with
    ``any_byte`` a third of the codes take values 6..127, which the packers
    never write (the kernels' exact path for such bytes)."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(0, L + 1, size=B)
    lens = np.asarray(lens, dtype=np.int32)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.005] = 4
    codes[rng.random((B, L)) < 0.001] = 5
    if any_byte:
        wild = rng.random((B, L)) < 0.33
        codes[wild] = rng.integers(6, 128, size=int(wild.sum()))
    if binned:
        bins = np.array([2, 12, 23, 37]) + 33
        quals = bins[rng.integers(0, 4, size=(B, L))].astype(np.uint8)
    else:
        quals = rng.integers(33, 75, size=(B, L)).astype(np.uint8)
    inside = np.arange(L)[None, :] < lens[:, None]
    codes = np.where(inside, codes, np.int8(5))
    quals = np.where(inside, quals, np.uint8(0))
    valid = rng.random(B) < valid_frac
    return codes, quals, lens, valid


BENCH_FILTER = dict(read_length_range=(50, 200), read_quality_range=(20, 60),
                    max_N=2)  # bench.py:58-61
FILTERS = {  # the thresholds of hpgq_torch.stats, by setting
    "none": {},
    "bench": BENCH_FILTER,
    "all checks": dict(BENCH_FILTER, max_out_of_quality=30,
                       left=(8, (10, 60)), right=(8, (10, 60)),
                       quality_window=(12, 60)),
    "windows": dict(left=(8, (10, 60)), right=(8, (10, 60))),
    "out_of_quality": dict(read_quality_range=(15, 40),
                           max_out_of_quality=30),
}


# ---------------------------------------------------------------- phase 3

def compare_partials(k, p, label):
    """Absolute ``acc_quality`` difference (the integer fields must be
    equal, so it is the max over all fields); raises on a mismatch."""
    import torch

    check(set(k) == set(p), "%s: kernel keys %s, plain twin keys %s"
          % (label, sorted(k), sorted(p)))
    for key in INT_KEYS + tuple(x for x in OPTIONAL_KEYS if x in p):
        a, b = k[key].cpu(), p[key].cpu()
        if not torch.equal(a.to(torch.int64), b.to(torch.int64)):
            raise SmokeFailure("%s: the kernel and the plain twin differ in "
                               "%s" % (label, key))
    aq_k = float(k["acc_quality"])
    aq_p = float(p["acc_quality"])
    err = abs(aq_k - aq_p)
    check(err <= 1e-4 * max(1.0, abs(aq_p)),
          "%s: acc_quality %r vs plain %r" % (label, aq_k, aq_p))
    return err


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def reset_counts():
    """Zero every launch and wire counter, just before a path is driven."""
    from hpgq_torch.kernels import stats_cuda, step

    stats_cuda.LAUNCHES = stats_cuda.LAUNCHES_2U = stats_cuda.LAUNCHES_K2 = 0
    step.WIRE_BATCHES.clear()
    step.DECODED.clear()


def launch_counts():
    """Launches per kernel since :func:`reset_counts`."""
    from hpgq_torch.kernels import stats_cuda

    return {"K1": stats_cuda.LAUNCHES, "K1 2u": stats_cuda.LAUNCHES_2U,
            "K2": stats_cuda.LAUNCHES_K2}


# H100 SXM peaks: HBM bytes/s from NVIDIA's datasheet, and the 32-bit
# integer instruction rate the kernels' work runs on: 64 results per clock
# per SM for integer add, compare, logic and shift on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput),
# x 132 SMs x 1.98 GHz boost clock
PEAK_BYTES = 3.35e12
PEAK_INT_OPS = 64 * 132 * 1.98e9
OPS_PER_BASE = 10  # integer operations per base the stats need, at least


def output_bytes(B, lcap, n_f32):
    """Bytes of every output of one call: the int64 partials, the f32
    slots and the pass mask."""
    return 8 * (8 + lcap + 1 + 256 + 101 + 7 * lcap + 5) + 4 * n_f32 + B


def bound(nbytes, nbases):
    """(bound ms, what bounds it): the larger of the bytes over HBM and the
    integer operations over the SMs' 32-bit integer peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = OPS_PER_BASE * nbases / PEAK_INT_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(phase, label, kernel_fn, plain_fn, prepare, name, nbytes,
                nbases, launches_per_call=1):
    """The kernel against its plain twin on the same inputs: CUDA events in
    turns (plain, kernel, kernel, plain) around the wrapper and the twin,
    then the kernel's device time alone, by two timers: the profiler's
    kernel records (:func:`kernel_profiler_ms`) and CUDA events around the
    raw launches of ``prepare()`` (:func:`kernel_event_ms`).  The row
    takes the profiler's time, else the events'.  Prints ms, bytes, GB/s,
    the bound and its share.  The wrapper's time goes in ``wrapper_ms``
    only: where neither timer gives the kernel's time, ``ms`` is None, the
    line says why, and no share is computed."""
    ms_plain = ms = None
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "kernel":
            t = cuda_time_ms(kernel_fn)
            ms = t if ms is None else min(ms, t)
        else:
            t = cuda_time_ms(plain_fn)
            ms_plain = t if ms_plain is None else min(ms_plain, t)
    prof_ms = kernel_profiler_ms(kernel_fn, launches_per_call, name=name)
    try:
        ev_ms = kernel_event_ms(prepare)
        events = "%.4f" % ev_ms
    except Exception as e:  # the line says why; the phase goes on
        ev_ms, events = None, "failed (%s: %s)" % (type(e).__name__, e)
    k_ms = prof_ms if prof_ms is not None else ev_ms
    timers = ("torch.profiler %s, CUDA events around the raw launches %s"
              % ("an incomplete trace" if prof_ms is None
                 else "%.4f" % prof_ms, events))
    b_ms, b_by = bound(nbytes, nbases)
    if k_ms is None:
        kernel = "device time not measured (%s); bound %.4f ms (%s), " \
                 "share not computed" % (timers, b_ms, b_by)
    else:
        kernel = ("device %.4f ms per call (%s; %d launch(es)); %.1f GB/s; "
                  "bound %.4f ms (%s), %.1f%% of the bound"
                  % (k_ms, timers, launches_per_call, nbytes / k_ms / 1e6,
                     b_ms, b_by, 100 * b_ms / k_ms))
    say(phase, "%s: wrapper %.4f ms per call, plain twin %.4f ms (CUDA "
        "events, best of 2 turns of 20 calls); %d bytes needed; %s"
        % (label, ms, ms_plain, nbytes, kernel))
    return {"ms": k_ms, "wrapper_ms": ms, "plain_ms": ms_plain,
            "bound_ms": b_ms, "bound_by": b_by}


def kernel_event_ms(prepare, iters=20):
    """Device ms per call from CUDA events around ``iters`` raw launches
    alone, on the launching stream: ``prepare()`` (a ``stats_cuda.prepare_*``
    call) gives each launch its own zeroed outputs beforehand, and a sleep
    on the card keeps it busy while the launches are queued, so that the
    host's queueing is not timed."""
    import torch

    launches = [prepare()[0] for _ in range(iters + 1)]
    launches[0]()  # the warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for launch in launches[1:]:
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_2u(B, L, n_valid, seed, all_n_every=0):
    """A 2u batch (numpy), from :func:`make_batch` rows of the uniform
    length ``L`` (binned qualities, N and OTHER codes), the first
    ``n_valid`` rows valid; every ``all_n_every``-th row all N."""
    from hpgq_torch.io.packer import wire_bitpack2u_np

    codes, quals, lens, _ = make_batch(B, -(-L // 128) * 128, seed,
                                       lens=np.full(B, L))
    if all_n_every:
        codes[::all_n_every, :L] = 4
    valid = np.arange(B) < n_valid
    return wire_bitpack2u_np(codes, quals, lens, valid)


def phase_kernel(dev):
    """K1's plain and 2u entries against the plain twin; returns the
    kernels-line fields of both."""
    import torch

    from hpgq_torch.api import filter_criteria
    from hpgq_torch.kernels.stats_cuda import (
        batch_partials_cuda,
        batch_partials_cuda_2u,
        make_batch_partials,
        prepare_k1,
        prepare_k1_2u,
    )
    from hpgq_torch.kernels.stats_torch import fused_partials
    from hpgq_torch.kernels.wire_torch import pad_wire_cols, wire_unbits2u

    crits = {name: filter_criteria(**kw) for name, kw in FILTERS.items()}
    cases = [
        # (label, B, L, lcap, lens, valid_frac)
        ("main 131072x128 len100", 131072, 128, 128, np.full(131072, 100),
         1.0),
        ("ragged B=1000 L=200 lcap=384", 1000, 200, 384, None, 0.9),
        ("ragged B=70 L=37 lcap=128", TILE + 6, 37, 128, None, 0.8),
        ("all rows invalid", 300, 128, 128, None, 0.0),
        ("long rows 40x4096 lcap=4096", 40, 4096, 4096, None, 0.9),
        ("empty 0x128", 0, 128, 128, None, 1.0),
        ("codes of any byte 2000x128", 2000, 128, 128, None, 0.9),
    ]
    err = {"K1": 0.0, "K1 2u": 0.0}
    for ci, (label, B, L, lcap, lens, vf) in enumerate(cases):
        arrs = make_batch(B, L, seed=100 + ci, lens=lens, valid_frac=vf,
                          any_byte=label.startswith("codes of any"))
        if lens is None:
            arrs[2][:5] = 0  # length-0 rows
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        for name, crit in crits.items():
            k = batch_partials_cuda(*t, lcap, 33, crit)
            p = fused_partials(*t, lcap, 33, crit)
            torch.cuda.synchronize()
            err["K1"] = max(err["K1"], compare_partials(
                k, p, "%s / %s" % (label, name)))
        say("k1", "%s: K1 == plain twin for %d filter settings"
            % (label, len(crits)))

    def plain_2u(buf, exc, pal, n_valid, L, lcap, crit):
        codes, quals, lens, valid = wire_unbits2u(buf, exc, pal, n_valid,
                                                  L=L)
        codes, quals = pad_wire_cols(codes, quals, lcap)
        return fused_partials(codes, quals, lens, valid, lcap, 33, crit)

    cases_2u = [
        # (label, B, L, n_valid, all-N rows every)
        ("main 131072x52 bytes (L 100)", 131072, 100, 131072, 0),
        ("ragged n_valid 70000 of 81920, all-N rows", 81920, 100, 70000, 97),
        ("L 37, n_valid 1000 of 1024", 1024, 37, 1000, 0),
        ("L 150, n_valid 5 of 64", 64, 150, 5, 2),
        # every base N: a tile holds more exceptions than one window
        ("all rows all N, 256 x L 100", 256, 100, 256, 1),
        # past 1024 bases: two word passes per thread
        ("L 1500, n_valid 300 of 320", 320, 1500, 300, 0),
    ]
    wires = {}
    for ci, (label, B, L, n_valid, every) in enumerate(cases_2u):
        buf, exc, pal, nv = make_2u(B, L, n_valid, seed=150 + ci,
                                    all_n_every=every)
        wire = [torch.from_numpy(a).to(dev) for a in (buf, exc, pal)]
        wires[label] = (wire, nv, L)
        lcap = -(-L // 128) * 128
        n_exc = int((exc < (B * 2 * buf.shape[1]) << 1).sum())
        for name, crit in crits.items():
            k = batch_partials_cuda_2u(*wire, nv, L, lcap, 33, crit)
            p = plain_2u(*wire, nv, L, lcap, crit)
            torch.cuda.synchronize()
            err["K1 2u"] = max(err["K1 2u"], compare_partials(
                k, p, "2u %s / %s" % (label, name)))
        say("k1", "2u %s (%d exceptions): K1 2u entry == decode + plain "
            "twin for %d filter settings" % (label, n_exc, len(crits)))
    empty = [torch.zeros((0, 52), dtype=torch.uint8, device=dev),
             torch.zeros(8192, dtype=torch.int32, device=dev),
             torch.zeros(4, dtype=torch.uint8, device=dev)]
    for name, crit in crits.items():
        err["K1 2u"] = max(err["K1 2u"], compare_partials(
            batch_partials_cuda_2u(*empty, 0, 100, 128, 33, crit),
            plain_2u(*empty, 0, 100, 128, crit), "2u empty / " + name))
    say("k1", "2u empty batch: K1 2u entry == decode + plain twin")

    codes, quals, lens, valid = (torch.from_numpy(a).to(dev) for a in
                                 make_batch(131072, 128, seed=100,
                                            lens=np.full(131072, 100)))
    bench = crits["bench"]
    k = make_batch_partials(128, 33, bench, kmers_on=True)(codes, quals,
                                                            lens, valid)
    p = fused_partials(codes, quals, lens, valid, 128, 33, bench,
                       kmers_on=True)
    torch.cuda.synchronize()
    err["K1"] = max(err["K1"], compare_partials(k, p, "main + k-mers"))
    say("k1", "131072x128, bench filter, k-mers on: K1 + ride-along == plain "
        "twin (%d k-mers counted)" % int(k["kmer_counts"].sum()))

    B = 131072
    nbases = int(lens.clamp(max=128).sum())
    out = {"K1": time_kernel(
        "k1", "K1 plain entry, 131072x128 (len 100), bench filter",
        lambda: batch_partials_cuda(codes, quals, lens, valid, 128, 33,
                                    bench),
        lambda: fused_partials(codes, quals, lens, valid, 128, 33, bench),
        lambda: prepare_k1(codes, quals, lens, valid, 128, 33, bench),
        "stats_k1_kernel", 2 * nbases + 5 * B + output_bytes(B, 128, 2049),
        nbases)}
    wire, nv, L = wires["main 131072x52 bytes (L 100)"]
    n_exc = int((wire[1] < (B * 2 * wire[0].shape[1]) << 1).sum())
    out["K1 2u"] = time_kernel(
        "k1", "K1 2u entry, 131072x52 bytes (L 100, %d exceptions), bench "
        "filter" % n_exc,
        lambda: batch_partials_cuda_2u(*wire, nv, L, 128, 33, bench),
        lambda: plain_2u(*wire, nv, L, 128, bench),
        lambda: prepare_k1_2u(*wire, nv, L, 128, 33, bench),
        "stats_k1_kernel", wire[0].numel() + 4 * n_exc + 4
        + output_bytes(B, 128, 2049), nv * L)
    for key in out:
        out[key]["max_abs_err"] = err[key]
    return out


def kernel_profiler_ms(fn, launches, iters=20, name="stats_k1_kernel"):
    """Device time per call of ``fn`` spent in the kernels whose names
    contain ``name`` (profiler; K2 is two launches per call).  None when
    the trace does not hold every one of the ``launches`` per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace that lost kernel records is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if name in ev.key]
        if sum(ev.count for ev in evs) == launches * iters:
            us = sum(getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
                     for ev in evs)
            return us / iters / 1e3
        say("prof", "%s: %s kernel records in the trace, expected %d"
            % (name, {ev.key: ev.count for ev in evs}, launches * iters))
    return None


# ---------------------------------------------------------------- phases 4-5

def run_port(path, outdir, kw):
    import hpgq_torch

    return hpgq_torch.stats(path, outdir=outdir, device="cuda", **kw)


def cached_corpus(path, write):
    """``(path, records)`` of a corpus that ``write(path)`` writes (and
    returns the records of), written once per run."""
    if path not in _CORPUS:
        t0 = time.perf_counter()
        records = write(path)
        _CORPUS[path] = records
        say("corpus", "%s: %d reads, %d bytes, written in %.1f s"
            % (os.path.basename(path), len(records), os.path.getsize(path),
               time.perf_counter() - t0))
    return path, _CORPUS[path]


_CORPUS = {}


def bench_corpus(tmp, seed=7):
    """The bench corpus (bench.corpus), 1,000,000 x 100 bp RTA3-binned;
    ``seed=8`` makes the mate-2 file of phase 9."""
    from gen import make_fastq

    name = "bench_1000000_100_rta3%s.fq" % ("" if seed == 7 else "_s%d"
                                             % seed)
    return cached_corpus(os.path.join(tmp, name), lambda p: make_fastq(
        p, 1_000_000, min_len=100, max_len=100, n_prob=0.005, seed=seed,
        qual_bins=(2, 12, 23, 37)))


def phase_end_to_end(tmp):
    import torch

    from hpgq_torch.kernels import step
    from hpgq_torch.oracle import assert_counters_equal, reference_stats

    path, records = bench_corpus(tmp)
    out = tempfile.mkdtemp(dir=tmp)

    reset_counts()
    t0 = time.perf_counter()
    got = run_port(path, out, BENCH_FILTER)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = launch_counts()
    tiers = dict(step.WIRE_BATCHES)
    decoded = dict(step.DECODED)
    say("e2e", "cold pass %.3f s, launches %s, wire tiers %s, decoded %s"
        % (cold, launches, tiers, decoded))
    check(launches["K1 2u"] > 0, "the main path launched K1's 2u entry no "
          "time")
    check(tiers.get("2u", 0) == launches["K1 2u"],
          "every 2u batch must go to K1's 2u entry (tiers %s)" % tiers)
    check(not decoded.get(("cuda", "2u")), "the main path decoded a 2u "
          "batch on the card (%s)" % decoded)
    check(os.path.exists(os.path.join(out, os.path.basename(path)
                                      + ".summary.txt")),
          "no summary report written")

    t0 = time.perf_counter()
    want = reference_stats(records, **BENCH_FILTER)
    say("e2e", "single-CPU numpy reference over the generated reads %.2f s"
        % (time.perf_counter() - t0))
    assert_counters_equal(got, want, "1M x 100 bp")
    say("e2e", "port == reference: %d passed, %d failed, every integer "
        "counter exact, acc_quality rel diff %.3g" % (
            got.num_passed, got.num_failed,
            abs(got.acc_quality - want.acc_quality) / want.acc_quality))
    return launches["K1 2u"], got.num_passed


def phase_tiers(tmp):
    """The other wire tiers and a k-mer run; returns K1 plain-entry
    launches."""
    from gen import make_fastq
    from hpgq_torch.kernels import step
    from hpgq_torch.oracle import assert_counters_equal, reference_stats

    binned = os.path.join(tmp, "var_binned.fq")
    wide = os.path.join(tmp, "var_unbinned.fq")
    records_binned = make_fastq(binned, 200_000, min_len=60, max_len=150,
                                n_prob=0.01, seed=21,
                                qual_bins=(2, 12, 23, 37))
    want = {
        binned: records_binned,
        wide: make_fastq(wide, 200_000, min_len=60, max_len=150, n_prob=0.01,
                         seed=22),
    }
    want = {p: reference_stats(r, **BENCH_FILTER) for p, r in want.items()}
    runs = [  # (tier, corpus, environment)
        ("2c", binned, {}),
        ("2q", binned, {"HPGQ_WIRE2C": "0"}),
        ("6bit", wide, {}),
        ("7bit", wide, {"HPGQ_WIRE6": "0"}),
        ("plain", wide, {"HPGQ_WIRE": "off"}),
    ]
    reset_counts()
    for tier, path, env in runs:
        step.WIRE_BATCHES.clear()
        with mock.patch.dict(os.environ, env):
            got = run_port(path, tempfile.mkdtemp(dir=tmp), BENCH_FILTER)
        tiers = dict(step.WIRE_BATCHES)
        check(tiers.get(tier, 0) > 0, "tier %s carried no batch (%s)"
              % (tier, tiers))
        assert_counters_equal(got, want[path], "tier " + tier)
        say("tiers", "%s: %s, port == reference (%d passed, %d failed)"
            % (tier, tiers, got.num_passed, got.num_failed))

    k1 = launch_counts()["K1"]
    check(k1 > 0, "the tier runs launched K1 no time")
    kw = dict(BENCH_FILTER, kmers=True)
    got = run_port(binned, tempfile.mkdtemp(dir=tmp), kw)
    check(launch_counts()["K1"] > k1, "the k-mer run launched K1 no time")
    assert_counters_equal(got, reference_stats(records_binned, **kw),
                          "k-mers")
    say("tiers", "k-mers (2c tier, bench filter): K1 launches %d, port == "
        "reference, k-mer tables too (%d k-mers counted)"
        % (launch_counts()["K1"] - k1, int(got.kmer_counts.sum())))
    return launch_counts()["K1"]


# ---------------------------------------------------------------- phase 7

K2_TIME_SHAPE = (512, 32768)
# the long-read blocks of the benchmark's Nanopore cell
# (ont_chunk_gz_stats_filter): a 16 MB reader block of a 4,000-read MinION
# chunk is ~1,250 reads, padded to a multiple of 64 rows, in the lcap of
# the chunk's longest read (126,106), with the cell's filter
ONT_BLOCK = (1280, 126208)
ONT_FILTER = dict(read_length_range=(1000, 1000000),
                  read_quality_range=(7, 60))


def ont_block(seed, shape=ONT_BLOCK, n=1250, longest=126106):
    """(codes, quals, lens, valid) numpy of a block as the Nanopore cell's
    reads pack it: ``n`` reads of log-normal lengths (median 3,882, sigma
    1.0, one of ``longest``), then padding rows (length 0, not valid);
    each read's qualities drawn around a mean of its own (normal, median
    Q10, sd 2.5, Q4-20; each base sd 4, Q1-40), unbinned; no N."""
    B, L = shape
    rng = np.random.default_rng(seed)
    lens = np.zeros(B, np.int32)
    lens[:n] = np.clip(rng.lognormal(np.log(3882), 1.0, n), 1, longest)
    lens[rng.integers(n)] = longest
    inside = np.arange(L)[None, :] < lens[:, None]
    codes = np.where(inside, rng.integers(0, 4, (B, L), dtype=np.int8),
                     np.int8(5))
    means = np.clip(10 + 2.5 * rng.standard_normal((B, 1), np.float32), 4, 20)
    q = means + np.float32(4) * rng.standard_normal((B, L), np.float32)
    quals = np.where(inside, np.clip(np.rint(q), 1, 40).astype(np.uint8) + 33,
                     np.uint8(0))
    return codes, quals, lens, np.arange(B) < n


def ragged_block(codes, quals, lens, valid):
    """A block's valid rows as the session sends a long block: its ragged
    6-bit wire, the rows longest first (``native.pack_ragged6`` over the
    rows' bases and qualities as text), and those rows in that order as
    ``(codes, quals, lens, valid)`` numpy for the plain twin; ``(buf,
    rows, L, arrays)``."""
    from hpgq_torch.io import native

    keep = np.flatnonzero(valid)
    order = keep[np.argsort(-lens[keep], kind="stable")]
    letters = np.frombuffer(b"ACGTNX??", np.uint8)
    pieces, starts, at = [], [], 0
    for r in order:
        n = int(lens[r])
        pieces += [letters[codes[r, :n] & 7], quals[r, :n]]
        starts.append((at, at + n))
        at += 2 * n
    starts = np.array(starts, dtype=np.int64).reshape(-1, 2)
    buf = native.pack_ragged6(np.concatenate(pieces), starts[:, 0],
                              starts[:, 1], lens[order])
    check(buf is not None, "the block does not fit the ragged 6-bit wire")
    rows = (codes[order], quals[order], lens[order], valid[order])
    return buf, len(order), int(lens.max()), rows


def compare_k2(t, lcap, settings, label, kmers_settings=(False, True)):
    """K2 (through ``make_batch_partials``) against the plain twin on the
    tensors ``t`` under each filter setting, k-mers off and on (or as
    ``kmers_settings`` says); returns (max abs err, the last kernel
    partials)."""
    import torch

    from hpgq_torch.kernels.stats_cuda import make_batch_partials
    from hpgq_torch.kernels.stats_torch import fused_partials

    err = 0.0
    for name, crit in settings.items():
        for kmers in kmers_settings:
            k = make_batch_partials(lcap, 33, crit, kmers)(*t)
            p = fused_partials(*t, lcap, 33, crit, kmers)
            torch.cuda.synchronize()
            err = max(err, compare_partials(
                k, p, "%s / %s / kmers %s" % (label, name, kmers)))
    say("k2", "%s: K2 == plain twin for %d filter settings x k-mers %s"
        % (label, len(settings),
           "/".join("on" if k else "off" for k in kmers_settings)))
    return err, k


def phase_k2(dev):
    """K2 against its plain twin; returns its kernels-line fields (times
    on the 512 x 32768 batch, no filter)."""
    import torch

    from hpgq_torch.api import filter_criteria
    from hpgq_torch.kernels import stats_cuda
    from hpgq_torch.kernels.stats_cuda import (
        batch_partials_cuda_long,
        prepare_k2,
    )
    from hpgq_torch.kernels.stats_torch import fused_partials

    crits = {name: filter_criteria(**kw) for name, kw in FILTERS.items()}
    long_t = None
    sentinel = {"min quality only": filter_criteria(
        read_quality_range=(5, None))}
    nanofilt = {"nanofilt": filter_criteria(**LONG_FILTER)}
    # [D8] windows: one across the 512-column tile edge (the 500-900 of
    # tools/validate_device.py:308-345), one that ends past every read
    windows = {
        "window 500-900": filter_criteria(read_quality_range=(15, 40),
                                          max_out_of_quality=100,
                                          quality_window=(500, 900)),
        "window 4000-40000": filter_criteria(read_quality_range=(15, 40),
                                             quality_window=(4000, 40000))}
    # phase 8's batches: a 16 MB block of ~490 reads of 2-30 kb (one of
    # 66-90 kb among them) padded to 512 rows, in lcap 89,472
    rng = np.random.default_rng(798)
    long_lens = rng.integers(2_000, 30_001, size=512)
    long_lens[[100, 300]] = (70_001, 89_415)
    long_lens[490:] = 0
    cases = [
        # (label, B, L, lcap, lens, valid_frac, extra settings)
        ("256x4608 lcap 4608", 256, 4608, 4608, None, 0.9, windows),
        ("100x8192 lcap 8192", 100, 8192, 8192, None, 0.9, {}),
        ("64x4608 lcap 8192", 64, 4608, 8192, None, 0.9, {}),
        ("32x24576 full length", 32, 24576, 24576, np.full(32, 24576), 0.9,
         sentinel),
        ("8x66048 lcap 66048", 8, 66048, 66048, None, 1.0, {}),
        ("ragged 300x4101 lcap 4224", 300, 4101, 4224, None, 0.8, {}),
        ("all rows invalid 300x8192", 300, 8192, 8192, None, 0.0, {}),
        ("empty 0x8192", 0, 8192, 8192, None, 1.0, {}),
        ("long-read batch 512x89472", 512, 89472, 89472, long_lens, 1.0,
         nanofilt),
        # a few reads fill the card; lengths on and off the 512-column tile
        # edges and not multiples of 16 (one read each for B = 1..7)
    ] + [("%d long reads, tile edges" % b, b, 30016, 30016,
          np.array([30016, 511, 512, 513, 1025, 16383, 29999][:b]), 1.0, {})
         for b in range(1, 8)] + [
        ("ragged 9x20007 (L % 16 != 0)", 9, 20007, 20096,
         np.array([20007, 0, 1, 15, 17, 4099, 10000, 20006, 512]), 1.0,
         windows),
        ("codes of any byte 64x8192", 64, 8192, 8192, None, 0.9, {}),
    ]
    max_err = 0.0
    before = stats_cuda.LAUNCHES_K2
    for ci, (label, B, L, lcap, lens, vf, extra) in enumerate(cases):
        arrs = make_batch(B, L, seed=700 + ci, lens=lens, valid_frac=vf,
                          binned=False,
                          any_byte=label.startswith("codes of any"))
        if lens is None:
            arrs[2][:5] = 0  # length-0 rows
        if extra is nanofilt:
            arrs[3][490:] = False  # the block's padding rows
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        if extra is nanofilt:
            long_t = t
        err, k = compare_k2(t, lcap, dict(crits, **extra), label)
        max_err = max(max_err, err)
        if extra is sentinel:  # only a minimum quality: every valid read
            n_pass = int(k["_num_passed"])  # passes
            check(n_pass == int(arrs[3].sum()),
                  "%s: %d of %d valid reads passed a minimum quality of 5"
                  % (label, n_pass, int(arrs[3].sum())))

    B, L = K2_TIME_SHAPE
    t = [torch.from_numpy(a).to(dev) for a in
         make_batch(B, L, seed=799, binned=False)]
    err, _ = compare_k2(t, L, {"none": crits["none"], "bench": crits["bench"],
                               **nanofilt}, "timed batch %dx%d" % (B, L))
    max_err = max(max_err, err)
    check(stats_cuda.LAUNCHES_K2 - before == 2 * (3 + sum(
        len(crits) + len(c[6]) for c in cases if c[1])),
        "K2 launch count %d" % (stats_cuda.LAUNCHES_K2 - before))

    # the Nanopore cell's block, with its filter, k-mers off as in the
    # cell: one K2 call (launches A and B)
    ont = {"the Nanopore cell's": filter_criteria(**ONT_FILTER)}
    ont_t = [torch.from_numpy(a).to(dev) for a in ont_block(797)]
    reset_counts()
    err, k = compare_k2(ont_t, ONT_BLOCK[1], ont, "the Nanopore cell's "
                        "block %dx%d" % ONT_BLOCK, kmers_settings=(False,))
    max_err = max(max_err, err)
    check(launch_counts() == {"K1": 0, "K1 2u": 0, "K2": 1},
          "the Nanopore cell's block: launches %s" % launch_counts())
    n_pass = int(k["_num_passed"])
    check(0 < n_pass < int(ont_t[3].sum()),
          "the Nanopore cell's block: %d of %d reads passed its filter"
          % (n_pass, int(ont_t[3].sum())))
    # the same block as the session sends it: one ragged 6-bit wire, K2's
    # ragged entry against the plain twin on its rows, filter off and on
    from hpgq_torch.kernels.stats_cuda import (
        batch_partials_cuda_ragged,
        prepare_k2_ragged,
    )

    buf, rows, Lr, rag_rows = ragged_block(*ont_block(797))
    rag_buf = torch.from_numpy(buf).to(dev)
    rag_t = [torch.from_numpy(a).to(dev) for a in rag_rows]
    for name, crit in (("no filter", None),
                       ("its filter", ont["the Nanopore cell's"])):
        reset_counts()
        k = batch_partials_cuda_ragged(rag_buf, rows, Lr, ONT_BLOCK[1], 33,
                                       crit)
        p = fused_partials(*rag_t, ONT_BLOCK[1], 33, crit)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_partials(
            k, p, "the Nanopore cell's block as a ragged wire, %s" % name))
        check(launch_counts() == {"K1": 0, "K1 2u": 0, "K2": 1},
              "the ragged wire: launches %s" % launch_counts())
    say("k2", "the Nanopore cell's block as one ragged 6-bit wire (%d rows, "
        "%d bytes): K2's ragged entry == plain twin, filter off and on"
        % (rows, buf.nbytes))
    out = {}
    for label, t, lcap, crit in (
            ("512x32768, no filter (one sweep)", t, L, None),
            ("512x32768, NanoFilt-style filter (two sweeps)", t, L,
             nanofilt["nanofilt"]),
            ("phase 8's batch 512x89472, NanoFilt-style filter", long_t,
             89472, nanofilt["nanofilt"]),
            ("the Nanopore cell's block %dx%d, its filter" % ONT_BLOCK,
             ont_t, ONT_BLOCK[1], ont["the Nanopore cell's"])):
        codes, quals, lens, valid = t
        Bt, Lt = codes.shape
        nbases = int(lens.clamp(0, Lt).sum())
        out[label] = time_kernel(
            "k2", "K2, " + label,
            lambda t=t, lcap=lcap, crit=crit: batch_partials_cuda_long(
                *t, lcap, 33, crit),
            lambda t=t, lcap=lcap, crit=crit: fused_partials(
                *t, lcap, 33, crit),
            lambda t=t, lcap=lcap, crit=crit: prepare_k2(*t, lcap, 33, crit),
            "stats_k2_", 2 * nbases + 5 * Bt + output_bytes(Bt, lcap, Bt),
            nbases, launches_per_call=1 if crit is None else 2)
    nbases = int(rag_rows[2].sum())
    for label, crit in (("no filter", None),
                        ("its filter", ont["the Nanopore cell's"])):
        out["ragged " + label] = time_kernel(
            "k2", "K2's ragged entry, the Nanopore cell's block as one "
            "ragged wire, " + label,
            lambda crit=crit: batch_partials_cuda_ragged(
                rag_buf, rows, Lr, ONT_BLOCK[1], 33, crit),
            lambda crit=crit: fused_partials(*rag_t, ONT_BLOCK[1], 33, crit),
            lambda crit=crit: prepare_k2_ragged(rag_buf, rows, Lr,
                                                ONT_BLOCK[1], 33, crit),
            "stats_k2_", buf.nbytes + output_bytes(rows, ONT_BLOCK[1], rows),
            nbases, launches_per_call=1 if crit is None else 2)
    res = out["512x32768, no filter (one sweep)"]
    res["max_abs_err"] = max_err
    return res


# ---------------------------------------------------------------- phase 8

LONG_FILTER = dict(read_length_range=(5000, 100000),
                   read_quality_range=(10, 60), max_N=20)


def long_read_corpus(path, n=10_000, n_huge=36, lengths=(2_000, 30_000),
                     huge=(66_000, 90_000), seed=41):
    """Write ``n`` reads of ``lengths`` plus ``n_huge`` of ``huge`` bp
    (unbinned qualities 2-41, N rate 0.001), the long ones spread through
    the file; returns the records."""
    from gen import make_records, write_fastq

    records = make_records(n, min_len=lengths[0], max_len=lengths[1],
                           n_prob=0.001, seed=seed)
    big = make_records(n_huge, min_len=huge[0], max_len=huge[1],
                       n_prob=0.001, seed=seed + 1)
    step = max(1, n // max(n_huge, 1))
    for i, rec in enumerate(big):
        records.insert(min(len(records), i * (step + 1) + step // 2), rec)
    write_fastq(path, records)
    return records


def long_corpus(tmp):
    """Phase 8's long-read corpus (:func:`long_read_corpus`), cached."""
    return cached_corpus(os.path.join(tmp, "long_reads.fq"), long_read_corpus)


def run_stats_kw(path, outdir, device, quality_window=None, **kw):
    """``hpgq_torch.stats(path, **kw)``; with ``quality_window``, the
    legacy [D8] window that only the CLI's ``--start-quality-nt`` and
    ``--end-quality-nt`` set, put on the options as
    ``tools/validate_device.py:308-345`` puts it."""
    import hpgq_torch
    from hpgq_torch.api import filter_criteria
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.pipeline.run import run_stats

    if quality_window is None:
        return hpgq_torch.stats(path, outdir=outdir, device=device, **kw)
    return run_stats(StatsOptions(
        in_filename=path, out_dirname=outdir, quality_encoding_name="phred33",
        criteria=filter_criteria(quality_window=quality_window, **kw),
        filter_on=True), device=device)


# a window across K2's 512-column tile edge, at a mean quality range that
# splits the corpus (qualities 2-41: a 400-base mean near 21.5)
LONG_WINDOW = dict(read_quality_range=(21, 22), quality_window=(500, 900))


def long_read_runs(path, records, outdir, device):
    """``hpgq_torch.stats`` on ``device`` with ``kmers=True``, with
    :data:`LONG_FILTER` and with :data:`LONG_WINDOW`, each held against
    the reference; returns ``{run: (counters, K1 launches, K2 launches,
    wire tiers, seconds)}``."""
    import torch

    from hpgq_torch.kernels import step
    from hpgq_torch.oracle import assert_counters_equal, reference_stats

    out = {}
    for run, kw in (("kmers", dict(kmers=True)), ("filter", LONG_FILTER),
                    ("window", LONG_WINDOW)):
        reset_counts()
        t0 = time.perf_counter()
        got = run_stats_kw(path, outdir, device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launch_counts()
        out[run] = (got, n["K1"] + n["K1 2u"], n["K2"],
                    dict(step.WIRE_BATCHES), secs)
        assert_counters_equal(got, reference_stats(records, **kw),
                              "long reads, " + run)
        if run != "kmers":
            check(got.num_passed > 0 and got.num_failed > 0,
                  "the long-read %s run passed %d and failed %d reads"
                  % (run, got.num_passed, got.num_failed))
    return out


def phase_long_reads(tmp):
    path, records = long_corpus(tmp)
    nbases = sum(len(r[1]) for r in records)
    say("long", "%d reads, %d bases (longest %d)"
        % (len(records), nbases, max(len(r[1]) for r in records)))
    out = tempfile.mkdtemp(dir=tmp)
    t0 = time.perf_counter()
    runs = long_read_runs(path, records, out, "cuda")
    for run, (got, k1, k2, tiers, secs) in runs.items():
        check(k2 > 0, "the long-read %s run launched K2 no time" % run)
        say("long", "%s: cold pass %.3f s, K2 launches %d, K1 launches %d, "
            "wire tiers %s; port == reference (%d reads counted, %d passed, "
            "%d failed%s)" % (
                run, secs, k2, k1, tiers, got.num_reads, got.num_passed,
                got.num_failed, ", %d k-mers" % int(got.kmer_counts.sum())
                if run == "kmers" else ""))
    say("long", "the three runs and their references took %.1f s"
        % (time.perf_counter() - t0))
    return runs["filter"][2]


# ---------------------------------------------------------------- phase 9

def paired_runs(m1, recs1, m2, recs2, outdir, device):
    """``hpgq_torch.stats(m1, m2)`` on ``device`` with :data:`BENCH_FILTER`
    and with no filter, both mates held against
    ``oracle.reference_paired_stats``; returns ``{run: (counters pair,
    launches by kernel, wire tiers, seconds)}``."""
    import torch

    import hpgq_torch
    from hpgq_torch.kernels import step
    from hpgq_torch.oracle import assert_counters_equal, reference_paired_stats

    out = {}
    for run, kw in (("filter", BENCH_FILTER), ("all", {})):
        reset_counts()
        t0 = time.perf_counter()
        got = hpgq_torch.stats(m1, m2, outdir=outdir, device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[run] = (got, launch_counts(), dict(step.WIRE_BATCHES), secs)
        want = reference_paired_stats(recs1, recs2, **kw)
        for mate, g, w in zip((1, 2), got, want):
            assert_counters_equal(g, w, "paired %s, mate %d" % (run, mate))
        if kw:
            check(got[0].num_passed > 0 and got[0].num_failed > 0,
                  "the paired filter passed %d and failed %d pairs"
                  % (got[0].num_passed, got[0].num_failed))
    return out


def long_pairs(tmp, n=2000, n_huge=8):
    """Two mate files of long reads (:func:`long_read_corpus`, seeds 51
    and 61, ``n + n_huge`` records each), cached."""
    return [cached_corpus(os.path.join(tmp, "long_pairs_%d.fq" % m),
                          lambda p, s=seed: long_read_corpus(
                              p, n=n, n_huge=n_huge, seed=s))
            for m, seed in ((1, 51), (2, 61))]


def paired_long_run(pair1, pair2, outdir, device):
    """Paired ``stats`` of long reads with :data:`LONG_FILTER`, both mates
    held against ``reference_paired_stats``; returns (counters pair,
    launches, wire tiers).  On CUDA every mate batch must launch K2."""
    import hpgq_torch
    from hpgq_torch.kernels import step
    from hpgq_torch.oracle import assert_counters_equal, reference_paired_stats

    (m1, recs1), (m2, recs2) = pair1, pair2
    reset_counts()
    got = hpgq_torch.stats(m1, m2, outdir=outdir, device=device,
                           **LONG_FILTER)
    n, tiers = launch_counts(), dict(step.WIRE_BATCHES)
    want = reference_paired_stats(recs1, recs2, **LONG_FILTER)
    for mate, g, w in zip((1, 2), got, want):
        assert_counters_equal(g, w, "paired long reads, mate %d" % mate)
    check(got[0].num_passed > 0 and got[0].num_failed > 0,
          "the paired long-read filter passed %d and failed %d pairs"
          % (got[0].num_passed, got[0].num_failed))
    if device == "cuda":
        check(n["K2"] > 0 and n["K2"] == sum(tiers.values())
              and n["K1"] + n["K1 2u"] == 0,
              "paired long reads: every mate batch must launch K2 once "
              "(launches %s, tiers %s)" % (n, tiers))
    return got, n, tiers


def phase_paired(tmp):
    """Paired stats over 1M pairs of 2 x 100 bp, and over 2,008 pairs of
    long reads; returns the launches of K1's plain entry (the filtered
    run: the pair verdict reads both mates decoded), of its 2u entry (the
    run with no filter) and of K2 (the long pairs, both mates)."""
    m1, recs1 = bench_corpus(tmp)
    m2, recs2 = bench_corpus(tmp, seed=8)
    t0 = time.perf_counter()
    runs = paired_runs(m1, recs1, m2, recs2, tempfile.mkdtemp(dir=tmp),
                       "cuda")
    for run, ((c1, c2), n, tiers, secs) in runs.items():
        entry = "K1" if run == "filter" else "K1 2u"
        check(n[entry] > 0 and tiers == {"2u": n[entry]}
              and n["K1"] + n["K1 2u"] == n[entry],
              "paired %s: every mate batch must ride the 2u tier and launch "
              "%s once (tiers %s, launches %s)" % (run, entry, tiers, n))
        say("paired", "%s: cold pass %.3f s, launches %s, wire tiers %s; "
            "both mates == reference (%d pairs counted, %d passed, %d "
            "failed)" % (run, secs, n, tiers, c1.num_reads, c1.num_passed,
                         c1.num_failed))
    say("paired", "both runs and their references took %.1f s"
        % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    (c1, _), n, tiers = paired_long_run(*long_pairs(tmp),
                                        tempfile.mkdtemp(dir=tmp), "cuda")
    say("paired", "long reads, NanoFilt-style filter: %.3f s with its "
        "reference, launches %s, wire tiers %s; both mates == reference "
        "(%d pairs counted, %d passed, %d failed)"
        % (time.perf_counter() - t0, n, tiers, c1.num_reads, c1.num_passed,
           c1.num_failed))
    return runs["filter"][1]["K1"], runs["all"][1]["K1 2u"], n["K2"]


# ---------------------------------------------------------------- phase 10

def filter_runs(cases, outdir, device):
    """``hpgq_torch.filter_reads`` on ``device`` for each case ``(label,
    paths, record lists, thresholds)``: every output file must equal, byte
    for byte, the records ``oracle.reference_verdicts`` selects (a pair
    passes when both mates do).  Returns ``{label: (result, verdict
    batches by (device, tier), seconds)}``."""
    import hpgq_torch
    from hpgq_torch.oracle import fastq_bytes, reference_verdicts
    from hpgq_torch.pipeline import session

    out = {}
    for label, paths, recs, kw in cases:
        session.FN_BATCHES.clear()
        od = tempfile.mkdtemp(dir=outdir)
        t0 = time.perf_counter()
        res = hpgq_torch.filter_reads(*paths, outdir=od, device=device, **kw)
        secs = time.perf_counter() - t0
        out[label] = (res, dict(session.FN_BATCHES), secs)
        ok = reference_verdicts(recs[0], **kw)
        for r in recs[1:]:
            ok &= reference_verdicts(r, **kw)
        names = (("passed.fq", "failed.fq") if len(paths) == 1 else
                 ("passed_1.fq", "passed_2.fq", "failed_1.fq", "failed_2.fq"))
        sel = [ok] * len(paths) + [~ok] * len(paths)
        for name, r, s in zip(names, list(recs) * 2, sel):
            with open(os.path.join(od, name), "rb") as f:
                check(f.read() == fastq_bytes(r, s), "%s: %s differs from "
                      "the reference's selection" % (label, name))
        check(res["num_passed"] == int(ok.sum())
              and res["num_failed"] == int((~ok).sum()),
              "%s: %d passed, %d failed; the reference passes %d of %d"
              % (label, res["num_passed"], res["num_failed"], int(ok.sum()),
                 len(ok)))
    return out


LONG_FILTER_PASSED = 5744  # what phase 8's filtered stats counts on this corpus


def phase_filter(tmp, se_passed=None):
    """Single-end filter of the phase-4 corpus, paired filter of phase 9's
    pairs, long-read filter of phase 8's corpus."""
    m1, recs1 = bench_corpus(tmp)
    m2, recs2 = bench_corpus(tmp, seed=8)
    lpath, lrecs = long_corpus(tmp)
    cases = [("single-end", (m1,), (recs1,), BENCH_FILTER),
             ("paired", (m1, m2), (recs1, recs2), BENCH_FILTER),
             ("long reads", (lpath,), (lrecs,), LONG_FILTER)]
    want_tier = {"single-end": "2c", "paired": "2c", "long reads": "qn8"}
    t0 = time.perf_counter()
    runs = filter_runs(cases, tmp, "cuda")
    for label, (res, batches, secs) in runs.items():
        check(all(dev == "cuda" for dev, _ in batches),
              "%s: a verdict ran off the card (%s)" % (label, batches))
        check(batches.get(("cuda", want_tier[label]), 0) > 0,
              "%s: the %s tier carried no batch (%s)"
              % (label, want_tier[label], batches))
        say("filter", "%s: cold pass %.3f s, verdict batches %s; every "
            "output file == reference (%d passed, %d failed)"
            % (label, secs, batches, res["num_passed"], res["num_failed"]))
    if se_passed is not None:
        check(runs["single-end"][0]["num_passed"] == se_passed,
              "filter passed %d reads, phase 4's stats %d"
              % (runs["single-end"][0]["num_passed"], se_passed))
    check(runs["long reads"][0]["num_passed"] == LONG_FILTER_PASSED,
          "the long-read filter passed %d reads, phase 8 %d"
          % (runs["long reads"][0]["num_passed"], LONG_FILTER_PASSED))
    say("filter", "three runs and their references took %.1f s"
        % (time.perf_counter() - t0))


# ---------------------------------------------------------------- phase 11

EDIT_TRIM = dict(left_length=10, left_quality_range=(28, 60))  # bench.py:381
EDIT_GOLDEN = dict(  # tests/test_golden.py:100-111
    left_length=8, left_quality_range=(28, 60), right_length=6,
    right_quality_range=(28, 60), filter_after=True,
    read_quality_range=(20, 45))
PREPRO = dict(ltrim_nts=5, rtrim_nts=3, min_quality=27, max_quality=64)
# a 50-base right window: qualities 2-41 put its mean near 21.5, so a
# window of 20-60 trims about a fifth of the reads (10-60 would trim none)
LONG_EDIT = dict(LONG_FILTER, right_length=50, right_quality_range=(20, 60),
                 filter_after=True)


def _window_kw(kw, side):
    if side + "_length" not in kw:
        return None
    return kw[side + "_length"], kw.get(side + "_quality_range")


def edit_expect(kind, paths, recs, kw):
    """What ``hpgq_torch.<kind>(*paths, **kw)`` must write and count, from
    ``hpgq_torch.oracle``: ``({file name: bytes}, {count: value}, [(lt,
    rt) per mate], the records kept)``.  A pair is kept when both trimmed
    mates pass the post-filter."""
    from hpgq_torch.oracle import (
        reference_trims,
        reference_verdicts,
        trimmed_fastq_bytes,
        trimmed_records,
    )

    single = len(paths) == 1
    if kind == "prepro":
        q = (max(kw["min_quality"], 10), min(kw["max_quality"], 70))
        left = (kw["ltrim_nts"], q) if kw.get("ltrim_nts", 0) > 0 else None
        right = (kw["rtrim_nts"], q) if kw.get("rtrim_nts", 0) > 0 else None
        post = None
        names = [os.path.basename(p) + ".valid" for p in paths]
    else:
        left, right = _window_kw(kw, "left"), _window_kw(kw, "right")
        post = {k: kw[k] for k in ("read_length_range", "read_quality_range",
                                   "max_N") if k in kw} \
            if kw.get("filter_after") else None
        names = ["edit.fq"] if single else ["edit_1.fq", "edit_2.fq"]
    trims = []
    for r in recs:  # each list's trims computed once per run
        key = (id(r), left, right)
        if key not in _TRIMS:
            _TRIMS[key] = reference_trims(r, left=left, right=right)
        trims.append(_TRIMS[key])
    sel = np.ones(len(recs[0]), bool)
    for r, (lt, rt) in zip(recs, trims):
        if post is not None:
            sel &= reference_verdicts(trimmed_records(r, lt, rt), **post)
    files = {n: trimmed_fastq_bytes(r, lt, rt, sel)
             for n, r, (lt, rt) in zip(names, recs, trims)}
    if post is not None:
        failed = ["failed.fq"] if single else ["failed_1.fq", "failed_2.fq"]
        files.update({n: trimmed_fastq_bytes(r, lt, rt, ~sel)
                      for n, r, (lt, rt) in zip(failed, recs, trims)})
    counts = {"num_edited": sum(int(((lt > 0) | (rt > 0)).sum())
                                for lt, rt in trims),
              "num_passed": int(sel.sum()) if post is not None else 0,
              "num_failed": int((~sel).sum()) if post is not None else 0}
    return files, counts, trims, sel


_TRIMS = {}


def edit_runs(cases, outdir, device):
    """``hpgq_torch.edit`` or ``prepro`` on ``device`` for each case
    ``(label, kind, paths, record lists, keywords)``: the output directory
    must hold exactly the files :func:`edit_expect` builds, byte for byte,
    and the counts must be its counts.  Returns ``{label: (result, verdict
    batches by (device, tier), seconds, reference trims, records kept)}``."""
    import hpgq_torch
    from hpgq_torch.pipeline import session

    out = {}
    for label, kind, paths, recs, kw in cases:
        session.FN_BATCHES.clear()
        od = tempfile.mkdtemp(dir=outdir)
        t0 = time.perf_counter()
        res = getattr(hpgq_torch, kind)(*paths, outdir=od, device=device,
                                        **kw)
        secs = time.perf_counter() - t0
        files, counts, trims, sel = edit_expect(kind, paths, recs, kw)
        check(sorted(os.listdir(od)) == sorted(files),
              "%s: wrote %s, the reference %s" % (label, sorted(os.listdir(od)),
                                                   sorted(files)))
        for name, want in files.items():
            with open(os.path.join(od, name), "rb") as f:
                check(f.read() == want, "%s: %s differs from the reference"
                      % (label, name))
        got = {k: res[k] for k in counts}
        check(got == counts, "%s: counts %s, the reference %s"
              % (label, got, counts))
        out[label] = (res, dict(session.FN_BATCHES), secs, trims, sel)
    return out


def edit_then_stats(res, records, trims, sel, outdir, device):
    """``hpgq_torch.stats`` over an edit run's ``edit.fq`` (the
    ``bench.py:530-551`` chain): counters equal to ``reference_stats`` over
    the trimmed records it kept (``sel``).  Returns (counters, launches)."""
    import hpgq_torch
    from hpgq_torch.oracle import (
        assert_counters_equal,
        reference_stats,
        trimmed_records,
    )

    reset_counts()
    got = hpgq_torch.stats(res["edit_filename"], outdir=outdir, device=device)
    kept = [r for r, s in zip(trimmed_records(records, *trims), sel) if s]
    assert_counters_equal(got, reference_stats(kept), "stats over edit.fq")
    return got, launch_counts()


def phase_edit(tmp):
    """Edit and prepro on the card; returns the launches of K1's plain
    entry and of K2 by the stats passes over ``edit.fq``."""
    m1, recs1 = bench_corpus(tmp)
    m2, recs2 = bench_corpus(tmp, seed=8)
    lpath, lrecs = long_corpus(tmp)
    cases = [("trim only", "edit", (m1,), (recs1,), EDIT_TRIM),
             ("golden settings", "edit", (m1,), (recs1,), EDIT_GOLDEN),
             ("paired, golden settings", "edit", (m1, m2), (recs1, recs2),
              EDIT_GOLDEN),
             ("prepro", "prepro", (m1,), (recs1,), PREPRO),
             ("long reads", "edit", (lpath,), (lrecs,), LONG_EDIT)]
    t0 = time.perf_counter()
    runs = edit_runs(cases, tmp, "cuda")
    for label, (res, batches, secs, _, _) in runs.items():
        check(batches and all(dev == "cuda" for dev, _ in batches),
              "%s: an edit batch ran off the card (%s)" % (label, batches))
        say("edit", "%s: cold pass %.3f s, batches %s; every output == "
            "reference (%d edited, %d passed, %d failed)"
            % (label, secs, batches, res["num_edited"], res["num_passed"],
               res["num_failed"]))
    say("edit", "five runs and their references took %.1f s"
        % (time.perf_counter() - t0))
    n = {}
    for label, recs, kernel in (("trim only", recs1, "K1"),
                                ("long reads", lrecs, "K2")):
        res, _, _, trims, sel = runs[label]
        got, launches = edit_then_stats(res, recs, trims[0], sel,
                                        tempfile.mkdtemp(dir=tmp), "cuda")
        check(launches[kernel] + (launches["K1 2u"] if kernel == "K1" else 0)
              > 0, "stats over the %s edit.fq launched %s no time (%s)"
              % (label, kernel, launches))
        n[kernel] = launches[kernel]
        say("edit", "stats over the %s edit.fq: launches %s; == reference "
            "(%d reads, lengths %d-%d)" % (label, launches, got.num_reads,
                                           got.min_length, got.max_length))
    return n["K1"], n["K2"]


# ---------------------------------------------------------------- phase 12

def cgr_reference(recs, k):
    """``reference_cgr`` summed over the record lists of every mate (one
    signature), each list computed once per run."""
    from hpgq_torch.oracle import reference_cgr

    refs = [_CGR_REFS.get((id(r), k)) for r in recs]
    for i, r in enumerate(recs):
        if refs[i] is None:
            refs[i] = _CGR_REFS[(id(r), k)] = reference_cgr(r, k)
    return tuple(sum(x) for x in zip(*refs))


_CGR_REFS = {}


def cgr_check(res, recs, k, outdir, label):
    """A ``hpgq_torch.cgr`` result against :func:`cgr_reference` over the
    records of every mate: the tables, the word count, and the PGM and
    ``.gs`` bytes that ``hpgq_torch.report.pgm`` writes from the
    reference's tables."""
    from hpgq_torch.constants import CGR_MAX_QUALITY_IN_TABLE
    from hpgq_torch.report import pgm

    ts, tq, words = cgr_reference(recs, k)
    check(np.array_equal(res["table_seq"], ts)
          and np.array_equal(res["table_q"], tq)
          and res["fq_word_count"] == words,
          "%s: tables or word count differ from the reference" % label)
    want = {"_FG.pgm": pgm.pgm_bytes(ts, k, pgm.fq_norm_value(words, k)),
            "_QQ.pgm": pgm.pgm_bytes(pgm.normalize_quality_table(tq, ts, k),
                                     k, 256.0 / CGR_MAX_QUALITY_IN_TABLE)}
    if "gs_file" in res:
        ref = os.path.join(tempfile.mkdtemp(dir=outdir),
                           os.path.basename(res["gs_file"]))
        with open(pgm.write_gs(ref, ts, k, words), "rb") as f:
            want[".gs"] = f.read()
    base = res["pgm_files"][0][:-len("_FG.pgm")]
    for suffix, data in want.items():
        with open(base + suffix, "rb") as f:
            check(f.read() == data, "%s: %s differs from the reference"
                  % (label, suffix))
    return words


def cgr_self_diff(path, gs, k, outdir, device):
    """``cgr`` against the file's own signature: an all-zero diff image,
    mean and stddev 0."""
    import hpgq_torch

    res = hpgq_torch.cgr(path, outdir=outdir, k=k, gs_filename=gs,
                         device=device)
    with open(res["pgm_files"][-1], "rb") as f:
        body = f.read().split(b"\n", 3)[3]
    check(res["pgm_files"][-1].endswith("_FG_dif.pgm") and set(body) == {0}
          and res["mean_dif"] == 0.0 and res["std_dif"] == 0.0,
          "the self-diff is not zero (mean %r, stddev %r)"
          % (res["mean_dif"], res["std_dif"]))


def cgr_direct_checks(device, n_overflow=3000):
    """``cgr_batch_tables`` on ``device`` against ``reference_cgr``: k=10
    on a small batch, and the int32-overflow case of
    ``tests/test_cgr.py:241-261`` (``n_overflow`` poly-A reads of 4096 at
    quality 126, k=2), whose one cell passes 2^31 with 3000 reads."""
    import torch

    from gen import make_records
    from hpgq_torch.kernels.cgr_torch import cgr_batch_tables
    from hpgq_torch.oracle import _padded, reference_cgr

    cases = [("k=10, 96 reads of 20-300 bp", 10, make_records(
        96, min_len=20, max_len=300, n_prob=0.02, lowercase_prob=0.05,
        seed=12)),
        ("k=2, %d poly-A reads of 4096 at quality 126" % n_overflow, 2,
         [(b"@a", b"A" * 4096, b"~" * 4096)] * n_overflow)]
    out = {}
    for label, k, recs in cases:
        codes, quals, lens, _ = _padded(recs, 33)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for a in (codes, quals.astype(np.uint8), lens,
                       np.ones(len(recs), bool))]
        ts, tq, w = (x.cpu().numpy() for x in cgr_batch_tables(*t, k, 33))
        rts, rtq, rw = reference_cgr(recs, k)
        check(np.array_equal(ts, rts) and np.array_equal(tq, rtq)
              and int(w) == rw, "%s: cgr_batch_tables differs from the "
              "reference" % label)
        out[label] = int(np.abs(tq).max())
    return out


def phase_cgr(tmp):
    import hpgq_torch
    from hpgq_torch.pipeline import cgr_run

    m1, recs1 = bench_corpus(tmp)
    m2, recs2 = bench_corpus(tmp, seed=8)
    gs = {}
    for label, paths, recs in (("single-end", (m1,), (recs1,)),
                               ("paired", (m1, m2), (recs1, recs2))):
        cgr_run.BATCHES.clear()
        t0 = time.perf_counter()
        res = hpgq_torch.cgr(*paths, outdir=tempfile.mkdtemp(dir=tmp), k=7,
                             write_gs=True, device="cuda")
        gs[label] = res["gs_file"]
        secs = time.perf_counter() - t0
        batches = dict(cgr_run.BATCHES)
        check(batches and all(dev == "cuda" for dev, _ in batches),
              "%s: a CGR batch ran off the card (%s)" % (label, batches))
        words = cgr_check(res, recs, 7, tmp, "cgr " + label)
        say("cgr", "%s k=7: cold pass %.3f s, batches %s; tables, word "
            "count (%d), PGMs and .gs == reference"
            % (label, secs, batches, words))
    cgr_self_diff(m1, gs["single-end"], 7, tempfile.mkdtemp(dir=tmp), "cuda")
    say("cgr", "diff against its own .gs: all-zero _FG_dif.pgm, mean and "
        "stddev 0")
    for label, cell in cgr_direct_checks("cuda").items():
        say("cgr", "cgr_batch_tables %s on the card == reference (largest "
            "quality cell %d)" % (label, cell))


# ---------------------------------------------------------------- phase 13

def cached_reference(fn, *recs, **kw):
    """``fn(*recs, **kw)`` of ``hpgq_torch.oracle``, computed once per run
    for the same record lists and keywords."""
    key = (fn.__name__, tuple(id(r) for r in recs),
           json.dumps(kw, sort_keys=True))
    if key not in _REFS:
        _REFS[key] = fn(*recs, **kw)
    return _REFS[key]


_REFS = {}


def _argv(kw):
    """CLI flags of the API's threshold keywords (BENCH_FILTER's)."""
    return ["--read-length-range", "%d,%d" % kw["read_length_range"],
            "--read-quality-range", "%d,%d" % kw["read_quality_range"],
            "--max-N", str(kw["max_N"])]


def rank_job(job):
    """One rank of phase 13: the target that ``hpgq_torch.dist.launch``
    runs in each rank it starts, and the body of ``--rank-worker`` (one
    process with torch's launcher variables: the torchrun route).  Each
    run of the job goes through the port's entry points with
    ``sharded=True`` (the API for ``stats`` and ``cgr``, the CLI for
    ``filter`` and ``edit``); per run, each rank writes
    ``<run>.rank<r>.json`` (its device, the world size, the launches, the
    tiers, the seconds, the wall-clock time of its first stats batch, the
    launcher's start-up stamps of the rank, whether jax or ``hpgq`` is
    loaded) and dumps its counters or tables for the parent to check."""
    for name in BLOCKED:  # a rank of launch() blocked them on import too
        sys.modules[name] = None
    import contextlib

    import torch

    import hpgq_torch
    from hpgq_torch.cli.main import main as cli
    from hpgq_torch.dist import launch, mesh
    from hpgq_torch.kernels import step
    from hpgq_torch.pipeline import session
    from hpgq_torch.utils.checkpoint import save_counters_checkpoint

    device = job["device"]
    pg = mesh.initialize_distributed(device)
    first = []  # the wall-clock time of this run's first stats batch
    for cls, name in ((session.StatsSession, "feed_packed"),
                      (session.PairedStatsSession, "feed_pair_packed")):
        def timed(self, *a, _real=getattr(cls, name), **k):
            if not first:
                first.append(time.time())
            return _real(self, *a, **k)

        setattr(cls, name, timed)
    for run in job["runs"]:
        out = run["outdir"] if run["kind"] == "cli" else "%s.rank%d" % (
            run["outdir"], pg.rank)  # one dir per rank: rank 0 alone writes
        os.makedirs(out, exist_ok=True)
        dump = os.path.join(job["dump"], "%s.rank%d" % (run["name"],
                                                       pg.rank))
        mesh.barrier(pg)
        reset_counts()
        first.clear()
        t0 = time.perf_counter()
        if run["kind"] == "stats":
            got = hpgq_torch.stats(*run["paths"], outdir=out, device=device,
                                   sharded=True, **run["kw"])
            c1, c2 = got if isinstance(got, tuple) else (got, None)
            save_counters_checkpoint(dump + ".npz", c1, 0, "dump",
                                     counters2=c2)
        elif run["kind"] == "cgr":
            res = hpgq_torch.cgr(*run["paths"], outdir=out, device=device,
                                 sharded=True, **run["kw"])
            np.savez(dump + ".npz", table_seq=res["table_seq"],
                     table_q=res["table_q"], words=res["fq_word_count"])
        else:
            log = os.path.join(job["dump"], "log.rank%d" % pg.rank)
            with open(log + ".out", "a") as f, contextlib.redirect_stdout(f):
                rc = cli(run["argv"] + ["-o", out, "--sharded", "--device",
                                        device, "--log-file", log])
            check(rc == 0, "%s: the CLI exited %d" % (run["name"], rc))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        mesh.barrier(pg)
        with open(dump + ".json", "w") as f:
            json.dump({
                "name": run["name"], "rank": pg.rank, "world": pg.world_size,
                "device": str(pg.device), "launches": launch_counts(),
                "tiers": dict(step.WIRE_BATCHES),
                "secs": time.perf_counter() - t0,
                "first_batch": first[0] if first else None,
                "stamps": launch.STAMPS,
                "jax": [n for n in BLOCKED
                        if sys.modules.get(n) is not None]}, f)


def rank_worker(job_file):
    """``--rank-worker JOB``: :func:`rank_job` as one process of torch's
    launcher route (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set: a gloo group over ``env://``)."""
    from hpgq_torch.dist import mesh

    with open(job_file) as f:
        rank_job(json.load(f))
    mesh.leave_group()  # not left to the interpreter's exit


def _rank_results(work, runs, world):
    """``{run name: [result of each rank]}`` from the ranks' files, with
    the dumps loaded (``counters``, ``tables``)."""
    from hpgq_torch.utils.checkpoint import load_counters_checkpoint

    results = {}
    for run in runs:
        ranks = []
        for r in range(world):
            path = os.path.join(work, "%s.rank%d" % (run["name"], r))
            check(os.path.exists(path + ".json"), "%s: rank %d of %d wrote "
                  "no result" % (run["name"], r, world))
            with open(path + ".json") as f:
                res = json.load(f)
            check(not res["jax"], "%s: rank %d loaded %s" % (
                run["name"], r, res["jax"]))
            if run["kind"] == "cgr":
                with np.load(path + ".npz") as z:
                    res["tables"] = (z["table_seq"], z["table_q"],
                                     int(z["words"]))
            elif run["kind"] == "stats":
                c1, _, extra = load_counters_checkpoint(path + ".npz", "dump")
                res["counters"] = (c1, extra.get("__counters2__"))
            ranks.append(res)
        results[run["name"]] = ranks
    return results


def rank_devices(world, device="cuda"):
    """``world`` ranks over the cards, round-robin: one card each when
    there are as many cards, two sharing ``cuda:0`` on one card (all on
    the CPU when ``device`` is the CPU)."""
    import torch

    if device == "cpu":
        return ["cpu"] * world
    n = torch.cuda.device_count()
    return ["cuda:%d" % (r % n) for r in range(world)]


def spawn_ranks(devices, runs, tmp, timeout=600):
    """Run ``runs`` as one rank on each of ``devices``, started by the
    port's launcher (``hpgq_torch.dist.launch.launch``, the one a user's
    ``--sharded`` gets): every rank a new interpreter that imports this
    script first, which blocks jax and ``hpgq`` there.  A run of more than
    ``timeout`` seconds fails the phase (the launcher stops the ranks).
    Returns ``{run name: [result of each rank]}``, each with
    ``launched_at``, the wall-clock time the launch started, and
    ``parent``, the launcher's stamps in the parent (``start_s``: seconds
    in the ranks' ``Process.start()``)."""
    import signal

    from hpgq_torch.dist.launch import launch

    work = tempfile.mkdtemp(dir=tmp)
    job = {"device": devices[0].split(":")[0], "dump": work, "runs": runs}

    def late(sig, frame):
        raise SmokeFailure("%d ranks did not finish %s in %d s"
                           % (len(devices), [r["name"] for r in runs],
                              timeout))

    old = signal.signal(signal.SIGALRM, late)
    signal.alarm(timeout)
    parent = {}
    t0 = time.time()
    try:
        launch(rank_job, (job,), devices, stamps=parent, kernels=True)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    results = _rank_results(work, runs, len(devices))
    for ranks in results.values():
        for r in ranks:
            r.update(launched_at=t0, parent=parent)
    return results


def launcher_variables_rank(runs, device, tmp, timeout=600):
    """``runs`` in one subprocess with torch's launcher variables (world
    size 1, ``env://`` on port 0: a group of one binds whatever port is
    free), the route ``torchrun`` takes.  Returns ``{run name: [its
    result]}``."""
    import subprocess

    work = tempfile.mkdtemp(dir=tmp)
    job = os.path.join(work, "job.json")
    with open(job, "w") as f:
        json.dump({"device": device, "dump": work, "runs": runs}, f)
    env = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT="0")
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--rank-worker", job],
        env=env, capture_output=True, text=True, timeout=timeout)
    check(p.returncode == 0, "the launcher-variable rank exited %d: %s"
          % (p.returncode, p.stderr[-3000:]))
    return _rank_results(work, runs, 1)


def check_ranks_stats(ranks, want, label):
    """Every rank's counters (both mates) equal the reference."""
    from hpgq_torch.oracle import assert_counters_equal

    want = want if isinstance(want, tuple) else (want, None)
    for res in ranks:
        for mate, got, w in zip((1, 2), res["counters"], want):
            if w is not None:
                assert_counters_equal(got, w, "%s, rank %d, mate %d"
                                      % (label, res["rank"], mate))


def sharded_ranks(corpora, outdir, device, tmp, world=2):
    """``world`` ranks on one host (by default two sharing the card; with
    as many cards, one each), started by the port's launcher, over gloo:
    sharded ``stats``, paired ``stats``, long-read ``stats``, ``filter``,
    ``edit`` and ``cgr`` k=7, each held against the reference; then one
    timed ``stats`` pass.  Returns the results by run."""
    from hpgq_torch.oracle import (
        fastq_bytes,
        reference_paired_stats,
        reference_stats,
        reference_verdicts,
    )

    (m1, recs1), (m2, recs2), (lpath, lrecs) = corpora
    devices = rank_devices(world, device)

    def d(name):
        return os.path.join(outdir, name)

    runs = [
        dict(name="stats", kind="stats", paths=[m1], kw=BENCH_FILTER,
             outdir=d("stats")),
        dict(name="paired", kind="stats", paths=[m1, m2], kw=BENCH_FILTER,
             outdir=d("paired")),
        dict(name="long reads", kind="stats", paths=[lpath], kw=LONG_FILTER,
             outdir=d("long")),
        dict(name="filter", kind="cli", outdir=d("filter"),
             argv=["filter", "-f", m1] + _argv(BENCH_FILTER)),
        dict(name="edit", kind="cli", outdir=d("edit"),
             argv=["edit", "-f", m1, "--left-length", "10",
                   "--left-quality-range", "28,60"]),
        dict(name="cgr", kind="cgr", paths=[m1],
             kw=dict(k=7, write_gs=True), outdir=d("cgr")),
        dict(name="stats, warm", kind="stats", paths=[m1], kw=BENCH_FILTER,
             outdir=d("warm")),
    ]
    res = spawn_ranks(devices, runs, tmp)
    for name, ranks in res.items():
        check({r["world"] for r in ranks} == {world},
              "%s: ranks saw world sizes %s, not %d"
              % (name, [r["world"] for r in ranks], world))
        check([r["device"] for r in ranks] == devices,
              "%s: ranks ran on %s, not %s"
              % (name, [r["device"] for r in ranks], devices))
    check_ranks_stats(res["stats"], cached_reference(
        reference_stats, recs1, **BENCH_FILTER), "sharded stats")
    check_ranks_stats(res["paired"], cached_reference(
        reference_paired_stats, recs1, recs2, **BENCH_FILTER),
        "sharded paired stats")
    check_ranks_stats(res["long reads"], cached_reference(
        reference_stats, lrecs, **LONG_FILTER), "sharded long reads")
    for name in ("stats", "paired", "long reads", "cgr"):
        run = next(r for r in runs if r["name"] == name)
        for rank in range(1, world):
            check(os.listdir("%s.rank%d" % (run["outdir"], rank)) == [],
                  "sharded %s: rank %d wrote files" % (name, rank))
    if device == "cuda":
        for name, kernel in (("stats", "K1 2u"), ("paired", "K1"),
                             ("long reads", "K2")):
            check(all(r["launches"][kernel] > 0 for r in res[name]),
                  "sharded %s: a rank launched %s no time (%s)"
                  % (name, kernel, [r["launches"] for r in res[name]]))
    check(os.path.exists(os.path.join(d("stats") + ".rank0",
                                      os.path.basename(m1)
                                      + ".summary.txt")),
          "sharded stats: rank 0 wrote no report")
    ok = cached_reference(reference_verdicts, recs1, **BENCH_FILTER)
    check(sorted(os.listdir(d("filter"))) == ["failed.fq", "passed.fq"],
          "sharded filter wrote %s" % sorted(os.listdir(d("filter"))))
    for name, sel in (("passed.fq", ok), ("failed.fq", ~ok)):
        with open(os.path.join(d("filter"), name), "rb") as f:
            check(f.read() == fastq_bytes(recs1, sel),
                  "sharded filter: %s differs from the reference's "
                  "selection" % name)
    files, _, _, _ = edit_expect("edit", (m1,), (recs1,), EDIT_TRIM)
    check(sorted(os.listdir(d("edit"))) == sorted(files),
          "sharded edit wrote %s" % sorted(os.listdir(d("edit"))))
    for name, want in files.items():
        with open(os.path.join(d("edit"), name), "rb") as f:
            check(f.read() == want, "sharded edit: %s differs from the "
                  "reference" % name)
    base = os.path.join(d("cgr") + ".rank0", os.path.basename(m1) + "_k=7")
    for r in res["cgr"]:
        ts, tq, words = r["tables"]
        cgr_check({"table_seq": ts, "table_q": tq, "fq_word_count": words,
                   "pgm_files": [base + "_FG.pgm"],
                   "gs_file": base + ".gs"}, (recs1,), 7, tmp,
                  "sharded cgr, rank %d" % r["rank"])
    return res


def startup_s(ranks):
    """Seconds from the launch to the first rank's first stats batch."""
    firsts = [r["first_batch"] for r in ranks if r["first_batch"]]
    check(firsts, "no rank timed its first batch")
    return min(firsts) - ranks[0]["launched_at"]


def startup_split(ranks):
    """Rank 0's start-up split by stage (``hpgq_torch.dist.launch``'s
    ``launch-*`` stages, from the launcher's stamps and the rank's first
    stats batch), as text; the stages must sum to rank 0's own seconds
    from the launch to its first batch within 0.1 s."""
    from hpgq_torch.dist.launch import startup_stages

    r0 = next(r for r in ranks if r["rank"] == 0)
    stages = startup_stages(dict(r0["stamps"],
                                 first_batch=r0["first_batch"]))
    own = r0["first_batch"] - r0["launched_at"]
    check(len(stages) == 6 and abs(sum(stages.values()) - own) <= 0.1,
          "rank 0's start-up stages %s sum to %.3f s, not to its %.3f s "
          "from the launch to its first batch"
          % (stages, sum(stages.values()), own))
    return "rank 0 %.2f s = %s (the parent's Process.start() %.3f s)" % (
        own, " + ".join("%s %.3f" % (k[len("launch-"):], v)
                        for k, v in stages.items()),
        r0["parent"]["start_s"])


def stats_in_process(path, outdir, device="cuda"):
    """``hpgq_torch.stats(path, sharded=True)`` with the bench filter on
    ``device`` at world size 1 in this process, with no launcher (no
    group), as on a one-card host.  Where several cards are visible, the API would start
    a rank on each (the launched runs of phase 13 cover that), so the
    rank plan is held to ``cuda:0`` for this call."""
    import torch

    import hpgq_torch
    from hpgq_torch.dist import mesh

    plan = mesh.rank_devices
    if torch.cuda.device_count() > 1:
        mesh.rank_devices = lambda opts, device="cuda": [
            torch.device("cuda", 0)]
    try:
        return hpgq_torch.stats(path, outdir=outdir, device=device,
                                sharded=True, **BENCH_FILTER)
    finally:
        mesh.rank_devices = plan


def sharded_world1(m1, recs1, outdir, device, tmp):
    """World size 1: in this process with no launcher (no group), and in
    one subprocess with the launcher's variables (a gloo group of one over
    ``env://``); ``stats`` with the bench filter, each equal to the
    reference.  Returns (counters, launches, the subprocess's result)."""
    from hpgq_torch.oracle import assert_counters_equal, reference_stats

    want = cached_reference(reference_stats, recs1, **BENCH_FILTER)
    reset_counts()
    got = stats_in_process(m1, outdir, device)
    launches = launch_counts()
    assert_counters_equal(got, want, "sharded stats, world size 1")
    (res,) = launcher_variables_rank(
        [dict(name="stats", kind="stats", paths=[m1], kw=BENCH_FILTER,
              outdir=outdir + ".launched")], device, tmp)["stats"]
    check(res["world"] == 1, "world size 1 with the launcher: the rank saw "
          "world size %d" % res["world"])
    check_ranks_stats([res], want, "sharded stats, launched, world size 1")
    return got, launches, res


def launched_world1(m1, recs1, outdir, device, tmp):
    """One rank started by the port's launcher (on ``cuda:0``): a first
    ``stats`` pass with the bench filter and a warm one, each equal to the
    reference.  Returns the results by run."""
    from hpgq_torch.oracle import reference_stats

    want = cached_reference(reference_stats, recs1, **BENCH_FILTER)
    run = dict(name="stats", kind="stats", paths=[m1], kw=BENCH_FILTER,
               outdir=outdir + ".first")
    (dev,) = rank_devices(1, device)
    one = spawn_ranks([dev], [run, dict(run, name="stats, warm",
                                        outdir=outdir + ".warm")], tmp)
    for name, (r,) in one.items():
        check(r["world"] == 1 and r["device"] == dev,
              "%s, one launched rank: world %d on %s" % (name, r["world"],
                                                         r["device"]))
        check_ranks_stats([r], want, "sharded stats, one rank started by "
                          "the launcher, " + name)
    return one


def cli_sharded(m1, recs1, outdir, device):
    """``python -m hpgq_torch stats --sharded`` with the bench filter, a
    subprocess with no launcher variables (jax and ``hpgq`` blocked): it
    starts one rank per card (one process on one card) and says so in its
    log, and its report equals the reference's.  Returns (the log's line,
    the seconds)."""
    import subprocess

    import torch

    from hpgq_torch.core.counters import StatsCounters
    from hpgq_torch.oracle import COUNTER_ARRAYS, COUNTER_KEYS, reference_stats
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.report.stats_report import stats_report

    got_dir, want_dir = outdir + ".cli", outdir + ".want"
    for d in (got_dir, want_dir):
        os.makedirs(d)
    log = os.path.join(outdir + ".cli", "log")
    argv = (["stats", "-f", m1, "-o", got_dir, "--sharded", "--log-file",
             log, "--device", device] + _argv(BENCH_FILTER))
    run = ("import runpy, sys\n"
           "for n in %r:\n    sys.modules[n] = None\n"
           "sys.argv = ['hpgq_torch'] + %r\n"
           "runpy.run_module('hpgq_torch', run_name='__main__')\n"
           % (BLOCKED, argv))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", run], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=600)
    secs = time.perf_counter() - t0
    check(p.returncode == 0, "stats --sharded exited %d: %s"
          % (p.returncode, p.stderr[-3000:]))
    check(p.stdout.count("RESULTS") == 1, "stats --sharded printed %d "
          "RESULTS blocks" % p.stdout.count("RESULTS"))
    with open(log) as f:
        said = [ln.split("hpgq: ", 1)[1] for ln in f.read().splitlines()
                if "hpgq: --sharded: " in ln]
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cpu":
        expect = "--sharded: 1 process on cpu: the run is on the cpu"
    elif cards == 1:
        expect = "--sharded: 1 process on cuda:0: one visible card"
    else:
        expect = "--sharded: %d ranks, one per card: %s" % (
            cards, ", ".join(rank_devices(cards)))
    check(said == [expect], "stats --sharded logged %s, not %r"
          % (said, expect))
    ref = cached_reference(reference_stats, recs1, **BENCH_FILTER)
    c = StatsCounters(phred=33)
    for k in COUNTER_KEYS + ("acc_quality",):
        setattr(c, k, getattr(ref, k))
    for k in COUNTER_ARRAYS:
        setattr(c, k, getattr(ref, k))
    c.filter_on = True
    o = StatsOptions(in_filename=m1, out_dirname=want_dir,
                     read_length_range="%d,%d"
                     % BENCH_FILTER["read_length_range"],
                     read_quality_range="%d,%d"
                     % BENCH_FILTER["read_quality_range"])
    crit = o.criteria
    crit.min_read_length, crit.max_read_length = \
        BENCH_FILTER["read_length_range"]
    crit.min_read_quality, crit.max_read_quality = \
        BENCH_FILTER["read_quality_range"]
    crit.max_N = BENCH_FILTER["max_N"]
    stats_report(c, o)
    same_report_set(got_dir, m1, want_dir, m1, "stats --sharded, the CLI")
    return said[0], secs


def failing_rank_job(pid_dir):
    """Phase 13's failing rank: every rank notes its pid; rank 1 raises,
    rank 0 waits in a collective for it."""
    import torch.distributed as dist

    from hpgq_torch.dist import mesh

    with open(os.path.join(pid_dir, "rank%d" % dist.get_rank()), "w") as f:
        f.write(str(os.getpid()))
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.barrier(mesh.initialize_distributed("cuda"))


def start_failing_rank(tmp, devices):
    """Start ``--failing-ranks DIR DEVICE...`` in a subprocess: the
    launcher on ``devices``, whose rank 1 raises.  Returns the function
    that waits for it and checks that the parent exited non-zero within
    60 s and left no rank running; it returns the seconds."""
    import subprocess

    pids = tempfile.mkdtemp(dir=tmp)
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--failing-ranks", pids] + devices,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)

    def finish():
        try:
            _, err = p.communicate(
                timeout=max(1.0, 60 - (time.perf_counter() - t0)))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        secs = time.perf_counter() - t0
        check(p.returncode != 0 and "rank 1 fails on purpose" in err,
              "a failing rank: the parent exited %d: %s"
              % (p.returncode, err[-2000:]))
        check(secs < 60, "a failing rank: the parent took %.1f s" % secs)
        left = []
        for name in os.listdir(pids):
            with open(os.path.join(pids, name)) as f:
                pid = int(f.read())
            try:
                with open("/proc/%d/stat" % pid) as f:
                    if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                        left.append(pid)
            except OSError:
                pass
        check(os.listdir(pids) and not left, "a failing rank: ranks %s of "
              "%s still run" % (left, os.listdir(pids)))
        return secs

    return finish


def legacy_qc_filter(m1, recs1, outdir, device):
    """``python -m hpgq_torch --qc --filter`` with the legacy spellings of
    the bench filter: ``<input>.valid`` and ``.invalid`` equal the
    reference's selection, and the two summaries equal the reports of
    ``reference_stats`` over the selected and the rejected records."""
    import subprocess

    from hpgq_torch.core.counters import StatsCounters
    from hpgq_torch.oracle import (
        COUNTER_ARRAYS,
        COUNTER_KEYS,
        fastq_bytes,
        reference_stats,
        reference_verdicts,
    )
    from hpgq_torch.report.stats_report import stats_report
    from hpgq_torch.options import StatsOptions

    os.makedirs(outdir, exist_ok=True)
    lo, hi = BENCH_FILTER["read_length_range"]
    qlo, qhi = BENCH_FILTER["read_quality_range"]
    argv = ["--qc", "--filter", "--fq", m1, "--outdir", outdir,
            "--min-read-length", str(lo), "--max-read-length", str(hi),
            "--min-quality", str(qlo), "--max-quality", str(qhi),
            "--max-n-per-read", str(BENCH_FILTER["max_N"]),
            "--log-file", os.path.join(outdir, "log"), "--device", device]
    run = ("import runpy, sys\n"
           "for n in %r:\n    sys.modules[n] = None\n"
           "sys.argv = ['hpgq_torch'] + %r\n"
           "runpy.run_module('hpgq_torch', run_name='__main__')\n"
           % (BLOCKED, argv))
    p = subprocess.run([sys.executable, "-c", run], capture_output=True,
                       text=True, cwd=REPO, timeout=600)
    check(p.returncode == 0, "legacy --qc --filter exited %d: %s"
          % (p.returncode, p.stderr[-3000:]))
    ok = cached_reference(reference_verdicts, recs1, **BENCH_FILTER)
    name = os.path.basename(m1)
    for suffix, sel in ((".valid", ok), (".invalid", ~ok)):
        with open(os.path.join(outdir, name + suffix), "rb") as f:
            check(f.read() == fastq_bytes(recs1, sel), "legacy --qc "
                  "--filter: %s%s differs from the reference's selection"
                  % (name, suffix))
        ref = reference_stats([r for r, s in zip(recs1, sel) if s])
        c = StatsCounters(phred=33)
        for k in COUNTER_KEYS + ("acc_quality",):
            setattr(c, k, getattr(ref, k))
        for k in COUNTER_ARRAYS:
            setattr(c, k, getattr(ref, k))
        want_dir = tempfile.mkdtemp(dir=outdir)
        stats_report(c, StatsOptions(in_filename=name + suffix,
                                     out_dirname=want_dir))
        summary = name + suffix + ".summary.txt"
        with open(os.path.join(outdir, summary), "rb") as f:
            got = f.read().replace(outdir.encode(), b"<OUT>")
        with open(os.path.join(want_dir, summary), "rb") as f:
            want = f.read().replace(want_dir.encode(), b"<OUT>")
        same_report(got, want, summary)
    return int(ok.sum()), int((~ok).sum())


def same_report(got, want, label):
    """Byte equality, except that the ``Mean quality`` line (the f32
    ``acc_quality`` sum, whose order differs) may differ by 1e-3
    relative."""
    lg, lw = got.split(b"\n"), want.split(b"\n")
    check(len(lg) == len(lw), "%s: %d lines, the reference %d"
          % (label, len(lg), len(lw)))
    for a, b in zip(lg, lw):
        if a != b:
            check(a.startswith(b"Mean quality = ")
                  and b.startswith(b"Mean quality = "),
                  "%s: %r, the reference %r" % (label, a, b))
            qa, qb = (int(x.split(b"=")[1].split()[0]) for x in (a, b))
            check(abs(qa - qb) <= 1e-3 * max(abs(qb), 1),
                  "%s: %r, the reference %r" % (label, a, b))


def phase_sharded(tmp, smi, ranks=None):
    """Phase 13: ``--sharded`` at world size 1 (no launcher, the
    launcher's variables, one rank started by the port's launcher),
    ``ranks`` ranks started by the port's launcher (by default two sharing
    the card on one card, one per card on several), the legacy ``--qc
    --filter`` run, ``python -m hpgq_torch stats --sharded`` with no
    launcher, a failing rank, and the rates of one warm pass at world
    size 1 and at ``ranks``.  Returns the launches of K1's plain and 2u
    entries and of K2 on these paths."""
    import torch

    cards = torch.cuda.device_count()
    world = ranks or (cards if cards > 1 else 2)
    m1, recs1 = bench_corpus(tmp)
    corpora = (bench_corpus(tmp), bench_corpus(tmp, seed=8), long_corpus(tmp))
    t0 = time.perf_counter()
    w1 = tempfile.mkdtemp(dir=tmp)
    got, n1, res = sharded_world1(m1, recs1, w1, "cuda", tmp)
    one = launched_world1(m1, recs1, w1, "cuda", tmp)
    n_one = [one[n][0]["launches"] for n in one]
    check(n1["K1 2u"] > 0 and res["launches"]["K1 2u"] > 0
          and all(n["K1 2u"] > 0 for n in n_one),
          "sharded stats at world size 1 launched K1's 2u entry no time "
          "(%s, launched %s, %s)" % (n1, res["launches"], n_one))
    say("sharded", "world size 1, no launcher (no group): launches %s; "
        "launched (RANK=0 WORLD_SIZE=1, env://): %s, launches %s; one rank "
        "started by hpgq_torch.dist.launch on %s: launches %s; all == "
        "reference (%d passed) in %.1f s"
        % (n1, res["device"], res["launches"], one["stats"][0]["device"],
           n_one, got.num_passed, time.perf_counter() - t0))
    # the failing-rank check runs beside the legacy run, which it does not
    # time
    failing = start_failing_rank(tmp, rank_devices(2))
    t0 = time.perf_counter()
    n_pass, n_fail = legacy_qc_filter(m1, recs1, tempfile.mkdtemp(dir=tmp),
                                      "cuda")
    say("sharded", "python -m hpgq_torch --qc --filter: .valid (%d) and "
        ".invalid (%d) == reference selection, both summaries == the "
        "reference's reports, in %.1f s" % (n_pass, n_fail,
                                           time.perf_counter() - t0))
    say("sharded", "a rank that raises: the parent exited non-zero in %.1f "
        "s, no rank left" % failing())
    said, secs = cli_sharded(m1, recs1, tempfile.mkdtemp(dir=tmp), "cuda")
    say("sharded", "python -m hpgq_torch stats --sharded, no launcher "
        "variables, %d card(s): %r; report == reference, in %.1f s"
        % (cards, said, secs))
    t0 = time.perf_counter()
    res2 = sharded_ranks(corpora, tempfile.mkdtemp(dir=tmp), "cuda", tmp,
                         world)
    for name, by_rank in res2.items():
        say("sharded", "world size %d, %s: gloo, devices %s, "
            "launches by rank %s, %.3f s; == reference" % (
                world, name, [r["device"] for r in by_rank],
                [r["launches"] for r in by_rank],
                max(r["secs"] for r in by_rank)))
    say("sharded", "world size %d: seven runs and their checks in %.1f s"
        % (world, time.perf_counter() - t0))

    t0 = time.perf_counter()
    stats_in_process(m1, tempfile.mkdtemp(dir=tmp))
    torch.cuda.synchronize()
    s1 = time.perf_counter() - t0
    sl = one["stats, warm"][0]["secs"]
    sn = max(r["secs"] for r in res2["stats, warm"])
    say("sharded", "sharded stats + bench filter, one warm pass: world size "
        "1 in this process %.0f reads/s (%.3f s); world size 1 through the "
        "launcher %.0f reads/s (%.3f s); world size %d through the launcher "
        "on %d card(s) %.0f reads/s (%.3f s); from the launch to the first "
        "batch: %.2f s at world size 1, %.2f s at world size %d; on %s"
        % (len(recs1) / s1, s1, len(recs1) / sl, sl, world, cards,
           len(recs1) / sn, sn, startup_s(one["stats"]),
           startup_s(res2["stats"]), world, smi))
    for n, ranks in ((1, one["stats"]), (world, res2["stats"])):
        say("sharded", "start-up by stage, world size %d: %s; on %s"
            % (n, startup_split(ranks), smi))

    def total(kernel, *names):
        return sum(r["launches"][kernel] for n in names for r in res2[n])

    return (total("K1", "paired"),
            n1["K1 2u"] + res["launches"]["K1 2u"] + total("K1 2u", "stats")
            + sum(n["K1 2u"] for n in n_one),
            total("K2", "long reads"))


# ---------------------------------------------------------------- phase 14

COALESCED = dict(read_quality_range=(18, 40), max_N=3)  # validate_device:279


def compressed_corpora(path):
    """``path`` as plain gzip (level 6, ``bench.py:92-101``) and as BGZF
    (``hpgq_torch.io.bgzf.write_bgzf``), written once per run, the two at
    once (zlib releases the interpreter lock)."""
    import concurrent.futures
    import gzip

    from hpgq_torch.io.bgzf import write_bgzf

    def gz(dst):
        with open(path, "rb") as f, gzip.open(dst, "wb", 6) as g:
            shutil.copyfileobj(f, g, 4 << 20)

    def bgz(dst):
        with open(path, "rb") as f:
            write_bgzf(dst, f.read())

    out = (path + ".gz", path + ".bgz")
    if not os.path.exists(out[1]):
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for job in [pool.submit(fn, dst) for fn, dst in zip((gz, bgz),
                                                               out)]:
                job.result()
        say("corpus", "%s as gzip (%d bytes) and as BGZF (%d bytes) in %.1f s"
            % (os.path.basename(path), os.path.getsize(out[0]),
               os.path.getsize(out[1]), time.perf_counter() - t0))
    return out


def same_report_set(got_dir, got_input, want_dir, want_input, label):
    """The report files of ``got_input`` in ``got_dir`` equal those of
    ``want_input`` in ``want_dir``, except where they name the input file
    or the directory (the summary's ``FastQ filename`` line, the chart
    scripts' paths); the ``Mean quality`` line as :func:`same_report`."""
    def reports(d, name):
        return {f[len(name):]: os.path.join(d, f) for f in os.listdir(d)
                if f.startswith(name + ".")}

    got = reports(got_dir, os.path.basename(got_input))
    want = reports(want_dir, os.path.basename(want_input))
    check(got and sorted(got) == sorted(want), "%s: report files %s, the "
          "plain input's %s" % (label, sorted(got), sorted(want)))
    for suffix in want:
        texts = []
        for d, name, path in ((got_dir, got_input, got[suffix]),
                              (want_dir, want_input, want[suffix])):
            with open(path, "rb") as f:
                texts.append(f.read().replace(d.encode(), b"<OUT>").replace(
                    os.path.basename(name).encode(), b"<INPUT>"))
        same_report(texts[0], texts[1], label + " " + suffix)


def coalesced_run(path, records, outdir, device):
    """``tools/validate_device.py:check_coalesced``: ``stats`` with
    :data:`COALESCED`, ``batch_size=10000`` set explicitly and
    ``HPGQ_COALESCE=131072``, held against the reference.  Returns (reader
    blocks, batches dispatched, launches)."""
    from hpgq_torch.api import filter_criteria
    from hpgq_torch.io.fastq import FastqReader
    from hpgq_torch.kernels import step
    from hpgq_torch.options import StatsOptions
    from hpgq_torch.oracle import assert_counters_equal, reference_stats
    from hpgq_torch.pipeline.run import run_stats

    with FastqReader(path, batch_size=10000) as rd:
        blocks = sum(1 for _ in rd)
    reset_counts()
    with mock.patch.dict(os.environ, {"HPGQ_COALESCE": "131072"}):
        got = run_stats(StatsOptions(
            in_filename=path, out_dirname=outdir,
            quality_encoding_name="phred33", batch_size=10000,
            batch_size_set=True, criteria=filter_criteria(**COALESCED),
            filter_on=True), device=device)
    dispatched = sum(step.WIRE_BATCHES.values())
    launches = launch_counts()
    assert_counters_equal(got, reference_stats(records, **COALESCED),
                          "coalesced stats")
    check(0 < dispatched < blocks, "coalesced stats dispatched %d batches "
          "for %d reader blocks" % (dispatched, blocks))
    return blocks, dispatched, launches


def profiled_runs(path, records, outdir, device):
    """``stats`` with the bench filter with and without ``--profile-dir``
    (counters equal to the reference, report files byte-equal), then
    ``filter`` with it (files equal to the reference's selection).  Each
    profiled run writes one Chrome trace.  Returns {run: (seconds,
    launches, trace events by kind)}; the kinds are ``kernel`` (device
    kernels, CUDA only), ``k1`` (K1's among them) and ``all``."""
    import torch

    from hpgq_torch.api import filter_criteria
    from hpgq_torch.options import FilterOptions, StatsOptions
    from hpgq_torch.oracle import (
        assert_counters_equal,
        fastq_bytes,
        reference_verdicts,
    )
    from hpgq_torch.pipeline.run import run_filter, run_stats

    prof = os.path.join(outdir, "prof")
    crit = filter_criteria(**BENCH_FILTER)
    want = cached_reference(reference_stats_of, records, **BENCH_FILTER)
    out, runs = {}, {}
    for run in ("stats", "stats, profiled", "filter, profiled"):
        od = out[run] = os.path.join(outdir, run.replace(", ", "_"))
        os.makedirs(od)
        kw = dict(profile_dir=prof) if "profiled" in run else {}
        cls = StatsOptions if run.startswith("stats") else FilterOptions
        opts = cls(in_filename=path, out_dirname=od,
                   quality_encoding_name="phred33", criteria=crit,
                   filter_on=True, **kw)
        before = set(os.listdir(prof)) if os.path.isdir(prof) else set()
        reset_counts()
        t0 = time.perf_counter()
        got = (run_stats if cls is StatsOptions else run_filter)(
            opts, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        events = {}
        if kw:
            new = sorted(set(os.listdir(prof)) - before)
            check(len(new) == 1 and new[0].endswith(".pt.trace.json"),
                  "%s: wrote %s into the profile directory" % (run, new))
            with open(os.path.join(prof, new[0])) as f:
                evs = json.load(f)["traceEvents"]
            kernels = [e for e in evs if e.get("cat") == "kernel"]
            events = {"all": len(evs), "kernel": len(kernels),
                      "k1": sum("stats_k1_kernel" in e.get("name", "")
                                for e in kernels)}
            check(events["all"] > 0, "%s: an empty trace" % run)
        runs[run] = (secs, launch_counts(), events)
        if cls is StatsOptions:
            assert_counters_equal(got, want, run)
        else:
            ok = cached_reference(reference_verdicts, records, **BENCH_FILTER)
            for name, sel in (("passed.fq", ok), ("failed.fq", ~ok)):
                with open(os.path.join(od, name), "rb") as f:
                    check(f.read() == fastq_bytes(records, sel), "%s: %s "
                          "differs from the reference's selection"
                          % (run, name))
    names = sorted(os.listdir(out["stats"]))
    check(names and names == sorted(os.listdir(out["stats, profiled"])),
          "the profiled stats run wrote other files")
    for name in names:
        with open(os.path.join(out["stats"], name), "rb") as a, \
                open(os.path.join(out["stats, profiled"], name), "rb") as b:
            check(a.read().replace(out["stats"].encode(), b"<OUT>")
                  == b.read().replace(out["stats, profiled"].encode(),
                                      b"<OUT>"),
                  "profiled stats: %s differs from the unprofiled run's"
                  % name)
    return runs


def reference_stats_of(records, **kw):
    from hpgq_torch.oracle import reference_stats

    return reference_stats(records, **kw)


def input_runs(path, records, tmp, device, n_coalesced=100_000):
    """Phase 14's checks on ``device``: ``stats`` + bench filter over
    ``path`` as gzip and as BGZF (counters equal to the reference, report
    sets equal to the plain input's but for its name), ``cgr`` k=7 over
    the gzip file, ``filter`` over the BGZF file, the coalesced run and
    the profiled runs.  Returns {run: (seconds, launches, detail)}."""
    import torch

    import hpgq_torch
    from gen import make_fastq
    from hpgq_torch.oracle import assert_counters_equal
    from hpgq_torch.pipeline import cgr_run

    gz, bgz = compressed_corpora(path)
    want = cached_reference(reference_stats_of, records, **BENCH_FILTER)
    plain = tempfile.mkdtemp(dir=tmp)
    run_stats_kw(path, plain, device, **BENCH_FILTER)
    out = {}
    for label, cpath in (("stats, gzip", gz), ("stats, BGZF", bgz)):
        od = tempfile.mkdtemp(dir=tmp)
        reset_counts()
        t0 = time.perf_counter()
        got = run_stats_kw(cpath, od, device, **BENCH_FILTER)
        secs = time.perf_counter() - t0
        out[label] = (secs, launch_counts(), got.num_passed)
        assert_counters_equal(got, want, label)
        same_report_set(od, cpath, plain, path, label)
    cgr_run.BATCHES.clear()
    reset_counts()
    t0 = time.perf_counter()
    res = hpgq_torch.cgr(gz, outdir=tempfile.mkdtemp(dir=tmp), k=7,
                         write_gs=True, device=device)
    out["cgr k=7, gzip"] = (time.perf_counter() - t0, launch_counts(),
                            cgr_check(res, (records,), 7, tmp, "cgr, gzip"))
    check({d for d, _ in cgr_run.BATCHES} == {device},
          "cgr over gzip: a batch ran off the %s (%s)" % (device,
                                                         cgr_run.BATCHES))
    reset_counts()
    (res, batches, secs), = filter_runs(
        [("filter, BGZF", (bgz,), (records,), BENCH_FILTER)], tmp,
        device).values()
    out["filter, BGZF"] = (secs, launch_counts(), res["num_passed"])
    check({d for d, _ in batches} == {device},
          "filter over BGZF: a verdict ran off the %s (%s)" % (device,
                                                              batches))
    cpath, crecs = cached_corpus(
        os.path.join(tmp, "devval_%d.fq" % n_coalesced),
        lambda p: make_fastq(p, n_coalesced, min_len=100, max_len=100,
                             n_prob=0.005, seed=7))
    t0 = time.perf_counter()
    blocks, dispatched, launches = coalesced_run(
        cpath, crecs, tempfile.mkdtemp(dir=tmp), device)
    out["coalesced stats"] = (time.perf_counter() - t0, launches,
                              (blocks, dispatched))
    for run, res in profiled_runs(path, records, tempfile.mkdtemp(dir=tmp),
                                  device).items():
        out[run] = res
    if device == "cuda":
        torch.cuda.synchronize()
    return out


def phase_inputs(tmp):
    """Phase 14; returns the launches of K1's plain and 2u entries."""
    path, records = bench_corpus(tmp)
    t0 = time.perf_counter()
    runs = input_runs(path, records, tmp, "cuda")
    for run, (secs, n, detail) in runs.items():
        say("inputs", "%s: %.3f s, launches %s; == reference (%s)"
            % (run, secs, n, detail))
    check(all(runs[r][1]["K1 2u"] > 0 for r in ("stats, gzip", "stats, BGZF",
                                               "stats, profiled")),
          "gzip, BGZF and profiled stats must launch K1's 2u entry")
    blocks, dispatched = runs["coalesced stats"][2]
    k1 = runs["coalesced stats"][1]["K1"]
    check(0 < k1 < blocks, "coalesced stats: %d K1 launches for %d reader "
          "blocks" % (k1, blocks))
    ev = runs["stats, profiled"][2]
    check(ev["k1"] > 0, "the profiled stats trace holds no K1 event (%s)"
          % ev)
    check(runs["filter, profiled"][2]["kernel"] > 0,
          "the profiled filter trace holds no device kernel")
    say("inputs", "coalesced: %d reader blocks of 10,000 reads went to %d K1 "
        "launch(es); profiled stats: trace of %d events, %d device kernels, "
        "%d of them K1, %.3f s against %.3f s unprofiled"
        % (blocks, k1, ev["all"], ev["kernel"], ev["k1"],
           runs["stats, profiled"][0], runs["stats"][0]))
    say("inputs", "checks took %.1f s" % (time.perf_counter() - t0))

    def total(kernel):
        return sum(r[1][kernel] for r in runs.values())

    return total("K1"), total("K1 2u")


# ---------------------------------------------------------------- phase 15

FUZZ_SEED, FUZZ_ROUNDS = 4, 12  # seed 4's 12 rounds draw sharded,
# checkpointed and paired rounds of every command


def fuzz_rounds(device, rounds=FUZZ_ROUNDS, seed=FUZZ_SEED, max_n=4000):
    """``tools/fuzz_torch.py``'s rounds on ``device``, each held against
    the oracle there; returns [(config, launches, seconds)]."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fuzz_torch

    cfgs = fuzz_torch.configs(rounds, seed, max_n)
    check({c["cmd"] for c in cfgs} == set(fuzz_torch.COMMANDS),
          "the fuzz rounds draw %s" % sorted({c["cmd"] for c in cfgs}))
    out = []
    for cfg in cfgs:
        reset_counts()
        t0 = time.perf_counter()
        try:
            fuzz_torch.run_round(cfg, device)
        except AssertionError as e:
            raise SmokeFailure("fuzz round %d: %s; config %s"
                               % (cfg["round"], e,
                                  json.dumps(cfg, sort_keys=True)))
        out.append((cfg, launch_counts(), time.perf_counter() - t0))
    return out


def phase_fuzz():
    """Phase 15; returns the launches of K1's plain and 2u entries."""
    t0 = time.perf_counter()
    rounds = fuzz_rounds("cuda")
    for cfg, n, secs in rounds:
        say("fuzz", "round %d: %s%s%s%s, %d reads, wire %s, batch %d: %.2f s, "
            "launches %s; == reference" % (
                cfg["round"], cfg["cmd"], ", paired" * cfg["paired"],
                ", sharded" * cfg["sharded"],
                ", interrupted and resumed" * bool(cfg.get("interrupted")),
                cfg["n"], cfg["wire"], cfg["batch_size"], secs, n))
    k1 = sum(n["K1"] for _, n, _ in rounds)
    k1u = sum(n["K1 2u"] for _, n, _ in rounds)
    check(k1 + k1u > 0, "the fuzz rounds launched K1 no time")
    say("fuzz", "%d rounds (seed %d), every one == reference, in %.1f s"
        % (len(rounds), FUZZ_SEED, time.perf_counter() - t0))
    return k1, k1u


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,7,8,9,10,11,12,13,14,15",
                    help="comma-separated phases to run (default 1-5 and "
                         "7-15, every phase; the card and the build always "
                         "run)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of phase 13's multi-rank runs (default: one "
                         "per card, or two sharing the card on one card); "
                         "ranks share the cards round-robin")
    ap.add_argument("--rank-worker", metavar="JOB", default=None,
                    help=argparse.SUPPRESS)  # one rank of phase 13
    ap.add_argument("--failing-ranks", nargs="+", default=None,
                    help=argparse.SUPPRESS)  # DIR DEVICE...: phase 13
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}
    for name in BLOCKED:  # any import of jax or hpgq now fails the run
        sys.modules[name] = None
    if args.rank_worker:
        sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
        os.environ["HPGQ_CHARTS"] = "off"
        rank_worker(args.rank_worker)
        return 0
    if args.failing_ranks:
        sys.path.insert(0, REPO)
        from hpgq_torch.dist.launch import launch

        launch(failing_rank_job, (args.failing_ranks[0],),
               args.failing_ranks[1:])
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    os.environ["HPGQ_CHARTS"] = "off"
    try:
        from hpgq_torch.device import gpu_name_and_power_limit
        from hpgq_torch.kernels import build
    except ImportError as e:
        print("chip_smoke: the hpgq_torch package is missing next to this "
              "script (%s)" % e, file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    smi = gpu_name_and_power_limit().splitlines()[0]
    say("card", "nvidia-smi: %s | torch: %s | count %d | torch %s, CUDA %s"
        % (smi, torch.cuda.get_device_name(0), torch.cuda.device_count(),
           torch.__version__, torch.version.cuda))
    t0 = time.perf_counter()
    build.load(verbose=True)
    say("build", "K1 and K2 built and loaded in %.1f s"
        % (time.perf_counter() - t0))

    def entry(name, source, replaces):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0, "max_abs_err": None,
                "ms": None, "plain_ms": None, "bound_ms": None,
                "bound_by": None, "library_ms": None}

    k1 = entry("K1 stats_k1_kernel, plain entry",
               "hpgq_torch/kernels/csrc/stats_k1.cu",
               "hpgq/kernels/stats_pallas.py:60")
    k1u = entry("K1 stats_k1_kernel, 2u entry",
                "hpgq_torch/kernels/csrc/stats_k1.cu",
                "hpgq/kernels/stats_pallas.py:60")
    k2 = entry("K2 stats_k2_rows + stats_k2_positions",
               "hpgq_torch/kernels/csrc/stats_k2.cu",
               "hpgq/kernels/stats_pallas.py:281")
    tmp = tempfile.mkdtemp(prefix="hpgq_torch_smoke_")
    se_passed = None
    running = []

    def clock(phase):
        """Print the seconds of the phase that ran until now."""
        now = time.perf_counter()
        if running:
            say("time", "phase %d took %.1f s" % (running[0], now
                                                   - running[1]))
        running[:] = [] if phase is None else [phase, now]

    try:
        # launches come from the paths that drive each kernel: the main
        # path (phase 4) and paired stats with no filter (9) for the 2u
        # entry; the other wire tiers (5), the paired filter (9) and stats
        # over the trimmed short reads (11) for the plain entry; long
        # reads (8) and stats over the trimmed long reads (11) for K2
        if 3 in phases:
            clock(3)
            res = phase_kernel(dev)
            k1.update(res["K1"])
            k1u.update(res["K1 2u"])
        if 7 in phases:
            clock(7)
            k2.update(phase_k2(dev))
        if 4 in phases:
            clock(4)
            n, se_passed = phase_end_to_end(tmp)
            k1u["launches"] += n
        if 5 in phases:
            clock(5)
            k1["launches"] += phase_tiers(tmp)
        if 8 in phases:
            clock(8)
            k2["launches"] += phase_long_reads(tmp)
        if 9 in phases:
            clock(9)
            n_plain, n_2u, n_k2 = phase_paired(tmp)
            k1["launches"] += n_plain
            k1u["launches"] += n_2u
            k2["launches"] += n_k2
        if 10 in phases:
            clock(10)
            phase_filter(tmp, se_passed)
        if 11 in phases:
            clock(11)
            n_plain, n_k2 = phase_edit(tmp)
            k1["launches"] += n_plain
            k2["launches"] += n_k2
        if 12 in phases:
            clock(12)
            phase_cgr(tmp)
        if 13 in phases:
            clock(13)
            n_plain, n_2u, n_k2 = phase_sharded(tmp, smi, args.ranks)
            k1["launches"] += n_plain
            k1u["launches"] += n_2u
            k2["launches"] += n_k2
        if 14 in phases:
            clock(14)
            n_plain, n_2u = phase_inputs(tmp)
            k1["launches"] += n_plain
            k1u["launches"] += n_2u
        if 15 in phases:
            clock(15)
            n_plain, n_2u = phase_fuzz()
            k1["launches"] += n_plain
            k1u["launches"] += n_2u
        clock(None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": [k1, k1u, k2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
