#!/usr/bin/env python3
"""Smoke run of the hpgq_torch port on one CUDA card.

    python3 chip_smoke.py            # phases 1-5 and 7-12 (one NVIDIA GPU)
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
   twin: device ms, bytes needed, GB/s, the bound and its share.
4. End to end: ``hpgq_torch.stats`` with the bench's inline filter over a
   generated 1,000,000 x 100 bp RTA3-binned corpus on ``cuda``, held
   against ``hpgq_torch.oracle``, a plain numpy reference computed from
   the generated reads themselves (every integer counter exact,
   ``acc_quality`` to 1e-3); every batch on the 2u tier must go to K1's
   2u entry, none decoded on the card; then reads/s of three warm
   passes.
5. The other wire tiers (2c, 2q, 6-bit, 7-bit, plain) on 200k reads of
   60-150 bp, each held against the reference, and one ``kmers=True`` run
   (K1 + the k-mer ride-along, k-mer tables exact).
6. Only when asked for: ``hpgq_torch.breakdown`` over the phase-4 corpus
   (end-to-end arms in turns, each stage alone, the device's busy share).
7. K2 against its plain twin on CUDA tensors, from lcap 4224 to 66048,
   ragged, empty, all-invalid and any-byte-code batches, one to seven
   reads with lengths on and off the 512-column tile edges, a width that
   is no multiple of 16, five filter settings (and a minimum quality
   alone at 24576, where the MAX sentinel times the length passes int32),
   k-mers off and on; every integer field and the pass mask exact,
   ``acc_quality`` to 1e-4.  Also at phase 8's batch shape (512 x 89472,
   mixed lengths, padding rows) and on the 512 x 32768 timed batch, with
   the NanoFilt-style filter too.  Then K2 timed against the twin on
   both, as in phase 3.
8. Long reads end to end: about 10,000 reads of 2-30 kb plus a few dozen
   of 66-90 kb (lcap past 65536), unbinned qualities; ``hpgq_torch.stats``
   with ``kmers=True`` and with a NanoFilt-style filter, each held against
   the reference (k-mer tables too), with K2 launches required; then
   reads/s and bases/s of three warm passes.
9. Paired stats: 1,000,000 pairs of 2 x 100 bp (mate 1 is phase 4's
   corpus, mate 2 the same recipe with seed 8); ``hpgq_torch.stats(m1,
   m2)`` with the bench filter and with none, both mates held against
   ``oracle.reference_paired_stats`` (statistics over the pairs where both
   mates pass, tallies per pair), every mate batch on the 2u tier: with
   the filter decoded for the pair verdict and sent to K1's plain entry,
   without it sent to the 2u entry; then pairs/s of three warm passes.
10. Filter: ``hpgq_torch.filter_reads`` single-end over phase 4's corpus
    (2c tier), paired over phase 9's pairs, and with the NanoFilt-style
    thresholds over phase 8's long reads (qn8 tier); every output file
    byte-equal to the records ``oracle.reference_verdicts`` selects, every
    verdict batch on the card; then reads/s (pairs/s) of three warm passes.

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
    the first must launch K1, the second K2.  Reads/s of three warm passes
    of the chain, of paired edit and of long-read edit.
12. CGR: ``hpgq_torch.cgr`` at k=7 with ``write_gs`` over phase 4's
    corpus and over phase 9's pairs (one signature): the tables, the word
    count and the PGM and ``.gs`` bytes equal to ``oracle.reference_cgr``
    and what ``report.pgm`` writes from it; a second run against its own
    ``.gs`` gives a zero diff.  ``cgr_batch_tables`` on the card at k=10
    and on the poly-A batch whose quality cell passes 2^31, exact.  Reads/s
    of three warm passes, and the device ms per batch of one profiled pass.

Phases 9-12 reuse the corpora of phases 4 and 8, and write them when
those phases are not selected.  On an NVIDIA H100 80GB HBM3 (700 W) the
default run takes about 390 s of command time, the build included;
``--phases 9,10`` alone takes about 135 s and ``--phases 11,12`` about
235 s, since each writes all three corpora itself (about 50 s).  The
kernels line gives K1's plain and 2u entries and K2 with their launches
on the paths that drive them (phase 4 and 9's unfiltered run for the 2u
entry; phases 5, 9's filtered run and 11's stats over the trimmed short
reads for the plain entry; phase 8 and 11's stats over the trimmed long
reads for K2).

Imports nothing of jax and nothing of the JAX package ``hpgq``: the run
blocks ``import jax`` and ``import hpgq``, so a path that needed either
would fail here.  Any failure exits non-zero before the result
lines; the last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCKED = ("jax", "jaxlib", "hpgq")  # the port needs none of them
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


def time_kernel(phase, label, kernel_fn, plain_fn, name, nbytes, nbases,
                launches_per_call=1):
    """The kernel against its plain twin on the same inputs: CUDA events in
    turns (plain, kernel, kernel, plain), then the kernels' device time
    alone (profiler); prints ms, bytes, GB/s, the bound and its share."""
    ms_plain = ms = None
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "kernel":
            t = cuda_time_ms(kernel_fn)
            ms = t if ms is None else min(ms, t)
        else:
            t = cuda_time_ms(plain_fn)
            ms_plain = t if ms_plain is None else min(ms_plain, t)
    dev_ms = kernel_device_ms(kernel_fn, launches_per_call, name=name)
    b_ms, b_by = bound(nbytes, nbases)
    k_ms = dev_ms if dev_ms is not None else ms
    say(phase, "%s: wrapper %.4f ms per call, plain twin %.4f ms (CUDA "
        "events, best of 2 turns of 20 calls); device %s ms per call "
        "(torch.profiler, %d launch(es)); %d bytes needed, %.1f GB/s; bound "
        "%.4f ms (%s), %.1f%% of the bound"
        % (label, ms, ms_plain,
           "not measured" if dev_ms is None else "%.4f" % dev_ms,
           launches_per_call, nbytes, nbytes / k_ms / 1e6, b_ms, b_by,
           100 * b_ms / k_ms))
    return {"ms": k_ms, "wrapper_ms": ms, "plain_ms": ms_plain,
            "bound_ms": b_ms, "bound_by": b_by}


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
        "stats_k1_kernel", 2 * nbases + 5 * B + output_bytes(B, 128, 2049),
        nbases)}
    wire, nv, L = wires["main 131072x52 bytes (L 100)"]
    n_exc = int((wire[1] < (B * 2 * wire[0].shape[1]) << 1).sum())
    out["K1 2u"] = time_kernel(
        "k1", "K1 2u entry, 131072x52 bytes (L 100, %d exceptions), bench "
        "filter" % n_exc,
        lambda: batch_partials_cuda_2u(*wire, nv, L, 128, 33, bench),
        lambda: plain_2u(*wire, nv, L, 128, bench),
        "stats_k1_kernel", wire[0].numel() + 4 * n_exc + 4
        + output_bytes(B, 128, 2049), nv * L)
    for key in out:
        out[key]["max_abs_err"] = err[key]
    return out


def kernel_device_ms(fn, launches, iters=20, name="stats_k1_kernel"):
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


def phase_end_to_end(tmp, smi):
    import torch

    from hpgq_torch.kernels import stats_cuda, step
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

    times = []
    for _ in range(3):  # warm passes: the spread is part of the result
        t0 = time.perf_counter()
        warm = run_port(path, out, BENCH_FILTER)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n = warm.num_passed + warm.num_failed
    say("e2e", "warm passes: %d reads in %s s; best %.0f reads/s, median "
        "%.0f reads/s, on %s" % (n, ", ".join("%.3f" % t for t in times),
                                 n / min(times), n / sorted(times)[1], smi))
    return launches["K1 2u"], got.num_passed


def phase_tiers(tmp):
    """The other wire tiers and a k-mer run; returns K1 plain-entry
    launches."""
    from gen import make_fastq
    from hpgq_torch.breakdown import environ
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
        with environ(env):
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


def phase_breakdown(tmp, smi):
    """Opt-in: hpgq_torch.breakdown over the bench corpus."""
    from hpgq_torch import breakdown

    path, _ = bench_corpus(tmp)
    say("breakdown", "on %s" % smi)
    breakdown.main([path])


# ---------------------------------------------------------------- phase 7

K2_TIME_SHAPE = (512, 32768)


def compare_k2(t, lcap, settings, label):
    """K2 (through ``make_batch_partials``) against the plain twin on the
    tensors ``t`` under each filter setting, k-mers off and on; returns
    (max abs err, the last kernel partials)."""
    import torch

    from hpgq_torch.kernels.stats_cuda import make_batch_partials
    from hpgq_torch.kernels.stats_torch import fused_partials

    err = 0.0
    for name, crit in settings.items():
        for kmers in (False, True):
            k = make_batch_partials(lcap, 33, crit, kmers)(*t)
            p = fused_partials(*t, lcap, 33, crit, kmers)
            torch.cuda.synchronize()
            err = max(err, compare_partials(
                k, p, "%s / %s / kmers %s" % (label, name, kmers)))
    say("k2", "%s: K2 == plain twin for %d filter settings x k-mers off/on"
        % (label, len(settings)))
    return err, k


def phase_k2(dev):
    """K2 against its plain twin; returns its kernels-line fields (times
    on the 512 x 32768 batch, no filter)."""
    import torch

    from hpgq_torch.api import filter_criteria
    from hpgq_torch.kernels import stats_cuda
    from hpgq_torch.kernels.stats_cuda import batch_partials_cuda_long
    from hpgq_torch.kernels.stats_torch import fused_partials

    crits = {name: filter_criteria(**kw) for name, kw in FILTERS.items()}
    long_t = None
    sentinel = {"min quality only": filter_criteria(
        read_quality_range=(5, None))}
    nanofilt = {"nanofilt": filter_criteria(**LONG_FILTER)}
    # phase 8's batches: a 16 MB block of ~490 reads of 2-30 kb (one of
    # 66-90 kb among them) padded to 512 rows, in lcap 89,472
    rng = np.random.default_rng(798)
    long_lens = rng.integers(2_000, 30_001, size=512)
    long_lens[[100, 300]] = (70_001, 89_415)
    long_lens[490:] = 0
    cases = [
        # (label, B, L, lcap, lens, valid_frac, extra settings)
        ("256x4608 lcap 4608", 256, 4608, 4608, None, 0.9, {}),
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
         np.array([20007, 0, 1, 15, 17, 4099, 10000, 20006, 512]), 1.0, {}),
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
    out = {}
    for label, t, lcap, crit in (
            ("512x32768, no filter (one sweep)", t, L, None),
            ("512x32768, NanoFilt-style filter (two sweeps)", t, L,
             nanofilt["nanofilt"]),
            ("phase 8's batch 512x89472, NanoFilt-style filter", long_t,
             89472, nanofilt["nanofilt"])):
        codes, quals, lens, valid = t
        Bt, Lt = codes.shape
        nbases = int(lens.clamp(0, Lt).sum())
        out[label] = time_kernel(
            "k2", "K2, " + label,
            lambda t=t, lcap=lcap, crit=crit: batch_partials_cuda_long(
                *t, lcap, 33, crit),
            lambda t=t, lcap=lcap, crit=crit: fused_partials(
                *t, lcap, 33, crit),
            "stats_k2_", 2 * nbases + 5 * Bt + output_bytes(Bt, lcap, Bt),
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


def long_read_runs(path, records, outdir, device):
    """``hpgq_torch.stats`` on ``device`` with ``kmers=True`` and with
    :data:`LONG_FILTER`, each held against the reference; returns
    ``{run: (counters, K1 launches, K2 launches, wire tiers, seconds)}``."""
    import torch

    import hpgq_torch
    from hpgq_torch.kernels import step
    from hpgq_torch.oracle import assert_counters_equal, reference_stats

    out = {}
    for run, kw in (("kmers", dict(kmers=True)), ("filter", LONG_FILTER)):
        reset_counts()
        t0 = time.perf_counter()
        got = hpgq_torch.stats(path, outdir=outdir, device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launch_counts()
        out[run] = (got, n["K1"] + n["K1 2u"], n["K2"],
                    dict(step.WIRE_BATCHES), secs)
        assert_counters_equal(got, reference_stats(records, **kw),
                              "long reads, " + run)
        if run == "filter":
            check(got.num_passed > 0 and got.num_failed > 0,
                  "the long-read filter passed %d and failed %d reads"
                  % (got.num_passed, got.num_failed))
    return out


def phase_long_reads(tmp, smi):
    import torch

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
    say("long", "both runs and their references took %.1f s"
        % (time.perf_counter() - t0))
    launches = runs["filter"][2]

    from hpgq_torch.breakdown import _device_ms, _fmt_busy

    times = []
    for _ in range(3):  # warm passes of the filtered run
        t0 = time.perf_counter()
        run_port(path, tempfile.mkdtemp(dir=tmp), LONG_FILTER)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n = len(records)
    say("long", "warm filtered passes: %d reads, %d bases in %s s; best "
        "%.0f reads/s (%.4g bases/s), median %.0f reads/s (%.4g bases/s), "
        "on %s" % (n, nbases, ", ".join("%.3f" % t for t in times),
                   n / min(times), nbases / min(times), n / sorted(times)[1],
                   nbases / sorted(times)[1], smi))
    for label, kw in (("no filter, no report", dict(report=False)),
                      ("kmers=True, no report", dict(kmers=True,
                                                     report=False)),
                      ("kmers=True", dict(kmers=True))):
        t0 = time.perf_counter()
        run_port(path, tempfile.mkdtemp(dir=tmp), kw)
        torch.cuda.synchronize()
        say("long", "one warm pass, %s: %.3f s"
            % (label, time.perf_counter() - t0))
    busy = _device_ms(lambda: run_port(path, tempfile.mkdtemp(dir=tmp),
                                       LONG_FILTER), torch.device("cuda", 0))
    say("long", "one profiled filtered pass: device %s" % _fmt_busy(busy))
    return launches


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


def warm_passes(fn, n, unit, smi, label, phase):
    """Three warm passes of ``fn``, printed as ``unit``/s, best and
    median, then one profiled pass: the card's busy share.  Returns that
    pass's ``breakdown._device_ms`` (None where the profiler saw no
    device)."""
    import torch

    from hpgq_torch.breakdown import _device_ms, _fmt_busy

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    say(phase, "%s, warm passes: %d %s in %s s; best %.0f %s/s, median "
        "%.0f %s/s, on %s" % (label, n, unit, ", ".join("%.3f" % t
                                                       for t in times),
                              n / min(times), unit, n / sorted(times)[1],
                              unit, smi))
    busy = _device_ms(fn, torch.device("cuda", 0))
    say(phase, "%s, one profiled pass: device %s" % (label, _fmt_busy(busy)))
    return busy


def phase_paired(tmp, smi):
    """Paired stats over 1M pairs of 2 x 100 bp; returns the launches of
    K1's plain entry (the filtered run: the pair verdict reads both mates
    decoded) and of its 2u entry (the run with no filter)."""
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
    warm_passes(lambda: run_port_paired(m1, m2, tempfile.mkdtemp(dir=tmp)),
                len(recs1), "pairs", smi, "bench filter", "paired")
    return runs["filter"][1]["K1"], runs["all"][1]["K1 2u"]


def run_port_paired(m1, m2, outdir):
    import hpgq_torch

    return hpgq_torch.stats(m1, m2, outdir=outdir, device="cuda",
                            **BENCH_FILTER)


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


def phase_filter(tmp, smi, se_passed=None):
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
    for label, paths, recs, kw in cases:
        def one(paths=paths, kw=kw):
            import hpgq_torch

            hpgq_torch.filter_reads(*paths, outdir=tempfile.mkdtemp(dir=tmp),
                                    device="cuda", **kw)
        warm_passes(one, len(recs[0]), "pairs" if len(paths) == 2
                    else "reads", smi, label, "filter")


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


def phase_edit(tmp, smi):
    """Edit and prepro on the card; returns the launches of K1's plain
    entry and of K2 by the stats passes over ``edit.fq``."""
    import hpgq_torch

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

    def chain():
        od = tempfile.mkdtemp(dir=tmp)
        res = hpgq_torch.edit(m1, outdir=od, device="cuda", **EDIT_TRIM)
        hpgq_torch.stats(res["edit_filename"], outdir=od, device="cuda")

    warm_passes(chain, len(recs1), "reads", smi, "edit -> stats chain "
                "(bench config #3)", "edit")
    for label, paths, recs, kw in (
            ("paired edit, golden settings", (m1, m2), recs1, EDIT_GOLDEN),
            ("long-read edit", (lpath,), lrecs, LONG_EDIT)):
        warm_passes(lambda paths=paths, kw=kw: hpgq_torch.edit(
            *paths, outdir=tempfile.mkdtemp(dir=tmp), device="cuda", **kw),
            len(recs), "pairs" if len(paths) == 2 else "reads", smi, label,
            "edit")
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


def phase_cgr(tmp, smi):
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
        if label == "single-end":
            nbatches = sum(batches.values())
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

    def one():
        hpgq_torch.cgr(m1, outdir=tempfile.mkdtemp(dir=tmp), k=7,
                       device="cuda")

    busy = warm_passes(one, len(recs1), "reads", smi, "cgr k=7", "cgr")
    if busy is not None:
        say("cgr", "device time per batch of the profiled pass (kernels and "
            "copies, %d batches): %.3f ms" % (nbatches, busy[0] / nbatches))


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,7,8,9,10,11,12",
                    help="comma-separated phases to run (default 1-5 and "
                         "7-12; 6, the stage breakdown, runs only when "
                         "asked for; the card and the build always run)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}
    for name in BLOCKED:  # any import of jax or hpgq now fails the run
        sys.modules[name] = None

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
    try:
        # launches come from the paths that drive each kernel: the main
        # path (phase 4) and paired stats with no filter (9) for the 2u
        # entry; the other wire tiers (5), the paired filter (9) and stats
        # over the trimmed short reads (11) for the plain entry; long
        # reads (8) and stats over the trimmed long reads (11) for K2
        if 3 in phases:
            res = phase_kernel(dev)
            k1.update(res["K1"])
            k1u.update(res["K1 2u"])
        if 7 in phases:
            k2.update(phase_k2(dev))
        if 4 in phases:
            n, se_passed = phase_end_to_end(tmp, smi)
            k1u["launches"] += n
        if 5 in phases:
            k1["launches"] += phase_tiers(tmp)
        if 8 in phases:
            k2["launches"] += phase_long_reads(tmp, smi)
        if 9 in phases:
            n_plain, n_2u = phase_paired(tmp, smi)
            k1["launches"] += n_plain
            k1u["launches"] += n_2u
        if 10 in phases:
            phase_filter(tmp, smi, se_passed)
        if 11 in phases:
            n_plain, n_k2 = phase_edit(tmp, smi)
            k1["launches"] += n_plain
            k2["launches"] += n_k2
        if 12 in phases:
            phase_cgr(tmp, smi)
        if 6 in phases:
            phase_breakdown(tmp, smi)
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
