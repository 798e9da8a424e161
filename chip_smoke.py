#!/usr/bin/env python3
"""Smoke run of the hpgq_torch port on one CUDA card.

    python3 chip_smoke.py            # every phase (needs one NVIDIA GPU)
    python3 chip_smoke.py --phases 1,2,3

Phases, each printing its own lines:

1. The card: ``nvidia-smi`` name and power limit, torch's device name.
2. The build: compile the K1 kernel from ``hpgq_torch/kernels/csrc``.
3. K1 against its plain PyTorch twin on the same CUDA tensors: the
   131072 x 128 main-path batch, ragged batches, and five filter settings.
   Integer fields must match exactly; ``acc_quality`` to 1e-4 relative
   (per-block f32 sums are added in another order than torch's).
4. End to end: ``hpgq_torch.stats`` with the bench's inline filter over a
   generated 1,000,000 x 100 bp RTA3-binned corpus on ``cuda``, held
   against ``hpgq_torch.oracle``, a plain numpy reference computed from
   the generated reads themselves (every integer counter exact,
   ``acc_quality`` to 1e-3), with K1 launches and the 2u wire tier
   required; then reads/s of three warm passes.
5. The other wire tiers (2c, 2q, 6-bit, 7-bit, plain) on 200k reads of
   60-150 bp, each held against the reference.
6. Only when asked for: ``hpgq_torch.breakdown`` over the phase-4 corpus
   (end-to-end arms in turns, each stage alone, the device's busy share).

Imports nothing of jax: the run blocks ``import jax``, so a path that
needed it would fail here.  Any failure exits non-zero before the result
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
TILE = 64  # rows per K1 block, for the ragged shapes

INT_KEYS = ("num_reads", "acc_length", "min_length", "max_length",
            "base_totals", "length_hist", "quality_hist", "gc_hist",
            "cov_per_nt", "qual_per_nt", "base_per_nt", "_passed_mask")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print("[%s] %s" % (phase, msg), flush=True)


# ---------------------------------------------------------------- inputs

def make_batch(B, L, seed, lens=None, valid_frac=1.0, binned=True):
    """(codes int8, quals uint8, lens int32, valid bool) numpy, packer
    layout: codes 5 / quals 0 beyond each read's length."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(0, L + 1, size=B)
    lens = np.asarray(lens, dtype=np.int32)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.005] = 4
    codes[rng.random((B, L)) < 0.001] = 5
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

    keys = INT_KEYS + tuple(x for x in ("_num_passed", "_num_failed")
                            if x in p)
    for key in keys:
        a, b = k[key].cpu(), p[key].cpu()
        if not torch.equal(a.to(torch.int64), b.to(torch.int64)):
            raise SmokeFailure("%s: K1 and the plain twin differ in %s"
                               % (label, key))
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


def phase_kernel(dev):
    import torch

    from hpgq_torch.api import filter_criteria
    from hpgq_torch.kernels.stats_cuda import batch_partials_cuda
    from hpgq_torch.kernels.stats_torch import fused_partials

    crits = {name: filter_criteria(**kw) for name, kw in FILTERS.items()}
    cases = [
        # (label, B, L, lcap, lens, valid_frac)
        ("main 131072x128 len100", 131072, 128, 128, np.full(131072, 100),
         1.0),
        ("ragged B=1000 L=200 lcap=384", 1000, 200, 384, None, 0.9),
        ("ragged B=70 L=37 lcap=128", TILE + 6, 37, 128, None, 0.8),
        ("all rows invalid", 300, 128, 128, None, 0.0),
    ]
    max_err = 0.0
    for ci, (label, B, L, lcap, lens, vf) in enumerate(cases):
        arrs = make_batch(B, L, seed=100 + ci, lens=lens, valid_frac=vf)
        if lens is None:
            arrs[2][:5] = 0  # length-0 rows
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        for name, crit in crits.items():
            k = batch_partials_cuda(*t, lcap, 33, crit)
            p = fused_partials(*t, lcap, 33, crit)
            torch.cuda.synchronize()
            max_err = max(max_err, compare_partials(k, p, "%s / %s"
                                                    % (label, name)))
        say("k1", "%s: K1 == plain twin for %d filter settings"
            % (label, len(crits)))
    codes, quals, lens, valid = (torch.from_numpy(a).to(dev) for a in
                                 make_batch(131072, 128, seed=100,
                                            lens=np.full(131072, 100)))
    bench = crits["bench"]
    ms_plain = ms = None
    for turn in ("plain", "kernel", "kernel", "plain"):  # in turns
        if turn == "kernel":
            t = cuda_time_ms(lambda: batch_partials_cuda(
                codes, quals, lens, valid, 128, 33, bench))
            ms = t if ms is None else min(ms, t)
        else:
            t = cuda_time_ms(lambda: fused_partials(
                codes, quals, lens, valid, 128, 33, bench))
            ms_plain = t if ms_plain is None else min(ms_plain, t)
    say("k1", "131072x128, bench filter: K1 wrapper %.4f ms per call, plain "
        "twin %.4f ms (CUDA events, best of 2 turns of 20 calls)"
        % (ms, ms_plain))
    dev_ms = kernel_device_ms(lambda: batch_partials_cuda(
        codes, quals, lens, valid, 128, 33, bench))
    say("k1", "K1 kernel alone: %s ms of device time per launch "
        "(torch.profiler, 20 launches)"
        % ("not measured" if dev_ms is None else "%.4f" % dev_ms))
    return max_err, ms, ms_plain


def kernel_device_ms(fn, iters=20, name="stats_k1_kernel"):
    """Device time per launch of the kernel called ``name`` (profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.key.startswith(name) and ev.count:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            return us / ev.count / 1e3 if us else None
    return None


# ---------------------------------------------------------------- phases 4-5

def run_port(path, outdir, kw):
    import hpgq_torch

    return hpgq_torch.stats(path, outdir=outdir, device="cuda", **kw)


def bench_corpus(tmp):
    """The bench corpus (bench.corpus): its path and its records, written
    once per run."""
    from gen import make_fastq

    path = os.path.join(tmp, "bench_1000000_100_rta3.fq")
    if path not in _CORPUS:
        t0 = time.perf_counter()
        records = make_fastq(path, 1_000_000, min_len=100, max_len=100,
                             n_prob=0.005, seed=7, qual_bins=(2, 12, 23, 37))
        _CORPUS[path] = records
        say("corpus", "1,000,000 x 100 bp, %d bytes, written in %.1f s"
            % (os.path.getsize(path), time.perf_counter() - t0))
    return path, _CORPUS[path]


_CORPUS = {}


def phase_end_to_end(tmp, smi):
    import torch

    from hpgq_torch.kernels import stats_cuda, step
    from hpgq_torch.oracle import assert_counters_equal, reference_stats

    path, records = bench_corpus(tmp)
    out = os.path.join(tmp, "out")
    os.makedirs(out)

    stats_cuda.LAUNCHES = 0
    step.WIRE_BATCHES.clear()
    t0 = time.perf_counter()
    got = run_port(path, out, BENCH_FILTER)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = stats_cuda.LAUNCHES
    tiers = dict(step.WIRE_BATCHES)
    say("e2e", "cold pass %.3f s, K1 launches %d, wire tiers %s"
        % (cold, launches, tiers))
    check(launches > 0, "the main path launched K1 no time")
    check(tiers.get("2u", 0) > 0, "the 2u wire tier carried no batch")
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
    return launches


def phase_tiers(tmp):
    from gen import make_fastq
    from hpgq_torch.breakdown import environ
    from hpgq_torch.kernels import step
    from hpgq_torch.oracle import assert_counters_equal, reference_stats

    binned = os.path.join(tmp, "var_binned.fq")
    wide = os.path.join(tmp, "var_unbinned.fq")
    want = {
        binned: make_fastq(binned, 200_000, min_len=60, max_len=150,
                           n_prob=0.01, seed=21, qual_bins=(2, 12, 23, 37)),
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


def phase_breakdown(tmp, smi):
    """Opt-in: hpgq_torch.breakdown over the bench corpus."""
    from hpgq_torch import breakdown

    path, _ = bench_corpus(tmp)
    say("breakdown", "on %s" % smi)
    breakdown.main([path])


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated phases to run (default 1-5; 6, "
                         "the stage breakdown, runs only when asked for; "
                         "the card and the build always run)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}
    for name in ("jax", "jaxlib"):  # any import of jax now fails the run
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
    say("build", "K1 built and loaded in %.1f s" % (time.perf_counter() - t0))

    kernel = {"name": "K1 stats_k1_kernel", "route": "cuda",
              "source": "hpgq_torch/kernels/csrc/stats_k1.cu",
              "replaces": "hpgq/kernels/stats_pallas.py:60",
              "launches": None, "max_abs_err": None, "ms": None,
              "plain_ms": None}
    tmp = tempfile.mkdtemp(prefix="hpgq_torch_smoke_")
    try:
        if 3 in phases:
            err, ms, plain_ms = phase_kernel(dev)
            kernel.update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        if 4 in phases:
            kernel["launches"] = phase_end_to_end(tmp, smi)
        if 5 in phases:
            phase_tiers(tmp)
        if 6 in phases:
            phase_breakdown(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": [kernel]}))
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
