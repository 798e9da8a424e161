"""Randomised config-space fuzzer of the hpgq_torch port: random corpora x
random criteria x the port's wire tiers x batch and coalescing knobs x
paired input x checkpoint interrupts x sharded runs, across every command
(stats, filter, edit, cgr), the port against ``hpgq_torch/oracle.py``.

    python tools/fuzz_torch.py [--rounds N] [--seed S] [--device cuda|cpu]

The port's arm of ``tools/fuzz_configs.py``, with its own copy of that
file's draws (``one_round``), over the tiers the port has: the bitpack
ladder (2u, 2c, 2q, 6-bit, 7-bit, qn8) or the plain wire; the fused4 and
pack4 wires are not ported.  Each round writes its corpus with
``tests/gen.make_records``, runs the port through its pipeline entry
points (``run_stats``, ``run_filter``, ``run_edit``, ``run_cgr``, and
``run_stats_sharded``/``run_cgr_sharded`` on a gloo group of one made in
this process) and holds the result against the oracle, computed from the
generated records: every counter equal (``acc_quality`` to 1e-3
relative), the k-mer tables when drawn, ``filter`` and ``edit`` files
byte-equal, CGR tables and word count equal.  A checkpoint round first
runs with the block iterators rigged to stop after ``stop_after`` batches,
then resumes from the checkpoint.  When there are at least four rounds,
the last ones take any command not drawn yet, so every command runs.

Exits non-zero on the first mismatch and prints the config that
reproduces it (``--replay CONFIG_JSON`` runs that round alone).
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]  # tests/gen.py: corpora

import numpy as np  # noqa: E402

COMMANDS = ("stats", "filter", "edit", "cgr")
KNOBS = ("HPGQ_WIRE", "HPGQ_QN_WIRE", "HPGQ_COALESCE", "HPGQ_WIRE6",
         "HPGQ_WIRE2C", "HPGQ_WIRE2U")


def draw(rng, rnd: int, max_n: int = 4000) -> dict:
    """One round's config, drawn as ``tools/fuzz_configs.py:49-161`` draws
    it, over the port's wires; corpora of 200 to ``max_n`` reads."""
    cfg = {
        "round": rnd,
        "n": int(rng.integers(200, max_n)),
        "min_len": int(rng.integers(1, 80)),
        "n_prob": float(rng.choice([0.0, 0.01, 0.05])),
        "lowercase_prob": float(rng.choice([0.0, 0.1])),
        "wire": str(rng.choice(["bitpack", "off"])),
        "qn": str(rng.choice(["0", "1"])),
        # the bitpack ladder's tiers, and quality shapes that reach each:
        # "binned" takes the 2-bit palette tiers, the default uniform 2..41
        # the 6-bit tier, "wide" (up to '~') misfits both
        "wire6": str(rng.choice(["0", "1"])),
        "wire2c": str(rng.choice(["0", "1"])),
        "wire2u": str(rng.choice(["0", "1"])),
        "qshape": str(rng.choice(["uniform", "uniform", "binned", "wide"])),
        "batch_size": int(rng.choice([37, 250, 1000, 10000])),
        "coalesce": int(rng.choice([0, 777, 131072])),
        "paired": bool(rng.integers(0, 2)),
        "kmers": bool(rng.integers(0, 2)),
        "cmd": str(rng.choice(COMMANDS)),
        "seed": int(rng.integers(0, 2**31)),
    }
    cfg["k"] = int(rng.choice([3, 4, 5, 7]))
    # checkpoint rounds: interrupted after a few batches, then resumed
    cfg["checkpoint"] = bool(rng.integers(0, 4) == 0)
    cfg["stop_after"] = int(rng.integers(1, 4))
    cfg["sharded"] = bool(rng.integers(0, 2) == 0)
    # a quarter of the rounds are of one length, the 2u tier's condition
    cfg["max_len"] = cfg["min_len"] + int(rng.choice(
        [0, int(rng.integers(1, 200))], p=[0.25, 0.75]))
    crit_draw = {
        "min_read_quality": int(rng.choice([-1, 18, 35])),
        "max_read_quality": int(rng.choice([-1, 40, 60])),
        "max_N": int(rng.choice([-1, 0, 2])),
        "min_read_length": int(rng.choice([-1, 30])),
        "max_read_length": int(rng.choice([-1, 150])),
        "max_out_of_quality": int(rng.choice([-1, 50])),
        "left_length": int(rng.choice([-1, 5])),
        "min_left_quality": int(rng.choice([-1, 20])),
        "max_left_quality": int(rng.choice([-1, 65])),
        "right_length": int(rng.choice([-1, 7])),
        "min_right_quality": int(rng.choice([-1, 15])),
        "max_right_quality": int(rng.choice([-1, 70])),
    }
    crit_kw = {k: v for k, v in crit_draw.items() if v != -1}
    # [D8] quality position window in a quarter of the rounds, degenerate
    # shapes (past the read, empty) included
    if rng.integers(0, 4) == 0:
        beg = int(rng.choice([0, 5, 30, 300]))
        end = int(rng.choice([20, 60, 1024]))
        if (beg, end) != (0, 1024):
            crit_kw.update(begin_quality_nt=beg, end_quality_nt=end)
    cfg["criteria"] = crit_kw
    cfg["filter_draw"] = bool(rng.integers(0, 2))
    return settle(cfg)


def settle(cfg: dict) -> dict:
    """The rules that tie a config's knobs to its command (also after a
    command is forced on it)."""
    cmd = cfg["cmd"]
    crit_kw = dict(cfg["criteria"])
    if cmd == "cgr":
        cfg["n"] = min(cfg["n"], 1500)
    if cfg["checkpoint"]:
        cfg["batch_size"] = max(20, cfg["n"] // 6)  # at least ~6 batches
        # forced coalescing would merge the corpus into one dispatch,
        # leaving nothing to interrupt after the first
        cfg["coalesce"] = 0
    cfg["sharded"] = cfg["sharded"] and cmd in ("stats", "cgr")
    filter_on = bool(crit_kw) and (cmd == "filter" or cfg["filter_draw"])
    if cmd == "filter" and not crit_kw:
        crit_kw = {"min_read_quality": 20}
        filter_on = True
    if cmd == "edit":
        if crit_kw.get("left_length", -1) < 0 \
                and crit_kw.get("right_length", -1) < 0:
            crit_kw["left_length"] = 6  # edit needs a trim window
            crit_kw.setdefault("min_left_quality", 25)
            crit_kw.setdefault("max_left_quality", 60)
        cfg["paired"] = False  # paired rides filter and stats
    if cmd == "cgr":
        filter_on = False
    cfg["criteria"] = crit_kw
    cfg["filter_on"] = filter_on
    return cfg


def corpus_kw(cfg) -> dict:
    kw = dict(min_len=cfg["min_len"], max_len=cfg["max_len"],
              n_prob=cfg["n_prob"], lowercase_prob=cfg["lowercase_prob"])
    if cfg["qshape"] == "binned":
        kw["qual_bins"] = (2, 12, 23, 37)
    elif cfg["qshape"] == "wide":
        kw["max_q"] = 93  # ASCII '~', the top of the legal range
    return kw


def write_corpus(cfg, outdir):
    """The round's input files and their records: ``([a.fq(, b.fq)],
    [records(, records)])``."""
    from gen import make_records, write_fastq

    paths, recs = [], []
    for name, seed in (("a.fq", cfg["seed"]), ("b.fq", cfg["seed"] ^ 1)):
        if name == "b.fq" and not cfg["paired"]:
            break
        recs.append(make_records(cfg["n"], seed=seed, **corpus_kw(cfg)))
        paths.append(write_fastq(os.path.join(outdir, name), recs[-1]))
    return paths, recs


@contextlib.contextmanager
def knobs(cfg):
    """The round's ``HPGQ_*`` environment, restored afterwards."""
    saved = {k: os.environ.get(k) for k in KNOBS}
    os.environ.update(
        HPGQ_WIRE=cfg["wire"], HPGQ_QN_WIRE=cfg["qn"],
        HPGQ_COALESCE=str(cfg["coalesce"]), HPGQ_WIRE6=cfg["wire6"],
        HPGQ_WIRE2C=cfg["wire2c"], HPGQ_WIRE2U=cfg["wire2u"])
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def options(cfg, cls, inputs, outdir):
    """The port's options of ``cls`` for the round."""
    from hpgq_torch.options import FilterCriteria

    o = cls(in_filename=inputs[0],
            in_filename2=inputs[1] if len(inputs) > 1 else None,
            out_dirname=outdir, quality_encoding_value=33,
            quality_encoding_name="phred33", batch_size=cfg["batch_size"],
            batch_size_set=True, criteria=FilterCriteria(**cfg["criteria"]),
            filter_on=cfg["filter_on"])
    if cls.__name__ == "StatsOptions":
        o.kmers_on = cfg["kmers"]
    if cls.__name__ == "CgrOptions":
        o.k = cfg["k"]
        o.sharded = cfg["sharded"]
    return o


@contextlib.contextmanager
def group_of_one(outdir):
    """A gloo process group of one made here, for a sharded round."""
    import torch.distributed as dist

    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method="file://" + os.path.join(outdir,
                                                                 "pg"))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _interruptible(cfg, run, opts):
    """``run(opts)``; in a checkpoint round first with the block iterators
    rigged to raise after ``stop_after`` batches, then resumed to the end
    (``tools/fuzz_configs.py:164-211``).  The port looks these iterators up
    in the modules patched here: ``run`` for the single-process loops,
    ``cgr_run`` for the checkpointed CGR loop, ``run_dist`` for the
    sharded lockstep loop."""
    if not cfg["checkpoint"]:
        return run(opts)
    from hpgq_torch.dist import run_dist
    from hpgq_torch.pipeline import cgr_run
    from hpgq_torch.pipeline import run as run_mod

    opts.checkpoint_path = os.path.join(opts.out_dirname, "fuzz.ck.npz")
    opts.checkpoint_every = 1
    calls = {"n": 0}

    def wrap(real):
        def limited(*a, **k):
            for item in real(*a, **k):
                if calls["n"] >= cfg["stop_after"]:
                    raise KeyboardInterrupt
                calls["n"] += 1
                yield item
        return limited

    sites = [(run_mod, "_iter_packed"), (run_mod, "_iter_with"),
             (run_mod, "_iter_blocks_paired"), (cgr_run, "_iter_blocks"),
             (run_dist, "iter_lockstep")]
    saved = [getattr(m, name) for m, name in sites]
    for (m, name), real in zip(sites, saved):
        setattr(m, name, wrap(real))
    cfg["interrupted"] = False
    try:
        res = run(opts)
    except KeyboardInterrupt:
        cfg["interrupted"] = True
        res = None
    finally:
        for (m, name), real in zip(sites, saved):
            setattr(m, name, real)
    if cfg["interrupted"]:
        res = run(opts)  # resume from the checkpoint
    return res


def run_port(cfg, inputs, outdir, device) -> dict:
    """Run the round's command on the port.  Returns ``{"counters": ...}``
    (stats: the counters, a pair when paired), ``{"files": {name: bytes},
    "counts": ...}`` (filter, edit) or ``{"tables": (seq, q, words)}``
    (cgr)."""
    from hpgq_torch.dist.run_dist import run_stats_sharded
    from hpgq_torch.options import (
        CgrOptions,
        EditOptions,
        FilterOptions,
        StatsOptions,
    )
    from hpgq_torch.pipeline.cgr_run import run_cgr
    from hpgq_torch.pipeline.run import run_edit, run_filter, run_stats

    cmd = cfg["cmd"]
    os.makedirs(outdir, exist_ok=True)
    with knobs(cfg), (group_of_one(outdir) if cfg["sharded"]
                      else contextlib.nullcontext()):
        if cmd == "stats":
            run = run_stats_sharded if cfg["sharded"] else run_stats
            return {"counters": _interruptible(
                cfg, lambda o: run(o, report=False, device=device),
                options(cfg, StatsOptions, inputs, outdir))}
        if cmd == "cgr":
            res = _interruptible(cfg, lambda o: run_cgr(o, device=device),
                                 options(cfg, CgrOptions, inputs, outdir))
            return {"tables": (res["table_seq"], res["table_q"],
                               res["fq_word_count"])}
        cls, run = ((FilterOptions, run_filter) if cmd == "filter"
                    else (EditOptions, run_edit))
        res = _interruptible(cfg, lambda o: run(o, device=device),
                             options(cfg, cls, inputs, outdir))
    return {"counts": {k: res[k] for k in ("num_passed", "num_failed",
                                           "num_edited") if k in res},
            "files": _outputs(outdir, cmd, len(inputs))}


def _outputs(outdir, cmd, n_inputs) -> dict:
    names = {("filter", 1): ("passed.fq", "failed.fq"),
             ("filter", 2): ("passed_1.fq", "passed_2.fq", "failed_1.fq",
                             "failed_2.fq"),
             ("edit", 1): ("edit.fq", "failed.fq")}[cmd, n_inputs]
    out = {}
    for name in names:
        path = os.path.join(outdir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def oracle_thresholds(crit_kw) -> dict:
    """``hpgq_torch.oracle`` keywords of the criteria fields; the length
    range is always set, so the filter is on even when no drawn field
    restricts it."""
    def rng(lo, hi):
        return crit_kw.get(lo), crit_kw.get(hi)

    kw = {"read_length_range": rng("min_read_length", "max_read_length"),
          "read_quality_range": rng("min_read_quality", "max_read_quality"),
          "max_N": crit_kw.get("max_N"),
          "max_out_of_quality": crit_kw.get("max_out_of_quality")}
    for side in ("left", "right"):
        if side + "_length" in crit_kw:
            kw[side] = (crit_kw[side + "_length"],
                        rng("min_%s_quality" % side, "max_%s_quality" % side))
    if "begin_quality_nt" in crit_kw:
        kw["quality_window"] = (crit_kw["begin_quality_nt"],
                                crit_kw["end_quality_nt"])
    return kw


def check_oracle(cfg, recs, got) -> None:
    """The port's result of the round against ``hpgq_torch.oracle`` over
    the generated records; raises AssertionError naming what differs."""
    from hpgq_torch import oracle

    cmd = cfg["cmd"]
    thr = oracle_thresholds(cfg["criteria"])
    if cmd == "stats":
        kw = dict(thr if cfg["filter_on"] else {}, kmers=cfg["kmers"])
        if cfg["paired"]:
            want = oracle.reference_paired_stats(recs[0], recs[1], **kw)
            for mate, g, w in zip((1, 2), got["counters"], want):
                oracle.assert_counters_equal(g, w, "stats, mate %d" % mate)
        else:
            oracle.assert_counters_equal(got["counters"],
                                         oracle.reference_stats(recs[0],
                                                                **kw),
                                         "stats")
        return
    if cmd == "cgr":
        want = [oracle.reference_cgr(r, cfg["k"]) for r in recs]
        ts, tq, words = got["tables"]
        assert np.array_equal(ts, sum(w[0] for w in want)), "cgr table_seq"
        assert np.array_equal(tq, sum(w[1] for w in want)), "cgr table_q"
        assert words == sum(w[2] for w in want), "cgr word count"
        return
    if cmd == "filter":
        ok = np.ones(len(recs[0]), bool)
        for r in recs:
            ok &= oracle.reference_verdicts(r, **thr)
        names = (("passed.fq", "failed.fq") if len(recs) == 1 else
                 ("passed_1.fq", "passed_2.fq", "failed_1.fq", "failed_2.fq"))
        want = {n: oracle.fastq_bytes(r, s) for n, r, s in zip(
            names, list(recs) * 2, [ok] * len(recs) + [~ok] * len(recs))}
        counts = {"num_passed": int(ok.sum()), "num_failed": int((~ok).sum())}
    else:  # edit: trim, then the post-filter without the trim windows
        lt, rt = oracle.reference_trims(recs[0], left=thr.get("left"),
                                        right=thr.get("right"))
        trimmed = oracle.trimmed_records(recs[0], lt, rt)
        if cfg["filter_on"]:
            post = {k: v for k, v in thr.items() if k not in ("left", "right")}
            ok = oracle.reference_verdicts(trimmed, **post)
            want = {"edit.fq": oracle.fastq_bytes(trimmed, ok),
                    "failed.fq": oracle.fastq_bytes(trimmed, ~ok)}
            counts = {"num_passed": int(ok.sum()),
                      "num_failed": int((~ok).sum())}
        else:
            want = {"edit.fq": oracle.fastq_bytes(trimmed, np.ones(len(lt),
                                                                   bool))}
            counts = {"num_passed": 0, "num_failed": 0}
        counts["num_edited"] = int(((lt > 0) | (rt > 0)).sum())
    assert sorted(got["files"]) == sorted(want), (
        "%s wrote %s, the oracle %s" % (cmd, sorted(got["files"]),
                                        sorted(want)))
    for name, data in want.items():
        assert got["files"][name] == data, "%s: %s bytes" % (cmd, name)
    assert got["counts"] == counts, ("%s counts %s, the oracle %s"
                                     % (cmd, got["counts"], counts))


def run_round(cfg, device="cuda", outdir=None) -> dict:
    """Write the round's corpus, run the port on ``device`` and hold it
    against the oracle.  Returns ``{"inputs": paths, "got": result}``;
    the files stay in ``outdir`` when one is given, else they go."""
    tmp = outdir or tempfile.mkdtemp(prefix="fuzz_torch_")
    try:
        inputs, recs = write_corpus(cfg, tmp)
        got = run_port(cfg, inputs, os.path.join(tmp, "port"), device)
        check_oracle(cfg, recs, got)
        return {"inputs": inputs, "got": got}
    finally:
        if outdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def configs(rounds: int, seed: int, max_n: int = 4000):
    """The configs of ``rounds`` rounds from ``seed``; with at least four
    rounds, the last take any command not drawn before them."""
    rng = np.random.default_rng(seed)
    out = [draw(rng, r, max_n) for r in range(rounds)]
    if rounds >= len(COMMANDS):
        for i in range(rounds):
            missing = [c for c in COMMANDS
                       if c not in {x["cmd"] for x in out}]
            if len(missing) >= rounds - i:
                out[i]["cmd"] = missing[0]
                settle(out[i])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--replay", metavar="CONFIG_JSON", default=None,
                    help="run the one round this config printed")
    args = ap.parse_args(argv)
    os.environ.setdefault("HPGQ_CHARTS", "off")
    from hpgq_torch.device import resolve_device

    device = resolve_device(args.device)
    cfgs = ([json.loads(args.replay)] if args.replay
            else configs(args.rounds, args.seed))
    for cfg in cfgs:
        try:
            run_round(cfg, device)
        except AssertionError as e:
            print("FAIL round=%d: %s\n  cfg=%s" % (cfg["round"], e,
                                                   json.dumps(cfg,
                                                              sort_keys=True)),
                  flush=True)
            return 1
        print("PASS", json.dumps(cfg, sort_keys=True), flush=True)
    print("OK: %d rounds on %s, commands %s" % (
        len(cfgs), device, sorted({c["cmd"] for c in cfgs})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
