"""Smoke tests of the port's fuzz arm (``tools/fuzz_torch.py``) on the CPU.

The four handcrafted rounds of ``tests/test_fuzz_smoke.py`` (stats with
k-mers and a filter, filter with a checkpoint interrupt, edit, cgr
sharded), each held against ``hpgq_torch/oracle.py`` by the fuzzer; then a
few of its seeded random rounds, each also run through ``hpgq`` (JAX on
the CPU) on the same config and corpus: the port's counters (k-mer tables
too), output bytes and CGR tables equal ``hpgq``'s, ``acc_quality`` to
1e-3 relative.  Corpora stay at most 1,500 reads.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import fuzz_torch as fz  # noqa: E402
from hpgq_torch.oracle import assert_counters_equal  # noqa: E402

CPU = torch.device("cpu")


def _base_cfg(**kw):
    cfg = {
        "round": 0, "n": 400, "min_len": 40, "max_len": 90, "n_prob": 0.02,
        "lowercase_prob": 0.0, "wire": "off", "qn": "1", "wire6": "1",
        "wire2c": "1", "wire2u": "1", "qshape": "uniform", "batch_size": 64,
        "coalesce": 0, "paired": False, "kmers": False, "checkpoint": False,
        "sharded": False, "seed": 5, "k": 4, "stop_after": 1,
    }
    cfg.update(kw)
    return cfg


def _run(cfg, crit_kw, filter_on):
    cfg["criteria"] = crit_kw
    cfg["filter_on"] = filter_on
    return fz.run_round(cfg, CPU)


def test_stats_round():
    _run(_base_cfg(cmd="stats", kmers=True),
         {"min_read_quality": 18, "max_N": 2}, True)


def test_filter_checkpoint_interrupt_round():
    cfg = _base_cfg(cmd="filter", checkpoint=True, stop_after=2)
    _run(cfg, {"min_read_quality": 20, "max_read_length": 150}, True)
    assert cfg["interrupted"], "the rigged iterator should have fired"


def test_edit_round():
    _run(_base_cfg(cmd="edit"),
         {"left_length": 6, "min_left_quality": 25, "max_left_quality": 60},
         False)


def test_cgr_sharded_round():
    _run(_base_cfg(cmd="cgr", k=4, sharded=True, n=250), {}, False)


def test_oracle_check_bites(tmp_path):
    """A round's result with one output byte changed fails the fuzzer's
    oracle check."""
    from gen import make_records

    cfg = fz.settle(_base_cfg(cmd="filter", criteria={"max_N": 0},
                              filter_draw=True))
    recs = [make_records(cfg["n"], seed=cfg["seed"], **fz.corpus_kw(cfg))]
    got = fz.run_round(cfg, CPU, outdir=str(tmp_path))["got"]
    fz.check_oracle(cfg, recs, got)
    data = bytearray(got["files"]["passed.fq"])
    data[len(data) // 2] ^= 1
    got["files"]["passed.fq"] = bytes(data)
    with pytest.raises(AssertionError, match="passed.fq"):
        fz.check_oracle(cfg, recs, got)


def _hpgq_result(cfg, inputs, outdir):
    """The round's command through ``hpgq`` on the CPU, in the shape of
    ``fuzz_torch.run_port``'s result."""
    from hpgq.dist.run_dist import run_stats_sharded
    from hpgq.options import (
        CgrOptions,
        EditOptions,
        FilterCriteria,
        FilterOptions,
        StatsOptions,
    )
    from hpgq.pipeline.cgr_run import run_cgr
    from hpgq.pipeline.run import run_edit, run_filter, run_stats

    cls = {"stats": StatsOptions, "filter": FilterOptions,
           "edit": EditOptions, "cgr": CgrOptions}[cfg["cmd"]]
    o = cls()
    o.in_filename = inputs[0]
    o.in_filename2 = inputs[1] if len(inputs) > 1 else None
    o.out_dirname = outdir
    os.makedirs(outdir)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = cfg["batch_size"]
    o.batch_size_set = True
    o.criteria = FilterCriteria(**cfg["criteria"])
    o.filter_on = cfg["filter_on"]
    with fz.knobs(cfg):
        if cfg["cmd"] == "stats":
            o.kmers_on = cfg["kmers"]
            run = run_stats_sharded if cfg["sharded"] else run_stats
            return {"counters": run(o, report=False)}
        if cfg["cmd"] == "cgr":
            o.k = cfg["k"]
            o.sharded = cfg["sharded"]
            res = run_cgr(o)
            return {"tables": (res["table_seq"], res["table_q"],
                               res["fq_word_count"])}
        res = (run_filter if cfg["cmd"] == "filter" else run_edit)(o)
    return {"counts": {k: res[k] for k in ("num_passed", "num_failed",
                                           "num_edited") if k in res},
            "files": fz._outputs(outdir, cfg["cmd"], len(inputs))}


@pytest.mark.parametrize("rnd", range(8))
def test_random_round_equals_hpgq(tmp_path, rnd):
    """Round ``rnd`` of seed 38's eight (at most 1,500 reads; sharded,
    checkpointed, paired, k-mer and [D8] rounds among them): the port
    against the oracle (in the fuzzer), then against ``hpgq`` on the same
    config and corpus (``hpgq`` runs uninterrupted)."""
    cfg = fz.configs(8, seed=38, max_n=1500)[rnd]
    port = fz.run_round(cfg, CPU, outdir=str(tmp_path))
    ref = _hpgq_result(cfg, port["inputs"], str(tmp_path / "hpgq"))
    got = port["got"]
    assert sorted(got) == sorted(ref)
    if "counters" in ref:
        pairs = (zip(got["counters"], ref["counters"]) if cfg["paired"]
                 else [(got["counters"], ref["counters"])])
        for g, w in pairs:
            assert_counters_equal(g, w, "round %d against hpgq" % rnd)
    if "tables" in ref:
        for a, b in zip(got["tables"], ref["tables"]):
            np.testing.assert_array_equal(a, b)
    if "files" in ref:
        assert got["counts"] == ref["counts"]
        assert sorted(got["files"]) == sorted(ref["files"])
        for name, data in ref["files"].items():
            assert got["files"][name] == data, name
