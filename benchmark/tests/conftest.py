"""Fixtures of the benchmark's own tests.

``small_root`` is a copy of the benchmark's data (``BENCHMARK.json`` and
the configurations, traffic mixes, limits and metric readers) with files
small enough for the CPU; ``drive`` runs a cell of it through
``benchmark/run.py``'s ``main`` on the CPU, which a measurement never
does.  Whether a test has the cards it needs is decided inside the test
(``cards``), never while a module is imported."""

import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_READS = {"novaseq_se100_rta3": 3000, "long_reads_test": 40}


def make_root(dest, reads=SMALL_READS):
    """A checkout's benchmark data at ``dest``, each configuration's file
    cut to ``reads`` reads, with the cells of ``cells_out.json`` added to
    its ``BENCHMARK.json``: cells whose files are here and whose entries
    are not yet in ``BENCHMARK.json``, and a test-only cell of long reads
    (its configuration and limits in that file)."""
    os.makedirs(os.path.join(dest, "benchmark"), exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "tests", "cells_out.json")) as f:
        out = json.load(f)
    for part in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(os.path.join(BENCH, part),
                        os.path.join(dest, "benchmark", part),
                        ignore=shutil.ignore_patterns("*.py[co]", "__pycache__"))
    for c in out["configs"]:
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(c.pop("data"), f)
        bench["configs"].append(c)
    bench["per_layer"] += out["per_layer"]
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for w in out["workloads"]:
        for name in w.pop("per_layer"):
            metrics[name]["workloads"].append(w["name"])
        if "limits" in w:
            with open(os.path.join(dest, "benchmark", "checks",
                                   w["name"] + ".json"), "w") as f:
                json.dump(w.pop("limits"), f)
        bench["workloads"].append(w)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name, n in reads.items():
        path = os.path.join(dest, "benchmark", "configs", name + ".json")
        with open(path) as f:
            config = json.load(f)
        config["reads_per_file"] = n
        with open(path, "w") as f:
            json.dump(config, f)
    return str(dest)


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return make_root(tmp_path / "checkout")


def drive(root, workload, trace=0, seed=4294967311, seconds=0.5, world=None):
    """(exit code, result or None) of one CPU run of ``workload``."""
    import run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device_type="cpu", world=world, root=root)
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return rc, result


@pytest.fixture
def cards():
    """The number of CUDA cards here (0 on a machine without)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0
