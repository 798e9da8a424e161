"""What ``BENCHMARK.json`` and the files it names say about one cell.

A cell is an entry of ``workloads``: a configuration (its ``file``), a
traffic mix (``benchmark/traffic/<traffic>.json``) and a number of chips.
Its limits are ``benchmark/checks/<cell>.json``; a per-layer metric is
read by ``benchmark/metrics/<metric>.py``; a traffic's ``command`` runs
as ``benchmark/commands/<command>.py`` on the file its ``generator``
(``benchmark/traffic/<generator>.py``) draws.  Everything is found by
name, so a cell, a configuration, a traffic mix, a command or a metric is
added by adding files and entries, with no file here edited.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: str


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError("BENCHMARK.json has no %s named %r" % (what, name))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = _named(bench["workloads"], workload, "workload")
    config = _load_json(os.path.join(
        root, _named(bench["configs"], entry["config"], "config")["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic",
                                      entry["traffic"] + ".json"))
    limits = _load_json(os.path.join(root, "benchmark", "checks",
                                     workload + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, int(entry["chips"]), config, traffic, limits, e2e,
                per_layer, root)


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def code(package: str, name: str):
    """The module ``benchmark.<package>.<name>``: a command or a
    generator."""
    return importlib.import_module("benchmark.%s.%s" % (package, name))
