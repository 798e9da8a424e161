"""What the benchmark may import, the contract of ``BENCHMARK.json``, how
a cell, a traffic mix and a metric are added by files alone, and what a
run does without a card."""

import ast
import json
import os
import re
import subprocess
import sys
import types

import pytest

from conftest import BENCH, ROOT, drive

FORBIDDEN = {"jax", "jaxlib", "flax", "hpgq"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _modules(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    """The top-level names of every module ``path`` imports (relative
    imports are the benchmark's own)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_hpgq():
    """Compared by whole top-level names: ``hpgq_torch`` is not ``hpgq``."""
    for path in _modules(BENCH):
        assert not FORBIDDEN & set(_imports(path)), path


def test_reference_stands_alone():
    """The reference imports numpy, the standard library and itself."""
    allowed = {"numpy", "ctypes", "dataclasses", "os", "__future__", "benchmark"}
    for path in _modules(os.path.join(BENCH, "reference")):
        names = set(_imports(path))
        assert names <= allowed, (path, names - allowed)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for group in (names, [c["name"] for c in b["configs"]],
                  [w["name"] for w in b["workloads"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    four = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        four += w["chips"] == 4
        for part in ("traffic/%s.json" % w["traffic"], "checks/%s.json" % w["name"]):
            assert os.path.exists(os.path.join(BENCH, part)), part
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        for part in ("commands/%s.py" % traffic["command"],
                     "traffic/%s.py" % traffic.get("generator", "generate")):
            assert os.path.exists(os.path.join(BENCH, part)), part
    assert four <= max(1, len(b["workloads"]) // 4)
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s", "bases_per_s"}
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_cell_a_traffic_mix_and_a_metric_are_added_by_files(small_root):
    """A throwaway cell (a new traffic mix) and a throwaway per-layer metric,
    each a new file and a new entry, run with no file of the harness
    edited."""
    bench = os.path.join(small_root, "benchmark")
    with open(os.path.join(bench, "traffic", "stats_filter_plain.json")) as f:
        traffic = json.load(f)
    traffic["read_scale"] = 2
    with open(os.path.join(bench, "traffic", "throwaway_mix.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "checks", "throwaway_cell.json"), "w") as f:
        json.dump({"counter_fields_off": 0, "acc_quality_gap": 1e-6,
                   "report_files_off": 0, "passes_unchecked": 0}, f)
    with open(os.path.join(bench, "metrics", "throwaway_passes.py"), "w") as f:
        f.write("def read(run):\n    return float(run.passes)\n")
    path = os.path.join(small_root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["workloads"].append({"name": "throwaway_cell", "config": "novaseq_se100_rta3",
                           "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "throwaway_passes", "unit": "passes",
                           "better": "higher", "source": "program_counter",
                           "layer": "pipeline", "moves": "bases_per_s",
                           "workloads": ["throwaway_cell"]})
    with open(path, "w") as f:
        json.dump(b, f)
    rc, result = drive(small_root, "throwaway_cell", trace=1)
    assert rc == 0 and result["correct"]
    assert result["run"]["reads_per_pass"] == 6000
    assert result["metrics"]["throwaway_passes"]["value"] == result["attempted"]
    assert "input_wait_share" not in result["metrics"]  # it lists its cells


def test_no_card_no_result(small_root, monkeypatch, capsys):
    """Without the cards it asks for, a run prints no result and fails."""
    import torch

    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "se100_stats_filter", "--seed", "1",
                   "--seconds", "1"], root=small_root)
    assert rc != 0 and capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    rc = run.main(["--workload", "se100_stats_filter_4card", "--seed", "1",
                   "--seconds", "1"], root=small_root)
    assert rc != 0 and capsys.readouterr().out == ""


def test_command_without_card_exits_nonzero(cards):
    """The benchmark's command, as ``BENCHMARK.json`` gives it, on a machine
    with no card."""
    if cards:
        pytest.skip("this machine has a card: the command would measure it")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "se100_gz_stats_filter", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_loaded_jax_stops_the_result(small_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, result = drive(small_root, "se100_stats_filter")
    assert rc == 3 and result is None
