"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 20
        [--control-seeds 7,8,9] [--trace-seeds 4,5] [--out FILE]

For each of ``--seeds`` it runs the cell as ``run.py`` does (set-up,
window, check; the set-up of the cards and ranks is paid once) and prints
one JSON line with the numbers compared, ``correct`` and the end-to-end
metrics; ``--trace-seeds`` do the same with ``--trace 1``.  For each of
``--control-seeds`` it draws the file and prints one line for each
control (the command's ``control``, :mod:`benchmark.commands`): the
reference with one float computed one precision step lower, in the
program's place (this needs no card).  Lines also go to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--trace-seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("--out")
    args = p.parse_args(argv)
    started = time.time()
    import torch

    from benchmark.harness import cell as run_cell, spec

    out = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    cell = spec.load(args.workload)
    runs = [(False, args.seeds), (True, args.trace_seeds)]
    if any(seeds for _, seeds in runs) and (
            not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        print("the cell needs %d CUDA cards" % cell.chips, file=sys.stderr)
        return 2
    world = cell.chips if cell.traffic.get("sharded") else 1
    with run_cell.Ranks(cell, "cuda", world) if runs[0][1] or runs[1][1] \
            else contextlib.nullcontext() as ranks:
        for trace, seeds in runs:
            for seed in seeds:
                r = ranks.run(seed=seed, seconds=args.seconds, trace=trace,
                              started=started)
                started = time.time()
                emit({"kind": "program", "workload": cell.name, "seed": seed,
                      "trace": int(trace), "correct": r["correct"],
                      "failed": r["failed"], "run": r["run"],
                      "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                      "device": r["device"], "breakdown": r.get("breakdown"),
                      "checks": {k: v["value"] for k, v in r["checks"].items()}})
    for seed in args.control_seeds:
        work = tempfile.mkdtemp(prefix="bench_control_")
        try:
            generator = spec.code("traffic", cell.traffic.get("generator", "generate"))
            corpus = generator.make_corpus(cell.config, cell.traffic, seed, work)
            controls = spec.code("commands", cell.traffic["command"]).control(
                cell, corpus, os.path.join(work, "out"))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for name, numbers in controls.items():
            emit({"kind": "control", "control": name, "workload": cell.name,
                  "seed": seed, "correct": run_cell.correct(numbers),
                  "checks": {k: v["value"] for k, v in numbers.items()}})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
