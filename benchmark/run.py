"""Run one cell of the benchmark of ``hpgq_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the root of the checkout.
The last line on standard output is the run's result, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; ``checks`` last); the last lines on
standard error are the numbers compared, each beside its limit.  A run
needs as many CUDA cards as the cell asks for; without them it prints no
result and exits 2.  It exits 3 without a result when ``jax``,
``jaxlib``, ``flax`` or ``hpgq`` got loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_start() -> float:
    """This process's start, wall clock (``/proc``: ticks since boot
    against the uptime)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return "nvidia-smi failed: %s" % e


def main(argv=None, started=None, device_type="cuda", world=None, root=ROOT) -> int:
    """Run the cell; ``device_type`` and ``world`` let the tests drive a
    run on the CPU, which a measurement never does."""
    started = time.time() if started is None else started
    args = parse(argv)
    import torch

    from benchmark.harness import cell as run_cell, spec

    cell = spec.load(args.workload, root)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card: the benchmark measures the card only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print("the cell needs %d cards, this machine has %d"
                  % (cell.chips, torch.cuda.device_count()), file=sys.stderr)
            return 2
    world = world or (cell.chips if cell.traffic.get("sharded") else 1)
    with run_cell.Ranks(cell, device_type, world, root) as ranks:
        out = ranks.run(seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), started=started)
    if "forbidden" in out:
        print("loaded in this process: %s" % ", ".join(out["forbidden"]), file=sys.stderr)
        return 3
    print("pass_s %s" % json.dumps(out["run"].pop("pass_s")))
    if device_type == "cuda":
        print("card %s" % card_line())
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    _started = process_start()
    sys.path.insert(0, ROOT)
    sys.exit(main(started=_started))
