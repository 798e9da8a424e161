"""One run of one cell: set-up, the measured window, the trace, the check.

The load is a closed loop with one client: passes of the traffic's
command (``stats``) over one file, back to back, each starting when the
last returns, as a QC step works through a sequencing run's files.  Set-up makes the file from the
seed, loads ``hpgq_torch`` and runs one warm pass.  The window then runs
passes until ``--seconds`` have passed and ends with the last pass.

``bases_per_s`` is every input base of the window's passes over the
window's length; ``setup_s`` runs from the process's start to the
window's.  With ``--trace 1`` each pass is handed the harness's stage
timers, inside the profiler, and the per-layer metrics are read from
those.

A cell with ``sharded`` traffic runs one rank per card, as ``torchrun``
would start them: this process is rank 0 and starts the others at set-up;
they meet in a gloo group over a ``file://`` rendezvous under ``TMPDIR``
and follow rank 0's orders (:func:`rank_main`).  Every pass is one sharded
pass over the whole file; rank 0 keeps what it returns.

Once the window has closed and the memory peak is read, what every pass
returned is held against the plain reference by the command's ``judge``
(:mod:`benchmark.commands`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from benchmark import yardstick
from benchmark.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "hpgq")  # top-level module names
GROUP_TIMEOUT = datetime.timedelta(seconds=240)


class Group:
    """This process's rank in the cell's ranks; world size 1: no group."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def bcast(self, obj):
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def join_group(rank: int, world: int, rendezvous: str) -> Group:
    if world > 1:
        dist.init_process_group("gloo", init_method="file://" + rendezvous,
                                rank=rank, world_size=world,
                                timeout=GROUP_TIMEOUT)
    return Group(rank, world)


def correct(numbers: dict) -> bool:
    """Every number compared within its limit."""
    return all(n["value"] <= n["limit"] for n in numbers.values())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Runner:
    """The passes of one cell on this rank's device: the traffic's
    ``command`` (``benchmark/commands/<command>.py``) over the file its
    ``generator`` (``benchmark/traffic/<generator>.py``, ``generate`` by
    default) draws."""

    def __init__(self, cell: spec.Cell, group: Group, device: torch.device):
        self.cell, self.group, self.device = cell, group, device
        self.command = spec.code("commands", cell.traffic["command"])
        self.generator = spec.code("traffic", cell.traffic.get("generator", "generate"))

    def run(self, seed: int, seconds: float, trace: bool, started: float):
        """One run: on rank 0 the result (see :func:`result`), elsewhere
        None.  ``started`` is the process's start, wall clock."""
        from benchmark.harness import trace as tr

        g = self.group
        work = tempfile.mkdtemp(prefix="bench_") if g.rank == 0 else None
        local = tempfile.mkdtemp(prefix="bench_rank_")
        try:
            corpus = None
            if g.rank == 0:
                corpus = self.generator.make_corpus(self.cell.config,
                                                    self.cell.traffic, seed, work)
            path = g.bcast(corpus.path if corpus is not None else None)
            outdir = os.path.join(os.path.dirname(path), "out")
            prof = tr.profiler(self.device) if trace else None
            if prof is not None:
                prof.__enter__()
            timers = tr.TracedTimers() if trace else None
            one_pass = self.command.one_pass
            results = [one_pass(self, path, outdir, timers)]  # the warm pass
            stages, pass_s = {}, []
            g.gather(None)  # every rank ready
            t0 = time.perf_counter()
            setup_s = time.time() - started
            with (torch.profiler.record_function("bench.window")
                  if trace else contextlib.nullcontext()):
                go = True
                while go:
                    timers = tr.TracedTimers() if trace else None
                    t = time.perf_counter()
                    with (torch.profiler.record_function("bench.pass")
                          if trace else contextlib.nullcontext()):
                        results.append(one_pass(self, path, outdir, timers))
                    pass_s.append(time.perf_counter() - t)
                    if timers is not None:
                        for k, v in timers.totals.items():
                            stages[k] = stages.get(k, 0.0) + v
                    go = g.bcast(time.perf_counter() - t0 < seconds)
            window_s = time.perf_counter() - t0
            card = None
            if prof is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                prof.__exit__(None, None, None)
                card = tr.reduce_trace(
                    tr.export(prof, local),
                    self.device.index if self.device.type == "cuda" else None)
            peak = (torch.cuda.max_memory_allocated(self.device)
                    if self.device.type == "cuda" else 0)
            ranks = g.gather({"stages": stages, "card": card, "peak": peak})
            if g.rank != 0:
                return None
            found = forbidden_modules()
            if found:
                return {"forbidden": found}
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            checks, failed = self.command.judge(self.cell, corpus, results,
                                                len(pass_s) + 1, outdir)
            return result(self, corpus, seed, checks, failed, setup_s,
                          window_s, pass_s, stages, ranks, trace)
        finally:
            shutil.rmtree(local, ignore_errors=True)
            if work is not None:
                shutil.rmtree(work, ignore_errors=True)


class Run:
    """What a per-layer metric's ``read(run)`` is given: the window's
    numbers, summed over its passes.

    ``stages``: the stage seconds of the harness's timers, summed over the
    passes and the ranks (``rank_stages``: each rank's, rank 0 first);
    ``window_s``, ``passes``, ``pass_s``; ``cards``: each card's reduced
    trace (:func:`benchmark.harness.trace.reduce_trace`), None untraced;
    ``reads``, ``bases`` and ``data_bytes``: of the window's passes;
    ``peak_bytes_per_s``: one card's memory bandwidth; ``config``,
    ``traffic``, ``world``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def result(runner, corpus, seed, checks, failed, setup_s, window_s, pass_s,
           stages, ranks, trace) -> dict:
    cell = runner.cell
    passes = len(pass_s)
    reads, bases = passes * corpus.reads, passes * corpus.bases
    metrics = {}
    if not trace:
        values = {"bases_per_s": bases / window_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    cards = [r["card"] for r in ranks] if trace else None
    if trace:
        total = {}
        for r in ranks:
            for k, v in r["stages"].items():
                total[k] = total.get(k, 0.0) + v
        run = Run(stages=total, rank_stages=[r["stages"] for r in ranks],
                  window_s=window_s, passes=passes, pass_s=pass_s,
                  cards=cards, reads=reads, bases=bases,
                  data_bytes=yardstick.data_bytes(cell.config, reads, bases),
                  peak_bytes_per_s=yardstick.PEAK_HBM_BYTES_PER_S,
                  config=cell.config, traffic=cell.traffic,
                  world=runner.group.world)
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = runner.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": runner.group.world,
              "memory_peak_bytes": int(max(r["peak"] for r in ranks))}
    out = {"correct": failed == 0 and correct(checks),
           "attempted": passes, "failed": failed, "metrics": metrics,
           "device": device}
    if trace and all(c is not None for c in cards):
        device["busy_s"] = sum(c["busy_s"] for c in cards) / len(cards)
        device["window_s"] = window_s
        ops = {}
        for c in cards:
            for k, v in c["ops_s"].items():
                ops[k] = ops.get(k, 0.0) + v
        gaps = sorted(((("rank%d: " % i if len(cards) > 1 else "") + n, s)
                       for i, c in enumerate(cards) for n, s in c["gaps"]),
                      key=lambda x: -x[1])
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
    out["run"] = {"seed": seed, "passes": passes, "window_s": window_s,
                  "reads_per_pass": corpus.reads, "bases_per_pass": corpus.bases,
                  "pass_s": pass_s}
    out["checks"] = checks
    return out


def rank_main(rank: int, world: int, rendezvous: str, workload: str,
              device_type: str, root: str) -> None:
    """A rank other than 0: join the group, then run what rank 0 sends
    until it sends None."""
    group = join_group(rank, world, rendezvous)
    device = _device(device_type, rank)
    runner = Runner(spec.load(workload, root), group, device)
    try:
        while True:
            job = group.bcast(None)
            if job is None:
                return
            runner.run(**job)
    finally:
        dist.destroy_process_group()


def _device(device_type: str, rank: int) -> torch.device:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return torch.device(device_type)


class Ranks:
    """This process as rank 0 of the cell's ranks, the others started on
    entry as processes of their own and stopped on exit."""

    def __init__(self, cell: spec.Cell, device_type: str, world: int,
                 root: str = spec.ROOT):
        self.cell, self.device_type, self.world, self.root = cell, device_type, world, root
        self.procs = []
        self.rdv = None

    def __enter__(self) -> "Ranks":
        if self.world > 1:
            import multiprocessing

            self.rdv = tempfile.mkdtemp(prefix="bench_ranks_")
            ctx = multiprocessing.get_context("spawn")
            where = os.path.join(self.rdv, "rendezvous")
            for r in range(1, self.world):
                p = ctx.Process(target=rank_main, name="bench rank %d" % r,
                                args=(r, self.world, where, self.cell.name,
                                      self.device_type, self.root))
                p.start()
                self.procs.append(p)
            group = join_group(0, self.world, where)
        else:
            group = Group(0, 1)
        self.runner = Runner(self.cell, group, _device(self.device_type, 0))
        return self

    def run(self, **job):
        """:meth:`Runner.run` on every rank; rank 0's result."""
        self.runner.group.bcast(job)
        return self.runner.run(**job)

    def __exit__(self, *exc):
        try:
            if self.world > 1:
                if exc[0] is None:
                    self.runner.group.bcast(None)
                    for p in self.procs:
                        p.join(timeout=120)
                dist.destroy_process_group()
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            if self.procs:  # the resource tracker that spawn started, too
                from multiprocessing import resource_tracker

                resource_tracker._resource_tracker._stop()
            if self.rdv:
                shutil.rmtree(self.rdv, ignore_errors=True)
        bad = [p.exitcode for p in self.procs if p.exitcode]
        if exc[0] is None and bad:
            raise RuntimeError("a rank exited with %r" % bad)
        return False
