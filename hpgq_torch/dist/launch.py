"""One rank per local card for a ``--sharded`` run that no launcher started.

The counterpart of ``data_mesh()``'s default in ``hpgq/dist/mesh.py``,
every local device: where ``hpgq``'s one process drives every chip of the
host through one mesh, the port starts one process per card
(:func:`~hpgq_torch.dist.mesh.rank_devices` says how many), and each runs
the ``run_*_sharded`` code of :mod:`hpgq_torch.dist.run_dist` as one rank of
a gloo group.

:func:`launch` starts the ranks with the ``spawn`` method (never ``fork``:
the parent may hold a CUDA context already); they meet over a ``file://``
rendezvous in a private temporary directory, so no TCP port is raced for.
The parent waits for every rank and gets rank 0's return value back; a
rank that exits non-zero stops the others at once (no rank is left
waiting in a collective until :data:`~hpgq_torch.dist.mesh.TIMEOUT`), and
so do Ctrl-C and SIGTERM to the parent.  The ranks leave Ctrl-C to the
parent (a terminal's Ctrl-C reaches the whole process group), so a rank
inside a gloo call is stopped by the parent and not left to the
interrupt.  Each rank also dies with the parent.  :func:`run_sharded` is
the entry points' route: the CLI's commands, the legacy flags, the API
and ``cgr_run.run_cgr``.

Each rank stamps its start-up (:data:`STAMPS`), and :func:`run_sharded`
hands rank 0's split to the caller's timers as ``launch-*`` stages
(:func:`startup_stages`), which ``--t`` prints.
"""

from __future__ import annotations

import contextlib
import logging
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import signal
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from . import mesh

_log = logging.getLogger("hpgq")

# seconds a rank has to exit after SIGTERM before it is killed
_GRACE_S = 5.0
_PR_SET_PDEATHSIG = 1

# This rank's start-up, wall-clock seconds: "launch" (the parent's
# launch() began), "process" (this process was made), "main" (_rank_main
# entered: the interpreter, torch and hpgq_torch imported), "join" (the
# gloo group joined), "cuda" (the CUDA context made on the rank's card;
# nothing to make on the CPU), "load" (the kernel library, where the
# target launches K1 or K2 on a card, and the native packer loaded).
STAMPS = {}
# the start-up stages: (name, from stamp, to stamp); "first_batch" is the
# caller's stamp of the rank's first batch
STAGES = (("launch-spawn", "launch", "process"),
          ("launch-imports", "process", "main"),
          ("launch-join", "main", "join"),
          ("launch-cuda", "join", "cuda"),
          ("launch-load", "cuda", "load"),
          ("launch-first-batch", "load", "first_batch"))


class RankFailed(RuntimeError):
    """A rank of a launched run exited non-zero; ``exitcode`` is its exit
    status (128 + the signal for a rank a signal ended)."""

    def __init__(self, rank: int, exitcode: int):
        self.rank = rank
        self.exitcode = exitcode
        super().__init__("rank %d of the --sharded run exited %d"
                         % (rank, exitcode))


def local_devices() -> list:
    """``cuda:0`` to ``cuda:N-1``, the N visible cards."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def launch(target, args=(), devices=None, stamps=None, kernels=False):
    """Run ``target(*args)`` as ``len(devices)`` ranks of one gloo group,
    rank ``r`` on ``devices[r]`` (default: :func:`local_devices`); return
    rank 0's return value.  ``target`` and ``args`` must pickle, and
    ``target`` must be importable in a new interpreter.  A rank on a card
    makes its CUDA context, and with ``kernels`` (the target launches K1
    or K2) loads the kernel library, before ``target`` runs.  Raises
    :class:`RankFailed` when a rank exits non-zero, after stopping the
    others.  ``stamps``, a dict, gets the parent's part of the start-up:
    ``launch`` (the wall-clock time of this call) and ``start_s`` (the
    seconds spent in the ranks' ``Process.start()``)."""
    launched = time.time()
    devices = [torch.device(d) for d in (devices or local_devices())]
    if not devices:
        raise ValueError("launch: no device to run a rank on")
    ctx = multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="hpgq_torch_ranks_")
    procs = []
    started = 0.0
    hold, restore = _trap_signals()
    try:
        for r, dev in enumerate(devices):
            p = ctx.Process(target=_rank_main, name="hpgq_torch rank %d" % r,
                            args=(target, tuple(args), r, len(devices),
                                  str(dev), work, os.getpid(), launched,
                                  kernels))
            t = time.perf_counter()
            p.start()
            started += time.perf_counter() - t
            procs.append(p)
        if stamps is not None:
            stamps.update(launch=launched, start_s=started)
        _wait_all(procs)
        with open(os.path.join(work, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        hold()  # a signal from here on waits until the ranks are stopped
        _stop(procs)
        shutil.rmtree(work, ignore_errors=True)
        restore()  # last: it may pass a signal on


def _wait_all(procs) -> None:
    """Wait for every rank; raise :class:`RankFailed` at the first that
    exits non-zero."""
    pending = {p.sentinel: (r, p) for r, p in enumerate(procs)}
    while pending:
        for s in multiprocessing.connection.wait(list(pending)):
            r, p = pending.pop(s)
            p.join()
            if p.exitcode:
                code = p.exitcode
                raise RankFailed(r, 128 - code if code < 0 else code)


def _stop(procs) -> None:
    """SIGTERM to every rank still running, SIGKILL to any that outlives
    the grace period (one for all: they got SIGTERM together); every rank
    reaped."""
    for p in procs:
        if p.exitcode is None:
            p.terminate()
    deadline = time.monotonic() + _GRACE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.exitcode is None:
            p.kill()
            p.join()


class _Terminated(SystemExit):
    """SIGTERM reached the parent while ranks ran (exit status 143 where
    no handler of the parent's own takes it)."""

    def __init__(self):
        super().__init__(128 + signal.SIGTERM)


def _trap_signals():
    """While the ranks run, SIGTERM raises :class:`_Terminated` and SIGINT
    ``KeyboardInterrupt`` in the waiting main thread, so that ``launch``'s
    ``finally`` stops the ranks.  Returns ``(hold, restore)``: after
    ``hold()`` either signal is only noted, so that none cuts the stop
    short; ``restore()`` puts the handlers back and passes on, to the
    handler that was there before, a SIGTERM caught at any time and a
    SIGINT caught while held.  A signal the process ignores stays ignored.
    Main thread only (elsewhere both do nothing)."""
    if threading.current_thread() is not threading.main_thread():
        return (lambda: None), (lambda: None)
    caught, held, prev = [], [], {}

    def on_signal(signum, frame):
        caught.append((signum, bool(held)))
        if not held:
            raise (_Terminated() if signum == signal.SIGTERM
                   else KeyboardInterrupt())

    for sig in (signal.SIGTERM, signal.SIGINT):
        old = signal.getsignal(sig)
        if old is not signal.SIG_IGN:
            # None: a handler set outside Python, taken as the default
            prev[sig] = signal.SIG_DFL if old is None else old
            signal.signal(sig, on_signal)

    def restore():
        for sig, old in prev.items():
            signal.signal(sig, old)
        passed = [sig for sig, was_held in caught
                  if was_held or sig == signal.SIGTERM]
        if passed:  # the ranks are stopped: now the parent's own handling
            signal.raise_signal(passed[0])

    return (lambda: held.append(True)), restore


def _parent_takes_ctrl_c(signum, frame):
    """A rank's SIGINT handler: nothing.  Ctrl-C at a terminal reaches the
    parent too, which stops every rank; a rank interrupted on its own,
    maybe inside a gloo call, would only leave the others waiting."""


def _die_with_parent(parent: int) -> None:
    """The rank gets SIGKILL when the parent dies (Linux), so that no rank
    outlives a parent that was killed outright."""
    with contextlib.suppress(OSError, AttributeError):
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:  # it died before the call above
        os._exit(1)


def _process_start():
    """The wall-clock time this process was made: field 22 of
    ``/proc/self/stat`` (clock ticks after boot) set against
    ``/proc/uptime`` read now (``btime`` of ``/proc/stat`` has whole
    seconds only; the uptime is to 0.01 s).  None without those files."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")


def startup_stages(stamps) -> dict:
    """``{stage: seconds}`` of one rank's start-up, in :data:`STAGES`'
    order, from its :data:`STAMPS` and its ``first_batch``; a stage whose
    stamps are missing is left out.  The stages follow one another, so
    they sum to the time from the launch to the rank's first batch."""
    return {name: stamps[b] - stamps[a] for name, a, b in STAGES
            if stamps.get(a) is not None and stamps.get(b) is not None}


def _ready(dev, kernels: bool) -> None:
    """Make the CUDA context on the rank's card, then load the kernel
    library (``kernels``, on a card) and the native packer, stamping each:
    work the rank's first batch would do, done before it so that the
    start-up splits by stage."""
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    STAMPS["cuda"] = time.time()
    if kernels and dev.type == "cuda":
        from ..kernels import build

        build.load()
    from ..io import native

    native.get_lib()
    STAMPS["load"] = time.time()


def _rank_main(target, args, rank, world, device, work, parent, launched,
               kernels):
    """A rank's process: the launcher's variables, the group over the
    ``file://`` rendezvous, this rank's device made ready, ``target(*args)``;
    rank 0's return value pickled for the parent."""
    STAMPS.update(launch=launched, process=_process_start(),
                  main=time.time())
    signal.signal(signal.SIGINT, _parent_takes_ctrl_c)
    _die_with_parent(parent)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "rendezvous"),
        rank=rank, world_size=world, timeout=mesh.TIMEOUT)
    STAMPS["join"] = time.time()
    try:
        pg = mesh.initialize_distributed(device, rank_device=device)
        _ready(pg.device, kernels)
        result = target(*args)
        if rank == 0:
            tmp = os.path.join(work, "result.pkl.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(result, f)
            os.replace(tmp, os.path.join(work, "result.pkl"))
    finally:
        dist.destroy_process_group()  # not left to the interpreter's exit


# ---------------------------------------------------------------- entry points

def run_sharded(runner, opts, timers=None, device="cuda", **kw):
    """A ``--sharded`` command: ``runner(opts, timers, device=..., **kw)``
    (one of :mod:`~hpgq_torch.dist.run_dist`'s ``run_*_sharded``) in this
    process where :func:`~hpgq_torch.dist.mesh.rank_devices` gives one
    device, else as one rank on each of its devices.  Returns rank 0's
    result; ``timers`` gets rank 0's stage totals and counts, and its
    start-up split (``launch-*``, :func:`startup_stages`, ending at its
    first ``compute`` stage) with ``launch-start``, the parent's seconds
    in ``Process.start()``.  Log lines go where this process's go, from
    rank 0; the other ranks print only warnings and errors."""
    devices = mesh.rank_devices(opts, device)
    if len(devices) == 1:
        return runner(opts, timers, device=devices[0], **kw)
    stamps = {}
    result, counts = launch(_rank_run, (runner, opts, kw, _log_setup()),
                            devices, stamps=stamps,
                            kernels=opts.command_name == "stats")
    if timers is not None:
        timers.totals.update(counts["totals"])
        timers.totals["launch-start"] = stamps["start_s"]
        timers.totals.update(startup_stages(counts["startup"]))
        for k in ("num_batches", "total_reads", "total_bytes"):
            setattr(timers, k, counts[k])
    return result


def _log_setup():
    """What a rank needs to log as this process does: the root logger's
    level and format, its log files (reopened for appending here, so that
    this process's later lines land after rank 0's) and whether it also
    logs to the console."""
    root = logging.getLogger()
    files, fmt, console = [], None, False
    for h in root.handlers:
        if isinstance(h, logging.FileHandler):
            h.close()  # reopened on the next record, appending
            h.mode = "a"
            files.append(h.baseFilename)
        elif isinstance(h, logging.StreamHandler):
            console = True
        if h.formatter is not None:
            fmt = h.formatter._fmt
    return {"level": root.level, "files": files, "format": fmt,
            "console": console}


def _rank_run(runner, opts, kw, log):
    """The rank side of :func:`run_sharded`: returns ``(result, timer
    counts)``, the counts with this rank's start-up stamps, its first
    batch the first entry into the ``compute`` stage.  The CLI's errors
    exit 255 after one ``Error:`` line, as ``main()`` prints them."""
    from ..device import DeviceUnavailable
    from ..io.fastq import FastqParseError
    from ..utils.timers import StageTimers

    pg = mesh.initialize_distributed()
    root = logging.getLogger()
    if pg.rank == 0:
        root.setLevel(log["level"])
        handlers = [logging.FileHandler(f, mode="a") for f in log["files"]]
        if log["console"]:
            handlers.append(logging.StreamHandler())
    else:
        root.setLevel(max(log["level"], logging.WARNING))
        handlers = [logging.StreamHandler()]
        sys.stdout = open(os.devnull, "w")
    for h in handlers:
        h.setFormatter(logging.Formatter(log["format"]))
        root.addHandler(h)
    timers = StageTimers()
    try:
        result = runner(opts, timers, device=pg.device, **kw)
    except (FastqParseError, DeviceUnavailable, NotImplementedError) as e:
        print("Error: %s" % e, file=sys.stderr)
        sys.exit(255)
    return result, {"totals": timers.totals, "num_batches": timers.num_batches,
                    "total_reads": timers.total_reads,
                    "total_bytes": timers.total_bytes,
                    "startup": dict(STAMPS,
                                    first_batch=timers.first.get("compute"))}
