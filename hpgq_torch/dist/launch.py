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
so do Ctrl-C and SIGTERM to the parent.  Each rank also dies with the
parent.  :func:`run_sharded` is the entry points' route: the CLI's
commands, the legacy flags, the API and ``cgr_run.run_cgr``.
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

import torch
import torch.distributed as dist

from . import mesh

_log = logging.getLogger("hpgq")

# seconds a rank has to exit after SIGTERM before it is killed
_GRACE_S = 5.0
_PR_SET_PDEATHSIG = 1


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


def launch(target, args=(), devices=None):
    """Run ``target(*args)`` as ``len(devices)`` ranks of one gloo group,
    rank ``r`` on ``devices[r]`` (default: :func:`local_devices`); return
    rank 0's return value.  ``target`` and ``args`` must pickle, and
    ``target`` must be importable in a new interpreter.  Raises
    :class:`RankFailed` when a rank exits non-zero, after stopping the
    others."""
    devices = [torch.device(d) for d in (devices or local_devices())]
    if not devices:
        raise ValueError("launch: no device to run a rank on")
    ctx = multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="hpgq_torch_ranks_")
    procs = []
    restore = _trap_sigterm()
    try:
        for r, dev in enumerate(devices):
            p = ctx.Process(target=_rank_main, name="hpgq_torch rank %d" % r,
                            args=(target, tuple(args), r, len(devices),
                                  str(dev), work, os.getpid()))
            p.start()
            procs.append(p)
        _wait_all(procs)
        with open(os.path.join(work, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        _stop(procs)
        shutil.rmtree(work, ignore_errors=True)
        restore()  # last: it may pass a SIGTERM on


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
    the grace period; every rank reaped."""
    for p in procs:
        if p.exitcode is None:
            p.terminate()
    for p in procs:
        p.join(_GRACE_S)
        if p.exitcode is None:
            p.kill()
            p.join()


class _Terminated(SystemExit):
    """SIGTERM reached the parent while ranks ran (exit status 143 where
    no handler of the parent's own takes it)."""

    def __init__(self):
        super().__init__(128 + signal.SIGTERM)


def _trap_sigterm():
    """Turn SIGTERM into :class:`_Terminated` while the ranks run (main
    thread only); returns the undo, which passes a caught SIGTERM on to
    the handler that was there before."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    caught = []

    def on_term(signum, frame):
        caught.append(signum)
        raise _Terminated()

    prev = signal.signal(signal.SIGTERM, on_term)
    if prev is None:  # a handler set outside Python: SIGTERM's default
        prev = signal.SIG_DFL

    def restore():
        signal.signal(signal.SIGTERM, prev)
        if caught:  # the ranks are stopped: now the parent's own handling
            signal.raise_signal(signal.SIGTERM)

    return restore


def _die_with_parent(parent: int) -> None:
    """The rank gets SIGKILL when the parent dies (Linux), so that no rank
    outlives a parent that was killed outright."""
    with contextlib.suppress(OSError, AttributeError):
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:  # it died before the call above
        os._exit(1)


def _rank_main(target, args, rank, world, device, work, parent):
    """A rank's process: the launcher's variables, the group over the
    ``file://`` rendezvous, this rank's device, ``target(*args)``; rank 0's
    return value pickled for the parent."""
    _die_with_parent(parent)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "rendezvous"),
        rank=rank, world_size=world, timeout=mesh.TIMEOUT)
    try:
        mesh.initialize_distributed(device, rank_device=device)
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
    result; ``timers`` gets rank 0's stage totals and counts.  Log lines
    go where this process's go, from rank 0; the other ranks print only
    warnings and errors."""
    devices = mesh.rank_devices(opts, device)
    if len(devices) == 1:
        return runner(opts, timers, device=devices[0], **kw)
    result, counts = launch(_rank_run, (runner, opts, kw, _log_setup()),
                            devices)
    if timers is not None:
        timers.totals.update(counts["totals"])
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
    counts)``.  The CLI's errors exit 255 after one ``Error:`` line, as
    ``main()`` prints them."""
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
                    "total_bytes": timers.total_bytes}
