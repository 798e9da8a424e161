"""Rank targets of ``tests/test_torch_launch*.py``.

``hpgq_torch.dist.launch`` starts each rank as a new interpreter that
imports its target by name, so the targets live here, in a module that
imports neither ``jax`` nor ``hpgq`` (the test files import both) and
only the port's modules.
"""

import os
import signal
import sys
import time

import torch.distributed as dist

from hpgq_torch.dist import mesh, run_dist

RUNNERS = {"stats": run_dist.run_stats_sharded,
           "filter": run_dist.run_filter_sharded,
           "edit": run_dist.run_edit_sharded,
           "prepro": run_dist.run_edit_sharded,
           "cgr": run_dist.run_cgr_sharded}


def run_jobs(jobs):
    """Each ``(name, options)`` through its ``run_*_sharded`` runner on
    this rank, in turn; ``{name: (result, rank, world size, jax
    loaded)}``, the same on every rank (rank 0's reaches the parent)."""
    pg = mesh.initialize_distributed()
    out = {}
    for name, opts in jobs:
        res = RUNNERS[opts.command_name](opts, device=pg.device)
        out[name] = (res, pg.rank, pg.world_size,
                     any(sys.modules.get(n) is not None
                         for n in ("jax", "jaxlib", "hpgq")))
    return out


def _note_pid(pid_dir):
    with open(os.path.join(pid_dir, "rank%d.pid" % dist.get_rank()),
              "w") as f:
        f.write(str(os.getpid()))


def fail_on_rank_one(opts, pid_dir):
    """Rank 1 raises at once; rank 0 runs `stats` over its range and then
    waits in the merge for a rank that never comes."""
    _note_pid(pid_dir)
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return run_dist.run_stats_sharded(opts, device="cpu")


def wait_forever(pid_dir):
    """Every rank waits: rank 0 in a collective, the others asleep."""
    _note_pid(pid_dir)
    if dist.get_rank() == 0:
        mesh.barrier(mesh.initialize_distributed())
    time.sleep(3600)


def wait_through_sigterm(pid_dir):
    """:func:`wait_forever`, with SIGTERM ignored: a rank that only
    SIGKILL stops, after the launcher's grace period."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    wait_forever(pid_dir)


def stats_then_wait(opts, pid_dir):
    """``stats`` over this rank's range until its first rotating
    checkpoint is on disk; then the rank notes its pid and waits, as
    :func:`wait_forever` waits (both ranks save at the same lockstep
    step)."""
    real = run_dist._RotatingRankCheckpoint.maybe_save

    def save_then_wait(self, *a, **k):
        if real(self, *a, **k):
            _note_pid(pid_dir)
            time.sleep(3600)
        return False

    run_dist._RotatingRankCheckpoint.maybe_save = save_then_wait
    return run_dist.run_stats_sharded(opts, device="cpu")
