"""The process group of a ``--sharded`` run, its host votes and its merge.

The counterpart of ``hpgq/dist/mesh.py``.  The file keeps that name so a
reader finds the counterpart, but it holds a process group, not a device
mesh: the port runs one process per card, and each rank runs the port's
single-process sessions on its own part of the input
(:mod:`hpgq_torch.dist.run_dist`).  The rank-local counters merge once, at
the end: SUM on every integer field, MIN on ``min_length``, MAX on
``max_length`` (``StatsCounters.merge``), and ``acc_quality`` summed in
rank order.

Every collective runs over one gloo group on CPU tensors: the host votes
(:func:`vote_max_vec`, :func:`vote_sum`, :func:`barrier`), as ``hpgq``'s
key-value votes are host-side, and the merge too, since what it merges is
on the host already (the sessions' ``finish()`` and ``take()`` return host
counters, and CGR's tables are numpy).  The merge runs once per run (once
per checkpoint under one), so a card collective would only copy those
arrays to the card and back.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.counters import StatsCounters
from ..device import resolve_device
from ..pipeline.ranges import (  # noqa: F401  (re-exported, as hpgq's mesh)
    count_newlines_in_range,
    range_splittable,
    record_offsets,
    split_byte_ranges,
    split_paired_ranges,
)

# how long a rank waits at the group's creation and in any collective
# before it fails (a rank that died leaves the others waiting)
TIMEOUT = datetime.timedelta(minutes=15)

# whether initialize_distributed made the default group (and so owns it)
_MADE = False
# the device the local launcher gave this rank (None: LOCAL_RANK picks it)
_RANK_DEVICE = None

_log = logging.getLogger("hpgq")

_SCALARS = ("num_reads", "num_passed", "num_failed", "acc_length", "num_As",
            "num_Cs", "num_Gs", "num_Ts", "num_Ns")


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place in a ``--sharded`` run: ``rank`` of
    ``world_size``, and the card (or the CPU) it runs on."""

    rank: int
    world_size: int
    device: torch.device


def initialize_distributed(device="cuda", rank_device=None) -> RankGroup:
    """Join the run's process group and pick this rank's device.

    torch's launcher variables say where the rank stands: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and, for the ``env://`` rendezvous,
    ``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun`` sets them all).
    Without ``RANK`` and ``WORLD_SIZE`` the world size is 1 and no group is
    made.  A default group the caller already made (for
    instance with a ``file://`` rendezvous) is used as it is, and must hold
    gloo, since every collective of the run is on CPU tensors.  On CUDA the
    rank runs on ``cuda:LOCAL_RANK % device_count``, unless a
    ``rank_device`` was given, in this call or an earlier one
    (:mod:`hpgq_torch.dist.launch` gives each rank its own): that device is
    the rank's, the CPU too, and two ranks may share a card."""
    global _MADE, _RANK_DEVICE
    if rank_device is not None:
        _RANK_DEVICE = resolve_device(rank_device)
    env = os.environ
    made = dist.is_available() and dist.is_initialized()
    if made:
        backend = str(dist.get_backend())
        if "gloo" not in backend:
            raise ValueError(
                "--sharded collectives run on CPU tensors over gloo; the "
                "process group's backend is %r" % backend)
        rank, world = dist.get_rank(), dist.get_world_size()
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        return RankGroup(0, 1, resolve_device(device))
    if _RANK_DEVICE is not None:
        dev = _RANK_DEVICE
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank))
                               % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not made:
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world, timeout=TIMEOUT)
        _MADE = True
    _log.info(
        "torch.distributed: rank %d of %d on %s, collectives over gloo",
        rank, world, dev)
    return RankGroup(rank, world, dev)


def leave_group() -> None:
    """Destroy the default group if :func:`initialize_distributed` made it
    (a group the caller made stays): the CLI calls this before the process
    exits, since a gloo group left to the interpreter's exit can abort the
    process after a run that succeeded."""
    global _MADE
    if _MADE and dist.is_initialized():
        dist.destroy_process_group()
    _MADE = False


def rank_devices(opts, device="cuda") -> list:
    """The devices of the ranks that a ``--sharded`` run of ``opts`` starts
    on this host, one per rank; a list of one means that this process runs
    the command itself.  The counterpart of ``data_mesh()``'s default,
    every local device (``hpgq/dist/mesh.py:43-46``):

    * under a launcher (``RANK`` and ``WORLD_SIZE`` set) or in a process
      group that exists already, this process is one rank of that run;
    * on the CPU, one process;
    * resuming a checkpoint set that M ranks wrote, M ranks (round-robin
      over the cards when M is more); a one-process checkpoint (``hpgq``'s
      one-process mesh writes one) stays in one process;
    * plain gzip with ``--checkpoint``, one process: striped ranks drop
      the checkpoint (:func:`~hpgq_torch.dist.run_dist._striped_checkpoint`),
      and ``hpgq``'s one-process mesh keeps it; plain gzip where the
      command needs byte ranges (paired ``stats``, ``filter``, ``edit``,
      ``prepro``), one process too, as in ``hpgq``'s mesh;
    * one visible card, one process;
    * else one rank per visible card (``CUDA_VISIBLE_DEVICES`` narrows
      them).

    The choice is logged at INFO with its reason."""
    devs, why = _rank_plan(opts, torch.device(device))
    if len(devs) == 1:
        _log.info("--sharded: 1 process on %s: %s", devs[0], why)
    else:
        _log.info("--sharded: %d ranks, %s: %s", len(devs), why,
                  ", ".join(str(d) for d in devs))
    return devs


def _rank_plan(opts, dev):
    """``(devices, reason)`` of :func:`rank_devices`."""
    if (dist.is_available() and dist.is_initialized()) or (
            "RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return [dev], "this process is one rank of a launched run"
    if dev.type != "cuda":
        return [dev], "the run is on the %s" % dev.type
    cards = torch.cuda.device_count()
    inputs = [opts.in_filename] + ([opts.in_filename2]
                                   if opts.paired_end else [])
    if opts.checkpoint_path:
        m = checkpoint_world_size(opts.checkpoint_path, inputs)
        if m == 1:
            return [dev], "resuming a one-process checkpoint"
        if m > 1:
            return ([torch.device("cuda", r % cards) for r in range(m)],
                    "resuming a %d-rank checkpoint" % m)
    if not all(range_splittable(p) for p in inputs):
        cmd = opts.command_name
        if opts.checkpoint_path:
            return [dev], ("plain gzip input with --checkpoint (striped "
                           "ranks cannot resume)")
        if cmd == "stats" and opts.paired_end:
            cmd = "paired stats"
        if cmd not in ("stats", "cgr"):  # the commands that stripe gzip
            return [dev], ("plain gzip input, which %s splits only by byte "
                           "range" % cmd)
    if cards < 2:
        return [dev], "one visible card"
    return ([torch.device("cuda", i) for i in range(cards)],
            "one per card")


def _checkpoint_key(path: str):
    """The config key (decoded) of the checkpoint at ``path``, or None."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        return json.loads(meta["config_key"])
    except (OSError, ValueError, KeyError):
        return None


def checkpoint_world_size(path: str, inputs) -> int:
    """How many processes wrote the checkpoint set at ``path``: ``nprocs``
    of the rotating slots (``<path>.rank0.{a,b}``, ``<path>.{a,b}``) of
    ``stats`` and ``cgr``; for ``filter``, ``edit`` and ``prepro``, the
    rank count whose byte range of ``inputs[0]`` matches the range in a
    rank's ``<path>.rankNNNN`` (up to 256 ranks), or 1 for a single
    ``<path>``.  0 when there is no checkpoint."""
    for base in (path + ".rank0", path):
        for slot in ("a", "b"):
            key = _checkpoint_key("%s.%s" % (base, slot))
            if key is not None:
                return int(key.get("nprocs", 1))
    d, name = os.path.split(os.path.abspath(path))
    ranks = sorted(int(f[len(name) + 5:]) for f in os.listdir(d)
                   if f.startswith(name + ".rank")
                   and f[len(name) + 5:].isdigit())
    for i in ranks:
        rng = (_checkpoint_key("%s.rank%04d" % (path, i)) or {}).get("range")
        for m in range(i + 1, 257):
            if rng and list(split_byte_ranges(inputs[0], m)[i]) == rng:
                return m
    return 1 if os.path.exists(path) else 0


def _all_reduce(values: np.ndarray, op) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(values))
    dist.all_reduce(t, op=op)
    return t.numpy()


def vote_max_vec(pg: RankGroup, values) -> np.ndarray:
    """Element-wise max over the ranks of a small int64 vector (gloo, on
    the host); the values unchanged at world size 1."""
    vals = np.atleast_1d(np.asarray(values, dtype=np.int64))
    if pg.world_size == 1:
        return vals
    return _all_reduce(vals, dist.ReduceOp.MAX)


def vote_sum(pg: RankGroup, values) -> np.ndarray:
    """Element-wise sum over the ranks of a small int64 vector (gloo)."""
    vals = np.atleast_1d(np.asarray(values, dtype=np.int64))
    if pg.world_size == 1:
        return vals
    return _all_reduce(vals, dist.ReduceOp.SUM)


def barrier(pg: RankGroup) -> None:
    """Every rank reaches this point (one host vote)."""
    vote_max_vec(pg, [1])


def sharded_sum(pg: RankGroup, *arrays) -> list:
    """Each int64 array summed over the ranks, in one collective (CGR's
    tables and word count)."""
    arrays = [np.asarray(a, dtype=np.int64) for a in arrays]
    if pg.world_size == 1:
        return arrays
    flat = _all_reduce(np.concatenate([a.ravel() for a in arrays]),
                       dist.ReduceOp.SUM)
    out, at = [], 0
    for a in arrays:
        out.append(flat[at:at + a.size].reshape(a.shape))
        at += a.size
    return out


def _fit(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` zero-padded along its last axis to ``n``."""
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])])


def sharded_counters(pg: RankGroup, c: StatsCounters) -> StatsCounters:
    """The rank-local counters ``c`` merged over every rank, the same on
    each: ``StatsCounters.merge`` of all of them in rank order (SUM on the
    integer fields, MIN/MAX on the length bounds, ``acc_quality`` added in
    rank order)."""
    if pg.world_size == 1:
        return c
    lcap, nhist = (int(v) for v in vote_max_vec(
        pg, [c.lcap, c.length_hist.shape[0]]))
    fields = [("length_hist", max(nhist, lcap + 1)), ("quality_hist", None),
              ("gc_hist", None), ("count_quality_per_nt", lcap),
              ("acc_quality_per_nt", lcap), ("base_per_nt", lcap)]
    if c.kmers_on:
        fields += [("kmer_counts", None), ("kmer_counts_by_pos", lcap)]
    # position-indexed fields padded to the widest rank's; the histograms
    # of quality and GC have fixed widths
    parts = [getattr(c, k) if n is None else _fit(getattr(c, k), n)
             for k, n in fields]
    flat = _all_reduce(np.concatenate(
        [np.array([getattr(c, k) for k in _SCALARS], np.int64)]
        + [p.ravel() for p in parts]), dist.ReduceOp.SUM)
    # min_length starts at 100000 on every rank (the reference's initial
    # value) and only ever falls, so a rank with no read cannot lower it
    hi, neg_lo = _all_reduce(np.array([c.max_length, -c.min_length],
                                      np.int64), dist.ReduceOp.MAX)
    aq = np.zeros(pg.world_size, np.float64)
    aq[pg.rank] = c.acc_quality
    aq = _all_reduce(aq, dist.ReduceOp.SUM)

    out = StatsCounters(phred=c.phred, kmers_on=c.kmers_on)
    out.filter_on = c.filter_on
    for k, v in zip(_SCALARS, flat):
        setattr(out, k, int(v))
    at = len(_SCALARS)
    for (k, _), p in zip(fields, parts):
        setattr(out, k, flat[at:at + p.size].reshape(p.shape).copy())
        at += p.size
    out.max_length, out.min_length = int(hi), int(-neg_lo)
    out.acc_quality = sum(aq.tolist())  # rank order, as merge() adds them
    return out
