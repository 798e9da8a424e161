"""Multi-process ``--sharded`` runs of every command, over torch.distributed.

The counterpart of ``hpgq/dist/run_dist.py``.  One process per card
(:mod:`hpgq_torch.dist.mesh`); each rank reads its own part of the input, a
record-aligned byte range of a plain or BGZF file (mate ranges covering the
same records) or every p-th block of a plain-gzip stream, and runs the
port's single-process code on it:

* ``stats``: :class:`~hpgq_torch.pipeline.session.StatsSession` or
  :class:`~hpgq_torch.pipeline.session.PairedStatsSession`; the counters
  merge once at the end and rank 0 writes the report;
* ``cgr``: :class:`~hpgq_torch.pipeline.cgr_run.CgrSession`; the int64
  tables and the word count are summed and rank 0 writes the PGM and
  ``.gs`` files;
* ``filter``, ``edit`` and ``prepro``: the whole ``run_filter`` /
  ``run_edit`` pipeline on the rank's range into per-rank shard files,
  which rank 0 concatenates in rank order (which is input order); the
  counts are summed.

Kernels launched per rank need no shape that every rank shares, so what
``hpgq`` needs for one SPMD program is not here: the global batch, the
sharded partials and steps, the per-step shape and wire-tier vote, the
exception regrouping and the int32 flush.  Ranks step together only under
a checkpoint, whose saves must fall at one step on every rank
(:func:`iter_lockstep`).  Checkpoints keep ``hpgq``'s format: two rotating
slots per rank, ``hpgq``'s file names and config keys, and the carry is
the global total at a common step, so either package resumes the other's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Optional

import numpy as np

from ..io.fastq import FastqReader
from ..options import OptionsError, StatsOptions
from ..pipeline.cgr_run import CgrSession, emit_cgr_outputs, run_cgr
from ..pipeline.run import (
    _EDIT_COUNTS,
    _batch_reads,
    _coalesced,
    _iter_blocks,
    _iter_blocks_paired,
    _iter_packed,
    _iter_packed_paired,
    _reader_batch,
    _warn_no_pallas,
    run_edit,
    run_filter,
    run_stats,
)
from ..pipeline.session import PairedStatsSession, StatsSession
from ..report.stats_report import stats_report
from ..utils.checkpoint import (
    load_counters_checkpoint,
    save_counters_checkpoint,
)
from ..utils.timers import StageTimers
from .mesh import (
    barrier,
    initialize_distributed,
    range_splittable,
    sharded_counters,
    sharded_sum,
    split_byte_ranges,
    split_paired_ranges,
    vote_max_vec,
    vote_sum,
)

_log = logging.getLogger("hpgq")


def striped_blocks(reader, stripe: int, n_stripes: int):
    """Every ``n_stripes``-th block of the reader, from ``stripe``: the
    split of a plain-gzip stream, which cannot seek (every rank inflates
    the stream and keeps its own stripe)."""
    for i, block in enumerate(reader):
        if i % n_stripes == stripe:
            yield block


def open_shard_reader(path: str, opts, pg, timers, start_offset=None):
    """``(reader, block iterator)`` of this rank's part of ``path``: its
    record-aligned byte range (plain or BGZF), its stripe (plain gzip), or
    the whole file at world size 1.  ``start_offset`` resumes a range or a
    whole file from a checkpointed logical offset; the reader times its
    inflate and index in ``timers``."""
    batch = _reader_batch(opts, pg.device)
    if pg.world_size > 1 and range_splittable(path):
        start, end = split_byte_ranges(path, pg.world_size)[pg.rank]
        if start_offset is not None:
            start = max(start, start_offset)
        reader = FastqReader(path, batch_size=batch, start_offset=start,
                             end_offset=end, timers=timers)
        return reader, iter(reader)
    if pg.world_size > 1:
        reader = FastqReader(path, batch_size=batch, timers=timers)
        return reader, striped_blocks(reader, pg.rank, pg.world_size)
    reader = FastqReader(path, batch_size=batch,
                         start_offset=start_offset or 0, timers=timers)
    return reader, iter(reader)


def _require_splittable(paths, cmd: str) -> None:
    for p in paths:
        if not range_splittable(p):
            raise OptionsError(
                "%s: multi-process --sharded needs a byte-seekable input "
                "(plain or BGZF FASTQ); %r is plain gzip — recompress with "
                "bgzip or run without --sharded" % (cmd, p))


def _striped_checkpoint(pg, paths, ck_path):
    """The checkpoint path, or None (with ``hpgq``'s warning, word for
    word) where a stripe would have to resume: its phase is not an
    offset."""
    if ck_path and pg.world_size > 1 and not all(range_splittable(p)
                                                 for p in paths):
        _log.warning("--checkpoint is not supported for striped (plain-gzip) "
                     "multi-host input; running without checkpoints")
        return None
    return ck_path


def iter_lockstep(pg, items, lockstep: bool, timers):
    """The items of this rank's input.  With ``lockstep`` (a checkpoint,
    whose saves must fall at one step on every rank) one host vote per
    step, "does any rank have input left", and None on a rank whose input
    ran out while another's did not; without it, plain iteration: a rank
    runs its whole range and meets the others at the merge."""
    if not lockstep or pg.world_size == 1:
        yield from items
        return
    items = iter(items)
    done = False
    while True:
        item = None if done else next(items, None)
        done = item is None
        with timers.stage("vote"):
            if not vote_max_vec(pg, [0 if done else 1])[0]:
                return
        yield item


class _RotatingRankCheckpoint:
    """Per-rank checkpoints in two rotating slots, ``<path>.rank<i>.{a,b}``
    (``<path>.{a,b}`` at world size 1), resumed at the newest ordinal every
    rank holds (``hpgq/dist/run_dist.py:1011-1085``).  Saves fall at one
    lockstep step on every rank, so after a crash the ranks' newest
    ordinals differ by at most one, and two slots always hold a common
    one."""

    def __init__(self, pg, path: str, key: str, every: int):
        self.pg = pg
        self.base = path if pg.world_size == 1 else "%s.rank%d" % (path,
                                                                   pg.rank)
        self.key = key
        self.every = max(1, every)
        self.ordinal = -1
        self.nsteps = 0

    def resume(self):
        """``(counters or None, offset, extra)`` at the common ordinal, or
        None when any rank lacks it (every rank then starts afresh)."""
        cands = {}
        for slot in ("a", "b"):
            try:
                got = load_counters_checkpoint(self.base + "." + slot,
                                               self.key)
            except ValueError:
                got = None
            if got:
                cands[int(got[2]["ordinal"])] = got
        local = max(cands) if cands else -1
        common = -int(vote_max_vec(self.pg, [-local])[0])
        ok = common >= 0 and common in cands
        if not -int(vote_max_vec(self.pg, [-int(ok)])[0]):
            return None
        self.ordinal = common
        return cands[common]

    def maybe_save(self, counters, offset: int, extra=None, fold=None,
                   counters2=None) -> bool:
        """Call once per lockstep step; every ``every`` steps run ``fold``
        (the collective merge into the carry), then save.  ``counters``,
        ``counters2`` and ``extra`` may be callables, read after the
        fold."""
        self.nsteps += 1
        if self.nsteps % self.every:
            return False
        if fold is not None:
            fold()
        self.ordinal += 1

        def value(x):
            return x() if callable(x) else x

        payload = dict(value(extra) or {})
        payload["ordinal"] = self.ordinal
        save_counters_checkpoint(
            self.base + ("." + "ab"[self.ordinal % 2]), value(counters),
            offset, self.key, extra=payload, counters2=value(counters2))
        return True

    def complete(self) -> None:
        for slot in ("a", "b"):
            p = self.base + "." + slot
            if os.path.exists(p):
                os.unlink(p)


def _untraced(opts):
    """``opts`` without ``--profile-dir``: a ``--sharded`` run takes the
    flag and writes no trace, as in ``hpgq``."""
    return dataclasses.replace(opts, profile_dir=None)


def _crit_key(crit):
    return None if crit is None else dataclasses.astuple(crit)


def _merged(carry, since, crit):
    """The global total: the carry of a checkpoint (global already, so
    added once) plus what every rank counted since."""
    total = since if carry is None else carry.merge(since)
    total.filter_on = crit is not None
    return total


def run_stats_sharded(opts: StatsOptions,
                      timers: Optional[StageTimers] = None,
                      report: bool = True, device="cuda"):
    """`stats` over every rank of the run; the counters (a ``(c1, c2)``
    pair for paired input) come back the same on every rank, and rank 0
    writes the report.  One process with no checkpoint runs the ordinary
    pipeline; under a checkpoint it keeps the sharded checkpoint's
    format."""
    _warn_no_pallas(opts)
    opts = _untraced(opts)
    timers = timers or StageTimers()
    pg = initialize_distributed(device)
    if pg.world_size == 1 and not opts.checkpoint_path:
        return run_stats(opts, timers, report=report, device=pg.device)
    if opts.paired_end:
        return _run_stats_sharded_paired(opts, timers, pg, report)
    dev = pg.device
    crit = opts.criteria if opts.filter_on else None
    br = _batch_reads(opts, dev)
    sess = StatsSession(opts.quality_encoding_value, crit, batch_reads=br,
                        device=dev, kmers_on=opts.kmers_on, timers=timers)
    path = opts.in_filename
    ck_path = _striped_checkpoint(pg, [path], opts.checkpoint_path)
    ck = carry = offset = None
    if ck_path:
        ck = _RotatingRankCheckpoint(pg, ck_path, json.dumps({
            "cmd": "stats-sharded", "in": os.path.abspath(path),
            "phred": opts.quality_encoding_value, "kmers": opts.kmers_on,
            "crit": _crit_key(crit), "rank": pg.rank,
            "nprocs": pg.world_size}, sort_keys=True),
            opts.checkpoint_every or 50)
        got = ck.resume()
        if got:
            carry, offset, _ = got

    def fold():
        nonlocal carry
        with timers.stage("fold"):
            local = sess.take()
        carry = _merged(carry, sharded_counters(pg, local), crit)

    last = offset or 0
    reader, blocks = open_shard_reader(path, opts, pg, timers, offset)
    with reader:
        items = _iter_packed(_coalesced(opts, blocks, dev), sess, br, timers,
                             depth=opts.batch_list_size, plan=reader.plan)
        for item in iter_lockstep(pg, items, ck is not None, timers):
            if item is not None:
                block, arrs = item
                with timers.stage("compute"):
                    sess.feed_packed(*arrs)
                last = block.end_offset
            if ck is not None:
                with timers.stage("checkpoint"):
                    ck.maybe_save(lambda: carry, last, fold=fold)

    with timers.stage("finish-merge"):
        with timers.stage("fold"):
            local = sess.finish()
        counters = _merged(carry, sharded_counters(pg, local), crit)
    if ck is not None:
        ck.complete()
    if report and pg.rank == 0:
        with timers.stage("reporting"):
            stats_report(counters, opts)
    return counters


def _run_stats_sharded_paired(opts, timers, pg, report: bool):
    """Paired `stats` (``hpgq/dist/run_dist.py:1191-1291``): mate ranges
    that cover the same records, the port's paired session on them, both
    mates merged; the pair tallies ride mate 1 and are copied to mate 2."""
    dev = pg.device
    crit = opts.criteria if opts.filter_on else None
    paths = [opts.in_filename, opts.in_filename2]
    if pg.world_size > 1:
        _require_splittable(paths, "paired stats")
        (s1, e1), (s2, e2) = split_paired_ranges(*paths,
                                                 pg.world_size)[pg.rank]
    else:
        (s1, e1), (s2, e2) = (0, None), (0, None)
    sess = PairedStatsSession(opts.quality_encoding_value, crit,
                              batch_reads=_batch_reads(opts, dev), device=dev,
                              kmers_on=opts.kmers_on, timers=timers)
    ck = carry1 = carry2 = None
    if opts.checkpoint_path:
        ck = _RotatingRankCheckpoint(pg, opts.checkpoint_path, json.dumps({
            "cmd": "stats-sharded-paired", "fused": True,
            "in": [os.path.abspath(p) for p in paths],
            "phred": opts.quality_encoding_value, "kmers": opts.kmers_on,
            "crit": _crit_key(crit), "rank": pg.rank,
            "nprocs": pg.world_size}, sort_keys=True),
            opts.checkpoint_every or 50)
        got = ck.resume()
        if got:
            carry1, off1, extra = got
            carry2 = extra["__counters2__"]
            s1, s2 = max(s1, int(off1)), max(s2, int(extra["offset2"]))

    def merge_both(c1, c2):
        m1 = _merged(carry1, sharded_counters(pg, c1), crit)
        m2 = _merged(carry2, sharded_counters(pg, c2), crit)
        m2.num_passed, m2.num_failed = m1.num_passed, m1.num_failed
        return m1, m2

    def fold():
        nonlocal carry1, carry2
        with timers.stage("fold"):
            local = sess.take()
        carry1, carry2 = merge_both(*local)

    last1, last2 = s1, s2
    batch = _reader_batch(opts, dev)
    with FastqReader(paths[0], batch_size=batch, start_offset=s1,
                     end_offset=e1, timers=timers, mates=2) as r1, \
            FastqReader(paths[1], batch_size=batch, start_offset=s2,
                        end_offset=e2, timers=timers, mates=2) as r2:
        items = _iter_packed_paired(_iter_blocks_paired(
            _coalesced(opts, r1, dev), _coalesced(opts, r2, dev), timers),
            sess, timers, plan=r1.plan)
        for item in iter_lockstep(pg, items, ck is not None, timers):
            if item is not None:
                b1, b2, in1, in2 = item
                with timers.stage("compute"):
                    sess.feed_pair_packed(in1, in2)
                last1, last2 = b1.end_offset, b2.end_offset
            if ck is not None:
                with timers.stage("checkpoint"):
                    ck.maybe_save(lambda: carry1, last1,
                                  counters2=lambda: carry2,
                                  extra=lambda: {"offset2": last2},
                                  fold=fold)

    with timers.stage("finish-merge"):
        with timers.stage("fold"):
            local = sess.finish()
        c1, c2 = merge_both(*local)
    if ck is not None:
        ck.complete()
    if report and pg.rank == 0:
        with timers.stage("reporting"):
            stats_report(c1, opts)
            stats_report(c2, dataclasses.replace(opts,
                                                 in_filename=paths[1]))
    return c1, c2


def run_cgr_sharded(opts, timers: Optional[StageTimers] = None,
                    device="cuda") -> dict:
    """`cgr` over every rank of the run: each rank's tables over its part
    of each input (both mates make one signature), summed over the ranks;
    rank 0 writes the PGM and ``.gs`` files.  Every rank returns the
    tables and the word count.  One process with no checkpoint runs the
    ordinary pipeline, as :func:`run_stats_sharded`."""
    _warn_no_pallas(opts)
    timers = timers or StageTimers()
    pg = initialize_distributed(device)
    if pg.world_size == 1 and not opts.checkpoint_path:
        return run_cgr(dataclasses.replace(opts, sharded=False), timers,
                       device=pg.device)
    k = int(opts.k)
    phred = opts.quality_encoding_value
    sess = CgrSession(k, phred, _batch_reads(opts, pg.device), pg.device)
    inputs = [opts.in_filename] + ([opts.in_filename2]
                                   if opts.paired_end else [])
    carry = [np.zeros_like(sess.table_seq), np.zeros_like(sess.table_q),
             np.zeros(1, np.int64)]
    ck_path = _striped_checkpoint(pg, inputs, opts.checkpoint_path)
    ck = offset = None
    start_input = 0
    if ck_path:
        ck = _RotatingRankCheckpoint(pg, ck_path, json.dumps({
            "cmd": "cgr-sharded", "k": k, "phred": phred,
            "in": [os.path.abspath(p) for p in inputs],
            "rank": pg.rank, "nprocs": pg.world_size}, sort_keys=True),
            opts.checkpoint_every or 50)
        got = ck.resume()
        if got:
            _, offset, extra = got
            carry = [np.asarray(extra["table_seq"], np.int64),
                     np.asarray(extra["table_q"], np.int64),
                     np.array([int(extra["words"])], np.int64)]
            start_input = int(extra["input_idx"])

    def local():
        return sess.table_seq, sess.table_q, np.array([sess.word_count])

    def fold():
        nonlocal carry
        carry = [a + b for a, b in zip(carry, sharded_sum(pg, *local()))]
        sess.table_seq[...] = 0
        sess.table_q[...] = 0
        sess.word_count = 0

    for idx, path in enumerate(inputs):
        if idx < start_input:
            continue
        start = offset if idx == start_input else None
        reader, blocks = open_shard_reader(path, opts, pg, timers, start)
        last = start or 0
        with reader:
            if ck is None:
                sess.feed_all(blocks, timers, reader.plan)
                continue
            for block in iter_lockstep(pg, _iter_blocks(blocks, timers),
                                       True, timers):
                if block is not None:
                    with timers.stage("compute"):
                        sess.feed_block(block)
                    last = block.end_offset
                with timers.stage("checkpoint"):
                    ck.maybe_save(None, last, extra=lambda: {
                        "table_seq": carry[0], "table_q": carry[1],
                        "words": int(carry[2][0]), "input_idx": idx},
                        fold=fold)
    with timers.stage("finish-merge"):
        fold()
    if ck is not None:
        ck.complete()
    sess.table_seq, sess.table_q = carry[0], carry[1]
    sess.word_count = int(carry[2][0])
    if pg.rank != 0:
        return {"fq_word_count": sess.word_count, "pgm_files": [],
                "table_seq": sess.table_seq, "table_q": sess.table_q}
    return emit_cgr_outputs(opts, sess, timers)


def _shard_path(path: str, rank: int) -> str:
    return "%s.shard%04d" % (path, rank)


def _concat_shards(pg, final_paths) -> bool:
    """Rank 0 concatenates the ranks' output shards in rank order (which
    is input order: byte ranges go to ranks in file order) into the final
    files and removes the shards.  The output directory must be one that
    every rank sees; where a shard is missing, the shards stay for a
    concatenation by hand and False comes back."""
    barrier(pg)  # every rank has written its shards
    if pg.rank != 0:
        barrier(pg)
        return True
    ok = True
    try:
        for final in final_paths:
            shards = [_shard_path(final, i) for i in range(pg.world_size)]
            if not all(os.path.exists(s) for s in shards):
                _log.warning("output dir is not shared across hosts; "
                             "per-rank shards left as %s.shard*", final)
                ok = False
                continue
            with open(final, "wb") as out:
                for s in shards:
                    with open(s, "rb") as f:
                        shutil.copyfileobj(f, out, 16 << 20)
            for s in shards:
                os.unlink(s)
    finally:
        barrier(pg)  # no rank goes on before the shards are concatenated
    return ok


def _run_output_sharded(opts, timers, pg, cmd, runner, count_keys):
    """`filter`, `edit` and `prepro` over every rank
    (``hpgq/dist/run_dist.py:1383-1446``): the ordinary pipeline over this
    rank's range into ``<out>/.shardNNNN/``, lifted to
    ``<out>/<name>.shardNNNN``, then concatenated and the counts summed.
    The explicit range also keeps the runner's own shard readers off: this
    rank's range is one shard already, and nesting would split the whole
    file again."""
    paths = [opts.in_filename] + ([opts.in_filename2]
                                  if opts.paired_end else [])
    _require_splittable(paths, cmd)
    local = dataclasses.replace(opts)
    if opts.paired_end:
        local.input_range, local.input_range2 = split_paired_ranges(
            *paths, pg.world_size)[pg.rank]
    else:
        local.input_range = split_byte_ranges(paths[0],
                                              pg.world_size)[pg.rank]
    shard_dir = os.path.join(opts.out_dirname, ".shard%04d" % pg.rank)
    os.makedirs(shard_dir, exist_ok=True)
    local.out_dirname = shard_dir
    # each rank resumes its own shard: the output commands take no
    # lockstep; the range in the checkpointer's key refuses a resume under
    # another process count
    local.checkpoint_path = (opts.checkpoint_path
                             and "%s.rank%04d" % (opts.checkpoint_path,
                                                  pg.rank))
    out = runner(local, timers, device=pg.device)

    finals = []
    for name in sorted(os.listdir(shard_dir)):
        final = os.path.join(opts.out_dirname, name)
        os.replace(os.path.join(shard_dir, name), _shard_path(final, pg.rank))
        finals.append(final)
    os.rmdir(shard_dir)
    # every rank opened every writer, empty range or not, so the names
    # are the same on every rank
    _concat_shards(pg, finals)
    for key, n in zip(count_keys, vote_sum(pg, [int(out.get(k, 0))
                                                for k in count_keys])):
        out[key] = int(n)
    for key, v in out.items():
        if isinstance(v, str) and ".shard" in v:
            out[key] = v.replace(shard_dir, opts.out_dirname)
    return out


def run_filter_sharded(opts, timers: Optional[StageTimers] = None,
                       device="cuda") -> dict:
    """`filter` over every rank; at world size 1 the ordinary pipeline.
    The outputs are byte-equal to one process's."""
    opts = _untraced(opts)
    timers = timers or StageTimers()
    pg = initialize_distributed(device)
    if pg.world_size == 1:
        return run_filter(opts, timers, device=pg.device)
    return _run_output_sharded(opts, timers, pg, "filter", run_filter,
                               ("num_passed", "num_failed"))


def run_edit_sharded(opts, timers: Optional[StageTimers] = None,
                     device="cuda") -> dict:
    """`edit` (and `prepro`, an edit with its own names) over every rank,
    as :func:`run_filter_sharded`."""
    opts = _untraced(opts)
    timers = timers or StageTimers()
    pg = initialize_distributed(device)
    if pg.world_size == 1:
        return run_edit(opts, timers, device=pg.device)
    return _run_output_sharded(opts, timers, pg, opts.command_name or "edit",
                               run_edit, _EDIT_COUNTS)
