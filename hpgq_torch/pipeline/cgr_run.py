"""The `cgr` command: the chaos-game genomic signature of a FASTQ.

The port of ``hpgq/pipeline/cgr_run.py`` (``:45-227``): ``CgrSession``,
``run_cgr`` and ``emit_cgr_outputs``, with the same outputs
(``<fq>_k=<k>_FG.pgm``, ``_QQ.pgm``, ``_FG_dif.pgm`` against a reference
signature, ``.gs`` with ``--write-gs``), the same checkpoint key and
extras, so either package resumes the other's checkpoint.  Paired input
folds both mates into one signature.

Each block's tables come from :mod:`hpgq_torch.kernels.cgr_torch` on a
fresh zero accumulator and are read back to the host, where they are
summed in input order: blocks are independent, so the pack, copy and
table update of several blocks run on pool threads, each on a CUDA stream
of its own, and no two streams ever add into one tensor.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Optional

import numpy as np

from ..constants import (
    CGR_DIFF_PGM_SUFFIX,
    CGR_FASTQ_PGM_SUFFIX,
    CGR_K_VALUE_INFIX,
    CGR_MAX_QUALITY_IN_TABLE,
    CGR_QUALITY_PGM_SUFFIX,
)
from ..core.accumulator import resolve_wire, to_numpy
from ..device import resolve_device
from ..io.fastq import FastqReader
from ..io.packer import pack_block, pack_block_wire, round_up, wire_len
from ..kernels.cgr_torch import make_cgr_step, zero_cgr_acc
from ..kernels.step import TIER_OF_QBITS, count_batch
from ..kernels.wire_torch import bitwire_kind
from ..options import CgrOptions
from ..report import pgm
from ..utils.checkpoint import (
    load_counters_checkpoint,
    save_counters_checkpoint,
)
from ..utils.timers import StageTimers
from .run import (
    _batch_reads,
    _count,
    _iter_blocks,
    _iter_with,
    _reader_batch,
    _warn_no_pallas,
)
from .session import batch_rows, thread_stream, to_device

# blocks per (device type, wire tier) through CgrSession.block_tables
# since the last reset: shows where the tables were computed
BATCHES = collections.Counter()


class CgrSession:
    """Streaming CGR accumulation: int64 host tables, one device table
    update per block."""

    def __init__(self, k: int, phred: int, batch_reads: int, device="cuda"):
        self.k = k
        self.phred = phred
        self.batch_reads = batch_reads
        self.device = resolve_device(device)
        dim = 1 << k
        self.table_seq = np.zeros((dim, dim), dtype=np.int64)
        self.table_q = np.zeros((dim, dim), dtype=np.int64)
        self.word_count = 0
        self.wire = resolve_wire(None, self.device)
        self._step = make_cgr_step(k, phred, wire=self.wire)
        self._local = threading.local()

    def block_tables(self, block) -> dict:
        """Host int64 tables of one block (``table_seq``, ``table_q``,
        ``words``); touches no session state, so pool threads may call it
        at once."""
        lmax = round_up(max(block.max_len(), self.k), 128)
        rows = batch_rows(block.num_reads, lmax, self.batch_reads)
        if self.wire == "bitpack":
            # wire columns trimmed to the block, floored at k so that one
            # window always fits
            host = (pack_block_wire(block, "bitpack",
                                    wire_len(max(block.max_len(), self.k),
                                             lmax),
                                    pad_reads_to=rows, allow6=True),)
            tier = TIER_OF_QBITS[bitwire_kind(host[0].shape[1])[0]]
        else:
            host = pack_block(block, max_len=lmax, pad_reads_to=rows)
            tier = "plain"
        count_batch(BATCHES, (self.device.type, tier))
        keep = []  # pinned sources, alive until the read-back below
        with thread_stream(self._local, self.device):
            args = to_device(host, self.device, non_blocking=True, keep=keep)
            return to_numpy(self._step(zero_cgr_acc(self.k, self.device),
                                       *args))

    def fold_host(self, host: dict) -> None:
        self.table_seq += host["table_seq"]
        self.table_q += host["table_q"]
        self.word_count += int(host["words"])

    def feed_block(self, block) -> None:
        self.fold_host(self.block_tables(block))

    def feed_all(self, blocks, timers) -> None:
        """Every block's tables, computed on the pool threads (blocks are
        independent) and summed here in input order."""
        for block, host in _iter_with(blocks, self.block_tables, timers):
            _count(timers, block)
            with timers.stage("compute"):
                self.fold_host(host)


def _config_key(opts, k: int, phred: int) -> str:
    """Checkpoint fingerprint, the string ``hpgq`` writes."""
    return json.dumps({
        "cmd": "cgr", "k": k, "phred": phred,
        "in": os.path.abspath(opts.in_filename),
        "in2": opts.in_filename2 and os.path.abspath(opts.in_filename2),
    }, sort_keys=True)


def run_cgr(opts: CgrOptions, timers: Optional[StageTimers] = None,
            device="cuda") -> dict:
    """The `cgr` command on ``device``; returns the tables, the word
    count, the PGM paths and, against a reference signature, the diff
    statistics."""
    dev = resolve_device(device)
    _warn_no_pallas(opts)  # --profile-dir is taken and writes no trace
    timers = timers or StageTimers()
    if opts.sharded:
        from ..dist.launch import run_sharded
        from ..dist.run_dist import run_cgr_sharded

        return run_sharded(run_cgr_sharded, opts, timers, dev)
    k = int(opts.k)
    phred = opts.quality_encoding_value
    sess = CgrSession(k, phred, _batch_reads(opts, dev), dev)

    ck_path = opts.checkpoint_path
    ck_every = opts.checkpoint_every or 50
    ck_key = _config_key(opts, k, phred) if ck_path else None
    start_input = start_offset = 0
    if ck_path:
        loaded = load_counters_checkpoint(ck_path, ck_key)
        if loaded:
            _, start_offset, extra = loaded
            sess.table_seq += extra["table_seq"]
            sess.table_q += extra["table_q"]
            sess.word_count += int(extra["words"])
            start_input = int(extra["input_idx"])

    inputs = [opts.in_filename]
    if opts.paired_end:
        inputs.append(opts.in_filename2)
    nb = 0
    for idx, path in enumerate(inputs):
        if idx < start_input:
            continue
        offset = start_offset if idx == start_input else 0
        with FastqReader(path, batch_size=_reader_batch(opts, dev),
                         start_offset=offset) as rd:
            if not ck_path:
                sess.feed_all(rd, timers)
                continue
            # a checkpoint holds the tables of every block up to its offset:
            # fold in order on this thread
            for block in _iter_blocks(rd, timers):
                with timers.stage("compute"):
                    sess.feed_block(block)
                nb += 1
                if nb % ck_every == 0:
                    with timers.stage("checkpoint"):
                        save_counters_checkpoint(
                            ck_path, None, block.end_offset, ck_key,
                            extra={"table_seq": sess.table_seq,
                                   "table_q": sess.table_q,
                                   "words": sess.word_count,
                                   "input_idx": idx})
    if ck_path and os.path.exists(ck_path):
        os.unlink(ck_path)
    return emit_cgr_outputs(opts, sess, timers)


def emit_cgr_outputs(opts: CgrOptions, sess, timers: StageTimers) -> dict:
    """The PGM, ``.gs`` and diff outputs of the accumulated tables (the
    reference's ``chaos_game_write_table_images``,
    ``old/chaos_game.c:407-465``)."""
    k = int(opts.k)
    out: dict = {"fq_word_count": sess.word_count, "pgm_files": []}
    base = os.path.join(
        opts.out_dirname,
        "%s%s%d" % (os.path.basename(opts.in_filename), CGR_K_VALUE_INFIX, k),
    )

    with timers.stage("reporting"):
        fq_norm = pgm.fq_norm_value(sess.word_count, k)
        fg = base + CGR_FASTQ_PGM_SUFFIX
        pgm.write_pgm(fg, sess.table_seq, k, fq_norm)
        out["pgm_files"].append(fg)

        qn = pgm.normalize_quality_table(sess.table_q, sess.table_seq, k)
        qq = base + CGR_QUALITY_PGM_SUFFIX
        pgm.write_pgm(qq, qn, k, 256.0 / CGR_MAX_QUALITY_IN_TABLE)
        out["pgm_files"].append(qq)

        if opts.write_gs:
            gs_path = base + ".gs"
            pgm.write_gs(gs_path, sess.table_seq, k, sess.word_count)
            out["gs_file"] = gs_path

        out["mean_dif"] = out["std_dif"] = None
        if opts.gs_filename:
            table_gs, _, ref_words = pgm.read_gs(opts.gs_filename, expect_k=k)
            dif, stats = pgm.diff_table(sess.table_seq, table_gs,
                                        sess.word_count, ref_words, k)
            dp = base + CGR_DIFF_PGM_SUFFIX
            pgm.write_pgm(dp, pgm.abs_clamp_diff(dif), k, 1.0)
            out["pgm_files"].append(dp)
            out["mean_dif"] = stats["mean"]
            out["std_dif"] = stats["std"]
            out["dif_stats"] = stats

    out["table_seq"] = sess.table_seq
    out["table_q"] = sess.table_q
    return out
