"""Sessions: length-bucket management and per-block device calls.

The port's ``StatsSession``, ``PairedStatsSession``, ``ShapeCachedFn`` and
``ShapeCachedPairFn`` (``hpgq/pipeline/session.py:43-504``).  Read
lengths are bucketed to multiples of 128 columns; a block longer than the
current bucket finishes the device accumulator and rebuilds it wider (the
host counters carry over, since merging is associative), which also moves
the batches from K1 to K2 once the bucket passes 4096.

With a pass's timers, a session times each growth (the ``grow`` stage on
the feeding thread: the fold of the device accumulator to the host and
the wider one's allocation) and counts the growths (``grow``) and, on the
packing thread, the bytes of each long-read (K2) block bound for the
device (``long-bytes``) and the share of them that lies past each read's
end (``long-pad-bytes``).

Rows: short-read blocks (L <= 4096, K1) are padded to
``bucket_rows``' 16,384-row buckets as in ``hpgq``.  A
long-read block (K2) goes to the device as its length classes
(:func:`long_parts`), each packed at its own width and padded only to a
multiple of :data:`PART_ROW_MULTIPLE` rows: those buckets exist to bound
XLA's compiled shapes, eager PyTorch has no shape cache, and a 16 MB block
of 10 kb reads holds only a few hundred reads, so 16,384 rows would be
mostly padding.  On the device each class is padded out to the session's
width (``unwire``), where the copy costs next to nothing.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading

import numpy as np
import torch

from ..core.counters import StatsCounters
from ..device import resolve_device
from ..io import native
from ..io.fastq import RecordBlock
from ..io.packer import (
    bucket_rows,
    pack_block,
    pack_block_wire,
    round_up,
    try_pack_block_2c,
    try_pack_block_2u,
    try_pack_block_palette,
    wire_len,
)

from ..core.accumulator import (
    DeviceAccumulator,
    fold_partials,
    resolve_wire,
    to_numpy,
)
from ..kernels.stats_cuda import MAX_LCAP
from ..kernels.stats_torch import zero_partials
from ..kernels.step import TIER_OF_QBITS, count_batch, make_paired_stats_step
from ..kernels.wire_torch import (
    bitwire_kind,
    bitwire_logical_len,
    wire_unbits,
    wire_unbits2c,
    wire_unqn8,
)
from ..utils.timers import NO_TIMERS

LONG_ROW_MULTIPLE = 64  # row padding of a long-read (K2) block
PART_ROW_MULTIPLE = 8  # row padding of one length class of a K2 block

# batches per (device type, wire tier) through ShapeCachedFn and
# ShapeCachedPairFn since the last reset, one per mate: shows where the
# filter verdict ran and which wire carried it
FN_BATCHES = collections.Counter()


def batch_rows(n: int, L: int, batch_reads: int) -> int:
    """Device rows for an ``n``-read block packed ``L`` columns wide."""
    if L > MAX_LCAP:
        return round_up(max(int(n), 1), LONG_ROW_MULTIPLE)
    return bucket_rows(n, batch_reads)


def pack_payload(block, L: int, rows: int, wire):
    """Host-pack one block for a stats step, ``rows`` rows: with the
    bitpack wire the 2u tuple ``("2u", buf, exc, pal, n_valid, Lu)`` or an
    adaptive bitpack buffer (a ``(buf, exc)`` pair for 2c) trimmed to the
    block's own length; else ``(codes, quals, lens, valid)`` ``L`` wide."""
    if wire == "bitpack":
        u = try_pack_block_2u(block, pad_reads_to=rows)
        if u is not None:
            return ("2u",) + u
        return pack_block_wire(block, "bitpack", wire_len(block.max_len(), L),
                               pad_reads_to=rows, allow6=True, allow2c=True)
    return pack_block(block, max_len=L, pad_reads_to=rows)


def payload_len(payload) -> int:
    """Logical columns of a :func:`pack_payload` result (host or device)."""
    if isinstance(payload, tuple) and isinstance(payload[0], str):
        return int(payload[5])
    if isinstance(payload, tuple) and len(payload) == 4:
        return payload[1].shape[1]
    buf = payload[0] if isinstance(payload, tuple) else payload
    return bitwire_logical_len(buf.shape[1])


def long_parts(block) -> list:
    """A block bound for K2 as its length classes, widest first: its reads
    in order of falling length, cut where the width rounded up to the next
    power of two times 128 changes, each class a RecordBlock over the
    block's buffer.  Packed each at its own width, most of a long block's
    columns past its reads' ends stay off the wire; the counters are sums
    over reads, so the order of the reads does not change them."""
    lens = block.seq_lens
    if lens.shape[0] == 0:
        return []
    order = np.argsort(-lens, kind="stable")
    cls = np.ceil(np.log2(np.maximum(lens[order], 1) / 128.0)).clip(0)
    cuts = np.flatnonzero(np.diff(cls)) + 1
    return [RecordBlock(block.buf, block.starts[idx], block.ends[idx],
                        block.base_offset)
            for idx in np.split(order, cuts)]


def _is_parts(payload) -> bool:
    """A long block's ``("parts", args, ...)``."""
    return (isinstance(payload, tuple) and len(payload) > 0
            and isinstance(payload[0], str) and payload[0] == "parts")


def _count_long(timers, block, L: int, rows: int, host) -> None:
    """Count a block bound for K2 (one of :func:`long_parts`, or a mate's
    block), packed ``L`` columns wide, into ``timers``: its host payload's
    bytes (``long-bytes``) and their share past each read's end, pad rows whole
    (``long-pad-bytes``: the bytes times the ``rows x L`` columns past the
    reads over all of them)."""
    parts = host if isinstance(host, tuple) else (host,)
    nbytes = sum(a.nbytes for a in parts if isinstance(a, np.ndarray))
    cells = rows * L
    bases = int(block.seq_lens.sum(dtype=np.int64))
    pad = nbytes * (cells - bases) // cells
    timers.count("long-bytes", nbytes)
    timers.count("long-pad-bytes", pad)


class StatsSession:
    """Streaming single-end stats accumulation with length growth."""

    def __init__(self, phred, crit=None, batch_reads=16384, device="cuda",
                 lcap: int = 128, wire="auto", kmers_on: bool = False,
                 timers=NO_TIMERS):
        self.phred = phred
        self.crit = crit
        self.batch_reads = batch_reads
        self.device = resolve_device(device)
        self.wire = wire
        self.kmers_on = kmers_on
        self.timers = timers
        self.acc = DeviceAccumulator(lcap, phred, crit, self.device, wire,
                                     kmers_on)

    @property
    def lcap(self):
        return self.acc.lcap

    def _grow(self, lcap: int):
        with self.timers.stage("grow"):
            old = self.acc.finish()
            self.acc = DeviceAccumulator(lcap, self.phred, self.crit,
                                         self.device, self.wire,
                                         self.kmers_on)
            self.acc.counters = old
            old.ensure_length(lcap)
        self.timers.count("grow", 1)

    def pack(self, block, batch_reads: int = 0):
        """Host-pack a RecordBlock into the ``feed_packed`` arguments as
        numpy arrays (:func:`pack_payload`).  Reads ``self.lcap`` once, so
        a pool thread may pack while the feeding thread grows the
        session.  A block bound for K2 goes as its length classes
        (:func:`long_parts`), each packed at its own width: one
        ``("parts", args, ...)`` argument, widest part first."""
        L = max(round_up(max(block.max_len(), 1), 128), self.lcap)
        if L > MAX_LCAP:
            return (("parts",) + tuple(self._pack_part(part)
                                       for part in long_parts(block)),)
        rows = batch_rows(block.num_reads, L, batch_reads or self.batch_reads)
        p = pack_payload(block, L, rows, self.acc.wire)
        return p if self.acc.wire is None else (p,)

    def _pack_part(self, part):
        L = round_up(max(part.max_len(), 1), 128)
        rows = round_up(part.num_reads, PART_ROW_MULTIPLE)
        p = pack_payload(part, L, rows, self.acc.wire)
        _count_long(self.timers, part, L, rows, p)
        return p if self.acc.wire is None else (p,)

    def feed_packed(self, codes, quals=None, lens=None, valid=None):
        """Feed one packed batch already on the session's device: a
        ``("2u", buf, exc, pal, n_valid, Lu)`` tuple, a bitpack buffer or
        2c ``(buf, exc)`` tuple, the four plain tensors, or a long block's
        ``("parts", args, ...)``, each part's ``args`` fed in turn."""
        if _is_parts(codes):
            for args in codes[1:]:
                self.feed_packed(*args)
            return
        payload = codes if quals is None else (codes, quals, lens, valid)
        L = payload_len(payload)
        if L > self.lcap:
            self._grow(round_up(L, 128))
        if isinstance(codes, tuple) and isinstance(codes[0], str):
            self.acc.update_uniform(codes[1:])
        else:
            self.acc.update(codes, quals, lens, valid)

    def finish(self):
        return self.acc.finish()

    def take(self):
        """The counters since the start or the last take, then zero ones
        (a sharded checkpoint's fold)."""
        return self.acc.take()


class PairedStatsSession:
    """Streaming paired-end stats: both mates' verdicts and partials in one
    step per batch (:func:`~hpgq_torch.kernels.step.make_paired_stats_step`).

    One length bucket covers both mates (they grow together); the two
    int64 device accumulators fold into two host counters at :meth:`flush`
    only, since int64 state needs no overflow window."""

    def __init__(self, phred, crit=None, batch_reads=16384, device="cuda",
                 lcap: int = 128, wire="auto", kmers_on: bool = False,
                 timers=NO_TIMERS):
        self.phred = phred
        self.crit = crit
        self.batch_reads = batch_reads
        self.device = resolve_device(device)
        self.wire = resolve_wire(wire, self.device)
        self.kmers_on = kmers_on
        self.timers = timers
        self._zero_counters()
        self._rebuild(lcap)

    def _zero_counters(self):
        self.counters1 = StatsCounters(phred=self.phred,
                                       kmers_on=self.kmers_on)
        self.counters2 = StatsCounters(phred=self.phred,
                                       kmers_on=self.kmers_on)

    def _rebuild(self, lcap: int):
        self.lcap = lcap
        for c in (self.counters1, self.counters2):
            c.ensure_length(lcap)
        self._step = make_paired_stats_step(lcap, self.phred, self.crit,
                                            self.kmers_on)
        self._acc1 = zero_partials(lcap, self.kmers_on, self.device)
        self._acc2 = zero_partials(lcap, self.kmers_on, self.device)
        self._dirty = False

    @property
    def num_passed(self) -> int:
        """Pairs that passed (folded into ``counters1``; read after
        :meth:`flush`)."""
        return self.counters1.num_passed

    @property
    def num_failed(self) -> int:
        return self.counters1.num_failed

    def pack_pair(self, b1, b2):
        """Host-pack a lockstep mate-block pair -> ``(in1, in2)`` for
        :meth:`feed_pair_packed`: both mates ``L = max(lmax, lcap)`` wide
        and padded to one row count, each on the narrowest tier it fits
        (the mates need not share one).  Reads ``self.lcap`` once, so a
        pool thread may pack while the feeding thread grows the session."""
        L = max(round_up(max(b1.max_len(), b2.max_len(), 1), 128), self.lcap)
        rows = batch_rows(max(b1.num_reads, b2.num_reads), L,
                          self.batch_reads)
        pair = (pack_payload(b1, L, rows, self.wire),
                pack_payload(b2, L, rows, self.wire))
        if L > MAX_LCAP:
            for b, p in zip((b1, b2), pair):
                _count_long(self.timers, b, L, rows, p)
        return pair

    def feed_pair_packed(self, in1, in2) -> None:
        """One step over a packed pair already on the device; never waits
        on the device."""
        L = max(payload_len(in1), payload_len(in2))
        if L > self.lcap:
            with self.timers.stage("grow"):
                self.flush()
                self._rebuild(round_up(L, 128))
            self.timers.count("grow", 1)
        self._acc1, self._acc2 = self._step(self._acc1, self._acc2, in1, in2)
        self._dirty = True

    def flush(self) -> None:
        if not self._dirty:
            return
        fold_partials(self.counters1, to_numpy(self._acc1))
        fold_partials(self.counters2, to_numpy(self._acc2))
        self._acc1 = zero_partials(self.lcap, self.kmers_on, self.device)
        self._acc2 = zero_partials(self.lcap, self.kmers_on, self.device)
        self._dirty = False

    def finish(self):
        self.flush()
        return self.counters1, self.counters2

    def take(self):
        """Both mates' counters since the start or the last take, then
        zero ones (a sharded checkpoint's fold)."""
        done = self.finish()
        self._zero_counters()
        for c in (self.counters1, self.counters2):
            c.ensure_length(self.lcap)
        return done


def to_device(packed: tuple, device, non_blocking: bool = False,
              keep: list = None, threads: int = 0) -> tuple:
    """Move a :meth:`StatsSession.pack` result to ``device`` as tensors
    (the tags of a 2u tuple and of a long block's parts, and the 2u tuple's
    ``n_valid`` and ``Lu``, stay host values).  For CUDA
    the host arrays go through pinned buffers, which are appended to
    ``keep`` when given, so a caller can hold them until the copy is done.
    An array reaches its pinned buffer on a native team of ``threads``
    (0: the calling thread's planned team), never on torch's own."""
    def put(a):
        t = torch.from_numpy(a)
        if device.type == "cuda":
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            native.copy_into(pinned.numpy(), a, threads)
            if keep is not None:
                keep.append(pinned)
            t = pinned.to(device, non_blocking=non_blocking)
        return t

    def move(x):
        if isinstance(x, tuple):
            if _is_parts(x):
                return (x[0],) + tuple(move(a) for a in x[1:])
            if x and isinstance(x[0], str):  # ("2u", buf, exc, pal, n, Lu)
                return (x[0],) + tuple(put(a) for a in x[1:4]) + x[4:]
            return tuple(move(a) for a in x)
        return put(x)

    return tuple(move(x) for x in packed)


def thread_stream(local: threading.local, device):
    """On a CUDA device, the calling thread's own stream (made once, kept
    in ``local``) as the current stream; a no-op context elsewhere."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    s = getattr(local, "stream", None)
    if s is None:
        s = local.stream = torch.cuda.Stream(device)
    return torch.cuda.stream(s)


class ShapeCachedFn:
    """``fn(block) -> numpy outputs[:n]`` around a device function
    ``fn(codes, quals, lens, valid)`` that returns a tensor or a tuple of
    tensors of one row per read (the filter verdict, edit's trims).

    The port of ``hpgq/pipeline/session.py:297-428``.  The name is kept so
    the counterpart is easy to find, but eager PyTorch has no shape cache:
    there is no jit cache here, and ``fn`` simply runs on the decoded
    tensors.  With the bitpack wire and ``qn_ok`` (the default wire on
    CUDA) each block goes over the narrowest layout that carries what the
    verdict reads: 2c, else the 2q palette, else qn8 (one byte per base);
    after :data:`_PAL_MISS_LIMIT` consecutive misses the first two are not
    tried again until one fits.  ``HPGQ_QN_WIRE=0`` falls back to the
    plain bitpack ladder (2q, 6-bit, 7-bit); with the wire off the four
    plain tensors go.

    Calls may come from several pool threads at once.  On CUDA each
    thread copies, runs ``fn`` and reads the result back on a stream of
    its own, so one thread's read-back waits only for its own work; the
    result is a finished host array."""

    _PAL_MISS_LIMIT = 3

    def __init__(self, fn, batch_reads: int, device="cuda",
                 qn_ok: bool = False):
        self._fn = fn
        self.batch_reads = batch_reads
        self.device = resolve_device(device)
        self.wire = resolve_wire(None, self.device)
        self._qn = qn_ok and os.environ.get("HPGQ_QN_WIRE", "1") != "0"
        self._pal_miss = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _pack(self, block, lmax: int, rows: int):
        """(tier, host payload) for one block."""
        if self.wire is None:
            return "plain", pack_block(block, max_len=lmax, pad_reads_to=rows)
        wl = wire_len(block.max_len(), lmax)
        if not self._qn:
            buf = pack_block_wire(block, "bitpack", wl, pad_reads_to=rows,
                                  allow6=True)
            return TIER_OF_QBITS[bitwire_kind(buf.shape[1])[0]], buf
        if self._pal_miss < self._PAL_MISS_LIMIT:
            out = try_pack_block_2c(block, wl, pad_reads_to=rows)
            if out is not None:
                tier = "2c"
            else:
                tier = "2q"
                out = try_pack_block_palette(block, wl, pad_reads_to=rows)
            with self._lock:
                self._pal_miss = 0 if out is not None else self._pal_miss + 1
            if out is not None:
                return tier, out
        return "qn8", pack_block_wire(block, "qn8", wl, pad_reads_to=rows)

    def _mate(self, block, lmax: int, rows: int, keep: list):
        """One block packed, on the device and decoded:
        ``(codes, quals, lens, valid)``."""
        tier, host = self._pack(block, lmax, rows)
        x = to_device((host,), self.device, non_blocking=True, keep=keep)[0]
        count_batch(FN_BATCHES, (self.device.type, tier))
        if tier == "plain":
            return x
        if tier == "qn8":
            return wire_unqn8(x)
        if tier == "2c":
            return wire_unbits2c(*x)
        return wire_unbits(x)

    def _run(self, blocks):
        n = blocks[0].num_reads
        lmax = round_up(max(max(b.max_len() for b in blocks), 1), 128)
        rows = batch_rows(n, lmax, self.batch_reads)
        keep = []  # pinned sources, alive until the read-back below
        with thread_stream(self._local, self.device):
            args = []
            for b in blocks:
                args += self._mate(b, lmax, rows, keep)
            out = self._fn(*args)
            if isinstance(out, tuple):
                return tuple(o.cpu().numpy()[:n] for o in out)
            return out.cpu().numpy()[:n]

    def __call__(self, block):
        return self._run((block,))


class ShapeCachedPairFn(ShapeCachedFn):
    """Both mates of a lockstep pair in one call:
    ``fn(c1, q1, l1, v1, c2, q2, l2, v2)`` (``hpgq/pipeline/session.py:
    431-504``).  The mates share the column bucket and the row count; each
    goes over the narrowest tier it fits on its own."""

    def __call__(self, b1, b2):
        return self._run((b1, b2))
