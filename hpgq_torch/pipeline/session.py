"""Sessions: length-bucket management and per-block device calls.

The port's ``StatsSession``, ``PairedStatsSession``, ``ShapeCachedFn`` and
``ShapeCachedPairFn`` (``hpgq/pipeline/session.py:43-504``).  Read
lengths are bucketed to multiples of 128 columns; a block longer than the
current bucket finishes the device accumulator and rebuilds it wider (the
host counters carry over, since merging is associative), which also moves
the batches from K1 to K2 once the bucket passes 4096.

Rows: short-read blocks (L <= 4096, K1) are padded to
``bucket_rows``' 16,384-row buckets as in ``hpgq``.  A
long-read block (K2) is padded only to a multiple of
:data:`LONG_ROW_MULTIPLE`: those buckets exist to bound XLA's compiled
shapes, eager PyTorch has no shape cache, and a 16 MB block of 10 kb reads
holds only a few hundred reads, so 16,384 rows would be mostly padding.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading

import torch

from ..core.counters import StatsCounters
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

LONG_ROW_MULTIPLE = 64  # row padding of a long-read (K2) block

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


class StatsSession:
    """Streaming single-end stats accumulation with length growth."""

    def __init__(self, phred, crit=None, batch_reads=16384, device="cpu",
                 lcap: int = 128, wire="auto", kmers_on: bool = False):
        self.phred = phred
        self.crit = crit
        self.batch_reads = batch_reads
        self.device = torch.device(device)
        self.wire = wire
        self.kmers_on = kmers_on
        self.acc = DeviceAccumulator(lcap, phred, crit, self.device, wire,
                                     kmers_on)

    @property
    def lcap(self):
        return self.acc.lcap

    def _grow(self, lcap: int):
        old = self.acc.finish()
        self.acc = DeviceAccumulator(lcap, self.phred, self.crit, self.device,
                                     self.wire, self.kmers_on)
        self.acc.counters = old
        old.ensure_length(lcap)

    def pack(self, block, batch_reads: int = 0):
        """Host-pack a RecordBlock into the ``feed_packed`` arguments as
        numpy arrays (:func:`pack_payload`).  Reads ``self.lcap`` once, so
        a pool thread may pack while the feeding thread grows the
        session."""
        L = max(round_up(max(block.max_len(), 1), 128), self.lcap)
        rows = batch_rows(block.num_reads, L, batch_reads or self.batch_reads)
        p = pack_payload(block, L, rows, self.acc.wire)
        return p if self.acc.wire is None else (p,)

    def feed_packed(self, codes, quals=None, lens=None, valid=None):
        """Feed one packed batch already on the session's device: a
        ``("2u", buf, exc, pal, n_valid, Lu)`` tuple, a bitpack buffer or
        2c ``(buf, exc)`` tuple, or the four plain tensors."""
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


class PairedStatsSession:
    """Streaming paired-end stats: both mates' verdicts and partials in one
    step per batch (:func:`~hpgq_torch.kernels.step.make_paired_stats_step`).

    One length bucket covers both mates (they grow together); the two
    int64 device accumulators fold into two host counters at :meth:`flush`
    only, since int64 state needs no overflow window."""

    def __init__(self, phred, crit=None, batch_reads=16384, device="cpu",
                 lcap: int = 128, wire="auto", kmers_on: bool = False):
        self.phred = phred
        self.crit = crit
        self.batch_reads = batch_reads
        self.device = torch.device(device)
        self.wire = resolve_wire(wire, self.device)
        self.kmers_on = kmers_on
        self.counters1 = StatsCounters(phred=phred, kmers_on=kmers_on)
        self.counters2 = StatsCounters(phred=phred, kmers_on=kmers_on)
        self._rebuild(lcap)

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
        return (pack_payload(b1, L, rows, self.wire),
                pack_payload(b2, L, rows, self.wire))

    def feed_pair_packed(self, in1, in2) -> None:
        """One step over a packed pair already on the device; never waits
        on the device."""
        L = max(payload_len(in1), payload_len(in2))
        if L > self.lcap:
            self.flush()
            self._rebuild(round_up(L, 128))
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


def to_device(packed: tuple, device, non_blocking: bool = False,
              keep: list = None) -> tuple:
    """Move a :meth:`StatsSession.pack` result to ``device`` as tensors
    (the 2u tuple's tag, ``n_valid`` and ``Lu`` stay host ints).  For CUDA
    the host arrays go through pinned buffers, which are appended to
    ``keep`` when given, so a caller can hold them until the copy is done."""
    def put(a):
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory()
            if keep is not None:
                keep.append(t)
            t = t.to(device, non_blocking=non_blocking)
        return t

    def move(x):
        if isinstance(x, tuple):
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

    def __init__(self, fn, batch_reads: int, device="cpu",
                 qn_ok: bool = False):
        self._fn = fn
        self.batch_reads = batch_reads
        self.device = torch.device(device)
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
