"""Stats session: length-bucket management for the streaming pipeline.

The port's ``StatsSession`` (``hpgq/pipeline/session.py:43-128``).  Read
lengths are bucketed to multiples of 128 columns; a block longer than the
current bucket finishes the device accumulator and rebuilds it wider (the
host counters carry over, since merging is associative), which also moves
the batches from K1 to K2 once the bucket passes 4096.

Rows: short-read blocks (L <= 4096, K1) are padded to
``hpgq.io.packer.bucket_rows``' 16,384-row buckets as in ``hpgq``.  A
long-read block (K2) is padded only to a multiple of
:data:`LONG_ROW_MULTIPLE`: those buckets exist to bound XLA's compiled
shapes, eager PyTorch has no shape cache, and a 16 MB block of 10 kb reads
holds only a few hundred reads, so 16,384 rows would be mostly padding.
"""

from __future__ import annotations

import torch

from hpgq.io.packer import bucket_rows, pack_block, round_up, wire_len

from ..core.accumulator import DeviceAccumulator
from ..kernels.stats_cuda import MAX_LCAP
from ..kernels.wire_torch import bitwire_logical_len

LONG_ROW_MULTIPLE = 64  # row padding of a long-read (K2) block


def batch_rows(n: int, L: int, batch_reads: int) -> int:
    """Device rows for an ``n``-read block packed ``L`` columns wide."""
    if L > MAX_LCAP:
        return round_up(max(int(n), 1), LONG_ROW_MULTIPLE)
    return bucket_rows(n, batch_reads)


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
        numpy arrays: the 2u tuple, a bitpack buffer (or 2c ``(buf, exc)``),
        or ``(codes, quals, lens, valid)``.  Reads ``self.lcap`` once, so a
        pool thread may pack while the feeding thread grows the session."""
        L = max(round_up(max(block.max_len(), 1), 128), self.lcap)
        rows = batch_rows(block.num_reads, L, batch_reads or self.batch_reads)
        if self.acc.wire == "bitpack":
            from hpgq.io.packer import pack_block_wire, try_pack_block_2u

            u = try_pack_block_2u(block, pad_reads_to=rows)
            if u is not None:
                return (("2u",) + u,)
            return (pack_block_wire(block, "bitpack",
                                    wire_len(block.max_len(), L),
                                    pad_reads_to=rows, allow6=True,
                                    allow2c=True),)
        return pack_block(block, max_len=L, pad_reads_to=rows)

    def feed_packed(self, codes, quals=None, lens=None, valid=None):
        """Feed one packed batch already on the session's device: a
        ``("2u", buf, exc, pal, n_valid, Lu)`` tuple, a bitpack buffer or
        2c ``(buf, exc)`` tuple, or the four plain tensors."""
        if isinstance(codes, tuple) and codes and isinstance(codes[0], str):
            _, buf, exc, pal, n_valid, Lu = codes
            if Lu > self.lcap:
                self._grow(round_up(Lu, 128))
            self.acc.update_uniform((buf, exc, pal, n_valid, Lu))
            return
        if quals is None:
            W = (codes[0] if isinstance(codes, tuple) else codes).shape[1]
            L = bitwire_logical_len(W)
        else:
            L = quals.shape[1]
        if L > self.lcap:
            self._grow(round_up(L, 128))
        self.acc.update(codes, quals, lens, valid)

    def finish(self):
        return self.acc.finish()


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
