"""Device-side stats accumulation with a host fold at the end.

The port's counterpart of ``hpgq.core.accumulator``.  The device state is
int64 (CUDA has 64-bit integer atomics), so no counter can overflow within
a run and the int32 flush windows of ``safe_flush_every`` are gone: the
accumulator folds into the int64 host :class:`StatsCounters` only at
:meth:`DeviceAccumulator.finish` and at checkpoints.  Nothing in
:meth:`~DeviceAccumulator.update` waits on the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.counters import StatsCounters
from ..device import resolve_device

from ..kernels.stats_torch import MIN_LENGTH_INIT, zero_partials
from ..kernels.step import make_stats_step, make_stats_step2u, step_ragged


def resolve_wire(wire=None, device="cuda"):
    """'bitpack' | None.  Precedence: an explicit format, then the
    ``HPGQ_WIRE`` environment variable (bitpack|off), then the device
    default: bitpack on CUDA (fewest bytes over the host link), plain
    tensors on the CPU.  Only the device's type is read: no tensor is
    made.  The JAX package's ``fused4``/``pack4`` wires are not
    ported."""
    w = wire
    if w in (None, "auto"):
        w = os.environ.get("HPGQ_WIRE", "auto")
    if w == "auto":
        return "bitpack" if torch.device(device).type == "cuda" else None
    if w in ("off", "none", ""):
        return None
    if w != "bitpack":
        raise ValueError("unknown wire format %r (valid: bitpack, off)" % w)
    return w


def from_jax_partials(host: dict, device) -> dict:
    """A JAX accumulator's partials (``stats_jnp.zero_partials`` layout, as
    numpy arrays) -> the port's accumulator dict on ``device``: the f32
    ``acc_quality`` less its Kahan term ``acc_quality_comp`` becomes the
    port's float64 carry."""
    out = {k: torch.tensor(np.asarray(v), device=device,  # always a copy
                           dtype=torch.int64)
           for k, v in host.items()
           if k not in ("acc_quality", "acc_quality_comp")}
    out["acc_quality"] = torch.tensor(
        float(np.float64(host["acc_quality"])
              - np.float64(host["acc_quality_comp"])),
        dtype=torch.float64, device=device)
    return out


def from_jax_cgr_acc(host: dict, device) -> dict:
    """A JAX CGR accumulator (``cgr.zero_cgr_acc`` layout: ``table_seq``,
    the quality table as ``table_q_hi``/``table_q_lo`` int32 limbs worth
    ``hi * 2^16 + lo``, ``words``, as numpy arrays) -> the port's int64
    accumulator (``cgr_torch.zero_cgr_acc`` layout) on ``device``."""
    tq = ((np.asarray(host["table_q_hi"], dtype=np.int64) << 16)
          + np.asarray(host["table_q_lo"], dtype=np.int64))
    return {k: torch.tensor(v, dtype=torch.int64, device=device)
            for k, v in (("table_seq", np.asarray(host["table_seq"])),
                         ("table_q", tq),
                         ("words", np.asarray(host["words"])))}


def to_numpy(acc: dict) -> dict:
    """The accumulator dict as host numpy arrays (one device sync)."""
    return {k: v.cpu().numpy() for k, v in acc.items()}


def fold_partials(c: StatsCounters, host: dict) -> None:
    """Fold a host copy of the partials into int64 counters (the jax-free
    twin of ``hpgq.core.accumulator.fold_partials``, ``:160-190``), the
    k-mer fields included when the partials carry them."""
    c.ensure_length(len(np.asarray(host["cov_per_nt"])))
    c.num_reads += int(host["num_reads"])
    c.num_passed += int(host.get("num_passed", 0))
    c.num_failed += int(host.get("num_failed", 0))
    c.acc_length += int(host["acc_length"])
    ml = int(host["min_length"])
    if ml != MIN_LENGTH_INIT:  # INIT sentinel = no valid read folded
        c.min_length = min(c.min_length, ml)
    c.max_length = max(c.max_length, int(host["max_length"]))
    c.acc_quality += float(host["acc_quality"])
    bt = np.asarray(host["base_totals"], dtype=np.int64)
    c.num_As += int(bt[0])
    c.num_Cs += int(bt[1])
    c.num_Gs += int(bt[2])
    c.num_Ts += int(bt[3])
    c.num_Ns += int(bt[4])
    lh = np.asarray(host["length_hist"], dtype=np.int64)
    c.length_hist[: lh.shape[0]] += lh
    c.quality_hist += np.asarray(host["quality_hist"], dtype=np.int64)
    c.gc_hist += np.asarray(host["gc_hist"], dtype=np.int64)
    lcap = np.asarray(host["cov_per_nt"]).shape[0]
    c.count_quality_per_nt[:lcap] += np.asarray(host["cov_per_nt"],
                                                dtype=np.int64)
    c.acc_quality_per_nt[:lcap] += np.asarray(host["qual_per_nt"],
                                              dtype=np.int64)
    c.base_per_nt[:, :lcap] += np.asarray(host["base_per_nt"], dtype=np.int64)
    if "kmer_counts" in host:
        c.kmer_counts += np.asarray(host["kmer_counts"], dtype=np.int64)
        c.kmer_counts_by_pos[:, :lcap] += np.asarray(host["kmer_per_nt"],
                                                     dtype=np.int64)


class DeviceAccumulator:
    """Streaming stats accumulator: device steps + a host fold at flush."""

    def __init__(self, lcap: int, phred: int, crit=None, device="cuda",
                 wire="auto", kmers_on: bool = False):
        self.lcap = lcap
        self.phred = phred
        self.device = resolve_device(device)
        self._crit = crit
        self.kmers_on = kmers_on
        self.counters = self._zero_counters()
        self.wire = resolve_wire(wire, self.device)
        self._step = make_stats_step(lcap, phred, crit, wire=self.wire,
                                     kmers_on=kmers_on)
        self.acc = zero_partials(lcap, kmers_on, self.device)
        self._dirty = False

    def update(self, codes, quals=None, lens=None, valid=None) -> None:
        """Feed one batch: the four packed tensors, or with the bitpack
        wire a single buffer (a ``(buf, exc)`` tuple for the 2c tier)."""
        if self.wire == "bitpack" and quals is None:
            args = codes if isinstance(codes, tuple) else (codes,)
            self.acc = self._step(self.acc, *args)
        elif self.wire == "bitpack":
            raise ValueError("the bitpack accumulator takes wire buffers")
        else:
            self.acc = self._step(self.acc, codes, quals, lens, valid)
        self._dirty = True

    def update_uniform(self, payload) -> None:
        """Feed one 2u batch: ``(buf, exc, pal, n_valid, Lu)``."""
        buf, exc, pal, n_valid, Lu = payload
        step = make_stats_step2u(self.lcap, self.phred, self._crit, Lu,
                                 self.kmers_on)
        self.acc = step(self.acc, buf, exc, pal, n_valid)
        self._dirty = True

    def update_ragged(self, buf, rows: int, L: int) -> None:
        """Feed one long block's ragged 6-bit wire (``rows`` rows, the
        longest ``L <= lcap`` columns; no k-mer fields)."""
        if self.kmers_on:
            raise ValueError("a ragged wire carries no k-mer partials")
        self.acc = step_ragged(self.acc, buf, rows, L, self.lcap, self.phred,
                               self._crit)
        self._dirty = True

    def flush(self) -> None:
        """Fold the device state into the host counters and zero it."""
        if not self._dirty:
            return
        fold_partials(self.counters, to_numpy(self.acc))
        self.acc = zero_partials(self.lcap, self.kmers_on, self.device)
        self._dirty = False

    def finish(self) -> StatsCounters:
        self.flush()
        return self.counters

    def take(self) -> StatsCounters:
        """The counters of every batch fed since the start or the last
        take; the accumulator then starts again from zero."""
        done = self.finish()
        self.counters = self._zero_counters()
        return done

    def _zero_counters(self) -> StatsCounters:
        c = StatsCounters(phred=self.phred, kmers_on=self.kmers_on)
        c.filter_on = self._crit is not None
        c.ensure_length(self.lcap)
        return c
