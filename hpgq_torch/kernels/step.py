"""Per-batch stats steps: wire decode -> pad -> K1/K2 partials -> merge.

A 2u batch on CUDA skips the decode: K1's 2u entry reads the wire itself
(:func:`~hpgq_torch.kernels.stats_cuda.batch_partials_2u`), unless a
decoded tensor is needed anyway (``--kmers``, a paired filter's pair
verdict, or a session grown past K1's 4096 columns, where K2 runs).

Torch counterparts of ``stats_jnp.make_stats_step`` (plain and bitpack
wires), ``make_stats_step2u``, ``make_paired_stats_step`` and
``make_paired_stats_step2u`` (``stats_jnp.py:732-798``, ``:816-1022``).
A step updates the accumulator dicts in place and returns them; nothing in
it waits on the device.  PyTorch runs eagerly, so there is no jit cache,
and the 2u wire's uniform length travels with the batch instead of being
baked into a compiled step.
"""

from __future__ import annotations

import collections
import threading

from .stats_cuda import MAX_LCAP, batch_partials_2u, make_batch_partials
from .stats_torch import merge_into, verdicts
from .wire_torch import (
    bitwire_kind,
    pad_wire_cols,
    wire_unbits,
    wire_unbits2c,
    wire_unbits2u,
)

# batches per wire tier since the last reset ("2u", "2c", "2q", "6bit",
# "7bit", "plain"), one per mate on the paired path — lets a run show
# which decoders carried it
WIRE_BATCHES = collections.Counter()
# batches decoded into codes/quals tensors since the last reset, by
# (device type, tier): shows that a 2u batch on CUDA went to K1 undecoded
DECODED = collections.Counter()
_count_lock = threading.Lock()
TIER_OF_QBITS = {2: "2q", 6: "6bit", 7: "7bit"}


def count_batch(counter, key) -> None:
    """``counter[key] += 1`` under one lock shared by every batch counter
    (shard and pool threads update them concurrently)."""
    with _count_lock:
        counter[key] += 1


def unwire(payload, lcap: int):
    """One packed batch on the device -> ``(codes, quals, lens, valid)``
    padded to ``lcap`` columns, counting its tier in :data:`WIRE_BATCHES`.

    ``payload`` is a ``("2u", buf, exc, pal, n_valid, L)`` tuple, a 2c
    ``(buf, exc)`` pair, a 7-bit/6-bit/2q bitpack buffer, or the four plain
    tensors (which the session packs at least ``lcap`` wide, or narrower
    only when the session grew after packing; the kernels take L <= lcap)."""
    if isinstance(payload, tuple) and len(payload) == 4:
        count_batch(WIRE_BATCHES, "plain")
        return payload
    if _is_2u(payload):
        _, buf, exc, pal, n_valid, L = payload
        tier = "2u"
        codes, quals, lens, valid = wire_unbits2u(buf, exc, pal, n_valid, L=L)
    elif isinstance(payload, tuple):
        tier = "2c"
        codes, quals, lens, valid = wire_unbits2c(*payload)
    else:
        tier = TIER_OF_QBITS[bitwire_kind(payload.shape[1])[0]]
        codes, quals, lens, valid = wire_unbits(payload)
    count_batch(WIRE_BATCHES, tier)
    count_batch(DECODED, (codes.device.type, tier))
    codes, quals = pad_wire_cols(codes, quals, lcap)
    return codes, quals, lens, valid


def _is_2u(payload) -> bool:
    return isinstance(payload, tuple) and isinstance(payload[0], str)


def _merge(acc, p):
    np_ = p.pop("_num_passed", None)
    nf = p.pop("_num_failed", None)
    p.pop("_passed_mask")
    merge_into(acc, p)
    if np_ is not None:  # the inline-filter tallies (stats_jnp.py:877-885)
        acc["num_passed"] += np_
        acc["num_failed"] += nf
    return acc


def make_stats_step(lcap: int, phred: int, crit=None, wire=None,
                    kmers_on: bool = False):
    """``step(acc, codes, quals, lens, valid)``, or with ``wire='bitpack'``
    ``step(acc, buf, exc=None)`` where ``exc`` is the 2c tier's sidecar.
    With ``kmers_on`` the accumulator must carry the k-mer fields."""
    if wire not in (None, "bitpack"):
        raise ValueError("unknown wire %r (valid: bitpack, None)" % (wire,))
    pfn = make_batch_partials(lcap, phred, crit, kmers_on)

    if wire is None:
        def step(acc, codes, quals, lens, valid):
            return _merge(acc, pfn(*unwire((codes, quals, lens, valid),
                                           lcap)))

        return step

    def step_wire(acc, buf, exc=None):
        return _merge(acc, pfn(*unwire(buf if exc is None else (buf, exc),
                                       lcap)))

    return step_wire


def make_stats_step2u(lcap: int, phred: int, crit, L: int,
                      kmers_on: bool = False):
    """``step(acc, buf, exc, pal, n_valid)`` over the 2u (uniform) wire;
    ``L`` is the uniform read length, which the wire width cannot carry.
    The batch goes to :func:`batch_partials_2u` undecoded, unless the
    k-mer pass (which reads codes) is on or ``lcap`` is past K1's limit
    (K2 takes decoded tensors): then it is decoded first."""
    if kmers_on or lcap > MAX_LCAP:
        pfn = make_batch_partials(lcap, phred, crit, kmers_on)

        def step_kmers(acc, buf, exc, pal, n_valid):
            return _merge(acc, pfn(*unwire(("2u", buf, exc, pal, n_valid, L),
                                           lcap)))

        return step_kmers

    def step(acc, buf, exc, pal, n_valid):
        count_batch(WIRE_BATCHES, "2u")
        return _merge(acc, batch_partials_2u(buf, exc, pal, n_valid, L, lcap,
                                             phred, crit))

    return step


def make_paired_stats_step(lcap: int, phred: int, crit=None,
                           kmers_on: bool = False):
    """``step(acc1, acc2, in1, in2)`` over both mates of a paired batch;
    ``inN`` is any :func:`unwire` payload, and the mates may come in on
    different tiers and lengths (the 2u payload carries its own ``L``).

    The pair counts when both mates are valid and, with ``crit``, both
    pass; K1/K2 (or the twin) then run with criteria off and that
    selection as ``valid`` on each mate, and the per-pair passed/failed
    tallies fold into ``acc1``.  With no filter and no k-mers, two 2u
    mates go to :func:`batch_partials_2u` undecoded (within K1's lcap):
    their pair selection is the first ``min(n_valid1, n_valid2)`` rows."""
    pfn = make_batch_partials(lcap, phred, None, kmers_on)
    undecoded = crit is None and not kmers_on and lcap <= MAX_LCAP

    def step(acc1, acc2, in1, in2):
        if undecoded and _is_2u(in1) and _is_2u(in2):
            n = min(in1[4], in2[4])
            for acc, (_, buf, exc, pal, _, L) in ((acc1, in1), (acc2, in2)):
                count_batch(WIRE_BATCHES, "2u")
                _merge(acc, batch_partials_2u(buf, exc, pal, n, L, lcap,
                                              phred))
            return acc1, acc2
        c1, q1, l1, v1 = unwire(in1, lcap)
        c2, q2, l2, v2 = unwire(in2, lcap)
        pair = v1 & v2
        sel = pair
        if crit is not None:
            ok = (verdicts(c1, q1, l1, crit, phred)
                  & verdicts(c2, q2, l2, crit, phred))
            sel = pair & ok
            acc1["num_passed"] += sel.sum()
            acc1["num_failed"] += (pair & ~ok).sum()
        _merge(acc1, pfn(c1, q1, l1, sel))
        _merge(acc2, pfn(c2, q2, l2, sel))
        return acc1, acc2

    return step
