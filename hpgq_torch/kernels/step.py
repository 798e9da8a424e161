"""Per-batch stats steps: wire decode -> pad -> K1/K2 partials -> merge.

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

from .stats_cuda import make_batch_partials
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
    if isinstance(payload, tuple) and isinstance(payload[0], str):
        _, buf, exc, pal, n_valid, L = payload
        count_batch(WIRE_BATCHES, "2u")
        codes, quals, lens, valid = wire_unbits2u(buf, exc, pal, n_valid, L=L)
    elif isinstance(payload, tuple):
        count_batch(WIRE_BATCHES, "2c")
        codes, quals, lens, valid = wire_unbits2c(*payload)
    else:
        count_batch(WIRE_BATCHES,
                    TIER_OF_QBITS[bitwire_kind(payload.shape[1])[0]])
        codes, quals, lens, valid = wire_unbits(payload)
    codes, quals = pad_wire_cols(codes, quals, lcap)
    return codes, quals, lens, valid


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
    ``L`` is the uniform read length, which the wire width cannot carry."""
    pfn = make_batch_partials(lcap, phred, crit, kmers_on)

    def step(acc, buf, exc, pal, n_valid):
        return _merge(acc, pfn(*unwire(("2u", buf, exc, pal, n_valid, L),
                                       lcap)))

    return step


def make_paired_stats_step(lcap: int, phred: int, crit=None,
                           kmers_on: bool = False):
    """``step(acc1, acc2, in1, in2)`` over both mates of a paired batch;
    ``inN`` is any :func:`unwire` payload, and the mates may come in on
    different tiers and lengths (the 2u payload carries its own ``L``).

    The pair counts when both mates are valid and, with ``crit``, both
    pass; K1/K2 (or the twin) then run with criteria off and that
    selection as ``valid`` on each mate, and the per-pair passed/failed
    tallies fold into ``acc1``."""
    pfn = make_batch_partials(lcap, phred, None, kmers_on)

    def step(acc1, acc2, in1, in2):
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
