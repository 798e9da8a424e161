"""Per-batch stats steps: wire decode -> pad -> K1 partials -> merge.

Torch counterparts of ``stats_jnp.make_stats_step`` (plain and bitpack
wires) and ``make_stats_step2u`` (``stats_jnp.py:732-761``, ``:816-924``).
A step updates the accumulator dict in place and returns it; nothing in it
waits on the device.  PyTorch runs eagerly, so there is no jit cache.
"""

from __future__ import annotations

import collections
import threading

from .stats_cuda import make_batch_partials
from .stats_torch import merge_into
from .wire_torch import (
    bitwire_kind,
    pad_wire_cols,
    wire_unbits,
    wire_unbits2c,
    wire_unbits2u,
)

# batches per wire tier since the last reset ("2u", "2c", "2q", "6bit",
# "7bit", "plain") — lets a run show which decoders carried it
WIRE_BATCHES = collections.Counter()
_tier_lock = threading.Lock()
_TIER_OF_QBITS = {2: "2q", 6: "6bit", 7: "7bit"}


def _count_tier(tier: str) -> None:
    with _tier_lock:
        WIRE_BATCHES[tier] += 1


def _merge(acc, p):
    np_ = p.pop("_num_passed", None)
    nf = p.pop("_num_failed", None)
    p.pop("_passed_mask")
    merge_into(acc, p)
    if np_ is not None:  # the inline-filter tallies (stats_jnp.py:877-885)
        acc["num_passed"] += np_
        acc["num_failed"] += nf
    return acc


def _apply_partials(lcap: int, phred: int, crit):
    pfn = make_batch_partials(lcap, phred, crit)

    def apply(acc, codes, quals, lens, valid):
        return _merge(acc, pfn(codes, quals, lens, valid))

    return apply


def make_stats_step(lcap: int, phred: int, crit=None, wire=None):
    """``step(acc, codes, quals, lens, valid)``, or with ``wire='bitpack'``
    ``step(acc, buf, exc=None)`` where ``exc`` is the 2c tier's sidecar."""
    apply = _apply_partials(lcap, phred, crit)
    if wire is None:
        def step(acc, codes, quals, lens, valid):
            _count_tier("plain")
            return apply(acc, codes, quals, lens, valid)

        return step
    if wire != "bitpack":
        raise ValueError("unknown wire %r (valid: bitpack, None)" % (wire,))

    def step_wire(acc, buf, exc=None):
        if exc is None:
            codes, quals, lens, valid = wire_unbits(buf)
            _count_tier(_TIER_OF_QBITS[bitwire_kind(buf.shape[1])[0]])
        else:
            _count_tier("2c")
            codes, quals, lens, valid = wire_unbits2c(buf, exc)
        codes, quals = pad_wire_cols(codes, quals, lcap)
        return apply(acc, codes, quals, lens, valid)

    return step_wire


def make_stats_step2u(lcap: int, phred: int, crit, L: int):
    """``step(acc, buf, exc, pal, n_valid)`` over the 2u (uniform) wire;
    ``L`` is the uniform read length, which the wire width cannot carry."""
    apply = _apply_partials(lcap, phred, crit)

    def step(acc, buf, exc, pal, n_valid):
        _count_tier("2u")
        codes, quals, lens, valid = wire_unbits2u(buf, exc, pal, n_valid, L=L)
        codes, quals = pad_wire_cols(codes, quals, lcap)
        return apply(acc, codes, quals, lens, valid)

    return step
