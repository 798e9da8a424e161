"""The port's own copy of ``hpgq/io/packer.py`` (the port imports nothing of
``hpgq``); without the fused4
wire, which the port does not carry.  Every other layout is bit for bit
the same as ``hpgq``'s.

Record-block → padded tensor packer.

Turns a :class:`~hpgq_torch.io.fastq.RecordBlock` into the engine's batch layout:

* ``codes`` int8 ``[N, L]`` — base codes (A=0 C=1 G=2 T=3 N=4 other=5,
  case-insensitive, LUT semantics from ``old/chaos_game.c:51-72``), padded
  with ``BASE_OTHER`` beyond each read's length.
* ``quals`` uint8 ``[N, L]`` — raw ASCII quality bytes (offset *included*,
  matching the reference's raw accumulation, ``src/stats_fastq.c:353-355``),
  zero-padded.
* ``lens`` int32 ``[N]``.

Fully vectorized numpy (one fancy-gather per field); a native C++ packer can
replace this transparently (see ``hpgq_torch/io/native``).
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import BASE_A, BASE_C, BASE_G, BASE_N, BASE_OTHER, BASE_T


def set_num_threads(n: int) -> None:
    """Threads of each native pack and index call (the CLI's
    --num-threads; the reference's worker-pool size,
    src/stats_options.c:271); 0 = the plan of the host's cores
    (:func:`hpgq_torch.io.native.plan`)."""
    from . import native

    native.set_num_threads(n)


BASE_LUT = np.full(256, BASE_OTHER, dtype=np.int8)
for ch, code in (
    ("A", BASE_A), ("a", BASE_A),
    ("C", BASE_C), ("c", BASE_C),
    ("G", BASE_G), ("g", BASE_G),
    ("T", BASE_T), ("t", BASE_T),
    ("N", BASE_N), ("n", BASE_N),
):
    BASE_LUT[ord(ch)] = code
if os.environ.get("HPGQ_STRICT_CASE"):
    # strict-compat toggle for deviation [D6] (oracle/spec.py): the
    # reference's observable per-position consumer counts only the
    # UPPERCASE letters (src/stats_fastq.c:360-372); lowercase soft-masked
    # bases then count toward length but no base bin.  See PARITY.md.
    for ch in "acgtn":
        BASE_LUT[ord(ch)] = BASE_OTHER


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_rows(n: int, cap: int) -> int:
    """Device row count for an ``n``-read block: round up to 16384-row
    buckets, capped at the configured batch.  Streaming blocks are
    chunk-bound (16 MB of FASTQ ≈ 64k 100-bp reads) and often far below
    ``--device-batch-reads`` — padding every dispatch to the full cap would
    ship ~2x the necessary H2D bytes on the link-bound path.  Bucketing
    bounds the number of distinct compiled shapes to cap/16384 (typically
    1-2 per run; jit caches per shape)."""
    if cap <= 0:
        return max(int(n), 1)
    return min(int(cap), round_up(max(int(n), 1), 16384))


def wire_len(max_len: int, lcap: int) -> int:
    """Wire-buffer length dimension for a block whose longest read is
    ``max_len``, under a device cap of ``lcap`` (128-lane rounded).

    The device tensors stay ``[B, lcap]`` (the step pads decoded columns
    on device — free relative to the link), but the WIRE only needs
    ``max_len`` columns: 100 bp reads under lcap=128 otherwise ship 28
    all-padding columns per read (~17% of the bitpack row).  Rounded to
    ``max(8, lcap // 16)`` so the distinct wire shapes per lcap stay ≤16
    (bitpack needs L % 8 == 0; jit compiles per shape).  Long-read caps
    (> 1024) keep the full width — the blockwise-L kernel chunks the wire
    per L-block and the relative saving is negligible there."""
    if lcap > 1024:
        return lcap
    g = max(8, lcap // 16)
    return min(lcap, round_up(max(int(max_len), 1), g))


def _pack_wire_dispatch(block, max_len: int, pad_reads_to: int,
                        native_name: str, np_wire_fn) -> np.ndarray:
    """Shared native-or-numpy dispatch for the single-pass wire packers:
    one OpenMP pass from the chunk bytes to the transfer buffer when the
    native library is available, else ``pack_block`` + the named numpy
    wire builder (the differential oracle, tests/test_native.py)."""
    n = block.num_reads
    L = int(max_len)
    nrows = max(int(pad_reads_to), n) if pad_reads_to else n

    from . import native

    if n and native.available():
        return getattr(native, native_name)(
            block.arr, block.starts[:, 1], block.starts[:, 3],
            block.seq_lens, L, nrows,
        )
    return np_wire_fn(*pack_block(block, max_len=L, pad_reads_to=nrows))


def _bitpack_np(vals: np.ndarray, nbits: int) -> np.ndarray:
    """[N, L] small-int values -> little-endian bitstream [N, nbits*L/8]
    (value LSB first; matches hpgq_pack_bitwire's register order)."""
    n, L = vals.shape
    bits = (vals[:, :, None].astype(np.uint8) >> np.arange(nbits)) & 1
    return np.packbits(bits.reshape(n, L * nbits), axis=1, bitorder="little")


def wire_bitpack_np(codes, quals, lens, valid) -> np.ndarray:
    """Numpy reference of the bitpack wire: rows
    [codes3 | quals7 | len_le32 | valid | pad3] (see hpgq_pack_bitwire).
    Differential oracle for the native packer and the engine-feed fallback
    when packed arrays (not a RecordBlock) are supplied."""
    B, L = np.asarray(quals).shape
    assert L % 8 == 0, L
    c = np.where(np.asarray(valid)[:, None], np.asarray(codes, dtype=np.uint8),
                 np.uint8(0))
    q = np.where(np.asarray(valid)[:, None], np.asarray(quals, dtype=np.uint8),
                 np.uint8(0))
    lens_b = np.where(np.asarray(valid), np.asarray(lens), 0).astype(
        "<i4").view(np.uint8).reshape(B, 4)
    v = np.asarray(valid, dtype=np.uint8).reshape(B, 1)
    row = np.concatenate(
        [_bitpack_np(c & 7, 3), _bitpack_np(q & 0x7F, 7), lens_b, v,
         np.zeros((B, 3), dtype=np.uint8)], axis=1
    )
    return row


def wire_bitpack6_np(codes, quals, lens, valid):
    """Numpy reference of the bitpack6 wire: rows
    [codes3 | quals6(re-based) | len_le32 | valid | qbase | pad2 (+1 pad
    column on 7-bit width collision — see ``native.bitwire6_width``)].
    Returns None when some row's qual range spans >= 64 values (the caller
    falls back to the 7-bit bitpack).  Differential oracle for
    ``hpgq_pack_bitwire6``."""
    from .native import bitwire6_width

    B, L = np.asarray(quals).shape
    assert L % 8 == 0, L
    v = np.asarray(valid, dtype=bool)
    c = np.where(v[:, None], np.asarray(codes, dtype=np.uint8), np.uint8(0))
    q = np.where(v[:, None], np.asarray(quals, dtype=np.uint8) & 0x7F,
                 np.uint8(0))
    lens64 = np.where(v, np.asarray(lens), 0).astype(np.int64)
    mask = np.arange(L)[None, :] < np.minimum(lens64, L)[:, None]
    qm = np.where(mask, q, np.uint8(255))
    qmin = qm.min(axis=1, initial=255)
    qmin = np.where(mask.any(axis=1), qmin, 0).astype(np.uint8)
    qmax = np.where(mask, q, np.uint8(0)).max(axis=1, initial=0)
    if qmax.size and int((qmax.astype(int) - qmin.astype(int)).max(initial=0)) > 63:
        return None
    q6 = np.where(mask, q - qmin[:, None], np.uint8(0))
    lens_b = lens64.astype("<i4").view(np.uint8).reshape(B, 4)
    parts = [
        _bitpack_np(c & 7, 3), _bitpack_np(q6 & 0x3F, 6), lens_b,
        v.astype(np.uint8).reshape(B, 1), qmin.reshape(B, 1),
        np.zeros((B, 2), dtype=np.uint8),
    ]
    W = bitwire6_width(L)
    row = np.concatenate(parts, axis=1)
    if row.shape[1] < W:  # collision pad column
        row = np.concatenate(
            [row, np.zeros((B, W - row.shape[1]), dtype=np.uint8)], axis=1)
    return row


def wire_bitpack2q_np(codes, quals, lens, valid):
    """Numpy reference of the bitpack2q wire: rows
    [codes3 | qidx2 | len_le32 | valid | palette4 (ascending) | pad3
    (+ pad columns from ``native.bitwire2q_width``'s collision bumps)].
    Quality values are 2-bit indices into a per-row 4-entry palette —
    production Illumina corpora (NovaSeq/NextSeq RTA3) emit exactly 4
    distinct quality levels, so this tier fits them with 5 bits/base
    total.  Returns None when some row holds > 4 distinct qual values
    (the caller falls down the 6-bit → 7-bit ladder).  Differential
    oracle for ``hpgq_pack_bitwire2q``."""
    from .native import bitwire2q_width

    B, L = np.asarray(quals).shape
    assert L % 8 == 0, L
    v = np.asarray(valid, dtype=bool)
    c = np.where(v[:, None], np.asarray(codes, dtype=np.uint8), np.uint8(0))
    q = np.where(v[:, None], np.asarray(quals, dtype=np.uint8) & 0x7F,
                 np.uint8(0))
    lens64 = np.where(v, np.asarray(lens), 0).astype(np.int64)
    mask = np.arange(L)[None, :] < np.minimum(lens64, L)[:, None]
    # distinct count per row: sort the in-length quals (out-of-length
    # pinned to the row min so they add no distinct value)
    qm = np.where(mask, q, np.uint8(255))
    qmin = qm.min(axis=1, initial=255)
    qmin = np.where(mask.any(axis=1), qmin, 0).astype(np.uint8)
    qs = np.sort(np.where(mask, q, qmin[:, None]), axis=1)
    d = np.concatenate([np.ones((B, 1), bool),
                        np.diff(qs.astype(np.int16), axis=1) != 0], axis=1)
    if B and int(d.sum(axis=1).max(initial=1)) > 4:
        return None
    # palette: the up-to-4 distinct values ascending (scatter by distinct
    # rank), unused upper slots repeating the row max so index-by-rank
    # (count of strictly-smaller palette entries) maps every value back
    rank = d.cumsum(axis=1) - 1
    pal = np.zeros((B, 4), dtype=np.uint8)
    pal[np.repeat(np.arange(B), L), np.minimum(rank, 3).ravel()] = qs.ravel()
    for k in (1, 2, 3):
        np.maximum(pal[:, k], pal[:, k - 1], out=pal[:, k])
    qidx = ((q[:, :, None] > pal[:, None, :3]).sum(axis=2)).astype(np.uint8)
    qidx = np.where(mask, qidx, np.uint8(0))
    lens_b = lens64.astype("<i4").view(np.uint8).reshape(B, 4)
    parts = [
        _bitpack_np(c & 7, 3), _bitpack_np(qidx & 3, 2), lens_b,
        v.astype(np.uint8).reshape(B, 1), pal,
        np.zeros((B, 3), dtype=np.uint8),
    ]
    W = bitwire2q_width(L)
    row = np.concatenate(parts, axis=1)
    if row.shape[1] < W:  # collision pad column(s)
        row = np.concatenate(
            [row, np.zeros((B, W - row.shape[1]), dtype=np.uint8)], axis=1)
    return row


def wire_bitpack2c_np(codes, quals, lens, valid):
    """Numpy reference of the bitpack2c wire: ``(buf, exc)`` with rows
    [codes2 | qidx2 | len_le32 | valid | palette4 (ascending) | pad3
    (+ pad columns from ``native.bitwire2c_width``'s collision bumps)].

    The information carried is exactly the reference's ``fastq_read_t``
    per-read payload (sequence + quality + length, field access
    ``src/stats_fastq.c:353-360``) at 4.1 bits/base instead of the
    reference's 16 (two char arrays).
    Bases pack as 2-bit codes (A..T = 0..3); N/OTHER positions pack as 0
    and are listed in the exception sidecar ``exc`` (int32, row-major,
    ``((row * L + pos) << 1) | is_other``, padded to the EXC_BUCKET grid
    with out-of-bounds sentinels) — the device decode scatter-restores
    codes 4/5 so downstream kernels see EXACT codes
    (``stats_jnp.wire_unbits2c``).  Returns None when some row holds > 4
    distinct qual values.  Differential oracle for
    ``hpgq_pack_bitwire2c``."""
    from .native import bitwire2c_width, exc_pad

    B, L = np.asarray(quals).shape
    assert L % 8 == 0, L
    if B * L >= (1 << 30):
        return None
    v = np.asarray(valid, dtype=bool)
    c = np.where(v[:, None], np.asarray(codes, dtype=np.uint8), np.uint8(0))
    q = np.where(v[:, None], np.asarray(quals, dtype=np.uint8) & 0x7F,
                 np.uint8(0))
    lens64 = np.where(v, np.asarray(lens), 0).astype(np.int64)
    mask = np.arange(L)[None, :] < np.minimum(lens64, L)[:, None]
    qm = np.where(mask, q, np.uint8(255))
    qmin = qm.min(axis=1, initial=255)
    qmin = np.where(mask.any(axis=1), qmin, 0).astype(np.uint8)
    qs = np.sort(np.where(mask, q, qmin[:, None]), axis=1)
    d = np.concatenate([np.ones((B, 1), bool),
                        np.diff(qs.astype(np.int16), axis=1) != 0], axis=1)
    if B and int(d.sum(axis=1).max(initial=1)) > 4:
        return None
    rank = d.cumsum(axis=1) - 1
    pal = np.zeros((B, 4), dtype=np.uint8)
    pal[np.repeat(np.arange(B), L), np.minimum(rank, 3).ravel()] = qs.ravel()
    for k in (1, 2, 3):
        np.maximum(pal[:, k], pal[:, k - 1], out=pal[:, k])
    qidx = ((q[:, :, None] > pal[:, None, :3]).sum(axis=2)).astype(np.uint8)
    qidx = np.where(mask, qidx, np.uint8(0))
    # exceptions (row-major): in-length N/OTHER positions; codes pack as 0
    is_exc = mask & (c >= 4)
    er, ep = np.nonzero(is_exc)
    exc = ((er.astype(np.int64) * L + ep) * 2
           + (c[er, ep] == 5)).astype(np.int32)
    c2 = np.where(is_exc, np.uint8(0), np.where(mask, c, np.uint8(0)))
    lens_b = lens64.astype("<i4").view(np.uint8).reshape(B, 4)
    parts = [
        _bitpack_np(c2 & 3, 2), _bitpack_np(qidx & 3, 2), lens_b,
        v.astype(np.uint8).reshape(B, 1), pal,
        np.zeros((B, 3), dtype=np.uint8),
    ]
    W = bitwire2c_width(L)
    row = np.concatenate(parts, axis=1)
    if row.shape[1] < W:  # collision pad column(s)
        row = np.concatenate(
            [row, np.zeros((B, W - row.shape[1]), dtype=np.uint8)], axis=1)
    return row, exc_pad(exc, B, L)


def wire_bitpack2u_np(codes, quals, lens, valid):
    """Numpy reference of the bitpack2u (uniform) wire:
    ``(buf, exc, pal, n_valid)`` with rows = two bare 2-bit planes
    [codes2 | qidx2], each padded to whole even bytes (W = 4*ceil(Lu/8)).

    Same ``fastq_read_t`` payload as the other wire tiers
    (``src/stats_fastq.c:353-360``) at ~4.2 bits/base: the per-row
    len/valid/palette tail collapses into a per-batch sidecar because
    production Illumina runs are uniform-length.
    Applies when every VALID row has the same length Lu and the
    block-wide union of qual values fits one ascending 4-entry palette;
    lengths/validity/palette travel as the per-batch sidecar.  N/OTHER
    positions pack as 0 with exceptions ((row * Lp + pos) << 1)|is_other,
    Lp = 8*ceil(Lu/8).  Returns None when the block misses the tier.
    Differential oracle for ``hpgq_pack_bitwire2u``."""
    from .native import bitwire2u_width, exc_pad

    v = np.asarray(valid, dtype=bool)
    lens_a = np.asarray(lens)
    n = int(v.sum())
    if n == 0:
        return None
    vlens = lens_a[v]
    Lu = int(vlens[0])
    if Lu <= 0 or not (vlens == Lu).all():
        return None
    # valid rows must be a prefix (the packers' padding contract)
    if not v[:n].all():
        return None
    B, L = np.asarray(quals).shape
    Lp = 8 * ((Lu + 7) // 8)
    if B * Lp >= (1 << 30) or Lu > L:
        return None
    c = np.where(v[:, None], np.asarray(codes, dtype=np.uint8), np.uint8(0))
    q = np.where(v[:, None], np.asarray(quals, dtype=np.uint8) & 0x7F,
                 np.uint8(0))
    qv = q[:n, :Lu]
    palette = np.unique(qv)
    if palette.size > 4:
        return None
    pal = np.zeros(4, dtype=np.uint8)
    pal[: palette.size] = palette
    # unused upper slots repeat the max so index-by-rank maps every value
    pal = np.maximum.accumulate(pal)
    qidx = np.zeros((B, Lp), dtype=np.uint8)
    qidx[:n, :Lu] = (qv[:, :, None] > pal[None, None, :3]).sum(axis=2)
    cw = np.zeros((B, Lp), dtype=np.uint8)
    cu = c[:n, :Lu]
    is_exc = cu >= 4
    er, ep = np.nonzero(is_exc)
    exc = ((er.astype(np.int64) * Lp + ep) * 2
           + (cu[er, ep] == 5)).astype(np.int32)
    cw[:n, :Lu] = np.where(is_exc, np.uint8(0), cu)
    row = np.concatenate([_bitpack_np(cw & 3, 2), _bitpack_np(qidx & 3, 2)],
                         axis=1)
    assert row.shape[1] == bitwire2u_width(Lu), (row.shape, Lu)
    return row, exc_pad(exc, B, Lp), pal, n


_WIRE2U_MAX_L = 2048


def try_pack_block_2u(block, pad_reads_to: int = 0):
    """The uniform-tier pack alone: ``(buf, exc, pal, n_valid, Lu)`` or
    None when the block misses the tier or it is disabled
    (HPGQ_WIRE2U=0; it also requires the 2c machinery enabled)."""
    import os

    if not wire2c_enabled() \
            or os.environ.get("HPGQ_WIRE2U", "1") in ("0", "off"):
        return None
    n = block.num_reads
    if n == 0:
        return None
    lens = block.seq_lens
    Lu = int(lens[0])
    if Lu <= 0 or Lu > _WIRE2U_MAX_L or not (lens == Lu).all():
        return None
    nrows = max(int(pad_reads_to), n) if pad_reads_to else n

    from . import native

    if native.available():
        out = native.pack_bitwire2u(
            block.arr, block.starts[:, 1], block.starts[:, 3],
            lens, Lu, nrows,
        )
    else:
        out = wire_bitpack2u_np(*pack_block(block, max_len=round_up(Lu, 8),
                                            pad_reads_to=nrows))
    if out is None:
        return None
    buf, exc, pal, n_valid = out
    return buf, exc, pal, n_valid, Lu


def wire2c_enabled() -> bool:
    """The 2c tier is on unless HPGQ_WIRE2C=0 disables it specifically,
    HPGQ_QPAL=0 disables the palette machinery it builds on, or
    HPGQ_WIRE6=0 disables the whole adaptive ladder."""
    import os

    return (os.environ.get("HPGQ_WIRE2C", "1") not in ("0", "off")
            and os.environ.get("HPGQ_QPAL", "1") not in ("0", "off")
            and os.environ.get("HPGQ_WIRE6", "1") not in ("0", "off"))


_WIRE2C_MAX_L = 2048  # exception encoding + trimmed-wire scope (short reads)


def try_pack_block_2c(block, max_len: int, pad_reads_to: int = 0):
    """The 2c pack alone (no fallback ladder): ``(buf, exc)``, or None
    when the block misses the tier (> 4 distinct quals in a row, too many
    N/OTHER positions, L out of scope, or the tier is disabled)."""
    if not wire2c_enabled():
        return None
    n = block.num_reads
    L = int(max_len)
    assert L % 8 == 0, L
    if L > _WIRE2C_MAX_L:
        return None
    nrows = max(int(pad_reads_to), n) if pad_reads_to else n

    from . import native

    if n and native.available():
        return native.pack_bitwire2c(
            block.arr, block.starts[:, 1], block.starts[:, 3],
            block.seq_lens, L, nrows,
        )
    return wire_bitpack2c_np(*pack_block(block, max_len=L,
                                         pad_reads_to=nrows))


def try_pack_block_palette(block, max_len: int, pad_reads_to: int = 0):
    """The 2q palette pack alone (no fallback ladder): the wire buffer,
    or None when any row exceeds 4 distinct qual values or the adaptive
    tiers are disabled.  Used by the verdict/trim dispatchers to prefer
    the palette (5 bits/base) over their qn8 upgrade (8 bits/base) when
    the block fits — the palette carries full base identity AND quals,
    a strict superset of what those kernels read."""
    import os

    if (os.environ.get("HPGQ_WIRE6", "1") in ("0", "off")
            or os.environ.get("HPGQ_QPAL", "1") in ("0", "off")):
        return None
    n = block.num_reads
    L = int(max_len)
    assert L % 8 == 0, L
    nrows = max(int(pad_reads_to), n) if pad_reads_to else n

    from . import native

    if n and native.available():
        return native.pack_bitwire2q(
            block.arr, block.starts[:, 1], block.starts[:, 3],
            block.seq_lens, L, nrows,
        )
    return wire_bitpack2q_np(*pack_block(block, max_len=L,
                                         pad_reads_to=nrows))


def pack_block_bitwire_adaptive(block, max_len: int,
                                pad_reads_to: int = 0,
                                allow2c: bool = False):
    """Adaptive bitpack ladder, narrowest layout the block fits:
    bitpack2c (4.1 bits/base: 2-bit codes + 2-bit qual-palette indices +
    N/OTHER exception sidecar — ``allow2c`` callers only, returns a
    ``(buf, exc)`` tuple), else bitpack2q (5 bits/base) when every row
    has <= 4 distinct qual values (binned production corpora —
    NovaSeq/NextSeq RTA3), else bitpack6 (9 bits/base) when every row's
    qual range fits 6 bits (unbinned corpora virtually always do), else
    the plain 7-bit bitpack.  SINGLE-HOST paths only: the multihost
    shard_map sessions need data-independent dispatch shapes, so they
    keep calling the plain packers.  ``HPGQ_WIRE6=0`` disables the whole
    ladder; ``HPGQ_QPAL=0`` disables the palette tiers;
    ``HPGQ_WIRE2C=0`` disables just 2c."""
    import os

    if os.environ.get("HPGQ_WIRE6", "1") in ("0", "off"):
        return pack_block_bitwire(block, max_len, pad_reads_to=pad_reads_to)
    if allow2c:
        out = try_pack_block_2c(block, max_len, pad_reads_to=pad_reads_to)
        if out is not None:
            return out
    qpal = os.environ.get("HPGQ_QPAL", "1") not in ("0", "off")
    n = block.num_reads
    L = int(max_len)
    assert L % 8 == 0, L
    nrows = max(int(pad_reads_to), n) if pad_reads_to else n

    from . import native

    if n and native.available():
        args = (block.arr, block.starts[:, 1], block.starts[:, 3],
                block.seq_lens, L, nrows)
        if qpal:
            out = native.pack_bitwire2q(*args)
            if out is not None:
                return out
        out = native.pack_bitwire6(*args)
        if out is not None:
            return out
        return native.pack_bitwire(*args)
    packed = pack_block(block, max_len=L, pad_reads_to=nrows)
    out = wire_bitpack2q_np(*packed) if qpal else None
    if out is None:
        out = wire_bitpack6_np(*packed)
    return out if out is not None else wire_bitpack_np(*packed)


def bitwire_tier_width(L: int, tier: int) -> int:
    """Row width of the bitpack wire at an explicit tier
    (-1 = 2c codes+palette, 0 = 2q qual-palette, 1 = 6-bit re-based
    quals, 2 = plain 7-bit)."""
    from .native import bitwire2c_width, bitwire2q_width, bitwire6_width

    if tier == -1:
        return bitwire2c_width(L)
    if tier == 0:
        return bitwire2q_width(L)
    if tier == 1:
        return bitwire6_width(L)
    return 10 * L // 8 + 8


def bitwire_tier_valid_off(L: int, tier: int) -> int:
    """Byte offset of the per-row valid flag in each bitpack tier layout
    (collision pad columns append at the END of a row, so offsets are
    width-independent): 2c = codes2+qidx2+len4, 2q = codes3+qidx2+len4,
    6-bit = codes3+q6+len4, 7-bit = codes3+q7+len4."""
    if tier == -1:
        return 4 * L // 8 + 4
    if tier == 0:
        return 5 * L // 8 + 4
    if tier == 1:
        return 9 * L // 8 + 4
    return 10 * L // 8 + 4


def bitwire_tier_palette_cols(L: int, tier: int = 0) -> "tuple[int, int]":
    """Column slice ``(start, stop)`` of the 4-entry ascending qual palette
    in a palette-tier wire row (tier -1 = 2c, 0 = 2q) — both tail layouts
    are ``[... | len4 | valid | palette4 | pad3]`` (see
    hpgq_pack_bitwire2q / hpgq_pack_bitwire2c), so the palette sits right
    after the valid byte.  Single source of truth for consumers that read
    the palette back off the wire (the multihost tier-vote monotonicity
    probe); the native-vs-numpy packer equality tests pin this layout."""
    vo = bitwire_tier_valid_off(L, tier)
    return vo + 1, vo + 5


def bitwire_tier_floor(allow2c: bool = False) -> int:
    """Narrowest bitpack tier the environment allows: -1 (2c) for callers
    whose device step accepts the exception sidecar when the tier is
    enabled, else 0; 1 when ``HPGQ_QPAL=0`` disables the palette tiers,
    2 when ``HPGQ_WIRE6=0`` disables the whole adaptive ladder."""
    import os

    if os.environ.get("HPGQ_WIRE6", "1") in ("0", "off"):
        return 2
    if os.environ.get("HPGQ_QPAL", "1") in ("0", "off"):
        return 1
    if allow2c and wire2c_enabled():
        return -1
    return 0


def pack_block_bitwire_tier(block, max_len: int, tier: int,
                            pad_reads_to: int = 0):
    """Pack at EXACTLY the given bitpack tier; returns None when the
    block doesn't fit a narrow tier (-1/0/1) — tier -1 (2c) additionally
    returns a ``(buf, exc)`` tuple and misses when the exception sidecar
    overflows or L is out of 2c scope.  The multihost sharded sessions
    vote the per-step tier element-wise max across ranks (a rank's probed
    minimum tier is a lower bound any wider tier also satisfies), so
    packing at a voted tier always succeeds."""
    n = block.num_reads
    L = int(max_len)
    assert L % 8 == 0, L
    nrows = max(int(pad_reads_to), n) if pad_reads_to else n

    if tier == -1:
        return try_pack_block_2c(block, L, pad_reads_to=nrows)

    from . import native

    if n and native.available():
        args = (block.arr, block.starts[:, 1], block.starts[:, 3],
                block.seq_lens, L, nrows)
        if tier == 0:
            return native.pack_bitwire2q(*args)
        if tier == 1:
            return native.pack_bitwire6(*args)
        return native.pack_bitwire(*args)
    packed = pack_block(block, max_len=L, pad_reads_to=nrows)
    if tier == 0:
        return wire_bitpack2q_np(*packed)
    if tier == 1:
        return wire_bitpack6_np(*packed)
    return wire_bitpack_np(*packed)


def wire_qn8_np(codes, quals, lens, valid) -> np.ndarray:
    """Numpy reference of the qn8 wire: rows
    [(qual & 0x7F | is_N << 7) x L | len_le32 | valid | pad3]
    (see hpgq_pack_qnwire).  ASCII quality never exceeds 126, so bit 7
    carries the is-N flag — all the filter/edit verdict+trim kernels need
    from the sequence.  Differential oracle for the native packer."""
    B, L = np.asarray(quals).shape
    c = np.asarray(codes, dtype=np.uint8)
    q = np.asarray(quals, dtype=np.uint8)
    body = (q & 0x7F) | ((c == 4).astype(np.uint8) << 7)
    body = np.where(np.asarray(valid)[:, None], body, np.uint8(0))
    lens_b = np.where(np.asarray(valid), np.asarray(lens), 0).astype(
        "<i4").view(np.uint8).reshape(B, 4)
    v = np.asarray(valid, dtype=np.uint8).reshape(B, 1)
    return np.concatenate(
        [body, lens_b, v, np.zeros((B, 3), dtype=np.uint8)], axis=1
    )


def pack_block_qnwire(block, max_len: int, pad_reads_to: int = 0) -> np.ndarray:
    """Pack a RecordBlock straight into the qn8 wire buffer
    (uint8 ``[nrows, L + 8]``) — the minimal H2D layout for verdict/trim
    calls (filter/edit): 8 vs bitpack's 10 bits/base, ~20% fewer wire
    bytes."""
    return _pack_wire_dispatch(block, max_len, pad_reads_to,
                               "pack_qnwire", wire_qn8_np)


def zero_wire_sel(buf: np.ndarray, sel, valid_off: int = None) -> np.ndarray:
    """Drop deselected reads from a packed wire buffer in place by zeroing
    each row's tail valid byte (offset W-4 in the bitpack/fused4/qn8 rows;
    the bitpack6 layout's valid byte sits before its qbase+pad tail) —
    one scatter instead of a re-pack.  ``sel`` is bool [num_reads]; rows
    beyond ``len(sel)`` (padding) already carry valid=0.  Callers that
    know the layout (tiered sharded sessions) pass ``valid_off``
    explicitly (``bitwire_tier_valid_off``); otherwise it is inferred
    from the row width."""
    drop = np.flatnonzero(~np.asarray(sel, bool))
    if drop.size:
        if valid_off is not None:
            buf[drop, valid_off] = 0
            return buf
        W = buf.shape[1]
        off = W - 4
        # every wire layout puts valid at W-4 EXCEPT a collision-padded
        # bitpack6 row (W = 9L/8 + 9, see native.bitwire6_width), where
        # the pad column shifts it to W-5.  Such a W is odd while fused4
        # and qn8 widths are always even (L % 8 == 0), so the check below
        # cannot misfire on another wire kind.
        body = W - 9
        if body > 0 and body * 8 % 9 == 0 and (body * 8 // 9) % 8 == 0:
            b10 = (W - 1 - 8) * 8
            if b10 % 10 == 0 and (b10 // 10) % 8 == 0:
                # W-1 was a valid 7-bit width -> this IS the padded layout
                off = W - 5
        buf[drop, off] = 0
    return buf


def pack_block_wire(block, wire: str, max_len: int,
                    pad_reads_to: int = 0, allow6: bool = False,
                    allow2c: bool = False):
    """Pack a RecordBlock into the named wire format
    ('bitpack' | 'qn8') — the one dispatch point for every wire-format
    consumer.  ``allow6``: for 'bitpack', permit the adaptive 6-bit-qual
    layout (single-host callers only; multihost shard_map shapes must not
    depend on data — see ``pack_block_bitwire_adaptive``).  ``allow2c``:
    additionally permit the 2c tier, whose return value is a
    ``(buf, exc)`` tuple — only callers whose device step accepts the
    exception sidecar opt in."""
    if wire == "bitpack" and allow6:
        return pack_block_bitwire_adaptive(block, max_len,
                                           pad_reads_to=pad_reads_to,
                                           allow2c=allow2c)
    pack = {"bitpack": pack_block_bitwire, "qn8": pack_block_qnwire}[wire]
    return pack(block, max_len, pad_reads_to=pad_reads_to)


def pack_block_bitwire(block, max_len: int, pad_reads_to: int = 0) -> np.ndarray:
    """Pack a RecordBlock straight into the bitpack wire buffer
    (uint8 ``[nrows, 3L/8 + 7L/8 + 8]``, ``max_len % 8 == 0``): 3-bit base
    codes + 7-bit ASCII quals, ~31% fewer wire bytes than fused4, so fewer
    bytes to pin and copy to the device."""
    assert int(max_len) % 8 == 0, max_len
    return _pack_wire_dispatch(block, max_len, pad_reads_to,
                               "pack_bitwire", wire_bitpack_np)


def pack_block(block, max_len: int = 0, pad_reads_to: int = 0):
    """Pack a RecordBlock into (codes, quals, lens, valid).

    ``max_len``: pad/clip length (0 = block max, rounded up to 128 lanes).
    ``pad_reads_to``: pad the read dimension (0 = no padding); padded rows
    have ``valid`` False and length 0.

    Uses the native C++ packer (``hpgq_torch.io.native``) when available; the
    numpy gather below is the portable fallback and the differential oracle
    for it (tests/test_native.py).
    """
    n = block.num_reads
    lens = block.seq_lens
    lmax = int(max_len) if max_len else round_up(max(int(lens.max(initial=1)), 1), 128)
    nrows = max(int(pad_reads_to), n) if pad_reads_to else n

    from . import native

    if n and native.available():
        codes, quals = native.pack_rows(
            block.arr, block.starts[:, 1], block.starts[:, 3], lens, lmax,
            nrows,
        )
        if nrows > n:
            out_lens = np.concatenate([lens, np.zeros(nrows - n, dtype=np.int32)])
        else:
            out_lens = lens
        valid = np.arange(nrows) < n
        return codes, quals, out_lens.astype(np.int32), valid

    arr = block.arr
    seq_start = block.starts[:, 1]
    q_start = block.starts[:, 3]
    col = np.arange(lmax, dtype=np.int64)

    clip = np.minimum(lens.astype(np.int64), lmax)
    pos_mask = col[None, :] < clip[:, None]

    limit = arr.shape[0] - 1
    seq_idx = np.minimum(seq_start[:, None] + col[None, :], limit)
    q_idx = np.minimum(q_start[:, None] + col[None, :], limit)

    codes = np.where(pos_mask, BASE_LUT[arr[seq_idx]], np.int8(BASE_OTHER))
    quals = np.where(pos_mask, arr[q_idx], np.uint8(0))

    if nrows > n:
        codes = np.concatenate(
            [codes, np.full((nrows - n, lmax), BASE_OTHER, dtype=np.int8)], axis=0
        )
        quals = np.concatenate(
            [quals, np.zeros((nrows - n, lmax), dtype=np.uint8)], axis=0
        )
        out_lens = np.concatenate([lens, np.zeros(nrows - n, dtype=np.int32)])
    else:
        out_lens = lens
    valid = np.arange(nrows) < n
    return codes, quals, out_lens.astype(np.int32), valid
