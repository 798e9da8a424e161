"""Device-side decoders of the bitpack wire tiers, in plain torch.

Torch twins of ``hpgq.kernels.stats_jnp``'s ``_bit_fields``, ``_wire_tail``,
``wire_unbits``, ``_unbits6``, ``_unbits2q``, ``wire_unbits2c``,
``wire_unbits2u``, ``pad_wire_cols``, ``bitwire_kind``,
``bitwire_logical_len``, ``qnwire_logical_len`` and ``wire_unqn8``
(``stats_jnp.py:469-729``).  The host packers are the port's copies of
``hpgq``'s (``hpgq_torch.io.packer`` / ``hpgq_torch.io.native``), bit for
bit the same layouts; these functions take their buffers on any device and
return ``(codes int8, quals uint8, lens int32, valid bool)`` byte-equal to
``hpgq_torch.io.packer.pack_block``.

Two details differ from the jnp code because torch has no ``mode="drop"``
scatter: the 2c/2u exception restore scatters into a flat buffer one
element longer than ``B*L`` and maps every out-of-range index (the packers'
padding sentinel is exactly ``B*L``) onto that extra element, which is then
cut off.  No boolean filtering, so nothing waits on the device.
"""

from __future__ import annotations

import torch

from ..io.native import bitwire2c_width, bitwire2q_width, bitwire6_width


def bitwire_kind(row_width: int):
    """(qual_bits, L) for a bitpack-family row width (7, 6, 2, or -2 for
    2c); same width arithmetic as ``stats_jnp.bitwire_kind``."""
    body = (row_width - 8) * 8
    if body % 10 == 0 and (body // 10) % 8 == 0:
        return 7, body // 10
    L6 = (body // 9) // 8 * 8
    if L6 > 0 and bitwire6_width(L6) == row_width:
        return 6, L6
    m = (row_width - 12) // 5
    for mm in (m, m - 1):
        if mm >= 1 and bitwire2q_width(8 * mm) == row_width:
            return 2, 8 * mm
    for d in range(4):  # collision pads bump W by up to a few bytes
        L2 = 2 * (row_width - d - 12)
        if L2 > 0 and L2 % 8 == 0 and bitwire2c_width(L2) == row_width:
            return -2, L2
    raise ValueError("not a bitpack-family row width: %d" % row_width)


def bitwire_logical_len(row_width: int) -> int:
    """Logical read length L encoded by a bitpack-family wire row."""
    return bitwire_kind(row_width)[1]


def _bit_fields(groups, nbits: int, mask: int):
    """[B, L/8, nbytes] uint8 bitstream groups -> [B, L/8, 8] fields.

    The operands stay uint8, so ``<<`` wraps exactly as in the jnp code."""
    out = []
    for k in range(8):
        s = nbits * k
        i0, r = s >> 3, s & 7
        v = groups[..., i0] >> r
        if r + nbits > 8:
            v = v | (groups[..., i0 + 1] << (8 - r))
        out.append(v & mask)
    return torch.stack(out, dim=-1)


def _wire_tail(buf, off: int):
    """(lens int32, valid bool) from a row tail [len_le32 | valid]."""
    lb = buf[:, off:off + 4].to(torch.int32)  # widen before shifting
    lens = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    return lens, buf[:, off + 4] != 0


def _len_mask(lens, B: int, L: int):
    pos = torch.arange(L, dtype=torch.int32, device=lens.device)
    return pos[None, :] < lens[:, None]


def _codes3(buf, B: int, L: int):
    c3 = 3 * L // 8
    return _bit_fields(buf[:, :c3].reshape(B, L // 8, 3), 3, 7).to(
        torch.int8).reshape(B, L), c3


def _palette(idx, pal):
    """4-entry palette lookup by three selects (``pal[..., 0..3]``)."""
    lo = torch.where(idx == 0, pal[..., 0:1], pal[..., 1:2])
    hi = torch.where(idx == 2, pal[..., 2:3], pal[..., 3:4])
    return torch.where(idx < 2, lo, hi)


def wire_unbits(buf):
    """Decode a 7-bit, 6-bit or 2q bitpack buffer (tier from its width)."""
    B, W = buf.shape
    qbits, L = bitwire_kind(W)
    if qbits == -2:
        raise ValueError("2c wire rows need their exception sidecar — "
                         "decode with wire_unbits2c(buf, exc)")
    if qbits == 6:
        return _unbits6(buf, L)
    if qbits == 2:
        return _unbits2q(buf, L)
    codes, c3 = _codes3(buf, B, L)
    q7 = 7 * L // 8
    quals = _bit_fields(buf[:, c3:c3 + q7].reshape(B, L // 8, 7), 7,
                        0x7F).reshape(B, L)
    lens, valid = _wire_tail(buf, c3 + q7)
    return codes, quals, lens, valid


def _unbits6(buf, L: int):
    """3-bit codes + 6-bit quals re-based on the per-row ``qbase``."""
    B = buf.shape[0]
    codes, c3 = _codes3(buf, B, L)
    q6 = 6 * L // 8
    q = _bit_fields(buf[:, c3:c3 + q6].reshape(B, L // 8, 6), 6,
                    0x3F).reshape(B, L)
    lens, valid = _wire_tail(buf, c3 + q6)
    qbase = buf[:, c3 + q6 + 5]
    quals = torch.where(_len_mask(lens, B, L), q + qbase[:, None],
                        torch.zeros((), dtype=torch.uint8, device=buf.device))
    return codes, quals, lens, valid


def _unbits2q(buf, L: int):
    """3-bit codes + 2-bit indices into the per-row 4-entry palette."""
    B = buf.shape[0]
    codes, c3 = _codes3(buf, B, L)
    q2 = L // 4
    idx = _bit_fields(buf[:, c3:c3 + q2].reshape(B, L // 8, 2), 2,
                      3).reshape(B, L)
    lens, valid = _wire_tail(buf, c3 + q2)
    q = _palette(idx, buf[:, c3 + q2 + 5:c3 + q2 + 9])
    quals = torch.where(_len_mask(lens, B, L), q,
                        torch.zeros((), dtype=torch.uint8, device=buf.device))
    return codes, quals, lens, valid


def _restore_exceptions(codes2, exc, n: int):
    """Scatter-max codes 4/5 back at the sidecar's flat indices; indices
    outside ``[0, n)`` (the padding sentinels) land on a spare element."""
    idx = (exc >> 1).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    val = ((exc & 1) + 4).to(torch.uint8)
    flat = torch.cat([codes2.reshape(-1),
                      torch.zeros(1, dtype=torch.uint8, device=codes2.device)])
    flat.scatter_reduce_(0, idx, val, reduce="amax")
    return flat[:n]


def wire_unbits2c(buf, exc):
    """Decode a 2c buffer with its int32 exception sidecar ``exc``."""
    B, W = buf.shape
    qbits, L = bitwire_kind(W)
    if qbits != -2:
        raise ValueError("row width %d is not a 2c wire row" % W)
    c2 = q2 = L // 4
    codes2 = _bit_fields(buf[:, :c2].reshape(B, L // 8, 2), 2, 3)
    codes = _restore_exceptions(codes2, exc, B * L).reshape(B, L)
    qidx = _bit_fields(buf[:, c2:c2 + q2].reshape(B, L // 8, 2), 2,
                       3).reshape(B, L)
    lens, valid = _wire_tail(buf, c2 + q2)
    q = _palette(qidx, buf[:, c2 + q2 + 5:c2 + q2 + 9])
    mask = _len_mask(lens, B, L)
    zero = torch.zeros((), dtype=torch.uint8, device=buf.device)
    quals = torch.where(mask, q, zero)
    codes = torch.where(mask, codes, zero + 5).to(torch.int8)
    return codes, quals, lens, valid


def wire_unbits2u(buf, exc, pal, n_valid: int, *, L: int):
    """Decode a 2u (uniform) buffer: two bare 2-bit planes of ``W`` bytes;
    the uniform length ``L``, the valid-row count and the 4-entry palette
    ``pal`` (a uint8 tensor on ``buf``'s device) are the batch sidecar."""
    B, W = buf.shape
    Lp = 2 * W  # fields per row of each plane
    c2 = W // 2
    codes2 = _bit_fields(buf[:, :c2].reshape(B, Lp // 8, 2), 2, 3)
    codes = _restore_exceptions(codes2, exc, B * Lp).reshape(B, Lp)
    qidx = _bit_fields(buf[:, c2:].reshape(B, Lp // 8, 2), 2, 3).reshape(B, Lp)
    q = _palette(qidx, pal)
    valid = torch.arange(B, device=buf.device) < n_valid
    lens = torch.where(valid, L, 0).to(torch.int32)
    mask = _len_mask(lens, B, Lp)
    zero = torch.zeros((), dtype=torch.uint8, device=buf.device)
    quals = torch.where(mask, q, zero)
    codes = torch.where(mask, codes, zero + 5).to(torch.int8)
    return codes, quals, lens, valid


def qnwire_logical_len(W: int) -> int:
    """Logical L of a qn8 wire row (W = L + 8)."""
    return W - 8


def wire_unqn8(buf):
    """Decode a qn8 buffer (``hpgq_torch.io.packer.pack_block_qnwire``): one
    byte per base, ``(qual & 0x7F) | (is_N << 7)``, then the row tail.  Codes
    come out as 4 (N) or 0: all the verdict reads of the sequence is its N
    count, so never feed these codes to a stats step."""
    L = qnwire_logical_len(buf.shape[1])
    body = buf[:, :L]
    quals = body & 0x7F
    codes = ((body >> 7) << 2).to(torch.int8)
    lens, valid = _wire_tail(buf, L)
    return codes, quals, lens, valid


def pad_wire_cols(codes, quals, lcap: int):
    """Pad decoded columns up to ``lcap`` with the packers' padding values
    (codes 5 = OTHER, quals 0); every kernel masks by ``lens`` anyway."""
    L = codes.shape[1]
    if L >= lcap:
        return codes, quals
    pad = (0, lcap - L)
    return (torch.nn.functional.pad(codes, pad, value=5),
            torch.nn.functional.pad(quals, pad))
