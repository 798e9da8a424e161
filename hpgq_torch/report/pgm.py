"""The port's own copy of ``hpgq/report/pgm.py`` (the port imports nothing of
``hpgq``); kept equal to it, so the PGM and ``.gs`` files match ``hpgq``'s
byte for byte.

Chaos-game output formats: binary P5 PGM images, genomic-signature files,
and the diff/validate math — byte-compatible with the reference
(``old/chaos_game.c:322-593``).

C-semantics notes replicated here:

* PGM pixel = ``(uchar)(int)((float)value * norm)`` — float truncation toward
  zero, then mod-256 wrap (``old/chaos_game.c:537-541``).
* k < 7 images are zoomed ``2^(7-k)``-fold to 128x128
  (``old/chaos_game.c:519-524,545-568``).
* The quality table is normalized in place with *unsigned integer* division
  by ``k`` then by ``table_seq`` (``chaos_game_normalize_quality_table_``,
  ``old/chaos_game.c:484-499``).
* ``table_dif = (int)(seq*fq_norm - gs*gs_norm)`` truncation; the abs-clamp
  to 255 then uchar store (``:322-372,502-517``).
* .gs file layout: 196-byte header (char[180] filename, u32 k, u32 dim_x,
  u32 dim_y, u32 ref_word_count — ``old/chaos_game.h:65-70``) followed by
  dim rows of dim little-endian u32 counts (``old/chaos_game.c:294-296``).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..constants import (
    CGR_MIN_IMAGE_PIXEL_SIZE,
    CGR_MIN_K_IMAGE_VALUE,
)

_GS_HEADER = struct.Struct("<180sIIII")


def pgm_bytes(table: np.ndarray, k: int, norm: float) -> bytes:
    """Binary P5 PGM with the reference's norm/zoom semantics."""
    dim = table.shape[0]
    vals = (
        np.float32(np.float32(table.astype(np.float32)) * np.float64(norm))
        .astype(np.int64)
        .astype(np.uint8)
    )
    if k < CGR_MIN_K_IMAGE_VALUE:
        zoom = 1 << (CGR_MIN_K_IMAGE_VALUE - k)
        vals = np.repeat(np.repeat(vals, zoom, axis=0), zoom, axis=1)
        redim = CGR_MIN_IMAGE_PIXEL_SIZE
        assert vals.shape == (redim, redim)
    else:
        redim = dim
    header = b"P5\n%d %d\n255\n" % (redim, redim)
    return header + vals.tobytes()


def write_pgm(path: str, table: np.ndarray, k: int, norm: float) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(pgm_bytes(table, k, norm))
    return path


def fq_norm_value(word_count: int, k: int) -> float:
    """128 / (words per cell) — ``old/chaos_game.c:330-338,430-438``.

    Zero counted words (every read shorter than k, or every window broken
    by N) returns norm 0.0 — the table is all-zero anyway, so the PGMs
    come out black and the diff reduces to the (negated) reference
    signature.  The reference divides by zero here (float inf, then
    0*inf = NaN cast to unsigned — UB garbage pixels); an all-zero image
    is the sane documented deviation (caught by the config fuzzer on
    uniform reads shorter than k)."""
    mem = 1 << (2 * k)
    norm = word_count / mem
    if norm <= 0.0:
        return 0.0
    return 128.0 / norm


def normalize_quality_table(table_q: np.ndarray, table_seq: np.ndarray,
                            k: int) -> np.ndarray:
    """Unsigned integer division by k then by the word frequency
    (``old/chaos_game.c:484-499``); 0 where no word was seen."""
    # the reference table is unsigned int: negative cell totals (quality
    # bytes below the phred offset, e.g. Solexa -5..-1) wrap mod 2^32 and
    # divide as huge unsigned values (old/chaos_game.h:79)
    q = table_q.astype(np.int64) % (1 << 32)
    nz = table_seq > 0
    out = np.zeros_like(q)
    out[nz] = (q[nz] // k) // table_seq[nz]
    return out


def diff_table(table_seq: np.ndarray, table_gs: np.ndarray,
               fq_word_count: int, ref_word_count: int, k: int):
    """(table_dif int, stats dict) — ``chaos_game_calculate_table_dif`` +
    ``chaos_game_validate_table_dif`` (``old/chaos_game.c:322-405``)."""
    fq_norm = fq_norm_value(fq_word_count, k)
    gs_norm = fq_norm_value(ref_word_count, k)
    dif = (
        table_seq.astype(np.float64) * fq_norm
        - table_gs.astype(np.float64) * gs_norm
    ).astype(np.int64)  # C int truncation
    mean = float(dif.mean())
    std = float(np.sqrt(np.mean((dif - mean) ** 2)))
    stats = {
        "highest": int(dif.max()),
        "lowest": int(dif.min()),
        "mean": mean,
        "std": std,
    }
    return dif, stats


def abs_clamp_diff(dif: np.ndarray) -> np.ndarray:
    """abs + clamp to 255 (``chaos_game_absolute_diff_table_``)."""
    return np.minimum(np.abs(dif), 255).astype(np.int64)


def write_gs(path: str, table: np.ndarray, k: int, word_count: int) -> str:
    """Write a genomic-signature file in the reference's binary layout."""
    dim = table.shape[0]
    assert dim == 1 << k
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    name = os.path.basename(path).encode()[:179]
    with open(path, "wb") as f:
        f.write(_GS_HEADER.pack(name, k, dim, dim, word_count))
        f.write(table.astype("<u4").tobytes())
    return path


def read_gs(path: str, expect_k: int = None):
    """(table u32 [dim, dim], k, ref_word_count) from a .gs file."""
    with open(path, "rb") as f:
        raw = f.read(_GS_HEADER.size)
        if len(raw) < _GS_HEADER.size:
            raise ValueError("truncated genomic-signature header: %s" % path)
        _, k, dim_x, _dim_y, ref_word_count = _GS_HEADER.unpack(raw)
        if expect_k is not None and k != expect_k:
            raise ValueError(
                "genomic signature %s has k=%d, expected k=%d"
                % (path, k, expect_k)
            )
        dim = 1 << k
        if dim_x and dim_x != dim:
            raise ValueError("inconsistent gs dims in %s" % path)
        data = np.frombuffer(f.read(dim * dim * 4), dtype="<u4")
        if data.size != dim * dim:
            raise ValueError("truncated genomic-signature table: %s" % path)
    return data.reshape(dim, dim).astype(np.int64), k, int(ref_word_count)
