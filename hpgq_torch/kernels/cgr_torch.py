"""Chaos-game representation tables in plain PyTorch.

Torch twins of ``hpgq.kernels.cgr``'s ``window_cells``, ``window_qsums``,
``cgr_batch_tables``, ``make_cgr_step`` and ``zero_cgr_acc``
(``cgr.py:64-235``).  The closed form is the same: the cell of a k-word
is its k-bit x and y window codes (base at window offset ``t`` weighs
``2^t``; x set for A/T, y for G/T), so a batch's tables are a 2-D
histogram over ``ix * dim + iy`` of the windows that lie inside their
read and hold no N.  Any other byte (packer code 5, IUPAC and the like)
counts as N, deviation [D7] (``cgr.py:25-35``).

What the TPU needed and this does not: the table is one int64
``index_add_`` per table instead of chunked f32 one-hot matmuls, so
there is no chunk loop, no ``Precision.HIGHEST`` trap and no pair of
int32 limbs.  The quality table uses the same index, weighted by the
window's quality sum minus ``phred * k``, which is negative when quality
bytes sit below the offset; one cell may pass 2^31, which int64 holds.
Invalid windows go to a spare row of ``W`` bins (one per window
position, so they do not all hit one address) that is cut off.  No
float touches a table, and nothing waits on the device.
"""

from __future__ import annotations

import torch

from ..constants import BASE_A, BASE_G, BASE_T, DEFAULT_CGR_K
from .wire_torch import wire_unbits


def window_cells(codes, lens, k: int):
    """(ix, iy int32, ok bool) ``[B, W]`` window codes for W = L-k+1; ok
    marks windows inside the read with no N or other byte."""
    B, L = codes.shape
    W = L - k + 1
    assert W >= 1, (L, k)
    ix = torch.zeros((B, W), dtype=torch.int32, device=codes.device)
    iy = torch.zeros_like(ix)
    ok = torch.ones((B, W), dtype=torch.bool, device=codes.device)
    for t in range(k):
        part = codes[:, t:t + W]
        ix += ((part == BASE_A) | (part == BASE_T)).to(torch.int32) << t
        iy += ((part == BASE_G) | (part == BASE_T)).to(torch.int32) << t
        ok &= part < 4
    pos = torch.arange(W, dtype=torch.int64, device=codes.device)
    ok &= (pos + k)[None, :] <= lens.to(torch.int64)[:, None]
    return ix, iy, ok


def window_qsums(quals, k: int):
    """Sliding sum of k raw quality bytes, int32 ``[B, W]``."""
    W = quals.shape[1] - k + 1
    q = quals.to(torch.int32)
    s = q[:, :W].clone()
    for t in range(1, k):
        s += q[:, t:t + W]
    return s


def cgr_batch_tables(codes, quals, lens, valid, k: int, phred: int):
    """(table_seq, table_q, words) int64 for one packed batch: word
    counts and quality totals (``sum(window qsum) - phred*k*words``) per
    ``[dim, dim]`` cell, and the number of words."""
    dim = 1 << k
    ix, iy, ok = window_cells(codes, lens, k)
    ok &= valid.to(torch.bool)[:, None]
    B, W = ix.shape
    cells = dim * dim
    spare = cells + torch.arange(W, dtype=torch.int64, device=codes.device)
    key = torch.where(ok, ix.to(torch.int64) * dim + iy, spare[None, :])
    key = key.reshape(-1)
    weight = (window_qsums(quals, k).to(torch.int64) - phred * k).reshape(-1)

    def hist(w):
        out = torch.zeros(cells + W, dtype=torch.int64, device=codes.device)
        return out.index_add_(0, key, w)[:cells].view(dim, dim)

    ones = torch.ones((), dtype=torch.int64, device=codes.device)
    return hist(ones.expand(B * W)), hist(weight), ok.sum()


def zero_cgr_acc(k: int, device="cpu") -> dict:
    """Zeroed int64 accumulator: ``table_seq``, ``table_q``, ``words``."""
    dim = 1 << k
    return {
        "table_seq": torch.zeros((dim, dim), dtype=torch.int64, device=device),
        "table_q": torch.zeros((dim, dim), dtype=torch.int64, device=device),
        "words": torch.zeros((), dtype=torch.int64, device=device),
    }


def make_cgr_step(k: int = DEFAULT_CGR_K, phred: int = 33, wire=None):
    """``step(acc, codes, quals, lens, valid) -> acc`` (in place), or with
    ``wire='bitpack'`` ``step(acc, buf)`` where ``buf`` is a 2q, 6-bit or
    7-bit bitpack buffer decoded on its device (CGR reads the qualities,
    so neither qn8 nor 2c carries it)."""
    if wire not in (None, "bitpack"):
        raise ValueError("unknown wire %r (valid: bitpack, None)" % (wire,))

    def step(acc, codes, quals, lens, valid):
        ts, tq, w = cgr_batch_tables(codes, quals, lens, valid, k, phred)
        acc["table_seq"] += ts
        acc["table_q"] += tq
        acc["words"] += w
        return acc

    if wire is None:
        return step
    return lambda acc, buf: step(acc, *wire_unbits(buf))
