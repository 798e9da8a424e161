"""Plain PyTorch stats partials: the reference version of the K1 and K2
kernels.

Torch twins of ``hpgq.kernels.stats_jnp``'s ``zero_partials``,
``read_reductions``, ``_window_sums``, ``verdicts``, ``trims``,
``apply_trims``, ``kmer_codes``, ``kmer_hist2d``, ``batch_partials`` and
``merge_into`` (``stats_jnp.py:46-391``).  :func:`fused_partials` composes
them into the contract of the hand-written kernels
(``hpgq_torch.kernels.stats_cuda``), k-mers included: the CPU path runs it,
and the GPU checks hold the kernels against it on the same tensors.

Differences from the jnp module, all deliberate:

* Partials and the running accumulator are int64 (``acc_quality`` and its
  Kahan compensation stay f32), so no host flush window is needed.
* :func:`merge_into` updates the accumulator in place: the step owns it,
  and the in-place add saves one allocation per field and batch.
* Every histogram key is integer math [D1]; the per-read mean is the f32
  quotient ``qsum.float() / lens.float()`` exactly as on the other engines.
  Per-read sums and verdict products are int64, so no read length wraps.
* The k-mer histogram is the scatter-add branch of ``kmer_hist2d``
  (``stats_jnp.py:284-288``), an int64 ``index_add_`` over
  ``kmer * lcap + pos`` with invalid windows routed to a spare row; the
  TPU's one-hot branch is not ported.
"""

from __future__ import annotations

import torch

from ..constants import (
    BASE_C,
    BASE_G,
    BASE_N,
    KMER_K,
    MAX_VALUE,
    MIN_VALUE,
    NUM_KMERS,
    PHRED33,
)
from ..core.counters import GC_BINS, QUAL_BINS

MIN_LENGTH_INIT = 100000  # reference init, src/stats_fastq.c:24


def zero_partials(lcap: int, kmers_on: bool = False, device="cpu") -> dict:
    """Zeroed accumulator dict on ``device`` (int64 except ``acc_quality*``),
    with the ``kmer_counts`` / ``kmer_per_nt`` fields when ``kmers_on``."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    p = {
        "num_reads": z(),
        "num_passed": z(),
        "num_failed": z(),
        "acc_length": z(),
        "min_length": torch.full((), MIN_LENGTH_INIT, dtype=torch.int64,
                                 device=device),
        "max_length": z(),
        # Kahan-compensated f32 sum of per-read mean raw qualities [D1]
        "acc_quality": torch.zeros((), dtype=torch.float32, device=device),
        "acc_quality_comp": torch.zeros((), dtype=torch.float32,
                                        device=device),
        "base_totals": z(5),  # A C G T N
        "length_hist": z(lcap + 1),
        "quality_hist": z(QUAL_BINS),
        "gc_hist": z(GC_BINS),
        "cov_per_nt": z(lcap),
        "qual_per_nt": z(lcap),
        "base_per_nt": z(5, lcap),
    }
    if kmers_on:
        p["kmer_counts"] = z(NUM_KMERS)
        p["kmer_per_nt"] = z(NUM_KMERS, lcap)
    return p


def _pos(B: int, L: int, device):
    return torch.arange(L, dtype=torch.int32, device=device).expand(B, L)


def read_reductions(codes, quals, lens):
    """(mask, qsum[B], nG+nC[B], nN[B]) masked per-read reductions."""
    B, L = codes.shape
    mask = _pos(B, L, codes.device) < lens[:, None]
    q = torch.where(mask, quals.to(torch.int64), 0)
    qsum = q.sum(dim=1)
    ngc = (((codes == BASE_G) | (codes == BASE_C)) & mask).sum(dim=1)
    nn = ((codes == BASE_N) & mask).sum(dim=1)
    return mask, qsum, ngc, nn


def _window_sums(quals, lens, left_len: int, right_len: int, mask):
    """Left/right window quality sums and widths [D3]."""
    B, L = quals.shape
    q = torch.where(mask, quals.to(torch.int64), 0)
    pos = _pos(B, L, quals.device)
    out = {}
    if left_len > 0:
        w = torch.clamp(lens, max=left_len)
        out["left"] = (torch.where(pos < w[:, None], q, 0).sum(dim=1), w)
    if right_len > 0:
        w = torch.clamp(lens, max=right_len)
        rmask = (pos >= (lens - w)[:, None]) & mask
        out["right"] = (torch.where(rmask, q, 0).sum(dim=1), w)
    return out


def _bounds(ok, qn, w, lo: int, hi: int):
    """Sentinel-aware ``lo*w <= qn <= hi*w`` (``stats_jnp.verdicts``)."""
    ok &= (lo * w <= qn) if lo != MIN_VALUE else (qn >= 0)
    if hi != MAX_VALUE:
        ok &= qn <= hi * w
    return ok


def verdicts(codes, quals, lens, crit, phred: int = PHRED33):
    """fastq_filter predicate, vectorized — bool [B].  [D2][D3][D8]"""
    crit = crit.substituted()
    B, L = codes.shape
    lens64 = lens.to(torch.int64)
    mask, qsum, _, nn = read_reductions(codes, quals, lens64)

    ok = (lens64 >= crit.min_read_length) & (lens64 <= crit.max_read_length)
    if crit.quality_window_on:
        pos = _pos(B, L, codes.device)
        qwmask = (mask & (pos >= crit.begin_quality_nt)
                  & (pos < crit.end_quality_nt))
        wlen = qwmask.sum(dim=1)
        wqsum = torch.where(qwmask, quals.to(torch.int64), 0).sum(dim=1)
    else:
        qwmask, wlen, wqsum = mask, lens64, qsum
    ok = _bounds(ok, wqsum - phred * wlen, wlen,
                 crit.min_read_quality, crit.max_read_quality)

    if crit.max_out_of_quality != MAX_VALUE:
        nq = quals.to(torch.int64) - phred
        out_of = (((nq < crit.min_read_quality) | (nq > crit.max_read_quality))
                  & qwmask).sum(dim=1)
        ok &= out_of <= crit.max_out_of_quality

    wins = _window_sums(
        quals, lens64,
        crit.left_length if crit.left_length > MIN_VALUE else 0,
        crit.right_length if crit.right_length > MIN_VALUE else 0,
        mask,
    )
    if "left" in wins:
        s, w = wins["left"]
        ok = _bounds(ok, s - phred * w, w,
                     crit.min_left_quality, crit.max_left_quality)
    if "right" in wins:
        s, w = wins["right"]
        ok = _bounds(ok, s - phred * w, w,
                     crit.min_right_quality, crit.max_right_quality)
    return ok & (nn <= crit.max_N)


def trims(quals, lens, crit, phred: int = PHRED33):
    """fastq_edit trim decision — (ltrim, rtrim) int32 [B].  [D4]

    A window whose mean quality is out of its range is cut whole; the
    right cut never reaches into the left one.  Window sums are int64 and
    the bounds sentinel-aware (``stats_jnp.trims``): MIN means ``qn < 0``,
    and the MAX check is skipped."""
    crit = crit.substituted()
    B, L = quals.shape
    lens64 = lens.to(torch.int64)
    mask = _pos(B, L, quals.device) < lens64[:, None]
    lt = torch.zeros(B, dtype=torch.int64, device=quals.device)
    rt = torch.zeros_like(lt)
    wins = _window_sums(
        quals, lens64,
        crit.left_length if crit.left_length > MIN_VALUE else 0,
        crit.right_length if crit.right_length > MIN_VALUE else 0,
        mask,
    )
    for side, lo, hi in (("left", crit.min_left_quality,
                          crit.max_left_quality),
                         ("right", crit.min_right_quality,
                          crit.max_right_quality)):
        if side not in wins:
            continue
        s, w = wins[side]
        ok = _bounds(torch.ones_like(w, dtype=torch.bool), s - phred * w, w,
                     lo, hi)
        cut = torch.where(ok, 0, w)
        if side == "left":
            lt = cut
        else:
            rt = cut
    rt = torch.minimum(rt, lens64 - lt)
    return lt.to(torch.int32), rt.to(torch.int32)


def apply_trims(codes, quals, lens, lt, rt):
    """Shift-trim packed tensors (``stats_jnp.apply_trims``): each row
    gathered from ``min(pos + lt, L - 1)``, positions past the new length
    filled with code 5 and quality 0 (never an N)."""
    B, L = codes.shape
    lt64 = lt.to(torch.int64)
    new_lens = lens.to(torch.int64) - lt64 - rt.to(torch.int64)
    pos = torch.arange(L, dtype=torch.int64, device=codes.device)[None, :]
    src = torch.clamp(pos + lt64[:, None], max=max(L - 1, 0))
    keep = pos < new_lens[:, None]
    nc = torch.where(keep, torch.gather(codes, 1, src), 5).to(codes.dtype)
    nq = torch.where(keep, torch.gather(quals, 1, src), 0).to(quals.dtype)
    return nc, nq, new_lens.to(lens.dtype)


def batch_partials(codes, quals, lens, valid, lcap: int):
    """All per-batch statistics over ``valid`` rows -> partials dict."""
    B, L = codes.shape
    assert L <= lcap, (L, lcap)
    lens64 = lens.to(torch.int64)
    mask, qsum, _, _ = read_reductions(codes, quals, lens64)
    v64 = valid.to(torch.int64)
    base_counts = torch.stack(
        [((codes == c) & mask).sum(dim=1) for c in range(5)])  # [5, B]
    mean_q = torch.where(lens64 > 0,
                         qsum.to(torch.float32) / lens64.to(torch.float32),
                         0.0)

    p = {
        "num_reads": v64.sum(),
        "acc_length": (lens64 * v64).sum(),
        "min_length": torch.where(valid, lens64, MIN_LENGTH_INIT).min()
        if B else torch.tensor(MIN_LENGTH_INIT, device=codes.device),
        "max_length": torch.where(valid, lens64, 0).max()
        if B else torch.tensor(0, device=codes.device),
        "acc_quality": torch.where(valid, mean_q, 0.0).sum(),
        "base_totals": (base_counts * v64[None, :]).sum(dim=1),
    }

    def hist(keys, weight, bins):
        return torch.zeros(bins, dtype=torch.int64,
                           device=codes.device).index_add_(0, keys, weight)

    p["length_hist"] = hist(lens64.clamp(0, lcap), v64, lcap + 1)
    # [D1] integer round-half-up of the rational mean — backend-exact
    qkey = ((2 * qsum + lens64) // (2 * lens64).clamp(min=1)).clamp(
        0, QUAL_BINS - 1)
    p["quality_hist"] = hist(qkey, v64, QUAL_BINS)
    # zero-length reads take no GC key (the reference would divide by zero)
    gkey = ((100 * (base_counts[BASE_G] + base_counts[BASE_C]))
            // lens64.clamp(min=1)).clamp(0, GC_BINS - 1)
    p["gc_hist"] = hist(gkey, v64 * (lens64 > 0), GC_BINS)

    vmask = mask & valid[:, None]
    pad = lcap - L
    p["cov_per_nt"] = torch.nn.functional.pad(vmask.sum(dim=0), (0, pad))
    p["qual_per_nt"] = torch.nn.functional.pad(
        torch.where(vmask, quals.to(torch.int64), 0).sum(dim=0), (0, pad))
    p["base_per_nt"] = torch.nn.functional.pad(
        torch.stack([((codes == c) & vmask).sum(dim=0) for c in range(5)]),
        (0, pad))
    return p


def kmer_codes(codes, lens):
    """[D5] per-window 5-mer codes (int64) and validity, ``[B, L-4]`` each."""
    B, L = codes.shape
    W = L - KMER_K + 1
    kc = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    ok = torch.ones((B, W), dtype=torch.bool, device=codes.device)
    for i in range(KMER_K):
        part = codes[:, i:i + W]
        kc = kc * 4 + part.clamp(max=3).to(torch.int64)
        ok &= part < 4
    pos = torch.arange(W, dtype=torch.int64, device=codes.device)
    ok &= (pos + KMER_K)[None, :] <= lens.to(torch.int64)[:, None]
    return kc, ok


def kmer_hist2d(kc, ok, lcap: int):
    """int64 ``[NUM_KMERS, lcap]`` (kmer, position) histogram of the valid
    windows: one ``index_add_`` over ``kmer * lcap + pos``, invalid windows
    routed to a sacrificial row ``NUM_KMERS`` that is cut off.  Nothing
    waits on the device (``bincount`` would read the maximum back)."""
    B, W = kc.shape
    assert W <= lcap, (W, lcap)
    pos = torch.arange(W, dtype=torch.int64, device=kc.device)
    key = torch.where(ok, kc, NUM_KMERS) * lcap + pos[None, :]
    out = torch.zeros((NUM_KMERS + 1) * lcap, dtype=torch.int64,
                      device=kc.device)
    out.index_add_(0, key.reshape(-1),
                   torch.ones((), dtype=torch.int64,
                              device=kc.device).expand(B * W))
    return out.view(NUM_KMERS + 1, lcap)[:NUM_KMERS]


def kmer_partials(codes, lens, passed, lcap: int) -> dict:
    """The k-mer ride-along of ``stats_pallas.make_batch_partials``
    (``:594-608``) over the rows of ``passed``: ``kmer_per_nt`` and
    ``kmer_counts``, all zero when the batch is narrower than a k-mer."""
    if codes.shape[1] >= KMER_K:
        kc, ok = kmer_codes(codes, lens)
        k2d = kmer_hist2d(kc, ok & passed[:, None], lcap)
    else:
        k2d = torch.zeros((NUM_KMERS, lcap), dtype=torch.int64,
                          device=codes.device)
    return {"kmer_per_nt": k2d, "kmer_counts": k2d.sum(dim=1)}


def fused_partials(codes, quals, lens, valid, lcap: int, phred: int,
                   crit=None, kmers_on: bool = False) -> dict:
    """The K1/K2 contract in plain torch: verdicts (when ``crit`` is set),
    partials over the passing rows, the ``_passed_mask`` /
    ``_num_passed`` / ``_num_failed`` side outputs of
    ``stats_pallas.batch_partials_pallas`` (``stats_pallas.py:253-273``),
    and with ``kmers_on`` the k-mer fields over the passing rows."""
    valid = valid.to(torch.bool)
    if crit is None:
        p = batch_partials(codes, quals, lens, valid, lcap)
        p["_passed_mask"] = valid
    else:
        ok = verdicts(codes, quals, lens, crit, phred)
        passed = valid & ok
        p = batch_partials(codes, quals, lens, passed, lcap)
        p["_passed_mask"] = passed
        p["_num_passed"] = passed.sum()
        p["_num_failed"] = (valid & ~ok).sum()
    if kmers_on:
        p.update(kmer_partials(codes, lens, p["_passed_mask"], lcap))
    return p


def merge_into(acc: dict, p: dict) -> dict:
    """Accumulate batch partials into ``acc`` in place; returns ``acc``."""
    acc["num_reads"] += p["num_reads"]
    acc["acc_length"] += p["acc_length"]
    torch.minimum(acc["min_length"], p["min_length"], out=acc["min_length"])
    torch.maximum(acc["max_length"], p["max_length"], out=acc["max_length"])
    # Kahan step for the f32 mean-quality sum (each op its own kernel, so
    # nothing reassociates the compensation away)
    y = p["acc_quality"] - acc["acc_quality_comp"]
    t = acc["acc_quality"] + y
    acc["acc_quality_comp"].copy_((t - acc["acc_quality"]) - y)
    acc["acc_quality"].copy_(t)
    for k in ("base_totals", "length_hist", "quality_hist", "gc_hist",
              "cov_per_nt", "qual_per_nt", "base_per_nt"):
        acc[k] += p[k]
    if "kmer_counts" in acc:
        assert "kmer_counts" in p, "k-mer accumulator, partials without k-mers"
        acc["kmer_counts"] += p["kmer_counts"]
        acc["kmer_per_nt"] += p["kmer_per_nt"]
    return acc
