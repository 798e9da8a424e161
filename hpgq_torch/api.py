"""High-level Python API of the port.

    import hpgq_torch

    counters = hpgq_torch.stats("reads.fq", outdir="qc",
                                read_quality_range=(20, 60), max_N=2)
    result = hpgq_torch.filter_reads("reads.fq", outdir="out",
                                     read_quality_range=(20, 40), max_N=2)
    result = hpgq_torch.edit("reads.fq", outdir="out",
                             left_length=10, left_quality_range=(25, 93))
    result = hpgq_torch.prepro("reads.fq", outdir="out", ltrim_nts=5)
    result = hpgq_torch.cgr("reads.fq", outdir="out", k=7, write_gs=True)

Same signatures as :mod:`hpgq.api`'s ``stats``, ``filter_reads``, ``edit``,
``prepro`` and ``cgr``, plus ``device=`` ("cuda" by default, "cpu" when
asked for; a missing GPU raises), and ``sharded=`` on every command: the
CLI's ``--sharded``, one rank per local card
(:func:`hpgq_torch.dist.launch.run_sharded`), or one rank of a
``torchrun`` run; the call returns what it returns in one process.  A rank
that fails raises :class:`~hpgq_torch.dist.launch.RankFailed`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from .constants import DEFAULT_CGR_K, NO_VALUE, QUALITY_ENCODINGS
from .device import resolve_device
from .options import (
    CgrOptions,
    EditOptions,
    FilterOptions,
    PreproOptions,
    StatsOptions,
)
from .dist.launch import run_sharded
from .dist.run_dist import (
    run_edit_sharded,
    run_filter_sharded,
    run_stats_sharded,
)
from .pipeline.cgr_run import run_cgr
from .pipeline.run import run_edit, run_filter, run_stats

_Range = Optional[Tuple[Optional[int], Optional[int]]]


# _set_range, _common and _criteria are copies of hpgq/api.py:37-88 (and the
# bodies of edit, prepro and cgr of :133-199), so the two APIs build the
# same options from the same keywords.
def _set_range(crit, lo_attr: str, hi_attr: str, rng: _Range):
    if rng is None:
        return
    lo, hi = rng
    if lo is not None:
        setattr(crit, lo_attr, int(lo))
    if hi is not None:
        setattr(crit, hi_attr, int(hi))


def _common(opts, in_path, in_path2, outdir, encoding, batch_size,
            checkpoint, sharded):
    opts.in_filename = os.fspath(in_path)
    opts.in_filename2 = os.fspath(in_path2) if in_path2 else None
    opts.out_dirname = os.fspath(outdir)
    os.makedirs(opts.out_dirname, exist_ok=True)
    enc = QUALITY_ENCODINGS.get(str(encoding))
    if enc is None:
        raise ValueError(
            "invalid quality encoding %r (valid: phred33, phred64)" % encoding
        )
    opts.quality_encoding_name = str(encoding)
    opts.quality_encoding_value = enc
    opts.batch_size = int(batch_size)
    opts.checkpoint_path = checkpoint
    opts.sharded = bool(sharded)
    return opts


def _criteria(opts, read_length_range, read_quality_range, max_N,
              max_out_of_quality, left, right):
    c = opts.criteria
    _set_range(c, "min_read_length", "max_read_length", read_length_range)
    _set_range(c, "min_read_quality", "max_read_quality", read_quality_range)
    if max_N is not None:
        c.max_N = int(max_N)
    if max_out_of_quality is not None:
        c.max_out_of_quality = int(max_out_of_quality)
    if left is not None:
        length, rng = left
        c.left_length = int(length)
        _set_range(c, "min_left_quality", "max_left_quality", rng)
    if right is not None:
        length, rng = right
        c.right_length = int(length)
        _set_range(c, "min_right_quality", "max_right_quality", rng)
    return any(
        getattr(c, f) != NO_VALUE
        for f in ("min_read_length", "max_read_length", "min_read_quality",
                  "max_read_quality", "max_N", "max_out_of_quality",
                  "left_length", "right_length")
    )


def stats(in_path, in_path2=None, outdir=".", *, kmers: bool = False,
          encoding: str = "phred33", batch_size: int = 10000,
          read_length_range: _Range = None, read_quality_range: _Range = None,
          max_N: Optional[int] = None, max_out_of_quality: Optional[int] = None,
          left=None, right=None, checkpoint: Optional[str] = None,
          sharded: bool = False, report: bool = True, device="cuda"):
    """QC statistics (the `stats` command) on ``device``.  Returns
    :class:`~hpgq_torch.core.counters.StatsCounters` (a pair when paired-end).
    Passing any threshold enables the inline pre-filter.  ``sharded`` runs
    it over every local card, one rank per card, or as one rank of a
    ``torchrun`` run (:mod:`hpgq_torch.dist`)."""
    dev = resolve_device(device)
    opts = _common(StatsOptions(), in_path, in_path2, outdir, encoding,
                   batch_size, checkpoint, sharded)
    opts.kmers_on = bool(kmers)
    opts.filter_on = _criteria(opts, read_length_range, read_quality_range,
                               max_N, max_out_of_quality, left, right)
    if sharded:  # single-end and paired alike
        return run_sharded(run_stats_sharded, opts, None, dev, report=report)
    return run_stats(opts, report=report, device=dev)


def filter_reads(in_path, in_path2=None, outdir=".", *,
                 encoding: str = "phred33", batch_size: int = 10000,
                 read_length_range: _Range = None,
                 read_quality_range: _Range = None,
                 max_N: Optional[int] = None,
                 max_out_of_quality: Optional[int] = None,
                 left=None, right=None, checkpoint: Optional[str] = None,
                 sharded: bool = False, device="cuda"):
    """Split into passed/failed record files (the `filter` command) on
    ``device``.  Returns the result dict (counts + output paths);
    ``sharded`` as in :func:`stats`."""
    dev = resolve_device(device)
    opts = _common(FilterOptions(), in_path, in_path2, outdir, encoding,
                   batch_size, checkpoint, sharded)
    if not _criteria(opts, read_length_range, read_quality_range, max_N,
                     max_out_of_quality, left, right):
        raise ValueError("nothing to filter: no filter criteria given")
    if sharded:
        return run_sharded(run_filter_sharded, opts, None, dev)
    return run_filter(opts, device=dev)


def edit(in_path, in_path2=None, outdir=".", *,
         encoding: str = "phred33", batch_size: int = 10000,
         left_length: Optional[int] = None, left_quality_range: _Range = None,
         right_length: Optional[int] = None, right_quality_range: _Range = None,
         filter_after: bool = False, read_length_range: _Range = None,
         read_quality_range: _Range = None, max_N: Optional[int] = None,
         checkpoint: Optional[str] = None, sharded: bool = False,
         device="cuda"):
    """Quality-trim reads (the `edit` command) on ``device``;
    ``filter_after`` applies the remaining criteria to the trimmed reads.
    Returns the result dict (counts + output paths); ``sharded`` as in
    :func:`stats`."""
    dev = resolve_device(device)
    opts = _common(EditOptions(), in_path, in_path2, outdir, encoding,
                   batch_size, checkpoint, sharded)
    c = opts.criteria
    if left_length is not None:
        c.left_length = int(left_length)
        _set_range(c, "min_left_quality", "max_left_quality",
                   left_quality_range)
    if right_length is not None:
        c.right_length = int(right_length)
        _set_range(c, "min_right_quality", "max_right_quality",
                   right_quality_range)
    if c.left_length == NO_VALUE and c.right_length == NO_VALUE:
        raise ValueError("nothing to edit: no trim options given")
    _set_range(c, "min_read_length", "max_read_length", read_length_range)
    _set_range(c, "min_read_quality", "max_read_quality", read_quality_range)
    if max_N is not None:
        c.max_N = int(max_N)
    opts.filter_on = bool(filter_after)
    if sharded:
        return run_sharded(run_edit_sharded, opts, None, dev)
    return run_edit(opts, device=dev)


def prepro(in_path, in_path2=None, outdir=".", *,
           encoding: str = "phred33", batch_size: int = 10000,
           ltrim_nts: int = 0, rtrim_nts: int = 0,
           min_quality: int = 20, max_quality: int = 60,
           checkpoint: Optional[str] = None, sharded: bool = False,
           device="cuda"):
    """Legacy preprocessing (the `prepro` command) on ``device``: trim the
    first/last nucleotides when the window's mean quality is outside
    ``[min_quality, max_quality]``; writes ``<input>.valid`` file(s).
    Returns the result dict; ``sharded`` as in :func:`stats`."""
    dev = resolve_device(device)
    opts = _common(PreproOptions(), in_path, in_path2, outdir, encoding,
                   batch_size, checkpoint, sharded)
    opts.min_quality, opts.max_quality = int(min_quality), int(max_quality)
    opts.ltrim_nts, opts.rtrim_nts = int(ltrim_nts), int(rtrim_nts)
    if opts.ltrim_nts <= 0 and opts.rtrim_nts <= 0:
        raise ValueError("nothing to preprocess: ltrim_nts/rtrim_nts are 0")
    opts.apply_trim_windows()
    if sharded:
        return run_sharded(run_edit_sharded, opts, None, dev)
    return run_edit(opts, device=dev)


def cgr(in_path, in_path2=None, outdir=".", *, k: int = DEFAULT_CGR_K,
        encoding: str = "phred33", batch_size: int = 10000,
        gs_filename: Optional[str] = None, write_gs: bool = False,
        checkpoint: Optional[str] = None, sharded: bool = False,
        device="cuda"):
    """Chaos-game genomic signature (the `cgr` command) on ``device``.
    Returns the result dict (tables, word count, PGM paths, diff stats
    when ``gs_filename``); ``sharded`` as in :func:`stats`."""
    dev = resolve_device(device)
    opts = _common(CgrOptions(), in_path, in_path2, outdir, encoding,
                   batch_size, checkpoint, sharded)
    opts.k = int(k)
    opts.gs_filename = gs_filename
    opts.write_gs = bool(write_gs)
    return run_cgr(opts, device=dev)


def filter_criteria(*, read_length_range: _Range = None,
                    read_quality_range: _Range = None,
                    max_N: Optional[int] = None,
                    max_out_of_quality: Optional[int] = None, left=None,
                    right=None, quality_window: _Range = None):
    """The inline filter :func:`stats` builds from the same threshold
    keywords, as the ``crit`` argument of the kernels' ``batch_partials``
    (None when no threshold is set).  ``quality_window`` is the legacy
    ``[begin, end)`` position window of the quality screens."""
    opts = StatsOptions()
    on = _criteria(opts, read_length_range, read_quality_range, max_N,
                   max_out_of_quality, left, right)
    if quality_window is not None:
        crit = opts.criteria
        crit.begin_quality_nt, crit.end_quality_nt = map(int, quality_window)
        on = True
    return opts.criteria if on else None
