"""High-level Python API of the port.

    import hpgq_torch

    counters = hpgq_torch.stats("reads.fq", outdir="qc",
                                read_quality_range=(20, 60), max_N=2)

Same signature as :func:`hpgq.api.stats`, plus ``device=`` ("cuda" by
default, "cpu" when asked for; a missing GPU raises).
"""

from __future__ import annotations

from typing import Optional

from hpgq.api import _Range, _common, _criteria
from hpgq.options import StatsOptions

from .device import resolve_device
from .pipeline.run import run_stats


def stats(in_path, in_path2=None, outdir=".", *, kmers: bool = False,
          encoding: str = "phred33", batch_size: int = 10000,
          read_length_range: _Range = None, read_quality_range: _Range = None,
          max_N: Optional[int] = None, max_out_of_quality: Optional[int] = None,
          left=None, right=None, checkpoint: Optional[str] = None,
          sharded: bool = False, report: bool = True, device="cuda"):
    """QC statistics (the `stats` command) on ``device``.  Returns
    :class:`~hpgq.core.counters.StatsCounters`.  Passing any threshold
    enables the inline pre-filter."""
    dev = resolve_device(device)
    opts = _common(StatsOptions(), in_path, in_path2, outdir, encoding,
                   batch_size, checkpoint, sharded)
    opts.kmers_on = bool(kmers)
    opts.filter_on = _criteria(opts, read_length_range, read_quality_range,
                               max_N, max_out_of_quality, left, right)
    return run_stats(opts, report=report, device=dev)


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
