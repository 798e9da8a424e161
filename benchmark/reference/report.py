"""The report files of ``stats``, as bytes, from the reference's counters.

A frozen copy of the writers of ``hpgq_torch/report/stats_report.py`` and
of ``hpgq_torch/utils/cfmt.py`` (C float arithmetic, libm ``round`` and
glibc ``%0.2f``, with the upstream tool's format quirks), for the files
that a ``stats`` run without ``--kmers`` writes: ``summary.txt``, each
``.data`` file and each ``.gnuplot`` script.  The PNG charts are not
judged: whether they are drawn depends on the tools the machine has.

:func:`report_files` returns ``{file name: bytes}`` for the output
directory ``out_dir`` (the ``.gnuplot`` scripts name their files by path)
and writes nothing.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np

from .stats import MAX_VALUE

_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.round.restype = ctypes.c_double
_libm.round.argtypes = [ctypes.c_double]


def c_round(x: float) -> float:
    """C99 ``round()``: half away from zero."""
    return _libm.round(float(x))


def f32pct(count, total) -> float:
    """C ``100.0f * count / total`` in float32."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float32(np.float32(100.0) * np.float32(count))
                     / np.float32(total))


def f32div(a, b) -> float:
    """C ``1.0f * a / b`` in float32."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float32(a) / np.float32(b))


def fmt2f(x: float) -> str:
    """glibc ``%0.2f`` of a double."""
    if x != x:
        return "-nan" if np.copysign(1.0, x) < 0 else "nan"
    if x in (float("inf"), float("-inf")):
        return "-inf" if x < 0 else "inf"
    return "%0.2f" % x


def _norm_quality(quality: float, phred: int) -> int:
    v = c_round(quality - phred)
    return -(1 << 31) if v != v else int(v)


def _gnuplot(prefix, data_filename, title, xlabel, ylabel, kind, x_end,
             y_columns=(2,), y_titles=()):
    """The ``.gnuplot`` script of one chart (x range ``[0, x_end]``, y
    autoscaled)."""
    out = ["set output '%s.png'\n" % prefix,
           "set terminal png nocrop enhanced font arial 10 size 640,360\n",
           "set ylabel '%s'\n" % ylabel,
           "set xlabel '%s'\n" % xlabel,
           "set ytics border in scale 1,0.5 mirror norotate  "
           "offset character 0, 0, 0\n",
           "set title '%s'\n" % title,
           "set xrange [ %i : %i ] noreverse nowriteback\n" % (0, x_end),
           "set autoscale y\n",
           "set lmargin '10'\n", "set rmargin '4'\n", "set tmargin '3'\n",
           "set bmargin '4'\n"]
    parts = []
    for i, ycol in enumerate(y_columns):
        ytitle = y_titles[i] if i < len(y_titles) else ""
        parts.append("%s '%s' using %i:%i title '%s' with %s"
                     % ("" if i == 0 else ",", data_filename, 1, ycol, ytitle,
                        kind))
    out.append("plot" + "".join(parts) + "\n")
    return "".join(out)


def report_files(c, in_path: str, out_dir: str, max_N=None) -> dict:
    """``{file name: bytes}`` of the report of counters ``c`` (a
    :class:`~benchmark.reference.stats.Counters` with the filter on) for the
    input ``in_path`` written into ``out_dir``; ``max_N`` is echoed as the
    filter's N threshold, as the API's keywords set it (they set no range
    text, so no range is echoed)."""
    name = os.path.basename(in_path) or in_path
    files = {}

    def put(suffix, text):
        files[name + suffix] = text.encode()

    def chart(suffix, data_suffix, *args, **kw):
        prefix = os.path.join(out_dir, name + suffix)
        put(suffix + ".gnuplot", _gnuplot(
            prefix, os.path.join(out_dir, name + data_suffix), *args, **kw))

    total_nt = c.num_nucleotides()
    s = ["-----------------------------------\n",
         "      FastQ quality report\n",
         "-----------------------------------\n",
         "FastQ filename: %s\n" % name, "\n"]
    if c.filter_on:
        s.append("Filter options:\n")
        if max_N is not None and int(max_N) != MAX_VALUE:
            s.append("\tMax. number of Ns   : %i\n" % int(max_N))
        s.append("\n")
        total = c.num_passed + c.num_failed
        s.append("Number of reads in file  : %d\n" % total)
        s.append("Number of processed reads: %d (%s %%)\n"
                 % (c.num_reads, fmt2f(f32pct(c.num_reads, total))))
    else:
        s.append("Filter         : Disabled\n")
        s.append("Number of reads: %d\n" % c.num_reads)
    s.append("\n")
    s.append("Read length (min., mean, max.): (%i, %s, %i)\n"
             % (c.min_length, fmt2f(f32div(1.0 * c.acc_length, c.num_reads)),
                c.max_length))
    s.append("\n")
    q = _norm_quality(f32div(1.0 * c.acc_quality, c.num_reads), c.phred)
    s.append("Mean quality = %i [%s]\n" % (q, chr((q + c.phred) & 0xFF)))
    s.append("\n")
    s.append("Nucleotide content (A, C, G, T, N)\n")
    for label, val in (("A", c.num_As), ("T", c.num_Ts), ("G", c.num_Gs),
                       ("C", c.num_Cs), ("N", c.num_Ns)):
        s.append("\t%s: %s %%\n" % (label, fmt2f(f32pct(val, total_nt))))
    s.append("GC content\n")
    s.append("\tCG: %s %%\n" % fmt2f(f32pct(c.num_Gs + c.num_Cs, total_nt)))
    s.append("\n")
    s.append("Mean quality per nucleotide position\n")
    for k in range(c.max_length):
        acc = int(c.acc_quality_per_nt[k]) if k < c.lcap else 0
        cnt = int(c.count_quality_per_nt[k]) if k < c.lcap else 0
        q = _norm_quality(f32div(1.0 * acc, cnt), c.phred)
        s.append("\tpos. %i: %i [%s]\t" % (k + 1, q, chr((q + c.phred) & 0xFF)))
        if (k + 1) % 5 == 0:
            s.append("\n")
    s.append("\n")
    put(".summary.txt", "".join(s))

    # length histogram
    put(".length.histogram.data", "".join(
        "%i\t%i\n" % (i, int(c.length_hist[i]) if i < c.length_hist.shape[0] else 0)
        for i in range(1, c.max_length + 1)))
    chart(".length.histogram", ".length.histogram.data",
          "Read Length Histogram", "Read length", "Number of reads", "boxes",
          c.max_length + 1)

    # read quality histogram
    nz = np.flatnonzero(c.quality_hist)
    qmin = int(nz.min()) if nz.size else 1000
    qmax = int(nz.max()) if nz.size else 0
    put(".read.quality.histogram.data", "".join(
        "%i\t%i\n" % (i - c.phred, int(c.quality_hist[i]))
        for i in range(qmin, qmax + 1)))
    chart(".read.quality.histogram", ".read.quality.histogram.data",
          "Avg. Read Quality Histogram", "Read Quality (Phred%i scale)" % c.phred,
          "Number of reads", "boxes", qmax - qmin + 5)

    # GC histogram
    put(".GC.histogram.data", "".join(
        "%i\t%i\n" % (i, int(c.gc_hist[i])) for i in range(1, 100) if c.gc_hist[i]))
    chart(".GC.histogram", ".GC.histogram.data", "GC Content Histogram",
          "GC content (%)", "Number of reads", "boxes", 100)

    def pos_counts(k):
        b = c.base_per_nt[:, k]
        return int(b[0]), int(b[3]), int(b[2]), int(b[1]), int(b[4])  # A T G C N

    gc_rows, nt_rows = [], []
    for k in range(c.max_length):
        a, t, g, cc, n = pos_counts(k)
        tot = a + t + g + cc + n
        val = f32pct(g + cc, tot)
        if val > 1.0:
            gc_rows.append("%i\t%s\n" % (k + 1, fmt2f(val)))
        nt_rows.append("%i\t%s\t%s\t%s\t%s\t%s\n" % (
            k + 1, fmt2f(f32pct(a, tot)), fmt2f(f32pct(t, tot)),
            fmt2f(f32pct(g, tot)), fmt2f(f32pct(cc, tot)), fmt2f(f32pct(n, tot))))
    put(".GC.per.nt.data", "".join(gc_rows))
    chart(".GC.per.nt", ".GC.per.nt.data", "GC Content per Nucleotide Position",
          "Nucleotide position", "GC content (%)", "lines", c.max_length + 1)

    put(".quality.per.nt.data", "".join(
        "%i\t%i\n" % (k, _norm_quality(f32div(1.0 * int(c.acc_quality_per_nt[k]),
                                              int(c.count_quality_per_nt[k])),
                                       c.phred))
        for k in range(c.max_length)))
    chart(".quality.per.nt", ".quality.per.nt.data",
          "Quality per Nucleotide Position", "Nucleotide position",
          "Quality (Phred%i scale)" % c.phred, "lines", c.max_length + 1)

    put(".nucleotides.data", "".join(nt_rows))
    chart(".nucleotides", ".nucleotides.data", "Nucleotide Content per Position",
          "Nucleotide position", "Nucleotide content (%)", "lines",
          c.max_length + 1, y_columns=(2, 3, 4, 5, 6),
          y_titles=("A %", "T %", "G %", "C %", "N %"))
    return files
