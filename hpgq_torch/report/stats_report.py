"""The port's own copy of ``hpgq/report/stats_report.py`` (the port imports nothing of
``hpgq``); with ``kmer_string``
of ``hpgq/oracle/spec.py`` copied in, so the report files match ``hpgq``'s
byte for byte.

Byte-compatible stats report writers.

Reproduces the output-format contract of ``src/stats_report.c`` (SURVEY §2.5)
— file names, column formats, float formatting (C float arithmetic + glibc
``%0.2f``), and the reference's quirks, which we keep deliberately for byte
equality:

* ``summary.txt`` "top 20" k-mer table actually prints 21 rows
  (loop ``i < 21`` at ``src/stats_report.c:147``).
* literal ``%``/``%)`` text from invalid printf conversions
  (``src/stats_report.c:103,118-124``; glibc prints them verbatim).
* ``quality.per.nt.data`` is written twice — ``report_quality`` (integer
  division, ``%0.2f``) then ``report_nt_content`` (float division, ``%i``);
  the reference calls quality *before* nt_content (``src/stats_report.c:49-50``)
  so nt_content's integer-format file wins.  We write in the same order.
* gnuplot y-range uses the x bounds (``src/stats_report.c:626``).
* single-series plots carry an uninitialized y-title in the reference
  (``_init_report_graph`` never sets ``y_titles``); we emit an empty string.

Deviation [R1]: merged ``counter_by_pos_size`` for a k-mer with nonzero count
is defined as ``max_length - 4`` (number of window start positions in the
longest read); the reference's per-read size is not observable from the
vendored code (SURVEY §2.2).  Tie-breaks in the k-mer sort are by id
ascending (reference qsort is unstable).

PNG rendering: gnuplot when a binary exists (the reference shells out
unconditionally, ``src/stats_report.c:654-655``), otherwise a native
matplotlib-Agg renderer of the same charts (``hpgq_torch.report.charts``);
HPGQ_CHARTS=gnuplot|native|off|auto overrides.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass, field

import numpy as np

from ..core.counters import StatsCounters
from ..utils.cfmt import c_round, f32div, f32pct, fmt2f
from ..constants import KMER_K, MAX_VALUE, MIN_VALUE, NUM_KMERS


def kmer_string(i: int, k: int = KMER_K) -> str:
    """The k-mer of id ``i`` (``hpgq/oracle/spec.py:kmer_string``)."""
    s = []
    for _ in range(k):
        s.append("ACGT"[i % 4])
        i //= 4
    return "".join(reversed(s))


_HAVE_GNUPLOT = shutil.which("gnuplot") is not None


@dataclass
class ReportGraph:
    title: str = ""
    xlabel: str = ""
    ylabel: str = ""
    type: str = ""
    x_autoscale: int = 1
    x_start: int = 1
    x_end: int = 100
    y_autoscale: int = 1
    lmargin: int = 10
    rmargin: int = 4
    tmargin: int = 3
    bmargin: int = 4
    x_column: int = 0
    y_columns: list = field(default_factory=lambda: [1])
    y_titles: list = field(default_factory=list)


def _generate_gnuplot_image(graph: ReportGraph, data_filename: str, prefix: str):
    """Write ``<prefix>.gnuplot`` and render the PNG when gnuplot exists
    (mirrors ``_generate_gnuplot_image``, src/stats_report.c:591-656)."""
    gnuplot_filename = prefix + ".gnuplot"
    with open(gnuplot_filename, "w", newline="\n") as f:
        f.write("set output '%s.png'\n" % prefix)
        f.write("set terminal png nocrop enhanced font arial 10 size 640,360\n")
        f.write("set ylabel '%s'\n" % graph.ylabel)
        f.write("set xlabel '%s'\n" % graph.xlabel)
        f.write(
            "set ytics border in scale 1,0.5 mirror norotate  "
            "offset character 0, 0, 0\n"
        )
        f.write("set title '%s'\n" % graph.title)
        if graph.x_autoscale == 1:
            f.write("set autoscale x\n")
        else:
            f.write(
                "set xrange [ %i : %i ] noreverse nowriteback\n"
                % (graph.x_start, graph.x_end)
            )
        if graph.y_autoscale == 1:
            f.write("set autoscale y\n")
        else:  # reference quirk: y-range from x bounds (src/stats_report.c:626)
            f.write(
                "set yrange [ %i : %i ] noreverse nowriteback\n"
                % (graph.x_start, graph.x_end)
            )
        f.write("set lmargin '%i'\n" % graph.lmargin)
        f.write("set rmargin '%i'\n" % graph.rmargin)
        f.write("set tmargin '%i'\n" % graph.tmargin)
        f.write("set bmargin '%i'\n" % graph.bmargin)
        parts = []
        for i, ycol in enumerate(graph.y_columns):
            ytitle = graph.y_titles[i] if i < len(graph.y_titles) else ""
            parts.append(
                "%s '%s' using %i:%i title '%s' with %s"
                % ("" if i == 0 else ",", data_filename, graph.x_column, ycol,
                   ytitle, graph.type)
            )
        f.write("plot" + "".join(parts) + "\n")
    mode = os.environ.get("HPGQ_CHARTS", "auto")
    if mode == "off":
        return
    if mode != "native" and _HAVE_GNUPLOT:
        subprocess.run(["gnuplot", gnuplot_filename], check=False)
    elif mode != "gnuplot":
        from .charts import render_native

        render_native(graph, data_filename, prefix)


def sorted_kmers(counters: StatsCounters):
    """(id, string, count) list sorted by count desc, id asc [R1 tie-break]."""
    counts = counters.kmer_counts
    order = np.lexsort((np.arange(NUM_KMERS), -counts))
    return [(int(i), kmer_string(int(i)), int(counts[i])) for i in order]


def stats_report(counters: StatsCounters, opts, timing=None) -> None:
    """Write all report files (mirrors stats_report, src/stats_report.c:32-56)."""
    out_dir = opts.out_dirname
    in_filename = os.path.basename(opts.in_filename) or opts.in_filename
    if counters.num_reads == 0 and os.environ.get(
            "HPGQ_STRICT_EMPTY", "0") not in ("1", "on"):
        # zero processed reads: every mean is 0/0 — the reference would
        # printf NaNs; we emit an explicit empty summary instead.
        # HPGQ_STRICT_EMPTY=1 reproduces the reference bytes exactly
        # ("-nan" means, "Mean quality = -2147483648 [!]" from the x86
        # (int)NaN conversion — verified against compiled C, round 4)
        # through the normal writer path below.
        path = os.path.join(out_dir, in_filename + ".summary.txt")
        with open(path, "w", newline="\n") as f:
            f.write("-----------------------------------\n")
            f.write("      FastQ quality report\n")
            f.write("-----------------------------------\n")
            f.write("FastQ filename: %s\n" % in_filename)
            f.write("\n")
            f.write("Number of reads: 0\n")
            f.write("(no reads processed — empty input or nothing passed "
                    "the filter)\n")
        return
    report_summary(in_filename, counters, opts, out_dir)
    report_length(in_filename, counters, out_dir)
    report_quality(in_filename, counters, out_dir)
    report_nt_content(in_filename, counters, out_dir)
    if counters.kmers_on:
        report_kmers(in_filename, counters, out_dir)


def _normalize_quality(quality: float, phred: int) -> int:
    v = c_round(quality - phred)
    if v != v:  # NaN (0/0 means on zero-read inputs): C (int)NaN on x86
        return -(1 << 31)  # cvttsd2si indefinite value, INT_MIN
    return int(v)


def _c_char(code: int) -> str:
    """C ``%c`` of an int: printf converts via (unsigned char)."""
    return chr(code & 0xFF)


def report_summary(in_filename, counters: StatsCounters, opts, out_dir):
    path = os.path.join(out_dir, in_filename + ".summary.txt")
    c = counters
    # the reference substitutes defaults IN PLACE before reporting
    # (src/stats_fastq.c:431-444), so unset thresholds read as
    # MIN_VALUE/MAX_VALUE here and their echo lines are omitted
    crit = opts.criteria.substituted()
    with open(path, "w", newline="\n") as f:
        f.write("-----------------------------------\n")
        f.write("      FastQ quality report\n")
        f.write("-----------------------------------\n")
        num_nucleotides = c.num_nucleotides()
        f.write("FastQ filename: %s\n" % in_filename)
        f.write("\n")
        if c.filter_on:
            f.write("Filter options:\n")
            if opts.read_length_range:
                f.write("\tRead length range   : %s\n" % opts.read_length_range)
            if opts.read_quality_range:
                f.write("\tRead quality range  : %s\n" % opts.read_quality_range)
            if crit.left_length != MIN_VALUE and opts.left_quality_range:
                f.write("\tLeft length         : %i nucleotides\n" % crit.left_length)
                f.write("\tLeft quality range  : %s\n" % opts.left_quality_range)
            if crit.right_length != MIN_VALUE and opts.right_quality_range:
                f.write("\tRight length        : %i nucleotides\n" % crit.right_length)
                f.write("\tRight quality range : %s\n" % opts.right_quality_range)
            if crit.max_N != MAX_VALUE:
                f.write("\tMax. number of Ns   : %i\n" % crit.max_N)
            if crit.max_out_of_quality != MAX_VALUE and opts.read_quality_range:
                f.write(
                    "\tMax. out of quality : %i nucletotides\n" % crit.max_out_of_quality
                )
            f.write("\n")
            total = c.num_passed + c.num_failed
            f.write("Number of reads in file  : %d\n" % total)
            # C format "(%0.2f %)" — glibc prints the trailing "%)" verbatim
            f.write(
                "Number of processed reads: %d (%s %%)\n"
                % (c.num_reads, fmt2f(f32pct(c.num_reads, total)))
            )
        else:
            f.write("Filter         : Disabled\n")
            f.write("Number of reads: %d\n" % c.num_reads)
        f.write("\n")
        f.write(
            "Read length (min., mean, max.): (%i, %s, %i)\n"
            % (c.min_length, fmt2f(f32div(1.0 * c.acc_length, c.num_reads)), c.max_length)
        )
        f.write("\n")
        qual = _normalize_quality(f32div(1.0 * c.acc_quality, c.num_reads), c.phred)
        f.write("Mean quality = %i [%s]\n" % (qual, _c_char(qual + c.phred)))
        f.write("\n")
        f.write("Nucleotide content (A, C, G, T, N)\n")
        # C format "%0.2f %\n" — glibc keeps the lone "%" (see module docstring)
        for label, val in (
            ("A", c.num_As), ("T", c.num_Ts), ("G", c.num_Gs),
            ("C", c.num_Cs), ("N", c.num_Ns),
        ):
            f.write("\t%s: %s %%\n" % (label, fmt2f(f32pct(val, num_nucleotides))))
        f.write("GC content\n")
        f.write(
            "\tCG: %s %%\n"
            % fmt2f(f32pct(c.num_Gs + c.num_Cs, num_nucleotides))
        )
        f.write("\n")
        f.write("Mean quality per nucleotide position\n")
        for k in range(c.max_length):
            acc = int(c.acc_quality_per_nt[k]) if k < c.lcap else 0
            cnt = int(c.count_quality_per_nt[k]) if k < c.lcap else 0
            qual = _normalize_quality(f32div(1.0 * acc, cnt), c.phred)
            f.write("\tpos. %i: %i [%s]\t" % (k + 1, qual, _c_char(qual + c.phred)))
            if (k + 1) % 5 == 0:
                f.write("\n")
        f.write("\n")
        if c.kmers_on:
            f.write("K-mers (top 20)\n")
            f.write("\tSequence\tCount\n")
            km = sorted_kmers(c)
            for i in range(21):  # reference prints 21 rows (src/stats_report.c:147)
                f.write("\t%s\t\t%d\n" % (km[i][1], km[i][2]))


def report_length(in_filename, counters: StatsCounters, out_dir):
    c = counters
    data_filename = os.path.join(out_dir, in_filename + ".length.histogram.data")
    with open(data_filename, "w", newline="\n") as f:
        for i in range(1, c.max_length + 1):
            v = int(c.length_hist[i]) if i < c.length_hist.shape[0] else 0
            f.write("%i\t%i\n" % (i, v))
    graph = ReportGraph(
        title="Read Length Histogram",
        xlabel="Read length",
        ylabel="Number of reads",
        type="boxes",
        x_autoscale=0,
        x_start=0,
        x_end=c.max_length + 1,
        x_column=1,
        y_columns=[2],
    )
    _generate_gnuplot_image(
        graph, data_filename, os.path.join(out_dir, in_filename + ".length.histogram")
    )


def report_quality(in_filename, counters: StatsCounters, out_dir):
    c = counters
    data_filename = os.path.join(
        out_dir, in_filename + ".read.quality.histogram.data"
    )
    nz = np.flatnonzero(c.quality_hist)
    min_qual = int(nz.min()) if nz.size else 1000
    max_qual = int(nz.max()) if nz.size else 0
    with open(data_filename, "w", newline="\n") as f:
        for i in range(min_qual, max_qual + 1):
            f.write("%i\t%i\n" % (i - c.phred, int(c.quality_hist[i])))
    graph = ReportGraph(
        title="Avg. Read Quality Histogram",
        xlabel="Read Quality (Phred%i scale)" % c.phred,
        ylabel="Number of reads",
        type="boxes",
        x_autoscale=0,
        x_start=0,
        x_end=max_qual - min_qual + 5,
        x_column=1,
        y_columns=[2],
    )
    _generate_gnuplot_image(
        graph,
        data_filename,
        os.path.join(out_dir, in_filename + ".read.quality.histogram"),
    )

    # quality per nt (integer-division variant; later overwritten by
    # report_nt_content — reference call order, src/stats_report.c:49-50)
    data_filename = os.path.join(out_dir, in_filename + ".quality.per.nt.data")
    with open(data_filename, "w", newline="\n") as f:
        for k in range(c.max_length):
            acc = int(c.acc_quality_per_nt[k])
            cnt = int(c.count_quality_per_nt[k])  # > 0 for every k < max_length
            val = c_round(float(acc // cnt) - c.phred)
            f.write("%i\t%s\n" % (k, fmt2f(val)))
    graph = ReportGraph(
        title="Quality per Nucleotide Position",
        xlabel="Nucleotide position",
        ylabel="Read Quality (Phred%i scale)" % c.phred,
        type="lines",
        x_autoscale=0,
        x_start=0,
        x_end=c.max_length,
        x_column=1,
        y_columns=[2],
    )
    _generate_gnuplot_image(
        graph, data_filename, os.path.join(out_dir, in_filename + ".quality.per.nt")
    )


def report_nt_content(in_filename, counters: StatsCounters, out_dir):
    c = counters
    # GC histogram
    data_filename = os.path.join(out_dir, in_filename + ".GC.histogram.data")
    with open(data_filename, "w", newline="\n") as f:
        for i in range(1, 100):
            if c.gc_hist[i]:
                f.write("%i\t%i\n" % (i, int(c.gc_hist[i])))
    graph = ReportGraph(
        title="GC Content Histogram",
        xlabel="GC content (%)",
        ylabel="Number of reads",
        type="boxes",
        x_autoscale=0,
        x_start=0,
        x_end=100,
        x_column=1,
        y_columns=[2],
    )
    _generate_gnuplot_image(
        graph, data_filename, os.path.join(out_dir, in_filename + ".GC.histogram")
    )

    def pos_counts(k):
        a = int(c.base_per_nt[0, k])
        cc = int(c.base_per_nt[1, k])
        g = int(c.base_per_nt[2, k])
        t = int(c.base_per_nt[3, k])
        n = int(c.base_per_nt[4, k])
        return a, t, g, cc, n

    # GC per nt position
    data_filename = os.path.join(out_dir, in_filename + ".GC.per.nt.data")
    with open(data_filename, "w", newline="\n") as f:
        for k in range(c.max_length):
            a, t, g, cc, n = pos_counts(k)
            total = a + t + g + cc + n
            val = f32pct(g + cc, total)
            if val > 1.0:
                f.write("%i\t%s\n" % (k + 1, fmt2f(val)))
    graph = ReportGraph(
        title="GC Content per Nucleotide Position",
        xlabel="Nucleotide position",
        ylabel="GC content (%)",
        type="lines",
        x_autoscale=0,
        x_start=0,
        x_end=c.max_length + 1,
        x_column=1,
        y_columns=[2],
    )
    _generate_gnuplot_image(
        graph, data_filename, os.path.join(out_dir, in_filename + ".GC.per.nt")
    )

    # quality per nt (float-division variant; wins last-writer)
    data_filename = os.path.join(out_dir, in_filename + ".quality.per.nt.data")
    with open(data_filename, "w", newline="\n") as f:
        for k in range(c.max_length):
            acc = int(c.acc_quality_per_nt[k])
            cnt = int(c.count_quality_per_nt[k])
            qual = _normalize_quality(f32div(1.0 * acc, cnt), c.phred)
            f.write("%i\t%i\n" % (k, qual))
    graph = ReportGraph(
        title="Quality per Nucleotide Position",
        xlabel="Nucleotide position",
        ylabel="Quality (Phred%i scale)" % c.phred,
        type="lines",
        x_autoscale=0,
        x_start=0,
        x_end=c.max_length + 1,
        x_column=1,
        y_columns=[2],
    )
    _generate_gnuplot_image(
        graph, data_filename, os.path.join(out_dir, in_filename + ".quality.per.nt")
    )

    # nucleotide content per position
    data_filename = os.path.join(out_dir, in_filename + ".nucleotides.data")
    with open(data_filename, "w", newline="\n") as f:
        for k in range(c.max_length):
            a, t, g, cc, n = pos_counts(k)
            total = a + t + g + cc + n
            f.write(
                "%i\t%s\t%s\t%s\t%s\t%s\n"
                % (
                    k + 1,
                    fmt2f(f32pct(a, total)),
                    fmt2f(f32pct(t, total)),
                    fmt2f(f32pct(g, total)),
                    fmt2f(f32pct(cc, total)),
                    fmt2f(f32pct(n, total)),
                )
            )
    graph = ReportGraph(
        title="Nucleotide Content per Position",
        xlabel="Nucleotide position",
        ylabel="Nucleotide content (%)",
        type="lines",
        x_autoscale=0,
        x_start=0,
        x_end=c.max_length + 1,
        x_column=1,
        y_columns=[2, 3, 4, 5, 6],
        y_titles=["A %", "T %", "G %", "C %", "N %"],
    )
    _generate_gnuplot_image(
        graph, data_filename, os.path.join(out_dir, in_filename + ".nucleotides")
    )


def report_kmers(in_filename, counters: StatsCounters, out_dir):
    c = counters
    km = sorted_kmers(c)
    path = os.path.join(out_dir, in_filename + ".kmers.txt")
    with open(path, "w", newline="\n") as f:
        f.write("# Sequence\tCount\n")
        for _, s, cnt in km:
            f.write("%s\t%d\n" % (s, cnt))

    # top-5 kmers per position [R1]
    size_of = lambda cnt: (c.max_length - (KMER_K - 1)) if cnt > 0 else 0
    num_cols = max((size_of(km[i][2]) for i in range(5)), default=0)
    num_cols = max(num_cols, 0)
    data_filename = os.path.join(out_dir, in_filename + ".kmers.per.nt.data")
    with open(data_filename, "w", newline="\n") as f:
        for i in range(num_cols):
            vals = []
            for j in range(5):
                kid, _, cnt = km[j]
                # reference guard expression (src/stats_report.c:527-531)
                vals.append(
                    0 if size_of(cnt) < i else int(c.kmer_counts_by_pos[kid, i])
                )
            f.write("%i\t%d\t%d\t%d\t%d\t%d\n" % (i + 1, *vals))
    graph = ReportGraph(
        title="Relative Enrichment over Read Length",
        xlabel="Nucleotide position",
        ylabel="Number of K-mers",
        type="lines",
        x_autoscale=0,
        x_start=0,
        x_end=num_cols + 1,
        x_column=1,
        y_columns=[2, 3, 4, 5, 6],
        y_titles=[km[j][1] for j in range(5)],
    )
    _generate_gnuplot_image(
        graph, data_filename, os.path.join(out_dir, in_filename + ".kmers.per.nt")
    )
