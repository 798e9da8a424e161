"""hpgq_torch command-line interface: ``python -m hpgq_torch stats|filter``.

The `stats` and `filter` commands take ``hpgq``'s flags (the parser
helpers of ``hpgq.cli.main`` are reused, so the PARAMETERS and RESULTS
blocks, the report files and the FASTQ outputs come out byte-for-byte as
``hpgq`` writes them) plus ``--device`` (default ``cuda``).  The other
commands, and the legacy single-binary flags, are not ported yet and exit
non-zero.
"""

from __future__ import annotations

import argparse
import logging
import sys

from hpgq.cli.main import (
    _add_common,
    _add_legacy_filter_aliases,
    _ns_to_opts,
    _results_banner,
)
from hpgq.options import FilterOptions, StatsOptions, display, validate_common
from hpgq.utils.timers import StageTimers

from .. import __version__

_NOT_PORTED = ("edit", "prepro", "cgr")


def usage(exec_name: str) -> str:
    return (
        "Program: %s (PyTorch/CUDA port of hpgq, FastQ QC tools)\n"
        "Version: %s\n"
        "\n"
        "Usage: %s <command> [options]\n"
        "\n"
        "Command: stats\t\tstatistics summary (--device cuda|cpu)\n"
        "         filter\tfilter reads by length, quality and N count "
        "(--device cuda|cpu)\n"
        "\n"
        "Not ported yet (use hpgq): %s\n"
        % (exec_name, __version__, exec_name, ", ".join(_NOT_PORTED))
    )


def main(argv=None) -> int:
    from hpgq.io.fastq import FastqParseError

    from ..device import DeviceUnavailable

    try:
        return _main(argv)
    except (FastqParseError, DeviceUnavailable, NotImplementedError) as e:
        print("Error: %s" % e, file=sys.stderr)
        return -1


def _main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    exec_name = "hpgq_torch"
    if not argv or argv[0] in ("-h", "--help"):
        print(usage(exec_name), end="")
        return -1
    commands = {"stats": _stats, "filter": _filter}
    if argv[0] not in commands:
        print("%s: command %r is not ported yet (ROADMAP.md queue 1); "
              "use hpgq" % (exec_name, argv[0]), file=sys.stderr)
        return -1
    return commands[argv[0]](argv[1:], exec_name)


def _parse(command: str, rest, exec_name: str, options_cls):
    """Parse and validate a command's flags as ``hpgq`` does, print the
    PARAMETERS block; returns (options, device).  The device is resolved
    before anything is printed: no fallback."""
    from ..device import resolve_device

    parser = argparse.ArgumentParser(prog="%s %s" % (exec_name, command))
    _add_common(parser, with_encoding=True)
    if command == "stats":
        parser.add_argument("--kmers", dest="kmers_on", action="store_true",
                            help="Enable k-mers analysis (5-mer)")
    parser.add_argument("--device", default="cuda",
                        help="Device to run on: cuda (default) or cpu")
    _add_legacy_filter_aliases(parser)
    ns = parser.parse_args(rest)
    device = resolve_device(ns.device)
    opts = _ns_to_opts(ns, options_cls)
    if command == "stats":
        opts.kmers_on = ns.kmers_on
    validate_common(opts)
    display(opts)
    return opts, device


def _stats(rest, exec_name: str) -> int:
    from ..pipeline.run import run_stats

    opts, device = _parse("stats", rest, exec_name, StatsOptions)
    timers = StageTimers()
    result = run_stats(opts, timers, device=device)
    counters = result[0] if isinstance(result, tuple) else result
    lines = ["Report files and images were stored in '%s' directory"
             % opts.out_dirname]
    if counters.filter_on:
        lines += [
            "\nFiltering: enabled",
            "\tSo, statistics were computed for %d of %d reads."
            % (counters.num_passed, counters.num_passed + counters.num_failed),
        ]
    else:
        lines += [
            "\nFiltering: disabled",
            "\tSo, statistics were computed for the whole input file.",
        ]
    return _done(lines, opts, timers)


def _filter(rest, exec_name: str) -> int:
    from ..pipeline.run import run_filter

    opts, device = _parse("filter", rest, exec_name, FilterOptions)
    timers = StageTimers()
    res = run_filter(opts, timers, device=device)
    if opts.paired_end:
        lines = [
            "Num. passed pairs: %d (%s, %s)"
            % (res["num_passed"], res["passed_1"], res["passed_2"]),
            "Num. failed pairs: %d (%s, %s)"
            % (res["num_failed"], res["failed_1"], res["failed_2"]),
        ]
    else:
        lines = [
            "Num. passed reads: %d (%s)"
            % (res["num_passed"], res["passed_filename"]),
            "Num. failed reads: %d (%s)"
            % (res["num_failed"], res["failed_filename"]),
        ]
    return _done(lines, opts, timers)


def _done(lines, opts, timers) -> int:
    _results_banner(lines)
    if opts.time_on:
        timers.report()
    logging.getLogger("hpgq").info("Done !")
    return 0


if __name__ == "__main__":
    sys.exit(main())
