"""hpgq_torch command-line interface: ``python -m hpgq_torch stats ...``.

The `stats` command takes ``hpgq``'s flags (the parser helpers of
``hpgq.cli.main`` are reused, so the PARAMETERS and RESULTS blocks and the
report files come out byte-for-byte as ``hpgq`` prints them) plus
``--device`` (default ``cuda``).  The other commands are not ported yet
and exit non-zero.
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
from hpgq.options import StatsOptions, display, validate_common
from hpgq.utils.timers import StageTimers

from .. import __version__

_NOT_PORTED = ("filter", "edit", "prepro", "cgr")


def usage(exec_name: str) -> str:
    return (
        "Program: %s (PyTorch/CUDA port of hpgq, FastQ QC tools)\n"
        "Version: %s\n"
        "\n"
        "Usage: %s <command> [options]\n"
        "\n"
        "Command: stats\t\tstatistics summary (--device cuda|cpu)\n"
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
    if argv[0] != "stats":
        print("%s: command %r is not ported yet (ROADMAP.md queue 1); "
              "use hpgq" % (exec_name, argv[0]), file=sys.stderr)
        return -1
    return _stats(argv[1:], exec_name)


def _stats(rest, exec_name: str) -> int:
    from ..device import resolve_device
    from ..pipeline.run import run_stats

    parser = argparse.ArgumentParser(prog="%s stats" % exec_name)
    _add_common(parser, with_encoding=True)
    parser.add_argument("--kmers", dest="kmers_on", action="store_true",
                        help="Enable k-mers analysis (5-mer; not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="Device to run on: cuda (default) or cpu")
    _add_legacy_filter_aliases(parser)
    ns = parser.parse_args(rest)
    device = resolve_device(ns.device)  # before any output: no fallback
    opts = _ns_to_opts(ns, StatsOptions)
    opts.kmers_on = ns.kmers_on
    validate_common(opts)
    display(opts)
    timers = StageTimers()
    counters = run_stats(opts, timers, device=device)
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
    _results_banner(lines)
    if opts.time_on:
        timers.report()
    logging.getLogger("hpgq").info("Done !")
    return 0


if __name__ == "__main__":
    sys.exit(main())
