"""hpgq_torch command-line interface:
``python -m hpgq_torch stats|filter|edit|prepro|cgr``.

Every command takes ``hpgq``'s flags (the parser helpers below are copies
of ``hpgq/cli/main.py``'s, so the PARAMETERS and RESULTS blocks, the
report files, the FASTQ outputs and the PGM and ``.gs`` files come out
byte-for-byte as ``hpgq`` writes them) plus ``--device`` (default
``cuda``).  The legacy single-binary invocations (``--qc``, ``--filter``,
``--prep``, ``--cg`` and their spellings, and the combined ``--qc --cg``
and ``--qc --filter`` runs) dispatch to the commands as ``hpgq``'s do.
``--sharded`` runs a command over every local card, one rank per card
(:mod:`hpgq_torch.dist.launch`), or as one rank of a ``torchrun`` run
(:mod:`hpgq_torch.dist`).  The options are parsed and checked here, once,
before any rank starts; the RESULTS block and the ``--t`` report are
printed here, from rank 0's result.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .. import __version__
from ..options import (
    CgrOptions,
    EditOptions,
    FilterOptions,
    OptionsError,
    PreproOptions,
    StatsOptions,
    display,
    validate_common,
)
from ..utils.timers import StageTimers

# The parser helpers from here to _results_banner, and the legacy
# dispatch from _LEGACY_ACTIONS to _legacy_filter_names, are copies of
# hpgq/cli/main.py:40-42, :63-391 and :405-579.

_LOG_LEVELS = {1: logging.DEBUG, 2: logging.INFO, 3: logging.WARNING,
               4: logging.ERROR, 5: logging.CRITICAL}


def _add_common(p: argparse.ArgumentParser, with_windows=True, with_encoding=False):
    p.add_argument("-f", "--fastq-file", "--fq", "--fastq",
                   dest="in_filename",
                   help="Input file name (FastQ format; --fq/--fastq are "
                        "the legacy spellings)")
    p.add_argument("--fq1", "--fastq1", dest="in_filename1",
                   help="Paired-end input, mate 1")
    p.add_argument("--fq2", "--fastq2", dest="in_filename2",
                   help="Paired-end input, mate 2")
    p.add_argument("-o", "--outdir", dest="out_dirname",
                   help="Output directory name")
    p.add_argument("--num-threads", "--cpu-num-threads", type=int, default=2,
                   help="Number of threads")
    p.add_argument("--batch-size", type=int, default=None,
                   help="Batch size (in number of alignments; default 10000)")
    p.add_argument("--batch-list-size", type=int, default=0,
                   help="Max read batches queued ahead of the engine "
                        "(legacy knob; 0 = auto)")
    if with_encoding:
        p.add_argument("--quality-encoding", "--phred-quality",
                       dest="quality_encoding_name",
                       help="Encoding for quality scores: phred33, phred64 "
                            "(legacy --phred-quality also accepts "
                            "33/64/sanger/solexa)")
    p.add_argument("--read-length-range",
                   help="Read length range, eg. 80,110")
    p.add_argument("--read-quality-range",
                   help="Read quality range, eg. 20,40")
    p.add_argument("--left-length", type=int, default=-1,
                   help="Number of leftmost nucleotides to take into account "
                        "to filter or trim")
    p.add_argument("--left-quality-range",
                   help="Quality range for the leftmost nucleotides, eg. 15,45")
    p.add_argument("--right-length", type=int, default=-1,
                   help="Number of rightmost nucleotides to take into account "
                        "to filter or trim")
    p.add_argument("--right-quality-range",
                   help="Quality range for the rightmost nucleotides, eg. 10,60")
    p.add_argument("--max-N", type=int, default=-1, dest="max_N",
                   help="Maximum number of Ns in the sequences")
    p.add_argument("--max-out-of-quality", type=int, default=-1,
                   help="Maximum number of nucleotides out of the read quality range")
    # engine / observability knobs (new)
    p.add_argument("--t", "--time", dest="time_on", action="store_true",
                   help="Print per-stage timing report")
    p.add_argument("--log-level", type=int, default=2,
                   help="Log level 1 (debug) .. 5 (fatal)")
    p.add_argument("--v", "--verbose", dest="verbose", action="store_true",
                   help="Verbose console logging (legacy --v, "
                        "old/main_hpg_fastq_old.c:158)")
    # legacy GPU geometry knobs (old/main_hpg_fastq_old.c:159-161):
    # accepted for drop-in command-line parity, with no effect here (the
    # CUDA kernels pick their own grids; scale-out is --sharded); a value
    # logs a warning
    p.add_argument("--gpu-num-blocks", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--gpu-num-threads", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--gpu-num-devices", type=int, default=None,
                   help=argparse.SUPPRESS)
    # legacy QC quality position window (old/main_hpg_fastq_old.c:
    # 100-101,148-149; defaults 0/1024 = whole read; the usage banner
    # spells it --begin-quality-nt, the getopt table --start-quality-nt —
    # both accepted).  Reconstructed semantics [D8], see PARITY.md: the
    # mean-quality and out-of-quality screens evaluate positions
    # [begin, end) only.
    p.add_argument("--start-quality-nt", "--begin-quality-nt", type=int,
                   default=0,
                   help="First nucleotide (0-based) of the quality screen "
                        "window (legacy; default 0)")
    p.add_argument("--end-quality-nt", type=int, default=1024,
                   help="One past the last nucleotide of the quality screen "
                        "window (legacy; default 1024)")
    p.add_argument("--log-file", default=None, help="Log file path")
    p.add_argument("--conf", default=None,
                   help="key=value option file; file overrides command line")
    p.add_argument("--device-batch-reads", type=int, default=0,
                   help="Device batch rows (0 = auto from --batch-size)")
    p.add_argument("--checkpoint", dest="checkpoint_path", default=None,
                   help="Checkpoint file for resumable streaming")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="Batches between checkpoints (0 = off)")
    p.add_argument("--profile-dir", default=None,
                   help="Write a torch.profiler Chrome trace of the run "
                        "(stats, filter, edit, prepro; host operators and, "
                        "on CUDA, the card's kernels) into this directory")
    p.add_argument("--sharded", action="store_true",
                   help="Data-parallel over every local card, one process "
                        "per card (CUDA_VISIBLE_DEVICES narrows them); "
                        "under torchrun (RANK and WORLD_SIZE set) this "
                        "process is one rank of that run.  Each rank reads "
                        "its own part of the input and rank 0 writes the "
                        "outputs; every command, single- and paired-end")
    p.add_argument("--no-pallas", dest="use_pallas", action="store_false",
                   help="No effect in hpgq_torch (accepted for hpgq's "
                        "command lines): CUDA runs the K1/K2 kernels, the "
                        "CPU their plain twin")


def _parse_conf(path: str) -> dict:
    """Legacy ``--conf`` support: ``key = value ;`` / ``key=value`` lines
    (``old/hpg-fastq.conf``); flags may appear alone on a line."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(";").strip()
            if not line or line.startswith("#") or line.endswith("{") or line == "};":
                continue
            if line.endswith(":"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                out[k.strip().lstrip("-")] = v.strip().strip('"')
            else:
                out[line.lstrip("-")] = True
    return out


def _apply_conf(ns: argparse.Namespace, conf: dict):
    """File overrides command line (old/README:63-64)."""
    mapping = {
        "outdir": "out_dirname",
        "fastq-file": "in_filename",
        "fq": "in_filename",
        "fastq": "in_filename",
        "fq1": "in_filename1",
        "fq2": "in_filename2",
        "num-threads": "num_threads",
        "cpu-num-threads": "num_threads",
        "batch-size": "batch_size",
        "batch-list-size": "batch_list_size",
        "quality-encoding": "quality_encoding_name",
        "read-length-range": "read_length_range",
        "read-quality-range": "read_quality_range",
        "left-length": "left_length",
        "left-quality-range": "left_quality_range",
        "right-length": "right_length",
        "right-quality-range": "right_quality_range",
        "max-N": "max_N",
        "max-out-of-quality": "max_out_of_quality",
        "kmers": "kmers_on",
        "k": "k",
        "gs-filename": "gs_filename",
        "log-level": "log_level",
        "log-file": "log_file",
        "t": "time_on",
        "time": "time_on",
        # legacy prepro/filter keys (old/README:84-142): prepro uses the
        # plain dests, stats/filter/edit carry the lg_ alias dests — first
        # present attribute wins
        "ltrim-nts": "ltrim_nts",
        "rtrim-nts": "rtrim_nts",
        "min-quality": ("min_quality", "lg_min_quality"),
        "max-quality": ("max_quality", "lg_max_quality"),
        "phred-quality": "quality_encoding_name",
        "min-read-length": ("min_read_length", "lg_min_read_length"),
        "max-read-length": ("lg_max_read_length",),
        "max-n-per-read": ("lg_max_n_per_read",),
        "max-nts-mismatch": ("lg_max_nts_mismatch",),
        "lfilter-nts": ("lg_lfilter_nts",),
        "rfilter-nts": ("lg_rfilter_nts",),
        "start-quality-nt": "start_quality_nt",
        "begin-quality-nt": "start_quality_nt",
        "end-quality-nt": "end_quality_nt",
    }
    for key, val in conf.items():
        attrs = mapping.get(key)
        if attrs is None:
            continue
        if isinstance(attrs, str):
            attrs = (attrs,)
        attr = next((a for a in attrs if hasattr(ns, a)), None)
        if attr is None:
            continue
        cur = getattr(ns, attr)
        if isinstance(cur, bool) or val is True:
            # libconfig-style booleans: a bare key or truthy word enables,
            # false/0/off/no disables (bool("false") would enable!)
            setattr(ns, attr, str(val).strip().lower()
                    not in ("false", "0", "off", "no"))
        elif isinstance(cur, int) or (cur is None and str(val).lstrip("-").isdigit()):
            try:
                setattr(ns, attr, int(val))
            except ValueError:
                setattr(ns, attr, val)
        else:
            setattr(ns, attr, val)


def _ns_to_opts(ns: argparse.Namespace, cls):
    opts = cls()
    if ns.conf:
        _apply_conf(ns, _parse_conf(ns.conf))
    if hasattr(ns, "lg_min_quality"):
        # AFTER the conf (file overrides command line) so conf-set legacy
        # keys participate in the translation
        _apply_legacy_filter_flags(ns)
    if getattr(ns, "in_filename2", None) and not getattr(ns, "in_filename1",
                                                         None):
        raise OptionsError(
            "Both pair ends files are mandatory, use both --fastq1 and "
            "--fastq2 options"
        )
    if getattr(ns, "in_filename1", None) and not ns.in_filename:
        opts.in_filename = ns.in_filename1
        opts.in_filename2 = ns.in_filename2
        if not ns.in_filename2:
            raise OptionsError(
                "Both pair ends files are mandatory, use both --fastq1 and "
                "--fastq2 options"
            )
    else:
        opts.in_filename = ns.in_filename
        if ns.in_filename and (
            getattr(ns, "in_filename1", None) or getattr(ns, "in_filename2", None)
        ):
            raise OptionsError(
                "single-end and paired-end options are exclusive, use --fastq "
                "OR --fastq1/--fastq2 options, not both"
            )
    opts.out_dirname = ns.out_dirname
    opts.num_threads = ns.num_threads
    if ns.num_threads:
        from ..io.packer import set_num_threads

        set_num_threads(ns.num_threads)
    if ns.batch_size is not None:  # flag presence gates the auto reader batch
        opts.batch_size = int(ns.batch_size)
        opts.batch_size_set = True
    opts.batch_list_size = ns.batch_list_size
    opts.quality_encoding_name = getattr(ns, "quality_encoding_name", None)
    opts.read_length_range = ns.read_length_range
    opts.read_quality_range = ns.read_quality_range
    opts.left_quality_range = ns.left_quality_range
    opts.right_quality_range = ns.right_quality_range
    opts.criteria.left_length = ns.left_length
    opts.criteria.right_length = ns.right_length
    opts.criteria.max_N = ns.max_N
    opts.criteria.max_out_of_quality = ns.max_out_of_quality
    opts.time_on = ns.time_on
    opts.log_level = ns.log_level
    opts.device_batch_reads = ns.device_batch_reads
    opts.checkpoint_path = ns.checkpoint_path
    opts.checkpoint_every = ns.checkpoint_every
    opts.profile_dir = ns.profile_dir
    opts.use_pallas = ns.use_pallas
    opts.sharded = getattr(ns, "sharded", False)

    begin_nt = getattr(ns, "start_quality_nt", 0)
    end_nt = getattr(ns, "end_quality_nt", 1024)
    if begin_nt < 0 or end_nt < 0:
        raise OptionsError(
            "\nError: --start-quality-nt/--end-quality-nt must not be "
            "negative"
        )
    opts.criteria.begin_quality_nt = begin_nt
    opts.criteria.end_quality_nt = end_nt

    logging.basicConfig(
        filename=ns.log_file or "hpg-fastq.log",
        filemode="w",
        level=_LOG_LEVELS.get(ns.log_level, logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if getattr(ns, "verbose", False):
        # legacy --v mirrors logging to the console (log_verbose global,
        # src/hpg-fastq.c:39-41)
        logging.getLogger().addHandler(logging.StreamHandler())
    for knob in ("gpu_num_blocks", "gpu_num_threads", "gpu_num_devices"):
        if getattr(ns, knob, None) is not None:
            logging.getLogger("hpgq").warning(
                "--%s has no effect in hpgq_torch (scale-out is --sharded)",
                knob.replace("_", "-"),
            )
    return opts


def _add_legacy_filter_aliases(parser) -> None:
    """Register the legacy getopt filter-flag spellings
    (old/README:121-142) — on stats, filter, AND edit, like the legacy
    single binary, whose getopt table was shared across actions
    (old/main_hpg_fastq_old.c:131-192).  Translated onto the modern range
    strings in ``_apply_legacy_filter_flags`` so display/validation see
    one form."""
    for legacy in ("--min-read-length", "--max-read-length",
                   "--max-n-per-read", "--max-nts-mismatch",
                   "--lfilter-nts", "--rfilter-nts",
                   "--min-quality", "--max-quality"):
        parser.add_argument(legacy, type=int, default=None,
                            dest="lg_" + legacy[2:].replace("-", "_"),
                            help="Legacy alias (see MIGRATION.md)")


def _apply_legacy_filter_flags(ns) -> None:
    """Map the legacy getopt filter flags (old/README:121-142) onto the
    modern range-string options, which display/validate/parse as usual.
    Modern flags win when both forms are given; legacy quality bounds are
    clamped like the legacy parser (>=10 / <=70,
    old/main_hpg_fastq_old.c:289-305)."""

    def rng(lo, hi):
        return "%s,%s" % ("" if lo is None else lo, "" if hi is None else hi)

    lmin, lmax = ns.lg_min_read_length, ns.lg_max_read_length
    if (lmin is not None or lmax is not None) and not ns.read_length_range:
        ns.read_length_range = rng(lmin, lmax)
    qmin, qmax = ns.lg_min_quality, ns.lg_max_quality
    if qmin is not None:
        qmin = max(qmin, 10)
    if qmax is not None:
        qmax = min(qmax, 70)
    if (qmin is not None or qmax is not None) and not ns.read_quality_range:
        ns.read_quality_range = rng(qmin, qmax)
    if ns.lg_max_n_per_read is not None and ns.max_N < 0:
        ns.max_N = ns.lg_max_n_per_read
    if ns.lg_max_nts_mismatch is not None and ns.max_out_of_quality < 0:
        ns.max_out_of_quality = ns.lg_max_nts_mismatch
    # window screens: legacy reuses min/max-quality as the window bounds,
    # falling back to its defaults 20,60 (old/main_hpg_fastq_old.c:96-97)
    wrange = rng(20 if qmin is None else qmin, 60 if qmax is None else qmax)
    if ns.lg_lfilter_nts is not None and ns.left_length < 0:
        ns.left_length = ns.lg_lfilter_nts
        if not ns.left_quality_range:
            ns.left_quality_range = wrange
    if ns.lg_rfilter_nts is not None and ns.right_length < 0:
        ns.right_length = ns.lg_rfilter_nts
        if not ns.right_quality_range:
            ns.right_quality_range = wrange


def _results_banner(lines):
    print("\n")
    print("RESULTS")
    print("=================================================")
    for line in lines:
        print(line)
    print("=================================================")



def usage(exec_name: str) -> str:
    return (
        "Program: %s (PyTorch/CUDA port of hpgq, FastQ QC tools)\n"
        "Version: %s\n"
        "\n"
        "Usage: %s <command> [options]\n"
        "\n"
        "Command: stats\t\tstatistics summary\n"
        "         filter\tfilter reads by length, quality and N count\n"
        "         edit\t\ttrim read ends by window quality\n"
        "         prepro\tlegacy preprocessing (trims, <input>.valid)\n"
        "         cgr\t\tchaos-game genomic signature\n"
        "\n"
        "Every command takes --device cuda (default) or --device cpu, and\n"
        "--sharded for one process per local card over torch.distributed.\n"
        "The legacy single-binary flags (--qc, --filter, --prep, --cg) run\n"
        "as in hpgq.\n"
        % (exec_name, __version__, exec_name)
    )


def main(argv=None) -> int:
    from ..io.fastq import FastqParseError

    from ..device import DeviceUnavailable

    from ..dist.launch import RankFailed
    from ..dist.mesh import leave_group

    try:
        return _main(argv)
    except (FastqParseError, DeviceUnavailable, NotImplementedError) as e:
        print("Error: %s" % e, file=sys.stderr)
        return -1
    except RankFailed as e:  # the rank printed its own error
        print("Error: %s" % e, file=sys.stderr)
        return e.exitcode
    finally:
        leave_group()


# legacy single-binary action flags (old/main_hpg_fastq_old.c:131-192) →
# subcommands.  --qc together with --cg/--chaos-game runs both (the legacy
# note: "Chaos Game ... must be launched together with Quality Control",
# old/README:177).
_LEGACY_ACTIONS = {"--qc": "stats", "--quality-control": "stats",
                   "--filter": "filter", "--prep": "prepro",
                   "--preprocessing": "prepro", "--cg": "cgr",
                   "--chaos-game": "cgr"}
_VALUE_FLAGS = {"--k", "--gs-filename"}  # cgr-only flags that take a value
# every filter-criteria flag (modern + legacy), all value-taking — stripped
# from the stats legs of the legacy --qc --filter combined run so the
# per-output stats don't re-filter
_CRITERIA_FLAGS = {
    "--read-length-range", "--read-quality-range", "--left-length",
    "--left-quality-range", "--right-length", "--right-quality-range",
    "--max-N", "--max-out-of-quality", "--min-read-length",
    "--max-read-length", "--max-n-per-read", "--max-nts-mismatch",
    "--lfilter-nts", "--rfilter-nts", "--min-quality", "--max-quality",
}


def _strip_flags(args, drop_flags, drop_value_flags=()):
    out, skip = [], False
    for a in args:
        if skip:
            skip = False
            continue
        if a in drop_value_flags:
            skip = True
            continue
        if a in drop_flags:
            continue
        out.append(a)
    return out


def _legacy_main(argv, exec_name: str) -> int:
    """Dispatch a legacy-style invocation (action flags, no subcommand):
    ``hpg-fastq --filter --fq in.fq --outdir out ...``."""
    # normalize the argparse-legal '--flag=value' form into two tokens so
    # the action/criteria/outdir/batch-size argv scans below see every
    # spelling (argparse downstream accepts both forms either way)
    norm = []
    for a in argv:
        if a.startswith("--") and "=" in a:
            flag, val = a.split("=", 1)
            norm += [flag, val]
        else:
            norm.append(a)
    argv = norm
    kinds = []
    for a in argv:
        k = _LEGACY_ACTIONS.get(a)
        if k and k not in kinds:
            kinds.append(k)
    rest = [a for a in argv if a not in _LEGACY_ACTIONS]
    # legacy --batch-size is in BYTES (default 64 MB, old/README:56); the
    # modern flag counts reads.  In legacy dispatch, large values are
    # clearly bytes — convert at ~250 B per short record.
    for i, a in enumerate(rest):
        if a == "--batch-size" and i + 1 < len(rest):
            try:
                v = int(rest[i + 1])
            except ValueError:
                break
            if v > 1_000_000:
                rest[i + 1] = str(max(10000, v // 250))
                logging.getLogger("hpgq").info(
                    "legacy --batch-size %d bytes -> %s reads", v, rest[i + 1]
                )
    if sorted(kinds) == ["cgr", "stats"]:
        rc = _dispatch("stats", _strip_flags(rest, ("--write-gs",),
                                             _VALUE_FLAGS), exec_name)
        if rc != 0:
            return rc
        return _dispatch("cgr", _strip_flags(rest, ("--kmers",)), exec_name)
    if sorted(kinds) == ["filter", "stats"]:
        # legacy combined run: "quality control statistics are provided
        # both over the .valid and .invalid file" (old/README:144) —
        # filter first, then stats over each output set
        rc = _dispatch("filter", _strip_flags(rest, ("--kmers",)), exec_name,
                       legacy=True)
        if rc != 0:
            return rc
        outdir = "."
        conf_path = None
        for i, a in enumerate(rest):
            if a in ("-o", "--outdir") and i + 1 < len(rest):
                outdir = rest[i + 1]
            elif a == "--conf" and i + 1 < len(rest):
                conf_path = rest[i + 1]
        if conf_path:
            try:
                cf = _parse_conf(conf_path)
            except OSError:
                cf = {}
            if isinstance(cf.get("outdir"), str):
                outdir = cf["outdir"]  # file overrides CLI
        names = _legacy_filter_names(_argv_inputs(rest))
        # the stats legs run over the filter outputs: strip the inputs,
        # every criteria flag, AND the conf file — its input/criteria keys
        # would override the legs' argv right back (file-overrides-CLI)
        base = _strip_flags(
            rest, (),
            _CRITERIA_FLAGS | {"-f", "--fastq-file", "--fq", "--fastq",
                               "--fq1", "--fastq1", "--fq2", "--fastq2",
                               "--conf"},
        )
        # (valid set, invalid set): names order is (p1, p2, f1, f2) paired
        # or (p, f) single
        h = len(names) // 2
        for group in (names[:h], names[h:]):
            paths = [os.path.join(outdir, n) for n in group]
            in_flags = (["-f", paths[0]] if len(paths) == 1
                        else ["--fq1", paths[0], "--fq2", paths[1]])
            rc = _dispatch("stats", base + in_flags, exec_name)
            if rc != 0:
                return rc
        return 0
    if len(kinds) != 1:
        print(usage(exec_name), end="")
        print("Error: legacy action flags %s are not supported together; "
              "run the subcommands separately (see MIGRATION.md)"
              % (kinds or "(none)"), file=sys.stderr)
        return -1
    if kinds[0] == "cgr":
        rest = _strip_flags(rest, ("--kmers",))
    return _dispatch(kinds[0], rest, exec_name, legacy=True)


def _argv_inputs(argv) -> tuple:
    """(in1, in2) input paths scanned from a (normalized) legacy argv,
    honoring a ``--conf`` file's input keys (file overrides command line,
    old/README:63-64) so the combined --qc --filter run derives the same
    .valid/.invalid names the filter dispatch actually wrote."""
    in1 = in2 = None
    conf_path = None
    for i, a in enumerate(argv):
        if i + 1 >= len(argv):
            break
        if a in ("-f", "--fastq-file", "--fq", "--fastq", "--fq1", "--fastq1"):
            in1 = argv[i + 1]
        elif a in ("--fq2", "--fastq2"):
            in2 = argv[i + 1]
        elif a == "--conf":
            conf_path = argv[i + 1]
    if conf_path:
        try:
            conf = _parse_conf(conf_path)
        except OSError:
            conf = {}
        for key in ("fastq-file", "fq", "fastq", "fq1"):
            if isinstance(conf.get(key), str):
                in1 = conf[key]
        if isinstance(conf.get("fq2"), str):
            in2 = conf["fq2"]
    return in1, in2


def _legacy_filter_names(inputs) -> tuple:
    """Legacy ``--filter`` output names — ``<input>.valid``/``.invalid``
    per input file (old/README:126-131).  Returns (p, f) single-end or
    (p1, p2, f1, f2) paired, matching ``FilterOptions.out_names``."""
    in1, in2 = inputs
    b1 = os.path.basename(in1 or "in.fq")
    if in2 is None:
        return (b1 + ".valid", b1 + ".invalid")
    b2 = os.path.basename(in2)
    if b1 == b2:  # same basename from different dirs
        b1, b2 = b1 + "_1", b2 + "_2"
    return (b1 + ".valid", b2 + ".valid", b1 + ".invalid", b2 + ".invalid")


def _main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    exec_name = "hpgq_torch"
    if not argv or argv[0] in ("-h", "--help"):
        print(usage(exec_name), end="")
        return -1
    if argv[0].startswith("-") and any(a in _LEGACY_ACTIONS for a in argv):
        return _legacy_main(argv, exec_name)
    return _dispatch(argv[0], argv[1:], exec_name)


def _dispatch(command: str, rest, exec_name: str, legacy: bool = False) -> int:
    """Run one command; ``legacy`` (a single-binary invocation) gives
    `filter` the ``<input>.valid``/``.invalid`` names
    (``hpgq/cli/main.py:596-641``)."""
    commands = {"stats": _stats, "filter": _filter, "edit": _edit,
                "prepro": _prepro, "cgr": _cgr}
    if command not in commands:
        print(usage(exec_name), end="")
        return -1
    return commands[command](rest, exec_name, legacy)


def _add_command_args(parser, command: str) -> None:
    """The flags of one command beyond the common ones
    (``hpgq/cli/main.py:596-781``)."""
    if command == "stats":
        parser.add_argument("--kmers", dest="kmers_on", action="store_true",
                            help="Enable k-mers analysis (5-mer)")
    if command in ("stats", "filter", "edit"):
        _add_legacy_filter_aliases(parser)
    if command == "prepro":
        parser.add_argument("--ltrim-nts", type=int, default=0,
                            help="Number of left (first) nucleotides to screen")
        parser.add_argument("--rtrim-nts", type=int, default=0,
                            help="Number of right (last) nucleotides to screen")
        parser.add_argument("--min-quality", type=int, default=20,
                            help="Minimum accepted window quality (clamped to >=10)")
        parser.add_argument("--max-quality", type=int, default=60,
                            help="Maximum accepted window quality (clamped to <=70)")
        parser.add_argument("--min-read-length", type=int, default=50,
                            help="Used by the trim-length sanity check "
                                 "(trims must be at most 1/4 of it)")
    if command == "cgr":
        parser.add_argument("--k", type=int, default=7,
                            help="Word size of the Chaos Game (default 7)")
        parser.add_argument("--gs-filename", default=None,
                            help="Reference genomic-signature file for the given k")
        parser.add_argument("--write-gs", action="store_true",
                            help="Also write this file's signature in .gs format")


def _command_opts(command: str, ns, opts) -> None:
    """Copy a command's own flags into its options, before validation
    (``hpgq/cli/main.py:605``, ``:716-728``, ``:763-765``)."""
    if command == "stats":
        opts.kmers_on = ns.kmers_on
    elif command == "prepro":
        opts.min_quality, opts.max_quality = ns.min_quality, ns.max_quality
        opts.ltrim_nts, opts.rtrim_nts = ns.ltrim_nts, ns.rtrim_nts
        # the 1/4 rule (old/main_hpg_fastq_old.c:680-690), CLI only, like
        # the legacy getopt validation
        for flag, v in (("--rtrim-nts", ns.rtrim_nts),
                        ("--ltrim-nts", ns.ltrim_nts)):
            if v > ns.min_read_length // 4:
                raise OptionsError(
                    "%s must be at most 1/4 the value of min_read_length" % flag
                )
        opts.apply_trim_windows()
    elif command == "cgr":
        opts.k = ns.k
        opts.gs_filename = ns.gs_filename
        opts.write_gs = ns.write_gs


def _parse(command: str, rest, exec_name: str, options_cls,
           legacy: bool = False):
    """Parse and validate a command's flags as ``hpgq`` does, print the
    PARAMETERS block; returns (options, device).  The device is resolved
    before anything is printed: no fallback."""
    from ..device import resolve_device

    parser = argparse.ArgumentParser(prog="%s %s" % (exec_name, command))
    _add_common(parser, with_encoding=True)
    _add_command_args(parser, command)
    parser.add_argument("--device", default="cuda",
                        help="Device to run on: cuda (default) or cpu")
    ns = parser.parse_args(rest)
    device = resolve_device(ns.device)
    opts = _ns_to_opts(ns, options_cls)
    _command_opts(command, ns, opts)
    if legacy and command == "filter":
        # legacy single-binary --filter wrote <input>.valid/.invalid per
        # input file (old/README:126-131)
        opts.out_names = _legacy_filter_names(
            (opts.in_filename, opts.in_filename2))
    validate_common(opts)
    display(opts)
    return opts, device


def _run(opts, timers, device, runner, sharded_runner):
    """``runner`` in this process, or with ``--sharded`` ``sharded_runner``
    over the ranks that :func:`~hpgq_torch.dist.launch.run_sharded`
    starts."""
    if not opts.sharded:
        return runner(opts, timers, device=device)
    from ..dist.launch import run_sharded

    return run_sharded(sharded_runner, opts, timers, device)


def _stats(rest, exec_name: str, legacy: bool = False) -> int:
    from ..dist.run_dist import run_stats_sharded
    from ..pipeline.run import run_stats

    opts, device = _parse("stats", rest, exec_name, StatsOptions)
    timers = StageTimers()
    result = _run(opts, timers, device, run_stats, run_stats_sharded)
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


def _filter(rest, exec_name: str, legacy: bool = False) -> int:
    from ..dist.run_dist import run_filter_sharded
    from ..pipeline.run import run_filter

    opts, device = _parse("filter", rest, exec_name, FilterOptions, legacy)
    timers = StageTimers()
    res = _run(opts, timers, device, run_filter, run_filter_sharded)
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


def _edit(rest, exec_name: str, legacy: bool = False) -> int:
    from ..dist.run_dist import run_edit_sharded
    from ..pipeline.run import run_edit

    opts, device = _parse("edit", rest, exec_name, EditOptions)
    timers = StageTimers()
    res = _run(opts, timers, device, run_edit, run_edit_sharded)
    lines = ["Num. edited reads : %d" % res["num_edited"]]
    if opts.paired_end:
        lines.append("Output files      : %s, %s"
                     % (res["edit_1"], res["edit_2"]))
        if opts.filter_on:
            lines += [
                "\nFiltering : Enabled",
                "\tNum. passed pairs : %d" % res["num_passed"],
                "\tNum. failed pairs : %d" % res["num_failed"],
            ]
    else:
        lines.append("Output file       : %s" % res["edit_filename"])
        if opts.filter_on:
            lines += [
                "\nFiltering : Enabled",
                "\tNum. passed reads : %d (%s)"
                % (res["num_passed"], res["edit_filename"]),
                "\tNum. failed reads : %d (%s)"
                % (res["num_failed"], res["failed_filename"]),
            ]
    return _done(lines, opts, timers)


def _prepro(rest, exec_name: str, legacy: bool = False) -> int:
    from ..dist.run_dist import run_edit_sharded
    from ..pipeline.run import run_edit

    opts, device = _parse("prepro", rest, exec_name, PreproOptions)
    timers = StageTimers()
    res = _run(opts, timers, device, run_edit, run_edit_sharded)
    lines = ["Num. preprocessed reads : %d" % res["num_edited"]]
    if opts.paired_end:
        lines.append("Output files            : %s, %s"
                     % (res["edit_1"], res["edit_2"]))
    else:
        lines.append("Output file             : %s" % res["edit_filename"])
    if opts.filter_on:
        lines += [
            "\nFiltering : Enabled",
            "\tNum. passed reads : %d" % res["num_passed"],
            "\tNum. failed reads : %d" % res["num_failed"],
        ]
    return _done(lines, opts, timers)


def _cgr(rest, exec_name: str, legacy: bool = False) -> int:
    from ..pipeline.cgr_run import run_cgr  # routes --sharded itself

    opts, device = _parse("cgr", rest, exec_name, CgrOptions)
    timers = StageTimers()
    res = run_cgr(opts, timers, device=device)
    lines = ["Words read: %d" % res["fq_word_count"]]
    lines += ["PGM: %s" % p for p in res["pgm_files"]]
    if res.get("mean_dif") is not None:
        lines += [
            "Diff matrix mean   : %0.6f" % res["mean_dif"],
            "Diff matrix stddev : %0.6f" % res["std_dif"],
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
