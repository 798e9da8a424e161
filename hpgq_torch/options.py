"""The port's own copy of ``hpgq/options.py`` (the port imports nothing of
``hpgq``); kept equal to it, so the
PARAMETERS block and the checkpoint keys match ``hpgq``'s.

Options layer: per-command option structs, range parsing, validation, display.

Flag-compatible with the reference's argtable definitions
(``src/stats_options.c:262-287``, ``src/filter_options.c:235-258``,
``src/edit_options.c:267-290``) plus the legacy paired-end / chaos-game flags
(``old/main_hpg_fastq_old.c:131-192``).

``parse_range`` replicates ``src/commons_fastq.c:31-103`` including its error
messages; thresholds left unset stay ``NO_VALUE`` and are substituted with
``MIN_VALUE``/``MAX_VALUE`` at pipeline start exactly like the reference
(``src/filter_fastq.c:195-206``).

Reconstructed-contract note (the compute submodules are not vendored in the
reference): quality thresholds (``--read-quality-range`` etc., e.g. "20,40")
are interpreted on the *Phred scale*, i.e. compared against raw ASCII quality
minus the phred offset.  Evidence: the legacy engine de-normalizes CLI
qualities by adding ``base_quality`` before comparing raw bytes
(``old/main_hpg_fastq_old.c:605-607``), and the documented example thresholds
(20..60) only make sense post-offset.  Commands without a
``--quality-encoding`` flag use phred33, like the legacy default.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys
from typing import Optional

from .constants import (
    DEFAULT_BATCH_SIZE,
    DEFAULT_CGR_K,
    DEFAULT_NUM_THREADS,
    MAX_VALUE,
    MIN_VALUE,
    NO_VALUE,
    PHRED33,
    QUALITY_ENCODINGS,
)


class OptionsError(SystemExit):
    """Raised (as SystemExit, like the reference's exit(-1)) on bad options."""

    def __init__(self, message: str = ""):
        if message:
            import sys

            print(message, file=sys.stderr)
        super().__init__(-1)


def parse_range(range_str: Optional[str], msg: str):
    """Parse a ``"min,max"`` range string; either side may be omitted.

    Returns ``(min, max)`` with ``NO_VALUE`` for unset sides.  Mirrors
    ``parse_range`` at ``src/commons_fastq.c:31-103`` (error messages
    included).  Raises OptionsError on invalid input.
    """
    if not range_str:
        return NO_VALUE, NO_VALUE

    def _scan_int(s: str, which: str) -> int:
        # C sscanf("%d"): leading whitespace + signed integer PREFIX —
        # trailing garbage is accepted and ignored ("80x" parses as 80),
        # so inputs the reference tool accepts must parse here too.
        # (A literal "-1" scans to NO_VALUE and is therefore treated as
        # unset — the reference's own sentinel collision, commons_fastq.h:21.)
        m = re.match(r"\s*[+-]?\d+", s)
        if not m:
            _fail(which)
        return int(m.group())

    def _fail(which: str):
        raise OptionsError(
            "\nError: Invalid %s value in the %s (%s)" % (which, msg, range_str)
        )

    if "," in range_str:
        left, right = range_str.split(",", 1)
        lmax = NO_VALUE if len(right) == 0 else _scan_int(right, "maximum")
        lmin = NO_VALUE if left == "" else _scan_int(left, "minimum")
    else:
        lmin = _scan_int(range_str, "minimum")
        lmax = NO_VALUE

    if lmin != NO_VALUE and lmin < 0:
        raise OptionsError(
            "\nError: Invalid %s (%s). Minimum value (%i) must be greater than 0"
            % (msg, range_str, lmin)
        )
    if lmax != NO_VALUE and lmax < 0:
        raise OptionsError(
            "\nError: Invalid %s (%s). Maximum value (%i) must be greater than 0"
            % (msg, range_str, lmax)
        )
    if lmin != NO_VALUE and lmax != NO_VALUE and lmin > lmax:
        raise OptionsError(
            "\nError: Invalid %s (%s). Maximum value (%i) must be greater than "
            "minimum value (%i)" % (msg, range_str, lmax, lmin)
        )
    return lmin, lmax


@dataclasses.dataclass
class FilterCriteria:
    """The 12 thresholds of ``fastq_filter_options_new``.

    Constructor order in the reference: (min_len, max_len, min_q, max_q,
    max_out_q, left_len, min_left_q, max_left_q, right_len, min_right_q,
    max_right_q, max_N) — ``src/filter_fastq.c:140-145``.
    """

    min_read_length: int = NO_VALUE
    max_read_length: int = NO_VALUE
    min_read_quality: int = NO_VALUE
    max_read_quality: int = NO_VALUE
    max_out_of_quality: int = NO_VALUE
    left_length: int = NO_VALUE
    min_left_quality: int = NO_VALUE
    max_left_quality: int = NO_VALUE
    right_length: int = NO_VALUE
    min_right_quality: int = NO_VALUE
    max_right_quality: int = NO_VALUE
    max_N: int = NO_VALUE
    # Legacy QC quality position window [begin, end), 0-based nucleotide
    # indices (``--start-quality-nt``/``--end-quality-nt``,
    # ``old/main_hpg_fastq_old.c:100-101,148-149``; defaults 0/1024 = whole
    # read).  Reconstructed contract [D8]: when non-default, the two
    # quality screens (mean read quality + out-of-quality nt count)
    # evaluate only positions in the window intersected with the read;
    # an empty intersection passes those screens vacuously.  The legacy
    # consuming kernel is not vendored in the reference — see PARITY.md.
    begin_quality_nt: int = 0
    end_quality_nt: int = 1024

    @property
    def quality_window_on(self) -> bool:
        return self.begin_quality_nt != 0 or self.end_quality_nt != 1024

    def substituted(self) -> "FilterCriteria":
        """Default substitution, as in ``src/filter_fastq.c:195-206``."""

        def lo(v):
            return MIN_VALUE if v == NO_VALUE else v

        def hi(v):
            return MAX_VALUE if v == NO_VALUE else v

        return FilterCriteria(
            min_read_length=lo(self.min_read_length),
            max_read_length=hi(self.max_read_length),
            min_read_quality=lo(self.min_read_quality),
            max_read_quality=hi(self.max_read_quality),
            max_out_of_quality=hi(self.max_out_of_quality),
            left_length=lo(self.left_length),
            min_left_quality=lo(self.min_left_quality),
            max_left_quality=hi(self.max_left_quality),
            right_length=lo(self.right_length),
            min_right_quality=lo(self.min_right_quality),
            max_right_quality=hi(self.max_right_quality),
            max_N=hi(self.max_N),
            # clamp to >=0: every consumer (oracle slice, mask kernels,
            # the blockwise kernel's analytic width) assumes non-negative
            # positions — a negative begin would mean from-the-end in the
            # oracle's python slice but position 0 in the mask kernels
            begin_quality_nt=max(self.begin_quality_nt, 0),
            end_quality_nt=max(self.end_quality_nt, 0),
        )

    def without_windows(self) -> "FilterCriteria":
        """Window criteria disabled — the edit post-filter shape
        (``src/edit_fastq.c:159-164`` passes MIN/MIN/MAX for left & right)."""
        return dataclasses.replace(
            self,
            left_length=MIN_VALUE,
            min_left_quality=MIN_VALUE,
            max_left_quality=MAX_VALUE,
            right_length=MIN_VALUE,
            min_right_quality=MIN_VALUE,
            max_right_quality=MAX_VALUE,
        )


@dataclasses.dataclass
class CommandOptions:
    """Common options shared by all commands (reference option tables §2)."""

    command_name: str = ""
    exec_name: str = "hpgq"
    in_filename: Optional[str] = None
    in_filename2: Optional[str] = None  # paired-end mate 2 (legacy --fastq2)
    out_dirname: Optional[str] = None
    num_threads: int = DEFAULT_NUM_THREADS
    batch_size: int = DEFAULT_BATCH_SIZE
    # True when --batch-size was explicitly passed (the CLI tracks flag
    # presence); gates the accelerator auto reader-block upgrade so an
    # explicit 10000 is honored (pipeline.run._reader_batch)
    batch_size_set: bool = False
    # legacy --batch-list-size (old/README:57): how many read batches may be
    # queued ahead of the consumer; 0 = auto (pack workers + 2)
    batch_list_size: int = 0
    log_level: int = 0
    verbose: int = 0
    time_on: bool = False

    # filter/trim thresholds + their raw range strings (echoed in reports)
    criteria: FilterCriteria = dataclasses.field(default_factory=FilterCriteria)
    read_length_range: Optional[str] = None
    read_quality_range: Optional[str] = None
    left_quality_range: Optional[str] = None
    right_quality_range: Optional[str] = None

    filter_on: bool = False

    # quality encoding
    quality_encoding_name: Optional[str] = None
    quality_encoding_value: int = PHRED33

    # engine knobs (new; absent in reference)
    # (start, end) logical byte range to process (record-aligned); internal —
    # set by the parallel shard runners (pipeline.run) and multi-host paths.
    # input_range2 is the mate-2 range covering the SAME record indices
    # (paired files have equal record counts but different byte layouts).
    input_range: Optional[tuple] = None
    input_range2: Optional[tuple] = None
    device_batch_reads: int = 0      # 0 = auto
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    profile_dir: Optional[str] = None
    use_pallas: bool = True
    sharded: bool = False

    @property
    def paired_end(self) -> bool:
        return self.in_filename2 is not None


@dataclasses.dataclass
class StatsOptions(CommandOptions):
    command_name: str = "stats"
    kmers_on: bool = False


@dataclasses.dataclass
class FilterOptions(CommandOptions):
    command_name: str = "filter"
    # output filename override: (passed, failed) single-end,
    # (passed_1, passed_2, failed_1, failed_2) paired.  None = the modern
    # passed.fq/failed.fq names.  The legacy single-binary ``--filter``
    # dispatch sets <input>.valid/<input>.invalid per input file
    # (old/README:126-131).
    out_names: Optional[tuple] = None


@dataclasses.dataclass
class EditOptions(CommandOptions):
    command_name: str = "edit"
    # output filename override: (name,) single-end, (name1, name2) paired.
    # None = the reference's edit.fq / edit_1.fq+edit_2.fq.  Used by the
    # legacy `prepro` command to emit <input>.valid files (old/README:76-82).
    out_names: Optional[tuple] = None


@dataclasses.dataclass
class PreproOptions(EditOptions):
    """Legacy preprocessing mode (``old/main_hpg_fastq_old.c`` ``--prep``):
    trim the first ``ltrim_nts`` / last ``rtrim_nts`` nucleotides when the
    window's mean quality falls outside ``[min_quality, max_quality]``;
    write ``<input>.valid`` file(s) (``old/README:73-106``).  Internally a
    pure window-trim edit run — the shared trim kernel implements the
    semantics."""

    command_name: str = "prepro"
    ltrim_nts: int = 0
    rtrim_nts: int = 0
    # legacy defaults + clamps (old/main_hpg_fastq_old.c:96-97,289-305)
    min_quality: int = 20
    max_quality: int = 60
    # only used for the 1/4-rule trim validation (old/main:680-690)
    min_read_length: int = 50

    def apply_trim_windows(self) -> None:
        """Shared prepro wiring (used by both the CLI and ``hpgq.prepro``):
        clamp the legacy qualities (old/main_hpg_fastq_old.c:289-305), map
        ltrim/rtrim onto the edit pipeline's trim-window criteria, and
        derive the ``<input>.valid`` output names (old/README:76-82)."""
        self.min_quality = max(int(self.min_quality), 10)
        self.max_quality = min(int(self.max_quality), 70)
        qrange = "%d,%d" % (self.min_quality, self.max_quality)
        c = self.criteria
        if self.ltrim_nts > 0:
            c.left_length = int(self.ltrim_nts)
            c.min_left_quality, c.max_left_quality = (
                self.min_quality, self.max_quality)
            self.left_quality_range = qrange
        if self.rtrim_nts > 0:
            c.right_length = int(self.rtrim_nts)
            c.min_right_quality, c.max_right_quality = (
                self.min_quality, self.max_quality)
            self.right_quality_range = qrange
        if self.paired_end:
            n1 = os.path.basename(self.in_filename) + ".valid"
            n2 = os.path.basename(self.in_filename2) + ".valid"
            if n1 == n2:  # same basename from different dirs
                n1, n2 = n1 + "_1", n2 + "_2"
            self.out_names = (n1, n2)
        elif self.in_filename:
            self.out_names = (os.path.basename(self.in_filename) + ".valid",)


@dataclasses.dataclass
class CgrOptions(CommandOptions):
    """Chaos-game options (legacy flags --cg/--k/--gs-filename,
    ``old/main_hpg_fastq_old.c:186-190``)."""

    command_name: str = "cgr"
    k: int = DEFAULT_CGR_K
    gs_filename: Optional[str] = None
    write_gs: bool = False


def validate_common(opts: CommandOptions, usage_fn=None) -> None:
    """Validation mirroring ``stats_options_validate`` (src/stats_options.c:111-162)."""
    if not opts.in_filename or not os.path.exists(opts.in_filename):
        print("\nError: Input file name not found !")
        if usage_fn:
            usage_fn()
        raise OptionsError()
    if opts.in_filename2 is not None and not os.path.exists(opts.in_filename2):
        print("\nError: Input file name not found !")
        if usage_fn:
            usage_fn()
        raise OptionsError()

    if not opts.out_dirname or not os.path.exists(opts.out_dirname):
        opts.out_dirname = "."

    if opts.quality_encoding_name:
        enc = QUALITY_ENCODINGS.get(opts.quality_encoding_name)
        if enc is None:
            print(
                "\nError: Invalid quality encoding value (%s). Valid values: "
                "phred33, phred64" % opts.quality_encoding_name
            )
            if usage_fn:
                usage_fn()
            raise OptionsError()
        opts.quality_encoding_value = enc
    else:
        opts.quality_encoding_name = "phred33"
        opts.quality_encoding_value = PHRED33

    c = opts.criteria
    c.min_read_length, c.max_read_length = parse_range(
        opts.read_length_range, "read length range"
    )
    c.min_read_quality, c.max_read_quality = parse_range(
        opts.read_quality_range, "read quality range"
    )
    c.min_left_quality, c.max_left_quality = parse_range(
        opts.left_quality_range, "left quality range"
    )
    c.min_right_quality, c.max_right_quality = parse_range(
        opts.right_quality_range, "right quality range"
    )


def _count_filter_opts(opts: CommandOptions, out) -> int:
    """Shared 'Filter options' display block; returns the active-criteria count
    (side effect mirrors ``stats_options_display`` src/stats_options.c:177-213)."""
    c = opts.criteria
    n = 0
    print("\nFilter options", file=out)
    if opts.read_length_range:
        n += 1
        print("\tRead length range   : %s" % opts.read_length_range, file=out)
    if opts.read_quality_range:
        n += 1
        print("\tRead quality range  : %s" % opts.read_quality_range, file=out)
    if opts.command_name not in ("edit", "prepro"):
        if c.left_length != NO_VALUE and opts.left_quality_range:
            n += 1
            print("\tLeft length         : %i nucleotides" % c.left_length, file=out)
            print("\tLeft quality range  : %s" % opts.left_quality_range, file=out)
        if c.right_length != NO_VALUE and opts.right_quality_range:
            n += 1
            print("\tRight length        : %i nucleotides" % c.right_length, file=out)
            print("\tRight quality range : %s" % opts.right_quality_range, file=out)
    if c.max_N != NO_VALUE:
        n += 1
        print("\tMax. number of Ns   : %i" % c.max_N, file=out)
    if c.max_out_of_quality != NO_VALUE and opts.read_quality_range:
        n += 1
        print("\tMax. out of quality : %i nucletotides" % c.max_out_of_quality, file=out)
    return n


def display(opts: CommandOptions, out=None) -> None:
    """PARAMETERS CONFIGURATION block; sets ``filter_on`` as a side effect like
    the reference's ``*_options_display`` (src/stats_options.c:208-213)."""
    out = out or sys.stdout
    c = opts.criteria
    print("PARAMETERS CONFIGURATION", file=out)
    print("=================================================", file=out)
    print("Command name : %s" % opts.command_name, file=out)

    if opts.command_name == "edit":
        print("", file=out)
        print("Main edit_options", file=out)
    elif opts.command_name == "prepro":
        print("", file=out)
        print("Main prepro_options", file=out)
    else:
        print("\nMain options", file=out)
    if opts.paired_end:
        print("\tFastQ input filename : %s" % opts.in_filename, file=out)
        print("\tFastQ mate-2 filename: %s" % opts.in_filename2, file=out)
    else:
        print("\tFastQ input filename : %s" % opts.in_filename, file=out)
    print("\tOutput dirname       : %s" % opts.out_dirname, file=out)
    if isinstance(opts, StatsOptions):
        print(
            "\tK-mers (5-mer)       : %s" % ("Enabled" if opts.kmers_on else "Disabled"),
            file=out,
        )
        print("\tQuality encoding     : %s" % opts.quality_encoding_name, file=out)
    if isinstance(opts, CgrOptions):
        print("\tK (word size)        : %i" % opts.k, file=out)
        print("\tGenomic signature    : %s" % (opts.gs_filename or "None"), file=out)
        print("\tQuality encoding     : %s" % opts.quality_encoding_name, file=out)

    edit_count = 0
    if opts.command_name == "prepro":
        print("\nPreprocessing options", file=out)
        if c.left_length != NO_VALUE:
            edit_count += 1
            print("\tLtrim nucleotides        : %i" % c.left_length, file=out)
        if c.right_length != NO_VALUE:
            edit_count += 1
            print("\tRtrim nucleotides        : %i" % c.right_length, file=out)
        if edit_count == 0:
            print("\tNone.\n", file=out)
        else:
            print("\tQuality range            : %i,%i"
                  % (opts.min_quality, opts.max_quality), file=out)
    if opts.command_name == "edit":
        print("\nEdit options", file=out)
        if c.left_length != NO_VALUE and opts.left_quality_range:
            edit_count += 1
            print("\tTrim left length         : %i nucleotides" % c.left_length, file=out)
            print("\tTrim left quality range  : %s" % opts.left_quality_range, file=out)
        if c.right_length != NO_VALUE and opts.right_quality_range:
            edit_count += 1
            print("\tTrim right length        : %i nucleotides" % c.right_length, file=out)
            print("\tTrim right quality range : %s" % opts.right_quality_range, file=out)
        if edit_count == 0:
            print("\tNone.\n", file=out)

    filter_count = _count_filter_opts(opts, out)
    if filter_count == 0:
        print("\tNone." + ("\n" if opts.command_name == "edit" else ""), file=out)
        opts.filter_on = False
    else:
        opts.filter_on = True

    print("\nArchitecture options", file=out)
    print("\tNum. threads: %d" % opts.num_threads, file=out)
    print("\tBatch size  : %d alignments" % opts.batch_size, file=out)
    print("=================================================", file=out)

    if opts.command_name == "filter" and filter_count == 0:
        raise OptionsError("\n\nNothing to filter, no filter options specified !\n")
    if opts.command_name == "edit" and edit_count == 0:
        raise OptionsError("\n\nNothing to edit, no edit options specified !\n")
    if opts.command_name == "prepro" and edit_count == 0:
        raise OptionsError(
            "\n\nNothing to preprocess, use --ltrim-nts and/or --rtrim-nts !\n"
        )
