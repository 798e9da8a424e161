"""The port's own copy of ``hpgq/constants.py`` (the port imports nothing of
``hpgq``); kept equal to it.

Shared constants.

Mirrors the reference's observable constants:

* ``NO_VALUE``/``MIN_VALUE``/``MAX_VALUE`` — threshold sentinels and default
  substitution values (reference ``src/commons_fastq.h:21-23``).
* phred encodings (reference ``src/stats_options.c:123-137``; legacy aliases
  ``sanger``/``solexa`` at ``old/main_hpg_fastq_old.c:399-414``).
* base-code LUT semantics (reference ``old/chaos_game.c:51-72``): A/a=0, C/c=1,
  G/g=2, T/t=3, N/n=4; every other byte maps to OTHER.
"""

NO_VALUE = -1
MIN_VALUE = 0
MAX_VALUE = 100000

PHRED33 = 33
PHRED64 = 64
QUALITY_ENCODINGS = {
    "phred33": PHRED33,
    "phred64": PHRED64,
    # legacy aliases (old/main_hpg_fastq_old.c:399-414)
    "sanger": PHRED33,
    "solexa": PHRED64,
    "33": PHRED33,
    "64": PHRED64,
}

# base codes (int8 tensor alphabet)
BASE_A = 0
BASE_C = 1
BASE_G = 2
BASE_T = 3
BASE_N = 4
BASE_OTHER = 5

KMER_K = 5                  # the reference's k-mer analysis is 5-mers
NUM_KMERS = 4 ** KMER_K     # 1024

# chaos game (old/chaos_game.h:37-52)
CGR_EPSILON = 0.00001
CGR_MIN_K_IMAGE_VALUE = 7
CGR_MIN_IMAGE_PIXEL_SIZE = 128
CGR_MAX_QUALITY_IN_TABLE = 62
CGR_K_VALUE_INFIX = "_k="
CGR_FASTQ_PGM_SUFFIX = "_FG.pgm"
CGR_QUALITY_PGM_SUFFIX = "_QQ.pgm"
CGR_DIFF_PGM_SUFFIX = "_FG_dif.pgm"
DEFAULT_CGR_K = 7           # old/main_hpg_fastq_old.c:108

DEFAULT_NUM_THREADS = 2     # src/stats_options.c:21
DEFAULT_BATCH_SIZE = 10000  # src/stats_options.c:22 (reads per batch)
