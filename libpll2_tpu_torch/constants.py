"""Constants mirroring the reference library's public contract.

A copy of libpll2_tpu/constants.py (pure Python), so that the port imports
no jax.

Reference: libpll-2 src/pll.h:73-199 (values are part of the public
API semantics: scaling thresholds, gamma modes, asc-bias types, error codes).
"""
from __future__ import annotations

import enum

# --- numerical scaling (pll.h:89-97) ---------------------------------------
# fp64 path: rescale a CLV site block by 2**256 whenever all entries drop
# below 2**-256 (per-site mode) or all entries of one rate category do
# (per-rate mode).
SCALE_FACTOR = 2.0 ** 256
SCALE_THRESHOLD = 2.0 ** -256
SCALE_FACTOR_SQRT = 2.0 ** 128
SCALE_THRESHOLD_SQRT = 2.0 ** -128
# fp32 fast path uses a much smaller window (fp32 min normal is 2**-126).
# fp32 fast path: the window must satisfy threshold^2 > 2^-126 (fp32 min
# normal) — one pruning step multiplies two children that can each sit
# just below the threshold, and the underflow check runs only AFTER the
# product. 2^-64 (the old window) gave (2^-64)^2 = 2^-128 < 2^-126: on
# deep trees (~1000 taxa) flush-to-zero hardware zeroed whole sites between
# checks and the logL came back -inf while the reference was finite.
SCALE_FACTOR_F32 = 2.0 ** 32
SCALE_THRESHOLD_F32 = 2.0 ** -32
# per-rate scaling: cap on scaler differences when undoing (pll.h:97)
SCALE_RATE_MAXDIFF = 4

SCALE_BUFFER_NONE = -1

MISC_EPSILON = 1e-8
ONE_EPSILON = 1e-15
EIGEN_MINFREQ = 1e-6

# --- gamma discretization modes (pll.h:196-198) -----------------------------
GAMMA_RATES_MEAN = 0
GAMMA_RATES_MEDIAN = 1
ALPHA_MIN = 0.02

# --- ascertainment bias correction types (pll.h:119-124) --------------------
class AscBias(enum.Enum):
    NONE = 0
    LEWIS = 1
    FELSENSTEIN = 2
    STAMATAKIS = 3


# integer aliases used by the jitted kernels (static args must be ints)
AB_NONE = AscBias.NONE.value
AB_LEWIS = AscBias.LEWIS.value
AB_FELSENSTEIN = AscBias.FELSENSTEIN.value
AB_STAMATAKIS = AscBias.STAMATAKIS.value


# --- site repeats (pll.c:441-449, pll.h:128) ---------------------------------
REPEATS_MIN_SITES = 16

# --- branch-length optimization bounds (RAxML-NG convention) -----------------
OPT_MIN_BRANCH_LEN = 1e-6
OPT_MAX_BRANCH_LEN = 100.0

# --- traversal orders (pll.h:141-142) ---------------------------------------
TRAVERSE_POSTORDER = 1
TRAVERSE_PREORDER = 2

# --- topological moves (pll.h:134-139) ---------------------------------------
UTREE_MOVE_SPR = 1
UTREE_MOVE_NNI = 2
UTREE_MOVE_NNI_LEFT = 1
UTREE_MOVE_NNI_RIGHT = 2


class PllError(Exception):
    """Library error with a libpll-compatible error code (pll.h:143-179)."""

    def __init__(self, errno: int, message: str):
        super().__init__(message)
        self.errno = errno


ERROR_FILE_OPEN = 100
ERROR_FILE_SEEK = 101
ERROR_FILE_EOF = 102
ERROR_FASTA_ILLEGALCHAR = 201
ERROR_FASTA_UNPRINTABLECHAR = 202
ERROR_FASTA_INVALIDHEADER = 203
ERROR_FASTA_NONALIGNED = 204
ERROR_PHYLIP_SYNTAX = 231
ERROR_PHYLIP_LONGSEQ = 232
ERROR_PHYLIP_NONALIGNED = 233
ERROR_PHYLIP_ILLEGALCHAR = 234
ERROR_PHYLIP_UNPRINTABLECHAR = 235
ERROR_NEWICK_SYNTAX = 111
ERROR_MEM_ALLOC = 112
ERROR_PARAM_INVALID = 113
ERROR_TIPDATA_ILLEGALSTATE = 114
ERROR_TIPDATA_ILLEGALFUNCTION = 115
ERROR_TREE_CONVERSION = 116
ERROR_INVAR_INCOMPAT = 117
ERROR_INVAR_PROPORTION = 118
ERROR_INVAR_PARAMINDEX = 119
ERROR_INVAR_NONEFOUND = 120
ERROR_AB_INVALIDMETHOD = 121
ERROR_AB_NOSUPPORT = 122
ERROR_SPR_TERMINALBRANCH = 123
ERROR_SPR_NOCHANGE = 124
ERROR_NNI_INVALIDMOVE = 125
ERROR_NNI_TERMINALBRANCH = 126
ERROR_STEPWISE_STRUCT = 127
ERROR_STEPWISE_TIPS = 128
ERROR_STEPWISE_UNSUPPORTED = 129
ERROR_EINVAL = 130
ERROR_MSA_EMPTY = 131
ERROR_MSA_MAP_INVALID = 132
ERROR_TREE_INVALID = 133
