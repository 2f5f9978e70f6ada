"""Character-to-state bitmask maps.

Each map is a 256-entry table from ASCII code to a state bitmask (bit i set =
state i is compatible with the observed character), matching the reference
tables (reference: libpll-2 src/maps.c:26-140): binary, nucleotide
(IUPAC ambiguity codes), 20-state amino acid (with B/Z/J/X ambiguities), and
10-state unphased genotype. Built programmatically from the standard
encodings rather than as literal tables.
"""
from __future__ import annotations

import numpy as np


def _build(pairs: dict[str, int]) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint64)
    for chars, mask in pairs.items():
        for ch in chars:
            table[ord(ch.upper())] = mask
            table[ord(ch.lower())] = mask
    return table


# --- binary (2-state): 0, 1; gap = both --------------------------------------
map_bin = _build({'0': 1, '1': 2, '-.?': 3})

# --- nucleotide (4-state, order A C G T), IUPAC ambiguities ------------------
_A, _C, _G, _T = 1, 2, 4, 8
map_nt = _build({
    'A': _A, 'C': _C, 'G': _G, 'TU': _T,
    'M': _A | _C, 'R': _A | _G, 'W': _A | _T,
    'S': _C | _G, 'Y': _C | _T, 'K': _G | _T,
    'V': _A | _C | _G, 'H': _A | _C | _T, 'D': _A | _G | _T, 'B': _C | _G | _T,
    'NOX-.?': _A | _C | _G | _T,
})

# --- amino acid (20-state, PAML order A R N D C Q E G H I L K M F P S T W Y V)
AA_ORDER = 'ARNDCQEGHILKMFPSTWYV'
_aa_bits = {aa: 1 << i for i, aa in enumerate(AA_ORDER)}
ALL_AA = (1 << 20) - 1
map_aa = _build({
    **{aa: bit for aa, bit in _aa_bits.items()},
    'B': _aa_bits['N'] | _aa_bits['D'],
    'Z': _aa_bits['Q'] | _aa_bits['E'],
    'J': _aa_bits['I'] | _aa_bits['L'],
    'X*-.?': ALL_AA,
})

# --- 10-state unphased genotype (maps.c:108-140) -----------------------------
# order: A/A C/C G/G T/T A/C A/G A/T C/G C/T G/T
map_gt10 = _build({
    'A': 1, 'C': 2, 'G': 4, 'TU': 8,
    'M': 16, 'R': 32, 'W': 64, 'S': 128, 'Y': 256, 'K': 512,
    'N-.?': 1023,
})


# --- parser character classes (maps.c:142-225) -------------------------------
# 0 = stripped, 1 = legal, 2 = fatal, 3 = silently ignored (whitespace)
CHAR_STRIP, CHAR_LEGAL, CHAR_FATAL, CHAR_IGNORE = 0, 1, 2, 3


def _char_class_table(legal: str, ignore: str = "\t\n\x0b\x0c\r",
                      default: int = CHAR_STRIP,
                      fatal_ctrl: bool = True) -> np.ndarray:
    table = np.full(256, default, dtype=np.uint32)
    if fatal_ctrl:
        for i in list(range(0, 9)) + list(range(14, 32)):
            table[i] = CHAR_FATAL
    for ch in ignore:
        table[ord(ch)] = CHAR_IGNORE
    for ch in legal:
        table[ord(ch)] = CHAR_LEGAL
        table[ord(ch.lower())] = CHAR_LEGAL
    return table


_SEQ_CHARS = "-.0123456789?ABCDEFGHIJKLMNOPQRSTUVWXYZ*"
map_fasta = _char_class_table(_SEQ_CHARS.replace("?", "") + "?*-.")
map_phylip = _char_class_table(_SEQ_CHARS.replace("*", "") + "-.?")
# generic alignments: any printable non-whitespace character is legal
map_generic = _char_class_table(
    "".join(chr(i) for i in list(range(33, 127)) + list(range(128, 255))),
    ignore="\t\n\x0b\x0c\r ")


def validate_sequence(sequence: str, char_class: np.ndarray) -> str:
    """Filter a raw sequence through a character-class table: legal chars
    kept, strip/ignore classes removed, fatal classes raise."""
    codes = np.frombuffer(sequence.encode("latin-1"), dtype=np.uint8)
    classes = char_class[codes]
    if np.any(classes == CHAR_FATAL):
        bad = sequence[int(np.argmax(classes == CHAR_FATAL))]
        from .. import constants as C
        raise C.PllError(C.ERROR_FASTA_UNPRINTABLECHAR,
                         f"Illegal character {bad!r} in sequence")
    return "".join(np.array(list(sequence))[classes == CHAR_LEGAL])


def decode_states(sequence: str, charmap: np.ndarray) -> np.ndarray:
    """Map a sequence string to uint64 state bitmasks; 0 marks illegal chars."""
    # latin-1 maps every code point 0-255 to one byte, so illegal bytes
    # reach the charmap==0 PllError path instead of UnicodeEncodeError
    codes = np.frombuffer(sequence.encode('latin-1'), dtype=np.uint8)
    return charmap[codes]


def bits_to_clv(masks: np.ndarray, states: int) -> np.ndarray:
    """Expand bitmasks [L] to 0/1 indicator rows [L, states] (pll.c:959)."""
    bit = np.uint64(1) << np.arange(states, dtype=np.uint64)
    return ((masks[:, None] & bit[None, :]) != 0).astype(np.float64)
