"""PHYLIP reading — interleaved and sequential, whitespace-tolerant
(reference: libpll-2 src/phylip.c:382-751).

Carried over from libpll2_tpu/io/phylip.py (host code) so that the port
imports no jax; the PllError codes are the same.
"""
from __future__ import annotations

from typing import List, Tuple

from ..constants import (ERROR_FILE_OPEN, ERROR_PHYLIP_NONALIGNED,
                         ERROR_PHYLIP_SYNTAX, PllError)


def _read_header(line: str) -> Tuple[int, int]:
    parts = line.split()
    if len(parts) < 2:
        raise PllError(ERROR_PHYLIP_SYNTAX, "Invalid PHYLIP header")
    try:
        return int(parts[0]), int(parts[1])
    except ValueError as e:
        raise PllError(ERROR_PHYLIP_SYNTAX, "Invalid PHYLIP header") from e


def _open(path: str):
    try:
        return open(path, "r")
    except OSError as e:
        raise PllError(ERROR_FILE_OPEN, f"Unable to open file ({path})") from e


def parse_phylip_sequential(path: str) -> Tuple[List[str], List[str]]:
    """phylip.c:570-751: names then sequence possibly spanning lines."""
    with _open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    it = iter(ln for ln in lines if ln.strip())
    count, sites = _read_header(next(it))
    headers: List[str] = []
    seqs: List[str] = []
    current = ""
    for ln in it:
        if len(headers) == len(seqs):  # expect a new taxon
            parts = ln.split(None, 1)
            headers.append(parts[0])
            current = parts[1].replace(" ", "") if len(parts) > 1 else ""
        else:
            current += ln.replace(" ", "").replace("\t", "")
        if len(current) >= sites:
            if len(current) != sites:
                raise PllError(ERROR_PHYLIP_NONALIGNED,
                               "Sequence longer than expected")
            seqs.append(current)
            current = ""
    if len(seqs) != count:
        raise PllError(ERROR_PHYLIP_SYNTAX,
                       f"Expected {count} sequences, found {len(seqs)}")
    return headers, seqs


def parse_phylip_interleaved(path: str) -> Tuple[List[str], List[str]]:
    """phylip.c:382-568: first block has names, later blocks bare chunks."""
    with _open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    nonempty = [ln for ln in lines if ln.strip()]
    count, sites = _read_header(nonempty[0])
    headers: List[str] = []
    chunks: List[str] = [""] * count
    row = 0
    first_block = True
    for ln in nonempty[1:]:
        if first_block and len(headers) < count:
            parts = ln.split(None, 1)
            headers.append(parts[0])
            chunks[len(headers) - 1] += \
                parts[1].replace(" ", "") if len(parts) > 1 else ""
            if len(headers) == count:
                first_block = False
                row = 0
        else:
            chunks[row] += ln.replace(" ", "").replace("\t", "")
            row = (row + 1) % count
    for c in chunks:
        if len(c) != sites:
            raise PllError(ERROR_PHYLIP_NONALIGNED,
                           "Sequence length mismatch in PHYLIP file")
    return headers, chunks


def parse_phylip(path: str, interleaved: bool = False):
    return (parse_phylip_interleaved if interleaved
            else parse_phylip_sequential)(path)
