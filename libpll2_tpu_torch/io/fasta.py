"""FASTA reading (reference: libpll-2 src/fasta.c:40-417).

Provides both a streaming record reader (pll_fasta_getnext equivalent) and a
whole-file loader returning (headers, sequences).

Carried over from libpll2_tpu/io/fasta.py (host code) so that the port
imports no jax; the PllError codes are the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

from ..constants import (ERROR_FASTA_INVALIDHEADER, ERROR_FASTA_NONALIGNED,
                         ERROR_FILE_OPEN, PllError)


@dataclass
class FastaRecord:
    header: str
    sequence: str
    seqno: int


def iter_fasta(path: str) -> Iterator[FastaRecord]:
    """Stream records; strips whitespace inside sequences (fasta.c:130-257)."""
    try:
        fh = open(path, "r")
    except OSError as e:
        raise PllError(ERROR_FILE_OPEN, f"Unable to open file ({path})") from e
    with fh:
        header = None
        chunks: List[str] = []
        seqno = 0
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield FastaRecord(header, "".join(chunks), seqno)
                    seqno += 1
                header = line[1:].strip()
                chunks = []
            else:
                if header is None:
                    raise PllError(ERROR_FASTA_INVALIDHEADER,
                                   "Illegal header line in fasta file")
                chunks.append(line.replace(" ", "").replace("\t", ""))
        if header is not None:
            yield FastaRecord(header, "".join(chunks), seqno)


class FastaFile:
    """Streaming handle with position queries — the pll_fasta_open /
    getnext / rewind / getfilepos / getfilesize / close API surface
    (fasta.c:40-128, 259-316)."""

    def __init__(self, path: str):
        self.path = path
        self._it = None
        try:
            self._size = __import__("os").path.getsize(path)
        except OSError as e:
            raise PllError(ERROR_FILE_OPEN,
                           f"Unable to open file ({path})") from e
        self.rewind()

    def getnext(self) -> FastaRecord | None:
        """Next record, or None at EOF (pll_fasta_getnext)."""
        rec = next(self._it, None)
        if rec is not None:
            self._count = rec.seqno + 1
        return rec

    def rewind(self) -> None:
        self._it = iter_fasta(self.path)
        self._count = 0

    def getfilesize(self) -> int:
        return self._size

    def getfilepos(self) -> int:
        """Records consumed so far (the streaming analog of the byte
        offset the reference exposes)."""
        return self._count

    def close(self) -> None:
        self._it = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_fasta(path: str, require_aligned: bool = True
               ) -> Tuple[List[str], List[str]]:
    """pll_fasta_load equivalent (fasta.c:318-333)."""
    headers: List[str] = []
    seqs: List[str] = []
    for rec in iter_fasta(path):
        headers.append(rec.header)
        seqs.append(rec.sequence)
    if require_aligned and seqs and len({len(s) for s in seqs}) != 1:
        raise PllError(ERROR_FASTA_NONALIGNED,
                       "FASTA file does not contain equal size sequences")
    return headers, seqs
