"""Random bifurcating tree generation (for benchmarks and synthetic tests).

The reference only builds random topologies through parsimony-guided
stepwise addition (reference: libpll-2 src/stepwise.c:391); for
benchmarking we also want plain random topologies of a given size. Trees are
emitted as newick text and parsed through the standard parser so all index
template rules apply unchanged.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .newick import parse_newick
from .utree import UTree


def random_newick(labels: Sequence[str], rng: np.random.Generator,
                  min_len: float = 0.02, max_len: float = 0.5,
                  balanced: bool = False) -> str:
    """Random (or perfectly balanced) bifurcating topology over `labels`."""

    def blen() -> str:
        return f"{rng.uniform(min_len, max_len):.6f}"

    def rec(group: List[str]) -> str:
        if len(group) == 1:
            return f"{group[0]}:{blen()}"
        if balanced:
            k = len(group) // 2
        else:
            k = int(rng.integers(1, len(group)))
        return f"({rec(group[:k])},{rec(group[k:])}):{blen()}"

    order = [labels[i] for i in rng.permutation(len(labels))]
    if len(order) < 3:
        raise ValueError("need at least 3 taxa")
    k1, k2 = len(order) // 3, 2 * len(order) // 3
    parts = [order[:k1], order[k1:k2], order[k2:]]
    return "(" + ",".join(rec(p) for p in parts) + ");"


def random_utree(labels: Sequence[str], seed: int = 0,
                 balanced: bool = False) -> UTree:
    rng = np.random.default_rng(seed)
    return parse_newick(random_newick(labels, rng, balanced=balanced))


def random_alignment(n_taxa: int, n_sites: int, alphabet: str = "ACGT",
                     seed: int = 0, gap_prob: float = 0.0):
    """(headers, sequences) of i.i.d. random characters (benchmark data)."""
    rng = np.random.default_rng(seed)
    chars = np.array(list(alphabet))
    idx = rng.integers(0, len(chars), size=(n_taxa, n_sites))
    seqs = ["".join(row) for row in chars[idx]]
    if gap_prob > 0:
        out = []
        for s in seqs:
            mask = rng.random(n_sites) < gap_prob
            out.append("".join('-' if m else c for m, c in zip(mask, s)))
        seqs = out
    headers = [f"t{i}" for i in range(n_taxa)]
    return headers, seqs
