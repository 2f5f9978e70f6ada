"""Sequence simulation along a tree (for benchmarks and realistic tests).

Port of libpll2_tpu/utils/simulate.py (the same numpy code, on the port's
own ops/eigen and ops/gamma). Evolves i.i.d. sites down a tree under a
GTR+Gamma model using the same eigendecomposition/P-matrix math as the
likelihood engine (host-side numpy). Simulation gives the statistical
structure of real alignments (shared subtree patterns) without shipping
data.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops import eigen as ops_eigen
from ..ops.gamma import compute_gamma_cats

DNA = "ACGT"
AA = "ARNDCQEGHILKMFPSTWYV"


def _pmatrix(eigensystem, t: float) -> np.ndarray:
    lam, evecs, inv_evecs = (eigensystem.eigenvals, eigensystem.evecs,
                             eigensystem.inv_evecs)
    return (inv_evecs * np.exp(lam * t)[None, :]) @ evecs


def simulate_alignment(tree,
                       n_sites: int,
                       freqs: Sequence[float],
                       subst_params: Sequence[float],
                       alpha: Optional[float] = None,
                       rate_cats: int = 4,
                       seed: int = 0,
                       alphabet: Optional[str] = None
                       ) -> Tuple[List[str], List[str]]:
    """Returns (headers, sequences) for the tree's tips.

    Each site draws a Gamma rate category (if alpha is given), a root state
    from the stationary frequencies, and transitions along every branch
    with P(rate * t).
    """
    rng = np.random.default_rng(seed)
    freqs = np.asarray(freqs, dtype=np.float64)
    states = freqs.size
    if alphabet is None:
        alphabet = DNA if states == 4 else AA
    es = ops_eigen.update_eigen(np.asarray(subst_params, dtype=np.float64),
                                freqs)
    rates = (np.asarray(compute_gamma_cats(alpha, rate_cats))
             if alpha is not None else np.ones(1))
    site_rate = rng.integers(0, rates.size, size=n_sites)

    root = tree.vroot
    root_states = rng.choice(states, size=n_sites, p=freqs / freqs.sum())

    out = {}

    def transition(states_in: np.ndarray, t: float) -> np.ndarray:
        new = np.empty_like(states_in)
        for r in range(rates.size):
            mask = site_rate == r
            if not np.any(mask):
                continue
            P = np.clip(_pmatrix(es, rates[r] * t), 0.0, 1.0)
            P = P / P.sum(axis=1, keepdims=True)
            sub = states_in[mask]
            u = rng.random(sub.size)
            cdf = np.cumsum(P, axis=1)
            # clip: fp rounding can leave cdf[-1] slightly below 1.0
            new[mask] = np.minimum((u[:, None] > cdf[sub]).sum(axis=1),
                                   states - 1)
        return new

    def rec(entry, states_here):
        """entry is the ring half-edge facing its parent."""
        if entry.is_tip():
            out[entry.label] = states_here
            return
        for h in entry.ring():
            if h is entry:
                continue
            child = h.back
            rec(child, transition(states_here, child.length))

    # every ring half of the virtual root leads to one of its neighbors
    for h in root.ring():
        child = h.back
        rec(child, transition(root_states, child.length))

    headers = [t.label for t in tree.tips()]
    seqs = ["".join(alphabet[s] for s in out[h]) for h in headers]
    return headers, seqs
