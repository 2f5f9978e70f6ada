"""Fast (Fitch) parsimony on bit-packed state vectors.

Port of libpll2_tpu/parsimony/fitch.py (reference: libpll-2
src/fast_parsimony.c). Parsimony-informative sites (>= 2 state codes
occurring >= 2 times among the tips; singletons of non-informative sites
accumulate a constant cost, fast_parsimony.c:128-194,369) are
weight-expanded and packed into per-state 32-bit bitvectors
(fast_parsimony.c:196-367, padding bits set) on the host, as in JAX. The
Fitch step

    parent_k = (c1_k & c2_k) | (~union & (c1_k | c2_k)),
    union    = OR_k (c1_k & c2_k),   steps += popcount(~union)

runs in plain PyTorch on the partition's device (JAX runs it as jitted
XLA, not Pallas). One vector per half-edge (`node_index` addressing,
tips + 3 * (tips - 1) slots) exactly as the reference, so partial refreshes
and the stepwise machinery carry over.

The words are int32 tensors holding JAX's uint32 bits (`vectors.numpy()
.view(np.uint32)` gives JAX's array): torch has no popcount and no `~` or
`>>` on uint32, so bits are counted with a SWAR popcount over the words
widened to int64. `update_vectors` runs an op list level by level: each
level gathers its children before it writes, and an op joins the first
level after the ops whose results it reads and no earlier than the ops that
read what it overwrites, so the list keeps its sequential meaning. JAX's
`chunked=` exists so that XLA compiles one shape; the port accepts the
keyword and gives the same numbers without padded no-op writes.
"""
from __future__ import annotations

from functools import reduce
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .sankoff import ParsBuildOp

BITS = 32
_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def _informative(tip_codes: np.ndarray,
                 pattern_weights: np.ndarray) -> Tuple[np.ndarray, int]:
    """(informative mask [S], const_cost) — fast_parsimony.c:128-194,369.

    Vectorized: one np.unique over (site, code) pairs classifies every
    column at once (the per-column loop was the construction bottleneck
    for long alignments)."""
    tips, sites = tip_codes.shape
    site_ids = np.repeat(np.arange(sites, dtype=np.uint64), tips)
    # (site, code) composite keys; codes fit in < 2^32 after ranking
    _, code_rank = np.unique(tip_codes, return_inverse=True)
    keys = site_ids * np.uint64(len(_)) + \
        code_rank.reshape(tips, sites).T.reshape(-1).astype(np.uint64)
    uniq_keys, counts = np.unique(keys, return_counts=True)
    per_site = (uniq_keys // np.uint64(len(_))).astype(np.int64)
    repeated = np.zeros(sites, dtype=np.int64)
    singles = np.zeros(sites, dtype=np.int64)
    np.add.at(repeated, per_site, (counts > 1).astype(np.int64))
    np.add.at(singles, per_site, (counts == 1).astype(np.int64))
    informative = repeated > 1
    const_cost = int((singles[~informative]
                      * np.asarray(pattern_weights)[~informative]).sum())
    return informative, const_cost


def _pack_tips(tip_codes: np.ndarray,        # [tips, S] uint64 state masks
               informative: np.ndarray,      # [S] bool
               pattern_weights: np.ndarray,  # [S]
               states: int) -> np.ndarray:
    """[tips, states, W] uint32, weight-expanded, padded with ones."""
    idx = np.repeat(np.nonzero(informative)[0],
                    pattern_weights[informative].astype(np.int64))
    bits = idx.size
    words = max(1, -(-bits // BITS))
    out = np.empty((tip_codes.shape[0], states, words), dtype=np.uint32)
    pad = words * BITS - bits
    for i in range(tip_codes.shape[0]):
        codes = tip_codes[i, idx]
        for k in range(states):
            b = ((codes >> np.uint64(k)) & np.uint64(1)).astype(np.uint8)
            b = np.concatenate([b, np.ones(pad, dtype=np.uint8)])
            out[i, k] = np.packbits(b, bitorder="little").view(np.uint32)
    return out


def _popcount_sum(words: torch.Tensor) -> torch.Tensor:
    """Set bits of int32 words [..., W] summed over the last axis, as
    int32 [...]: a SWAR popcount over the words widened to int64 (their
    uint32 bits), where no step can overflow."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = (x + (x >> 16)) & 0x3F
    return x.sum(dim=-1).to(torch.int32)


def _union(ands: torch.Tensor) -> torch.Tensor:
    """OR over the state axis of [n, states, W] words: [n, W]."""
    return reduce(torch.bitwise_or, ands.unbind(1))


def _join(a: torch.Tensor, b: torch.Tensor):
    """Fitch join of [n, states, W] children: (parent vectors, steps [n])."""
    ands = a & b
    union = _union(ands)
    joined = ands | (~union[:, None] & (a | b))
    return joined, _popcount_sum(~union)


def op_levels(rows: Sequence[Tuple[int, int, int]]) -> List[int]:
    """Level of each (parent, child1, child2) op such that running the
    levels in order, each gathering all its children before writing its
    parents, computes what the list computes op by op: an op comes after
    the last writer of each slot it reads and of the slot it writes, and no
    earlier than the ops before it that read the slot it writes."""
    ready = {}        # slot -> first level that sees its latest value
    read_at = {}      # slot -> last level reading it since its last write
    levels = []
    for p, c1, c2 in rows:
        lv = max(ready.get(c1, 0), ready.get(c2, 0), ready.get(p, 0),
                 read_at.get(p, 0))
        levels.append(lv)
        for c in (c1, c2):
            read_at[c] = max(read_at.get(c, 0), lv)
        ready[p] = lv + 1
        read_at.pop(p, None)
    return levels


class FastParsimony:
    """pll_fastparsimony_init (fast_parsimony.c:523-560) on the partition's
    device."""

    def __init__(self, partition):
        if not np.all(partition._tips_set):
            raise ValueError("all tip states must be set before "
                             "fast-parsimony init")
        self.device = partition.device
        self.tips = partition.tips
        self.states = partition.states
        self.sites = partition.sites
        self.inner_nodes = self.tips - 1
        nodes_count = self.tips + 3 * self.inner_nodes

        codes = partition.tip_states[:, :self.sites]
        weights = partition.pattern_weights[:self.sites]
        informative, self.const_cost = _informative(codes, weights)
        self.informative = informative
        self.informative_count = int(informative.sum())

        packed = _pack_tips(codes, informative, weights, self.states)
        words = packed.shape[-1]
        vecs = np.zeros((nodes_count, self.states, words), dtype=np.uint32)
        vecs[:self.tips] = packed
        self.packed_host = packed        # host copy for the native path
        self.vectors = torch.from_numpy(vecs.view(np.int32)).to(self.device)
        self.node_cost = torch.zeros(nodes_count, dtype=torch.int32,
                                     device=self.device)

    def update_vectors(self, operations: Sequence[ParsBuildOp],
                       chunked: bool = False) -> None:
        """Fitch-join every op's children into its parent slot, in list
        order (run level by level: `op_levels`). `chunked` is accepted for
        libpll2_tpu's signature and changes nothing."""
        rows = [(o.parent_score_index, o.child1_score_index,
                 o.child2_score_index) for o in operations]
        if not rows:
            return
        levels = np.asarray(op_levels(rows))
        order = np.argsort(levels, kind="stable")
        bounds = np.searchsorted(levels[order],
                                 np.arange(int(levels.max()) + 2))
        ops = torch.as_tensor(np.asarray(rows, dtype=np.int64)[order],
                              device=self.device)
        vec, cost = self.vectors, self.node_cost
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            p, c1, c2 = ops[lo:hi].unbind(1)
            joined, steps = _join(vec[c1], vec[c2])
            vec[p] = joined
            cost[p] = steps + cost[c1] + cost[c2]

    def edge_score(self, index1: int, index2: int) -> int:
        idx = torch.tensor([index1, index2], device=self.device)
        v = self.vectors[idx]
        union = _union(v[:1] & v[1:])
        return int(_popcount_sum(~union)[0]
                   + self.node_cost[idx].sum()) + self.const_cost

    def root_score(self, index: int) -> int:
        return int(self.node_cost[index]) + self.const_cost

    def batch_insert_scores(self, tip_index: int,
                            e1: np.ndarray, e2: np.ndarray,
                            chunked: bool = False) -> np.ndarray:
        """const_cost-inclusive scores of inserting tip_index on each edge
        (e1[i], e2[i]), all at once: Fitch-join the two edge-side vectors,
        then edge-score against the tip; the reference's splice + 1-op
        update + edge score (stepwise.c:320-361), batched. `chunked` is
        accepted for libpll2_tpu's signature and changes nothing."""
        i1 = torch.as_tensor(np.asarray(e1, dtype=np.int64),
                             device=self.device)
        i2 = torch.as_tensor(np.asarray(e2, dtype=np.int64),
                             device=self.device)
        vec, cost = self.vectors, self.node_cost
        joined, steps = _join(vec[i1], vec[i2])
        union = _union(joined & vec[tip_index][None])
        scores = (_popcount_sum(~union) + steps + cost[i1] + cost[i2]
                  + cost[tip_index])
        return scores.cpu().numpy().astype(np.int64) + self.const_cost
