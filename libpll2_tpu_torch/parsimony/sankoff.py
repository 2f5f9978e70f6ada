"""Weighted (Sankoff) parsimony: a min-plus dynamic program over a cost
matrix.

Port of libpll2_tpu/parsimony/sankoff.py (reference: libpll-2
src/parsimony.c, Sankoff 1975 minimum mutation trees). The score buffers
are one dense [buffers, states, sites] tensor on the `device` that
`Parsimony` takes; the per-node step

    score[p, n, s] = min_k(c1[k, s] + cost[k, n]) + min_k(c2[k, s] + cost[k, n])

is a min-plus contraction over the (small) state axis with sites along
the last axis, run one operation after another in plain PyTorch (JAX runs
the same step as a jitted `lax.scan`, not a Pallas kernel). The buffers
are float32, JAX's default dtype; the scores of integer cost matrices are
exact below 2^24.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import constants as C
from ..io import maps as state_maps
from ..partition import resolve_device


class ParsBuildOp(NamedTuple):
    """pll_pars_buildop_t (pll.h): score-buffer indices."""
    parent_score_index: int
    child1_score_index: int
    child2_score_index: int


class ParsRecOp(NamedTuple):
    """pll_pars_recop_t: preorder ancestral-reconstruction indices."""
    node_score_index: int
    node_ancestral_index: int
    parent_score_index: int
    parent_ancestral_index: int


def _min_plus(child: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """[states, S]: min over k of child[k, s] + cost[k, n]."""
    return (child[:, None, :] + cost[:, :, None]).amin(dim=0)


class Parsimony:
    """pll_parsimony_create (parsimony.c:117-203), on `device` ("cuda" by
    default, as `Partition`)."""

    def __init__(self, tips: int, states: int, sites: int,
                 score_matrix, score_buffers: int,
                 ancestral_buffers: int = 0, *, device="cuda"):
        self.device = resolve_device(device)
        self.tips = tips
        self.states = states
        self.sites = sites
        self.score_matrix = np.asarray(score_matrix,
                                       dtype=np.float64).reshape(states,
                                                                 states)
        self.inf = float(self.score_matrix.max()) + 1.0
        self.sbuffer = torch.zeros((tips + score_buffers, states, sites),
                                   dtype=torch.float32, device=self.device)
        self._cost = torch.tensor(self.score_matrix, dtype=torch.float32,
                                  device=self.device)
        self.anc_states = np.zeros((tips + ancestral_buffers, sites),
                                   dtype=np.int64)

    def set_sequence(self, tip_index: int, charmap, sequence: str) -> None:
        """Tip scores: 0 for compatible states, 'infinity' otherwise
        (parsimony.c:24-67)."""
        masks = state_maps.decode_states(
            sequence, np.asarray(charmap, dtype=np.uint64))
        if np.any(masks == 0):
            bad = sequence[int(np.argmax(masks == 0))]
            raise C.PllError(C.ERROR_TIPDATA_ILLEGALSTATE,
                             f"Illegal state code in tip \"{bad}\"")
        ind = state_maps.bits_to_clv(masks, self.states)       # [S, states]
        tipstate = np.where(ind > 0, 0.0, self.inf).T          # [states, S]
        self.sbuffer[tip_index] = torch.as_tensor(
            tipstate, dtype=self.sbuffer.dtype).to(self.device)

    def build(self, operations: Sequence[ParsBuildOp]) -> float:
        """Postorder DP, one operation after another; returns the score at
        the last parent (parsimony.c:205-284)."""
        buf, cost = self.sbuffer, self._cost
        for op in operations:
            buf[op.parent_score_index] = (
                _min_plus(buf[op.child1_score_index], cost)
                + _min_plus(buf[op.child2_score_index], cost))
        return self.score(operations[-1].parent_score_index)

    def score(self, score_buffer_index: int) -> float:
        """Sum over sites of the per-site state minimum
        (parsimony.c:286-307)."""
        return float(self.sbuffer[score_buffer_index].amin(dim=0).sum())

    def reconstruct(self, charmap, operations: Sequence[ParsRecOp]) -> None:
        """Preorder ancestral states (parsimony.c:309-383): pick the
        minimum-score state unless keeping the parent's state is at least
        as good (min + 1 > parent's value)."""
        cm = np.asarray(charmap, dtype=np.uint64)
        revmap = {}
        for i in range(256):
            m = int(cm[i])
            if m and (m & (m - 1)) == 0:
                revmap[m.bit_length() - 1] = i
        sbuf = self.sbuffer.cpu().numpy()

        op = operations[0]
        scores = sbuf[op.node_score_index]                   # [states, S]
        minidx = np.argmin(scores, axis=0)
        self.anc_states[op.node_ancestral_index] = [revmap[i] for i in minidx]

        for op in operations[1:]:
            scores = sbuf[op.node_score_index]
            minidx = np.argmin(scores, axis=0)
            minval = scores[minidx, np.arange(self.sites)]
            panc = self.anc_states[op.parent_ancestral_index]
            pstate = np.array([int(cm[a]).bit_length() - 1 for a in panc])
            pval = sbuf[op.parent_score_index][pstate, np.arange(self.sites)]
            keep_parent = minval + 1 > pval
            self.anc_states[op.node_ancestral_index] = np.where(
                keep_parent, panc, [revmap[i] for i in minidx])

    def ancestral(self, index: int) -> str:
        return "".join(chr(c) for c in self.anc_states[index])
