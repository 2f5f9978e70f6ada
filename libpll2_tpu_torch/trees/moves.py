"""Topological rearrangements: SPR and NNI with rollback.

Same semantics as the reference (libpll-2 src/utree_moves.c:72-375): moves
rewire `back` pointers, record the new branch lengths and pmatrix indices
for the caller to refresh, and fill a rollback record that restores the
previous topology exactly.

Carried over from libpll2_tpu/trees/moves.py so that the port imports no
jax; candidate scoring (`TreeEngine.evaluate_topologies`) is held against
JAX's with candidates each package builds with its own moves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..constants import (ERROR_NNI_INVALIDMOVE, ERROR_NNI_TERMINALBRANCH,
                         ERROR_PARAM_INVALID, ERROR_SPR_NOCHANGE,
                         ERROR_SPR_TERMINALBRANCH, UTREE_MOVE_NNI,
                         UTREE_MOVE_NNI_LEFT, UTREE_MOVE_NNI_RIGHT,
                         UTREE_MOVE_SPR, PllError)
from .utree import UNode


@dataclass
class Rollback:
    """pll_utree_rb_t (pll.h:431-453)."""
    move_type: int = 0
    # SPR fields
    p: Optional[UNode] = None
    r: Optional[UNode] = None
    rb: Optional[UNode] = None
    r_len: float = 0.0
    pnb: Optional[UNode] = None
    pnb_len: float = 0.0
    pnnb: Optional[UNode] = None
    pnnb_len: float = 0.0
    # NNI fields
    nni_type: int = 0


def _link(a: UNode, b: UNode, length: float, pmatrix_index: int) -> None:
    a.back = b
    b.back = a
    a.length = b.length = length
    a.pmatrix_index = b.pmatrix_index = pmatrix_index


def _swap(t1: UNode, t2: UNode) -> None:
    """Swap subtrees t1, t2; each keeps the branch to its new parent."""
    temp = t1.back
    _link(t1, t2.back, t2.back.length, t2.back.pmatrix_index)
    _link(t2, temp, temp.length, temp.pmatrix_index)


def utree_find(start: UNode, target: UNode) -> bool:
    """True if `target` occurs in the subtree hanging from `start`."""
    if start is None:
        return False
    if start is target:
        return True
    if start.next is None:
        return False
    for r in list(start.ring())[1:]:
        if r is target or utree_find(r.back, target):
            return True
    return False


def nni(p: UNode, move_type: int,
        rollback: Optional[Rollback] = None) -> None:
    """Nearest-neighbor interchange across the edge (p, p.back)."""
    if move_type not in (UTREE_MOVE_NNI_LEFT, UTREE_MOVE_NNI_RIGHT):
        raise PllError(ERROR_NNI_INVALIDMOVE, "Invalid NNI move type")
    if p.next is None or p.back.next is None:
        raise PllError(ERROR_NNI_TERMINALBRANCH, "Specified terminal branch")
    if rollback is not None:
        rollback.move_type = UTREE_MOVE_NNI
        rollback.p = p
        rollback.nni_type = move_type

    subtree1 = p.next
    subtree2 = p.back.next if move_type == UTREE_MOVE_NNI_LEFT \
        else p.back.next.next
    _swap(subtree1, subtree2)


def spr(p: UNode, r: UNode,
        rollback: Optional[Rollback] = None,
        safe: bool = False) -> Tuple[List[float], List[int]]:
    """Prune the subtree at p.back, regraft on edge (r, r.back).

    Returns (branch_lengths, pmatrix_indices) of the three changed edges —
    the caller must refresh those probability matrices."""
    if p.next is None:
        raise PllError(ERROR_SPR_TERMINALBRANCH,
                       "Prune edge must be defined by an inner node")
    if r in (p, p.back, p.next, p.next.back, p.next.next, p.next.next.back):
        raise PllError(ERROR_SPR_NOCHANGE, "Proposed move yields the same tree")
    if safe and utree_find(p.back, r):
        raise PllError(ERROR_PARAM_INVALID,
                       "Node r is part of the subtree to be pruned")

    if rollback is not None:
        rollback.move_type = UTREE_MOVE_SPR
        rollback.p = p
        rollback.r = r
        rollback.rb = r.back
        rollback.r_len = r.length
        rollback.pnb = p.next.back
        rollback.pnb_len = p.next.length
        rollback.pnnb = p.next.next.back
        rollback.pnnb_len = p.next.next.length

    branch_lengths: List[float] = []
    matrix_indices: List[int] = []

    # (b) connect u and v (heal the hole left by pruning)
    u = p.next.back
    v = p.next.next.back
    _link(u, v, u.length + v.length, u.pmatrix_index)
    branch_lengths.append(u.length)
    matrix_indices.append(u.pmatrix_index)

    # (a) prune subtree C
    p.next.back = p.next.next.back = None

    # (c) regraft at r<->r', splitting r's branch in half
    length = r.length / 2
    rb_node = r.back
    _link(rb_node, p.next.next, length, p.next.next.pmatrix_index)
    branch_lengths.append(length)
    matrix_indices.append(p.next.next.pmatrix_index)
    _link(r, p.next, length, r.pmatrix_index)
    branch_lengths.append(length)
    matrix_indices.append(r.pmatrix_index)
    return branch_lengths, matrix_indices


def rollback_move(rb: Rollback) -> Tuple[List[float], List[int]]:
    """Undo the last SPR or NNI (utree_moves.c:256-302,356-375)."""
    if rb.move_type == UTREE_MOVE_NNI:
        nni(rb.p, rb.nni_type, None)
        return [], []
    if rb.move_type != UTREE_MOVE_SPR:
        raise PllError(ERROR_PARAM_INVALID, "Invalid move type")
    branch_lengths: List[float] = []
    matrix_indices: List[int] = []
    _link(rb.pnb, rb.p.next, rb.pnb_len, rb.pnb.pmatrix_index)
    branch_lengths.append(rb.pnb_len)
    matrix_indices.append(rb.pnb.pmatrix_index)
    _link(rb.pnnb, rb.p.next.next, rb.pnnb_len,
          rb.p.next.next.pmatrix_index)
    branch_lengths.append(rb.pnnb_len)
    matrix_indices.append(rb.p.next.next.pmatrix_index)
    _link(rb.r, rb.rb, rb.r_len, rb.r.pmatrix_index)
    branch_lengths.append(rb.r_len)
    matrix_indices.append(rb.r.pmatrix_index)
    return branch_lengths, matrix_indices


def nni_neighbours(tree) -> List[Tuple[UNode, int]]:
    """(half-edge, move type) of the full NNI neighbourhood of an unrooted
    tree: left and right across each inner edge once, 2 x (tips - 3)
    neighbours in the order of `tree.nodes()`. Each is reached with
    `nni(h, move, rb)` and undone with `rollback_move(rb)`. Reads only the
    tree's links, so it enumerates any tree of the same shape."""
    seen, out = set(), []
    for n in tree.nodes():
        for h in ([] if n.is_tip() else list(n.ring())):
            if h.back is None or h.back.is_tip() or id(h.back) in seen:
                continue
            seen.add(id(h))
            out += [(h, UTREE_MOVE_NNI_LEFT), (h, UTREE_MOVE_NNI_RIGHT)]
    return out
