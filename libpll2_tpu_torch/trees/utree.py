"""Unrooted tree structure, traversal and operation-list compilation.

Re-implements the reference's "roundabout" unrooted tree (reference:
libpll-2 src/pll.h:377-400 pll_unode_t; libpll-2 src/utree.c)
in Python: each internal node of degree d is a ring of d UNode objects linked
by `next`, each with a `back` pointer across an edge. Index template rules
match the reference newick parser (parse_utree.y:270-338) so operation lists
and buffer indices are interchangeable with the reference:

  * tips get node/clv/pmatrix index 0..tips-1, scaler NONE;
  * inner rings share clv index tips+k and scaler k;
  * the pmatrix index of an edge is the clv index of the node on the
    "child" end (towards the traversal root: back->pmatrix for the ring
    entry point, own clv index otherwise).

Carried over from libpll2_tpu/trees/utree.py so that the port imports no
jax (the parsimony and level-schedule helpers come with their slices).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from ..constants import (ERROR_TREE_INVALID, SCALE_BUFFER_NONE,
                         TRAVERSE_POSTORDER, TRAVERSE_PREORDER, PllError)
from ..partition import Operation


class UNode:
    """One directed half-edge of the roundabout representation."""
    __slots__ = ("label", "length", "next", "back", "node_index",
                 "clv_index", "scaler_index", "pmatrix_index", "data")

    def __init__(self, label: Optional[str] = None, length: float = 0.0):
        self.label = label
        self.length = length
        self.next: Optional[UNode] = None   # None marks a tip
        self.back: Optional[UNode] = None
        self.node_index = 0
        self.clv_index = 0
        self.scaler_index = SCALE_BUFFER_NONE
        self.pmatrix_index = 0
        self.data = None

    def is_tip(self) -> bool:
        return self.next is None

    def ring(self):
        """Iterate the ring this node belongs to (itself first)."""
        yield self
        n = self.next
        while n is not None and n is not self:
            yield n
            n = n.next

    def __repr__(self):
        return (f"UNode({self.label!r}, clv={self.clv_index}, "
                f"len={self.length})")


@dataclass
class UTree:
    """A parsed unrooted tree: vnode is an inner node used as virtual root."""
    vroot: UNode
    tip_count: int
    inner_count: int
    edge_count: int

    @property
    def node_count(self) -> int:
        return self.tip_count + self.inner_count

    def nodes(self) -> List[UNode]:
        """All ring entry points + tips, unique per node (not per half-edge)."""
        out: List[UNode] = []
        seen = set()

        def rec(node: UNode):
            if node.is_tip():
                out.append(node)
                return
            if id(node) in seen:
                return
            for r in node.ring():
                seen.add(id(r))
            out.append(node)
            for r in node.ring():
                if r.back is not None:
                    if r.back.is_tip() or id(r.back) not in seen:
                        rec(r.back)

        rec(self.vroot)
        return out

    def tips(self) -> List[UNode]:
        return [n for n in self.nodes() if n.is_tip()]


def link(a: UNode, b: UNode, length: float = 0.0) -> None:
    a.back = b
    b.back = a
    a.length = b.length = length


def reset_template_indices(root: UNode, tip_count: int) -> None:
    """Assign default clv/scaler/pmatrix indices (parse_utree.y:321-338)."""
    state = {"tip": 0, "inner_clv": tip_count, "inner_node": tip_count,
             "scaler": 0}

    if root.is_tip():
        root = root.back

    def rec(node: UNode, level: int):
        if node.is_tip():
            node.node_index = node.clv_index = node.pmatrix_index = state["tip"]
            node.scaler_index = SCALE_BUFFER_NONE
            state["tip"] += 1
            return
        start = node.next if level else node
        snode = start
        while True:
            rec(snode.back, level + 1)
            snode = snode.next
            if snode is node:
                break
        snode = node
        while True:
            snode.node_index = state["inner_node"]
            state["inner_node"] += 1
            snode.clv_index = state["inner_clv"]
            snode.scaler_index = state["scaler"]
            if snode is node and level > 0:
                snode.pmatrix_index = state["inner_clv"]
            else:
                snode.pmatrix_index = snode.back.pmatrix_index
            snode = snode.next
            if snode is node:
                break
        state["inner_clv"] += 1
        state["scaler"] += 1

    rec(root, 0)


def traverse(root: UNode,
             order: int = TRAVERSE_POSTORDER,
             cbtrav: Optional[Callable[[UNode], bool]] = None) -> List[UNode]:
    """Callback-filtered traversal (utree.c:393-462, exact node order).

    Starting at an inner node `root`, first descends through root->back's
    subtree, then through root's own side. `cbtrav` returning False prunes a
    subtree (used for partial traversals over still-valid CLVs)."""
    if root.is_tip():
        raise PllError(ERROR_TREE_INVALID,
                       "traversal root must be an inner node")
    if order not in (TRAVERSE_POSTORDER, TRAVERSE_PREORDER):
        raise PllError(ERROR_TREE_INVALID, "Invalid traversal order")
    out: List[UNode] = []

    def rec(node: UNode):
        if cbtrav is not None and not cbtrav(node):
            return
        if order == TRAVERSE_PREORDER:
            out.append(node)
        if not node.is_tip():
            snode = node.next
            while snode is not node:
                rec(snode.back)
                snode = snode.next
        if order == TRAVERSE_POSTORDER:
            out.append(node)

    rec(root.back)
    rec(root)
    return out


def create_operations(trav: Sequence[UNode]):
    """Compile a postorder traversal into operations + edge updates
    (utree.c:317-366). Returns (operations, branch_lengths, pmatrix_indices).
    """
    operations: List[Operation] = []
    branches: List[float] = []
    pmatrix_indices: List[int] = []
    last_back = trav[-1].back if trav else None

    for node in trav:
        # record the edge towards the traversal root, skipping the second
        # endpoint of the root edge (it would duplicate the root's own entry)
        if node is not last_back:
            branches.append(node.length)
            pmatrix_indices.append(node.pmatrix_index)
        if not node.is_tip():
            c1 = node.next.back
            c2 = node.next.next.back
            if node.next.next.next is not node:
                raise PllError(ERROR_TREE_INVALID,
                               "operations require binary inner nodes")
            operations.append(Operation(
                parent_clv_index=node.clv_index,
                parent_scaler_index=node.scaler_index,
                child1_clv_index=c1.clv_index,
                child1_matrix_index=c1.pmatrix_index,
                child1_scaler_index=c1.scaler_index,
                child2_clv_index=c2.clv_index,
                child2_matrix_index=c2.pmatrix_index,
                child2_scaler_index=c2.scaler_index,
            ))
    return operations, branches, pmatrix_indices
