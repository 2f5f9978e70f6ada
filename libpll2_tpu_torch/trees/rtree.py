"""Rooted tree structure, traversal and operation compilation.

Mirrors the reference's pll_rnode_t services (reference:
libpll-2 src/rtree.c: traverse :355, create_operations :262,
template indices parse_rtree.y:167-211). Carried over from
libpll2_tpu/trees/rtree.py without the parsimony helpers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from ..constants import (ERROR_TREE_INVALID, SCALE_BUFFER_NONE,
                         TRAVERSE_POSTORDER, TRAVERSE_PREORDER, PllError)
from ..partition import Operation


class RNode:
    __slots__ = ("label", "length", "left", "right", "parent",
                 "node_index", "clv_index", "scaler_index", "pmatrix_index",
                 "data")

    def __init__(self, label: Optional[str] = None, length: float = 0.0):
        self.label = label
        self.length = length
        self.left: Optional[RNode] = None
        self.right: Optional[RNode] = None
        self.parent: Optional[RNode] = None
        self.node_index = 0
        self.clv_index = 0
        self.scaler_index = SCALE_BUFFER_NONE
        self.pmatrix_index = 0
        self.data = None

    def is_tip(self) -> bool:
        return self.left is None

    def __repr__(self):
        return f"RNode({self.label!r}, clv={self.clv_index})"


@dataclass
class RTree:
    root: RNode
    tip_count: int
    inner_count: int
    edge_count: int

    @property
    def node_count(self) -> int:
        return self.tip_count + self.inner_count

    def nodes(self) -> List[RNode]:
        out: List[RNode] = []

        def rec(n: RNode):
            if n.left is not None:
                rec(n.left)
                rec(n.right)
            out.append(n)

        rec(self.root)
        return out

    def tips(self) -> List[RNode]:
        return [n for n in self.nodes() if n.is_tip()]


def rtree_reset_template_indices(root: RNode, tip_count: int) -> None:
    """parse_rtree.y:167-211: tips 0..T-1, inner postorder from T."""
    state = {"tip": 0, "inner": tip_count, "scaler": 0, "node": tip_count}

    def rec(node: RNode):
        if node.left is None:
            node.node_index = node.clv_index = node.pmatrix_index = state["tip"]
            node.scaler_index = SCALE_BUFFER_NONE
            state["tip"] += 1
            return
        rec(node.left)
        rec(node.right)
        node.node_index = state["node"]
        node.clv_index = state["inner"]
        node.scaler_index = state["scaler"]
        node.pmatrix_index = state["inner"]
        state["inner"] += 1
        state["scaler"] += 1
        state["node"] += 1

    rec(root)


def traverse(root: RNode,
             order: int = TRAVERSE_POSTORDER,
             cbtrav: Optional[Callable[[RNode], bool]] = None) -> List[RNode]:
    """rtree.c:323-390."""
    if root.left is None:
        raise PllError(ERROR_TREE_INVALID, "traversal root must be inner")
    out: List[RNode] = []

    def rec(node: RNode):
        if cbtrav is not None and not cbtrav(node):
            return
        if order == TRAVERSE_PREORDER:
            out.append(node)
        if node.left is not None:
            rec(node.left)
            rec(node.right)
        if order == TRAVERSE_POSTORDER:
            out.append(node)

    rec(root)
    return out


def create_operations(trav: Sequence[RNode]):
    """rtree.c:262-321: ops + per-child edges (the root has no edge)."""
    operations: List[Operation] = []
    branches: List[float] = []
    pmatrix_indices: List[int] = []
    for node in trav:
        if node.parent is not None:
            branches.append(node.length)
            pmatrix_indices.append(node.pmatrix_index)
        if node.left is not None:
            operations.append(Operation(
                parent_clv_index=node.clv_index,
                parent_scaler_index=node.scaler_index,
                child1_clv_index=node.left.clv_index,
                child1_matrix_index=node.left.pmatrix_index,
                child1_scaler_index=node.left.scaler_index,
                child2_clv_index=node.right.clv_index,
                child2_matrix_index=node.right.pmatrix_index,
                child2_scaler_index=node.right.scaler_index,
            ))
    return operations, branches, pmatrix_indices
