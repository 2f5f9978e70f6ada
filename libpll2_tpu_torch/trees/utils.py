"""Tree utilities: integrity checking, cloning, rooted->unrooted conversion,
bipartitions and the consumers' split statistics.

Reference: libpll-2 src/utree.c:464-760, src/rtree.c. Carried over whole
(libpll2_tpu/trees/utils.py) so that the port imports no jax.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..constants import (ERROR_PARAM_INVALID, ERROR_TREE_CONVERSION,
                         ERROR_TREE_INVALID, PllError)
from .rtree import RNode, RTree
from .utree import UNode, UTree, link, reset_template_indices


def check_integrity(tree: UTree, binary: bool = True) -> bool:
    """pll_utree_check_integrity (utree.c:464-553): consistent edge
    attributes across back pointers, consistent ring attributes, closed
    roundabouts. Raises PllError on the first violation."""
    for node in tree.nodes():
        halves = [node] if node.is_tip() else list(node.ring())
        for h in halves:
            if h.back is None:
                raise PllError(ERROR_TREE_INVALID,
                               f"Unlinked half-edge at clv {h.clv_index}")
            if h.back.length != h.length:
                raise PllError(ERROR_TREE_INVALID,
                               f"Inconsistent branch lengths: {h.length} != "
                               f"{h.back.length}")
            if h.back.pmatrix_index != h.pmatrix_index:
                raise PllError(ERROR_TREE_INVALID,
                               f"Inconsistent pmatrix indices: "
                               f"{h.pmatrix_index} != "
                               f"{h.back.pmatrix_index}")
        if not node.is_tip():
            if binary and len(halves) != 3:
                raise PllError(ERROR_TREE_INVALID,
                               "Multifurcation found in a binary tree at "
                               f"node with clv_index = {node.clv_index}")
            for h in halves[1:]:
                if h.clv_index != node.clv_index:
                    raise PllError(ERROR_TREE_INVALID,
                                   f"Inconsistent CLV indices: "
                                   f"{node.clv_index} != {h.clv_index}")
                if h.scaler_index != node.scaler_index:
                    raise PllError(ERROR_TREE_INVALID,
                                   f"Inconsistent scaler indices: "
                                   f"{node.scaler_index} != "
                                   f"{h.scaler_index}")
    return True


def _clone_half(h: UNode) -> UNode:
    n = UNode(label=h.label, length=h.length)
    n.node_index = h.node_index
    n.clv_index = h.clv_index
    n.scaler_index = h.scaler_index
    n.pmatrix_index = h.pmatrix_index
    return n


def graph_clone(root: UNode) -> UNode:
    """Deep-copy the node graph (pll_utree_graph_clone, utree.c:551-633)."""
    mapping: Dict[int, UNode] = {}

    def get(h: UNode) -> UNode:
        if id(h) not in mapping:
            mapping[id(h)] = _clone_half(h)
        return mapping[id(h)]

    stack = [root]
    seen = set()
    while stack:
        h = stack.pop()
        if id(h) in seen:
            continue
        seen.add(id(h))
        c = get(h)
        if h.next is not None:
            c.next = get(h.next)
            stack.append(h.next)
        if h.back is not None:
            c.back = get(h.back)
            stack.append(h.back)
    return mapping[id(root)]


def utree_clone(tree: UTree) -> UTree:
    """pll_utree_clone (utree.c:635-682)."""
    return UTree(vroot=graph_clone(tree.vroot), tip_count=tree.tip_count,
                 inner_count=tree.inner_count, edge_count=tree.edge_count)


def rtree_unroot(tree: RTree) -> UTree:
    """Convert a rooted tree into an unrooted one by dissolving the root
    into an edge between its children (pll_rtree_unroot, utree.c:684-760):
    the root's right child becomes one endpoint, the left child's ring the
    other; branch lengths of the two root edges are summed."""
    root = tree.root
    if root.left is None or root.right is None:
        raise PllError(ERROR_TREE_CONVERSION, "Root must have two children")
    if root.left.left is None and root.right.left is None:
        raise PllError(ERROR_TREE_CONVERSION,
                       "Tree requires at least three tips to be converted "
                       "to unrooted")
    # pick an inner child to dissolve into
    new_root_r = root.left if root.left.left is not None else root.right
    other_r = root.right if new_root_r is root.left else root.left
    length = root.left.length + root.right.length

    def convert(rnode: RNode, parent_half: Optional[UNode]) -> UNode:
        """Build the unrooted subtree below rnode; returns the half-edge
        facing the parent."""
        if rnode.left is None:
            tip = UNode(label=rnode.label, length=rnode.length)
            return tip
        entry = UNode(label=rnode.label, length=rnode.length)
        h1 = UNode(label=rnode.label)
        h2 = UNode(label=rnode.label)
        entry.next, h1.next, h2.next = h1, h2, entry
        c1 = convert(rnode.left, h1)
        c2 = convert(rnode.right, h2)
        link(h1, c1, rnode.left.length)
        link(h2, c2, rnode.right.length)
        return entry

    # dissolve: new_root ring gets three children — its own two plus the
    # other side of the old root
    entry = UNode(label=new_root_r.label)
    h1 = UNode(label=new_root_r.label)
    h2 = UNode(label=new_root_r.label)
    entry.next, h1.next, h2.next = h1, h2, entry
    c1 = convert(new_root_r.left, h1)
    c2 = convert(new_root_r.right, h2)
    link(h1, c1, new_root_r.left.length)
    link(h2, c2, new_root_r.right.length)
    other = convert(other_r, entry)
    link(entry, other, length)

    tips = len([n for n in _iter_unodes(entry) if n.is_tip()])
    reset_template_indices(entry, tips)
    return UTree(vroot=entry, tip_count=tips, inner_count=tips - 2,
                 edge_count=2 * tips - 3)


def _iter_unodes(root: UNode):
    seen = set()
    stack = [root]
    while stack:
        h = stack.pop()
        if id(h) in seen or h is None:
            continue
        ring = [h] if h.is_tip() else list(h.ring())
        if any(id(r) in seen for r in ring):
            continue
        for r in ring:
            seen.add(id(r))
        yield h
        for r in ring:
            if r.back is not None:
                stack.append(r.back)


def tree_bipartitions(tree: UTree):
    """Non-trivial bipartitions as a set of frozensets of tip labels
    (each internal edge splits the taxa; the side not containing the
    lexicographically smallest label canonicalizes the split)."""
    all_labels = frozenset(t.label for t in tree.tips())
    anchor = min(all_labels)
    splits = set()

    def tips_below(h):
        """Tip labels on the far side of half-edge h."""
        if h.back.is_tip():
            return {h.back.label}
        out = set()
        stack = [h.back]
        while stack:
            node = stack.pop()
            for nh in node.ring():
                if nh is node:
                    continue
                if nh.back.is_tip():
                    out.add(nh.back.label)
                else:
                    stack.append(nh.back)
        return out

    seen = set()
    for node in tree.nodes():
        if node.is_tip():
            continue
        for h in node.ring():
            if h.back is None or h.back.is_tip() or id(h) in seen \
                    or id(h.back) in seen:
                continue
            seen.add(id(h)), seen.add(id(h.back))
            side = frozenset(tips_below(h))
            if anchor in side:
                side = all_labels - side
            if 1 < len(side) < len(all_labels) - 1:
                splits.add(side)
    return splits


def rf_distance(tree_a: UTree, tree_b: UTree,
                normalized: bool = False) -> float:
    """Robinson-Foulds distance between two unrooted trees over the same
    taxa: the symmetric difference of their non-trivial bipartition sets
    (the standard topology metric consumers report; one NNI move changes
    exactly one bipartition, so adjacent topologies are at RF 2)."""
    la = {t.label for t in tree_a.tips()}
    lb = {t.label for t in tree_b.tips()}
    if la != lb:
        raise PllError(ERROR_PARAM_INVALID,
                       "trees must share an identical taxon set")
    sa, sb = tree_bipartitions(tree_a), tree_bipartitions(tree_b)
    rf = len(sa ^ sb)
    if not normalized:
        return float(rf)
    denom = len(sa) + len(sb)
    return rf / denom if denom else 0.0


def edge_support(tree: UTree, replicate_trees) -> dict:
    """Bootstrap support per non-trivial bipartition of `tree`: the
    fraction of replicate trees containing the same split (what
    consumers annotate onto internal edges after a bootstrap search).
    Returns {bipartition(frozenset of labels): support in [0, 1]}."""
    target = tree_bipartitions(tree)
    counts = {s: 0 for s in target}
    reps = list(replicate_trees)
    labels = {t.label for t in tree.tips()}
    for rt in reps:
        if {t.label for t in rt.tips()} != labels:
            raise PllError(ERROR_PARAM_INVALID,
                           "replicate trees must share the target "
                           "tree's taxon set")
        for s in tree_bipartitions(rt) & target:
            counts[s] += 1
    n = max(len(reps), 1)
    return {s: c / n for s, c in counts.items()}


def majority_rule_consensus(trees, threshold: float = 0.5):
    """Majority-rule consensus: the set of bipartitions appearing in more
    than `threshold` of the input trees (threshold 0.5 guarantees the
    splits are pairwise compatible). Returns a list of
    (bipartition, support) sorted by support, descending — the split set
    consumers feed into consensus-tree construction and reporting."""
    trees = list(trees)
    if not trees:
        return []
    counts: dict = {}
    for t in trees:
        for s in tree_bipartitions(t):
            counts[s] = counts.get(s, 0) + 1
    n = len(trees)
    out = [(s, c / n) for s, c in counts.items() if c / n > threshold]
    return sorted(out, key=lambda kv: -kv[1])


def prune_tip(tree: UTree, label: str) -> UNode:
    """Remove the named tip IN PLACE (the classic leaf-prune: the tip's
    inner neighbor dissolves, its two other neighbors join with summed
    branch length). Returns a surviving inner node to re-root/export
    from. The tree object's counts become stale — re-parse the exported
    newick for a consistent UTree."""
    tip = next((t for t in tree.tips() if t.label == label), None)
    if tip is None:
        raise PllError(ERROR_PARAM_INVALID, f"no tip labelled {label!r}")
    inner = tip.back
    ring = [h for h in inner.ring() if h is not inner]
    a, b = ring[0].back, ring[1].back
    length = ring[0].length + ring[1].length
    a.back, b.back = b, a
    a.length = b.length = length
    return a if not a.is_tip() else b
