"""Randomized stepwise-addition starting trees via fast parsimony.

Port of libpll2_tpu/parsimony/stepwise.py (reference: libpll-2
src/stepwise.c:391-594). The algorithm is preserved exactly (the same glibc
shuffle, edge ordering and first-minimum tie breaking, so the resulting
topology is identical for a given seed). The build runs natively on the
host (native/pllnative.cpp pll_tpu_stepwise): ~N insertions of ~2N
microsecond-scale bit-op scores, a loop that device launches would only
slow down. Without the library it takes the Python loop over
`FastParsimony` on the partition's device, which scores all candidate
edges of the current topology at once (fitch.py batch_insert_scores) and
gives the same tree and cost (`native.load` says so on stderr once).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from ..trees.utree import UNode, UTree, traverse
from ..utils.rng import create_shuffled
from .fitch import FastParsimony
from .sankoff import ParsBuildOp


def _inner_create(i: int, tip_count: int) -> UNode:
    """Three-ring inner node with the reference's index template
    (stepwise.c:151-202)."""
    a, b, c = UNode(), UNode(), UNode()
    a.next, b.next, c.next = b, c, a
    for k, n in enumerate((a, b, c)):
        n.clv_index = tip_count + i
        n.scaler_index = i
        n.node_index = tip_count + i * 3 + k
        n.data = {"clv_valid": False}
    return a


def _tip_create(index: int, label: str) -> UNode:
    n = UNode(label=label)
    n.clv_index = n.node_index = n.pmatrix_index = index
    return n


def _link(a: UNode, b: UNode) -> None:
    a.back = b
    b.back = a


def _edgesplit(a: UNode, b: UNode, c: UNode) -> None:
    """Insert ring halves b, c into edge (a, a.back) (stepwise.c:225-247)."""
    _link(a.back, c)
    _link(a, b)


def _invalidate(node: UNode) -> None:
    for h in node.ring():
        h.data["clv_valid"] = False


def _partial_ops(root: UNode) -> List[ParsBuildOp]:
    """Partial postorder traversal over invalid directional vectors
    (cb_partial_traversal, stepwise.c:117-139)."""
    def cb(node: UNode) -> bool:
        if node.is_tip():
            return True
        if node.data["clv_valid"]:
            return False
        node.data["clv_valid"] = True
        return True

    trav = traverse(root, cbtrav=cb)
    return [ParsBuildOp(n.node_index, n.next.back.node_index,
                        n.next.next.back.node_index)
            for n in trav if not n.is_tip()]


def _rebuild_tree(back: np.ndarray, labels: Sequence[str],
                  order: np.ndarray) -> UTree:
    """UTree from the native engine's half-edge back-link array, with the
    same node objects/indices the Python loop would have produced."""
    tips_count = len(labels)
    root = _inner_create(tips_count - 3, tips_count)
    inner_nodes = [_inner_create(i, tips_count)
                   for i in range(tips_count - 3)]
    by_idx = {}
    for idx in order:
        n = _tip_create(int(idx), labels[int(idx)])
        by_idx[n.node_index] = n
    for n in [root] + inner_nodes:
        for h in n.ring():
            by_idx[h.node_index] = h
            h.data = None
    for i, b in enumerate(back):
        if b >= 0 and i < b:
            _link(by_idx[i], by_idx[int(b)])
    return UTree(vroot=root, tip_count=tips_count,
                 inner_count=tips_count - 2,
                 edge_count=2 * tips_count - 3)


def _stepwise_native(parsimony_list: Sequence[FastParsimony],
                     labels: Sequence[str],
                     seed: int) -> Optional[Tuple[UTree, int]]:
    """Host-native build (native/pllnative.cpp pll_tpu_stepwise): the
    same algorithm with no device launch. None when the native library is
    unavailable; a build the library refuses raises (native.stepwise)."""
    from .. import native
    T = len(labels)
    vecs = [p.packed_host.reshape(T, -1) for p in parsimony_list]
    tip_vecs = np.ascontiguousarray(np.concatenate(vecs, axis=1))
    states = np.array([p.states for p in parsimony_list], dtype=np.int64)
    words = np.array([p.packed_host.shape[-1]
                      for p in parsimony_list], dtype=np.int64)
    order = np.asarray(create_shuffled(T, seed), dtype=np.int32)
    res = native.stepwise(tip_vecs, states, words, order)
    if res is None:
        return None
    back, cost = res
    if T == 3:
        cost = 0
    cost += sum(p.const_cost for p in parsimony_list)
    return _rebuild_tree(back, labels, order), cost


def fastparsimony_stepwise(parsimony_list: Sequence[FastParsimony],
                           labels: Sequence[str],
                           seed: int,
                           use_native: bool = True) -> Tuple[UTree, int]:
    """Returns (tree, parsimony cost). Tip i of the tree keeps clv/node
    index == its position in `labels`, inner nodes get the reference's
    template indices — interchangeable with pll_fastparsimony_stepwise."""
    tips_count = len(labels)
    if tips_count < 3:
        raise C.PllError(C.ERROR_STEPWISE_TIPS,
                         "Stepwise parsimony requires at least three tips.")
    for p in parsimony_list:
        if p.tips != tips_count:
            raise C.PllError(C.ERROR_STEPWISE_STRUCT,
                             "Parsimony structures tips not equal.")
    if use_native:
        out = _stepwise_native(parsimony_list, labels, seed)
        if out is not None:
            return out

    root = _inner_create(tips_count - 3, tips_count)
    inner_nodes = [_inner_create(i, tips_count)
                   for i in range(tips_count - 3)]
    order = create_shuffled(tips_count, seed)
    tip_nodes = [_tip_create(idx, labels[idx]) for idx in order]

    _link(root, tip_nodes[0])
    _link(root.next, tip_nodes[1])
    _link(root.next.next, tip_nodes[2])
    edge_list: List[UNode] = [root, root.next, root.next.next]

    cost = 0
    if tips_count == 3:
        cost = sum(p.const_cost for p in parsimony_list)
    for i in range(3, tips_count):
        inner = inner_nodes[i - 3]
        tip = tip_nodes[i]

        # refresh every directional vector via partial traversals rooted at
        # the tip-adjacent inner halves (stepwise.c:289-318). All traversals
        # concatenate into one update: each is postorder and the validity
        # flags guarantee no op appears twice, so the combined list stays
        # dependency-ordered.
        all_ops: List[ParsBuildOp] = []
        for e in edge_list:
            r = e if not e.is_tip() else e.back
            if not r.back.is_tip():
                continue
            all_ops.extend(_partial_ops(r))
        if all_ops:
            for p in parsimony_list:
                p.update_vectors(all_ops)

        # score all candidate edges at once
        e1 = np.array([e.node_index for e in edge_list], dtype=np.int32)
        e2 = np.array([e.back.node_index for e in edge_list],
                      dtype=np.int32)
        total = np.zeros(len(edge_list), dtype=np.int64)
        for p in parsimony_list:
            total += p.batch_insert_scores(tip.node_index, e1, e2)
        best = int(np.argmin(total))        # first minimum, as reference
        cost = int(total[best])

        # perform the best placement (stepwise.c:365-377)
        _edgesplit(edge_list[best], inner, inner.next)
        _link(inner.next.next, tip)
        edge_list.append(inner.next)
        edge_list.append(inner.next.next)

        # invalidate everything, re-validate what the insertion kept
        for e in edge_list:
            if not e.is_tip():
                _invalidate(e)
        for n in traverse(tip.back):
            if not n.is_tip():
                n.data["clv_valid"] = True
        _invalidate(inner)

    for n in [root] + inner_nodes:
        for h in n.ring():
            h.data = None
    tree = UTree(vroot=root, tip_count=tips_count,
                 inner_count=tips_count - 2,
                 edge_count=2 * tips_count - 3)
    return tree, cost
