"""Newick parsing and export for unrooted and rooted trees.

Replaces the reference's flex/bison grammars (reference:
libpll-2 src/parse_utree.y, parse_rtree.y, lex_*.l) with a recursive-
descent parser producing the same structures, ring orientations and default
template indices, so operation lists are interchangeable with the reference.

Export formats mirror utree.c:250-315 / rtree.c:143-230 ("label:%f", fixed
6-decimal lengths) so golden outputs can be compared textually.
"""
from __future__ import annotations

from typing import List

from ..constants import ERROR_NEWICK_SYNTAX, PllError
from .rtree import RNode, RTree, rtree_reset_template_indices
from .utree import UNode, UTree, reset_template_indices


class _Ast:
    __slots__ = ("label", "length", "children")

    def __init__(self, label=None, length=None, children=None):
        self.label = label
        self.length = length
        self.children = children or []


def _tokenize(s: str):
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
            continue
        if c in "(),;:":
            yield c, c
            i += 1
            continue
        if c in "'\"":
            quote = c
            j = s.find(quote, i + 1)
            if j < 0:
                raise PllError(ERROR_NEWICK_SYNTAX, "Unterminated quoted label")
            yield "STRING", s[i + 1:j]
            i = j + 1
            continue
        j = i
        while j < n and s[j] not in "(),;:" and not s[j].isspace():
            j += 1
        yield "STRING", s[i:j]
        i = j


class _Parser:
    def __init__(self, text: str):
        self.tokens = list(_tokenize(text))
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else (None, None)

    def take(self, kind=None):
        t, v = self.peek()
        if kind is not None and t != kind:
            raise PllError(ERROR_NEWICK_SYNTAX,
                           f"syntax error, expected {kind!r} got {t!r}")
        self.pos += 1
        return v

    def parse(self) -> _Ast:
        node = self.subtree()
        self.take(";")
        return node

    def subtree(self) -> _Ast:
        t, _ = self.peek()
        node = _Ast()
        if t == "(":
            self.take("(")
            node.children.append(self.subtree())
            while self.peek()[0] == ",":
                self.take(",")
                node.children.append(self.subtree())
            self.take(")")
        t, v = self.peek()
        if t == "STRING":
            node.label = self.take()
        if self.peek()[0] == ":":
            self.take(":")
            node.length = float(self.take("STRING"))
        return node


def _count_tips(ast: _Ast) -> int:
    if not ast.children:
        return 1
    return sum(_count_tips(c) for c in ast.children)


# --------------------------------------------------------------- unrooted
def _build_unode(ast: _Ast) -> UNode:
    """Build the subtree for one AST node; returns the edge-entry node."""
    length = ast.length if ast.length is not None else 0.0
    if not ast.children:
        tip = UNode(ast.label, length)
        return tip
    entry = UNode(ast.label, length)
    connectors: List[UNode] = []
    for child_ast in ast.children:
        child = _build_unode(child_ast)
        conn = UNode(None, child.length)
        conn.back = child
        child.back = conn
        connectors.append(conn)
    # close the roundabout: entry -> conn1 -> conn2 -> ... -> entry
    ring = [entry] + connectors
    for a, b in zip(ring, ring[1:] + ring[:1]):
        a.next = b
    return entry


def parse_newick(text: str, unroot: bool = False) -> UTree:
    """Parse into the roundabout unrooted representation
    (parse_utree.y:182-238 construction, :270-338 template indices).

    A bifurcating root is accepted only with unroot=True (the reference's
    pll_utree_parse_newick_unroot), which fuses the two root edges."""
    ast = _Parser(text).parse()
    if not ast.children:
        raise PllError(ERROR_NEWICK_SYNTAX, "Tree is a single tip")
    degree = len(ast.children)
    if degree < 2:
        raise PllError(ERROR_NEWICK_SYNTAX, "Root must have >= 2 descendants")
    if degree == 2 and not unroot:
        raise PllError(ERROR_NEWICK_SYNTAX,
                       "Rooted newick: use unroot=True or parse_newick_rooted")

    if degree == 2:
        # unroot in place (pll_utree_unroot_inplace): fuse the two root edges
        c1, c2 = ast.children
        if not c2.children and not c1.children:
            raise PllError(ERROR_NEWICK_SYNTAX,
                           "Cannot unroot a 2-taxon tree")
        if not c2.children:
            c1, c2 = c2, c1  # make c2 the inner child to dissolve
        fused = (c1.length or 0.0) + (c2.length or 0.0)
        c1.length = fused
        ast = _Ast(ast.label, None, [c1] + c2.children)

    # top-level construction (parse_utree.y input rule): the pre-allocated
    # root node replaces the first child's connector
    children = [_build_unode(c) for c in ast.children]
    conns = [UNode(None, c.length) for c in children]
    for conn, child in zip(conns, children):
        conn.back = child
        child.back = conn
    conns[0].label = ast.label
    for a, b in zip(conns, conns[1:] + conns[:1]):
        a.next = b

    root = conns[0]
    tip_count = _count_tips(ast)
    reset_template_indices(root, tip_count)
    inner_count = tip_count - 2 if len(ast.children) == 3 else \
        _count_inner_unrooted(root)
    edge_count = tip_count + inner_count - 1
    return UTree(vroot=root, tip_count=tip_count, inner_count=inner_count,
                 edge_count=edge_count)


def _count_inner_unrooted(root: UNode) -> int:
    seen = set()

    def rec(node: UNode):
        if node.is_tip() or id(node) in seen:
            return 0
        for r in node.ring():
            seen.add(id(r))
        return 1 + sum(rec(r.back) for r in node.ring())

    return rec(root)


def _format_length(length: float) -> str:
    return f"{length:f}"


def _utree_newick_recurse(node: UNode) -> str:
    if node.is_tip():
        return f"{node.label or ''}:{_format_length(node.length)}"
    parts = [_utree_newick_recurse(r.back) for r in list(node.ring())[1:]]
    return (f"({','.join(parts)}){node.label or ''}:"
            f"{_format_length(node.length)}")


def export_newick(root: UNode, rooted: bool = False,
                  root_brlen: float = 0.0) -> str:
    """utree.c:305-315 pll_utree_export_newick[_rooted]."""
    if root.is_tip():
        root = root.back
    sub1 = _utree_newick_recurse(root.back)
    flat = ",".join(_utree_newick_recurse(r.back)
                    for r in list(root.ring())[1:])
    if rooted:
        return (f"({sub1},({flat}){root.label or ''}:"
                f"{_format_length(root_brlen)});")
    return f"({sub1},{flat}){root.label or ''};"


# ----------------------------------------------------------------- rooted
def _build_rnode(ast: _Ast) -> RNode:
    node = RNode(ast.label, ast.length if ast.length is not None else 0.0)
    if ast.children:
        if len(ast.children) != 2:
            raise PllError(ERROR_NEWICK_SYNTAX,
                           "Rooted trees must be strictly bifurcating")
        node.left = _build_rnode(ast.children[0])
        node.right = _build_rnode(ast.children[1])
        node.left.parent = node.right.parent = node
    return node


def parse_newick_rooted(text: str) -> RTree:
    """parse_rtree.y — strictly bifurcating rooted trees."""
    ast = _Parser(text).parse()
    if len(ast.children) != 2:
        raise PllError(ERROR_NEWICK_SYNTAX,
                       "Rooted newick requires a bifurcation at the root")
    root = _build_rnode(ast)
    tip_count = _count_tips(ast)
    rtree_reset_template_indices(root, tip_count)
    return RTree(root=root, tip_count=tip_count,
                 inner_count=tip_count - 1,
                 edge_count=2 * tip_count - 2)


def _rtree_newick_recurse(node: RNode) -> str:
    if node.left is None:
        return f"{node.label or ''}:{_format_length(node.length)}"
    return (f"({_rtree_newick_recurse(node.left)},"
            f"{_rtree_newick_recurse(node.right)})"
            f"{node.label or ''}:{_format_length(node.length)}")


def export_newick_rooted(root: RNode) -> str:
    """rtree.c:192-230."""
    if root.left is None:
        return f"{root.label or ''}:{_format_length(root.length)};"
    return (f"({_rtree_newick_recurse(root.left)},"
            f"{_rtree_newick_recurse(root.right)})"
            f"{root.label or ''};")
