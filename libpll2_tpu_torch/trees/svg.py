"""SVG visualization of unrooted trees.

Port of libpll2_tpu/trees/svg.py, host code whose document it reproduces
character for character. Reference: src/utree_svg.c (pll_utree_export_svg
with a pll_svg_attrib_t options struct, pll.h:501-516). Same model: the tree
is drawn rooted at vroot.back, horizontal branch lengths to scale (with a
configurable precision legend), tips evenly spaced vertically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .utree import UNode


@dataclass
class SvgAttrib:
    """pll_svg_attrib_t (pll.h:501-516); -1 = auto."""
    width: int = 800
    font_size: int = 12
    tip_spacing: int = 20
    stroke_width: float = 3.0
    legend_show: bool = True
    legend_font_size: int = 10
    legend_ratio: float = 0.1
    margin_left: int = 20
    margin_right: int = 20
    margin_top: int = 20
    margin_bottom: int = 20
    node_radius: float = 0.0
    precision: int = 7


def _max_depth(node: UNode) -> float:
    if node.is_tip():
        return node.length
    return node.length + max(_max_depth(h.back) for h in list(node.ring())[1:])


def _tip_count(node: UNode) -> int:
    if node.is_tip():
        return 1
    return sum(_tip_count(h.back) for h in list(node.ring())[1:])


def export_svg(root: UNode, attrib: Optional[SvgAttrib] = None) -> str:
    """Returns the SVG document as a string (pll_utree_export_svg,
    utree_svg.c:404-465)."""
    a = attrib or SvgAttrib()
    if root.is_tip():
        root = root.back

    # draw as rooted at `root`, subtrees = back + ring members
    subtrees = [root.back] + [h.back for h in list(root.ring())[1:]]
    n_tips = sum(_tip_count(s) for s in subtrees)
    depth = max(_max_depth(s) for s in subtrees)
    depth = depth or 1.0

    draw_w = a.width - a.margin_left - a.margin_right
    height = n_tips * a.tip_spacing + a.margin_top + a.margin_bottom
    if a.legend_show:
        height += 2 * a.legend_font_size
    scale = draw_w / depth

    lines: List[str] = []
    texts: List[str] = []
    state = {"y": a.margin_top}

    def draw(node: UNode, x: float) -> float:
        """Returns the vertical center of the subtree rooted at node."""
        x2 = x + node.length * scale
        if node.is_tip():
            y = state["y"]
            state["y"] += a.tip_spacing
            lines.append(
                f'<line x1="{x:.2f}" y1="{y:.2f}" x2="{x2:.2f}" '
                f'y2="{y:.2f}" stroke="black" '
                f'stroke-width="{a.stroke_width}"/>')
            texts.append(
                f'<text x="{x2 + 5:.2f}" y="{y + a.font_size / 3:.2f}" '
                f'font-size="{a.font_size}">{node.label or ""}</text>')
            return y
        ys = [draw(h.back, x2) for h in list(node.ring())[1:]]
        y = (min(ys) + max(ys)) / 2
        lines.append(
            f'<line x1="{x:.2f}" y1="{y:.2f}" x2="{x2:.2f}" y2="{y:.2f}" '
            f'stroke="black" stroke-width="{a.stroke_width}"/>')
        lines.append(
            f'<line x1="{x2:.2f}" y1="{min(ys):.2f}" x2="{x2:.2f}" '
            f'y2="{max(ys):.2f}" stroke="black" '
            f'stroke-width="{a.stroke_width}"/>')
        return y

    ys = [draw(s, a.margin_left) for s in subtrees]
    y0 = (min(ys) + max(ys)) / 2
    lines.append(
        f'<line x1="{a.margin_left:.2f}" y1="{min(ys):.2f}" '
        f'x2="{a.margin_left:.2f}" y2="{max(ys):.2f}" stroke="black" '
        f'stroke-width="{a.stroke_width}"/>')

    legend = ""
    if a.legend_show:
        bar = depth * a.legend_ratio * scale
        y = height - a.margin_bottom
        legend = (
            f'<line x1="{a.margin_left}" y1="{y}" '
            f'x2="{a.margin_left + bar:.2f}" y2="{y}" stroke="black" '
            f'stroke-width="{a.stroke_width}"/>'
            f'<text x="{a.margin_left + bar + 5:.2f}" y="{y + 4}" '
            f'font-size="{a.legend_font_size}">'
            f'{depth * a.legend_ratio:.{a.precision}f}</text>')

    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{a.width}" '
            f'height="{height}">' + "".join(lines) + "".join(texts)
            + legend + "</svg>")
