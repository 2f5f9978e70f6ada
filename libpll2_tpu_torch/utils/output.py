"""Debug pretty-printers (pll_show_pmatrix / pll_show_clv).

Port of libpll2_tpu/utils/output.py (reference src/output.c:26-101), whose
strings it prints. Repeat-aware: `Partition.get_clv` expands a repeats
partition's class columns through site_id, as the reference does through
pll_get_clv_size.
"""
from __future__ import annotations

import sys


def show_pmatrix(partition, index: int, float_precision: int = 4,
                 file=None) -> None:
    """output.c:26-54."""
    out = file or sys.stdout
    p = partition.get_pmatrix(index)        # [R, s, s]
    for r in range(p.shape[0]):
        for i in range(p.shape[1]):
            row = " ".join(f"{v:.{float_precision}f}" for v in p[r, i])
            print(row, file=out)
        print(file=out)


def show_clv(partition, clv_index: int, scaler_index: int = -1,
             float_precision: int = 4, file=None) -> None:
    """output.c:56-101: per site, per rate category, the state vector in
    parentheses."""
    out = file or sys.stdout
    clv = partition.get_clv(clv_index)      # [sites, R, s]
    for s in range(clv.shape[0]):
        cats = []
        for r in range(clv.shape[1]):
            vals = ",".join(f"{v:.{float_precision}f}" for v in clv[s, r])
            cats.append(f"({vals})")
        print(" ".join(cats), file=out)


def show_tree_ascii(node, file=None) -> None:
    """ASCII tree plot (pll_utree_show_ascii, utree.c:90-131)."""
    out = file or sys.stdout

    def rec(n, prefix: str, is_last: bool):
        connector = "+-" if prefix else ""
        label = n.label or ""
        print(f"{prefix}{connector}{label} [{n.length:.6f}]", file=out)
        if not n.is_tip():
            ext = "  " if is_last else "| "
            children = [h.back for h in list(n.ring())[1:]]
            for i, c in enumerate(children):
                rec(c, prefix + ext, i == len(children) - 1)

    root = node if not node.is_tip() else node.back
    subtrees = [root.back] + [h.back for h in list(root.ring())[1:]]
    print("(virtual root)", file=out)
    for i, s in enumerate(subtrees):
        rec(s, "", i == len(subtrees) - 1)
