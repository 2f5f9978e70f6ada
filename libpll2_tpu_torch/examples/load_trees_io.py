"""Tree + alignment I/O round-trips (port of examples/load_trees_io.py):
parse unrooted/rooted newick (string or file), auto-unroot a rooted tree,
export newick back out, render ASCII, and read PHYLIP (sequential +
interleaved) into a likelihood evaluation.

Reference analogs: examples/load-utree, examples/newick-export,
examples/newick-fasta-rooted, examples/newick-phylip-unrooted.
"""
from __future__ import annotations

import os
import tempfile

from .. import Partition, TreeEngine, compute_gamma_cats
from ..io import maps
from ..io.phylip import parse_phylip
from ..trees import (export_newick, export_newick_rooted, parse_newick,
                     parse_newick_rooted, traverse)
from ..utils.output import show_tree_ascii
from ._cli import parser

UNROOTED = ("((A:0.1,B:0.2):0.05,(C:0.3,D:0.1):0.07,E:0.15);")
ROOTED = ("(((A:0.1,B:0.2):0.05,C:0.3):0.02,(D:0.1,E:0.15):0.08);")

SEQS = {
    "A": "ACGTACGTACGTACGTACGT",
    "B": "ACGTACGAACGTACCTACGT",
    "C": "ACGAACGTACGTACGTACGA",
    "D": "CCGTACGTAAGTACGTACGT",
    "E": "ACGTACGTACGTGCGTACTT",
}


def phylip_files(d):
    """Write the toy MSA in both PHYLIP layouts into directory `d`; return
    the two paths."""
    seq_path = os.path.join(d, "seq.phy")
    int_path = os.path.join(d, "int.phy")
    names = sorted(SEQS)
    with open(seq_path, "w") as fh:
        fh.write(f" {len(names)} {len(SEQS['A'])}\n")
        for n in names:
            fh.write(f"{n:<10}{SEQS[n]}\n")
    with open(int_path, "w") as fh:
        fh.write(f" {len(names)} {len(SEQS['A'])}\n")
        half = len(SEQS["A"]) // 2
        for n in names:
            fh.write(f"{n:<10}{SEQS[n][:half]}\n")
        fh.write("\n")
        for n in names:
            fh.write(f"{' ':<10}{SEQS[n][half:]}\n")
    return seq_path, int_path


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    # -- load-utree: parse, traverse, inspect ---------------------------
    tree = parse_newick(UNROOTED)
    print(f"unrooted: {tree.tip_count} tips, {tree.inner_count} inner, "
          f"{tree.edge_count} edges")
    trav = traverse(tree.vroot)
    print("postorder traversal:",
          [n.label or f"inner{n.clv_index}" for n in trav])
    show_tree_ascii(tree.vroot)

    # -- newick-export: round-trip is parse-stable ----------------------
    out = export_newick(tree.vroot)
    again = export_newick(parse_newick(out).vroot)
    print("newick export:", out)
    print("round-trip stable:", out == again)

    # -- rooted parse + auto-unroot + rooted export ---------------------
    rooted = parse_newick_rooted(ROOTED)
    print(f"rooted: {rooted.tip_count} tips -> export: "
          f"{export_newick_rooted(rooted.root)}")
    unrooted = parse_newick(ROOTED, unroot=True)   # fuses the root edges
    print(f"auto-unroot: {unrooted.tip_count} tips, "
          f"{unrooted.edge_count} edges (root edges fused)")

    # -- newick-phylip-unrooted: PHYLIP -> logL on the parsed tree ------
    with tempfile.TemporaryDirectory(prefix="pll_io_") as d:
        seq_path, int_path = phylip_files(d)
        h1, s1 = parse_phylip(seq_path)
        h2, s2 = parse_phylip(int_path, interleaved=True)
    if (h1, s1) != (h2, s2):
        raise RuntimeError("the two PHYLIP layouts decode differently")
    sites = len(s1[0])
    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     tree.edge_count, 4, tree.inner_count,
                     device=args.device)
    by = dict(zip(h1, s1))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1] * 6)
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    lk = TreeEngine(part, tree).loglikelihood()
    print(f"PHYLIP ({len(h1)} x {sites}) JC+G4 logL: {lk:.6f}")


if __name__ == "__main__":
    main()
