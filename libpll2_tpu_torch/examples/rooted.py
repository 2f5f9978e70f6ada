"""Rooted-tree evaluation (reference: examples/rooted + rooted-tacg; port
of examples/rooted.py): parse a rooted newick, compile rooted operations,
and compute the ROOT log-likelihood (weighted by the stationary
frequencies at the root node) rather than an edge likelihood.
"""
from __future__ import annotations

import numpy as np

from .. import Partition, compute_gamma_cats
from ..io import maps
from ..trees import parse_newick_rooted, rtree
from ._cli import parser

NEWICK = "((A:0.15,B:0.25):0.10,(C:0.20,(D:0.05,E:0.30):0.15):0.05);"
SEQS = {"A": "CTGAGCTGGGGAAGGCTGAACGCTATTAGC",
        "B": "CTGAGCTGGGAAAGACTGAACGCTATTAGC",
        "C": "CTGAGCCGGGAGAGGTTGAACGTTATTCGC",
        "D": "CTCAGCCGGGAAAGGTCGAACGTTATTCGC",
        "E": "CTCAGCCGGAAAAGGTCGAACGTTATCCGC"}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    tree = parse_newick_rooted(NEWICK)
    trav = rtree.traverse(tree.root)
    ops, branches, pmat_idx = rtree.create_operations(trav)
    sites = len(next(iter(SEQS.values())))

    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     len(branches), 4, tree.inner_count, device=args.device)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, SEQS[t.label])
    part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))

    pidx = [0] * 4
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    r = tree.root
    total, per_site = part.compute_root_loglikelihood(
        r.clv_index, r.scaler_index, pidx, persite=True)
    print(f"rooted logL = {total:.6f}")
    print("worst 3 sites:",
          np.argsort(per_site)[:3].tolist(),
          [f"{per_site[i]:.3f}" for i in np.argsort(per_site)[:3]])


if __name__ == "__main__":
    main()
