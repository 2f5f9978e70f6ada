"""Randomized stepwise-addition starting tree via fast parsimony, then a
likelihood evaluation on it (reference: examples/stepwise/,
examples/parsimony/; port of examples/stepwise_parsimony.py).

Usage: python -m libpll2_tpu_torch.examples.stepwise_parsimony [seed]
       [--device cpu]"""
from __future__ import annotations

from .. import Partition, TreeEngine, compute_gamma_cats
from ..io import maps
from ..parsimony import FastParsimony
from ..parsimony.stepwise import fastparsimony_stepwise
from ..trees import export_newick, random_utree
from ..trees.utree import reset_template_indices
from ..utils import simulate_alignment
from ._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("seed", nargs="?", type=int, default=42)
    args = ap.parse_args(argv)
    seed, device = args.seed, args.device
    true_tree = random_utree([f"t{i}" for i in range(24)], seed=8)
    headers, seqs = simulate_alignment(true_tree, 600, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=8)
    n, sites = len(headers), len(seqs[0])

    part = Partition(n, n - 2, 4, sites, 1, 2 * n - 3, 1, n - 2,
                     device=device)
    for i, s in enumerate(seqs):
        part.set_tip_states(i, maps.map_nt, s)
    pars = FastParsimony(part)
    tree, cost = fastparsimony_stepwise([pars], headers, seed)
    print(f"Stepwise tree (seed {seed}): parsimony score {cost}")
    print(export_newick(tree.vroot)[:120], "...")

    # evaluate likelihood on the starting tree (default branch lengths)
    seen = set()
    for node in tree.nodes():
        for h in ([node] if node.is_tip() else list(node.ring())):
            if h.back is not None and id(h) not in seen:
                seen.add(id(h)), seen.add(id(h.back))
                h.length = h.back.length = 0.1
    reset_template_indices(tree.vroot, tree.tip_count)
    lpart = Partition(n, n - 2, 4, sites, 1, 2 * n - 3, 4, n - 2,
                      device=device)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        lpart.set_tip_states(tip.clv_index, maps.map_nt,
                             by_label[tip.label])
    lpart.set_frequencies(0, [0.25] * 4)
    lpart.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    lpart.set_category_rates(compute_gamma_cats(0.9, 4))
    lk = TreeEngine(lpart, tree).loglikelihood()
    print(f"logL on starting tree: {lk:.4f}")


if __name__ == "__main__":
    main()
