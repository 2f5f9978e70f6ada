"""Full-tree logL on an unrooted tree (reference:
examples/newick-fasta-unrooted/; port of examples/unrooted.py).

Usage: python -m libpll2_tpu_torch.examples.unrooted [msa.fa tree.nwk]
       [--device cpu]"""
from __future__ import annotations

from .. import Partition, TreeEngine, compute_gamma_cats
from ..io import load_fasta, maps
from ..trees import parse_newick, random_alignment, random_utree
from ._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("msa", nargs="?", default=None)
    ap.add_argument("nwk", nargs="?", default=None)
    args = ap.parse_args(argv)
    if args.msa:
        headers, seqs = load_fasta(args.msa)
        with open(args.nwk) as fh:
            tree = parse_newick(fh.read(), unroot=True)
    else:
        headers, seqs = random_alignment(16, 500, seed=1)
        tree = random_utree(headers, seed=1)

    part = Partition(tree.tip_count, tree.inner_count, 4, len(seqs[0]), 1,
                     tree.edge_count, 4, tree.inner_count,
                     device=args.device)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, [0.25, 0.25, 0.25, 0.25])
    part.set_subst_params(0, [1, 1, 1, 1, 1, 1])          # JC69
    part.set_category_rates(compute_gamma_cats(1.0, 4))

    engine = TreeEngine(part, tree)
    lk = engine.loglikelihood()
    print(f"Log-likelihood: {lk:.6f}")


if __name__ == "__main__":
    main()
