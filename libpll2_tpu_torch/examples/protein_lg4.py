"""20-state amino-acid models: every empirical matrix, plus the LG4X
per-category mixture (reference: examples/protein-list/, examples/lg4/;
port of examples/protein_lg4.py)."""
from __future__ import annotations

from .. import Partition, TreeEngine, compute_gamma_cats
from ..io import maps
from ..models import AA_MODEL_NAMES, load_aa_model, load_mixture_model
from ..trees import create_operations, random_utree, traverse
from ..utils import simulate_alignment
from ._cli import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    tree = random_utree([f"t{i}" for i in range(8)], seed=6)
    headers, seqs = simulate_alignment(
        tree, 200, [1.0 / 20] * 20, [1.0] * 190, alpha=1.0, seed=6)
    by_label = dict(zip(headers, seqs))

    def build(n_matrices):
        part = Partition(tree.tip_count, tree.inner_count, 20, 200,
                         n_matrices, tree.edge_count, 4, tree.inner_count,
                         device=args.device)
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_aa,
                                by_label[tip.label])
        part.set_category_rates(compute_gamma_cats(1.0, 4))
        return part

    print("Empirical models (best first):")
    scores = []
    for name in AA_MODEL_NAMES:
        part = build(1)
        load_aa_model(part, name)
        lk = TreeEngine(part, tree).loglikelihood()
        scores.append((lk, name))
    for lk, name in sorted(scores, reverse=True):
        print(f"  {name:10s} {lk:.4f}")

    # LG4X: one rate matrix per Gamma category, params_indices [0, 1, 2, 3]
    part = build(4)
    load_mixture_model(part, "lg4x")
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    part.update_prob_matrices([0, 1, 2, 3], pmat_idx, branches)
    part.update_partials(ops)
    root = tree.vroot
    lk = part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0, 1, 2, 3])
    print(f"LG4X mixture: {lk:.4f}")


if __name__ == "__main__":
    main()
