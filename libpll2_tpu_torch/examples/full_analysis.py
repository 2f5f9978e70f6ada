"""End-to-end phylogenetic analysis (port of examples/full_analysis.py):
the pipeline the reference's consumers (RAxML-NG et al.) build from
libpll, composed from this package:

  1. alignment -> pattern compression
  2. parsimony stepwise-addition starting tree (bit-reproducible)
  3. model optimization on the fused path (batched central-difference
     Adam over subst + freqs, each step's trials one launch of the fused
     kernel) + all-branches Newton smoothing
  4. NNI hill climbing scored from directional CLVs (streamed round)
  5. bootstrap support from ONE evaluation (logL is weight-linear)
  6. checkpoint of the final model + tree

Usage: python -m libpll2_tpu_torch.examples.full_analysis [seed]
       [--device cpu] [--ckpt PATH]
"""
from __future__ import annotations

import time

from .. import (Partition, TreeEngine, bootstrap_loglikelihoods, checkpoint,
                compute_gamma_cats)
from ..io import maps
from ..io.compress import compress_site_patterns
from ..optimize import (maximize_fused, maximize_loglikelihood,
                        newton_smooth_all)
from ..parsimony import FastParsimony
from ..parsimony.stepwise import fastparsimony_stepwise
from ..search import TreeSearch
from ..trees import export_newick, random_utree
from ..trees.utree import reset_template_indices
from ..utils import simulate_alignment
from ._cli import parser


def run(seed=42, taxa=24, sites=1200, steps=75, replicates=1000,
        ckpt="analysis.ckpt.npz", device="cuda"):
    """The pipeline on `taxa` x `sites` simulated columns, `steps` Adam
    steps a model round, `replicates` bootstrap replicates, the checkpoint
    written to `ckpt`; prints the example's lines and returns the final
    logL."""
    t0 = time.time()
    # --- data (simulated here; swap in load_fasta for real alignments) ---
    true_tree = random_utree([f"t{i}" for i in range(taxa)], seed=seed)
    headers, seqs = simulate_alignment(true_tree, sites,
                                       [0.3, 0.2, 0.2, 0.3],
                                       [1.2, 3.5, 0.8, 1.1, 3.0, 1.0],
                                       alpha=0.8, seed=seed)
    n = len(headers)

    # --- 1. pattern compression -----------------------------------------
    comp, weights, _ = compress_site_patterns(seqs, maps.map_nt)
    patterns = len(comp[0])
    print(f"[{time.time()-t0:5.1f}s] compressed {len(seqs[0])} sites -> "
          f"{patterns} patterns")

    # --- 2. parsimony starting tree -------------------------------------
    pars_part = Partition(n, n - 2, 4, patterns, 1, 2 * n - 3, 1, n - 2,
                          device=device)
    for i, s in enumerate(comp):
        pars_part.set_tip_states(i, maps.map_nt, s)
    pars_part.set_pattern_weights(weights)
    fp = FastParsimony(pars_part)
    tree, cost = fastparsimony_stepwise([fp], headers, seed)
    print(f"[{time.time()-t0:5.1f}s] stepwise tree: parsimony score {cost}")

    # default branch lengths + fresh template indices for likelihood
    seen = set()
    for node in tree.nodes():
        for h in ([node] if node.is_tip() else list(node.ring())):
            if h.back is not None and id(h) not in seen:
                seen.add(id(h)), seen.add(id(h.back))
                h.length = h.back.length = 0.1
    reset_template_indices(tree.vroot, tree.tip_count)

    # --- likelihood partition -------------------------------------------
    part = Partition(n, n - 2, 4, patterns, 1, 2 * n - 3, 4, n - 2,
                     device=device)
    by_label = dict(zip(headers, comp))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_pattern_weights(weights)
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1.0, 1.1, 0.9, 1.05, 0.95, 1.0])
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    eng = TreeEngine(part, tree)
    print(f"[{time.time()-t0:5.1f}s] starting logL: "
          f"{eng.loglikelihood():.4f} (path: {eng.execution_path})")

    # --- 3. model + branch optimization on the fast path ----------------
    if eng.use_fused:
        # subst/freq trials stay on the fused kernel (2n+1 trials a step
        # in one launch); branches by the all-edges Newton sweep. Two
        # alternations converge to the joint optimum.
        hist = []
        for _ in range(2):
            lk, params, h = maximize_fused(eng, ("subst", "freqs"),
                                           steps=steps, learning_rate=0.05)
            hist += h
            lk = newton_smooth_all(eng, tree, passes=2)
    else:                       # the gradient path
        lk, params, hist = maximize_loglikelihood(
            eng, ("branches", "subst", "freqs"), steps=200,
            learning_rate=0.04)
        eng.apply_branches_to_tree(tree)
    print(f"[{time.time()-t0:5.1f}s] after model+brlen optimization: "
          f"{lk:.4f} ({len(hist)} model steps)")

    # --- 4. NNI hill climbing (streamed directional-CLV scoring) --------
    search = TreeSearch(part, tree)
    lk_search, accepted = search.nni_round_streamed()
    print(f"[{time.time()-t0:5.1f}s] after NNI search: {lk_search:.4f} "
          f"({accepted} moves accepted)")

    # re-smooth branches on the final topology
    eng2 = TreeEngine(part, tree)
    lk_final = newton_smooth_all(eng2, tree, passes=2)
    print(f"[{time.time()-t0:5.1f}s] final logL: {lk_final:.4f}")

    # --- 5. bootstrap ------------------------------------------------------
    logls, _ = bootstrap_loglikelihoods(eng2, replicates, seed=seed)
    print(f"[{time.time()-t0:5.1f}s] {replicates} bootstrap replicate logLs "
          f"from one eval: mean {logls.mean():.2f} +- {logls.std():.2f}")

    # --- 6. checkpoint ---------------------------------------------------
    checkpoint.save(ckpt, part, tree, best_logl=lk_final)
    print(f"[{time.time()-t0:5.1f}s] checkpointed -> {ckpt}")
    print(export_newick(tree.vroot)[:100], "...")
    return lk_final


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("seed", nargs="?", type=int, default=42)
    ap.add_argument("--ckpt", default="analysis.ckpt.npz",
                    help="checkpoint path (default analysis.ckpt.npz in the "
                    "working directory)")
    args = ap.parse_args(argv)
    run(args.seed, ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
