"""Model selection on a fixed topology, the ModelTest-NG pattern (port of
examples/model_selection.py).

Simulates data under HKY (kappa = 5, skewed frequencies), then fits and
ranks the nested DNA model family by BIC. Expect HKY (or TN93/GTR, which
contain it) to win and JC to rank last.

Usage: python -m libpll2_tpu_torch.examples.model_selection [seed]
       [--device cpu]
"""
from __future__ import annotations

import time

from ..modelselect import select_dna_model
from ..trees import random_utree
from ..utils import simulate_alignment
from ._cli import parser


def ranking(seed=7, taxa=16, sites=1200, device="cuda", **select_kw):
    """select_dna_model's rows for the example's simulated data."""
    tree = random_utree([f"t{i}" for i in range(taxa)], seed=seed)
    headers, seqs = simulate_alignment(
        tree, sites, [0.35, 0.15, 0.15, 0.35],
        [1.0, 5.0, 1.0, 1.0, 5.0, 1.0], alpha=0.9, seed=seed)
    return select_dna_model(tree, dict(zip(headers, seqs)),
                            criterion="BIC", device=device, **select_kw)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("seed", nargs="?", type=int, default=7)
    args = ap.parse_args(argv)
    t0 = time.time()
    rows = ranking(args.seed, device=args.device)
    print(f"[{time.time()-t0:5.1f}s] model ranking (BIC):")
    print(f"{'model':6s} {'logL':>12s} {'k':>4s} {'AIC':>12s} "
          f"{'AICc':>12s} {'BIC':>12s}")
    for r in rows:
        print(f"{r['model']:6s} {r['logL']:12.2f} {r['k']:4d} "
              f"{r['AIC']:12.1f} {r['AICc']:12.1f} {r['BIC']:12.1f}")
    best = rows[0]
    print(f"\nselected: {best['model']}  "
          f"(freqs {['%.3f' % f for f in best['freqs']]}, "
          f"rates {['%.2f' % x for x in best['subst']]})")


if __name__ == "__main__":
    main()
