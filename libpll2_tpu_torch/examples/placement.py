"""Phylogenetic placement (the EPA-ng pattern; port of
examples/placement.py): place query sequences onto a reference tree,
scoring every attachment edge of a query in one call.

Simulates a 24-taxon tree, prunes three taxa out as "queries", and places
them back: each should land on (or next to) its true edge with a dominant
likelihood weight ratio.

Usage: python -m libpll2_tpu_torch.examples.placement [seed] [--device cpu]
"""
from __future__ import annotations

import time

from .. import EdgePlacer
from ..placement import to_jplace
from ..trees import export_newick, parse_newick, prune_tip, random_utree
from ..utils import simulate_alignment
from ._cli import parser

FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1.0, 2.5, 0.8, 1.1, 2.5, 1.0]


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("seed", nargs="?", type=int, default=11)
    args = ap.parse_args(argv)
    seed = args.seed
    t0 = time.time()
    full = random_utree([f"t{i}" for i in range(24)], seed=seed)
    headers, seqs = simulate_alignment(full, 1500, FREQS, SUBST,
                                       alpha=0.9, seed=seed)
    by = dict(zip(headers, seqs))
    queries = ["t4", "t11", "t19"]
    for q in queries:
        keep_node = prune_tip(full, q)
    ref_tree = parse_newick(export_newick(keep_node))
    ref_by = {k: v for k, v in by.items() if k not in queries}

    placer = EdgePlacer(ref_tree, ref_by, device=args.device)
    placer.set_model(FREQS, SUBST, alpha=0.9)
    for q in queries:
        rows = placer.place(by[q], top_k=3)
        t = time.time() - t0
        print(f"[{t:5.1f}s] {q}: best edge {rows[0]['edge_nodes']} "
              f"(lwr {rows[0]['lwr']:.2f}); runners-up "
              + ", ".join(f"{r['edge_nodes']}@{r['lwr']:.2f}"
                          for r in rows[1:]))

    # EPA-ng-scale streaming: precompute per-edge attachment tensors once,
    # then each (query, edge, site) costs one small contraction (place()
    # re-traverses per edge)
    placer.prepare_stream()
    stream = placer.place_stream({q: by[q] for q in queries}, top_k=3)
    for q in queries:
        best = stream[q][0]
        print(f"[{time.time()-t0:5.1f}s] stream {q}: best edge "
              f"{best['edge_nodes']} (lwr {best['lwr']:.2f})")
        if best['edge'] != placer.place(by[q], top_k=1)[0]['edge']:
            raise RuntimeError(f"placement: the streamed best edge of {q} "
                               f"is not place()'s")

    # jplace v3 interchange output (consumed by gappa/iTOL)
    jp = to_jplace(placer, stream, top_k=3)
    print(f"[{time.time()-t0:5.1f}s] jplace: {len(jp['placements'])} "
          f"queries over {jp['tree'].count('{')} annotated edges")


if __name__ == "__main__":
    main()
