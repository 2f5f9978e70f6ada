"""Model selection over a fixed topology: the ModelTest-NG pattern, in
PyTorch.

Port of libpll2_tpu/modelselect.py. The reference powers ModelTest-NG,
which fits candidate substitution models on a fixed tree and ranks them by
information criteria. Nested DNA models come from exchangeability-rate tying
(optimize.make_loglikelihood_fn's subst_template), amino-acid models from
the empirical matrices of `models`; branches, free rates and frequencies
are fitted by Adam on the gradient route (a pallas=False engine: plain
PyTorch, differentiated by autograd), the Gamma shape by Brent. Every
partition takes `device` and `dtype` (CUDA and float32 by default, as
everywhere in the port).

DNA model templates (upper-triangle slot order AC, AG, AT, CG, CT, GT;
class 0 pinned to rate 1):
  JC     equal rates, equal freqs            (0 free rates, fixed freqs)
  F81    equal rates, estimated freqs
  K80    transitions vs transversions, equal freqs
  HKY    transitions vs transversions, estimated freqs
  TN93   two transition classes, estimated freqs
  GTR    all six rates, estimated freqs
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .engine import TreeEngine
from .io import maps
from .ops.gamma import compute_gamma_cats
from .partition import Partition

__all__ = ["DNA_MODELS", "select_dna_model", "select_aa_model"]

#                          AC AG AT CG CT GT
DNA_MODELS: Dict[str, dict] = {
    "JC":   dict(template=[0, 0, 0, 0, 0, 0], est_freqs=False),
    "F81":  dict(template=[0, 0, 0, 0, 0, 0], est_freqs=True),
    "K80":  dict(template=[0, 1, 0, 0, 1, 0], est_freqs=False),
    "HKY":  dict(template=[0, 1, 0, 0, 1, 0], est_freqs=True),
    "TN93": dict(template=[0, 1, 0, 0, 2, 0], est_freqs=True),
    "GTR":  dict(template=[1, 2, 3, 4, 5, 0], est_freqs=True),
}


def _criteria(logl: float, k: int, n_sites: int) -> Dict[str, float]:
    return {"logL": logl,
            "k": k,
            "AIC": 2 * k - 2 * logl,
            "AICc": (2 * k - 2 * logl
                     + (2 * k * (k + 1)) / max(n_sites - k - 1, 1)),
            "BIC": k * np.log(n_sites) - 2 * logl}


def _build_partition(tree, by_label, states, sites, rate_cats, charmap,
                     **partition_kw):
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rate_cats, tree.inner_count,
                     **partition_kw)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, charmap, by_label[t.label])
    part.set_category_rates(compute_gamma_cats(1.0, rate_cats)
                            if rate_cats > 1 else np.ones(1))
    return part


def _fit(engine, optimize, subst_template, steps, learning_rate,
         opt_alpha, rounds: int = 2):
    """Alternate gradient ascent (branches + free rates + freqs) with
    Brent over the Gamma shape. Returns (logL, alpha or None)."""
    from .optimize import maximize_loglikelihood, optimize_gamma_shape

    lk, alpha = None, None
    for _ in range(rounds if opt_alpha else 1):
        lk, _, _ = maximize_loglikelihood(engine, optimize, steps=steps,
                                          learning_rate=learning_rate,
                                          patience=60,
                                          subst_template=subst_template)
        if opt_alpha:
            alpha, lk = optimize_gamma_shape(engine)
    return lk, alpha


def select_dna_model(tree, sequences_by_label: Dict[str, str],
                     rate_cats: int = 4,
                     models: Iterable[str] = tuple(DNA_MODELS),
                     criterion: str = "BIC", steps: int = 250,
                     learning_rate: float = 0.05, *, device="cuda",
                     dtype: torch.dtype = torch.float32) -> List[dict]:
    """Fit each nested DNA model on the fixed topology (branches + free
    exchangeabilities + frequencies by gradient, Gamma shape by Brent)
    and rank by the information criterion. Returns a list of result
    dicts sorted best-first; each carries model/logL/k/AIC/AICc/BIC and
    the fitted alpha/freqs/subst. k counts branches + free rates +
    (states-1 if frequencies are estimated) + (1 if rate_cats > 1)."""
    if criterion not in ("AIC", "AICc", "BIC"):
        raise ValueError("criterion must be AIC, AICc or BIC")
    sites = len(next(iter(sequences_by_label.values())))
    results = []
    for name in models:
        spec = DNA_MODELS[name]
        part = _build_partition(tree, sequences_by_label, 4, sites,
                                rate_cats, maps.map_nt, device=device,
                                dtype=dtype)
        part.set_frequencies(0, [0.25] * 4)
        part.set_subst_params(0, [1.0] * 6)
        eng = TreeEngine(part, tree, pallas=False)
        tmpl = np.asarray(spec["template"], np.int32)
        n_free = int(tmpl.max())
        groups = ["branches"]
        if n_free > 0:
            groups.append("subst")
        if spec["est_freqs"]:
            groups.append("freqs")
        lk, alpha = _fit(eng, tuple(groups), tmpl, steps, learning_rate,
                         opt_alpha=rate_cats > 1)
        k = (tree.edge_count + n_free
             + (3 if spec["est_freqs"] else 0)
             + (1 if rate_cats > 1 else 0))
        row = {"model": name, **_criteria(lk, k, sites), "alpha": alpha,
               "freqs": np.asarray(part.frequencies[0]).tolist(),
               "subst": np.asarray(part.subst_params[0]).tolist()}
        results.append(row)
    return sorted(results, key=lambda r: r[criterion])


def select_aa_model(tree, sequences_by_label: Dict[str, str],
                    rate_cats: int = 4,
                    models: Optional[Iterable[str]] = None,
                    criterion: str = "BIC", steps: int = 100,
                    learning_rate: float = 0.04, *, device="cuda",
                    dtype: torch.dtype = torch.float32) -> List[dict]:
    """Rank empirical amino-acid replacement matrices (fixed rates and
    frequencies; branches by gradient, Gamma shape by Brent) by the
    information criterion. `models` defaults to all 20 single-matrix
    empirical models. k counts branches + (1 if rate_cats > 1)."""
    if criterion not in ("AIC", "AICc", "BIC"):
        raise ValueError("criterion must be AIC, AICc or BIC")
    from .models import AA_MODEL_NAMES, load_aa_model

    if models is None:
        models = list(AA_MODEL_NAMES)
    sites = len(next(iter(sequences_by_label.values())))
    results = []
    for name in models:
        part = _build_partition(tree, sequences_by_label, 20, sites,
                                rate_cats, maps.map_aa, device=device,
                                dtype=dtype)
        load_aa_model(part, name)
        eng = TreeEngine(part, tree, pallas=False)
        lk, alpha = _fit(eng, ("branches",), None, steps, learning_rate,
                         opt_alpha=rate_cats > 1)
        k = tree.edge_count + (1 if rate_cats > 1 else 0)
        results.append({"model": name, **_criteria(lk, k, sites),
                        "alpha": alpha})
    return sorted(results, key=lambda r: r[criterion])
