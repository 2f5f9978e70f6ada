"""Bootstrap log-likelihoods: B column resamplings scored from ONE tree
evaluation and one [B, S] x [S] product.

Port of libpll2_tpu/bootstrap.py. The reference's consumers (RAxML-NG,
IQ-TREE) bootstrap by resampling alignment columns and re-running the
whole likelihood pipeline per replicate. On a fixed topology + model, that
is wasted work: the total logL is LINEAR in the pattern weights,

    logL(w) = sum_s w_s * lnl_s   (+ Lewis asc: -(sum_s w_s) * log(1-base))

so the per-pattern log-likelihoods lnl_s are computed ONCE (one
`engine.loglikelihood_persite()`, on the engine's device) and every
replicate's logL is a row of `W @ lnl`, computed on the host in float64 as
in JAX. Resampling follows the standard recipe over compressed patterns:
replicate weights are a multinomial draw of the original site total with
probabilities proportional to the pattern weights (what RAxML does per
replicate), from numpy's generator of `seed`, so both packages draw the
same weights.

For the Felsenstein/Stamatakis ascertainment corrections the dependence
on the weights is not a plain weighted sum of per-site terms, so those
engines are rejected with JAX's PllError: evaluate per replicate through
`set_pattern_weights` instead.
"""
from __future__ import annotations

import numpy as np

from . import constants as C


def persite_lnl(engine):
    """Per-pattern (unweighted) log-likelihood vector [sites] plus the
    Lewis base term needed to make logL(w) exactly linear in w."""
    if engine.asc_type not in (0, 1):    # NONE or LEWIS
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "bootstrap_loglikelihoods supports no asc-bias or Lewis; "
            "Felsenstein/Stamatakis corrections are not weight-linear")
    p = engine.partition
    total, per = engine.loglikelihood_persite()
    pw = np.asarray(p.pattern_weights, dtype=np.float64)[:p.sites]
    per = np.asarray(per, dtype=np.float64)[:p.sites]
    lnl = np.zeros(p.sites)
    nz = pw > 0
    lnl[nz] = per[nz] / pw[nz]
    log1m_base = 0.0
    if engine.asc_type == 1:             # Lewis: logL += -(sum w) log(1-base)
        # recover log(1-base) from the engine's own total so the linear
        # model reproduces it exactly: total = sum(per) - sum_w*log(1-base)
        sum_w = float(pw.sum())
        log1m_base = (float(per.sum()) - total) / sum_w
    return lnl, log1m_base


def bootstrap_weights(pattern_weights, n_replicates: int, seed: int = 0):
    """[B, S] multinomial column-resampling weights over compressed
    patterns: each replicate draws `sum(weights)` sites with replacement,
    with probability proportional to each pattern's weight."""
    pw = np.asarray(pattern_weights, dtype=np.float64)
    total = int(round(pw.sum()))
    rng = np.random.default_rng(seed)
    return rng.multinomial(total, pw / pw.sum(),
                           size=n_replicates).astype(np.float64)


def bootstrap_loglikelihoods(engine, n_replicates: int, seed: int = 0,
                             weights=None):
    """logL of `n_replicates` bootstrap resamplings of the alignment, all
    from ONE tree evaluation + one [B, S] x [S] matmul. Returns
    (logls [B], weights [B, S])."""
    p = engine.partition
    lnl, log1m_base = persite_lnl(engine)
    if weights is None:
        weights = bootstrap_weights(
            np.asarray(p.pattern_weights)[:p.sites], n_replicates, seed)
    W = np.asarray(weights, dtype=np.float64)
    # host-side float64: a float32 reduction over thousands of sites would
    # lose ~3 decimal digits per replicate
    logls = W @ np.asarray(lnl, dtype=np.float64)
    if engine.asc_type == 1:
        # corr_r = -sum(w_r) * log(1-base)
        logls = logls - W.sum(axis=1) * log1m_base
    return logls, W
