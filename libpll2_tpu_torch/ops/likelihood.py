"""Edge-based log-likelihood evaluation, in PyTorch.

Port of libpll2_tpu/ops/likelihood.py (reference: libpll-2
src/core_likelihood.c:1192-1497 edge ii; per-rate scaler handling as in
src/core_likelihood_avx.c:320-523):

  site_lk = sum_r w_r * [ L_r(site) * (1 - pinv_r) + pinv_r * f_r(inv_state) ]
  logL    = sum_sites weight_s * log(site_lk)  (+ scaler * log(threshold))

with the reference treatment of numerical scaling:
  * per-site scalers are undone in log space: + scalings * log(threshold);
  * per-rate scalers are reduced to a common per-site minimum plus capped
    (SCALE_RATE_MAXDIFF=4) relative factors multiplied into each rate term;
  * when an invariant-site term is present, the variable part is un-scaled by
    a capped linear factor instead (core_likelihood.c:1470-1485).

Layout: CLVs are [rate, state, site]. The per-rate and asc branches are
kept whole, although the engine of this slice refuses those features, so
that later slices need no rework here.
"""
from __future__ import annotations

import math

import torch

from ..constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE, AB_STAMATAKIS,
                         SCALE_RATE_MAXDIFF)

__all__ = ["cap_pow", "edge_loglikelihood"]


def cap_pow(threshold: float, rel: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """threshold ** min(rel, MAXDIFF); powers of two multiply exactly."""
    f = torch.ones(rel.shape, dtype=dtype, device=rel.device)
    for k in range(1, SCALE_RATE_MAXDIFF + 1):
        f = torch.where(rel >= k, f * threshold, f)
    return f


def _site_scalings(scaler: torch.Tensor, rate_scalers: bool,
                   threshold: float, dtype: torch.dtype):
    """Split scalers into a per-site count and capped per-rate factors.

    scaler: [S] (per-site mode) or [R, S] (per-rate mode), already the sum of
    all contributing buffers. Returns (site_sc [S], rate_factor [R, S] or
    None)."""
    if not rate_scalers:
        return scaler, None
    site_sc = torch.amin(scaler, dim=0)                       # [S]
    rel = torch.clamp(scaler - site_sc[None, :], max=SCALE_RATE_MAXDIFF)
    return site_sc, cap_pow(threshold, rel, dtype)


def _finalize_site_lk(terma, terminv, site_sc, threshold: float, dtype):
    """Reference scaling/invariant interaction (core_likelihood.c:1463-1486).
    A zero site likelihood gives -inf, as the reference reports it."""
    capped = torch.clamp(site_sc, max=SCALE_RATE_MAXDIFF).to(dtype)
    cap_factor = torch.pow(torch.tensor(threshold, dtype=dtype,
                                        device=terma.device), capped)
    has_sc = site_sc > 0
    has_inv = terminv > 0.0
    log_arg = torch.where(has_sc,
                          torch.where(has_inv, terma * cap_factor + terminv,
                                      terma),
                          terma + terminv)
    site_lk = torch.log(torch.clamp(log_arg, min=0.0))
    undo = site_sc.to(dtype) * math.log(threshold)
    return site_lk + torch.where(has_sc & ~has_inv, undo,
                                 torch.zeros_like(undo))


def _apply_asc(site_lk, terma, site_sc, pattern_weights, asc_type: int,
               n_real: int, states: int, threshold: float, dtype):
    """Ascertainment-bias corrections (likelihood.c:24-117); `n_real < 0`
    marks a partition without synthetic asc columns. Returns (total,
    weighted_per_site)."""
    pw = pattern_weights.to(dtype)
    zero = torch.zeros_like(site_lk)
    # site_lk may be -inf; 0 * -inf is nan, so zero-weight columns are
    # masked, not multiplied out
    if asc_type == AB_STAMATAKIS or (asc_type == AB_NONE and n_real < 0):
        weighted = torch.where(pw > 0, site_lk * pw, zero)
        if asc_type == AB_STAMATAKIS and n_real >= 0:
            # the scaler-undo term enters UNWEIGHTED on the synthetic
            # columns (likelihood.c:95-101)
            idxs = torch.arange(site_lk.shape[0], device=site_lk.device)
            asc_cols = (idxs >= n_real) & (idxs < n_real + states)
            sc_term = site_sc.to(dtype) * math.log(threshold)
            weighted = torch.where(asc_cols,
                                   (site_lk - sc_term) * pw + sc_term,
                                   weighted)
        return weighted.sum(), weighted
    main = (torch.arange(site_lk.shape[0], device=site_lk.device)
            < n_real).to(dtype)
    weighted = torch.where(pw * main > 0, site_lk * pw * main, zero)
    if asc_type == AB_NONE:
        return weighted.sum(), weighted
    term_asc = terma[n_real:n_real + states]
    sc_asc = site_sc[n_real:n_real + states]
    base = torch.sum(term_asc * torch.pow(
        torch.tensor(threshold, dtype=dtype, device=terma.device),
        sc_asc.to(dtype)))
    if asc_type == AB_LEWIS:
        corr = -torch.sum(pw * main) * torch.log(1.0 - base)
    elif asc_type == AB_FELSENSTEIN:
        corr = torch.sum(pw[n_real:n_real + states]) * torch.log(base)
    else:
        raise ValueError(f"unknown asc type {asc_type}")
    return weighted.sum() + corr, weighted


def _mix_rates(terma_r, rate_factor, freqs_r, pinv_r, rate_weights,
               invariant, dtype):
    """Rate-weighted mixing with proportion-of-invariant-sites handling.

    terma_r: [R, S] per-rate site likelihoods; returns (terma [S],
    terminv [S])."""
    if rate_factor is not None:
        terma_r = terma_r * rate_factor
    w = rate_weights[:, None].to(dtype)                      # [R, 1]
    pinv = pinv_r[:, None].to(dtype)                         # [R, 1]
    terma = torch.sum(w * terma_r * (1.0 - pinv), dim=0)     # [S]

    inv_ok = invariant >= 0                                  # [S]
    inv_state = torch.clamp(invariant, min=0).long()
    inv_freq = freqs_r[:, inv_state]                         # [R, S]
    terminv = torch.sum(torch.where(inv_ok[None, :] & (pinv > 0),
                                    w * inv_freq * pinv,
                                    torch.zeros_like(inv_freq)), dim=0)
    return terma, terminv


def edge_loglikelihood(clv_parent: torch.Tensor,     # [R, s, S]
                       clv_child: torch.Tensor,      # [R, s, S]
                       pscaler: torch.Tensor,        # [S] or [R, S] int
                       cscaler: torch.Tensor,
                       pmatrix: torch.Tensor,        # [R, s, s]
                       freqs: torch.Tensor,          # [M, s]
                       prop_invar: torch.Tensor,     # [M]
                       rate_weights: torch.Tensor,   # [R]
                       params_idx: torch.Tensor,     # [R] int
                       pattern_weights: torch.Tensor,  # [S]
                       invariant: torch.Tensor,      # [S] int (-1 variable)
                       scale_threshold: float,
                       rate_scalers: bool = False,
                       has_pscaler: bool = True,
                       has_cscaler: bool = True,
                       asc_type: int = AB_NONE,
                       n_real: int = -1):
    """Likelihood across the edge (parent, child) with transition matrix
    `pmatrix` on it; returns (total logL, per-site weighted logL [S])."""
    dtype = clv_parent.dtype
    f = freqs[params_idx].to(dtype)                          # [R, s]
    pinv = prop_invar[params_idx]

    termb = torch.einsum('rjk,rks->rjs', pmatrix.to(dtype), clv_child)
    terma_r = torch.einsum('rjs,rj->rs', clv_parent * termb, f)

    sc = None
    if has_pscaler:
        sc = pscaler
    if has_cscaler:
        sc = cscaler if sc is None else sc + cscaler
    if sc is None:
        site_sc = torch.zeros(clv_parent.shape[-1], dtype=torch.int32,
                              device=clv_parent.device)
        rate_factor = None
    else:
        site_sc, rate_factor = _site_scalings(sc, rate_scalers,
                                              scale_threshold, dtype)

    terma, terminv = _mix_rates(terma_r, rate_factor, f, pinv,
                                rate_weights, invariant, dtype)
    site_lk = _finalize_site_lk(terma, terminv, site_sc, scale_threshold,
                                dtype)
    return _apply_asc(site_lk, terma, site_sc, pattern_weights, asc_type,
                      n_real, clv_parent.shape[1], scale_threshold, dtype)
