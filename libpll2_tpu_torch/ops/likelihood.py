"""Root- and edge-based log-likelihood evaluation, marginal ancestral states
and per-site rate posteriors, in PyTorch.

Port of libpll2_tpu/ops/likelihood.py (reference: libpll-2
src/core_likelihood.c:25-209 root, :1192-1497 edge ii; per-rate scaler
handling as in src/core_likelihood_avx.c:320-523):

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

__all__ = ["cap_pow", "root_loglikelihood", "edge_loglikelihood",
           "edge_loglikelihood_candidates", "node_ancestral",
           "rate_posteriors", "asc_parts", "asc_total"]


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
    cap_factor = torch.pow(torch.full((), threshold, dtype=dtype,
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
               n_real: int, states: int, threshold: float, dtype,
               col0=None):
    """Ascertainment-bias corrections (likelihood.c:24-117); `n_real < 0`
    marks a partition without synthetic asc columns. Returns (total,
    weighted_per_site).

    The columns are [col0, col0 + S) of the partition: with `col0` (one
    shard of a site mesh) the first value is the shard's partial sums
    `asc_parts(asc_type)` long instead of the total, since the Lewis and
    Felsenstein terms are the log of a sum over the synthetic columns,
    which may lie in any shard; `asc_total` finishes the sums, summed over
    the shards or, without `col0`, the partition's own."""
    pw = pattern_weights.to(dtype)
    zero = torch.zeros_like(site_lk)
    # site_lk may be -inf; 0 * -inf is nan, so zero-weight columns are
    # masked, not multiplied out
    # the columns' indices in the partition, where synthetic columns exist
    idxs = None if n_real < 0 else (col0 or 0) + torch.arange(
        site_lk.shape[0], device=site_lk.device)
    if asc_type == AB_STAMATAKIS or (asc_type == AB_NONE and n_real < 0):
        weighted = torch.where(pw > 0, site_lk * pw, zero)
        if asc_type == AB_STAMATAKIS and n_real >= 0:
            # the scaler-undo term enters UNWEIGHTED on the synthetic
            # columns (likelihood.c:95-101)
            asc_cols = (idxs >= n_real) & (idxs < n_real + states)
            sc_term = site_sc.to(dtype) * math.log(threshold)
            weighted = torch.where(asc_cols,
                                   (site_lk - sc_term) * pw + sc_term,
                                   weighted)
        parts = weighted.sum()[None]
    else:
        main = (idxs < n_real).to(dtype)
        weighted = torch.where(pw * main > 0, site_lk * pw * main, zero)
        if asc_type == AB_NONE:
            parts = weighted.sum()[None]
        elif asc_type in (AB_LEWIS, AB_FELSENSTEIN):
            asc_cols = (idxs >= n_real) & (idxs < n_real + states)
            base = torch.sum(torch.where(asc_cols, terma * torch.pow(
                torch.full((), threshold, dtype=dtype, device=terma.device),
                site_sc.to(dtype)), zero))
            # the weight the correction scales by: the main columns'
            # (Lewis) or the synthetic columns' (Felsenstein)
            sum_w = (torch.sum(pw * main) if asc_type == AB_LEWIS
                     else torch.sum(torch.where(asc_cols, pw, zero)))
            parts = torch.stack([weighted.sum(), sum_w, base])
        else:
            raise ValueError(f"unknown asc type {asc_type}")
    return (parts if col0 is not None else asc_total(parts, asc_type)), \
        weighted


def asc_parts(asc_type: int) -> int:
    """Length of the partial sums `_apply_asc` finishes: the main sum, and
    for Lewis and Felsenstein also the weight sum the correction scales by
    and the synthetic columns' likelihood sum."""
    return 3 if asc_type in (AB_LEWIS, AB_FELSENSTEIN) else 1


def asc_total(parts: torch.Tensor, asc_type: int) -> torch.Tensor:
    """The logL from partial sums [..., asc_parts]."""
    if asc_type == AB_LEWIS:
        return parts[..., 0] - parts[..., 1] * torch.log(1.0 - parts[..., 2])
    if asc_type == AB_FELSENSTEIN:
        return parts[..., 0] + parts[..., 1] * torch.log(parts[..., 2])
    return parts[..., 0]


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


def root_loglikelihood(clv: torch.Tensor,            # [R, s, S]
                       scaler: torch.Tensor,         # [S] or [R, S] int
                       freqs: torch.Tensor,          # [M, s]
                       prop_invar: torch.Tensor,     # [M]
                       rate_weights: torch.Tensor,   # [R]
                       params_idx: torch.Tensor,     # [R] int
                       pattern_weights: torch.Tensor,  # [S]
                       invariant: torch.Tensor,      # [S] int (-1 variable)
                       scale_threshold: float,
                       rate_scalers: bool = False,
                       has_scaler: bool = True,
                       asc_type: int = AB_NONE,
                       n_real: int = -1,
                       col0=None):
    """Likelihood at a root CLV (rooted trees); returns (total logL,
    per-site weighted logL [S]); with `col0` the total is a shard's
    partial sums (`_apply_asc`)."""
    dtype = clv.dtype
    f = freqs[params_idx].to(dtype)                          # [R, s]
    pinv = prop_invar[params_idx]
    term_r = torch.einsum('ris,ri->rs', clv, f)
    if has_scaler:
        site_sc, rate_factor = _site_scalings(scaler, rate_scalers,
                                              scale_threshold, dtype)
    else:
        site_sc = torch.zeros(clv.shape[-1], dtype=torch.int32,
                              device=clv.device)
        rate_factor = None
    terma, terminv = _mix_rates(term_r, rate_factor, f, pinv, rate_weights,
                                invariant, dtype)
    site_lk = _finalize_site_lk(terma, terminv, site_sc, scale_threshold,
                                dtype)
    return _apply_asc(site_lk, terma, site_sc, pattern_weights, asc_type,
                      n_real, clv.shape[1], scale_threshold, dtype, col0)


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
                       n_real: int = -1,
                       col0=None):
    """Likelihood across the edge (parent, child) with transition matrix
    `pmatrix` on it; returns (total logL, per-site weighted logL [S]); with
    `col0` the total is a shard's partial sums (`_apply_asc`)."""
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
                      n_real, clv_parent.shape[1], scale_threshold, dtype,
                      col0)


def edge_loglikelihood_candidates(clv_parent: torch.Tensor,   # [K, R, s, S]
                                  clv_child: torch.Tensor,    # [K, R, s, S]
                                  pscaler: torch.Tensor,      # [K, (R,) S]
                                  cscaler: torch.Tensor,
                                  pmatrix: torch.Tensor,      # [K, R, s, s]
                                  freqs: torch.Tensor,        # [(K,) M, s]
                                  prop_invar: torch.Tensor,   # [(K,) M]
                                  rate_weights: torch.Tensor,  # [R]
                                  params_idx: torch.Tensor,   # [(K,) R] int
                                  pattern_weights: torch.Tensor,  # [S]
                                  invariant: torch.Tensor,    # [S] int
                                  scale_threshold: float,
                                  rate_scalers: bool = False,
                                  asc_type: int = AB_NONE,
                                  n_real: int = -1,
                                  col0=None) -> torch.Tensor:
    """`edge_loglikelihood` of K root edges at once: each its own rows,
    counts and root P-matrix; with `params_idx` [K, R] each its own root
    edge's rate matrices (candidates under per-branch heterotachy), and with
    `freqs` [K, M, s] and `prop_invar` [K, M] each its own model (trials).
    One batch of tensor ops (torch.func.vmap over the leading axis), not K
    calls of ~50 small ones. Returns the totals [K] (with `col0` a shard's
    partial sums [K, asc_parts])."""
    def one(clv_p, clv_c, sc_p, sc_c, pmat, pidx, f, pinv):
        return edge_loglikelihood(
            clv_p, clv_c, sc_p, sc_c, pmat, f, pinv, rate_weights, pidx,
            pattern_weights, invariant, scale_threshold,
            rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real,
            col0=col0)[0]

    in_dims = (0, 0, 0, 0, 0, 0 if params_idx.dim() == 2 else None,
               0 if freqs.dim() == 3 else None,
               0 if prop_invar.dim() == 2 else None)
    return torch.func.vmap(one, in_dims=in_dims)(
        clv_parent, clv_child, pscaler, cscaler, pmatrix, params_idx, freqs,
        prop_invar)


def node_ancestral(clv_node: torch.Tensor,           # [R, s, S]
                   clv_other: torch.Tensor,          # [R, s, S]
                   nscaler: torch.Tensor,
                   oscaler: torch.Tensor,
                   pmatrix: torch.Tensor,            # [R, s, s]
                   freqs: torch.Tensor,              # [M, s]
                   rate_weights: torch.Tensor,       # [R]
                   params_idx: torch.Tensor,         # [R] int
                   scale_threshold: float,
                   rate_scalers: bool = False,
                   has_nscaler: bool = True,
                   has_oscaler: bool = True) -> torch.Tensor:
    """Marginal ancestral state probabilities at a node, viewed across the
    edge to `other` (reference: likelihood.c:639-757):

        anc[site, i] ~ sum_r w_r * freq[i] * clv_node[r,i,site]
                                           * (P_r @ clv_other[r,:,site])[i]

    normalized over states per site. Per-site scalers cancel in the
    normalization; in per-rate mode the relative scaler differences are
    undone with the likelihood path's capped factors (libpll2_tpu's
    deliberate divergence from the reference). Returns anc [S, s]."""
    dtype = clv_node.dtype
    f = freqs[params_idx].to(dtype)                          # [R, s]
    combined = clv_node * torch.einsum('rjk,rks->rjs', pmatrix.to(dtype),
                                       clv_other)
    if rate_scalers:
        sc = None
        if has_nscaler:
            sc = nscaler
        if has_oscaler:
            sc = oscaler if sc is None else sc + oscaler
        if sc is not None:
            _, rate_factor = _site_scalings(sc, True, scale_threshold, dtype)
            combined = combined * rate_factor[:, None, :]
    anc = torch.einsum('r,rjs,rj->sj', rate_weights.to(dtype), combined, f)
    return anc / torch.sum(anc, dim=1, keepdim=True)


def rate_posteriors(clv_parent, clv_child, pscaler, cscaler,
                    pmatrix,                 # [R, s, s] root edge
                    freqs, prop_invar, rates, rate_weights, params_idx,
                    invariant,               # [S] int (-1 = variable)
                    scale_threshold: float = 2.0 ** -256,
                    rate_scalers: bool = False):
    """Empirical-Bayes per-site posteriors over the R rate categories plus
    the +I invariant category, across the root edge:

        post[r, s] = w_r (1-pinv) L_r(s) / Z(s)     r < R
        post[R, s] = pinv f(inv_state_s) / Z(s)     (0 when pinv = 0 or
                                                     the site varies)

    in log space, so scaler counts mix exactly with the unscaled invariant
    term. Returns (post [R+1, S], site_rate [S]), site_rate being the
    posterior mean (the invariant category has rate 0)."""
    dtype = clv_parent.dtype
    tiny = torch.finfo(dtype).tiny
    f = freqs[params_idx].to(dtype)                          # [R, s]
    pinv = prop_invar[params_idx].to(dtype)                  # [R]
    termb = torch.einsum('rjk,rks->rjs', pmatrix.to(dtype), clv_child)
    term_r = torch.einsum('rjs,rj->rs', clv_parent * termb, f)   # [R, S]

    sc = pscaler + cscaler
    log_t = math.log(scale_threshold)
    if rate_scalers:
        site_sc = torch.amin(sc, dim=0)
        rel = torch.clamp(sc - site_sc[None, :], max=SCALE_RATE_MAXDIFF)
        log_scale = (site_sc[None, :] + rel).to(dtype) * log_t
    else:
        log_scale = sc[None, :].to(dtype) * log_t            # [1, S]

    w = rate_weights[:, None].to(dtype) * (1.0 - pinv)[:, None]
    log_var = (torch.log(torch.clamp(w, min=tiny))
               + torch.log(torch.clamp(term_r, min=0.0)) + log_scale)

    inv_ok = invariant >= 0
    inv_state = torch.clamp(invariant, min=0).long()
    inv_freq = torch.sum((f * pinv[:, None]
                          * rate_weights[:, None].to(dtype))[:, inv_state],
                         dim=0)                              # [S]
    log_inv = torch.where(inv_ok & (inv_freq > 0),
                          torch.log(torch.clamp(inv_freq, min=tiny)),
                          torch.full_like(inv_freq, -math.inf))

    logs = torch.cat([log_var, log_inv[None, :]], dim=0)
    peak = torch.amax(logs, dim=0, keepdim=True)
    peak = torch.where(torch.isfinite(peak), peak, torch.zeros_like(peak))
    expd = torch.exp(logs - peak)
    post = expd / torch.clamp(torch.sum(expd, dim=0, keepdim=True), min=tiny)
    cat_rates = torch.cat([rates.to(dtype),
                           torch.zeros(1, dtype=dtype, device=rates.device)])
    site_rate = torch.sum(post * cat_rates[:, None], dim=0)
    return post, site_rate
