"""Branch-length derivatives of the log-likelihood (Newton engine), in
PyTorch.

Port of libpll2_tpu/ops/derivatives.py, the reference's two-phase split
(libpll-2 src/core_derivatives.c:25-471 sumtable, :643-929 derivatives):

Phase 1 (once per edge, branch-length independent): rotate both CLVs into the
eigenbasis and form

    sum[r, j, s] = (sum_k clvp[r,k,s] * f[r,k] * inv_evecs[r,k,j])
                 * (sum_k evecs[r,j,k] * clvc[r,k,s])

Phase 2 (per branch length, O(states) per site): with
x_rj = lambda_rj * rate_r / (1 - pinv_r),

    L  (s) = sum_r w_r sum_j sum[r,j,s] * exp(x_rj t)        (* (1-pinv) + inv)
    L' (s) = sum_r w_r sum_j sum[r,j,s] * x_rj exp(x_rj t)   (* (1-pinv))
    L''(s) = sum_r w_r sum_j sum[r,j,s] * x_rj^2 exp(x_rj t) (* (1-pinv))
    d1 = sum_s w_s * (-L'/L);   d2 = sum_s w_s * ((L'/L)^2 - L''/L)

Per-site scalers cancel in the L'/L and L''/L ratios; per-rate scalers are
folded into the sumtable as capped relative factors (core_derivatives.c:
399-460).
"""
from __future__ import annotations

import torch

from ..constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE, AB_STAMATAKIS,
                         SCALE_RATE_MAXDIFF)
from .likelihood import cap_pow


def update_sumtable(clv_parent: torch.Tensor,   # [R, s, S]
                    clv_child: torch.Tensor,    # [R, s, S]
                    pscaler: torch.Tensor,      # per-rate mode: [R, S]
                    cscaler: torch.Tensor,
                    inv_evecs: torch.Tensor,    # [M, s, s]
                    evecs: torch.Tensor,        # [M, s, s]
                    freqs: torch.Tensor,        # [M, s]
                    params_idx: torch.Tensor,   # [R]
                    scale_threshold: float,
                    rate_scalers: bool = False,
                    has_pscaler: bool = False,
                    has_cscaler: bool = False) -> torch.Tensor:
    """Returns the sumtable [R, s, S]."""
    dtype = clv_parent.dtype
    a = inv_evecs[params_idx].to(dtype)        # [R, s, s]
    b = evecs[params_idx].to(dtype)
    f = freqs[params_idx].to(dtype)            # [R, s]

    lefterm = torch.einsum('rks,rkj->rjs', clv_parent * f[:, :, None], a)
    righterm = torch.einsum('rjk,rks->rjs', b, clv_child)
    sumtable = lefterm * righterm

    if rate_scalers:
        sc = torch.zeros_like(pscaler)
        if has_pscaler:
            sc = sc + pscaler
        if has_cscaler:
            sc = sc + cscaler
        rel = torch.clamp(sc - torch.amin(sc, dim=0)[None, :],
                          max=SCALE_RATE_MAXDIFF)
        sumtable = sumtable * cap_pow(scale_threshold, rel,
                                      dtype)[:, None, :]
    return sumtable


def likelihood_derivatives(sumtable: torch.Tensor,      # [R, s, S]
                           eigenvals: torch.Tensor,     # [M, s]
                           prop_invar: torch.Tensor,    # [M]
                           freqs: torch.Tensor,         # [M, s]
                           rates: torch.Tensor,         # [R]
                           rate_weights: torch.Tensor,  # [R]
                           params_idx: torch.Tensor,    # [R]
                           pattern_weights: torch.Tensor,  # [S]
                           invariant: torch.Tensor,     # [S]
                           branch_length: torch.Tensor,  # scalar
                           asc_scalers: torch.Tensor | None = None,  # [S]
                           scale_threshold: float = 0.0,
                           asc_type: int = AB_NONE,
                           n_real: int = -1,
                           col0=None):
    """Returns (d1, d2): first/second derivative of -logL w.r.t. the length.

    Ascertainment bias (core_derivatives.c:852-924): Stamatakis enters the
    main sums as ordinary weighted columns; Lewis/Felsenstein exclude the
    synthetic columns and add the derivative of the log-of-sum term, which
    needs their absolute scalers (`asc_scalers`, parent + child rows).

    With `col0` (the first column's index, on one shard of a site mesh) it
    returns the shard's partial sums [derivative_parts] instead, which
    `derivatives_total` finishes once they are summed over the shards."""
    dtype = sumtable.dtype
    lam = eigenvals[params_idx].to(dtype)           # [R, s]
    pinv = prop_invar[params_idx].to(dtype)         # [R]
    f = freqs[params_idx].to(dtype)                 # [R, s]
    w = rate_weights.to(dtype)                      # [R]

    x = lam * (rates.to(dtype) / (1.0 - pinv))[:, None]      # [R, s]
    e = torch.exp(x * branch_length.to(dtype))
    diagp = torch.stack([e, x * e, x * x * e])               # [3, R, s]
    cat = torch.einsum('rjs,drj->drs', sumtable, diagp)      # [3, R, S]

    # invariant-site mixing per rate (core_derivatives.c:676-686)
    inv_ok = invariant >= 0
    inv_state = torch.clamp(invariant, min=0).long()
    inv_freq = f[:, inv_state]                               # [R, S]
    inv_lk = torch.where(inv_ok[None, :] & (pinv[:, None] > 0),
                         inv_freq * pinv[:, None],
                         torch.zeros_like(inv_freq))
    one_m_pinv = torch.where(pinv > 0, 1.0 - pinv, torch.ones_like(pinv))
    cat = cat * one_m_pinv[None, :, None]
    cat = torch.cat([(cat[0] + inv_lk)[None], cat[1:]])

    site = torch.einsum('drs,r->ds', cat, w)                 # [3, S]
    valid = pattern_weights > 0
    ones = torch.ones_like(site[0])
    lk0 = torch.where(valid & (site[0] != 0), site[0], ones)
    deriv1 = -site[1] / lk0
    deriv2 = deriv1 * deriv1 - site[2] / lk0
    pw = torch.where(valid, pattern_weights.to(dtype), torch.zeros_like(ones))
    parts = _derivative_sums(site, deriv1, deriv2, pw, asc_scalers,
                             scale_threshold, asc_type, n_real,
                             sumtable.shape[1], col0 or 0)
    if col0 is not None:
        return torch.stack(parts)
    return derivatives_total(parts, asc_type)


def _derivative_sums(site, deriv1, deriv2, pw, asc_scalers,
                     scale_threshold: float, asc_type: int, n_real: int,
                     states: int, col0: int) -> list:
    """The partial sums [derivative_parts] over the columns [col0, col0 + S)
    that `derivatives_total` finishes: d1 and d2 over the main columns,
    and for Lewis and Felsenstein (core_derivatives.c:852-924) the weight
    the correction scales by and the synthetic columns' L, L' and L''."""
    if asc_type == AB_STAMATAKIS or (asc_type == AB_NONE and n_real < 0):
        return [torch.sum(pw * deriv1), torch.sum(pw * deriv2)]
    # mask the synthetic columns out of the main sums
    dtype = site.dtype
    idxs = col0 + torch.arange(site.shape[1], device=site.device)
    main = (idxs < n_real).to(dtype)
    sums = [torch.sum(pw * main * deriv1), torch.sum(pw * main * deriv2)]
    if asc_type == AB_NONE:
        return sums
    if asc_type not in (AB_LEWIS, AB_FELSENSTEIN):
        raise ValueError(f"unknown asc type {asc_type}")
    asc_cols = (idxs >= n_real) & (idxs < n_real + states)
    zero = torch.zeros_like(site[0])
    scaling = torch.pow(torch.full((), scale_threshold, dtype=dtype,
                                   device=site.device),
                        asc_scalers.to(dtype))
    asc_lk = torch.sum(torch.where(asc_cols[None, :],
                                   site * scaling[None, :], zero[None, :]),
                       dim=1)                                 # [3]
    sum_w = (torch.sum(pw * main) if asc_type == AB_LEWIS
             else torch.sum(torch.where(asc_cols, pw, zero)))
    return sums + [sum_w, *asc_lk.unbind()]


def _asc_derivatives(d1, d2, sum_w, asc_lk, asc_type: int):
    """The Lewis or Felsenstein terms added to the main sums
    (core_derivatives.c:852-924): `asc_lk` [3] holds the synthetic columns'
    L, L' and L'' summed, `sum_w` the weight the correction scales by."""
    if asc_type == AB_LEWIS:
        d1 = d1 + sum_w * (asc_lk[1] / (asc_lk[0] - 1.0))
        d2 = d2 + sum_w * (((asc_lk[0] - 1.0) * asc_lk[2]
                            - asc_lk[1] * asc_lk[1])
                           / ((asc_lk[0] - 1.0) * (asc_lk[0] - 1.0)))
    else:
        d1 = d1 - sum_w * (asc_lk[1] / asc_lk[0])
        d2 = d2 - sum_w * ((asc_lk[2] * asc_lk[0]
                            - asc_lk[1] * asc_lk[1])
                           / (asc_lk[0] * asc_lk[0]))
    return d1, d2


def derivative_parts(asc_type: int) -> int:
    """Length of the partial sums `derivatives_total` finishes
    (`_derivative_sums`)."""
    return 6 if asc_type in (AB_LEWIS, AB_FELSENSTEIN) else 2


def derivatives_total(parts: torch.Tensor, asc_type: int):
    """(d1, d2) from partial sums [derivative_parts]: a shard's summed
    over the shards, or a whole partition's."""
    if asc_type in (AB_LEWIS, AB_FELSENSTEIN):
        return _asc_derivatives(parts[0], parts[1], parts[2], parts[3:6],
                                asc_type)
    return parts[0], parts[1]


def newton_step(length: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor,
                xmin: float, xmax: float) -> torch.Tensor:
    """One guarded Newton-Raphson update on a branch length."""
    step = torch.where(d2 != 0.0, d1 / d2, torch.zeros_like(d1))
    new = length - step
    # fall back to bisection-style damping when Newton leaves the bracket
    damped = torch.where(d1 > 0, length / 2.0,
                         torch.clamp(length * 2.0, max=xmax))
    new = torch.where((new < xmin) | (new > xmax) | (d2 <= 0.0), damped, new)
    return torch.clamp(new, xmin, xmax)
