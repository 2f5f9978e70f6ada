"""Discrete Gamma(alpha, alpha) rate categories.

Semantics match the reference (reference: libpll-2 src/gamma.c:220-292):
mean or median discretization of a Gamma(alpha, beta=alpha) distribution into
N categories, normalized to mean rate 1. The reference ports Yang's PAML
routines (PointChi2/IncompleteGamma); we use scipy's regularized incomplete
gamma functions, which compute the same quantities to full double precision.

Host-side (numpy): category rates are tiny and change only when alpha does.
"""
from __future__ import annotations

import numpy as np
from scipy import special

from ..constants import (ALPHA_MIN, ERROR_PARAM_INVALID, GAMMA_RATES_MEAN,
                         GAMMA_RATES_MEDIAN, PllError)


def _ln_gamma(alpha: float) -> float:
    """log Gamma via Stirling with argument shifting (Pike & Hill AS291).

    Matches the reference's convergence behavior exactly; scipy's gammaln is
    equivalent to ~1e-10 but we reproduce the classical series so discretized
    rates are bit-identical to the reference."""
    x, f = alpha, 0.0
    if x < 7.0:
        f = 1.0
        z = alpha - 1.0
        z += 1.0
        while z < 7.0:
            f *= z
            z += 1.0
        x = z
        f = -np.log(f)
    z = 1.0 / (x * x)
    return (f + (x - 0.5) * np.log(x) - x + .918938533204673
            + (((-.000595238095238 * z + .000793650793651) * z
                - .002777777777778) * z + .083333333333333) / x)


def _incomplete_gamma(x: float, alpha: float, ln_gamma_alpha: float) -> float:
    """Regularized lower incomplete gamma P(alpha, x), Bhattacharjee AS32.

    Series expansion for x <= max(1, alpha), continued fraction otherwise —
    converged to 1e-8 like the reference, so discretization matches it."""
    accurate, overflow = 1e-8, 1e30
    if x == 0.0:
        return 0.0
    if x < 0 or alpha <= 0:
        return -1.0
    factor = np.exp(alpha * np.log(x) - x - ln_gamma_alpha)
    if not (x > 1 and x >= alpha):
        gin, term, rn = 1.0, 1.0, alpha
        while True:
            rn += 1.0
            term *= x / rn
            gin += term
            if term <= accurate:
                return gin * factor / alpha
    a = 1.0 - alpha
    b = a + x + 1.0
    term = 0.0
    pn = [1.0, x, x + 1.0, x * b, 0.0, 0.0]
    gin = pn[2] / pn[3]
    while True:
        a += 1.0
        b += 2.0
        term += 1.0
        an = a * term
        pn[4] = b * pn[2] - an * pn[0]
        pn[5] = b * pn[3] - an * pn[1]
        if pn[5] != 0.0:
            rn = pn[4] / pn[5]
            dif = abs(gin - rn)
            # on convergence AS32 returns the PREVIOUS iterate, not rn
            if dif <= accurate and dif <= accurate * rn:
                return 1.0 - factor * gin
            gin = rn
        pn = [pn[2], pn[3], pn[4], pn[5], 0.0, 0.0]
        if abs(pn[3]) >= overflow:
            pn = [v / overflow for v in pn]


def _point_normal(prob: float) -> float:
    """Standard normal quantile, Odeh & Evans AS70."""
    a0, a1, a2, a3 = -.322232431088, -1.0, -.342242088547, -.0204231210245
    a4 = -.453642210148e-4
    b0, b1, b2 = .0993484626060, .588581570495, .531103462366
    b3, b4 = .103537752850, .0038560700634
    p1 = prob if prob < 0.5 else 1.0 - prob
    if p1 < 1e-20:
        return -9999.0
    y = np.sqrt(np.log(1.0 / (p1 * p1)))
    z = y + ((((y * a4 + a3) * y + a2) * y + a1) * y + a0) \
        / ((((y * b4 + b3) * y + b2) * y + b1) * y + b0)
    return -z if prob < 0.5 else z


def _point_chi2(prob: float, v: float) -> float:
    """Chi-square quantile, Best & Roberts AS91 (as iterated by the
    reference/PAML, outer tolerance .5e-6 with Taylor refinement)."""
    e, aa = 0.5e-6, 0.6931471805
    if prob < 2e-6 or prob > .999998 or v <= 0:
        return -1.0
    g = _ln_gamma(v / 2.0)
    xx = v / 2.0
    c = xx - 1.0
    if v < -1.24 * np.log(prob):
        ch = (prob * xx * np.exp(g + xx * aa)) ** (1.0 / xx)
        if ch - e < 0:
            return ch
    else:
        if v <= .32:
            ch = 0.4
            a = np.log(1 - prob)
            while True:
                q = ch
                p1 = 1 + ch * (4.67 + ch)
                p2 = ch * (6.73 + ch * (6.66 + ch))
                t = -0.5 + (4.67 + 2 * ch) / p1 \
                    - (6.73 + ch * (13.32 + 3 * ch)) / p2
                ch -= (1 - np.exp(a + g + .5 * ch + c * aa) * p2 / p1) / t
                if abs(q / ch - 1) - .01 <= 0:
                    break
        else:
            x = _point_normal(prob)
            p1 = 0.222222 / v
            ch = v * (x * np.sqrt(p1) + 1 - p1) ** 3.0
            if ch > 2.2 * v + 6:
                ch = -2 * (np.log(1 - prob) - c * np.log(.5 * ch) + g)
    while True:
        q = ch
        p1 = .5 * ch
        t = _incomplete_gamma(p1, xx, g)
        if t < 0.0:
            return -1.0
        p2 = prob - t
        t = p2 * np.exp(xx * aa + g + p1 - c * np.log(ch))
        b = t / ch
        a = 0.5 * t - b * c
        s1 = (210 + a * (140 + a * (105 + a * (84 + a * (70 + 60 * a))))) / 420
        s2 = (420 + a * (735 + a * (966 + a * (1141 + 1278 * a)))) / 2520
        s3 = (210 + a * (462 + a * (707 + 932 * a))) / 2520
        s4 = (252 + a * (672 + 1182 * a) + c * (294 + a * (889 + 1740 * a))) / 5040
        s5 = (84 + 264 * a + c * (175 + 606 * a)) / 2520
        s6 = (120 + c * (346 + 127 * c)) / 5040
        ch += t * (1 + 0.5 * t * s1 - b * c *
                   (s1 - b * (s2 - b * (s3 - b * (s4 - b * (s5 - b * s6))))))
        if abs(q / ch - 1) <= e:
            return ch


def _gamma_ppf(prob, alpha: float, beta: float):
    """Quantile of Gamma(alpha, rate=beta); PointChi2(p, 2a)/(2b)."""
    probs = np.atleast_1d(np.asarray(prob, dtype=np.float64))
    out = np.array([_point_chi2(p, 2.0 * alpha) / (2.0 * beta)
                    for p in probs])
    return out


def _gamma_ppf_scipy(prob, alpha: float, beta: float):
    """Exact quantile via scipy (cross-check / fast path)."""
    return special.gammaincinv(alpha, prob) / beta


def compute_gamma_cats(alpha: float,
                       categories: int,
                       rates_mode: int = GAMMA_RATES_MEAN) -> np.ndarray:
    """Return the `categories` discrete rates for a Gamma(alpha, alpha) model.

    rates_mode: GAMMA_RATES_MEAN (category means between quantile cut points,
    the default everywhere in the reference) or GAMMA_RATES_MEDIAN (category
    medians, renormalized to mean 1).
    """
    if alpha < ALPHA_MIN or categories < 1:
        raise PllError(ERROR_PARAM_INVALID, f"Invalid alpha value ({alpha})")

    k = int(categories)
    if k == 1:
        return np.array([1.0])

    a = b = float(alpha)
    if rates_mode == GAMMA_RATES_MEDIAN:
        probs = (2.0 * np.arange(k) + 1.0) / (2.0 * k)
        rates = _gamma_ppf(probs, a, b)
        rates *= k / rates.sum()
        return rates
    if rates_mode == GAMMA_RATES_MEAN:
        # quantile cut points between categories
        cuts = _gamma_ppf((np.arange(k - 1) + 1.0) / k, a, b)
        # mean of a Gamma(a, b) truncated below x is gammainc(a+1, b*x)-shaped:
        # P(a+1, b*x) is the fraction of the distribution mean below x.
        lnga1 = _ln_gamma(a + 1.0)
        frac = np.array([_incomplete_gamma(c * b, a + 1.0, lnga1)
                         for c in cuts])
        edges = np.concatenate([[0.0], frac, [1.0]])
        return np.diff(edges) * k
    raise PllError(ERROR_PARAM_INVALID,
                   f"Invalid GAMMA discretization mode ({rates_mode})")
