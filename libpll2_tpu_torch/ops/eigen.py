"""Eigendecomposition of reversible substitution rate matrices.

Semantics match the reference (reference: libpll-2 src/models.c:182-410):

  * substitution params are the upper triangle of a symmetric exchangeability
    matrix, normalized so the last parameter is 1;
  * Q is symmetrized as S = sqrt(Pi) Q sqrt(Pi)^-1 and normalized so the mean
    substitution rate (sum_i pi_i * -q_ii) is 1;
  * states whose frequency is <= EIGEN_MINFREQ are eliminated from the eigen
    problem (the IQ-TREE trick, models.c:258-291) and given eigenvalue 0 with
    identity eigenvector rows/cols;
  * the eigenvectors are rescaled by sqrt(Pi) so that
        P(t) = I + inv_evecs @ diag(expm1(lambda * t)) @ evecs
    needs no further frequency factors (models.c:388-398).

Returned orientation (identical to the reference buffers):
  evecs[m, k]      = V[k, m] * sqrt(pi_k)   ("eigenvecs", rows = eigenvectors)
  inv_evecs[j, m]  = V[j, m] / sqrt(pi_j)   ("inv_eigenvecs")
where V is the orthonormal eigenvector matrix (columns) of S.

Host-side numpy: eigendecompositions happen once per parameter change, on
tiny (states x states) matrices. Carried over from libpll2_tpu/ops/eigen.py;
the differentiable on-device variant comes with the optimisation slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..constants import EIGEN_MINFREQ


class EigenSystem(NamedTuple):
    eigenvals: np.ndarray   # [states]
    evecs: np.ndarray       # [states, states]  right factor B
    inv_evecs: np.ndarray   # [states, states]  left factor A


def build_rate_matrix_sym(subst_params: np.ndarray,
                          freqs: np.ndarray) -> np.ndarray:
    """Symmetrized, mean-rate-normalized rate matrix S = sqrt(Pi) Q sqrt(Pi)^-1.

    Mirrors create_ratematrix (models.c:182-256): params normalized by the
    last one; entries involving a (near-)zero-frequency state are zeroed.
    """
    states = freqs.shape[0]
    params = np.asarray(subst_params, dtype=np.float64).copy()
    if params[-1] > 0.0:
        params = params / params[-1]

    s = np.zeros((states, states), dtype=np.float64)
    iu, ju = np.triu_indices(states, k=1)
    ok = (freqs[iu] > EIGEN_MINFREQ) & (freqs[ju] > EIGEN_MINFREQ)
    factor = np.where(ok, params, 0.0)
    s[iu, ju] = s[ju, iu] = factor * np.sqrt(freqs[iu] * freqs[ju])
    # diagonal accumulates -factor * freq of the partner state
    diag = np.zeros(states)
    np.add.at(diag, iu, -factor * freqs[ju])
    np.add.at(diag, ju, -factor * freqs[iu])
    s[np.arange(states), np.arange(states)] = diag

    mean = float(np.sum(freqs * -diag))
    if mean != 0.0:
        s /= mean
    return s


def update_eigen(subst_params: np.ndarray, freqs: np.ndarray) -> EigenSystem:
    """Eigendecompose one rate matrix, reference-equivalent (models.c:293-410)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    states = freqs.shape[0]
    s = build_rate_matrix_sym(subst_params, freqs)

    keep = freqs > EIGEN_MINFREQ
    kept = np.flatnonzero(keep)
    sub = s[np.ix_(kept, kept)]
    w, v = np.linalg.eigh(sub)  # sub = v @ diag(w) @ v.T, v columns orthonormal

    eigenvals = np.zeros(states, dtype=np.float64)
    eigenvals[kept] = w

    sqrt_f = np.sqrt(freqs[kept])
    # start from identity so eliminated states act as fixed (rate-0) states
    evecs = np.eye(states, dtype=np.float64)
    inv_evecs = np.eye(states, dtype=np.float64)
    # evecs[m, k] = v[k', m'] * sqrt(f_k);  inv_evecs[j, m] = v[j', m'] / sqrt(f_j)
    evecs[np.ix_(kept, kept)] = v.T * sqrt_f[None, :]
    inv_evecs[np.ix_(kept, kept)] = v / sqrt_f[:, None]
    return EigenSystem(eigenvals, evecs, inv_evecs)


def update_eigen_batch(subst_params: np.ndarray,
                       freqs: np.ndarray) -> EigenSystem:
    """Vectorized convenience over the leading rate-matrix axis.

    subst_params: [M, states*(states-1)/2], freqs: [M, states]
    """
    out = [update_eigen(p, f) for p, f in zip(subst_params, freqs)]
    return EigenSystem(np.stack([o.eigenvals for o in out]),
                       np.stack([o.evecs for o in out]),
                       np.stack([o.inv_evecs for o in out]))
