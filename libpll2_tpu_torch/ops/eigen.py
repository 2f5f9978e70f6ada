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
tiny (states x states) matrices. Carried over from libpll2_tpu/ops/eigen.py.
`update_eigen_torch` is the differentiable, batched counterpart of
libpll2_tpu's `update_eigen_jax` (optimize.py's gradient route and model
trials), through `_EighDegenerateSafe`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


class _EighDegenerateSafe(torch.autograd.Function):
    """torch.linalg.eigh with a gradient that is defined at REPEATED
    eigenvalues (libpll2_tpu/ops/eigen.py:96-128, `_eigh_degenerate_safe`).
    Named DNA models have degenerate spectra by construction (JC: one
    eigenvalue of multiplicity 3; K80/HKY at equal frequencies: a pair),
    where the usual 1/(w_j - w_i) factors are infinite. P(t) = E diag(exp(w
    t)) E^-1 does not change under a rotation within a degenerate
    eigenspace, so the cross terms inside such a block carry nothing, and
    masking them gives the right gradient.

    JAX defines the JVP: with A' = sym(dA) and M' = V^T A' V, dw = diag(M')
    and dV = V (F o M'), where F[i, j] = 1 / (w_j - w_i), and 0 where
    |w_j - w_i| <= 1e3 eps(dtype) max|w|. Its transpose, with M = V^T Vbar:
    <wbar, dw> + <Vbar, dV> = <V (diag(wbar) + F o M) V^T, A'>, so
    Abar = sym(V (diag(wbar) + F o M) V^T).

    Within a degenerate block this is not the derivative of P(t): there
    the Daleckii-Krein derivative of a matrix function f has f'(w) times the
    block's off-diagonal entries of M', which the mask drops (checked
    against finite differences in tests/test_torch_optimize.py: at JC it
    misses every direction that splits the triple eigenvalue, and its value
    depends on the basis eigh picks in the block). The gradient route of
    optimize.py therefore takes the P-matrices' derivative from
    ops/pmatrix.py:update_prob_matrices_sym."""

    @staticmethod
    def forward(ctx, a):
        w, v = torch.linalg.eigh(a)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, w_bar, v_bar):
        w, v = ctx.saved_tensors
        vt = v.transpose(-1, -2)
        diff = w[..., None, :] - w[..., :, None]          # [i, j] = w_j - w_i
        scale = w.abs().amax(dim=-1, keepdim=True)[..., None]
        # the mask width tracks the dtype: structurally repeated eigenvalues
        # come out ~eps(dtype) apart
        tol = 1e3 * torch.finfo(w.dtype).eps
        degenerate = diff.abs() <= tol * scale.clamp(min=1e-30)
        f = torch.where(degenerate, torch.zeros_like(diff),
                        1.0 / torch.where(degenerate, torch.ones_like(diff),
                                          diff))
        inner = f * (vt @ v_bar) + torch.diag_embed(w_bar)
        g = v @ inner @ vt
        return (g + g.transpose(-1, -2)) / 2


def eigh_degenerate_safe(a: torch.Tensor):
    """(eigenvalues ascending, orthonormal eigenvector columns) of the
    symmetric matrices `a` [..., n, n], with `_EighDegenerateSafe`'s
    gradient."""
    return _EighDegenerateSafe.apply(a)


def rate_matrix_sym_torch(subst_params: torch.Tensor,
                          freqs: torch.Tensor) -> torch.Tensor:
    """`build_rate_matrix_sym` in torch, batched over the leading axis and
    differentiable (no zero-frequency elimination): S [M, s, s] =
    sqrt(Pi) Q sqrt(Pi)^-1, mean-rate normalized."""
    m, states = freqs.shape
    dtype, dev = freqs.dtype, freqs.device
    params = subst_params / subst_params[:, -1:]
    iu, ju = (torch.as_tensor(a, device=dev)
              for a in np.triu_indices(states, k=1))
    factor = params * torch.sqrt(freqs[:, iu] * freqs[:, ju])
    s = torch.zeros((m, states, states), dtype=dtype, device=dev)
    s[:, iu, ju] = factor
    s[:, ju, iu] = factor
    diag = (torch.zeros((m, states), dtype=dtype, device=dev)
            .index_add(1, iu, -params * freqs[:, ju])
            .index_add(1, ju, -params * freqs[:, iu]))
    ar = torch.arange(states, device=dev)
    s[:, ar, ar] = diag
    mean = torch.sum(freqs * -diag, dim=1)
    return s / mean[:, None, None]


def update_eigen_torch(subst_params: torch.Tensor, freqs: torch.Tensor):
    """Batched eigendecomposition in torch: the math of `update_eigen`
    (libpll2_tpu/ops/eigen.py:131-160 `update_eigen_jax`), so that many
    trial models are decomposed at once on the device. Differentiable
    through `_EighDegenerateSafe`, whose gradient is JAX's: exact off
    degenerate blocks, not within them (optimize.py's gradient route
    differentiates the P-matrices through ops/pmatrix.py:
    update_prob_matrices_sym instead). No zero-frequency elimination.

    subst_params: [M, s*(s-1)/2], freqs: [M, s] (one dtype and device).
    Returns (eigenvals [M, s], evecs [M, s, s], inv_evecs [M, s, s]) in the
    orientation of `EigenSystem`."""
    w, v = eigh_degenerate_safe(rate_matrix_sym_torch(subst_params, freqs))
    sqrt_f = torch.sqrt(freqs)
    evecs = v.transpose(1, 2) * sqrt_f[:, None, :]
    inv_evecs = v / sqrt_f[:, :, None]
    return w, evecs, inv_evecs
