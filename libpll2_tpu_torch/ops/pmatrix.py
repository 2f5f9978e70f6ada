"""Batched transition-probability matrices P(t) = exp(Qt), in PyTorch.

Port of libpll2_tpu/ops/pmatrix.py: `update_prob_matrices` (one rate matrix
per category for every edge) and `update_prob_matrices_per_edge` (per-branch
heterotachy: a rate matrix per edge and category); `update_prob_matrices_trials`
builds both for K model trials at once (libpll2_tpu/optimize.py's vmap over
trial eigensystems); `update_prob_matrices_sym` builds them from the
symmetric rate matrix with the exact derivative of the matrix function
(optimize.py's gradient route). Reference: libpll-2
src/core_pmatrix.c:24-244. Numerical semantics preserved:
  * P = I + inv_evecs @ diag(expm1(lambda * rate * t / (1 - pinv))) @ evecs.
    The expm1 + identity form keeps P well-conditioned as Qt -> 0
    (core_pmatrix.c:189-223).
  * pinv is only applied when > MISC_EPSILON (core_pmatrix.c:196).
  * branch length <= 0 yields the identity matrix (core_pmatrix.c:227-231).
"""
from __future__ import annotations

import torch

from ..constants import MISC_EPSILON


def update_prob_matrices(eigenvals: torch.Tensor,     # [M, s]
                         inv_evecs: torch.Tensor,     # [M, s, s]
                         evecs: torch.Tensor,         # [M, s, s]
                         prop_invar: torch.Tensor,    # [M]
                         rates: torch.Tensor,         # [R]
                         params_idx: torch.Tensor,    # [R] int
                         branch_lengths: torch.Tensor,  # [E]
                         ) -> torch.Tensor:
    """Return P as a contiguous [E, R, states, states] tensor in the dtype
    of `evecs` (the fused kernel reads it flat)."""
    dtype = evecs.dtype
    states = evecs.shape[-1]

    lam = eigenvals[params_idx]        # [R, s]
    a = inv_evecs[params_idx]          # [R, s, s]
    b = evecs[params_idx]              # [R, s, s]
    pinv = prop_invar[params_idx]      # [R]
    pinv = torch.where(pinv > MISC_EPSILON, pinv, torch.zeros_like(pinv))

    t = branch_lengths.to(dtype)       # [E]
    # exponent[e, r, m]
    expo = (lam * (rates / (1.0 - pinv))[:, None])[None, :, :] \
        * t[:, None, None]
    expd = torch.expm1(expo)

    # P[e,r,j,k] = I + sum_m a[r,j,m] * expd[e,r,m] * b[r,m,k]
    left = a[None, :, :, :] * expd[:, :, None, :]          # [E,R,j,m]
    eye = torch.eye(states, dtype=dtype, device=evecs.device)
    pmat = torch.einsum('erjm,rmk->erjk', left, b) + eye
    zero_len = (t <= 0.0)[:, None, None, None]
    return torch.where(zero_len, eye, pmat).contiguous()


def update_prob_matrices_per_edge(eigenvals: torch.Tensor,     # [M, s]
                                  inv_evecs: torch.Tensor,     # [M, s, s]
                                  evecs: torch.Tensor,         # [M, s, s]
                                  prop_invar: torch.Tensor,    # [M]
                                  rates: torch.Tensor,         # [R]
                                  params_idx: torch.Tensor,    # [E, R] int
                                  branch_lengths: torch.Tensor,  # [E]
                                  ) -> torch.Tensor:
    """Per-branch heterotachy: every edge may use another rate matrix
    (reference examples/heterotachy, which calls pll_update_prob_matrices
    once per branch class). `params_idx` is a full [edges, rate_cats]
    table; returns a contiguous P [E, R, s, s]."""
    dtype = evecs.dtype
    states = evecs.shape[-1]

    lam = eigenvals[params_idx]        # [E, R, s]
    a = inv_evecs[params_idx]          # [E, R, s, s]
    b = evecs[params_idx]              # [E, R, s, s]
    pinv = prop_invar[params_idx]      # [E, R]
    pinv = torch.where(pinv > MISC_EPSILON, pinv, torch.zeros_like(pinv))

    t = branch_lengths.to(dtype)       # [E]
    expo = lam * (rates[None, :] / (1.0 - pinv))[:, :, None] \
        * t[:, None, None]
    expd = torch.expm1(expo)           # [E, R, s]

    left = a * expd[:, :, None, :]                         # [E,R,j,m]
    eye = torch.eye(states, dtype=dtype, device=evecs.device)
    pmat = torch.einsum('erjm,ermk->erjk', left, b) + eye
    zero_len = (t <= 0.0)[:, None, None, None]
    return torch.where(zero_len, eye, pmat).contiguous()


def update_prob_matrices_trials(eigenvals: torch.Tensor,    # [K, M, s]
                                inv_evecs: torch.Tensor,    # [K, M, s, s]
                                evecs: torch.Tensor,        # [K, M, s, s]
                                prop_invar: torch.Tensor,   # [(K,) M]
                                rates: torch.Tensor,        # [R]
                                params_idx: torch.Tensor,   # [(E,) R] int
                                branch_lengths: torch.Tensor,  # [E]
                                ) -> torch.Tensor:
    """P of K trial models over one set of branch lengths: each trial its
    own eigensystems (and p-inv, with `prop_invar` [K, M]), one rate matrix
    per category for every edge, or per edge and category with
    `params_idx` [E, R]. Returns a contiguous P [K, E, R, s, s], each
    trial's equal to `update_prob_matrices(_per_edge)` of its own model."""
    dtype = evecs.dtype
    states = evecs.shape[-1]
    pidx = params_idx if params_idx.dim() == 2 else params_idx[None]
    lam = eigenvals[:, pidx]           # [K, E|1, R, s]
    a = inv_evecs[:, pidx]             # [K, E|1, R, s, s]
    b = evecs[:, pidx]
    pinv = (prop_invar if prop_invar.dim() == 2 else prop_invar[None])
    pinv = pinv[:, pidx]               # [K|1, E|1, R]
    pinv = torch.where(pinv > MISC_EPSILON, pinv, torch.zeros_like(pinv))

    t = branch_lengths.to(dtype)       # [E]
    expo = lam * (rates / (1.0 - pinv))[..., None] * t[None, :, None, None]
    expd = torch.expm1(expo)           # [K, E, R, s]

    eye = torch.eye(states, dtype=dtype, device=evecs.device)
    pmat = torch.matmul(a * expd[..., None, :], b) + eye
    zero_len = (t <= 0.0)[None, :, None, None, None]
    return torch.where(zero_len, eye, pmat).contiguous()


def _expm1_divided(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Divided differences of x -> expm1(x c) at the eigenvalue pairs:
    [..., i, j] = (expm1(w_i c) - expm1(w_j c)) / (w_i - w_j), and c e^(w_i
    c) where w_i == w_j, in the stable form c e^(w_j c) expm1(z) / z with
    z = (w_i - w_j) c. `w` [R, s], `c` [E, R]; returns [E, R, s, s]."""
    x = w[None] * c[..., None]                              # [E, R, s]
    z = (w[..., :, None] - w[..., None, :])[None] * c[..., None, None]
    safe = torch.where(z == 0, torch.ones_like(z), z)
    h = torch.where(z == 0, torch.ones_like(z), torch.expm1(safe) / safe)
    return c[..., None, None] * torch.exp(x)[..., None, :] * h


class _SymExpm1(torch.autograd.Function):
    """Q[e, r] = V_r diag(expm1(w_r c[e, r])) V_r^T for symmetric matrices
    S_r = V_r diag(w_r) V_r^T [R, s, s] and scales c [E, R], with the
    Daleckii-Krein derivative: for Y = V^T Qbar V, Sbar_r = sym(sum_e V
    (Phi o Y) V^T) with Phi the divided differences of expm1(. c), and cbar
    = sum_k w_k e^(w_k c) Y_kk. It holds at repeated eigenvalues (JC, K80,
    HKY at equal frequencies), where an eigh backward cannot."""

    @staticmethod
    def forward(ctx, s, c):
        w, v = torch.linalg.eigh(s)
        ctx.save_for_backward(w, v, c)
        vt = v.transpose(-1, -2)
        return (v[None] * torch.expm1(w[None] * c[..., None])[..., None, :]
                ) @ vt[None]

    @staticmethod
    def backward(ctx, q_bar):
        w, v, c = ctx.saved_tensors
        vt = v.transpose(-1, -2)
        y = vt[None] @ q_bar @ v[None]                       # [E, R, s, s]
        phi = _expm1_divided(w, c)
        g = (v[None] @ (phi * y) @ vt[None]).sum(dim=0)
        s_bar = (g + g.transpose(-1, -2)) / 2
        diag = torch.diagonal(y, dim1=-2, dim2=-1)           # [E, R, s]
        c_bar = torch.sum(w[None] * torch.exp(w[None] * c[..., None])
                          * diag, dim=-1)
        return s_bar, c_bar


def update_prob_matrices_sym(sym: torch.Tensor,           # [M, s, s]
                             freqs: torch.Tensor,         # [M, s]
                             prop_invar: torch.Tensor,    # [M]
                             rates: torch.Tensor,         # [R]
                             params_idx: torch.Tensor,    # [R] int
                             branch_lengths: torch.Tensor,  # [E]
                             ) -> torch.Tensor:
    """`update_prob_matrices` from the symmetric rate matrices S =
    sqrt(Pi) Q sqrt(Pi)^-1 (ops/eigen.py:rate_matrix_sym_torch): P =
    I + Pi^-1/2 expm1(S rate t / (1 - pinv)) Pi^1/2, the same values,
    differentiable in S, the frequencies and the branch lengths with the
    exact derivative of the matrix function (`_SymExpm1`). Returns P [E, R,
    s, s]."""
    dtype = sym.dtype
    states = sym.shape[-1]
    pinv = prop_invar[params_idx]
    pinv = torch.where(pinv > MISC_EPSILON, pinv, torch.zeros_like(pinv))
    t = branch_lengths.to(dtype)
    scale = (rates / (1.0 - pinv))[None, :] * t[:, None]     # [E, R]
    q = _SymExpm1.apply(sym[params_idx], scale)
    sqrt_f = torch.sqrt(freqs[params_idx])                    # [R, s]
    eye = torch.eye(states, dtype=dtype, device=sym.device)
    pmat = q * (sqrt_f[:, None, :] / sqrt_f[:, :, None])[None] + eye
    zero_len = (t <= 0.0)[:, None, None, None]
    return torch.where(zero_len, eye, pmat).contiguous()
