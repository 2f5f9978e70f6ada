"""Batched transition-probability matrices P(t) = exp(Qt), in PyTorch.

Port of libpll2_tpu/ops/pmatrix.py:update_prob_matrices (reference:
libpll-2 src/core_pmatrix.c:24-244). Numerical semantics preserved:
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
