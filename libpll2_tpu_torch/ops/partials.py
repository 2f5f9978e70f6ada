"""Conditional likelihood vector (CLV) updates -- Felsenstein pruning, in
plain PyTorch.

Port of the XLA paths of libpll2_tpu/ops/partials.py (reference: libpll-2
src/partials.c:237-291, src/core_partials.c:629-790). CLVs are stored as
[node, rate, state, site]; tips are bit-decoded CLVs, so every operation is
the inner-inner case:

    parent[r, i, s] = (sum_j Pl[r,i,j] * left[r,j,s])
                    * (sum_j Pr[r,i,j] * right[r,j,s])

`update_partials` runs the operation list serially (JAX's `lax.scan`);
`update_partials_levels` runs it level by level, each level batched over its
ops. These serve `TreeEngine(pallas=False)` ('scan' / 'levels') and float64
references; the hand-written level kernel is ops/levels.py. Site repeats'
pooled class columns are updated by ops/pool.py (its plain version serves
`TreeEngine(pallas=False)` on a repeats partition, 'pool');
`gather_flat_view` expands pooled class columns to per-site order.

Scaling (core_partials.c:707-789): per-site mode multiplies the whole site
block by `scale_factor` when all states x rates entries fall below
`scale_threshold` and increments an integer scaler; per-rate mode checks each
rate category on its own. Parent scalers are the sum of the child scalers
(pll.c:1183 fill_parent_scaler) plus that increment. An op without a parent
scaler (-1) is not rescaled; its count goes to the trash row K of the
[K+2, ...] scaler buffer, and row K+1 stays zero for every -1 read.

Unlike JAX's pure functions, these update `clv` and `scaler` in place (the
buffers are hundreds of MB at full width) and return them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Operations", "update_partials", "update_partials_levels",
           "gather_flat_view"]


class Operations(NamedTuple):
    """Structure-of-arrays operation list (pll.h:314-324 pll_operation_t):
    int64 tensors of shape [n] (serial) or [L, W] (level-grouped)."""
    parent_clv: torch.Tensor
    parent_scaler: torch.Tensor       # -1 = none
    child1_clv: torch.Tensor
    child1_matrix: torch.Tensor
    child1_scaler: torch.Tensor
    child2_clv: torch.Tensor
    child2_matrix: torch.Tensor
    child2_scaler: torch.Tensor


def _read_scaler(scaler: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Child scaler row(s), or zeros where idx is SCALE_BUFFER_NONE (-1).
    idx is a [W] vector of rows."""
    row = scaler[idx.clamp(min=0)]
    ok = (idx >= 0).reshape(idx.shape + (1,) * (row.dim() - idx.dim()))
    return torch.where(ok, row, torch.zeros_like(row))


def _rescale(x: torch.Tensor, threshold: float, factor: float,
             rate_scalers: bool, state_dim: int):
    """(x with underflowing blocks multiplied by factor, the int32 mask):
    per site over rates and states, or per rate over states."""
    if rate_scalers:
        mask = torch.all(x < threshold, dim=state_dim)
        scaled = torch.where(mask.unsqueeze(state_dim), x * factor, x)
    else:
        mask = torch.all(x < threshold, dim=state_dim).all(dim=state_dim - 1)
        scaled = torch.where(mask.unsqueeze(-2).unsqueeze(-2), x * factor, x)
    return scaled, mask.to(torch.int32)


def update_partials(clv: torch.Tensor,        # [N+1, R, s, S]
                    scaler: torch.Tensor,     # [K+2, S] or [K+2, R, S] int32
                    pmatrix: torch.Tensor,    # [E, R, s, s]
                    ops: Operations,          # [n] each
                    scale_threshold: float,
                    scale_factor: float,
                    rate_scalers: bool = False):
    """Execute the operation list in order; returns (clv, scaler), updated
    in place. The list is walked on the host, one op at a time."""
    trash = scaler.shape[0] - 2
    rows = torch.stack(list(ops), dim=1).tolist()
    for parent, psc, c1, m1, s1, c2, m2, s2 in rows:
        x = (torch.einsum('rij,rjs->ris', pmatrix[m1], clv[c1])
             * torch.einsum('rij,rjs->ris', pmatrix[m2], clv[c2]))
        child_sc = sum(scaler[s] if s >= 0 else torch.zeros_like(scaler[0])
                       for s in (s1, s2))
        scaled, mask = _rescale(x, scale_threshold, scale_factor,
                                rate_scalers, state_dim=1)
        clv[parent] = scaled if psc >= 0 else x
        scaler[psc if psc >= 0 else trash] = child_sc + mask
    return clv, scaler


def update_partials_levels(clv: torch.Tensor,
                           scaler: torch.Tensor,
                           pmatrix: torch.Tensor,
                           ops: Operations,          # [L, W] each
                           valid: torch.Tensor,      # [L, W] bool
                           scale_threshold: float,
                           scale_factor: float,
                           rate_scalers: bool = False):
    """Level-scheduled variant: the ops of one level are independent, so
    each level gathers its children, computes all W parents at once and
    scatters them. Padded slots (valid False) write the scratch CLV row N
    and the trash scaler row. Returns (clv, scaler), updated in place."""
    n_nodes = clv.shape[0] - 1          # last row is scratch
    trash = scaler.shape[0] - 2
    for lv in range(valid.shape[0]):
        parent, psc, c1, m1, s1, c2, m2, s2 = (f[lv] for f in ops)
        ok = valid[lv]
        x = (torch.einsum('wrij,wrjs->wris', pmatrix[m1], clv[c1])
             * torch.einsum('wrij,wrjs->wris', pmatrix[m2], clv[c2]))
        has_scaler = (psc >= 0) & ok
        child_sc = _read_scaler(scaler, s1) + _read_scaler(scaler, s2)
        scaled, mask = _rescale(x, scale_threshold, scale_factor,
                                rate_scalers, state_dim=2)
        hs = has_scaler.reshape((-1,) + (1,) * (x.dim() - 1))
        clv[torch.where(ok, parent, n_nodes)] = torch.where(hs, scaled, x)
        scaler[torch.where(has_scaler, psc, trash)] = child_sc + mask
    return clv, scaler


def gather_flat_view(clv_flat: torch.Tensor,     # [R, s, T]
                     sc_flat: torch.Tensor,      # [T2] or [R, T2]
                     clv_cols: torch.Tensor,     # [S] absolute columns
                     sc_cols: torch.Tensor):     # [S] absolute columns
    """Per-site expansion of one node from the pooled storage (clv [R, s,
    S], scaler [S], or [R, S] per rate) for the likelihood and sumtable
    functions (core_likelihood.c:211-349 repeats indexing)."""
    return clv_flat[:, :, clv_cols], sc_flat[..., sc_cols]
