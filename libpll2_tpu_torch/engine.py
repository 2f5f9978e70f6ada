"""Full-tree evaluation on the fused path, in PyTorch.

Port of the fused path of libpll2_tpu/engine.py (`_fused_loglikelihood`,
`_fused_newton_step` and `TreeEngine`):

    branches -> P-matrices -> one fused traversal launch -> root-edge logL
             (-> sumtable -> d1/d2 -> guarded Newton step on the root edge)

The traversal kernel (ops/fused.py) returns only the root edge's two CLVs
and their scaler counts; everything else is plain tensor code on the
partition's device. The engine follows its partition's `device` and
`dtype`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import constants as C
from .ops import derivatives as ops_derivatives
from .ops import fused as ops_fused
from .ops import likelihood as ops_likelihood
from .ops import pmatrix as ops_pmatrix
from .partition import Operation, Partition, not_ported
from .trees import create_operations, traverse

__all__ = ["TreeEngine"]


def _fused_loglikelihood(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, rate_weights, freqs, params_idx_rates,
                         branches, table, tip_codes, root_mat: int,
                         pattern_weights, invariant, n_slots: int,
                         scale_threshold: float, scale_factor: float,
                         traversal=ops_fused.fused_traversal):
    """branches[e] is ordered by pmatrix index e. Returns (total logL,
    per-site weighted logL, root rows (clv_p, clv_c, sc_p, sc_c)).
    `traversal` is the fused traversal to run: the dispatching
    wrapper, or its plain version for a comparison on the card."""
    pmatrix = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, branches)
    rows = traversal(tip_codes, pmatrix, table, rates=pmatrix.shape[1],
                     states=pmatrix.shape[2], n_slots=n_slots,
                     threshold=scale_threshold, factor=scale_factor)
    clv_p, clv_c, sc_p, sc_c = rows
    total, per = ops_likelihood.edge_loglikelihood(
        clv_p, clv_c, sc_p, sc_c, pmatrix[root_mat], freqs, prop_invar,
        rate_weights, params_idx_rates, pattern_weights, invariant,
        scale_threshold)
    return total, per, rows


def _fused_newton_step(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                       rates, rate_weights, freqs, params_idx_rates,
                       branches, table, tip_codes, root_mat: int,
                       pattern_weights, invariant, n_slots: int,
                       scale_threshold: float, scale_factor: float,
                       traversal=ops_fused.fused_traversal):
    """Evaluate the tree, then Newton-update the root branch length from
    d1/d2 (reference examples/newton/newton.c:66-96, fused). Returns
    (total, d1, d2, new branches)."""
    total, _, rows = _fused_loglikelihood(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        rate_weights, freqs, params_idx_rates, branches, table, tip_codes,
        root_mat, pattern_weights, invariant, n_slots, scale_threshold,
        scale_factor, traversal=traversal)
    clv_p, clv_c, sc_p, sc_c = rows
    sumtable = ops_derivatives.update_sumtable(
        clv_p, clv_c, sc_p, sc_c, inv_eigenvecs, eigenvecs, freqs,
        params_idx_rates, scale_threshold, has_pscaler=True,
        has_cscaler=True)
    blen = branches[root_mat]
    d1, d2 = ops_derivatives.likelihood_derivatives(
        sumtable, eigenvals, prop_invar, freqs, rates, rate_weights,
        params_idx_rates, pattern_weights, invariant, blen,
        scale_threshold=scale_threshold)
    new_len = ops_derivatives.newton_step(blen, d1, d2,
                                          C.OPT_MIN_BRANCH_LEN,
                                          C.OPT_MAX_BRANCH_LEN)
    branches = branches.clone()
    branches[root_mat] = new_len
    return total, d1, d2, branches


class TreeEngine:
    """Full-tree evaluator bound to one Partition and one topology size.

    The host packs the traversal into a fused op table once per topology;
    `set_topology` repacks it after a move."""

    def __init__(self, partition: Partition, tree=None,
                 operations: Optional[Sequence[Operation]] = None,
                 branches: Optional[Sequence[float]] = None,
                 pmatrix_indices: Optional[Sequence[int]] = None,
                 root=None, params_index: int = 0,
                 edge_params=None, mxu: Optional[str] = None):
        if edge_params is not None:
            raise not_ported("per-edge rate matrices (edge_params "
                             "heterotachy)")
        if mxu is not None:
            raise not_ported("mxu= contraction modes")
        self.partition = partition
        self.device = partition.device
        self.dtype = partition.dtype
        self.params_index = params_index
        if tree is not None:
            operations, branches, pmatrix_indices = create_operations(
                traverse(tree.vroot))
            root = tree.vroot
        self.params_idx_rates = torch.full(
            (partition.rate_cats,), params_index, dtype=torch.long,
            device=self.device)
        self._model_cache_version = None
        self._tip_codes_version = None
        self._pack_topology(operations, branches, pmatrix_indices, root)
        partition._ensure_eigen([params_index])

    @property
    def execution_path(self) -> str:
        """The compute path: always the fused traversal in this port."""
        return "fused"

    def _model_args(self):
        """Model tensors on the partition's device, cached until a
        Partition setter bumps its _model_version."""
        p = self.partition
        if self._model_cache_version != p._model_version:
            p._ensure_eigen([self.params_index])
            self._model_cache = tuple(
                torch.tensor(a, dtype=self.dtype, device=self.device)
                for a in (p.eigenvals, p.inv_eigenvecs, p.eigenvecs,
                          p.prop_invar, p.rates, p.rate_weights,
                          p.frequencies)) + (self.params_idx_rates,)
            self._site_cache = (
                torch.tensor(p.pattern_weights, device=self.device),
                torch.tensor(p.invariant, dtype=torch.long,
                             device=self.device))
            self._model_cache_version = p._model_version
        return self._model_cache

    def _site_args(self):
        self._model_args()
        return self._site_cache

    def _tip_codes(self) -> torch.Tensor:
        """int32 tip bitmask codes [tips, sites_padded] on the device,
        cached until a tip setter bumps the partition's _tip_version."""
        p = self.partition
        if self._tip_codes_version != p._tip_version:
            if not p._tips_set.all():
                raise C.PllError(C.ERROR_PARAM_INVALID,
                                 "the fused traversal needs every tip set")
            self._tip_codes_cache = torch.as_tensor(
                ops_fused.tip_code_matrix(p), device=self.device)
            self._tip_codes_version = p._tip_version
        return self._tip_codes_cache

    def _pack_topology(self, operations, branches, pmatrix_indices,
                       root) -> None:
        """(Re)build the fused op table, the pmatrix-ordered branches and
        the root indices for one topology."""
        p = self.partition
        table, n_slots = ops_fused.pack_fused_schedule(
            operations, p.tips, (root.clv_index, root.back.clv_index))
        if table is None:
            raise not_ported("op lists the fused kernel cannot run (partial "
                             "traversals, ops without a scaler buffer: the "
                             "levels path)")
        mats = np.concatenate([table[:-1, 3], table[:-1, 6],
                               [root.pmatrix_index]])
        if mats.min(initial=0) < 0 or mats.max(initial=0) >= p.prob_matrices:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"matrix index out of range [0, "
                             f"{p.prob_matrices})")
        self.table = torch.as_tensor(table, device=self.device)
        self.fused_slots = n_slots
        blen = np.zeros(p.prob_matrices)
        blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
        self.branches = torch.as_tensor(blen, dtype=self.dtype,
                                        device=self.device)
        self.root_idx = (root.clv_index, root.scaler_index,
                         root.back.clv_index, root.back.scaler_index,
                         root.pmatrix_index)

    def set_topology(self, tree) -> None:
        """Rebind to a new topology of the same size: refreshes the op
        table, branches and root indices only."""
        operations, branches, pmatrix_indices = create_operations(
            traverse(tree.vroot))
        self._pack_topology(operations, branches, pmatrix_indices,
                            tree.vroot)

    def _args(self):
        pw, inv = self._site_args()
        return (*self._model_args(), self.branches, self.table,
                self._tip_codes(), self.root_idx[4], pw, inv,
                self.fused_slots, self.partition.scale_threshold,
                self.partition.scale_factor)

    def loglikelihood(self, branches=None) -> float:
        """Full-traversal logL. `branches`, if given, must be in
        PMATRIX-INDEX order (the engine's storage order)."""
        total, _ = self._loglikelihood_dev(branches)
        return float(total)

    def loglikelihood_persite(self, branches=None):
        """(total logL, per-site WEIGHTED logL [sites_padded] as numpy)."""
        total, per = self._loglikelihood_dev(branches)
        return float(total), per.cpu().numpy()

    def _loglikelihood_dev(self, branches=None):
        if branches is not None:
            branches = torch.as_tensor(branches, dtype=self.dtype,
                                       device=self.device)
            if branches.shape != (self.partition.prob_matrices,):
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"branches must have shape "
                    f"({self.partition.prob_matrices},), got "
                    f"{tuple(branches.shape)}")
            self.branches = branches
        total, per, _ = _fused_loglikelihood(*self._args())
        return total, per

    def newton_step(self):
        """Evaluate + one Newton update of the root branch; returns
        (logL, d1, d2)."""
        total, d1, d2, self.branches = _fused_newton_step(*self._args())
        return float(total), float(d1), float(d2)
