"""Full-tree evaluation, in PyTorch.

Port of libpll2_tpu/engine.py (`_fused_loglikelihood`, `_fused_newton_step`
and `TreeEngine`), without its mesh, site-repeats, per-rate-scaler and
per-edge-model parts:

    branches -> P-matrices -> CLVs -> root-edge logL
             (-> sumtable -> d1/d2 -> guarded Newton step on the root edge)

The CLV step takes one of four paths (`TreeEngine.execution_path`):
  'fused'         one launch for the whole postorder (ops/fused.py); only
                  the root edge's rows leave the kernel, and they are
                  written back into the partition's dense buffers (its inner
                  rows stay stale, by design);
  'levels-kernel' one launch of the level kernel per dependency level
                  (ops/levels.py), parent rows written in place into the
                  partition's CLV buffer;
  'levels'/'scan' plain PyTorch (ops/partials.py), batched per level or one
                  op at a time.
Everything else is plain tensor code on the partition's device, in its
dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import constants as C
from .ops import derivatives as ops_derivatives
from .ops import fused as ops_fused
from .ops import levels as ops_levels
from .ops import likelihood as ops_likelihood
from .ops import partials as ops_partials
from .ops import pmatrix as ops_pmatrix
from .partition import (Operation, Partition, not_ported,
                        pack_level_operations, pack_operations)
from .trees import create_operations, traverse

__all__ = ["TreeEngine"]

# TreeEngine(pallas=...): the JAX package's names; the 'interpret' variants
# ran the Pallas kernels in interpret mode on a CPU, which the port's
# wrappers do by themselves for CPU tensors
PALLAS_MODES = ("auto", True, "interpret", "levels-kernel",
                "levels-interpret", False)


def _scatter_root_rows(clv, scaler, root_idx, rows) -> None:
    """Write the fused traversal's root-edge rows into the partition's
    buffers, in place (the API contract for step-by-step consumers of the
    root edge). A missing scaler goes to the trash row."""
    p_clv, p_sc, c_clv, c_sc, _ = root_idx
    clv_p, clv_c, sc_p, sc_c = rows
    trash = scaler.shape[0] - 2
    clv[p_clv] = clv_p
    clv[c_clv] = clv_c
    scaler[p_sc if p_sc >= 0 else trash] = sc_p
    scaler[c_sc if c_sc >= 0 else trash] = sc_c


def _root_newton(rows, branches, root_mat: int, eigenvals, inv_eigenvecs,
                 eigenvecs, prop_invar, rates, rate_weights, freqs,
                 params_idx_rates, pattern_weights, invariant,
                 scale_threshold: float):
    """Sumtable and d1/d2 of the root edge's rows, then a guarded Newton
    update of its length (reference examples/newton/newton.c:66-96).
    Returns (d1, d2, new branches)."""
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
    return d1, d2, branches


def _fused_loglikelihood(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, rate_weights, freqs, params_idx_rates,
                         branches, table, tip_codes, root_mat: int,
                         pattern_weights, invariant, n_slots: int,
                         scale_threshold: float, scale_factor: float,
                         traversal=ops_fused.fused_traversal,
                         mxu: str = "split"):
    """The fused path. branches[e] is ordered by pmatrix index e. Returns
    (total logL, per-site weighted logL, root rows (clv_p, clv_c, sc_p,
    sc_c), P-matrices). `traversal` is the fused traversal to run: the
    dispatching wrapper, or its plain version for a comparison on the card;
    `mxu` its contraction mode (ops/fused.py)."""
    pmatrix = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, branches)
    rows = traversal(tip_codes, pmatrix, table, rates=pmatrix.shape[1],
                     states=pmatrix.shape[2], n_slots=n_slots,
                     threshold=scale_threshold, factor=scale_factor, mxu=mxu)
    clv_p, clv_c, sc_p, sc_c = rows
    total, per = ops_likelihood.edge_loglikelihood(
        clv_p, clv_c, sc_p, sc_c, pmatrix[root_mat], freqs, prop_invar,
        rate_weights, params_idx_rates, pattern_weights, invariant,
        scale_threshold)
    return total, per, rows, pmatrix


def _fused_newton_step(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                       rates, rate_weights, freqs, params_idx_rates,
                       branches, table, tip_codes, root_mat: int,
                       pattern_weights, invariant, n_slots: int,
                       scale_threshold: float, scale_factor: float,
                       traversal=ops_fused.fused_traversal,
                       mxu: str = "split"):
    """Evaluate the tree on the fused path, then Newton-update the root
    branch length from d1/d2. Returns (total, d1, d2, new branches, root
    rows, P-matrices)."""
    total, _, rows, pmatrix = _fused_loglikelihood(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        rate_weights, freqs, params_idx_rates, branches, table, tip_codes,
        root_mat, pattern_weights, invariant, n_slots, scale_threshold,
        scale_factor, traversal=traversal, mxu=mxu)
    d1, d2, branches = _root_newton(
        rows, branches, root_mat, eigenvals, inv_eigenvecs, eigenvecs,
        prop_invar, rates, rate_weights, freqs, params_idx_rates,
        pattern_weights, invariant, scale_threshold)
    return total, d1, d2, branches, rows, pmatrix


def _dense_loglikelihood(clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                         prop_invar, rates, rate_weights, freqs,
                         params_idx_rates, branches, path: str, plan,
                         root_idx, pattern_weights, invariant,
                         scale_threshold: float, scale_factor: float,
                         level=ops_levels.level_update):
    """A path over the dense buffers `clv` [N+1, R, s, S] and `scaler`
    [K+2, S], which it updates in place. `path` and `plan`:
    'levels-kernel' with the level tables on the device (each level run by
    `level`: the dispatching wrapper, or its plain version for a comparison
    on the card), 'levels' with (Operations [L, W], valid), 'scan' with
    Operations [n]. Returns (total logL, per-site weighted logL, P-matrices,
    root rows)."""
    pmatrix = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, branches)
    if path == "levels-kernel":
        ops_levels.update_partials_kernel(clv, scaler, pmatrix, plan,
                                          scale_threshold, scale_factor,
                                          level=level)
    elif path == "levels":
        ops_partials.update_partials_levels(clv, scaler, pmatrix, *plan,
                                            scale_threshold, scale_factor)
    else:
        ops_partials.update_partials(clv, scaler, pmatrix, plan,
                                     scale_threshold, scale_factor)
    p_clv, p_sc, c_clv, c_sc, mat = root_idx
    # a missing scaler (-1) reads the last row, which stays zero
    rows = (clv[p_clv], clv[c_clv], scaler[p_sc], scaler[c_sc])
    total, per = ops_likelihood.edge_loglikelihood(
        rows[0], rows[1], rows[2], rows[3], pmatrix[mat], freqs, prop_invar,
        rate_weights, params_idx_rates, pattern_weights, invariant,
        scale_threshold)
    return total, per, pmatrix, rows


def _dense_newton_step(clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                       prop_invar, rates, rate_weights, freqs,
                       params_idx_rates, branches, path: str, plan,
                       root_idx, pattern_weights, invariant,
                       scale_threshold: float, scale_factor: float,
                       level=ops_levels.level_update):
    """`_dense_loglikelihood`, then the root edge's Newton step. Returns
    (total, d1, d2, new branches, P-matrices)."""
    total, _, pmatrix, rows = _dense_loglikelihood(
        clv, scaler, eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        rate_weights, freqs, params_idx_rates, branches, path, plan,
        root_idx, pattern_weights, invariant, scale_threshold, scale_factor,
        level=level)
    d1, d2, branches = _root_newton(
        rows, branches, root_idx[4], eigenvals, inv_eigenvecs, eigenvecs,
        prop_invar, rates, rate_weights, freqs, params_idx_rates,
        pattern_weights, invariant, scale_threshold)
    return total, d1, d2, branches, pmatrix


class TreeEngine:
    """Full-tree evaluator bound to one Partition and one topology size.

    The host packs the traversal once per topology for the selected path;
    `set_topology` repacks it after a move."""

    def __init__(self, partition: Partition, tree=None,
                 operations: Optional[Sequence[Operation]] = None,
                 branches: Optional[Sequence[float]] = None,
                 pmatrix_indices: Optional[Sequence[int]] = None,
                 root=None, params_index: int = 0,
                 level_schedule: bool = True, pallas="auto",
                 edge_params=None, mxu: str = "split"):
        """`pallas` selects the CLV path, under libpll2_tpu's names:
          'auto', True, 'interpret' -- the fused whole-traversal kernel
              when every tip is set and the op list is a postorder whose
              ops all have scaler buffers (`pack_fused_schedule`); else the
              per-level kernel;
          'levels-kernel', 'levels-interpret' -- the per-level kernel;
          False -- plain PyTorch, level by level with `level_schedule`,
              else one op at a time;
          'pool', 'pool-interpret' -- site repeats' pooled path: not
              ported.
        The kernels' wrappers run their plain versions for CPU tensors, so
        the 'interpret' names equal the others. `mxu` picks the fused
        traversal's contraction mode for 16+-state alphabets: 'split'
        (default) and 'highest' run exact float32, 'bf16' rounds the
        operands to bf16 (ops/fused.py)."""
        if edge_params is not None:
            raise not_ported("per-edge rate matrices (edge_params "
                             "heterotachy)")
        if mxu not in ops_fused.MXU_MODES:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"mxu must be 'split', 'bf16' or 'highest', "
                             f"got {mxu!r}")
        if pallas in ("pool", "pool-interpret"):
            raise not_ported(f"the pooled compute path of site repeats "
                             f"(pallas={pallas!r})")
        if not (isinstance(pallas, bool) or (isinstance(pallas, str)
                                             and pallas in PALLAS_MODES)):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"pallas must be one of {PALLAS_MODES}, "
                             f"'pool' or 'pool-interpret', got {pallas!r}")
        self.mxu = mxu
        self.partition = partition
        self.device = partition.device
        self.dtype = partition.dtype
        self.params_index = params_index
        self.levels = level_schedule
        want_fused = pallas in ("auto", True, "interpret")
        self._fused_wanted = want_fused and bool(partition._tips_set.all())
        self._levelk_wanted = want_fused or pallas in ("levels-kernel",
                                                       "levels-interpret")
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
    def use_pallas(self) -> bool:
        """True when a kernel path (fused or per-level) is active."""
        return self.use_fused or self.use_levelkernel

    @property
    def execution_path(self) -> str:
        """The compute path this engine selected: 'fused',
        'levels-kernel', 'levels' or 'scan'."""
        if self.use_fused:
            return "fused"
        if self.use_levelkernel:
            return "levels-kernel"
        return "levels" if self.levels else "scan"

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
        """(Re)build the selected path's op tables, the pmatrix-ordered
        branches and the root indices for one topology."""
        p = self.partition
        operations = list(operations)
        p._check_operations(operations)
        if not 0 <= root.pmatrix_index < p.prob_matrices:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"root matrix index {root.pmatrix_index} out "
                             f"of range [0, {p.prob_matrices})")
        self.use_fused = self.use_levelkernel = False
        self.table, self.fused_slots, self._ops = None, 0, None
        if self._fused_wanted:
            table, n_slots = ops_fused.pack_fused_schedule(
                operations, p.tips, (root.clv_index, root.back.clv_index))
            if table is not None:
                self.use_fused = True
                self.table = torch.as_tensor(table, device=self.device)
                self.fused_slots = n_slots
        if not self.use_fused and self._levelk_wanted:
            self.use_levelkernel = True
            self._ops = ops_levels.tables_to_device(
                ops_levels.pack_pallas_levels(
                    operations, p.tips, zero_scaler_row=p.scale_buffers + 1,
                    trash_scaler_row=p.scale_buffers), self.device)
        elif not self.use_fused and self.levels:
            self._ops = pack_level_operations(operations, p.tips,
                                              scratch_clv=p.nodes,
                                              device=self.device)
        elif not self.use_fused:
            self._ops = pack_operations(operations, device=self.device)
        blen = np.zeros(p.prob_matrices)
        blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
        self.branches = torch.as_tensor(blen, dtype=self.dtype,
                                        device=self.device)
        self.root_idx = (root.clv_index, root.scaler_index,
                         root.back.clv_index, root.back.scaler_index,
                         root.pmatrix_index)

    def set_topology(self, tree) -> None:
        """Rebind to a new topology of the same size: refreshes the op
        tables, branches and root indices only."""
        operations, branches, pmatrix_indices = create_operations(
            traverse(tree.vroot))
        self._pack_topology(operations, branches, pmatrix_indices,
                            tree.vroot)

    def _args(self):
        """The fused path's arguments."""
        pw, inv = self._site_args()
        return (*self._model_args(), self.branches, self.table,
                self._tip_codes(), self.root_idx[4], pw, inv,
                self.fused_slots, self.partition.scale_threshold,
                self.partition.scale_factor)

    def _dense_args(self):
        """The dense paths' arguments after (clv, scaler)."""
        pw, inv = self._site_args()
        return (*self._model_args(), self.branches, self.execution_path,
                self._ops, self.root_idx, pw, inv,
                self.partition.scale_threshold, self.partition.scale_factor)

    def _set_branches(self, branches) -> None:
        branches = torch.as_tensor(branches, dtype=self.dtype,
                                   device=self.device)
        if branches.shape != (self.partition.prob_matrices,):
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"branches must have shape "
                f"({self.partition.prob_matrices},), got "
                f"{tuple(branches.shape)}")
        self.branches = branches

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
        """Full evaluation without a host sync: (total, per-site) as
        tensors. The partition's P-matrices and the CLV and scaler rows the
        path computes (all of them, or the root edge's on the fused path)
        are updated."""
        if branches is not None:
            self._set_branches(branches)
        p = self.partition
        if self.use_fused:
            total, per, rows, p.pmatrix = _fused_loglikelihood(
                *self._args(), mxu=self.mxu)
            _scatter_root_rows(p.clv, p.scale_buffer, self.root_idx, rows)
        else:
            total, per, p.pmatrix, _ = _dense_loglikelihood(
                p.clv, p.scale_buffer, *self._dense_args())
        return total, per

    def newton_step(self):
        """Evaluate + one Newton update of the root branch; returns
        (logL, d1, d2)."""
        p = self.partition
        if self.use_fused:
            total, d1, d2, self.branches, rows, p.pmatrix = \
                _fused_newton_step(*self._args(), mxu=self.mxu)
            _scatter_root_rows(p.clv, p.scale_buffer, self.root_idx, rows)
        else:
            total, d1, d2, self.branches, p.pmatrix = _dense_newton_step(
                p.clv, p.scale_buffer, *self._dense_args())
        return float(total), float(d1), float(d2)

    def site_rate_posteriors(self):
        """Empirical-Bayes per-site rate-category posteriors and
        posterior-mean site rates across the root edge. Returns (posteriors
        [R+1, sites_padded], site_rates [sites_padded]) as numpy arrays;
        the last category is the +I invariant class (all-zero when pinv =
        0)."""
        p = self.partition
        (eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
         rate_weights, freqs, pidx) = self._model_args()
        self.loglikelihood()       # refresh the root rows
        p_clv, p_sc, c_clv, c_sc, mat = self.root_idx
        # a missing scaler (-1) reads the last row, which stays zero
        post, site_rate = ops_likelihood.rate_posteriors(
            p.clv[p_clv], p.clv[c_clv], p.scale_buffer[p_sc],
            p.scale_buffer[c_sc], p.pmatrix[mat], freqs, prop_invar, rates,
            rate_weights, pidx, self._site_args()[1],
            scale_threshold=p.scale_threshold)
        return post.cpu().numpy(), site_rate.cpu().numpy()

    def apply_branches_to_tree(self, tree) -> None:
        """Write the engine's (possibly optimized) branch lengths back onto
        the tree's half-edges, keyed by pmatrix index."""
        blen = self.branches.cpu().numpy().astype(np.float64)
        seen = set()
        for node in tree.nodes():
            halves = [node] if node.is_tip() else list(node.ring())
            for h in halves:
                if h.back is not None and id(h) not in seen:
                    seen.add(id(h))
                    seen.add(id(h.back))
                    h.length = h.back.length = float(blen[h.pmatrix_index])
