"""Full-tree evaluation, in PyTorch.

Port of libpll2_tpu/engine.py (`_fused_loglikelihood`, `_fused_newton_step`,
`_repeats_loglikelihood`, a single repeats Newton step and `TreeEngine`,
with per-rate scalers, raw tip CLVs and ascertainment-bias corrections),
without its mesh, candidate-scoring and k-chained loop parts:

    branches -> P-matrices -> CLVs -> root-edge logL
             (-> sumtable -> d1/d2 -> guarded Newton step on the root edge)

The CLV step takes one of seven paths (`TreeEngine.execution_path`):
  'fused'         one launch for the whole postorder (ops/fused.py); only
                  the root edge's rows leave the kernel, and they are
                  written back into the partition's dense buffers (its inner
                  rows stay stale, by design);
  'repeats-dense-fused'  the same kernel for a site-repeats partition: it
                  never reads class columns, and nothing is written back
                  (the pooled partition has no dense rows);
  'levels-kernel' one launch of the level kernel per dependency level
                  (ops/levels.py), parent rows written in place into the
                  partition's CLV buffer;
  'pool-pallas'   site repeats' pooled class columns, one launch of the pool
                  kernel per dependency level (ops/pool.py);
  'pool'          the same pooled levels through the pool kernel's plain
                  version (ops/pool.py:pool_update_reference);
  'levels'/'scan' plain PyTorch (ops/partials.py), batched per level or one
                  op at a time.
Everything else is plain tensor code on the partition's device, in its
dtype. A partition's per-rate scalers, raw tips and asc correction ride
every path (`Partition._modes`, and the raw tip rows on the fused path).
With `edge_params` (per-branch heterotachy) every path builds its
P-matrices per edge (ops/pmatrix.py:update_prob_matrices_per_edge), and the
root edge's rate matrix drives the likelihood and derivatives.
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
from .ops import pool as ops_pool
from .partition import (Operation, Partition, pack_level_operations,
                        pack_operations)
from .trees import create_operations, traverse

__all__ = ["TreeEngine", "pack_repeats"]

# TreeEngine(pallas=...): the JAX package's names; the 'interpret' variants
# ran the Pallas kernels in interpret mode on a CPU, which the port's
# wrappers do by themselves for CPU tensors
PALLAS_MODES = ("auto", True, "interpret", "levels-kernel",
                "levels-interpret", "pool", "pool-interpret", False)


def _pmatrices(eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
               params_idx_rates, branches, edge_params=None):
    """P [E, R, s, s]: one rate matrix per category for every edge, or per
    edge and category with `edge_params` [E, R]."""
    if edge_params is not None:
        return ops_pmatrix.update_prob_matrices_per_edge(
            eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
            edge_params, branches)
    return ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, branches)


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
                 scale_threshold: float, rate_scalers: bool = False,
                 asc_type: int = C.AB_NONE, n_real: int = -1):
    """Sumtable and d1/d2 of the root edge's rows, then a guarded Newton
    update of its length (reference examples/newton/newton.c:66-96). The
    Lewis and Felsenstein corrections undo the synthetic columns' scaling
    with the rows' counts (libpll2_tpu/engine.py:281-290). Returns (d1, d2,
    new branches)."""
    clv_p, clv_c, sc_p, sc_c = rows
    sumtable = ops_derivatives.update_sumtable(
        clv_p, clv_c, sc_p, sc_c, inv_eigenvecs, eigenvecs, freqs,
        params_idx_rates, scale_threshold, rate_scalers=rate_scalers,
        has_pscaler=True, has_cscaler=True)
    blen = branches[root_mat]
    asc_scalers = None
    if asc_type in (C.AB_LEWIS, C.AB_FELSENSTEIN):
        asc_scalers = sc_p + sc_c
    d1, d2 = ops_derivatives.likelihood_derivatives(
        sumtable, eigenvals, prop_invar, freqs, rates, rate_weights,
        params_idx_rates, pattern_weights, invariant, blen,
        asc_scalers=asc_scalers, scale_threshold=scale_threshold,
        asc_type=asc_type, n_real=n_real)
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
                         mxu: str = "split", edge_params=None,
                         rate_scalers: bool = False, tip_clvs=None,
                         asc_type: int = C.AB_NONE, n_real: int = -1):
    """The fused path. branches[e] is ordered by pmatrix index e. Returns
    (total logL, per-site weighted logL, root rows (clv_p, clv_c, sc_p,
    sc_c), P-matrices). `traversal` is the fused traversal to run: the
    dispatching wrapper, or its plain version for a comparison on the card;
    `mxu` its contraction mode, `rate_scalers` and `tip_clvs` (the raw tip
    rows) its modes (ops/fused.py); `asc_type` and `n_real` the
    likelihood's asc correction."""
    pmatrix = _pmatrices(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, params_idx_rates, branches, edge_params)
    rows = traversal(tip_codes, pmatrix, table, rates=pmatrix.shape[1],
                     states=pmatrix.shape[2], n_slots=n_slots,
                     threshold=scale_threshold, factor=scale_factor, mxu=mxu,
                     rate_scalers=rate_scalers, tip_clvs=tip_clvs)
    clv_p, clv_c, sc_p, sc_c = rows
    total, per = ops_likelihood.edge_loglikelihood(
        clv_p, clv_c, sc_p, sc_c, pmatrix[root_mat], freqs, prop_invar,
        rate_weights, params_idx_rates, pattern_weights, invariant,
        scale_threshold, rate_scalers=rate_scalers, asc_type=asc_type,
        n_real=n_real)
    return total, per, rows, pmatrix


def _fused_newton_step(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                       rates, rate_weights, freqs, params_idx_rates,
                       branches, table, tip_codes, root_mat: int,
                       pattern_weights, invariant, n_slots: int,
                       scale_threshold: float, scale_factor: float,
                       traversal=ops_fused.fused_traversal,
                       mxu: str = "split", edge_params=None,
                       rate_scalers: bool = False, tip_clvs=None,
                       asc_type: int = C.AB_NONE, n_real: int = -1):
    """Evaluate the tree on the fused path, then Newton-update the root
    branch length from d1/d2. Returns (total, d1, d2, new branches, root
    rows, P-matrices)."""
    total, _, rows, pmatrix = _fused_loglikelihood(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        rate_weights, freqs, params_idx_rates, branches, table, tip_codes,
        root_mat, pattern_weights, invariant, n_slots, scale_threshold,
        scale_factor, traversal=traversal, mxu=mxu, edge_params=edge_params,
        rate_scalers=rate_scalers, tip_clvs=tip_clvs, asc_type=asc_type,
        n_real=n_real)
    d1, d2, branches = _root_newton(
        rows, branches, root_mat, eigenvals, inv_eigenvecs, eigenvecs,
        prop_invar, rates, rate_weights, freqs, params_idx_rates,
        pattern_weights, invariant, scale_threshold,
        rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real)
    return total, d1, d2, branches, rows, pmatrix


def _dense_loglikelihood(clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                         prop_invar, rates, rate_weights, freqs,
                         params_idx_rates, branches, path: str, plan,
                         root_idx, pattern_weights, invariant,
                         scale_threshold: float, scale_factor: float,
                         level=ops_levels.level_update, edge_params=None,
                         rate_scalers: bool = False,
                         asc_type: int = C.AB_NONE, n_real: int = -1):
    """A path over the dense buffers `clv` [N+1, R, s, S] and `scaler`
    [K+2, S] ([K+2, R, S] with `rate_scalers`), which it updates in
    place. `path` and `plan`:
    'levels-kernel' with the level tables on the device (each level run by
    `level`: the dispatching wrapper, or its plain version for a comparison
    on the card), 'levels' with (Operations [L, W], valid), 'scan' with
    Operations [n]. Returns (total logL, per-site weighted logL, P-matrices,
    root rows)."""
    pmatrix = _pmatrices(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, params_idx_rates, branches, edge_params)
    if path == "levels-kernel":
        ops_levels.update_partials_kernel(clv, scaler, pmatrix, plan,
                                          scale_threshold, scale_factor,
                                          level=level)
    elif path == "levels":
        ops_partials.update_partials_levels(clv, scaler, pmatrix, *plan,
                                            scale_threshold, scale_factor,
                                            rate_scalers=rate_scalers)
    else:
        ops_partials.update_partials(clv, scaler, pmatrix, plan,
                                     scale_threshold, scale_factor,
                                     rate_scalers=rate_scalers)
    p_clv, p_sc, c_clv, c_sc, mat = root_idx
    # a missing scaler (-1) reads the last row, which stays zero
    rows = (clv[p_clv], clv[c_clv], scaler[p_sc], scaler[c_sc])
    total, per = ops_likelihood.edge_loglikelihood(
        rows[0], rows[1], rows[2], rows[3], pmatrix[mat], freqs, prop_invar,
        rate_weights, params_idx_rates, pattern_weights, invariant,
        scale_threshold, rate_scalers=rate_scalers, asc_type=asc_type,
        n_real=n_real)
    return total, per, pmatrix, rows


def _repeats_loglikelihood(clv_flat, sc_flat, eigenvals, inv_eigenvecs,
                           eigenvecs, prop_invar, rates, rate_weights, freqs,
                           params_idx_rates, branches, path: str, plan,
                           root_cols, root_mat: int, pattern_weights,
                           invariant, scale_threshold: float,
                           scale_factor: float, level=ops_pool.pool_update,
                           edge_params=None, rate_scalers: bool = False,
                           asc_type: int = C.AB_NONE, n_real: int = -1):
    """A path over a repeats partition's pooled buffers `clv_flat` [R, s,
    T] and `sc_flat` [T2] ([R, T2] with `rate_scalers`), which it updates
    in place. `plan` is a PoolPlan;
    `path` 'pool-pallas' runs each level through `level` (the dispatching
    wrapper, or its plain version for a comparison on the card), 'pool'
    through the plain version. `root_cols` holds the root edge's absolute
    per-site columns (clv and scaler, parent then child). Returns (total
    logL, per-site weighted logL, P-matrices, root rows)."""
    pmatrix = _pmatrices(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, params_idx_rates, branches, edge_params)
    if path == "pool":
        level = ops_pool.pool_update_reference
    ops_pool.update_partials_pool(clv_flat, sc_flat, pmatrix, plan,
                                  scale_threshold, scale_factor, level=level)
    p_cols, p_sc_cols, c_cols, c_sc_cols = root_cols
    rows = (clv_flat[:, :, p_cols], clv_flat[:, :, c_cols],
            sc_flat[..., p_sc_cols], sc_flat[..., c_sc_cols])
    total, per = ops_likelihood.edge_loglikelihood(
        *rows, pmatrix[root_mat], freqs, prop_invar, rate_weights,
        params_idx_rates, pattern_weights, invariant, scale_threshold,
        rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real)
    return total, per, pmatrix, rows


def pack_repeats(partition, operations, root_indices):
    """The pooled schedule of one topology (libpll2_tpu's
    `pack_repeats_canonical` without its power-of-two padding and merged
    runs, which bounded XLA recompiles): classes the op list and installs
    its layout on `partition` (carrying the pools over), through the
    partition's own cached plan (`Partition._pool_plan`, which its
    step-by-step API shares), and returns (PoolPlan, root_cols, root matrix
    index, layout). root_cols are the root edge's absolute per-site columns
    (parent clv, parent scaler, child clv, child scaler) on the partition's
    device."""
    p = partition
    dev = p.device
    plan = p._pool_plan(operations, True)
    layout = p._flat

    def cols(node, sc_idx):
        sid = p.repeats.site_id[node].astype(np.int64)
        has = sc_idx >= 0 and layout.sc_caps[sc_idx] > 0
        base = layout.sc_off[sc_idx] if has else layout.sc_zero
        return layout.off[node] + sid, base + sid

    p_clv, p_sc, c_clv, c_sc, mat = root_indices
    root_cols = tuple(torch.as_tensor(a, device=dev)
                      for a in cols(p_clv, p_sc) + cols(c_clv, c_sc))
    return plan, root_cols, mat, layout


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
              when every tip is set (from state codes or set_tip_clv), the
              op list is a postorder whose ops all have scaler buffers
              (`pack_fused_schedule`) and, with per-rate scalers on a 16+
              state alphabet, at most 8 rate categories (as in JAX); else
              the per-level kernel, or on a site-repeats partition the pool
              kernel ('repeats-dense-fused' runs the fused kernel over a
              repeats partition, which keeps its pooled storage);
          'levels-kernel', 'levels-interpret' -- the per-level kernel (on a
              repeats partition: the plain pooled path);
          'pool', 'pool-interpret' -- on a repeats partition the pool
              kernel; on a dense one the plain paths below;
          False -- plain PyTorch, level by level with `level_schedule`,
              else one op at a time; the plain pooled path on a repeats
              partition.
        The kernels' wrappers run their plain versions for CPU tensors, so
        the 'interpret' names equal the others. `mxu` picks the fused
        traversal's contraction mode for 16+-state alphabets: 'split'
        (default) and 'highest' run exact float32, 'bf16' rounds the
        operands to bf16 (ops/fused.py). `edge_params` [prob_matrices]
        gives the rate-matrix index of every P-matrix slot (per-branch
        heterotachy).

        Where libpll2_tpu falls back to XLA only because its level or pool
        kernel has no per-rate scaler mode, the port's kernels run theirs:
        'levels-kernel' where JAX says 'levels', 'pool-pallas' where it says
        'pool'."""
        if mxu not in ops_fused.MXU_MODES:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"mxu must be 'split', 'bf16' or 'highest', "
                             f"got {mxu!r}")
        if not (isinstance(pallas, bool) or (isinstance(pallas, str)
                                             and pallas in PALLAS_MODES)):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"pallas must be one of {PALLAS_MODES}, got "
                             f"{pallas!r}")
        p = partition
        self.mxu = mxu
        self.partition = p
        self.device = p.device
        self.dtype = p.dtype
        self.params_index = params_index
        self.levels = level_schedule
        want_fused = pallas in ("auto", True, "interpret")
        want_pool = pallas in ("pool", "pool-interpret")
        # every tip set, from state codes or raw probabilities (is_tip 2
        # rows of the op table); the rows route keeps JAX's 8-category
        # bound on per-rate scalers (libpll2_tpu/engine.py:835-839; the
        # small-alphabet kernel takes any count)
        fused_ok = bool(np.all(p._tips_set | p._tips_clv_set)) and (
            not p.rate_scalers or p.states < ops_fused.ROWS_STATES_MIN
            or p.rate_cats <= ops_fused.ROWS_RATE_SCALERS_MAX)
        self.repeats_mode = p.repeats is not None
        # the fused kernel over a repeats partition: it reads only tip codes
        # and writes nothing back, so the pooled storage stays as it is
        self.repeats_dense_fused = self.repeats_mode and want_fused \
            and fused_ok
        if self.repeats_dense_fused:
            self.repeats_mode = False
        self._fused_wanted = want_fused and fused_ok
        self._levelk_wanted = p.repeats is None and (
            want_fused or pallas in ("levels-kernel", "levels-interpret"))
        self._pool_kernel_wanted = p.repeats is not None and (
            want_fused or want_pool)
        self._edge_params_host = None
        self.edge_params = None
        if edge_params is not None:
            ep = np.asarray(edge_params, dtype=np.int64)
            if ep.shape != (p.prob_matrices,):
                raise C.PllError(C.ERROR_PARAM_INVALID,
                                 f"edge_params must have shape "
                                 f"({p.prob_matrices},), got {ep.shape}")
            p._index(ep, "edge_params rate-matrix index", p.rate_matrices)
            self._edge_params_host = ep
            self.edge_params = torch.as_tensor(
                np.repeat(ep[:, None], p.rate_cats, axis=1),
                device=self.device)
            p._ensure_eigen(np.unique(ep))
        if tree is not None:
            operations, branches, pmatrix_indices = create_operations(
                traverse(tree.vroot))
            root = tree.vroot
        self._model_cache_version = None
        self._tip_codes_version = None
        self._packed_ctips = frozenset()
        self._pack_topology(operations, branches, pmatrix_indices, root)
        p._ensure_eigen([params_index])

    @property
    def use_pallas(self) -> bool:
        """True when the fused or the per-level kernel path is active (as in
        libpll2_tpu; the pool kernel is `use_pool_kernel`)."""
        return self.use_fused or self.use_levelkernel

    @property
    def use_pool_kernel(self) -> bool:
        """True on the 'pool-pallas' path."""
        return self.repeats_mode and self._pool_kernel_wanted

    @property
    def execution_path(self) -> str:
        """The compute path this engine selected: 'repeats-dense-fused',
        'fused', 'levels-kernel', 'pool-pallas', 'pool', 'levels' or
        'scan'."""
        if self.repeats_dense_fused:
            return "repeats-dense-fused"
        if self.use_fused:
            return "fused"
        if self.use_levelkernel:
            return "levels-kernel"
        if self.repeats_mode:
            return "pool-pallas" if self.use_pool_kernel else "pool"
        return "levels" if self.levels else "scan"

    def _model_args(self):
        """Model tensors on the partition's device, cached until a
        Partition setter bumps its _model_version (or a repack changes the
        root edge's rate matrix)."""
        p = self.partition
        if self._model_cache_version != p._model_version:
            p._ensure_eigen([self.params_index])
            if self._edge_params_host is not None:
                p._ensure_eigen(np.unique(self._edge_params_host))
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

    def _refresh_tips(self) -> None:
        """The fused path's tip operands on the device, rebuilt when a tip
        setter bumped the partition's _tip_version: int32 bitmask codes
        [tips, sites_padded] and the raw tip rows (or None). Raises when
        the set of raw tips changed since the op table was packed (it
        encodes which tips are raw rows)."""
        p = self.partition
        if self._tip_codes_version == p._tip_version:
            return
        if not np.all(p._tips_set | p._tips_clv_set):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "the fused traversal needs every tip set")
        if frozenset(np.flatnonzero(p._tips_clv_set).tolist()) \
                != self._packed_ctips:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "the set of raw-probability tips (set_tip_clv) changed "
                "after this fused-kernel engine packed its schedule; "
                "rebuild the TreeEngine (or call set_topology) so that the "
                "op table says again which tips are raw rows")
        self._tip_codes_cache = torch.as_tensor(
            ops_fused.tip_code_matrix(p), device=self.device)
        self._tip_clvs_cache = ops_fused.tip_clv_matrix(p)
        self._tip_codes_version = p._tip_version

    def _tip_codes(self) -> torch.Tensor:
        """int32 tip bitmask codes [tips, sites_padded] on the device."""
        self._refresh_tips()
        return self._tip_codes_cache

    def _tip_clvs(self):
        """The raw tip rows [n_ctips, states, sites_padded] of the tips set
        with set_tip_clv, or None."""
        self._refresh_tips()
        return self._tip_clvs_cache

    def _fused_kw(self) -> dict:
        """The fused path's keyword arguments: modes and raw tip rows."""
        return dict(self.partition._modes(), tip_clvs=self._tip_clvs())

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
        blen = np.zeros(p.prob_matrices)
        blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
        self.branches = torch.as_tensor(blen, dtype=self.dtype,
                                        device=self.device)
        self.root_idx = (root.clv_index, root.scaler_index,
                         root.back.clv_index, root.back.scaler_index,
                         root.pmatrix_index)
        # the root edge's rate matrix drives the likelihood and derivatives
        rm = self.params_index if self._edge_params_host is None else \
            int(self._edge_params_host[root.pmatrix_index])
        self.params_idx_rates = torch.full(
            (p.rate_cats,), rm, dtype=torch.long, device=self.device)
        self._model_cache_version = None
        if self.repeats_mode:
            self._pack_repeats(operations)
            return
        if self._fused_wanted:
            table, n_slots = ops_fused.pack_fused_schedule(
                operations, p.tips, (root.clv_index, root.back.clv_index),
                clv_tip_rows=ops_fused.ctip_rows(p))
            if table is not None:
                self.use_fused = True
                self.table = torch.as_tensor(table, device=self.device)
                self.fused_slots = n_slots
                self._packed_ctips = frozenset(
                    np.flatnonzero(p._tips_clv_set).tolist())
                self._tip_codes_version = None
            elif self.repeats_dense_fused:
                # an op list the kernel cannot run (a partial traversal, a
                # missing scaler): a pooled partition has no dense buffers
                # to fall back on, so the pooled path takes it
                self.repeats_dense_fused = False
                self.repeats_mode = True
                self._pack_repeats(operations)
                return
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

    def _pack_repeats(self, operations) -> None:
        """The pooled path's plan for `operations` (`pack_repeats`), its
        layout installed on the partition."""
        p = self.partition
        self._repeat_ops = operations
        self._ops, self._root_cols, _, self._layout = pack_repeats(
            p, operations, self.root_idx)
        self._packed_tips = p._tip_version

    def _repeats_args(self):
        """The pooled paths' arguments, after repacking the class schedule
        when the tips or the partition's pooled layout changed since it was
        packed (a tip setter, or the step-by-step API on another op
        list)."""
        p = self.partition
        if p._flat is not self._layout or p._tip_version != self._packed_tips:
            self._pack_repeats(self._repeat_ops)
        pw, inv = self._site_args()
        return (p.clv_flat, p.sc_flat, *self._model_args(), self.branches,
                self.execution_path, self._ops, self._root_cols,
                self.root_idx[4], pw, inv, p.scale_threshold,
                p.scale_factor)

    def set_topology(self, tree) -> None:
        """Rebind to a new topology of the same size: refreshes the op
        tables (on a repeats partition also its classes and pooled layout),
        branches and root indices only."""
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
        tensors."""
        total, per, _ = self._evaluate(branches)
        return total, per

    def _evaluate(self, branches=None):
        """One full evaluation: (total, per-site, root rows). The
        partition's P-matrices and the CLV and scaler rows the path computes
        (all of them; the root edge's on the fused path; none on
        'repeats-dense-fused') are updated."""
        if branches is not None:
            self._set_branches(branches)
        p = self.partition
        if self.use_fused:
            total, per, rows, p.pmatrix = _fused_loglikelihood(
                *self._args(), mxu=self.mxu, edge_params=self.edge_params,
                **self._fused_kw())
            if not self.repeats_dense_fused:
                _scatter_root_rows(p.clv, p.scale_buffer, self.root_idx,
                                   rows)
        elif self.repeats_mode:
            total, per, p.pmatrix, rows = _repeats_loglikelihood(
                *self._repeats_args(), edge_params=self.edge_params,
                **p._modes())
        else:
            total, per, p.pmatrix, rows = _dense_loglikelihood(
                p.clv, p.scale_buffer, *self._dense_args(),
                edge_params=self.edge_params, **p._modes())
        return total, per, rows

    def newton_step(self):
        """Evaluate + one Newton update of the root branch; returns
        (logL, d1, d2)."""
        p = self.partition
        if self.use_fused:
            total, d1, d2, self.branches, rows, p.pmatrix = \
                _fused_newton_step(*self._args(), mxu=self.mxu,
                                   edge_params=self.edge_params,
                                   **self._fused_kw())
            if not self.repeats_dense_fused:
                _scatter_root_rows(p.clv, p.scale_buffer, self.root_idx,
                                   rows)
            return float(total), float(d1), float(d2)
        total, _, rows = self._evaluate()
        d1, d2, self.branches = _root_newton(
            rows, self.branches, self.root_idx[4], *self._model_args(),
            *self._site_args(), p.scale_threshold, **p._modes())
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
        _, _, rows = self._evaluate()
        post, site_rate = ops_likelihood.rate_posteriors(
            *rows, p.pmatrix[self.root_idx[4]], freqs, prop_invar, rates,
            rate_weights, pidx, self._site_args()[1],
            scale_threshold=p.scale_threshold, rate_scalers=p.rate_scalers)
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
