"""Full-tree evaluation, in PyTorch.

Port of libpll2_tpu/engine.py (`_fused_loglikelihood`, `_fused_newton_step`,
`_repeats_loglikelihood`, a single repeats Newton step, candidate scoring,
the k-chained loops and `TreeEngine`, with per-rate scalers, raw tip CLVs,
ascertainment-bias corrections and site sharding):

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
  'pool-pallas'   site repeats' pooled class columns through the pool
                  kernel (ops/pool.py): one launch a traversal at 4 states
                  x 4 rates, else one per dependency level;
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

Candidate scoring (`evaluate_topologies`, `pack_candidate`,
`evaluate_packed`, `evaluate_packed_arrays`) returns the logL of many
topologies of the engine's size. On the fused paths a chunk of up to
CANDIDATE_CHUNK candidates is ONE launch of the fused kernel's candidate
form (`_fused_multi_topology`); a batch the kernel cannot run goes one
candidate at a time through the engine's own dense path on scratch copies
of the dense buffers, and a repeats partition's candidates one at a time
through its pooled path. Scoring leaves the partition's buffers and the
engine's topology as they were.

Model trials (`_trial_loglikelihoods`, optimize.py's batched evaluator) score
K models (eigensystems and frequencies) on the engine's topology and path:
on the fused paths a chunk of up to CANDIDATE_CHUNK trials is ONE launch of
the same candidate form, the op table repeated and each trial its own
P-matrices (`_fused_trials`). On 'levels-kernel' and 'pool-pallas' a chunk
of trials (as many as TRIAL_LAUNCH_BYTES of trial buffers hold) runs the
trial form of the level or pool kernel: one launch a level for the whole
chunk ('levels-kernel', each trial its own inner rows and scaler rows, the
tips shared), or one launch a traversal at 4 states x 4 rates and one a
level otherwise ('pool-pallas', each trial its own copy of the pools); the
root edges' likelihoods are then one batch (`_level_trials`,
`_pool_trials`). The plain pooled path ('pool') runs its chunks the same
way through the pool kernel's plain trial form; the plain dense paths
('levels', 'scan') run the trials one after another on scratch copies of
the partition's buffers.

`loglikelihood_loop(k)` and `newton_loop(k)` run k chained evaluations
(JAX's one-dispatch `fori_loop`s, libpll2_tpu/engine.py:309-440): on one
card the first iteration runs eagerly and the next is captured once in a
CUDA graph and replayed k - 1 times, with one host sync at the end
(`choose_loop`, `run_chained`); the fused path writes the root rows back
once, after the loop.

On a sharded partition (parallel/sharding.py:shard_partition) the engine
holds one TreeEngine a shard (`_Shards`), each on its shard's column block
and device, and every evaluation, Newton step, candidate batch and trial
batch runs each of them (the path's kernel launched once a shard, JAX's
shard_map bodies) and reduces their partial sums with `psum`; the Newton
update from the summed d1/d2 is applied on every shard, so that every
shard holds the same branch lengths. Per-site outputs are concatenated in
shard order.
"""
from __future__ import annotations

import copy
import functools
import operator
import time
from typing import NamedTuple, Optional, Sequence

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
from .parallel.sharding import is_multiprocess, psum
from .partition import (Operation, Partition, PartitionShard,
                        pack_level_operations, pack_operations)
from .trees import create_operations, traverse
from .utils.profiling import annotate

__all__ = ["TreeEngine", "Route", "choose_route", "pack_repeats",
           "choose_loop", "run_chained", "LoopRun"]

# candidates a launch of the fused kernel takes (libpll2_tpu/engine.py:718)
CANDIDATE_CHUNK = 128
# the device memory one chunk of model trials may take on 'levels-kernel'
# and the pooled paths: each trial's CLV rows from the first inner row up and
# its scaler rows, or its copy of the pools. A 128 x 16384 DNA trial takes
# 127 inner rows (133.2 MB) and 128 scaler rows (8.4 MB), so a DNA step's
# 19 trials (2.69 GB) are one chunk; a 128 x 8192 protein trial (337 MB)
# leaves 9 a chunk.
TRIAL_LAUNCH_BYTES = 3 << 30

# TreeEngine(pallas=...): the JAX package's names; the 'interpret' variants
# ran the Pallas kernels in interpret mode on a CPU, which the port's
# wrappers do by themselves for CPU tensors
PALLAS_MODES = ("auto", True, "interpret", "levels-kernel",
                "levels-interpret", "pool", "pool-interpret", False)


class Route(NamedTuple):
    """The kernels a TreeEngine may run (`choose_route`): the fused
    whole-traversal kernel (over a repeats partition: 'repeats-dense-fused'),
    the level kernel on a dense partition, the pool kernel on a repeats
    one; `repeats` and `levels` (level_schedule) name the plain paths."""
    fused: bool
    levels_kernel: bool
    pool_kernel: bool
    repeats: bool
    levels: bool

    @property
    def path(self) -> str:
        """The engine's `execution_path` when the fused kernel, if chosen,
        packs its op list (`pack_fused_schedule`)."""
        if self.fused:
            return "repeats-dense-fused" if self.repeats else "fused"
        if self.repeats:
            return "pool-pallas" if self.pool_kernel else "pool"
        if self.levels_kernel:
            return "levels-kernel"
        return "levels" if self.levels else "scan"


def choose_route(pallas="auto", *, dtype=torch.float32, device_type="cuda",
                 states: int = 4, repeats: bool = False,
                 tips_set: bool = True, rate_scalers: bool = False,
                 rate_cats: int = 4, meshed: bool = False,
                 level_schedule: bool = True) -> Route:
    """The route a TreeEngine takes, from plain values: `pallas` (the
    engine's argument), the partition's dtype, device type, states,
    storage (`repeats`), whether every tip is set, per-rate scalers and
    categories, and whether it lies on a mesh.

    - The kernels are float32. A float64 partition on CUDA takes no kernel
      route: 'levels' or 'scan' (dense) and 'pool' (repeats), the plain
      versions of the paths JAX reports for it (its XLA paths,
      libpll2_tpu/engine.py:843-845, :903-906). On the CPU the wrappers run
      their plain versions by themselves, so a float64 CPU partition keeps
      the kernel routes' names (ROADMAP, Rules: routing difference 2).
    - The fused kernels take at most ops/fused.py:FUSED_MAX_STATES states
      (32-bit tip codes); above that the dense default is 'levels-kernel'
      and the repeats default 'pool-pallas' (JAX's 'fused' returns -inf
      there: ROADMAP C-J1).
    - The fused kernel needs every tip set; with per-rate scalers the rows
      route (16+ states) keeps JAX's 8-category bound, and under a mesh
      both routes do (libpll2_tpu/engine.py:835-839)."""
    want_fused = pallas in ("auto", True, "interpret")
    want_pool = pallas in ("pool", "pool-interpret")
    kernels = not (dtype == torch.float64 and device_type == "cuda")
    fused_ok = kernels and tips_set and states <= ops_fused.FUSED_MAX_STATES \
        and (not rate_scalers
             or rate_cats <= ops_fused.ROWS_RATE_SCALERS_MAX
             or (states < ops_fused.ROWS_STATES_MIN and not meshed))
    levelk = want_fused or pallas in ("levels-kernel", "levels-interpret")
    return Route(fused=want_fused and fused_ok,
                 levels_kernel=kernels and not repeats and levelk,
                 pool_kernel=kernels and repeats and (want_fused or want_pool),
                 repeats=repeats, levels=level_schedule)


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
    d1, d2 = _root_derivatives(
        rows, branches, root_mat, eigenvals, inv_eigenvecs, eigenvecs,
        prop_invar, rates, rate_weights, freqs, params_idx_rates,
        pattern_weights, invariant, scale_threshold,
        rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real)
    return d1, d2, _newton_update(branches, root_mat, d1, d2)


def _newton_update(branches, root_mat: int, d1, d2):
    """A copy of `branches` with the root edge's length Newton-updated."""
    new_len = ops_derivatives.newton_step(branches[root_mat], d1, d2,
                                          C.OPT_MIN_BRANCH_LEN,
                                          C.OPT_MAX_BRANCH_LEN)
    branches = branches.clone()
    branches[root_mat] = new_len
    return branches


def _root_derivatives(rows, branches, root_mat: int, eigenvals,
                      inv_eigenvecs, eigenvecs, prop_invar, rates,
                      rate_weights, freqs, params_idx_rates, pattern_weights,
                      invariant, scale_threshold: float,
                      rate_scalers: bool = False, asc_type: int = C.AB_NONE,
                      n_real: int = -1, col0=None):
    """(d1, d2) of the root edge's rows at its current length, or with
    `col0` a shard's partial sums (ops/derivatives.py)."""
    clv_p, clv_c, sc_p, sc_c = rows
    sumtable = ops_derivatives.update_sumtable(
        clv_p, clv_c, sc_p, sc_c, inv_eigenvecs, eigenvecs, freqs,
        params_idx_rates, scale_threshold, rate_scalers=rate_scalers,
        has_pscaler=True, has_cscaler=True)
    blen = branches[root_mat]
    asc_scalers = None
    if asc_type in (C.AB_LEWIS, C.AB_FELSENSTEIN):
        asc_scalers = sc_p + sc_c
    return ops_derivatives.likelihood_derivatives(
        sumtable, eigenvals, prop_invar, freqs, rates, rate_weights,
        params_idx_rates, pattern_weights, invariant, blen,
        asc_scalers=asc_scalers, scale_threshold=scale_threshold,
        asc_type=asc_type, n_real=n_real, col0=col0)


def _fused_loglikelihood(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, rate_weights, freqs, params_idx_rates,
                         branches, table, tip_codes, root_mat: int,
                         pattern_weights, invariant, n_slots: int,
                         scale_threshold: float, scale_factor: float,
                         traversal=ops_fused.fused_traversal,
                         mxu: str = "split", edge_params=None,
                         rate_scalers: bool = False, tip_clvs=None,
                         asc_type: int = C.AB_NONE, n_real: int = -1,
                         col0=None, pmatrix=None, splits=None):
    """The fused path. branches[e] is ordered by pmatrix index e. Returns
    (total logL, per-site weighted logL, root rows (clv_p, clv_c, sc_p,
    sc_c), P-matrices). `traversal` is the fused traversal to run: the
    dispatching wrapper, or its plain version for a comparison on the card;
    `mxu` its contraction mode, `rate_scalers` and `tip_clvs` (the raw tip
    rows) its modes (ops/fused.py); `asc_type`, `n_real` and `col0` the
    likelihood's asc correction (with `col0` on a shard, the total is its
    partial sums); `pmatrix` the P-matrices of `branches` when the caller
    has them (a mesh computes them once for its shards); `splits` the
    table's subtree splits (ops/fused.py:FusedSplits), which the 4 x 4
    on-chip body may walk on a thread block cluster."""
    if pmatrix is None:
        with annotate("pll.pmatrix"):
            pmatrix = _pmatrices(eigenvals, inv_eigenvecs, eigenvecs,
                                 prop_invar, rates, params_idx_rates,
                                 branches, edge_params)
    with annotate("pll.fused_traversal"):
        rows = traversal(tip_codes, pmatrix, table, rates=pmatrix.shape[1],
                         states=pmatrix.shape[2], n_slots=n_slots,
                         threshold=scale_threshold, factor=scale_factor,
                         mxu=mxu, rate_scalers=rate_scalers,
                         tip_clvs=tip_clvs, splits=splits)
    clv_p, clv_c, sc_p, sc_c = rows
    with annotate("pll.edge_logl"):
        total, per = ops_likelihood.edge_loglikelihood(
            clv_p, clv_c, sc_p, sc_c, pmatrix[root_mat], freqs, prop_invar,
            rate_weights, params_idx_rates, pattern_weights, invariant,
            scale_threshold, rate_scalers=rate_scalers, asc_type=asc_type,
            n_real=n_real, col0=col0)
    return total, per, rows, pmatrix


def _fused_newton_step(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                       rates, rate_weights, freqs, params_idx_rates,
                       branches, table, tip_codes, root_mat: int,
                       pattern_weights, invariant, n_slots: int,
                       scale_threshold: float, scale_factor: float,
                       traversal=ops_fused.fused_traversal,
                       mxu: str = "split", edge_params=None,
                       rate_scalers: bool = False, tip_clvs=None,
                       asc_type: int = C.AB_NONE, n_real: int = -1,
                       splits=None):
    """Evaluate the tree on the fused path, then Newton-update the root
    branch length from d1/d2. Returns (total, d1, d2, new branches, root
    rows, P-matrices)."""
    total, _, rows, pmatrix = _fused_loglikelihood(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        rate_weights, freqs, params_idx_rates, branches, table, tip_codes,
        root_mat, pattern_weights, invariant, n_slots, scale_threshold,
        scale_factor, traversal=traversal, mxu=mxu, edge_params=edge_params,
        rate_scalers=rate_scalers, tip_clvs=tip_clvs, asc_type=asc_type,
        n_real=n_real, splits=splits)
    d1, d2, branches = _root_newton(
        rows, branches, root_mat, eigenvals, inv_eigenvecs, eigenvecs,
        prop_invar, rates, rate_weights, freqs, params_idx_rates,
        pattern_weights, invariant, scale_threshold,
        rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real)
    return total, d1, d2, branches, rows, pmatrix


def _fused_multi_topology(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                          rates, rate_weights, freqs, params_idx_rates,
                          branches_k, tables_k, tip_codes, root_mats,
                          pattern_weights, invariant, n_slots: int,
                          scale_threshold: float, scale_factor: float,
                          traversal=ops_fused.fused_traversal,
                          mxu: str = "split", edge_params=None,
                          rate_scalers: bool = False, tip_clvs=None,
                          asc_type: int = C.AB_NONE, n_real: int = -1,
                          col0=None, pmatrix=None, splits=None):
    """logL [K] of K candidate topologies in ONE launch of the fused
    traversal's candidate form (libpll2_tpu/engine.py:_fused_multi_topology):
    branches_k [K, E] (pmatrix order), tables_k [K, n_ops+1, 8] int32 and
    root_mats [K], the root edges' matrix indices; `n_slots` the largest
    slot count of the K tables. Every candidate walks from the same tip
    operands and keeps only its root edge's logL. With `edge_params` each
    candidate's P-matrices use the per-edge table and its likelihood mixing
    its own root edge's rate matrix, as `set_topology` + `loglikelihood`
    compute it. `pmatrix` [K, E, R, s, s]: the candidates' P-matrices when
    the caller has them (`_candidate_pmatrices`); `splits` the tables'
    subtree splits (ops/fused.py:FusedSplits)."""
    k = branches_k.shape[0]
    pmat = pmatrix if pmatrix is not None else _candidate_pmatrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, branches_k, edge_params)
    clv_p, clv_c, sc_p, sc_c = traversal(
        tip_codes, pmat, tables_k, rates=pmat.shape[2],
        states=pmat.shape[3], n_slots=n_slots, threshold=scale_threshold,
        factor=scale_factor, mxu=mxu, rate_scalers=rate_scalers,
        tip_clvs=tip_clvs, splits=splits)
    root_p = pmat[torch.arange(k, device=pmat.device), root_mats]
    pidx = params_idx_rates if edge_params is None else edge_params[root_mats]
    return ops_likelihood.edge_loglikelihood_candidates(
        clv_p, clv_c, sc_p, sc_c, root_p, freqs, prop_invar, rate_weights,
        pidx, pattern_weights, invariant, scale_threshold,
        rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real,
        col0=col0)


def _candidate_pmatrices(eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, params_idx_rates, branches_k,
                         edge_params=None):
    """P [K, E, R, s, s] of K candidates' branch vectors [K, E]."""
    k, n_edges = branches_k.shape
    ep = None if edge_params is None else edge_params.repeat(k, 1)
    pmat = _pmatrices(eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
                      params_idx_rates, branches_k.reshape(-1), ep)
    return pmat.view(k, n_edges, *pmat.shape[1:])


def _fused_trials(eigenvals_k, inv_eigenvecs_k, eigenvecs_k, prop_invar,
                  rates, rate_weights, freqs_k, params_idx_rates, branches,
                  table, tip_codes, root_mat: int, pattern_weights,
                  invariant, n_slots: int, scale_threshold: float,
                  scale_factor: float, traversal=ops_fused.fused_traversal,
                  mxu: str = "split", edge_params=None,
                  rate_scalers: bool = False, tip_clvs=None,
                  asc_type: int = C.AB_NONE, n_real: int = -1, col0=None):
    """logL [K] of K trial models on one topology in ONE launch of the fused
    traversal's candidate form (the launch shape of libpll2_tpu/optimize.py:
    353-366, `jax.vmap` over `eval_one`): eigensystems [K, M, ...] and
    frequencies [K, M, s]. The op table [n_ops+1, 8] is repeated K times;
    each trial carries its own P-matrices [K, E, R, s, s] and its own
    frequencies in the root edge's likelihood."""
    k = eigenvals_k.shape[0]
    pidx = params_idx_rates if edge_params is None else edge_params
    pmat = ops_pmatrix.update_prob_matrices_trials(
        eigenvals_k, inv_eigenvecs_k, eigenvecs_k, prop_invar, rates, pidx,
        branches)
    tables = table[None].expand(k, *table.shape).contiguous()
    clv_p, clv_c, sc_p, sc_c = traversal(
        tip_codes, pmat, tables, rates=pmat.shape[2], states=pmat.shape[3],
        n_slots=n_slots, threshold=scale_threshold, factor=scale_factor,
        mxu=mxu, rate_scalers=rate_scalers, tip_clvs=tip_clvs)
    root_pidx = (params_idx_rates if edge_params is None
                 else edge_params[root_mat])
    return ops_likelihood.edge_loglikelihood_candidates(
        clv_p, clv_c, sc_p, sc_c, pmat[:, root_mat], freqs_k, prop_invar,
        rate_weights, root_pidx, pattern_weights, invariant, scale_threshold,
        rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real,
        col0=col0)


def _root_indices(root) -> tuple:
    """A candidate's root edge as (p_clv, p_scaler, c_clv, c_scaler,
    matrix): a 5-tuple as given (candidates built from trial moves snapshot
    it before the move is rolled back) or read off a live node."""
    if isinstance(root, (tuple, list)):
        return tuple(int(v) for v in root)
    return (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index)


def _check_candidate_tables(tables, roots, n_slots, n_tips: int,
                            n_ctips: int, n_matrices: int) -> None:
    """Every index of K candidates' op tables [K, n_ops+1, 8] in range (the
    kernels trust them): matrix indices below `n_matrices`, parent slots
    below each candidate's `n_slots`, and each child or root end a slot, a
    state-code tip or a raw tip row in range."""
    ops, root = tables[:, :-1], tables[:, -1]
    ns = np.asarray(n_slots)[:, None]
    mats = np.concatenate([ops[..., 3], ops[..., 6], roots[:, 4:5]], axis=1)
    ok = (np.all((mats >= 0) & (mats < n_matrices)) and np.all(ns >= 1)
          and np.all((ops[..., 0] >= 0) & (ops[..., 0] < ns)))
    for kind, idx in ((ops[..., 1], ops[..., 2]), (ops[..., 4], ops[..., 5]),
                      (root[:, 0:1], root[:, 1:2]),
                      (root[:, 2:3], root[:, 3:4])):
        limit = np.where(kind == 1, n_tips, np.where(kind == 2, n_ctips, ns))
        ok = ok and np.all((kind >= 0) & (kind <= 2) & (idx >= 0)
                           & (idx < limit))
    if not ok:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "a candidate's op table or root holds an index out "
                         "of range")


def _dense_loglikelihood(clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                         prop_invar, rates, rate_weights, freqs,
                         params_idx_rates, branches, path: str, plan,
                         root_idx, pattern_weights, invariant,
                         scale_threshold: float, scale_factor: float,
                         level=None, edge_params=None,
                         rate_scalers: bool = False,
                         asc_type: int = C.AB_NONE, n_real: int = -1,
                         col0=None, pmatrix=None):
    """A path over the dense buffers `clv` [N+1, R, s, S] and `scaler`
    [K+2, S] ([K+2, R, S] with `rate_scalers`), which it updates in
    place. `path` and `plan`:
    'levels-kernel' with the level tables on the device (each level run by
    `level`: by default ops/levels.py:level_for, the dispatching wrapper
    for float32 buffers; or the plain version for a comparison on the
    card), 'levels' with (Operations [L, W], valid), 'scan' with
    Operations [n]; `pmatrix` as in `_fused_loglikelihood`. Returns (total
    logL, per-site weighted logL, P-matrices, root rows)."""
    if pmatrix is None:
        with annotate("pll.pmatrix"):
            pmatrix = _pmatrices(eigenvals, inv_eigenvecs, eigenvecs,
                                 prop_invar, rates, params_idx_rates,
                                 branches, edge_params)
    with annotate("pll.partials"):
        if path == "levels-kernel":
            ops_levels.update_partials_kernel(clv, scaler, pmatrix, plan,
                                              scale_threshold, scale_factor,
                                              level=level)
        elif path == "levels":
            ops_partials.update_partials_levels(clv, scaler, pmatrix, *plan,
                                                scale_threshold,
                                                scale_factor,
                                                rate_scalers=rate_scalers)
        else:
            ops_partials.update_partials(clv, scaler, pmatrix, plan,
                                         scale_threshold, scale_factor,
                                         rate_scalers=rate_scalers)
    p_clv, p_sc, c_clv, c_sc, mat = root_idx
    # a missing scaler (-1) reads the last row, which stays zero
    rows = (clv[p_clv], clv[c_clv], scaler[p_sc], scaler[c_sc])
    with annotate("pll.edge_logl"):
        total, per = ops_likelihood.edge_loglikelihood(
            rows[0], rows[1], rows[2], rows[3], pmatrix[mat], freqs,
            prop_invar, rate_weights, params_idx_rates, pattern_weights,
            invariant, scale_threshold, rate_scalers=rate_scalers,
            asc_type=asc_type, n_real=n_real, col0=col0)
    return total, per, pmatrix, rows


def _repeats_loglikelihood(clv_flat, sc_flat, eigenvals, inv_eigenvecs,
                           eigenvecs, prop_invar, rates, rate_weights, freqs,
                           params_idx_rates, branches, path: str, plan,
                           root_cols, root_mat: int, pattern_weights,
                           invariant, scale_threshold: float,
                           scale_factor: float, level=None,
                           edge_params=None, rate_scalers: bool = False,
                           asc_type: int = C.AB_NONE, n_real: int = -1,
                           pmatrix=None):
    """A path over a repeats partition's pooled buffers `clv_flat` [R, s,
    T] and `sc_flat` [T2] ([R, T2] with `rate_scalers`), which it updates
    in place. `plan` is a PoolPlan; `path` 'pool-pallas' runs it through
    the plan's kernels (one launch a traversal at 4x4) or a given `level`
    (a level at a time: the plain version for a comparison on the card),
    'pool' through the plain version. `root_cols` holds the root edge's
    absolute per-site columns (clv and scaler, parent then child);
    `pmatrix` as in `_fused_loglikelihood`. Returns (total logL, per-site
    weighted logL, P-matrices, root rows)."""
    if pmatrix is None:
        with annotate("pll.pmatrix"):
            pmatrix = _pmatrices(eigenvals, inv_eigenvecs, eigenvecs,
                                 prop_invar, rates, params_idx_rates,
                                 branches, edge_params)
    if path == "pool":
        level = ops_pool.pool_update_reference
    with annotate("pll.partials.repeats"):
        ops_pool.update_partials_pool(clv_flat, sc_flat, pmatrix, plan,
                                      scale_threshold, scale_factor,
                                      level=level)
    p_cols, p_sc_cols, c_cols, c_sc_cols = root_cols
    rows = (clv_flat[:, :, p_cols], clv_flat[:, :, c_cols],
            sc_flat[..., p_sc_cols], sc_flat[..., c_sc_cols])
    with annotate("pll.edge_logl"):
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


def _on_device(x, device):
    """A tensor, or a (named) tuple of them as the packed plans are, on
    `device` (the same objects where they lie there already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        items = [_on_device(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def choose_loop(devices, multiprocess: bool = False) -> str:
    """How `loglikelihood_loop` and `newton_loop` run their k iterations,
    from plain values: the devices of the engine's units (its own, or one
    a shard) and whether its mesh spans processes.
      'graph' every unit on one CUDA device in one process (a mesh of
              shards of one card too): the first iteration runs eagerly,
              the next is captured once in a CUDA graph and replayed k - 1
              times on torch's current stream (`run_chained`);
      'eager' the same iteration in a Python loop, with no host sync but
              the result's at the end and what a collective needs: on the
              CPU (the kernels' plain versions), across processes (every
              iteration's psum runs a host collective, gloo's all_reduce,
              which a graph cannot hold) and across cards (a capture
              records the work of one device's stream)."""
    devs = {torch.device(d) for d in devices}
    one_card = len(devs) == 1 and next(iter(devs)).type == "cuda"
    return "graph" if one_card and not multiprocess else "eager"


class LoopRun(NamedTuple):
    """A run of `run_chained`: its route ('graph' or 'eager'), trip count,
    the capture's host ms (None without a capture), the kernel wrappers'
    launches an iteration ({"level_update": n, ...}), and the
    graph, which holds the replays' outputs until the caller has read
    them."""
    route: str
    k: int
    capture_ms: Optional[float]
    launches: dict
    graph: object


def _launch_counters() -> tuple:
    """The kernel wrappers whose `launches` count their launches."""
    return (ops_fused.fused_traversal, ops_fused.fused_traversal_rows,
            ops_fused.fused_traversal_f64, ops_levels.level_update,
            ops_pool.pool_update)


def _counts(counters) -> list:
    return [f.launches for f in counters]


def run_chained(k: int, step, route: str, device, state) -> LoopRun:
    """Run `step()` k >= 1 times on `route` (`choose_loop`). 'graph': the
    first call runs eagerly (it fills the engine's device caches and sets
    the kernels' attributes), the second is captured once in a CUDA graph
    on a side stream of `device`, then the graph is replayed k - 1 times on
    the current stream, with no host sync. `step` keeps its carry in
    tensors it updates in place, and what it leaves in Python names after
    the capture lives in the graph's memory pool, holding the last replay's
    values. The kernel wrappers' launch counters count the capture's
    launches once an iteration: after the loop they read the launches the
    card ran, the eager iteration's and the replays'. `state()`, what the
    iteration read through the engine's caches, must be the same after the
    capture as before it (nothing was uploaded in the graph). A capture
    that fails raises: nothing falls back to an eager loop."""
    counters = _launch_counters()
    start = _counts(counters)
    step()
    per = [n - s for n, s in zip(_counts(counters), start)]
    graph = capture_ms = None
    if route == "eager":
        for _ in range(k - 1):
            step()
    elif k > 1:
        graph, capture_ms, per = _capture(step, device, state, counters)
        with torch.cuda.device(device), annotate("pll.loop.replays"):
            for _ in range(k - 1):
                graph.replay()
        for f, n in zip(counters, per):
            f.launches += n * (k - 1)
    launches = {f.__name__: n for f, n in zip(counters, per) if n}
    return LoopRun(route, k, capture_ms, launches, graph)


def _capture(step, device, state, counters):
    """One call of `step` captured in a CUDA graph: (graph, host ms, the
    launches it counted, which the counters then give back)."""
    want = state()
    before = _counts(counters)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    t0 = time.perf_counter()
    try:
        with torch.cuda.device(device), torch.cuda.stream(side):
            graph.capture_begin()
            try:
                step()
            except Exception as exc:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise RuntimeError(f"capturing the loop's iteration in a "
                                   f"CUDA graph failed: {exc}") from exc
            graph.capture_end()
    finally:
        per = [n - b for n, b in zip(_counts(counters), before)]
        for f, b in zip(counters, before):
            f.launches = b
    ms = (time.perf_counter() - t0) * 1e3
    if state() != want:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "the loop's captured iteration rebuilt a cached "
                         "device operand (the model, the tips or the pooled "
                         "layout changed during the call)")
    return graph, ms, per


def _loop_state(units) -> tuple:
    """The device operands each unit's iteration reads through its caches
    (model, tip codes, pooled layout and plan), by identity."""
    return tuple((id(getattr(e, "_model_cache", None)),
                  id(getattr(e, "_tip_codes_cache", None)),
                  id(getattr(e, "_layout", None)), id(e._ops))
                 for e in units)


def _write_root_rows(units, rows) -> None:
    """The fused path's write-back of each unit's root rows into its
    partition's dense buffers (none on 'repeats-dense-fused')."""
    for e, r in zip(units, rows):
        if e.use_fused and not e.repeats_dense_fused:
            _scatter_root_rows(e.partition.clv, e.partition.scale_buffer,
                               e.root_idx, r)


def _own_pmatrices(units) -> None:
    """After a graph's replays: each unit's partition gets its own copy of
    the P-matrices the captured iteration left in the graph's pool."""
    copies = {}
    for e in units:
        t = e.partition.pmatrix
        if id(t) not in copies:
            copies[id(t)] = t.clone()
        e.partition.pmatrix = copies[id(t)]


def _bind_branches(owner, branches) -> None:
    owner.branches = branches
    if owner._shards is not None:
        owner._shards.bind(branches)


def _run_loop(owner, k: int, step) -> LoopRun:
    """`run_chained` on `owner`'s route, its record kept as
    `owner._last_loop`."""
    units = owner._units()
    mesh = owner._shards.mesh if owner._shards is not None else None
    route = choose_loop([e.device for e in units],
                        mesh is not None and is_multiprocess(mesh))
    run = run_chained(k, step, route, units[0].device,
                      lambda: _loop_state(units))
    # the record without the graph: its pool goes once the loop has read it
    owner._last_loop = run._replace(graph=None)
    return run


def chained_loglikelihood(owner, k: int) -> float:
    """The sum of k chained full evaluations of `owner` (a TreeEngine or a
    ShardedRepeatsEngine), accumulated in its dtype; 0.0 and nothing
    touched for k <= 0 (libpll2_tpu/engine.py:_scatter_if_ran). The fused
    path writes its root rows back once, after the loop."""
    k = operator.index(k)
    if k <= 0:
        return 0.0
    units = owner._units()
    acc = torch.zeros((), dtype=owner.dtype, device=units[0].device)
    last = []

    def step():
        total, _, rows = owner._evaluate(scatter=False)
        acc.add_(total.reshape(()))
        last[:] = [rows if owner._shards is not None else [rows]]

    run = _run_loop(owner, k, step)
    _write_root_rows(units, last[0])
    if run.graph is not None:
        _own_pmatrices(units)
    return float(acc)


def chained_newton(owner, k: int):
    """k chained guarded Newton updates of `owner`'s root branch, each on a
    fresh evaluation: (logL, d1, d2) of the last iteration, the branches
    left updated; (0.0, 0.0, 0.0) and nothing touched for k <= 0. The
    branches are the loop's carry, one tensor updated in place."""
    k = operator.index(k)
    if k <= 0:
        return 0.0, 0.0, 0.0
    units = owner._units()
    branches = owner.branches.clone()
    _bind_branches(owner, branches)
    last = []

    def step():
        total, d1, d2, new, rows = owner._newton_once()
        branches.copy_(new)
        _bind_branches(owner, branches)
        last[:] = [(total, d1, d2), rows]

    run = _run_loop(owner, k, step)
    values, rows = last
    _write_root_rows(units, rows)
    if run.graph is not None:
        _own_pmatrices(units)
    total, d1, d2 = torch.stack([v.reshape(()).to(torch.float64)
                                 for v in values]).tolist()
    return total, d1, d2


class _Shards:
    """The per-shard TreeEngines of a site mesh, in shard order, and the
    reductions over them. The site-independent work runs once: the op
    table or level plan is packed by the engine that owns the shards
    (`TreeEngine._bind_shards`) and the P-matrices are computed once a
    call, on the first shard's device. Then each shard's engine runs the
    path's kernel and the likelihood epilogue on its own column block, one
    shard after another (JAX's shard_map bodies), and the per-shard sums
    are reduced with parallel/sharding.py:psum (JAX's psums). The totals
    of shard partitions (partition.py:PartitionShard) are partial sums
    that the asc correction finishes (ops/likelihood.py:asc_total); those
    of whole partitions (ShardedRepeatsEngine's) are totals already."""

    def __init__(self, engines, mesh):
        self.engines = list(engines)
        self.mesh = mesh

    def _asc(self):
        """The asc type that finishes the reduced sums, or None when the
        shards' totals are complete."""
        modes = self.engines[0].partition._modes()
        return modes["asc_type"] if "col0" in modes else None

    def reduce(self, parts) -> torch.Tensor:
        total = psum(parts, self.mesh)
        asc = self._asc()
        return total if asc is None else ops_likelihood.asc_total(total, asc)

    def bind(self, branches) -> None:
        """The replicated branch lengths, on every shard."""
        for e in self.engines:
            e.branches = branches.to(e.device)

    def _pmatrix(self):
        """The replicated P-matrices of the bound branches, computed once
        (from the first shard's model, as JAX replicates it)."""
        return self.engines[0]._pmatrix(self.engines[0].branches)

    def evaluate(self, branches, scatter: bool = True):
        """(total, per-site concatenated in shard order, each shard's root
        rows); `scatter` as in TreeEngine._evaluate."""
        self.bind(branches)
        pmatrix = self._pmatrix()
        outs = [e._evaluate(pmatrix=pmatrix.to(e.device), scatter=scatter)
                for e in self.engines]
        dev = self.engines[0].device
        return (self.reduce([o[0] for o in outs]),
                torch.cat([o[1].to(dev) for o in outs]),
                [o[2] for o in outs])

    def newton(self, branches):
        """Evaluate, then one Newton update of the root branch from the d1
        and d2 summed over the shards (logL, d1 and d2 reduced as one packed
        tensor), applied on every shard. Returns (total, d1, d2, new
        branches, each shard's root rows, not written back)."""
        self.bind(branches)
        pmatrix = self._pmatrix()
        parts, shard_rows = [], []
        for e in self.engines:
            total, _, rows = e._evaluate(pmatrix=pmatrix.to(e.device),
                                         scatter=False)
            shard_rows.append(rows)
            p = e.partition
            d = _root_derivatives(rows, e.branches, e.root_idx[4],
                                  *e._model_args(), *e._site_args(),
                                  p.scale_threshold, **p._modes())
            d = torch.stack(d) if isinstance(d, tuple) else d
            parts.append(torch.cat([total.reshape(-1), d]))
        summed = psum(parts, self.mesh)
        asc = self._asc()
        if asc is None:
            total, d1, d2 = summed[0], summed[1], summed[2]
        else:
            n = ops_likelihood.asc_parts(asc)
            total = ops_likelihood.asc_total(summed[:n], asc)
            d1, d2 = ops_derivatives.derivatives_total(summed[n:], asc)
        branches = _newton_update(branches, self.engines[0].root_idx[4], d1,
                                  d2)
        self.bind(branches)
        return total, d1, d2, branches, shard_rows

    def score_fused(self, tables, blens, roots, n_slots) -> torch.Tensor:
        """Fused candidates: checked once and their P-matrices computed once
        a chunk, then a launch a chunk a shard."""
        e0 = self.engines[0]
        margs = e0._model_args()
        out = []
        for chunk in e0._candidate_chunks(tables, blens, roots, n_slots):
            pmatrix = _candidate_pmatrices(*margs[:5], margs[7], chunk[0],
                                           e0.edge_params)
            out.append(self.reduce([
                e._score_chunk(chunk, pmatrix.to(e.device))
                for e in self.engines]))
        return torch.cat(out)

    def trials(self, branches, eigen_k, freqs_k, traversal,
               level) -> torch.Tensor:
        self.bind(branches)
        return self.reduce([e._trial_loglikelihoods(
            tuple(x.to(e.device) for x in eigen_k), freqs_k.to(e.device),
            traversal, level) for e in self.engines])


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
              (`pack_fused_schedule`), the alphabet has at most 32
              states and, with per-rate scalers on a 16+ state alphabet,
              at most 8 rate categories (as in JAX); else the per-level
              kernel, or on a site-repeats partition the pool kernel
              ('repeats-dense-fused' runs the fused kernel over a repeats
              partition, which keeps its pooled storage);
          'levels-kernel', 'levels-interpret' -- the per-level kernel (on a
              repeats partition: the plain pooled path);
          'pool', 'pool-interpret' -- on a repeats partition the pool
              kernel; on a dense one the plain paths below;
          False -- plain PyTorch, level by level with `level_schedule`,
              else one op at a time; the plain pooled path on a repeats
              partition.
        The kernels' wrappers run their plain versions for CPU tensors, so
        the 'interpret' names equal the others. The kernels are float32: a
        float64 partition on CUDA takes the plain paths whatever `pallas`
        says, as JAX takes XLA (`choose_route` decides the route). `mxu`
        picks the fused traversal's contraction mode for 16+-state
        alphabets: 'split' (default) is JAX's three-term bf16 product and
        'bf16' its one-term one (the rows kernel runs both on the tensor
        cores), 'highest' exact float32 (ops/fused.py). `edge_params`
        [prob_matrices] gives the rate-matrix index of every P-matrix slot
        (per-branch heterotachy).

        Where libpll2_tpu falls back to XLA only because its level or pool
        kernel has no per-rate scaler mode, the port's kernels run theirs:
        'levels-kernel' where JAX says 'levels', 'pool-pallas' where it says
        'pool'.

        On a sharded partition the engine builds one engine a shard and
        reduces over them (`_Shards`); the paths are JAX's under a mesh, but
        that the level kernel runs each shard's levels where JAX takes
        'levels' (its level kernel has no mesh form) and the fused kernel
        takes any shard width (JAX pads each shard's block to its kernel
        grain)."""
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
        # every tip set, from state codes or raw probabilities (is_tip 2
        # rows of the op table)
        route = choose_route(
            pallas, dtype=p.dtype, device_type=p.device.type,
            states=p.states, repeats=p.repeats is not None,
            tips_set=bool(np.all(p._tips_set | p._tips_clv_set)),
            rate_scalers=p.rate_scalers, rate_cats=p.rate_cats,
            meshed=p.shards is not None or isinstance(p, PartitionShard),
            level_schedule=level_schedule)
        self.repeats_mode = route.repeats
        # the fused kernel over a repeats partition: it reads only tip codes
        # and writes nothing back, so the pooled storage stays as it is
        self.repeats_dense_fused = route.repeats and route.fused
        if self.repeats_dense_fused:
            self.repeats_mode = False
        self._fused_wanted = route.fused
        self._levelk_wanted = route.levels_kernel
        self._pool_kernel_wanted = route.pool_kernel
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
        self._shards = None
        self._pack_topology(operations, branches, pmatrix_indices, root)
        p._ensure_eigen([params_index])

    @property
    def use_pallas(self) -> bool:
        """True when the fused or the per-level kernel path is active (as in
        libpll2_tpu; the pool kernel is `use_repeats_pallas`)."""
        return self.use_fused or self.use_levelkernel

    @property
    def use_repeats_pallas(self) -> bool:
        """True on the 'pool-pallas' path. libpll2_tpu also asks that the
        class-column pool fit its kernel's VMEM budget, a TPU limit the
        CUDA kernel does not have."""
        return self.repeats_mode and self._pool_kernel_wanted

    @property
    def asc_type(self) -> int:
        """The partition's ascertainment-bias correction (C.AscBias
        value)."""
        return self.partition.asc_bias.value

    @property
    def n_real(self) -> int:
        """The real sites when asc columns follow them, else -1."""
        return self.partition.sites if self.partition.asc_extra else -1

    @property
    def ops(self):
        """The selected path's packed operands: on the fused path (the op
        table, tip codes, raw tip rows or None), the tip operands re-read
        through the version-checked cache so that a tip setter called after
        construction takes effect; else the level tables, the packed
        Operations or the PoolPlan."""
        if self.use_fused:
            return (self.table, self._tip_codes(), self._tip_clvs())
        return self._ops

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
            return "pool-pallas" if self.use_repeats_pallas else "pool"
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
        self.fused_splits = self._trial_rows = None
        self.branches = torch.as_tensor(
            self._branch_vector(branches, pmatrix_indices), dtype=self.dtype,
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
                self.fused_splits = ops_fused.FusedSplits(table)
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
        if not self.use_fused:
            self.use_levelkernel = self._levelk_wanted
            if self._dense_path() == "levels-kernel":
                tables = self._level_tables(operations)
                self._ops = ops_levels.tables_to_device(tables, self.device)
                zero = p.scale_buffers + 1
                r = self.root_idx
                self._trial_rows = ops_levels.trial_rows(
                    tables, p.tips, root_rows=(r[0], r[2]),
                    root_scalers=tuple(x if x >= 0 else zero
                                       for x in (r[1], r[3])))
            else:
                self._ops = self._dense_plan(operations)
        if p.shards is not None:
            self._bind_shards()

    # what a shard's engine takes from the engine that packed the topology
    _SHARED_TOPOLOGY = ("use_fused", "use_levelkernel", "fused_slots",
                        "fused_splits", "root_idx", "_packed_ctips",
                        "_trial_rows")

    def _bind_shards(self) -> None:
        """Hand the topology this engine packed to one engine a shard of
        its partition (made on the first call as shallow copies of this
        one, on each shard's partition and device): the op table or level
        plan, branches and root indices are shared, copied once to each
        device the first shard's does not share, so that a shard repacks
        nothing."""
        p = self.partition
        if self._shards is None:
            engines = []
            for sh in p.shards:
                e = copy.copy(self)
                e.partition, e.device = sh, sh.device
                e.edge_params = _on_device(self.edge_params, sh.device)
                engines.append(e)
            self._shards = _Shards(engines, p.mesh)
        placed = {}
        for e in self._shards.engines:
            for name in self._SHARED_TOPOLOGY:
                setattr(e, name, getattr(self, name))
            if e.device not in placed:
                placed[e.device] = _on_device(
                    (self.table, self._ops, self.branches,
                     self.params_idx_rates), e.device)
            e.table, e._ops, e.branches, e.params_idx_rates = \
                placed[e.device]
            e._model_cache_version = None
            if self.use_fused:
                e._tip_codes_version = None

    def _dense_path(self) -> str:
        """The dense path an op list takes when the fused kernel does not
        run it."""
        if self._levelk_wanted:
            return "levels-kernel"
        return "levels" if self.levels else "scan"

    def _level_tables(self, operations) -> tuple:
        """The level kernel's tables of `operations` (numpy, on the host)."""
        p = self.partition
        return ops_levels.pack_pallas_levels(
            operations, p.tips, zero_scaler_row=p.scale_buffers + 1,
            trash_scaler_row=p.scale_buffers)

    def _dense_plan(self, operations):
        """`operations` packed for `_dense_path`: the level tables on the
        device, (Operations [L, W], valid) or Operations [n]."""
        p = self.partition
        path = self._dense_path()
        if path == "levels-kernel":
            return ops_levels.tables_to_device(
                self._level_tables(operations), self.device)
        if path == "levels":
            return pack_level_operations(operations, p.tips,
                                         scratch_clv=p.nodes,
                                         device=self.device)
        return pack_operations(operations, device=self.device)

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
        """(total logL, per-site WEIGHTED logL [sites_padded] as numpy). On
        a mesh the shards' blocks in shard order: under several processes
        only this process's block (libpll2_tpu/engine.py:1229-1240)."""
        total, per = self._loglikelihood_dev(branches)
        return float(total), per.cpu().numpy()

    def _loglikelihood_dev(self, branches=None):
        """Full evaluation without a host sync: (total, per-site) as
        tensors."""
        total, per, _ = self._evaluate(branches)
        return total, per

    def _evaluate(self, branches=None, pmatrix=None, scatter: bool = True):
        """One full evaluation: (total, per-site, root rows; on a mesh each
        shard's). The partition's P-matrices and the CLV and scaler rows the
        path computes (all of them; the root edge's on the fused path, with
        `scatter`; none on 'repeats-dense-fused') are updated. `pmatrix`:
        the branches' P-matrices, when the caller computed them."""
        if branches is not None:
            self._set_branches(branches)
        p = self.partition
        if self._shards is not None:
            return self._shards.evaluate(self.branches, scatter)
        if self.use_fused:
            total, per, rows, p.pmatrix = _fused_loglikelihood(
                *self._args(), mxu=self.mxu, edge_params=self.edge_params,
                pmatrix=pmatrix, splits=self.fused_splits,
                **self._fused_kw())
            if scatter and not self.repeats_dense_fused:
                _scatter_root_rows(p.clv, p.scale_buffer, self.root_idx,
                                   rows)
        elif self.repeats_mode:
            total, per, p.pmatrix, rows = _repeats_loglikelihood(
                *self._repeats_args(), edge_params=self.edge_params,
                pmatrix=pmatrix, **p._modes())
        else:
            total, per, p.pmatrix, rows = _dense_loglikelihood(
                p.clv, p.scale_buffer, *self._dense_args(),
                edge_params=self.edge_params, pmatrix=pmatrix, **p._modes())
        return total, per, rows

    def _units(self) -> list:
        """The engines that hold the partition's columns: this one, or on
        a sharded partition its shards' engines in shard order."""
        return [self] if self._shards is None else self._shards.engines

    def _pmatrix(self, branches) -> torch.Tensor:
        """P [E, R, s, s] of `branches` under the engine's model."""
        m = self._model_args()
        return _pmatrices(*m[:5], m[7], branches, self.edge_params)

    def newton_step(self):
        """Evaluate + one Newton update of the root branch; returns
        (logL, d1, d2)."""
        total, d1, d2, self.branches, rows = self._newton_once()
        _write_root_rows(self._units(), rows)
        return float(total), float(d1), float(d2)

    def _newton_once(self):
        """Evaluate and one Newton update of the root branch, without
        writing the fused path's root rows back: (total, d1, d2, new
        branches, each unit's root rows). On a mesh the new branches are
        bound to every shard."""
        p = self.partition
        if self._shards is not None:
            return self._shards.newton(self.branches)
        if self.use_fused:
            total, d1, d2, branches, rows, p.pmatrix = _fused_newton_step(
                *self._args(), mxu=self.mxu, edge_params=self.edge_params,
                splits=self.fused_splits, **self._fused_kw())
            return total, d1, d2, branches, [rows]
        total, _, rows = self._evaluate()
        d1, d2, branches = _root_newton(
            rows, self.branches, self.root_idx[4], *self._model_args(),
            *self._site_args(), p.scale_threshold, **p._modes())
        return total, d1, d2, branches, [rows]

    def loglikelihood_loop(self, k: int) -> float:
        """The sum of k chained full-traversal evaluations, accumulated in
        the partition's dtype (libpll2_tpu/engine.py:1546-1568); 0.0 for k
        <= 0, with every buffer left as it was. On one card (a mesh of
        shards of one card too) the first evaluation runs eagerly and the
        next is captured once in a CUDA graph and replayed k - 1 times, one
        host sync at the end; on the CPU, across processes and across cards
        the same evaluation runs in a Python loop (`choose_loop`). The fused
        path writes the root edge's rows back once, after the loop; the
        kernels' launch counters count every iteration."""
        return chained_loglikelihood(self, k)

    def newton_loop(self, k: int):
        """k chained guarded Newton updates of the root branch, each on a
        fresh evaluation (libpll2_tpu/engine.py:1509-1544): returns the last
        iteration's (logL, d1, d2) and leaves the branches updated; (0.0,
        0.0, 0.0) for k <= 0, with the branches and every buffer left as
        they were. Runs as `loglikelihood_loop` does."""
        return chained_newton(self, k)

    # ------------------------------------------------------ candidate scoring
    def _branch_vector(self, branches, pmatrix_indices) -> np.ndarray:
        """Branch lengths in pmatrix-index order (the engine's storage
        order)."""
        blen = np.zeros(self.partition.prob_matrices)
        blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
        return blen

    def _root_params(self, root_mat: int) -> torch.Tensor:
        """The likelihood's rate-matrix indices [R] for a root edge: its
        own with `edge_params`, else the engine's."""
        if self.edge_params is None:
            return self._model_args()[7]
        return self.edge_params[root_mat]

    def evaluate_topologies(self, candidates) -> np.ndarray:
        """logL of each (operations, branches, pmatrix_indices, root)
        candidate, as `set_topology` + `loglikelihood()` would compute it
        for that topology; `root` is a node or a 5-tuple (p_clv, p_scaler,
        c_clv, c_scaler, matrix). On the fused paths every chunk of up to
        CANDIDATE_CHUNK candidates is one launch of the fused kernel; the
        op lists must then have one length, and one that
        `pack_fused_schedule` refuses sends the whole batch down the
        engine's dense path ('repeats-dense-fused': its pooled path), one
        candidate at a time. A repeats partition scores one candidate at a
        time through its pooled path. The partition's buffers, P-matrices
        and pooled layout and the engine's topology and branches are left
        as they were."""
        k = len(candidates)
        if k == 0:
            return np.zeros(0)
        if self.repeats_mode:
            return self._evaluate_topologies_pooled(candidates)
        p = self.partition
        roots = np.asarray([_root_indices(c[3]) for c in candidates])
        blens = np.stack([self._branch_vector(c[1], c[2])
                          for c in candidates])
        if self.use_fused:
            ctips = ops_fused.ctip_rows(p)
            tables, slots = [], []
            for (operations, *_), ri in zip(candidates, roots):
                table, n_slots = ops_fused.pack_fused_schedule(
                    operations, p.tips, (ri[0], ri[2]), clv_tip_rows=ctips)
                if table is None:
                    break
                tables.append(table)
                slots.append(n_slots)
            else:
                return self._score_fused(np.stack(tables), blens, roots,
                                         np.asarray(slots))
            if self.repeats_dense_fused:
                # a pooled partition has no dense buffers to fall back on
                return self._evaluate_topologies_pooled(candidates)
        return self._evaluate_topologies_dense_dev(candidates, blens,
                                                   roots).cpu().numpy()

    def _score_fused(self, tables, blens, roots, n_slots) -> np.ndarray:
        """logL of K fused candidates: op tables [K, n_ops+1, 8], branch
        vectors [K, E], roots [K, 5] and slot counts [K], a launch of the
        fused kernel a chunk of CANDIDATE_CHUNK (each chunk at its largest
        slot count); a launch a chunk a shard on a mesh."""
        return self._score_fused_dev(tables, blens, roots,
                                     n_slots).cpu().numpy()

    def _score_fused_dev(self, tables, blens, roots,
                         n_slots) -> torch.Tensor:
        """`_score_fused` without the host sync: the scores on the device."""
        if not self.use_fused:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "packed candidates need an engine on the fused "
                             "path")
        if self._shards is not None:
            return self._shards.score_fused(tables, blens, roots, n_slots)
        return torch.cat([self._score_chunk(chunk) for chunk in
                          self._candidate_chunks(tables, blens, roots,
                                                 n_slots)])

    def _candidate_chunks(self, tables, blens, roots, n_slots) -> list:
        """Fused candidates checked (`_check_candidate_tables`) and cut into
        chunks of CANDIDATE_CHUNK: (branches [k, E], op tables [k, n_ops+1,
        8], root matrices [k], on the device, the chunk's largest slot
        count and its tables' subtree splits, ops/fused.py:FusedSplits)."""
        p = self.partition
        tables = np.ascontiguousarray(tables, dtype=np.int32)
        blens = np.asarray(blens, dtype=np.float64)
        roots = np.asarray(roots, dtype=np.int64)
        k = tables.shape[0]
        if (tables.ndim != 3 or tables.shape[2] != 8
                or blens.shape != (k, p.prob_matrices)
                or roots.shape != (k, 5) or len(n_slots) != k):
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"candidates need tables [K, n_ops+1, 8], blens [K, "
                f"{p.prob_matrices}] and roots [K, 5] for one K, got "
                f"{tables.shape}, {blens.shape}, {roots.shape}")
        _check_candidate_tables(
            tables, roots, n_slots, p.tips,
            int(np.count_nonzero(p._tips_clv_set)), p.prob_matrices)
        dev = self.device
        return [(torch.as_tensor(blens[i:i + CANDIDATE_CHUNK],
                                 dtype=self.dtype, device=dev),
                 torch.as_tensor(tables[i:i + CANDIDATE_CHUNK], device=dev),
                 torch.as_tensor(roots[i:i + CANDIDATE_CHUNK, 4],
                                 device=dev),
                 int(np.max(n_slots[i:i + CANDIDATE_CHUNK])),
                 ops_fused.FusedSplits(tables[i:i + CANDIDATE_CHUNK]))
                for i in range(0, k, CANDIDATE_CHUNK)]

    def _score_chunk(self, chunk, pmatrix=None) -> torch.Tensor:
        """One launch of the fused kernel's candidate form on a chunk of
        `_candidate_chunks` (a shard's partial sums on a shard partition);
        `pmatrix` the chunk's P-matrices when the caller has them."""
        p = self.partition
        blens, tables, root_mats, n_slots, splits = (
            _on_device(x, self.device) for x in chunk)
        pw, inv = self._site_args()
        return _fused_multi_topology(
            *self._model_args(), blens, tables, self._tip_codes(), root_mats,
            pw, inv, n_slots, p.scale_threshold, p.scale_factor,
            mxu=self.mxu, edge_params=self.edge_params, pmatrix=pmatrix,
            splits=splits, **self._fused_kw())

    def _evaluate_topologies_dense_dev(self, candidates, blens,
                                       roots) -> torch.Tensor:
        """One candidate at a time through the engine's dense path
        ('levels-kernel', else 'levels' or 'scan'), each from a scratch copy
        of the partition's dense buffers; the scores on the device. On a
        mesh each candidate's plan and P-matrices are made once and every
        shard runs it from a scratch copy of its own block."""
        p = self.partition
        units = self._units()
        scratch = [(torch.empty_like(e.partition.clv),
                    torch.empty_like(e.partition.scale_buffer))
                   for e in units]
        path = self._dense_path()
        scores = [[] for _ in units]
        for (operations, *_), blen, ri in zip(candidates, blens, roots):
            operations = list(operations)
            p._check_operations(operations)
            plan = self._dense_plan(operations)
            ri = tuple(int(v) for v in ri)
            blen = torch.as_tensor(blen, dtype=self.dtype, device=self.device)
            pmatrix = units[0]._pmatrix(blen)
            for e, (clv, scaler), out in zip(units, scratch, scores):
                ep = e.partition
                clv.copy_(ep.clv)
                scaler.copy_(ep.scale_buffer)
                margs, (pw, inv) = e._model_args(), e._site_args()
                out.append(_dense_loglikelihood(
                    clv, scaler, *margs[:7], e._root_params(ri[4]),
                    blen.to(e.device), path, _on_device(plan, e.device), ri,
                    pw, inv, ep.scale_threshold, ep.scale_factor,
                    edge_params=e.edge_params,
                    pmatrix=pmatrix.to(e.device), **ep._modes())[0])
        if self._shards is None:
            return torch.stack(scores[0])
        return self._shards.reduce([torch.stack(out) for out in scores])

    def _evaluate_topologies_pooled(self, candidates) -> np.ndarray:
        """One candidate at a time over a repeats partition's pooled
        storage: each classes its op list into a new layout (class schedules
        are topology-dependent data), installed from the partition's own
        and run through the pool kernel ('pool-pallas'; its plain version
        on 'pool'). The partition's pooled buffers, layout and cached
        schedule, and so the engine's own, are restored afterwards."""
        p = self.partition
        saved = (p.clv_flat, p.sc_flat, p._flat, p._repeat_key,
                 p._repeat_schedule, p._repeat_layout)
        path = "pool-pallas" if self._pool_kernel_wanted else "pool"
        margs, (pw, inv) = self._model_args(), self._site_args()
        out = []
        try:
            for operations, branches, pmatrix_indices, root in candidates:
                ri = _root_indices(root)
                operations = list(operations)
                p._check_operations(operations)
                # from the partition's own state, into new pools
                (p.clv_flat, p.sc_flat, p._flat, p._repeat_key, _,
                 p._repeat_layout) = saved
                p._repeat_schedule = None
                plan, root_cols, mat, _ = pack_repeats(p, operations, ri)
                out.append(_repeats_loglikelihood(
                    p.clv_flat, p.sc_flat, *margs[:7], self._root_params(mat),
                    torch.as_tensor(
                        self._branch_vector(branches, pmatrix_indices),
                        dtype=self.dtype, device=self.device),
                    path, plan, root_cols, mat, pw, inv, p.scale_threshold,
                    p.scale_factor, edge_params=self.edge_params,
                    **p._modes())[0])
        finally:
            (p.clv_flat, p.sc_flat, p._flat, p._repeat_key,
             p._repeat_schedule, p._repeat_layout) = saved
        return torch.stack(out).cpu().numpy()

    def pack_candidate(self, vroot):
        """(table, blens, root_info, n_slots) of the CURRENT topology rooted
        at `vroot` (`ops/fused.py:fused_candidate_from_tree`, one walk, no
        Operation objects): the search loop's per-candidate packing for
        `evaluate_packed`. None off the fused path or when the kernel cannot
        run the topology."""
        if not self.use_fused:
            return None
        p = self.partition
        table, blens, ri, n_slots = ops_fused.fused_candidate_from_tree(
            vroot, p.tips, p.prob_matrices,
            clv_tip_rows=ops_fused.ctip_rows(p))
        if table is None:
            return None
        return table, blens, ri, n_slots

    def evaluate_packed(self, packed) -> np.ndarray:
        """logL of candidates packed by `pack_candidate`, [(table, blens,
        root_info, n_slots)]: `evaluate_topologies` without the Operation
        objects (fused path only; the tables must have one length)."""
        if len(packed) == 0:
            return np.zeros(0)
        tables, blens, roots, n_slots = zip(*packed)
        return self._score_fused(np.stack(tables), np.stack(blens),
                                 np.asarray(roots), np.asarray(n_slots))

    def evaluate_packed_arrays(self, tables, blens, roots,
                               n_slots: int) -> np.ndarray:
        """logL of candidates stacked as arrays: tables [K, n_ops+1, 8],
        blens [K, E], roots [K, 5] and the slot count every table fits in
        (`evaluate_packed` without the per-candidate list)."""
        k = len(tables)
        if k == 0:
            return np.zeros(0)
        return self._score_fused(tables, blens, roots,
                                 np.full(k, int(n_slots)))

    # ------------------------------------------------------------ model trials
    def trial_bytes(self) -> int:
        """The device bytes one trial's buffers take on 'levels-kernel' (its
        CLV rows from the trial base up and its scaler rows) and
        the pooled paths (its copy of the pools); 0 on the other paths. On
        a mesh, the first shard's."""
        if self._shards is not None:
            return self._shards.engines[0].trial_bytes()
        p = self.partition
        path = self.execution_path
        if self.use_fused:
            return 0
        if path == "levels-kernel":
            base = self._trial_rows[0]
            return ((p.clv.shape[0] - base) * p.clv[0].numel()
                    * p.clv.element_size() + p.scale_buffer.numel() * 4)
        if self.repeats_mode:
            clv_flat, sc_flat = self._repeats_args()[:2]
            return (clv_flat.numel() * clv_flat.element_size()
                    + sc_flat.numel() * 4)
        return 0

    def trial_chunk(self) -> int:
        """The trials one chunk of `_trial_loglikelihoods` takes on the
        engine's path: CANDIDATE_CHUNK on the fused paths, as many as
        TRIAL_LAUNCH_BYTES of trial buffers hold (`trial_bytes`, at least
        one) on 'levels-kernel' and the pooled paths, and 1 on the plain
        dense paths, which run the trials one after another."""
        if self._shards is not None:
            return self._shards.engines[0].trial_chunk()
        if self.use_fused:
            return CANDIDATE_CHUNK
        per = self.trial_bytes()
        return max(1, TRIAL_LAUNCH_BYTES // per) if per else 1

    def _trial_loglikelihoods(self, eigen_k, freqs_k, traversal=None,
                              level=None) -> torch.Tensor:
        """logL [K] of K trial models on the engine's topology, branches and
        execution path (libpll2_tpu/optimize.py:292-327 `eval_one`):
        `eigen_k` = (eigenvals [K, M, s], evecs [K, M, s, s], inv_evecs [K,
        M, s, s]) and `freqs_k` [K, M, s], in the partition's dtype on its
        device; p-inv, category rates and weights are the partition's. The
        trials go in chunks of `trial_chunk()`: on 'fused' and
        'repeats-dense-fused' a chunk is one launch of the candidate form
        (`_fused_trials`); on 'levels-kernel' one launch of the level
        kernel's trial form a level (`_level_trials`); on 'pool-pallas' one
        launch of the pool kernel's trial form a traversal at 4x4, a level
        otherwise (`_pool_trials`), and on 'pool' one call of its plain
        version a level. The plain dense paths run the trials one after
        another, each from a scratch copy of the partition's dense buffers.
        The partition's buffers stay as they were. `traversal` and
        `level` replace the path's kernel wrapper (its plain version, which
        takes the trial form too, for a comparison on the card). No host
        sync. On a mesh the trials run once a shard (each shard's chunks
        one launch, or one a level), and the [K] sums are reduced (JAX maps
        single meshed evaluations over the trials,
        libpll2_tpu/optimize.py:355-358; the numbers are the same)."""
        if self._shards is not None:
            return self._shards.trials(self.branches, eigen_k, freqs_k,
                                       traversal, level)
        w_k, evecs_k, ivecs_k = eigen_k
        k = w_k.shape[0]
        path = self.execution_path
        if self.use_fused or path == "levels-kernel" or self.repeats_mode:
            if self.use_fused:
                run = functools.partial(self._fused_trial_chunk,
                                        traversal=traversal)
            elif path == "levels-kernel":
                run = functools.partial(self._level_trials, level=level)
            else:
                run = functools.partial(
                    self._pool_trials, level=ops_pool.pool_update_reference
                    if path == "pool" else level)
            chunk = self.trial_chunk()
            return torch.cat([run(w_k[i:i + chunk], ivecs_k[i:i + chunk],
                                  evecs_k[i:i + chunk], freqs_k[i:i + chunk])
                              for i in range(0, k, chunk)])
        p = self.partition
        margs = self._model_args()
        prop_invar, rates, rate_weights, pidx = (margs[3], margs[4],
                                                 margs[5], margs[7])
        pw, inv = self._site_args()
        kw = {} if level is None else {"level": level}
        bufs = (p.clv, p.scale_buffer)
        scratch = tuple(torch.empty_like(b) for b in bufs)
        out = []
        for i in range(k):
            for dst, src in zip(scratch, bufs):
                dst.copy_(src)
            out.append(_dense_loglikelihood(
                *scratch, w_k[i], ivecs_k[i], evecs_k[i], prop_invar, rates,
                rate_weights, freqs_k[i], pidx, self.branches, path,
                self._ops, self.root_idx, pw, inv, p.scale_threshold,
                p.scale_factor, edge_params=self.edge_params, **kw,
                **p._modes())[0])
        return torch.stack(out)

    def _fused_trial_chunk(self, w_k, ivecs_k, evecs_k, freqs_k,
                           traversal=None) -> torch.Tensor:
        """One chunk of trials on the fused paths: one launch of the
        candidate form (`_fused_trials`)."""
        p = self.partition
        margs = self._model_args()
        pw, inv = self._site_args()
        return _fused_trials(
            w_k, ivecs_k, evecs_k, margs[3], margs[4], margs[5], freqs_k,
            margs[7], self.branches, self.table, self._tip_codes(),
            self.root_idx[4], pw, inv, self.fused_slots, p.scale_threshold,
            p.scale_factor, traversal=traversal or ops_fused.fused_traversal,
            mxu=self.mxu, edge_params=self.edge_params,
            tip_clvs=self._tip_clvs(), **p._modes())

    def _trial_pmatrices(self, w_k, ivecs_k, evecs_k):
        """P [K, E, R, s, s] of K trial eigensystems on the engine's
        branches (per edge with `edge_params`), and the root edge's rate
        matrix index per category."""
        margs = self._model_args()
        pidx = margs[7] if self.edge_params is None else self.edge_params
        pmat = ops_pmatrix.update_prob_matrices_trials(
            w_k, ivecs_k, evecs_k, margs[3], margs[4], pidx, self.branches)
        root_pidx = (margs[7] if self.edge_params is None
                     else self.edge_params[self.root_idx[4]])
        return pmat, root_pidx

    def _trial_epilogue(self, rows, pmat, freqs_k, root_pidx):
        """The K root edges' logL [K] from their rows (parent and child
        CLVs [K, R, s, S], counts [K, (R,) S])."""
        p = self.partition
        margs = self._model_args()
        pw, inv = self._site_args()
        return ops_likelihood.edge_loglikelihood_candidates(
            *rows, pmat[:, self.root_idx[4]], freqs_k, margs[3], margs[5],
            root_pidx, pw, inv, p.scale_threshold, **p._modes())

    def _level_trial_buffers(self, k: int):
        """(CLV rows [k, N+1-base, R, s, S], scaler rows [k, K+2, (R,) S],
        the shared rows [base, R, s, S] or None) of k trials on
        'levels-kernel': the rows `_trial_rows` names copied from the
        partition's buffers (one broadcast copy each), the others left to
        the traversal."""
        p = self.partition
        base, rows, sc_rows = self._trial_rows
        clv = torch.empty((k, p.clv.shape[0] - base) + p.clv.shape[1:],
                          dtype=p.clv.dtype, device=self.device)
        sc = torch.empty((k,) + p.scale_buffer.shape, dtype=torch.int32,
                         device=self.device)
        if rows.size:
            idx = torch.as_tensor(rows, device=self.device)
            clv[:, idx - base] = p.clv[idx]
        if sc_rows.size:
            idx = torch.as_tensor(sc_rows, device=self.device)
            sc[:, idx] = p.scale_buffer[idx]
        return clv, sc, (p.clv[:base] if base else None)

    def _pool_trial_buffers(self, k: int):
        """(pools [k, R, s, T], scaler pools [k, (R,) T2]) of k trials on
        'pool-pallas': the partition's, one broadcast copy each (after
        repacking a stale schedule)."""
        clv_flat, sc_flat = self._repeats_args()[:2]
        return (clv_flat.expand(k, *clv_flat.shape).contiguous(),
                sc_flat.expand(k, *sc_flat.shape).contiguous())

    def _level_trials(self, w_k, ivecs_k, evecs_k, freqs_k,
                      level=None) -> torch.Tensor:
        """One chunk of trials on 'levels-kernel': each trial's P, inner
        rows and scaler rows (the rows `_trial_rows` names copied from the
        partition's buffers, the tips read from them in place), every level
        one call of `level` (the wrapper: one launch of the level kernel's
        trial form) for the whole chunk, then the root edges' likelihoods
        in one batch."""
        p = self.partition
        pmat, root_pidx = self._trial_pmatrices(w_k, ivecs_k, evecs_k)
        k = pmat.shape[0]
        base = self._trial_rows[0]
        clv, sc, tips = self._level_trial_buffers(k)
        with annotate("pll.partials.trials"):
            ops_levels.update_partials_kernel(
                clv, sc, pmat, self._ops, p.scale_threshold, p.scale_factor,
                level=level, tips=tips)
        p_clv, p_sc, c_clv, c_sc, _ = self.root_idx
        zero = p.scale_buffer.shape[0] - 1   # a missing scaler reads it

        def row(i):
            return (clv[:, i - base] if i >= base
                    else p.clv[i].expand(k, *p.clv.shape[1:]))

        return self._trial_epilogue(
            (row(p_clv), row(c_clv), sc[:, p_sc if p_sc >= 0 else zero],
             sc[:, c_sc if c_sc >= 0 else zero]), pmat, freqs_k, root_pidx)

    def _pool_trials(self, w_k, ivecs_k, evecs_k, freqs_k,
                     level=None) -> torch.Tensor:
        """One chunk of trials on the pooled paths: each trial's P and its
        copy of the pools (one broadcast copy for the chunk), the plan run
        once for the whole chunk (one launch of the pool kernel's trial form
        a traversal at 4x4, a level otherwise; `level`, the plain version on
        'pool', a level at a time), then the root edges' likelihoods in one
        batch."""
        p = self.partition
        pmat, root_pidx = self._trial_pmatrices(w_k, ivecs_k, evecs_k)
        pool, sc = self._pool_trial_buffers(pmat.shape[0])
        with annotate("pll.partials.repeats.trials"):
            ops_pool.update_partials_pool(pool, sc, pmat, self._ops,
                                          p.scale_threshold, p.scale_factor,
                                          level=level)
        p_cols, p_sc_cols, c_cols, c_sc_cols = self._root_cols
        return self._trial_epilogue(
            (pool[..., p_cols], pool[..., c_cols], sc[..., p_sc_cols],
             sc[..., c_sc_cols]), pmat, freqs_k, root_pidx)

    def site_rate_posteriors(self):
        """Empirical-Bayes per-site rate-category posteriors and
        posterior-mean site rates across the root edge. Returns (posteriors
        [R+1, sites_padded], site_rates [sites_padded]) as numpy arrays;
        the last category is the +I invariant class (all-zero when pinv =
        0). On a mesh each shard's, concatenated in shard order."""
        p = self.partition
        if self._shards is not None:
            self._shards.bind(self.branches)
            post = [e.site_rate_posteriors() for e in self._shards.engines]
            return (np.concatenate([a for a, _ in post], axis=-1),
                    np.concatenate([b for _, b in post], axis=-1))
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
