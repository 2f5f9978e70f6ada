"""The certified final evaluation, in IEEE float64.

Port of libpll2_tpu/ops/df64.py. The TPU has no float64, so JAX carries
every number of its certified evaluation as an unevaluated pair of float32
values (double-single: error-free sums and products, a double-single log, a
2^-16 scaling window that keeps the low halves normal) and holds it to 1e-8
of float64 (gate case `dna_df64`). The H100 computes in IEEE float64, so the
port keeps the function and its scope and computes it in plain float64
instead of porting the pair arithmetic:

  * P-matrices are built on the host in float64 (`pmatrix_host64`, the
    same `expm1` form as JAX's `_pmatrix_host64`) and uploaded as they are,
    not split into pairs;
  * the whole postorder runs through `ops/fused.py:fused_traversal_f64`:
    on the card csrc/fused_traversal.cu's runtime-size walk instantiated in
    float64, on the CPU its plain version; tips are the partition's state
    codes, and raw rows in float64 for tips set with `set_tip_clv`;
  * sites are rescaled with float64's own window (`SCALE_THRESHOLD` /
    `SCALE_FACTOR`, 2^-256 / 2^256), only at ops that own a scaler row; the
    factors are powers of two, so the logL does not depend on the window
    beyond rounding;
  * the root edge's logL is `ops/likelihood.py:edge_loglikelihood` on
    float64 tensors, summed with the pattern weights in float64.

The partition stays float32 (or float64 on the CPU), as in JAX: only the
evaluation runs in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..partition import pack_level_operations
from ..trees import create_operations, traverse
from . import fused as ops_fused
from . import likelihood as ops_likelihood
from . import partials as ops_partials

__all__ = ["loglikelihood_df64", "pmatrix_host64", "walk_inputs"]


def pmatrix_host64(eigenvals, inv_evecs, evecs, prop_invar, rates,
                   params_index: int, branch_lengths) -> np.ndarray:
    """Reference-semantics P(t) [E, R, s, s] in host numpy float64 (mirror
    of ops/pmatrix.update_prob_matrices; reference core_pmatrix.c:189-231),
    as libpll2_tpu/ops/df64.py:_pmatrix_host64 builds it, without the split
    into float32 pairs."""
    lam = np.asarray(eigenvals[params_index], np.float64)       # [s]
    a = np.asarray(inv_evecs[params_index], np.float64)         # [s, s]
    b = np.asarray(evecs[params_index], np.float64)
    pinv = float(prop_invar[params_index])
    if pinv <= C.MISC_EPSILON:
        pinv = 0.0
    t = np.asarray(branch_lengths, np.float64)                  # [E]
    rates = np.asarray(rates, np.float64)                       # [R]
    expo = (lam[None, :] * (rates / (1.0 - pinv))[:, None]
            )[None, :, :] * t[:, None, None]                    # [E, R, s]
    expd = np.expm1(expo)
    left = a[None, None] * expd[:, :, None, :]
    pm = np.einsum('erjm,mk->erjk', left, b)
    pm = pm + np.eye(lam.shape[0])
    ident = np.broadcast_to(np.eye(lam.shape[0]), pm.shape)
    return np.where((t <= 0.0)[:, None, None, None], ident, pm)


def walk_inputs(partition, tree, operations, branches, pmatrix_indices,
                params_index: int = 0) -> dict:
    """The keyword arguments of `ops/fused.py:fused_traversal_f64` for the
    postorder `operations` (with `branches` on `pmatrix_indices`) of `tree`
    rooted at its vroot, on the partition's device: state codes, P-matrices
    from `pmatrix_host64` and the raw tip rows in float64, the op table
    packed onto slots, float64's scaling window."""
    p = partition
    root = tree.vroot
    table, n_slots = ops_fused.pack_fused_schedule(
        operations, p.tips, (root.clv_index, root.back.clv_index),
        ops_fused.ctip_rows(p))
    if table is None:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "loglikelihood_df64: the tree's operations are "
                         "not a postorder of the partition's tips")
    blen = np.zeros(p.prob_matrices)
    blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
    p._ensure_eigen([params_index])
    f64, dev = torch.float64, p.device
    pmatrix = torch.as_tensor(
        pmatrix_host64(p.eigenvals, p.inv_eigenvecs, p.eigenvecs,
                       p.prop_invar, p.rates, params_index, blen),
        dtype=f64).to(dev)
    tip_clvs = ops_fused.tip_clv_matrix(p)
    if tip_clvs is not None:
        tip_clvs = tip_clvs.to(f64).contiguous()
    return dict(tip_codes=torch.as_tensor(ops_fused.tip_code_matrix(p),
                                          device=dev),
                pmatrix=pmatrix, table=torch.as_tensor(table, device=dev),
                rates=p.rate_cats, states=p.states, n_slots=n_slots,
                threshold=C.SCALE_THRESHOLD, factor=C.SCALE_FACTOR,
                tip_clvs=tip_clvs)


def _levels_f64(p, tree, operations, pmatrix):
    """The root edge's rows (parent and child CLVs, their counts) of the
    postorder `operations` in float64 through the plain level path
    (ops/partials.py:update_partials_levels), with float64's window: for
    alphabets above ops/fused.py:FUSED_MAX_STATES, whose 64-bit tip states
    the float64 walk's 32-bit tip codes cannot carry. JAX's df64 evaluation
    is XLA, not a Pallas kernel, and reads the same dense tip rows."""
    f64, dev = torch.float64, p.device
    clv = torch.zeros((p.nodes + 1, p.rate_cats, p.states, p.sites_padded),
                      dtype=f64, device=dev)
    clv[:p.tips] = p.dense_tip_rows().to(f64)[:, None]
    scaler = torch.zeros((p.scale_buffers + 2, p.sites_padded),
                         dtype=torch.int32, device=dev)
    ops, valid = pack_level_operations(operations, p.tips,
                                       scratch_clv=p.nodes, device=dev)
    ops_partials.update_partials_levels(clv, scaler, pmatrix, ops, valid,
                                        C.SCALE_THRESHOLD, C.SCALE_FACTOR)
    r = tree.vroot
    return (clv[r.clv_index], clv[r.back.clv_index], scaler[r.scaler_index],
            scaler[r.back.scaler_index])


def loglikelihood_df64(partition, tree, params_index: int = 0) -> float:
    """Certified final evaluation: full-tree edge logL of `tree` on a DENSE
    partition, computed on the partition's device in float64 end to end
    (host-float64 P-matrices, float64 CLV pruning in one launch of
    `fused_traversal_f64`, or above 32 states the plain float64 level path,
    float64 per-site logs and sum). Budget: 1e-8 of a float64 evaluation
    on the CPU (gate case `dna_df64`).

    Scope, JAX's (raise PllError otherwise): no site repeats (dense rows),
    no asc bias, pinv == 0, per-site scalers, homogeneous model, and a
    scaler row on every inner node."""
    p = partition
    if (p.repeats is not None or p.asc_bias != C.AscBias.NONE
            or p.rate_scalers
            or float(np.max(np.asarray(p.prop_invar))) > 0.0):
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "loglikelihood_df64 covers dense partitions with per-site "
            "scalers, no asc bias and pinv == 0 (the certification "
            "scope); use the fp32 paths for other configurations")
    operations, branches, pidx = create_operations(traverse(tree.vroot))
    # JAX refuses op lists with a scaler-less inner node, because its 2^-16
    # window would drop their counts; float64's window would not, but the
    # port refuses what JAX refuses
    vr_sc = tree.vroot.scaler_index
    if any(op.parent_scaler_index is None or op.parent_scaler_index < 0
           for op in operations) or vr_sc is None or vr_sc < 0:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "loglikelihood_df64 needs a scaler row on every inner node "
            "(the certified path's aggressive scaling cannot thread "
            "counts through SCALE_BUFFER_NONE parents)")
    walk = walk_inputs(p, tree, operations, branches, pidx, params_index)
    if p.states > ops_fused.FUSED_MAX_STATES:
        clv_p, clv_c, sc_p, sc_c = _levels_f64(p, tree, operations,
                                               walk["pmatrix"])
    else:
        clv_p, clv_c, sc_p, sc_c = ops_fused.fused_traversal_f64(**walk)
    f64, dev = torch.float64, p.device
    total, _ = ops_likelihood.edge_loglikelihood(
        clv_p, clv_c, sc_p, sc_c, walk["pmatrix"][tree.vroot.pmatrix_index],
        torch.as_tensor(p.frequencies, dtype=f64, device=dev),
        torch.zeros(p.rate_matrices, dtype=f64, device=dev),
        torch.as_tensor(p.rate_weights, dtype=f64, device=dev),
        torch.full((p.rate_cats,), params_index, dtype=torch.long,
                   device=dev),
        torch.as_tensor(p.pattern_weights, device=dev),
        torch.as_tensor(p.invariant, dtype=torch.long, device=dev),
        C.SCALE_THRESHOLD)
    return float(total)
