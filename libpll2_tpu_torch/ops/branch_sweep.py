"""All-branches Newton smoothing over the dense buffers, in PyTorch.

Port of libpll2_tpu/ops/branch_sweep.py. The reference's clients optimize
branch lengths by walking the tree and, per edge, calling
pll_update_sumtable and a few Newton iterations of
pll_compute_likelihood_derivatives, updating CLVs as the walk reorients
(reference: examples/newton/newton.c:31-100 applied tree-wide;
src/derivatives.c:239,333):

  pass = full postorder refresh (down CLVs with the current lengths)
         + a pre-order edge walk; per step ONE CLV update -- either the
           "up" CLV of the next edge (the parent side's up CLV with the
           sibling's down CLV) or, on leaving a subtree, the refreshed
           "down" CLV of the node left (the reference's newview-on-return)
           -- then one sumtable, `iterations` Newton updates and the
           P-matrix of the new length (exit steps run a harmless dummy
           optimization into a scratch branch slot);
  sweep = `passes` such passes, then a last postorder refresh.

Directional ("up") CLVs live in auxiliary rows appended to the partition's
CLV and scaler buffers; a host-side stack allocator bounds them at O(depth)
rows (an aux row dies when the walk leaves its subtree).

Where JAX compiles the sweep into one program, the port runs each step's
CLV op as a one-op level of the level kernel (ops/levels.py:level_update,
csrc/level_update.cu on the card, its plain version on the CPU) and each
postorder refresh through the same kernel a level at a time. The step
tables are packed once, as one device tensor; the sumtable, Newton updates
and P refresh are plain tensor ops with no host sync between them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..utils.profiling import annotate
from . import derivatives as ops_derivatives
from . import levels as ops_levels
from . import pmatrix as ops_pmatrix

__all__ = ["AUX", "build_smoothing_schedule", "step_tables", "newton_sweep",
           "newton_sweep_shards"]

AUX = 1 << 20      # schedule-builder sentinel offset for aux rows


def build_smoothing_schedule(tree, n_nodes: int, scale_buffers: int,
                             n_matrices: int):
    """Pre-order edge walk with one CLV op per step.

    Returns (steps [n_steps, 13] int32, n_aux). Columns:
      0  up/refresh-CLV write row   1  its scaler write row
      2  c1 clv row   3 c1 matrix   4 c1 scaler row
      5  c2 clv row   6 c2 matrix   7 c2 scaler row
      8  edge child clv row    9  edge child scaler row
      10 edge parent-side clv row  11 parent-side scaler row
      12 edge pmatrix index (== n_matrices for dummy/exit steps: those
         optimize a scratch branch slot, results discarded)
    Row indices address the COMBINED buffers: clv rows [0, n_nodes] are the
    partition's (incl. scratch at n_nodes), aux rows start at n_nodes+1;
    scaler rows [0, scale_buffers) are the partition's, aux rows at
    scale_buffers+k, then the trash and guaranteed-zero rows last.
    Carried over from libpll2_tpu (its tables `==` these)."""
    steps = []
    free_aux: list = []
    n_aux = 0

    def new_aux():
        nonlocal n_aux
        if free_aux:
            return free_aux.pop()
        k = n_aux
        n_aux += 1
        return k

    def sc(idx):
        return idx if idx >= 0 else -1           # -1 -> zero row (patched)

    DUMMY_EDGE = [0, -1, 0, -1, n_matrices]      # tip CLVs, zero scalers

    def recurse(u, parent_mat, pside_clv, pside_sc):
        """u: the half-edge of the current node pointing to the parent
        side; the edge above u is already optimized."""
        if u.is_tip():
            return
        h1, h2 = u.next, u.next.next
        for hc, hsib in ((h1, h2), (h2, h1)):
            aux = new_aux()
            steps.append([
                AUX + aux, AUX + aux,
                pside_clv, parent_mat, sc(pside_sc),
                hsib.back.clv_index, hsib.pmatrix_index,
                sc(hsib.back.scaler_index),
                hc.back.clv_index, sc(hc.back.scaler_index),
                AUX + aux, AUX + aux,
                hc.pmatrix_index,
            ])
            recurse(hc.back, hc.pmatrix_index, AUX + aux, AUX + aux)
            free_aux.append(aux)
        # exit refresh: recompute u's down CLV from its (now fresh)
        # children so later siblings/ancestors read updated values
        steps.append([
            u.clv_index, sc(u.scaler_index),
            h1.back.clv_index, h1.pmatrix_index, sc(h1.back.scaler_index),
            h2.back.clv_index, h2.pmatrix_index, sc(h2.back.scaler_index),
            *DUMMY_EDGE,
        ])

    r = tree.vroot
    # root edge first: both sides are standard down CLVs; the step's CLV
    # op refreshes r's own CLV (a no-op repeat of the postorder, harmless)
    steps.append([
        r.clv_index, sc(r.scaler_index),
        r.next.back.clv_index, r.next.pmatrix_index,
        sc(r.next.back.scaler_index),
        r.next.next.back.clv_index, r.next.next.pmatrix_index,
        sc(r.next.next.back.scaler_index),
        r.clv_index, sc(r.scaler_index),
        r.back.clv_index, sc(r.back.scaler_index),
        r.pmatrix_index,
    ])
    recurse(r.back, r.pmatrix_index, r.clv_index, r.scaler_index)
    recurse(r, r.pmatrix_index, r.back.clv_index, r.back.scaler_index)

    arr = np.asarray(steps, dtype=np.int64)
    zero_sc = scale_buffers + n_aux + 1

    def fix_clv(v):
        return n_nodes + 1 + (v - AUX) if v >= AUX else v

    def fix_sc(v):
        if v >= AUX:
            return scale_buffers + (v - AUX)
        if v == -1:
            return zero_sc
        return v

    out = np.zeros_like(arr, dtype=np.int32)
    for col in (0, 2, 5, 8, 10):
        out[:, col] = [fix_clv(v) for v in arr[:, col]]
    for col in (1, 4, 7, 9, 11):
        out[:, col] = [fix_sc(v) for v in arr[:, col]]
    for col in (3, 6, 12):
        out[:, col] = arr[:, col]
    return out, n_aux


def step_tables(steps: np.ndarray, device) -> tuple:
    """Each step's CLV op as a one-op level table [9, 1] of the level kernel
    (ops/levels.py's rows; it always rescales, as JAX's step does), all in
    one int32 tensor on `device`: one host-to-device copy for the sweep."""
    t = np.stack([steps[:, 0], steps[:, 2], steps[:, 5], steps[:, 3],
                  steps[:, 6], steps[:, 4], steps[:, 7], steps[:, 1],
                  np.ones(len(steps), dtype=np.int32)]).astype(np.int32)
    return ops_levels.tables_to_device(np.split(t, len(steps), axis=1),
                                       device)


def newton_sweep(clv, scaler, pmatrix, branches,
                 eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                 rates, rate_weights, freqs, params_idx_rates,
                 tables,                  # the postorder's level tables
                 steps,                   # [n_steps, 13] int32 (numpy)
                 pattern_weights, invariant,
                 scale_threshold: float, scale_factor: float,
                 passes: int = 2, iterations: int = 8, n_aux: int = 0,
                 asc_type: int = C.AB_NONE, n_real: int = -1,
                 level=None):
    """Multi-pass all-edges Newton smoothing (libpll2_tpu/ops/branch_sweep.py
    :144 `newton_sweep`).

    `clv` [N+1, R, s, S] and `scaler` [K+2, S] are the partition's buffers
    (read, not written); `tables` the postorder's level tables for the
    combined buffers (`pack_pallas_levels` with trash row K + n_aux and
    zero row K + n_aux + 1, on the device); `steps` the schedule of
    `build_smoothing_schedule`. Each step's CLV op and every postorder
    level run through `level` (by default ops/levels.py:level_for: the
    dispatching wrapper, or the plain version for float64 buffers; or the
    plain version for a comparison on the card). A scaler buffer with a
    rate axis is read as JAX reads it: every decision is per site (the step
    and the postorder rescale a site when all its rates and states
    underflow) and every count the same for all rates, broadcast back on
    return.

    Returns (branches, pmatrix, clv, scaler) with every edge optimized
    `passes` times; clv and scaler partition-shaped (aux rows stripped),
    refreshed with the final lengths."""
    branches, pmatrix, blocks = newton_sweep_shards(
        [(clv, scaler, pattern_weights, invariant, None)], None, pmatrix,
        branches, eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        rate_weights, freqs, params_idx_rates, tables, steps,
        scale_threshold, scale_factor, passes=passes, iterations=iterations,
        n_aux=n_aux, asc_type=asc_type, n_real=n_real, level=level)
    return (branches, pmatrix) + blocks[0]


class _Block:
    """One column block's combined buffers ([partition rows | aux rows];
    the scaler keeps its trash/zero rows LAST) and site data, on its
    device."""

    def __init__(self, clv, scaler, pattern_weights, invariant, col0,
                 n_aux: int):
        self.per_rate = scaler.dim() == 3
        self.shape = scaler.shape
        sc0 = scaler[:, 0] if self.per_rate else scaler
        k = sc0.shape[0] - 2
        self.clv = torch.cat([clv, clv.new_zeros((n_aux,) + clv.shape[1:])])
        self.sc = torch.cat([sc0[:k], sc0.new_zeros((n_aux,) + sc0.shape[1:]),
                             sc0[k:]])
        self.clv2d = self.clv.view(self.clv.shape[0], -1, self.clv.shape[-1])
        self.pw, self.inv, self.col0 = pattern_weights, invariant, col0
        self.device = clv.device
        self.sumtable = self.asc_scalers = None

    def result(self, n_nodes: int, k: int, n_aux: int):
        """(clv, scaler) partition-shaped: aux rows stripped."""
        sc = torch.cat([self.sc[:k], self.sc[k + n_aux:]])
        if self.per_rate:
            sc = sc[:, None, :].expand(self.shape).contiguous()
        return self.clv[:n_nodes + 1], sc


def newton_sweep_shards(blocks, mesh, pmatrix, branches,
                        eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                        rates, rate_weights, freqs, params_idx_rates,
                        tables, steps, scale_threshold: float,
                        scale_factor: float, passes: int = 2,
                        iterations: int = 8, n_aux: int = 0,
                        asc_type: int = C.AB_NONE, n_real: int = -1,
                        level=None):
    """`newton_sweep` over column blocks: `blocks` holds (clv, scaler,
    pattern_weights, invariant, col0) a block, in shard order: one whole
    partition (col0 None, `mesh` None) or the shards of a site mesh that
    this process owns (col0 each block's first column). Every CLV op and
    sumtable runs once a block, on its device; on a mesh each Newton
    update takes the d1 and d2 summed over the shards
    (parallel/sharding.py:psum, JAX's psums) and updates the replicated
    branch and P-matrix, which every block then reads. The model tensors,
    `pmatrix`, `branches` and `tables` lie on the first block's device.
    Returns (branches, pmatrix, [(clv, scaler) a block])."""
    from ..parallel.sharding import psum

    level = level or ops_levels.level_for(blocks[0][0])
    n_nodes = blocks[0][0].shape[0] - 1
    k = blocks[0][1].shape[0] - 2
    rates_n, states = blocks[0][0].shape[1], blocks[0][0].shape[2]
    bufs = [_Block(*b, n_aux) for b in blocks]
    # scratch branch slot absorbs the dummy optimizations of exit steps
    branches_p = torch.cat([branches, branches.new_zeros(1)])
    pmatrix_p = torch.cat([pmatrix, pmatrix.new_zeros((1,) + pmatrix.shape[1:])])
    model = (eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
             rate_weights, freqs, params_idx_rates)
    placed = {}
    for b in bufs:
        if b.device not in placed:
            placed[b.device] = (step_tables(steps, b.device),
                                tuple(t.to(b.device) for t in tables),
                                tuple(m.to(b.device) for m in model))
    edges = [tuple(int(v) for v in row[8:13]) for row in steps]

    def refresh():
        with annotate("sweep.postorder"):
            for b in bufs:
                ops_levels.update_partials_kernel(
                    b.clv, b.sc, pmatrix_p.to(b.device), placed[b.device][1],
                    scale_threshold, scale_factor, level=level)

    def derivatives(b, blen):
        ev, _, _, pinv, r, rw, f, pidx = placed[b.device][2]
        return ops_derivatives.likelihood_derivatives(
            b.sumtable, ev, pinv, f, r, rw, pidx, b.pw, b.inv,
            blen.to(b.device), asc_scalers=b.asc_scalers,
            scale_threshold=scale_threshold, asc_type=asc_type,
            n_real=n_real, col0=b.col0)

    for _ in range(passes):
        refresh()
        for i, (e_c, e_csc, e_p, e_psc, mat) in enumerate(edges):
            for b in bufs:
                st_tables, _, (_, ivecs, evecs, _, _, _, f, pidx) = \
                    placed[b.device]
                with annotate("sweep.upclv"):
                    level(b.clv2d, b.sc, pmatrix_p.to(b.device), st_tables[i],
                          rates_n, states, scale_threshold, scale_factor)
                with annotate("sweep.sumtable"):
                    b.sumtable = ops_derivatives.update_sumtable(
                        b.clv[e_p], b.clv[e_c], b.sc[e_psc], b.sc[e_csc],
                        ivecs, evecs, f, pidx, scale_threshold,
                        rate_scalers=False, has_pscaler=True,
                        has_cscaler=True)
                if asc_type in (C.AB_LEWIS, C.AB_FELSENSTEIN):
                    b.asc_scalers = b.sc[e_psc] + b.sc[e_csc]
            blen = branches_p[mat]
            with annotate("sweep.newton"):
                for _ in range(iterations):
                    if mesh is None:
                        d1, d2 = derivatives(bufs[0], blen)
                    else:
                        d1, d2 = ops_derivatives.derivatives_total(
                            psum([derivatives(b, blen) for b in bufs], mesh),
                            asc_type)
                    blen = ops_derivatives.newton_step(
                        blen, d1, d2, C.OPT_MIN_BRANCH_LEN,
                        C.OPT_MAX_BRANCH_LEN)
            branches_p[mat] = blen
            with annotate("sweep.pmatrix"):
                pmatrix_p[mat] = ops_pmatrix.update_prob_matrices(
                    eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
                    params_idx_rates, blen[None])[0]
    # final refresh with the optimized lengths so that the returned CLVs and
    # scalers are consistent with `branches`
    refresh()
    return (branches_p[:-1], pmatrix_p[:-1],
            [b.result(n_nodes, k, n_aux) for b in bufs])
