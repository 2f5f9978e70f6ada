"""Streamed NNI/SPR scoring from directional CLVs, in PyTorch.

Port of libpll2_tpu/ops/spr_stream.py (the reference's partial-traversal
pattern, libpll-2 test/src/partial-traversal.c, src/utree_moves.c:119-255).
A batched round re-runs a full postorder a candidate; this module scores
every candidate of a round from three precomputed pieces instead:

  1. directional CLVs D[h] for every half-edge h of the current tree (down
     CLVs = the ordinary postorder; up CLVs = one extra op per edge, into
     aux rows);
  2. per prune point, corrected CLVs A[t] for each regraft target t within
     the radius: the directional CLV at t's near side in the remaining tree
     (prune node excised, its two other edges merged at summed length, as
     moves.spr relinks them), one pruning op each;
  3. per candidate (p, t): the regraft splits t's branch in half, so

        parent = (P(t.len/2) @ A[t]) * (P(t.len/2) @ D[t.back])
        logL   = edge_loglikelihood(parent, D[p.back], P(p.length))

     with the scaler counts of the three rows plus the parent product's own
     underflow event. An NNI candidate composes two such products across
     the central edge from the baseline directional CLVs alone (no pass 2).

Host half (numpy, carried over, its tables `==` JAX's): `pack_waves` and
the builders (`build_spr_stream`, `build_spr_stream_native` over the native
library, `build_nni_stream`, `enumerate_targets`) emit JAX's padded tables:
[L, WAVE_W, 8] op rows a pass (post, up, A), wave counts rounded to buckets
of 4, candidate rows and merged-edge lengths padded to powers of two, over
one address space (partition rows | n_aux up rows | n_arows A rows |
scratch; scalers likewise, then trash and zero rows).

Device half (`nni_stream_scores`, `spr_stream_scores`): the three passes
run through ops/levels.py:level_for, the CUDA level kernel for float32
CUDA tensors and its plain version for CPU tensors and float64 ones (JAX
runs XLA's update_partials_levels). Each wave's valid slots become one
[9, w] level table (`pass_tables`); padded slots and empty waves launch
nothing. The kernel writes in place, so a wave in which one op reads a row
another op of the wave writes would not give JAX's result (JAX gathers a
wave before it scatters it): `pass_tables` refuses such a wave; the
builders never emit one. The extended
buffers hold the real rows only: the pow2-padded A rows and the scratch row
are not allocated, and the padded zero-scaler row is mapped onto the
compact one. The per-candidate compose and the edge-logL epilogue stay
plain PyTorch, `chunk` candidates at a time, through the batched epilogue
of ops/likelihood.py (`edge_loglikelihood_candidates`, which computes
JAX's `_site_totals`); only the `n_candidates` real candidates are scored.

Eligibility (search.py falls back to the batched rounds otherwise): per-site
or per-rate scalers, homogeneous models; site repeats stream through a
dense tip-row base (`Partition.dense_tip_rows`); ascertainment corrections
ride the passes as ordinary columns. On a site mesh (`mesh=`) the passes
and the candidates run once a shard on its column block, and the [C]
scores are summed over the shards (asc and repeats stream on one device
only, as in JAX). Per-edge heterotachy is excluded by
design: merged and half SPR edges have no well-defined rate matrix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from . import levels as ops_levels
from . import pmatrix as ops_pmatrix
from .likelihood import edge_loglikelihood_candidates
from .partials import Operations, _rescale

__all__ = ["WAVE_W", "pack_waves", "build_spr_stream_native",
           "ops_from_table", "enumerate_targets", "SprStreamSchedule",
           "build_spr_stream", "build_nni_stream", "pass_tables",
           "wave_conflicts", "StreamBuffers", "stream_passes",
           "nni_stream_scores",
           "spr_stream_scores"]

WAVE_W = 256          # op slots a wave


def _bucket(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def _pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def pack_waves(rows: Sequence[Sequence[int]], deps: Sequence[int],
               scratch_clv: int, width: int = WAVE_W,
               wave_bucket: int = 4, min_waves: int = 0):
    """Greedy wavefront packing of op rows into [L, W] level tables.

    rows: 8-int op rows (update_partials_levels format); deps[i] lists
    the indices of the ops whose outputs op i consumes (possibly empty).
    An op lands in the earliest non-full wave strictly after ALL of its
    dependencies — op-index order says nothing about wave order (a deep
    child produced early can sit in a later wave than a shallow child
    produced late), so every dependency must be consulted. Returns
    (table [L, W, 8] np.int32, valid [L, W] bool).
    """
    n = len(rows)
    wave_of = np.empty(n, np.int64)
    fills: List[int] = []
    for i in range(n):
        w = 0
        for d in deps[i]:
            if d >= 0:
                w = max(w, wave_of[d] + 1)
        while w < len(fills) and fills[w] >= width:
            w += 1
        while w >= len(fills):
            fills.append(0)
        wave_of[i] = w
        fills[w] += 1
    L = _bucket(max(len(fills), min_waves, 1), wave_bucket)
    table = np.zeros((L, width, 8), np.int32)
    table[:, :, 0] = scratch_clv
    table[:, :, 1] = -1
    valid = np.zeros((L, width), bool)
    cursor = np.zeros(L, np.int64)
    for i in range(n):
        w = wave_of[i]
        k = cursor[w]
        table[w, k] = rows[i]
        valid[w, k] = True
        cursor[w] = k + 1
    return table, valid


class _LazyPairs:
    """(prune, target) UNode pairs materialized on access — a round only
    inspects the few top-ranked candidates of the ~10^4-entry list."""

    def __init__(self, prune_ids, tgt_ids, node_of):
        self._p, self._t, self._nodes = prune_ids, tgt_ids, node_of

    def __len__(self):
        return len(self._p)

    def __getitem__(self, i):
        return self._nodes[self._p[i]], self._nodes[self._t[i]]


def _scatter_table(rows: np.ndarray, wave: np.ndarray, scratch: int,
                   width: int, min_waves_val: int, wave_bucket: int = 4):
    """Vectorized assembly of a [L, W, 8] level table from dense rows +
    native greedy wave assignments (pack_waves' layout: within-wave
    order = creation order)."""
    n = rows.shape[0]
    n_waves = int(wave.max()) + 1 if n else 1
    L = _bucket(max(n_waves, min_waves_val, 1), wave_bucket)
    table = np.zeros((L, width, 8), np.int32)
    table[:, :, 0] = scratch
    table[:, :, 1] = -1
    valid = np.zeros((L, width), bool)
    if n:
        order = np.argsort(wave, kind="stable")
        w = wave[order]
        pos = np.arange(n) - np.searchsorted(w, w)
        table[w, pos] = rows[order]
        valid[w, pos] = True
    return table, valid


def build_spr_stream_native(tree, radius: int, n_nodes: int,
                            n_scalers: int, n_edges: int,
                            max_candidates=None, rng=None,
                            width: int = WAVE_W, min_waves=None):
    """Whole-round schedule via the native builder
    (native/pllnative.cpp pll_tpu_spr_stream_{enum,build}): target
    enumeration, directional/postorder/corrected row emission and greedy
    wave assignment run in C++ over flat half-edge arrays; numpy
    scatters the tables and applies the pow2/zero-scaler padding. Rows,
    waves and candidate order are bit-identical to build_spr_stream;
    rng subsampling stays host-side for stream parity with the batched
    rounds. Returns None without the native library (callers fall back
    to the Python builder)."""
    from .. import native
    if native.load() is None:
        return None
    from ..search import _flatten_tree
    back, nxt, clv, scaler, pmat, length, node_of, ids = \
        _flatten_tree(tree)
    T = tree.tip_count
    vr = tree.vroot
    if vr.next is None:
        vr = vr.back
    enum = native.spr_stream_enum(back, nxt, T, radius)
    if enum is None:
        return None
    prune, goff, tgt, tpar, tsib = enum
    sizes = np.diff(goff)
    # the subsampling below consumes `rng`; if the native build fails
    # after that, restore the generator state so the caller's Python
    # fallback re-draws the SAME subsets (stream parity with the batched
    # rounds)
    rng_state = rng.bit_generator.state if rng is not None else None
    if not max_candidates:
        # full round: kept = every target in order, per group
        kept = (np.arange(goff[-1], dtype=np.int64)
                - np.repeat(goff[:-1], sizes)).astype(np.int32)
        kept_off = goff.copy()
    else:
        kept_chunks = []
        for sz in sizes:
            sz = int(sz)
            if sz > max_candidates:
                kept_chunks.append(np.asarray(
                    rng.permutation(sz)[:max_candidates], np.int32))
            else:
                kept_chunks.append(np.arange(sz, dtype=np.int32))
        kept = (np.concatenate(kept_chunks) if kept_chunks
                else np.zeros(0, np.int32))
        kept_off = np.zeros(len(sizes) + 1, np.int64)
        if kept_chunks:
            np.cumsum([len(c) for c in kept_chunks], out=kept_off[1:])
    res = native.spr_stream_build(
        back, nxt, clv, scaler, pmat, length, T, ids[id(vr)], width,
        prune, goff, tgt, tpar, tsib, kept, kept_off,
        n_nodes, n_scalers, n_edges)
    if res is None:
        if rng_state is not None:
            rng.bit_generator.state = rng_state
        return None

    n_a = res["a_rows"].shape[0]
    n_aux = res["n_aux"]
    n_arows = _pow2(max(n_a, 1))
    scratch = n_nodes + n_aux + n_arows
    zero_sc = n_scalers + n_aux + n_arows + 1
    mw = min_waves or {}

    def fix(rows):
        rows = rows.copy()
        for col in (4, 7):
            rows[:, col] = np.where(rows[:, col] < 0, zero_sc,
                                    rows[:, col])
        return rows

    post_table, post_valid = _scatter_table(
        fix(res["post_rows"]), res["post_wave"], scratch, width,
        mw.get("post", 0))
    up_table, up_valid = _scatter_table(
        fix(res["up_rows"]), res["up_wave"], scratch, width,
        mw.get("up", 0))
    a_table, a_valid = _scatter_table(
        fix(res["a_rows"]), res["a_wave"], scratch, width,
        mw.get("a", 0))

    n_candidates = res["cand"].shape[0]
    Cp = _pow2(max(n_candidates, 1))
    cand_arr = np.zeros((Cp, 7), np.int32)
    hl = np.zeros(Cp)
    if n_candidates:
        cand_arr[:n_candidates] = res["cand"]
        cand_arr[n_candidates:] = res["cand"][-1]
        hl[:n_candidates] = res["half_len"]
        hl[n_candidates:] = res["half_len"][-1]
    cand_arr[:, (1, 3, 5)] = np.where(cand_arr[:, (1, 3, 5)] < 0,
                                      zero_sc, cand_arr[:, (1, 3, 5)])
    nm = res["merged_len"].shape[0]
    ml = np.zeros(_pow2(max(nm, 1)))
    ml[:nm] = res["merged_len"]
    blen_full = np.zeros(n_edges)
    linked = back >= 0
    blen_full[pmat[linked]] = length[linked]
    pairs = _LazyPairs(res["pair_prune"], res["pair_tgt"], node_of)
    return SprStreamSchedule(
        post_table=post_table, post_valid=post_valid,
        up_table=up_table, up_valid=up_valid,
        a_table=a_table, a_valid=a_valid,
        cand_rows=cand_arr, half_len=hl, blen_full=blen_full,
        merged_len=ml, n_candidates=n_candidates, n_aux=n_aux,
        n_arows=n_arows, pairs=pairs,
        rowmap=(ids, res["rowmap_clv"], res["rowmap_sc"]))


def ops_from_table(table: np.ndarray) -> Operations:
    """A [L, W, 8] level table as Operations of [L, W] numpy columns."""
    t = np.asarray(table)
    return Operations(*(np.ascontiguousarray(t[:, :, k]) for k in range(8)))


def enumerate_targets(p, radius: int):
    """Regraft targets within `radius` of the prune half-edge p, in the
    same DFS order and target set as search._radius_targets. Returns
    [(t, arrival_key, sibling)]: t points AWAY from the prune site;
    arrival_key is id() of the half-edge by which the walk entered t's
    node (p.next / p.next.next at depth 1, else the previous target);
    sibling is the node's third half-edge."""
    out = []
    stack = []
    for h in (p.next, p.next.next):
        if h.back is not None:
            stack.append((h.back, h, 1))
    while stack:
        nd, entry, d = stack.pop()
        if nd.is_tip() or d >= radius:
            continue
        for h, sib in ((nd.next, nd.next.next), (nd.next.next, nd.next)):
            if h.back is None:
                continue
            out.append((h, id(entry), sib))
            stack.append((h.back, h, d + 1))
    return out


@dataclass
class SprStreamSchedule:
    """Host-built tables for one streamed SPR round (all numpy)."""
    post_table: np.ndarray        # [Lp, W, 8] postorder refresh
    post_valid: np.ndarray
    up_table: np.ndarray          # [Lu, W, 8] directional up pass
    up_valid: np.ndarray
    a_table: np.ndarray           # [La, W, 8] corrected-CLV pass
    a_valid: np.ndarray
    cand_rows: np.ndarray         # [C, 7] a_row, a_sc, rb_row, rb_sc,
    #                                      pb_row, pb_sc, score_pm
    half_len: np.ndarray          # [C] regraft half lengths
    blen_full: np.ndarray         # [E] current branch length per pmatrix
    merged_len: np.ndarray        # [P] per-prune merged edge length
    n_candidates: int             # real candidates (<= C, rest padding)
    n_aux: int
    n_arows: int
    # indexable of (prune_halfedge, target_halfedge) pairs: a plain list
    # from the Python builder, a _LazyPairs view from the native one
    pairs: Sequence[Tuple]
    # Python builder: {id(halfedge): (clv_row, sc_row)}; native builder:
    # (ids, rowmap_clv, rowmap_sc) flat arrays — consumers type-sniff
    # (see build_nni_stream's `entry`)
    rowmap: "dict | tuple"


def build_spr_stream(tree, prune_targets, n_nodes: int, n_scalers: int,
                     n_edges: int, width: int = WAVE_W,
                     min_waves=None) -> SprStreamSchedule:
    """Build one round's tables from (prune half-edge, targets[, kept])
    groups.

    `prune_targets`: [(p, [(t, arrival_key, sibling), ...])] as produced
    by enumerate_targets — p's node plus the subtree at p.back is what
    moves.spr(p, t) prunes. An optional third group element lists the
    target indices to emit as candidates (subsampled rounds); corrected
    CLVs are then built only along the ancestor chains of kept targets.
    Row address space: [0, n_nodes) partition CLV rows, then n_aux up
    rows, then n_arows A rows, then one scratch row; scaler rows follow
    the same layout after the partition's n_scalers rows, with the trash
    and guaranteed-zero rows last.
    """
    vroot = tree.vroot
    if vroot.next is None:
        vroot = vroot.back
    vback = vroot.back

    base_aux = n_nodes
    sc_aux = n_scalers
    rowmap = {}          # id(halfedge) -> (clv_row, sc_row or -1)

    def down_entry(h):
        sc = h.scaler_index
        return (h.clv_index, sc if sc is not None and sc >= 0 else -1)

    blen_full = np.zeros(n_edges)
    for node in tree.nodes():
        halves = [node] if node.is_tip() else list(node.ring())
        for h in halves:
            if h.back is not None:
                blen_full[h.pmatrix_index] = h.length or 0.0

    up_rows: List[List[int]] = []
    up_deps: List[int] = []
    n_aux = 0

    def new_aux():
        nonlocal n_aux
        k = n_aux
        n_aux += 1
        return base_aux + k, sc_aux + k

    rowmap[id(vroot)] = down_entry(vroot)
    rowmap[id(vback)] = down_entry(vback)

    def recurse(u, parent_mat, pside_row, pside_sc, pside_op):
        """u: half-edge of the current node toward the parent side;
        (pside_row, pside_sc) hold D[toward-parent direction] seen from
        this node; pside_op is the up-op index producing it (-1 when it
        is a postorder row). Iterative to survive 1000-taxon
        caterpillars (CPython recursion limit)."""
        stack = [(u, parent_mat, pside_row, pside_sc, pside_op)]
        while stack:
            u, parent_mat, pside_row, pside_sc, pside_op = stack.pop()
            rowmap[id(u)] = down_entry(u)
            if u.is_tip():
                continue
            for hc, hsib in ((u.next, u.next.next),
                             (u.next.next, u.next)):
                crow, csc = new_aux()
                rowmap[id(hc)] = (crow, csc)
                sib_row, sib_sc = down_entry(hsib.back)
                up_rows.append([crow, csc,
                                pside_row, parent_mat, pside_sc,
                                sib_row, hsib.pmatrix_index, sib_sc])
                up_deps.append([pside_op])
                stack.append((hc.back, hc.pmatrix_index, crow, csc,
                              len(up_rows) - 1))

    rmat = vroot.pmatrix_index
    recurse(vback, rmat, *down_entry(vroot), -1)
    recurse(vroot, rmat, *down_entry(vback), -1)

    # postorder refresh of the down rows
    from ..trees.utree import create_operations, traverse
    operations, _, _ = create_operations(traverse(tree.vroot))
    post_rows, post_deps = [], []
    producer = {}
    for op in operations:
        post_rows.append([op.parent_clv_index, op.parent_scaler_index,
                          op.child1_clv_index, op.child1_matrix_index,
                          op.child1_scaler_index, op.child2_clv_index,
                          op.child2_matrix_index, op.child2_scaler_index])
        post_deps.append([producer.get(op.child1_clv_index, -1),
                          producer.get(op.child2_clv_index, -1)])
        producer[op.parent_clv_index] = len(post_rows) - 1

    # corrected-CLV (A) pass + candidate rows, per prune group
    a_rows: List[List[int]] = []
    a_deps: List[int] = []
    cand: List[List[int]] = []
    half_len: List[float] = []
    merged_len: List[float] = []
    pairs: List[Tuple] = []
    base_a = base_aux + n_aux
    sc_a = sc_aux + n_aux

    for group in prune_targets:
        p, targets = group[0], group[1]
        kept = group[2] if len(group) > 2 else None
        if not targets or (kept is not None and len(kept) == 0):
            continue
        if kept is not None:
            # a kept target needs the corrected CLVs of its whole
            # ancestor chain back to the prune site
            tix = {id(t): i for i, (t, _, _) in enumerate(targets)}
            needed = set()
            for i in kept:
                cur = i
                while cur is not None and cur not in needed:
                    needed.add(cur)
                    cur = tix.get(targets[cur][1])
        merged_len.append((p.next.back.length or 0.0)
                          + (p.next.next.back.length or 0.0))
        mi = n_edges + len(merged_len) - 1        # merged pmatrix index
        pb_row, pb_sc = rowmap[id(p.back)]
        # per-node arrival state keyed by the half-edge the walk entered
        # through: (clv_row, sc_row, pmatrix index, producing a-op)
        arrive = {id(p.next): (*rowmap[id(p.next.next.back)], mi, -1),
                  id(p.next.next): (*rowmap[id(p.next.back)], mi, -1)}
        slot_of = {}
        for i, (t, akey, sib) in enumerate(targets):
            if kept is not None and i not in needed:
                continue
            x_row, x_sc, gmat, gop = arrive[akey]
            sib_row, sib_sc = rowmap[id(sib.back)]
            k = len(a_rows)
            arow, asc = base_a + k, sc_a + k
            a_rows.append([arow, asc, x_row, gmat, x_sc,
                           sib_row, sib.pmatrix_index, sib_sc])
            a_deps.append([gop])
            arrive[id(t)] = (arow, asc, t.pmatrix_index, k)
            slot_of[i] = (arow, asc)
        for i in (range(len(targets)) if kept is None else kept):
            t, akey, sib = targets[i]
            arow, asc = slot_of[i]
            rb_row, rb_sc = rowmap[id(t.back)]
            cand.append([arow, asc, rb_row, rb_sc, pb_row, pb_sc,
                         p.pmatrix_index])
            half_len.append((t.length or 0.0) / 2.0)
            pairs.append((p, t))

    n_candidates = len(cand)
    n_arows = _pow2(max(len(a_rows), 1))
    scratch = base_a + n_arows
    zero_sc = sc_a + n_arows + 1                 # trash, zero rows last

    def fix_sc(rows):
        for r in rows:
            for col in (4, 7):
                if r[col] < 0:
                    r[col] = zero_sc
        return rows

    # wave counts follow the tree's depth; `min_waves` floors (callers
    # carry the historical max) keep the table shapes monotone, as JAX's
    # builder does
    mw = min_waves or {}
    post_table, post_valid = pack_waves(fix_sc(post_rows), post_deps,
                                        scratch, width,
                                        min_waves=mw.get("post", 0))
    up_table, up_valid = pack_waves(fix_sc(up_rows), up_deps, scratch,
                                    width, min_waves=mw.get("up", 0))
    a_table, a_valid = pack_waves(fix_sc(a_rows), a_deps, scratch, width,
                                  min_waves=mw.get("a", 0))

    Cp = _pow2(max(n_candidates, 1))
    cand_arr = np.zeros((Cp, 7), np.int32)
    hl = np.zeros(Cp)
    if n_candidates:
        cand_arr[:n_candidates] = cand
        cand_arr[n_candidates:] = cand[-1]   # pad: repeats the last
        hl[:n_candidates] = half_len
        hl[n_candidates:] = half_len[-1] if half_len else 0.0
    cand_arr[:, (1, 3, 5)] = np.where(cand_arr[:, (1, 3, 5)] < 0,
                                      zero_sc, cand_arr[:, (1, 3, 5)])
    # merged pmatrix count pads to a power of two, as in JAX (pad entries
    # are computed-but-unreferenced identity-at-0 matrices)
    ml = np.zeros(_pow2(max(len(merged_len), 1)))
    ml[:len(merged_len)] = merged_len
    return SprStreamSchedule(
        post_table=post_table, post_valid=post_valid,
        up_table=up_table, up_valid=up_valid,
        a_table=a_table, a_valid=a_valid,
        cand_rows=cand_arr, half_len=hl, blen_full=blen_full,
        merged_len=ml,
        n_candidates=n_candidates, n_aux=n_aux, n_arows=n_arows,
        pairs=pairs, rowmap=rowmap)


def build_nni_stream(tree, edges, n_nodes: int, n_scalers: int,
                     n_edges: int, width: int = WAVE_W, min_waves=None):
    """NNI analog of build_spr_stream: both alternatives of every
    internal edge scored from BASELINE directional CLVs only (an NNI
    swaps two subtrees across an edge; all four flanking directional
    CLVs are unchanged, and moves._swap keeps each branch with its
    node-side stub). Returns a SprStreamSchedule whose cand_rows are
    [C, 13]:

      [c_row, c_sc, c_pm, b_row, b_sc, b_pm,
       a_row, a_sc, a_pm, d_row, d_sc, d_pm, center_pm]

    scoring parent = (P[c_pm] @ D[C]) * (P[b_pm] @ D[B]) at p's node and
    child = (P[a_pm] @ D[A]) * (P[d_pm] @ D[D]) at q's node, across the
    central edge — exactly what moves.nni + a full evaluation computes.
    Its `pairs` list (edge, move_type) aligned with the candidate rows.
    """
    sched = build_spr_stream_native(tree, 0, n_nodes, n_scalers,
                                    n_edges, width=width,
                                    min_waves=min_waves)
    if sched is None:
        sched = build_spr_stream(tree, [], n_nodes, n_scalers, n_edges,
                                 width=width, min_waves=min_waves)
    rowmap = sched.rowmap
    zero_sc = n_scalers + sched.n_aux + sched.n_arows + 1

    if isinstance(rowmap, dict):
        def entry(h):
            row, sc = rowmap[id(h)]
            return row, (sc if sc >= 0 else zero_sc)
    else:                      # native: (ids, rowmap_clv, rowmap_sc)
        ids, rm_clv, rm_sc = rowmap

        def entry(h):
            hid = ids[id(h)]
            sc = int(rm_sc[hid])
            return int(rm_clv[hid]), (sc if sc >= 0 else zero_sc)

    cand: List[List[int]] = []
    mv: List[Tuple] = []
    for p in edges:
        q = p.back
        a = p.next            # subtree1 stub (swapped in both moves)
        b = p.next.next
        for kind, t2 in ((C.UTREE_MOVE_NNI_LEFT, q.next),
                         (C.UTREE_MOVE_NNI_RIGHT, q.next.next)):
            d = q.next.next if t2 is q.next else q.next
            c_row, c_sc = entry(t2.back)
            b_row, b_sc = entry(b.back)
            a_row, a_sc = entry(a.back)
            d_row, d_sc = entry(d.back)
            cand.append([c_row, c_sc, t2.pmatrix_index,
                         b_row, b_sc, b.pmatrix_index,
                         a_row, a_sc, a.pmatrix_index,
                         d_row, d_sc, d.pmatrix_index,
                         p.pmatrix_index])
            mv.append((p, kind))
    n_candidates = len(cand)
    Cp = _pow2(max(n_candidates, 1))
    cand_arr = np.zeros((Cp, 13), np.int32)
    if n_candidates:
        cand_arr[:n_candidates] = cand
        cand_arr[n_candidates:] = cand[-1]
    sched.cand_rows = cand_arr
    sched.n_candidates = n_candidates
    sched.pairs = mv
    return sched


# ------------------------------------------------------------- device half
def _check_range(what: str, idx: np.ndarray, limit: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= limit):
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         f"streamed schedule: {what} index out of range "
                         f"[0, {limit}): {int(idx.min())}..{int(idx.max())}")


def _level_table(rows: np.ndarray, trash: int) -> np.ndarray:
    """op rows [w, 8] (update_partials_levels order) -> the level kernel's
    [9, w] table (ops/levels.py): a parent scaler of -1 writes `trash`
    without rescaling."""
    has = rows[:, 1] >= 0
    return np.stack([rows[:, 0], rows[:, 2], rows[:, 5], rows[:, 3],
                     rows[:, 6], rows[:, 4], rows[:, 7],
                     np.where(has, rows[:, 1], trash),
                     has.astype(np.int32)]).astype(np.int32)


def wave_conflicts(t: np.ndarray):
    """The ops of one level table [9, w] that an in-place launch would race
    on: (read-after-write pairs (i, j), op j reads a row op i writes;
    write-write pairs (i, j), i < j, both write one row), over CLV rows and
    real scaler rows (the trash row, which ops without a scaler write, is
    never read). Both empty for every wave the builders emit."""
    parent, c1, c2 = t[0], t[1], t[2]
    s1, s2, psc, has = t[5], t[6], t[7], t[8] > 0
    raw, waw = set(), set()
    for writes, reads, hit in ((parent, (c1, c2), np.ones_like(has)),
                               (psc, (s1, s2), has)):
        w_rows = writes[hit]
        if (np.intersect1d(w_rows, np.concatenate(reads)).size == 0
                and np.unique(w_rows).size == w_rows.size):
            continue
        for i in np.flatnonzero(hit):
            for r in reads:
                raw.update((int(i), int(j))
                           for j in np.flatnonzero(r == writes[i]) if j != i)
            waw.update((int(i), int(j)) for j in
                       np.flatnonzero(hit & (writes == writes[i])) if j > i)
    return sorted(raw), sorted(waw)


def pass_tables(table: np.ndarray, valid: np.ndarray, trash: int,
                zero_pad: int, zero: int) -> List[np.ndarray]:
    """One pass's [L, W, 8] padded table as the level kernel's [9, w]
    tables, one a wave: only the valid slots, empty waves dropped; scaler
    reads of the padded layout's zero row `zero_pad` go to the compact
    `zero`, and parents without a scaler write `trash`. Raises PllError for
    a wave that would race in place (`wave_conflicts`)."""
    out = []
    for lv in range(table.shape[0]):
        rows = table[lv][valid[lv]]          # a copy: boolean indexing
        if rows.shape[0] == 0:
            continue
        for col in (4, 7):
            rows[:, col] = np.where(rows[:, col] == zero_pad, zero,
                                    rows[:, col])
        t = _level_table(rows, trash)
        raw, waw = wave_conflicts(t)
        if raw or waw:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"streamed schedule: wave {lv} reads a row "
                             f"another of its ops writes {raw} or writes "
                             f"one row twice {waw}")
        out.append(t)
    return out


def _extend_buffers(clv, scaler, n_aux: int, n_a: int, base=None,
                    rate_cats: int = 0, rate_scalers: bool = False):
    """Extended buffers: partition rows | n_aux up rows | n_a A rows (CLV)
    and partition rows | aux | A | trash | zero (scalers).

    With `base=(n_rows, n_scaler_rows)` the `clv` operand is DENSE TIP
    ROWS [tips, states, S] of a pooled site-repeats partition (which has
    no dense per-site buffers) and `scaler` is ignored: tips broadcast over
    `rate_cats`, inner rows and scalers zero, which is sufficient because
    the postorder pass rebuilds every inner row and scaler (only tip rows
    carry information into the streamed scoring)."""
    extra = n_aux + n_a
    if base is not None:
        n_rows, n_sc = base
        T, s, S = clv.shape
        clv_ext = torch.zeros((n_rows + extra, rate_cats, s, S),
                              dtype=clv.dtype, device=clv.device)
        clv_ext[:T] = clv[:, None]
        sc_shape = ((n_sc + extra + 2, rate_cats, S) if rate_scalers
                    else (n_sc + extra + 2, S))
        return clv_ext, torch.zeros(sc_shape, dtype=torch.int32,
                                    device=clv.device)
    K = scaler.shape[0] - 2
    clv_ext = torch.cat([clv, clv.new_zeros((extra,) + clv.shape[1:])])
    sc_ext = torch.cat([scaler[:K],
                        scaler.new_zeros((extra + 2,) + scaler.shape[1:])])
    return clv_ext, sc_ext


class StreamBuffers(NamedTuple):
    """The extended buffers after the streamed passes, the level tables
    that ran (one a wave, on the buffers' device), and the
    padded layout's zero-scaler row with the compact one it maps to."""
    clv: torch.Tensor             # [rows + n_aux + n_a, R, s, S]
    scaler: torch.Tensor          # [K + n_aux + n_a + 2, (R,) S] int32
    tables: tuple                 # [9, w] int32 views
    zero_pad: int
    zero: int


def stream_passes(clv, scaler, pm, passes, n_aux: int, n_arows: int,
                  scale_threshold: float, scale_factor: float, base=None,
                  rate_scalers: bool = False) -> StreamBuffers:
    """The streamed passes over new extended buffers: `passes` is a
    sequence of (table [L, W, 8], valid [L, W]) in the builders' padded
    address space (post, up[, A]), `pm` the P-matrices they index ([E, ...]
    or [E + merged, ...]). Every index is checked on the host; each wave's
    level table then runs through ops/levels.py:level_for (the level
    kernel for float32 CUDA tensors, its plain version for CPU tensors and
    float64 ones). The passes
    write every row they read after writing it, so running `tables` again
    over the buffers gives the same buffers."""
    n_rows = base[0] if base is not None else clv.shape[0]
    n_sc = base[1] if base is not None else scaler.shape[0] - 2
    writes = [t[v][:, 0] for t, v in passes]
    top = max((int(w.max()) + 1 for w in writes if w.size), default=0)
    n_a = max(top - n_rows - n_aux, 0)
    rates = pm.shape[1]
    clv_ext, sc_ext = _extend_buffers(clv, scaler, n_aux, n_a, base=base,
                                      rate_cats=rates,
                                      rate_scalers=rate_scalers)
    trash, zero = sc_ext.shape[0] - 2, sc_ext.shape[0] - 1
    zero_pad = n_sc + n_aux + n_arows + 1
    tables = []
    for table, valid in passes:
        tables += pass_tables(table, valid, trash, zero_pad, zero)
    for t in tables:
        _check_range("CLV", t[0:3], clv_ext.shape[0])
        _check_range("matrix", t[3:5], pm.shape[0])
        _check_range("scaler", t[5:8], sc_ext.shape[0])
    tables = ops_levels.tables_to_device(tables, clv.device)
    ops_levels.update_partials_kernel(clv_ext, sc_ext, pm, tables,
                                      scale_threshold, scale_factor)
    return StreamBuffers(clv_ext, sc_ext, tables, zero_pad, zero)


def _candidates(cand_rows, n_candidates, sc_cols, zero_pad: int, zero: int,
                clv_rows: int, sc_rows: int, mat_cols, n_mats: int,
                device) -> torch.Tensor:
    """The real candidate rows on the device, scaler columns mapped to the
    compact zero row, every index checked."""
    rows = np.array(cand_rows[:n_candidates], dtype=np.int64)
    rows[:, sc_cols] = np.where(rows[:, sc_cols] == zero_pad, zero,
                                rows[:, sc_cols])
    clv_cols = [c for c in range(rows.shape[1])
                if c not in sc_cols and c not in mat_cols]
    _check_range("candidate CLV", rows[:, clv_cols], clv_rows)
    _check_range("candidate scaler", rows[:, sc_cols], sc_rows)
    _check_range("candidate matrix", rows[:, mat_cols], n_mats)
    return torch.as_tensor(rows, device=device)


def _compose(clv_ext, sc_ext, pm1, x1, s1, pm2, x2, s2,
             scale_threshold: float, scale_factor: float,
             rate_scalers: bool):
    """(P1 @ D[x1]) * (P2 @ D[x2]) for a chunk of candidates, with the
    underflow check a real traversal applies at this node; returns (x,
    counts)."""
    x = (torch.einsum('crij,crjs->cris', pm1, clv_ext[x1])
         * torch.einsum('crij,crjs->cris', pm2, clv_ext[x2]))
    x, mask = _rescale(x, scale_threshold, scale_factor, rate_scalers,
                       state_dim=2)
    return x, sc_ext[s1] + sc_ext[s2] + mask


def _over_shards(score, mesh, clv, scaler, pattern_weights, invariant,
                 model):
    """A streamed scorer under a site mesh (JAX's shard_map body,
    libpll2_tpu/ops/spr_stream.py:871-885, 932-947): `clv`, `scaler`,
    `pattern_weights` and `invariant` hold one block a shard this process
    owns; `score(clv, scaler, model, pw, inv)` runs the passes and the
    candidates on one shard with the replicated `model` tensors moved to
    its device, and the shards' [C] scores are reduced with
    parallel/sharding.py:psum."""
    from ..parallel.sharding import psum
    return psum([score(c, sc, [m.to(c.device) for m in model],
                       pw.to(c.device), inv.to(c.device))
                 for c, sc, pw, inv in zip(clv, scaler, pattern_weights,
                                           invariant)], mesh)


def nni_stream_scores(clv, scaler,
                      eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                      rates, rate_weights, freqs, params_idx_rates,
                      post_ops, post_valid, up_ops, up_valid,
                      blen_full, cand_rows,      # [C, 13] int32
                      pattern_weights, invariant,
                      scale_threshold: float, scale_factor: float,
                      n_aux: int, n_arows: int, chunk: int = 256,
                      mesh=None, rate_scalers: bool = False,
                      base=None, asc_type: int = 0, n_real: int = -1,
                      n_candidates=None):
    """logL [n_candidates] of a round's NNI candidates (directional CLVs
    only, no corrected pass): the post and up passes through the level
    kernel (`stream_passes`), then the candidates `chunk` at a time. `n_candidates` (default: every row of
    `cand_rows`) is the real candidates, the rows past it padding that is
    not scored. With `base=(n_rows, n_scaler_rows)` the clv operand is the
    dense tip rows of a pooled site-repeats partition (`_extend_buffers`).
    With `mesh` (a site-sharded partition) `clv`, `scaler`,
    `pattern_weights` and `invariant` hold one block a shard, the passes
    run once a shard and the scores are summed over the shards
    (`_over_shards`).
    """
    if mesh is not None:
        return _over_shards(
            lambda c, sc, m, pw, inv: nni_stream_scores(
                c, sc, *m, post_ops, post_valid, up_ops, up_valid,
                blen_full, cand_rows, pw, inv, scale_threshold,
                scale_factor, n_aux, n_arows, chunk=chunk,
                rate_scalers=rate_scalers, base=base, asc_type=asc_type,
                n_real=n_real, n_candidates=n_candidates),
            mesh, clv, scaler, pattern_weights, invariant,
            (eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
             rate_weights, freqs, params_idx_rates))
    n = len(cand_rows) if n_candidates is None else int(n_candidates)
    pm_full = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, torch.as_tensor(blen_full, device=clv.device))
    clv_ext, sc_ext, _, zero_pad, zero = stream_passes(
        clv, scaler, pm_full,
        [(np.stack(post_ops, axis=-1), np.asarray(post_valid)),
         (np.stack(up_ops, axis=-1), np.asarray(up_valid))],
        n_aux, n_arows, scale_threshold, scale_factor, base=base,
        rate_scalers=rate_scalers)
    rows = _candidates(cand_rows, n, [1, 4, 7, 10], zero_pad, zero,
                       clv_ext.shape[0], sc_ext.shape[0],
                       [2, 5, 8, 11, 12], pm_full.shape[0], clv.device)
    out = []
    for c0 in range(0, n, chunk):
        r = rows[c0:c0 + chunk]
        parent, psc = _compose(clv_ext, sc_ext, pm_full[r[:, 2]], r[:, 0],
                               r[:, 1], pm_full[r[:, 5]], r[:, 3], r[:, 4],
                               scale_threshold, scale_factor, rate_scalers)
        child, csc = _compose(clv_ext, sc_ext, pm_full[r[:, 8]], r[:, 6],
                              r[:, 7], pm_full[r[:, 11]], r[:, 9], r[:, 10],
                              scale_threshold, scale_factor, rate_scalers)
        out.append(edge_loglikelihood_candidates(
            parent, child, psc, csc, pm_full[r[:, 12]], freqs, prop_invar,
            rate_weights, params_idx_rates, pattern_weights, invariant,
            scale_threshold, rate_scalers=rate_scalers, asc_type=asc_type,
            n_real=n_real))
    return torch.cat(out) if out else clv.new_zeros(0)


def spr_stream_scores(clv, scaler,
                      eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                      rates, rate_weights, freqs, params_idx_rates,
                      post_ops, post_valid, up_ops, up_valid,
                      a_ops, a_valid,
                      blen_full, merged_len, half_len,
                      cand_rows,               # [C, 7] int32
                      pattern_weights, invariant,
                      scale_threshold: float, scale_factor: float,
                      n_aux: int, n_arows: int, chunk: int = 256,
                      mesh=None, rate_scalers: bool = False,
                      base=None, asc_type: int = 0, n_real: int = -1,
                      n_candidates=None):
    """logL [n_candidates] of a streamed SPR round's candidates: the post,
    up and corrected (A) passes through the level kernel
    (`stream_passes`) over P-matrices [E + merged] (the merged edges'
    after the tree's), then each candidate's regraft product at the half
    lengths and its edge logL, `chunk` candidates at a time.
    `n_candidates`, `base` and `mesh` as in `nni_stream_scores`."""
    if mesh is not None:
        return _over_shards(
            lambda c, sc, m, pw, inv: spr_stream_scores(
                c, sc, *m, post_ops, post_valid, up_ops, up_valid, a_ops,
                a_valid, blen_full, merged_len, half_len, cand_rows, pw,
                inv, scale_threshold, scale_factor, n_aux, n_arows,
                chunk=chunk, rate_scalers=rate_scalers, base=base,
                asc_type=asc_type, n_real=n_real,
                n_candidates=n_candidates),
            mesh, clv, scaler, pattern_weights, invariant,
            (eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
             rate_weights, freqs, params_idx_rates))
    n = len(cand_rows) if n_candidates is None else int(n_candidates)
    dev = clv.device

    def pmats(lengths):
        return ops_pmatrix.update_prob_matrices(
            eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
            params_idx_rates, torch.as_tensor(lengths, device=dev))

    pm_full = pmats(blen_full)
    pm_ext = torch.cat([pm_full, pmats(merged_len)])
    pm_half = pmats(np.asarray(half_len)[:n])
    clv_ext, sc_ext, _, zero_pad, zero = stream_passes(
        clv, scaler, pm_ext,
        [(np.stack(post_ops, axis=-1), np.asarray(post_valid)),
         (np.stack(up_ops, axis=-1), np.asarray(up_valid)),
         (np.stack(a_ops, axis=-1), np.asarray(a_valid))],
        n_aux, n_arows, scale_threshold, scale_factor, base=base,
        rate_scalers=rate_scalers)
    rows = _candidates(cand_rows, n, [1, 3, 5], zero_pad, zero,
                       clv_ext.shape[0], sc_ext.shape[0], [6],
                       pm_full.shape[0], dev)
    out = []
    for c0 in range(0, n, chunk):
        r, ph = rows[c0:c0 + chunk], pm_half[c0:c0 + chunk]
        # the regraft node's own underflow event (a real traversal scales
        # this product like any other op; per rate in per-rate mode)
        cm, csc = _compose(clv_ext, sc_ext, ph, r[:, 0], r[:, 1], ph,
                           r[:, 2], r[:, 3], scale_threshold, scale_factor,
                           rate_scalers)
        out.append(edge_loglikelihood_candidates(
            cm, clv_ext[r[:, 4]], csc, sc_ext[r[:, 5]], pm_full[r[:, 6]],
            freqs, prop_invar, rate_weights, params_idx_rates,
            pattern_weights, invariant, scale_threshold,
            rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real))
    return torch.cat(out) if out else clv.new_zeros(0)
