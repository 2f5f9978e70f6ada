"""Phylogenetic placement: query sequences onto a fixed reference tree.

Port of libpll2_tpu/placement.py. The EPA pattern (EPA-ng is a flagship
consumer of the reference): for a query sequence, try attaching it to EVERY
edge of the reference tree and report the per-edge log-likelihoods and
likelihood weight ratios (LWR).

Method: each edge (u, v) of length L is split at its midpoint by a new
inner node carrying the query as a pendant tip (length `pendant_length`),
the standard EPA attachment heuristic. Branch lengths are not re-optimized
per candidate (EPA-ng's fast heuristic mode).

Three scorers:
  * `place`: one query through `TreeEngine.evaluate_topologies`, one
    candidate per attachment edge (on the fused path a launch of the fused
    kernel's candidate form a chunk of 128 edges);
  * `place_batch`: a chunk of queries against every edge in ONE launch of
    the fused kernel's query form (ops/fused.py: each query's codes stand
    in for tip row `query_row`), split along the edges where the launch's
    root rows and spill slots would pass `ops/fused.py:QUERY_LAUNCH_BYTES`;
    then the root edges' likelihoods of all (query, edge) walks at once.
    Off the fused path, `place` a query at a time;
  * `place_stream`: EPA-ng-scale streaming from per-edge attachment tensors
    (`prepare_stream`): the postorder and the smoothing schedule's edge walk
    (ops/branch_sweep.py) run through the level kernel, one op a launch, and
    each step's attachment product is taken right after its CLV op; a
    query then costs one R*s contraction and a log per (edge, site), plain
    PyTorch in site tiles.
The host code (edge list, indices, grafted candidates, ranked rows, the
jplace writer) is carried over from libpll2_tpu and gives the same tables
and dicts.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import constants as C
from .engine import TreeEngine, _pmatrices
from .io import maps
from .ops import fused as ops_fused
from .ops import likelihood as ops_likelihood
from .ops.gamma import compute_gamma_cats
from .ops.spr_stream import _pow2
from .partition import Partition
from .trees import create_operations, traverse
from .trees.utils import utree_clone
from .trees.utree import SCALE_BUFFER_NONE, UNode, UTree, link

__all__ = ["EdgePlacer", "to_jplace"]


class _RankedRows:
    """Ranked placement rows for ONE query, materialized per access.

    Behaves like the list of {edge, edge_nodes, logL, lwr} dicts that
    place()/place_batch return (indexing, slicing, iteration, len), but
    builds each dict on demand: the jplace writer reads only the top-k rows
    per query. Backed by rank-ordered arrays (order[i] = edge of rank i,
    scores/lwr sorted the same way)."""
    __slots__ = ("order", "scores", "lwr", "_names")

    def __init__(self, order, scores, lwr, names):
        self.order, self.scores, self.lwr = order, scores, lwr
        self._names = names

    def __len__(self):
        return len(self.order)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        e = int(self.order[i])
        return {"edge": e, "edge_nodes": self._names[e],
                "logL": float(self.scores[i]),
                "lwr": float(self.lwr[i])}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return repr(self[:min(len(self), 4)]) + ("..." if len(self) > 4
                                                 else "")


def _edge_list(tree: UTree):
    """One representative half-edge per edge (tips included)."""
    out, seen = [], set()
    for node in tree.nodes():
        halves = [node] if node.is_tip() else list(node.ring())
        for h in halves:
            if h.back is not None and id(h) not in seen \
                    and id(h.back) not in seen:
                seen.add(id(h)), seen.add(id(h.back))
                out.append(h)
    return out


def _index_for_placement(tree: UTree, label_row: Dict[str, int]):
    """Assign partition indices on the CLONED reference tree, reserving
    tip row `n` for the query: tips map to their partition rows by
    label; inner clvs start at n+1; pmatrix indices enumerate edges."""
    n = len(label_row)
    inner_clv = n + 1
    scaler = 0
    for node in tree.nodes():
        if node.is_tip():
            node.clv_index = node.node_index = label_row[node.label]
            node.scaler_index = SCALE_BUFFER_NONE
        else:
            for h in node.ring():
                h.clv_index = h.node_index = inner_clv
                h.scaler_index = scaler
            inner_clv += 1
            scaler += 1
    for e, h in enumerate(_edge_list(tree)):
        h.pmatrix_index = h.back.pmatrix_index = e


class EdgePlacer:
    """Placement engine bound to one reference tree + alignment.

    Build once, then `place(query_seq)` per query, `place_batch` for many
    at once or `place_stream` for EPA-ng-scale query sets. The partition
    lives on `device` ("cuda" by default, as `Partition`), in `dtype`
    (float32 by default; float64 on the CPU)."""

    def __init__(self, tree: UTree, reference_by_label: Dict[str, str],
                 states: int = 4, rate_cats: int = 4, charmap=None,
                 pendant_length: float = 0.05,
                 query_label: str = "QUERY", dtype=None, pallas="auto",
                 device="cuda"):
        if charmap is None:
            charmap = maps.map_nt if states == 4 else maps.map_aa
        self.charmap = charmap
        labels = [t.label for t in tree.tips()]
        if set(labels) != set(reference_by_label):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "reference alignment and tree taxa differ")
        n = len(labels)
        sites = len(next(iter(reference_by_label.values())))
        self.n_ref = n
        self.query_row = n
        self.query_label = query_label
        self.pendant_length = pendant_length
        self.tree = utree_clone(tree)
        label_row = {lab: i for i, lab in enumerate(labels)}
        _index_for_placement(self.tree, label_row)
        self.edges = _edge_list(self.tree)
        E = len(self.edges)                       # 2n-3
        # grafted trees have n+1 tips: one extra inner node/scaler and
        # two extra pmatrix slots (the split half + the pendant)
        self.partition = Partition(n + 1, n, states, sites, 1, E + 2,
                                   rate_cats, n, device=device,
                                   dtype=dtype or torch.float32)
        self._pallas = pallas
        self.partition.set_tip_states_batch(
            charmap, [reference_by_label[lab] for lab in labels],
            tip_indices=[label_row[lab] for lab in labels])
        # placeholder query (all-gap): every tip row must be populated
        # BEFORE the engine builds, or the fused path refuses the partition
        self.partition.set_tip_states(self.query_row, charmap,
                                      "-" * sites)
        self._candidates = None
        self._batch_inputs = None
        # the query form's traversal (ops/fused.py:fused_traversal, or a
        # stand-in that checks each launch against the plain version) and
        # the root-row bytes a launch of it may write
        self._traversal = ops_fused.fused_traversal
        self._launch_bytes = ops_fused.QUERY_LAUNCH_BYTES
        self._edge_names = [
            (h.label or f"node{h.clv_index}",
             h.back.label or f"node{h.back.clv_index}")
            for h in self.edges]

    def set_model(self, freqs, subst, rates=None, alpha: float = 1.0):
        p = self.partition
        p.set_frequencies(0, freqs)
        p.set_subst_params(0, subst)
        if rates is None:
            rates = (compute_gamma_cats(alpha, p.rate_cats)
                     if p.rate_cats > 1 else np.ones(1))
        p.set_category_rates(rates)
        self._engine = None
        self._stream = None

    def _graft_candidates(self):
        """Splice the query onto each edge in turn, snapshot the
        operation list, unsplice. Candidate tuples feed
        TreeEngine.evaluate_topologies; index assignments are shared, so
        every candidate has the same op count and index space."""
        n = self.n_ref
        E = len(self.edges)
        inner_clv = 2 * n          # rows n+1..2n-1 taken by base inners
        cands = []
        for e, h in enumerate(self.edges):
            u, v = h, h.back
            L = h.length
            r1, r2, r3 = UNode(), UNode(), UNode()
            r1.next, r2.next, r3.next = r2, r3, r1
            for r in (r1, r2, r3):
                r.clv_index = r.node_index = inner_clv
                r.scaler_index = n - 1            # one extra scaler row
            q = UNode(label=self.query_label)
            q.clv_index = q.node_index = self.query_row
            q.scaler_index = SCALE_BUFFER_NONE
            # wire: u -- r1, r2 -- v, r3 -- q; reuse e's pmatrix slot for
            # the u side, slot E for the v side, E+1 for the pendant
            link(r1, u, L / 2)
            link(r2, v, L / 2)
            link(r3, q, self.pendant_length)
            r1.pmatrix_index = u.pmatrix_index = e
            r2.pmatrix_index = v.pmatrix_index = E
            r3.pmatrix_index = q.pmatrix_index = E + 1
            trav = traverse(r3)
            ops, branches, pidx = create_operations(trav)
            root_info = (r3.clv_index, r3.scaler_index, q.clv_index,
                         q.scaler_index, r3.pmatrix_index)
            cands.append((ops, branches, pidx, root_info))
            if e == 0:
                # the engine's base topology roots here; the grafted
                # component keeps its indices after unsplicing
                self._root0 = r3
            # unsplice
            link(u, v, L)
            u.pmatrix_index = v.pmatrix_index = e
        return cands

    def _ensure_engine(self):
        if getattr(self, "_engine", None) is None:
            self._candidates = self._graft_candidates()
            self._batch_inputs = None
            ops, branches, pidx, _ = self._candidates[0]
            self._engine = TreeEngine(self.partition, operations=ops,
                                      branches=branches,
                                      pmatrix_indices=pidx,
                                      root=self._root0,
                                      level_schedule=False,
                                      pallas=self._pallas)
        return self._engine

    def _fused_batch_inputs(self):
        """(tables [E, n_ops+1, 8], branches [E, B], roots [E, 5], slots)
        of the candidates on the partition's device, for the query form,
        or None when any candidate is unfusable."""
        if self._batch_inputs is not None:
            return self._batch_inputs
        p = self.partition
        ctips = ops_fused.ctip_rows(p)
        tables, blens, roots, slots = [], [], [], 0
        for ops, branches, pidx, ri in self._candidates:
            table, n_slots = ops_fused.pack_fused_schedule(
                ops, p.tips, (ri[0], ri[2]), clv_tip_rows=ctips)
            if table is None:
                return None
            slots = max(slots, n_slots)
            tables.append(table)
            b = np.zeros(p.prob_matrices)
            b[np.asarray(pidx)] = np.asarray(branches)
            blens.append(b)
            roots.append(list(ri))
        dev = p.device
        self._batch_inputs = (
            torch.as_tensor(np.stack(tables), device=dev),
            torch.as_tensor(np.stack(blens), dtype=p.dtype, device=dev),
            np.asarray(roots, np.int64), slots)
        return self._batch_inputs

    def place_batch(self, query_seqs: Dict[str, str], chunk: int = 8,
                    top_k: Optional[int] = None
                    ) -> Dict[str, Sequence[dict]]:
        """Place MANY queries at once: every (query x edge) attachment of a
        chunk of `chunk` queries in one launch of the fused kernel's query
        form (more where `ops/fused.py:query_edge_split` splits the edges),
        the P-matrices built once per edge. The last chunk holds only the
        queries left: nothing is padded. Off the fused path (float64 on
        'levels', say), `place` a query at a time. Returns {query_label:
        ranked placement rows}."""
        eng = self._ensure_engine()
        fb = self._fused_batch_inputs() if eng.use_fused else None
        labels = list(query_seqs)
        if not labels:
            return {}
        if fb is None:
            return {lab: self.place(query_seqs[lab], top_k=top_k)
                    for lab in labels}
        tables, blens, roots, n_slots = fb
        p = self.partition
        codes = torch.as_tensor(self._query_codes_batch(
            [query_seqs[lab] for lab in labels]).astype(np.int32),
            device=p.device)
        margs = eng._model_args()
        n_edges = tables.shape[0]
        pmat = _pmatrices(*margs[:5], margs[7], blens.reshape(-1))
        pmat = pmat.view(n_edges, -1, *pmat.shape[1:])
        root_mats = torch.as_tensor(roots[:, 4], device=p.device)
        out = [_place_scores(
            codes[q0:q0 + chunk], tables, pmat, root_mats, margs,
            eng._site_args(), eng._tip_codes(), self.query_row, n_slots,
            p.scale_threshold, p.scale_factor, traversal=self._traversal,
            mxu=eng.mxu, budget=self._launch_bytes, **eng._fused_kw())
            for q0 in range(0, len(labels), chunk)]
        scores = torch.cat(out).to(torch.float64).cpu().numpy()
        return dict(zip(labels, self._rank_rows_batch(scores, top_k)))

    def prepare_stream(self):
        """Precompute the query-independent attachment tensors for
        `place_stream`: a postorder refresh, then the smoothing schedule's
        edge walk (ops/branch_sweep.py), each step's CLV op a one-op level
        of the level kernel (ops/levels.py:level_update) and its attachment
        product taken right after it. Call again after changing the model
        or branch lengths; `set_model` and a branch change invalidate it
        for `place_stream`."""
        from .ops import branch_sweep
        from .ops import levels as ops_levels
        from .ops import pmatrix as ops_pmatrix

        p = self.partition
        if float(np.max(np.asarray(p.prop_invar))) > 0.0:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "place_stream supports pinv == 0 only (the +I invariant "
                "term depends on the query state pattern); use "
                "place_batch for +I models")
        trav = traverse(self.tree.vroot)
        operations, branches, pidx = create_operations(trav)
        E = len(self.edges)
        steps, n_aux = branch_sweep.build_smoothing_schedule(
            self.tree, p.nodes, p.scale_buffers, E)
        K = p.scale_buffers
        tables = ops_levels.tables_to_device(ops_levels.pack_pallas_levels(
            operations, p.tips, zero_scaler_row=K + n_aux + 1,
            trash_scaler_row=K + n_aux), p.device)
        blen_full = np.zeros(E)
        blen_full[np.asarray(pidx)] = np.asarray(branches)
        blen_half = np.concatenate([blen_full / 2.0, [0.0]])
        # a throwaway engine supplies the device model operands
        eng = TreeEngine(p, operations=operations, branches=branches,
                         pmatrix_indices=pidx, root=self.tree.vroot,
                         level_schedule=False, pallas=False)
        margs = eng._model_args()
        a_w, cnt = _edge_attach_tensors(
            p.clv, p.scale_buffer, *margs, tables, steps,
            torch.as_tensor(blen_full, dtype=p.dtype, device=p.device),
            torch.as_tensor(blen_half, dtype=p.dtype, device=p.device),
            p.scale_threshold, p.scale_factor, n_aux=n_aux,
            level=ops_levels.level_for(p.clv))
        pend = ops_pmatrix.update_prob_matrices(
            *margs[:5], margs[7],
            torch.tensor([self.pendant_length], dtype=p.dtype,
                         device=p.device))[0]
        pw = eng._site_args()[0]
        self._stream = (a_w, cnt, pend, pw,
                        float(np.log(p.scale_threshold)))
        self._stream_version = p._model_version
        self._stream_blens = tuple(h.length for h in self.edges)
        return self

    def _query_codes(self, seq: str) -> np.ndarray:
        return self._query_codes_batch([seq])[0]

    def _query_codes_batch(self, seqs) -> np.ndarray:
        """All query bitmask rows in ONE vectorized pass (one charmap
        gather over the concatenated bytes). Returns [Q, sites_padded]
        int32 (int8 for <= 8-state alphabets, int64 above 32 states)."""
        p = self.partition
        for s in seqs:
            if len(s) != p.sites:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"query length {len(s)} != {p.sites} sites")
        raw = np.frombuffer("".join(seqs).encode("latin-1"),
                            dtype=np.uint8).reshape(len(seqs), p.sites)
        codes = np.asarray(self.charmap, dtype=np.uint64)[raw]
        if np.any(codes == 0):
            qi, si = np.unravel_index(int(np.argmax(codes == 0)),
                                      codes.shape)
            raise C.PllError(
                C.ERROR_TIPDATA_ILLEGALSTATE,
                f"illegal state in query sequence: {seqs[qi][si]!r}")
        dt = np.int8 if p.states <= 8 else \
            np.int32 if p.states <= 32 else np.int64
        out = np.zeros((len(seqs), p.sites_padded), dt)
        out[:, :p.sites] = codes.astype(dt)    # masks fit: < 2^states
        return out

    def place_stream(self, query_seqs: Dict[str, str],
                     chunk: Optional[int] = None,
                     top_k: Optional[int] = None
                     ) -> Dict[str, Sequence[dict]]:
        """EPA-ng-scale streaming placement: queries are scored against
        the PRECOMPUTED per-edge attachment tensors (prepare_stream), so
        each (query, edge, site) costs one R*s-element contraction plus a
        log, independent of tree size, instead of a full traversal.
        Queries go `chunk` at a time (default: the power-of-two bucket of
        the query count, capped at 1024), the last chunk only the queries
        left. Output rows are identical in format to place()/place_batch
        (feed to_jplace) and materialize lazily on access."""
        p = self.partition
        if getattr(self, "_stream", None) is None \
                or self._stream_version != p._model_version \
                or self._stream_blens != tuple(h.length
                                               for h in self.edges):
            self.prepare_stream()    # model or branch lengths changed
        a_w, cnt, pend, pw, log_thr = self._stream
        labels = list(query_seqs)
        if not labels:
            return {}
        S = p.sites_padded
        tile = next(t for t in (2048, 1024, 512, 128, S) if S % t == 0)
        Q = len(labels)
        if chunk is None:
            chunk = min(_pow2(Q), 1024)
        codes = torch.as_tensor(self._query_codes_batch(
            [query_seqs[lab] for lab in labels]), device=p.device)
        out = torch.cat([_stream_scores(codes[q0:q0 + chunk], a_w, cnt, pend,
                                        pw, log_thr, n_states=p.states,
                                        tile=tile)
                         for q0 in range(0, Q, chunk)])
        out = out.to(torch.float64).cpu().numpy()
        return dict(zip(labels, self._rank_rows_batch(out, top_k)))

    def place(self, query_seq: str, top_k: Optional[int] = None
              ) -> Sequence[dict]:
        """Score every attachment edge for one query sequence
        (`TreeEngine.evaluate_topologies`); returns rows sorted by logL
        with likelihood weight ratios: [{edge, edge_nodes, logL, lwr},
        ...]."""
        self.partition.set_tip_states(self.query_row, self.charmap,
                                      query_seq)
        eng = self._ensure_engine()
        scores = np.asarray(eng.evaluate_topologies(self._candidates),
                            dtype=np.float64)
        return self._rank_rows(scores, top_k)

    def _rank_rows(self, scores, top_k=None):
        return self._rank_rows_batch(np.asarray(scores)[None, :],
                                     top_k)[0]

    def _rank_rows_batch(self, scores, top_k=None):
        """Ranked jplace rows for a [Q, E] score matrix: vectorized
        exp/argsort across queries, lazy per-row dict materialization
        (_RankedRows)."""
        scores = np.asarray(scores, np.float64)
        w = np.exp(scores - scores.max(axis=1, keepdims=True))
        lwr = w / w.sum(axis=1, keepdims=True)
        order = np.argsort(-scores, axis=1)
        if top_k:
            order = order[:, :top_k]
        s_sorted = np.take_along_axis(scores, order, axis=1)
        l_sorted = np.take_along_axis(lwr, order, axis=1)
        names = self._edge_names
        return [_RankedRows(order[qi], s_sorted[qi], l_sorted[qi], names)
                for qi in range(scores.shape[0])]


def _edge_attach_tensors(clv, scaler,
                         eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, rate_weights, freqs, params_idx_rates,
                         tables,           # the postorder's level tables
                         steps,            # [n_steps, 13] int32 (numpy)
                         blen_full,        # [E] current edge lengths
                         blen_half,        # [E+1] half lengths (+0 dummy)
                         scale_threshold: float, scale_factor: float,
                         n_aux: int, level):
    """Per-edge attachment tensors for the streaming placer
    (libpll2_tpu/placement.py:_edge_attach_tensors): a postorder refresh of
    the combined buffers [partition rows | n_aux aux rows] through `level`
    a level at a time, then the smoothing-schedule edge walk
    (ops/branch_sweep.py) computing directional "up" CLVs in the aux rows,
    each step's CLV op a one-op level of `level`. Right after each step's
    op, while its aux rows still hold this edge's CLVs (the schedule's
    stack allocator reuses them once the walk leaves a subtree), it takes

        A[e]   = (P(L_e/2) @ clv_child) * (P(L_e/2) @ clv_parent_side)
                 folded with rate_weights x freqs  ->  [E, R*s, S]
        cnt[e] = summed per-site scaler counts      ->  [E, S]

    everything about attachment e that does not depend on the query. Exit
    steps (matrix index E) attach nothing. `clv` and `scaler` are read, not
    written."""
    from .ops import branch_sweep
    from .ops import levels as ops_levels
    from .ops import pmatrix as ops_pmatrix

    dtype = clv.dtype
    K = scaler.shape[0] - 2
    R, s, S = clv.shape[1], clv.shape[2], clv.shape[3]
    n_edges = blen_full.shape[0]
    pmat_full = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, blen_full)
    pmat_half = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, blen_half)
    clv_c = torch.cat([clv, clv.new_zeros((n_aux,) + clv.shape[1:])])
    sc_c = torch.cat([scaler[:K], scaler.new_zeros((n_aux,) + scaler.shape[1:]),
                      scaler[K:]])
    ops_levels.update_partials_kernel(clv_c, sc_c, pmat_full, tables,
                                      scale_threshold, scale_factor,
                                      level=level)
    clv2d = clv_c.view(clv_c.shape[0], R * s, S)
    out_a = clv.new_zeros((n_edges, R, s, S))
    out_cnt = scaler.new_zeros((n_edges, S))
    st_tables = branch_sweep.step_tables(steps, clv.device)
    for table, step in zip(st_tables, steps):
        level(clv2d, sc_c, pmat_full, table, R, s, scale_threshold,
              scale_factor)
        e_c, e_csc, e_p, e_psc, mat = (int(v) for v in step[8:13])
        if mat >= n_edges:
            continue                     # an exit step: no edge
        ph = pmat_half[mat]
        out_a[mat] = (torch.einsum('rij,rjs->ris', ph, clv_c[e_c])
                      * torch.einsum('rij,rjs->ris', ph, clv_c[e_p]))
        out_cnt[mat] = sc_c[e_csc] + sc_c[e_psc]
    fold = (rate_weights[:, None, None].to(dtype)
            * freqs[params_idx_rates][:, :, None])
    a_w = (out_a * fold[None]).reshape(n_edges, R * s, S)
    return a_w, out_cnt


def _stream_scores(codes_q,           # [Q, S] int query bitmasks
                   a_w,               # [E, R*s, S] weighted edge tensors
                   cnt,               # [E, S] per-site scaler counts
                   pend_pmat,         # [R, s, s] pendant P-matrix
                   pattern_weights,   # [S]
                   log_threshold,     # log of the scale window
                   n_states: int, tile: int):
    """logL grid [Q, E] from precomputed attachment tensors
    (libpll2_tpu/placement.py:_stream_scores): one R*s-element contraction
    and a log per (query, edge, site), `tile` sites at a time so that the
    [tile, Q, E] intermediate stands in for [S, Q, E]."""
    dtype = a_w.dtype
    Q = codes_q.shape[0]
    E, K, S = a_w.shape
    shifts = torch.arange(n_states, device=a_w.device)
    bits = ((codes_q.long()[:, None, :] >> shifts[None, :, None])
            & 1).to(dtype)                                  # [Q, s, S]
    qp = torch.einsum('rij,qjs->qris', pend_pmat, bits).reshape(Q, K, S)
    w_all = pattern_weights.to(dtype)
    acc = a_w.new_zeros((Q, E))
    for t0 in range(0, S, tile):
        a = a_w[:, :, t0:t0 + tile]
        q = qp[:, :, t0:t0 + tile]
        w = w_all[t0:t0 + tile]
        c = cnt[:, t0:t0 + tile].to(dtype)
        inner = torch.einsum('qkt,ekt->tqe', q, a)
        site = torch.where(w[:, None, None] > 0,
                           torch.log(inner.clamp(min=0.0))
                           + c.T[:, None, :] * log_threshold,
                           torch.zeros((), dtype=dtype, device=a_w.device))
        acc = acc + torch.sum(w[:, None, None] * site, dim=0)
    return acc


def _place_scores(codes_q,            # [Q, S] int32 query codes
                  tables,             # [E, n_ops+1, 8] int32
                  pmat,               # [E, B, R, s, s]
                  root_mats,          # [E] the root edges' matrices
                  model_args, site_args, tip_codes, query_row: int,
                  n_slots: int, scale_threshold: float, scale_factor: float,
                  traversal=ops_fused.fused_traversal, mxu: str = "split",
                  budget: int = ops_fused.QUERY_LAUNCH_BYTES,
                  rate_scalers: bool = False, tip_clvs=None,
                  asc_type: int = C.AB_NONE, n_real: int = -1):
    """logL grid [Q, E]: every query against every attachment edge
    (libpll2_tpu/placement.py:_place_scores), a launch of the fused kernel's
    query form (`traversal`) per `ops/fused.py:query_edge_split` edges
    (all of them where their root rows and spill slots fit in `budget`),
    then the root edges' likelihoods of the
    launch's Q x E' walks at once."""
    (_, _, _, prop_invar, _, rate_weights, freqs, pidx) = model_args
    pw, invariant = site_args
    q_n, n_edges = codes_q.shape[0], tables.shape[0]
    R, s = pmat.shape[2], pmat.shape[3]
    sites = tip_codes.shape[1]
    step = ops_fused.query_edge_split(
        q_n, n_edges, R, s, sites, rate_scalers, budget,
        ops_fused.query_spill_slots(tip_codes.device, R, s, n_slots,
                                    rate_scalers, sites,
                                    tip_clvs is not None, mxu))
    root_p = pmat[torch.arange(n_edges, device=pmat.device), root_mats]
    out = []
    for e0 in range(0, n_edges, step):
        sl = slice(e0, e0 + step)
        rows = traversal(tip_codes, pmat[sl].contiguous(), tables[sl],
                         rates=R, states=s, n_slots=n_slots,
                         threshold=scale_threshold, factor=scale_factor,
                         mxu=mxu, rate_scalers=rate_scalers,
                         tip_clvs=tip_clvs, query_codes=codes_q,
                         query_row=query_row)
        ne = rows[0].shape[1]
        flat = [r.reshape(q_n * ne, *r.shape[2:]) for r in rows]
        rp = root_p[sl].expand(q_n, *root_p[sl].shape)
        lk = ops_likelihood.edge_loglikelihood_candidates(
            *flat, rp.reshape(q_n * ne, R, s, s), freqs, prop_invar,
            rate_weights, pidx, pw, invariant, scale_threshold,
            rate_scalers=rate_scalers, asc_type=asc_type, n_real=n_real)
        out.append(lk.view(q_n, ne))
    return torch.cat(out, dim=1)


def _jplace_subtree(h) -> str:
    """Newick of the subtree behind half-edge h with {edge} annotations
    (each edge carries its candidate index exactly once)."""
    b = h.back
    e = h.pmatrix_index
    if b.is_tip():
        return f"{b.label}:{b.length:.6f}{{{e}}}"
    parts = ",".join(_jplace_subtree(r) for r in list(b.ring())[1:])
    return f"({parts}){b.label or ''}:{b.length:.6f}{{{e}}}"


def to_jplace(placer: EdgePlacer, results: Dict[str, Sequence[dict]],
              top_k: int = 7) -> dict:
    """Serialize placements into the jplace v3 interchange format (what
    EPA-ng emits; consumed by gappa/iTOL): the reference tree's edges are
    annotated {edge_num} matching the placer's candidate indices, and
    each query carries its top_k placements with logL, LWR, distal
    (midpoint) and pendant lengths. json.dumps the result to write a
    .jplace file."""
    root = placer.tree.vroot
    tree = "(" + ",".join(_jplace_subtree(r) for r in root.ring()) + ");"
    half_len = np.asarray([h.length / 2.0 for h in placer.edges])
    pend = placer.pendant_length
    items = list(results.items())
    placements = []
    lens = [len(r) for _, r in items]
    # the vectorized path needs a UNIFORM row count per query (all rows
    # >= top_k, or all equal: then the clamp is per-query exact); mixed
    # lengths (merged results of different top_k calls) take the dict
    # path, which emits min(len(rows), top_k) PER query
    uniform = lens and (min(lens) >= top_k or len(set(lens)) == 1)
    if items and uniform and all(isinstance(r, _RankedRows)
                                 for _, r in items):
        top_k = min(top_k, min(lens))
        o = np.stack([np.asarray(r.order[:top_k], np.int64)
                      for _, r in items])
        vals = np.stack([np.asarray(r.scores[:top_k]) for _, r in items])
        lwrs = np.stack([np.asarray(r.lwr[:top_k]) for _, r in items])
        blocks = np.stack([vals, lwrs, half_len[o],
                           np.full(o.shape, pend)], axis=2).tolist()
        edges_l = o.tolist()
        for (name, _), eq, bq in zip(items, edges_l, blocks):
            placements.append(
                {"p": [[e] + b for e, b in zip(eq, bq)], "n": [name]})
    else:
        for name, rows in items:
            p = [[r["edge"], r["logL"], r["lwr"],
                  placer.edges[r["edge"]].length / 2.0,
                  placer.pendant_length] for r in rows[:top_k]]
            placements.append({"p": p, "n": [name]})
    return {"tree": tree,
            "placements": placements,
            "fields": ["edge_num", "likelihood", "like_weight_ratio",
                       "distal_length", "pendant_length"],
            "version": 3,
            "metadata": {"software": "libpll2_tpu"}}
