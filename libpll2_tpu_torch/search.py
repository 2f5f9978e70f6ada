"""Hill-climbing topology search: NNI and SPR rounds over the engine.

Port of libpll2_tpu/search.py: the consumer pattern the reference library
serves (move -> partial traversal -> rescore -> accept/rollback, libpll-2
test/src/partial-traversal.c) as a ready-to-use search loop. Three kinds of
round:
  * first-improvement (`nni_round`, `spr_round`, `run`): one full
    evaluation a move;
  * batched (`nni_round_batched`, `spr_round_batched`): every candidate of
    a round built by the native builder (native/pllnative.cpp
    pll_tpu_move_candidates; the Python walk without it) and scored by the
    fused kernel's candidate form (`TreeEngine.evaluate_packed_arrays`);
  * streamed (`nni_round_streamed`, `spr_round_streamed`): every candidate
    scored from directional CLVs (ops/spr_stream.py: three passes of the
    level kernel, then a few op-equivalents a candidate), the winner
    verified by a full evaluation.
Rounds accept the same moves as JAX's from the same start: the rng is
consumed in the same calls and order.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import constants as C
from .engine import TreeEngine
from .partition import Partition
from .trees import create_operations, moves, traverse
from .trees.utree import UNode, UTree


def _internal_edges(tree: UTree) -> List[UNode]:
    """One half-edge per internal edge (both endpoints inner)."""
    out = []
    seen = set()
    for node in tree.nodes():
        if node.is_tip():
            continue
        for h in node.ring():
            if h.back is not None and not h.back.is_tip() \
                    and id(h) not in seen and id(h.back) not in seen:
                seen.add(id(h))
                out.append(h)
    return out


def _all_edges(tree: UTree) -> List[UNode]:
    out = []
    seen = set()
    for node in tree.nodes():
        halves = [node] if node.is_tip() else list(node.ring())
        for h in halves:
            if h.back is not None and id(h) not in seen \
                    and id(h.back) not in seen:
                seen.add(id(h))
                out.append(h)
    return out


def _flatten_tree(tree: UTree):
    """Flat half-edge arrays for the native candidate builder: tips get
    id = clv_index (0..T-1), inner node i owns ids T+3i+{0,1,2} in ring
    order. Returns (back, next, clv, scaler, pmat, length, node_of) where
    node_of[id] is the live UNode (to apply the winning move)."""
    T = tree.tip_count
    inner = [n for n in tree.nodes() if not n.is_tip()]
    H = T + 3 * len(inner)
    ids = {}
    node_of: List[Optional[UNode]] = [None] * H
    for n in tree.nodes():
        if n.is_tip():
            ids[id(n)] = n.clv_index
            node_of[n.clv_index] = n
    for i, n in enumerate(inner):
        for k, h in enumerate((n, n.next, n.next.next)):
            hid = T + 3 * i + k
            ids[id(h)] = hid
            node_of[hid] = h
    back = np.full(H, -1, np.int32)
    nxt = np.full(H, -1, np.int32)
    clv = np.zeros(H, np.int32)
    scaler = np.zeros(H, np.int32)
    pmat = np.zeros(H, np.int32)
    length = np.zeros(H, np.float64)
    for hid, h in enumerate(node_of):
        clv[hid] = h.clv_index
        scaler[hid] = h.scaler_index
        pmat[hid] = h.pmatrix_index
        length[hid] = h.length or 0.0
        if h.back is not None:
            back[hid] = ids[id(h.back)]
        if h.next is not None:
            nxt[hid] = ids[id(h.next)]
    return back, nxt, clv, scaler, pmat, length, node_of, ids


def _radius_targets(p: UNode, radius: int) -> List[UNode]:
    """Regraft targets within `radius` edges of the prune point — the
    RAxML/IQ-TREE SPR neighborhood bound. Walks outward from p's node
    without crossing p, so the pruned subtree (behind p.back) is excluded
    by construction: O(targets) instead of the O(edges * tree) subtree
    filter, which dominates full-neighborhood rounds at 1000 taxa.
    Distance-1 edges are skipped (regrafting there is the identity)."""
    out: List[UNode] = []
    stack = []
    for h in (p.next, p.next.next):
        if h.back is not None:
            stack.append((h.back, 1))
    while stack:
        nd, d = stack.pop()
        if nd.is_tip() or d >= radius:
            continue
        for h in (nd.next, nd.next.next):
            if h.back is None:
                continue
            out.append(h)
            stack.append((h.back, d + 1))
    return out


class TreeSearch:
    """Greedy hill climbing with accept/rollback (first-improvement)."""

    def __init__(self, partition: Optional[Partition], tree: UTree,
                 params_index: int = 0, epsilon: float = 1e-6,
                 engine=None, **engine_kwargs):
        self.partition = partition
        self.tree = tree
        self.params_index = params_index
        self.epsilon = epsilon
        # as JAX's: the plain path (pallas=False) runs one op at a time
        engine_kwargs.setdefault("level_schedule", False)
        self.engine_kwargs = engine_kwargs
        # a pre-built engine may be injected: a PartitionedEngine (the
        # consumers' partitioned search, every round summed over its
        # partitions) or a TreeEngine
        self._engine = engine
        self._engine_injected = engine is not None
        # monotone wave-count floors for the streamed rounds' level
        # tables (ops/spr_stream.py), as in JAX, so that the tables stay
        # equal to JAX's round for round
        self._stream_waves = {}

    def _stream_build(self, builder, *args, sig=None, **kwargs):
        floors = self._stream_waves.setdefault(sig, {})
        sched = builder(*args, min_waves=floors, **kwargs)
        if sched is None:
            return None
        for key, table in (("post", sched.post_table),
                           ("up", sched.up_table),
                           ("a", sched.a_table)):
            floors[key] = max(floors.get(key, 0), table.shape[0])
        return sched

    @staticmethod
    def _sig(p):
        """Buffer signature a streamed schedule is built against: the
        row-address space (CLV rows, scaler rows, pmatrix slots) baked
        into its tables. Partitions sharing one tree usually share it;
        mismatched allocations get their own schedule (built from the
        same deterministic enumeration, so candidate order is
        identical and per-unit scores sum row-for-row)."""
        return (TreeSearch._n_rows(p), p.scale_buffers, p.prob_matrices)

    def _stream_schedules(self, builder, *args, rng=None, **kwargs):
        """One schedule per distinct unit signature. The rng (SPR
        subsampling) is replayed from the same state for every
        signature so all schedules keep identical candidate subsets,
        and ends one-consumption advanced (parity with the batched
        rounds). Returns {sig: sched} or None (builder declined)."""
        units = self._stream_units()
        out = {}
        state0 = rng.bit_generator.state if rng is not None else None
        for ue, p in units:
            sig = self._sig(p)
            if sig in out:
                continue
            if state0 is not None:
                rng.bit_generator.state = state0
            sched = self._stream_build(builder, *args, *sig, sig=sig,
                                       rng=rng, **kwargs) \
                if rng is not None else \
                self._stream_build(builder, *args, *sig, sig=sig,
                                   **kwargs)
            if sched is None:
                return None
            out[sig] = sched
        return out

    def evaluate(self) -> float:
        # one engine for the whole search: only the op/branch/root arrays
        # refresh per topology, never the model state
        if self._engine is None:
            self._engine = TreeEngine(self.partition, self.tree,
                                      params_index=self.params_index,
                                      **self.engine_kwargs)
        else:
            self._engine.set_topology(self.tree)
        return self._engine.loglikelihood()

    def nni_round(self) -> Tuple[float, int]:
        """Try both NNI alternatives on every internal edge; keep
        improvements. Returns (best logL, accepted moves). The edges are
        listed once, at the start: an edge that an accepted move has
        relinked to a tip is skipped (JAX's round raises PllError there,
        ROADMAP C)."""
        best = self.evaluate()
        accepted = 0
        for edge in _internal_edges(self.tree):
            if edge.back is None or edge.back.is_tip():
                continue
            for move_type in (C.UTREE_MOVE_NNI_LEFT, C.UTREE_MOVE_NNI_RIGHT):
                rb = moves.Rollback()
                moves.nni(edge, move_type, rb)
                lk = self.evaluate()
                if lk > best + self.epsilon:
                    best = lk
                    accepted += 1
                else:
                    moves.rollback_move(rb)
        return best, accepted

    def nni_round_batched(self) -> Tuple[float, int]:
        """Steepest-ascent NNI: ALL candidate topologies scored at once
        (the native builder + `evaluate_packed_arrays` on the fused path,
        else `evaluate_packed` / `evaluate_topologies`), then the best
        improving move is applied; repeats until no improvement."""
        best = self.evaluate()
        eng = self._engine
        accepted = 0
        while True:
            edges = _internal_edges(self.tree)
            # native fast path: the whole round's apply-NNI + pack +
            # rollback in one C++ call (same machinery as the SPR round)
            if edges and getattr(eng, "use_fused", False):
                mv = [(mt, e, None) for e in edges
                      for mt in (C.UTREE_MOVE_NNI_LEFT,
                                 C.UTREE_MOVE_NNI_RIGHT)]
                nat = self._native_candidates(mv)
                if nat is not None:
                    tables, blens, roots, slots, kept = nat
                    if tables.shape[0] == 0:
                        return best, accepted
                    scores = eng.evaluate_packed_arrays(
                        tables, blens, roots, int(slots.max()))
                    i = int(np.argmax(scores))
                    if scores[i] <= best + self.epsilon:
                        return best, accepted
                    moves.nni(kept[i][1], kept[i][0], None)
                    best = float(scores[i])
                    accepted += 1
                    continue
            candidates, applied = [], []
            for edge in edges:
                for mt in (C.UTREE_MOVE_NNI_LEFT, C.UTREE_MOVE_NNI_RIGHT):
                    rb = moves.Rollback()
                    moves.nni(edge, mt, rb)
                    vr = self.tree.vroot
                    # snapshot indices BEFORE rollback — the move may
                    # rewire the vroot's back pointer
                    pc = eng.pack_candidate(vr)
                    if pc is not None:
                        candidates.append(pc)
                    else:
                        trav = traverse(vr)
                        ops, br, pidx = create_operations(trav)
                        root_info = (vr.clv_index, vr.scaler_index,
                                     vr.back.clv_index,
                                     vr.back.scaler_index,
                                     vr.pmatrix_index)
                        candidates.append((ops, br, pidx, root_info))
                    moves.rollback_move(rb)
                    applied.append((edge, mt))
            if not candidates:
                return best, accepted
            scores = (eng.evaluate_packed(candidates)
                      if isinstance(candidates[0][0], np.ndarray)
                      else eng.evaluate_topologies(candidates))
            i = int(np.argmax(scores))
            if scores[i] <= best + self.epsilon:
                return best, accepted
            edge, mt = applied[i]
            moves.nni(edge, mt, None)
            best = float(scores[i])
            accepted += 1

    def spr_round_batched(self, max_candidates: Optional[int] = None,
                          seed: int = 0,
                          batch: Optional[int] = None,
                          radius: Optional[int] = None
                          ) -> Tuple[float, int]:
        """Steepest-ascent SPR: every (prune, regraft) candidate of the
        round (within `radius` of the prune point, or the whole
        neighbourhood; at most `max_candidates` a prune point, drawn from
        an rng seeded with `seed`) is scored on the device — the native
        builder + `evaluate_packed_arrays` on the fused path (chunks of
        128 candidates a launch), else `evaluate_packed` /
        `evaluate_topologies`; `batch` caps the candidates a call. The best
        improving move is applied; repeats until no improvement.
        """
        best = self.evaluate()
        eng = self._engine
        accepted = 0
        rng = np.random.default_rng(seed)
        while True:
            # pair enumeration (radius BFS / full neighborhood +
            # subsampling) happens ONCE per iteration — it is
            # O(candidates); the rng must never be consumed twice for one
            # iteration (native fallback) or paths diverge
            pair_list = []
            for p in list(_internal_edges(self.tree)):
                if radius is not None:
                    targets = _radius_targets(p, radius)
                else:
                    targets = [r for r in _all_edges(self.tree)
                               if r not in (p, p.back, p.next, p.next.back,
                                            p.next.next, p.next.next.back)
                               and not moves.utree_find(p.back, r)
                               and r.back is not None]
                if max_candidates and len(targets) > max_candidates:
                    idx = rng.permutation(len(targets))[:max_candidates]
                    targets = [targets[i] for i in idx]
                pair_list.extend((p, r) for r in targets)
            # native fast path: the per-candidate apply-SPR + pack-table +
            # rollback walk runs in ONE C++ call over flat half-edge
            # arrays (the Python walk below is the fallback)
            if pair_list and getattr(eng, "use_fused", False):
                nat = self._native_spr_candidates(pair_list)
                if nat is not None:
                    tables, blens, roots, slots, kept_pairs = nat
                    if tables.shape[0] == 0:
                        return best, accepted
                    step = batch or tables.shape[0]
                    scores = np.concatenate(
                        [eng.evaluate_packed_arrays(
                            tables[i:i + step], blens[i:i + step],
                            roots[i:i + step], int(slots.max()))
                         for i in range(0, tables.shape[0], step)])
                    i = int(np.argmax(scores))
                    if scores[i] <= best + self.epsilon:
                        return best, accepted
                    p, r = kept_pairs[i]
                    moves.spr(p, r, None, safe=True)
                    best = float(scores[i])
                    accepted += 1
                    continue
            candidates, applied = [], []
            for p, r in pair_list:
                rb = moves.Rollback()
                try:
                    moves.spr(p, r, rb, safe=True)
                except C.PllError:
                    continue
                vr = self.tree.vroot
                # one-pass packed candidate (fused path): skips the
                # Operation-object pipeline — the per-candidate host
                # cost that dominates 1000-taxon rounds
                pc = eng.pack_candidate(vr)
                if pc is not None:
                    candidates.append(pc)
                else:
                    trav = traverse(vr)
                    ops, br, pidx = create_operations(trav)
                    root_info = (vr.clv_index, vr.scaler_index,
                                 vr.back.clv_index,
                                 vr.back.scaler_index,
                                 vr.pmatrix_index)
                    candidates.append((ops, br, pidx, root_info))
                applied.append((p, r))
                moves.rollback_move(rb)
            if not candidates:
                return best, accepted
            # homogeneous by construction: pack_candidate succeeds for
            # every binary topology once the engine selected the fused
            # path, and always returns None otherwise
            evaluate = (eng.evaluate_packed
                        if isinstance(candidates[0][0], np.ndarray)
                        else eng.evaluate_topologies)
            step = batch or len(candidates)
            scores = np.concatenate(
                [evaluate(candidates[i:i + step])
                 for i in range(0, len(candidates), step)])
            i = int(np.argmax(scores))
            if scores[i] <= best + self.epsilon:
                return best, accepted
            p, r = applied[i]
            moves.spr(p, r, None, safe=True)
            best = float(scores[i])
            accepted += 1

    def _stream_units(self):
        """(engine, partition) pairs the streamed scorer sums over: one
        for a TreeEngine, one per partition for an injected
        PartitionedEngine, linked or not (candidate scoring always
        evaluates the tree's branch lengths, as the batched rounds'
        set_topology does; `linked` only changes how Newton updates
        apply); None for an engine of another type, which takes the
        batched rounds."""
        from .partitioned import PartitionedEngine

        eng = self._engine
        if isinstance(eng, TreeEngine):
            return [(eng, eng.partition)]
        if isinstance(eng, PartitionedEngine):
            return [(e, e.partition) for e in eng.engines]
        return None

    @staticmethod
    def _n_rows(p) -> int:
        """CLV row count of the streamed address space: the dense buffer
        row count, or nodes+1 (the same layout the dense allocation
        would have) for pooled site-repeats partitions."""
        return p.clv.shape[0] if p.clv is not None else p.nodes + 1

    def _streamed_eligible(self) -> bool:
        """The streamed scorer supports per-site or per-rate scalers and
        homogeneous models on a TreeEngine or a PartitionedEngine (linked
        or not, even with mismatched buffer signatures: per-partition
        scores summed, one schedule per distinct signature), with or
        without an asc correction. Site-repeats partitions stream through
        a dense base
        built from the tip rows (`Partition.dense_tip_rows`; every tip
        set): the reference's partial traversal over repeats (libpll-2
        src/repeats.c:299, test/src/partial-traversal.c). A site mesh
        streams too, each shard's passes on its own block and one sum of
        the candidates' scores over the shards, but for JAX's exclusions:
        asc corrections and repeats stream on one device only."""
        units = self._stream_units()
        if not units:
            return False
        for ue, p in units:
            # per-edge heterotachy is excluded by design: merged/half
            # SPR edges have no well-defined rate matrix
            # (ops/spr_stream.py docstring)
            if p is None or getattr(ue, "edge_params", None) is not None:
                return False
            meshed = getattr(p, "mesh", None) is not None
            # under a mesh the synthetic asc columns are global (they lie
            # in one shard)
            if p.asc_bias != C.AscBias.NONE and meshed:
                return False
            if p.repeats is not None and (meshed or not bool(
                    np.all(p._tips_set | p._tips_clv_set))):
                return False
        return True

    def _summed_nni_scores(self, scheds, chunk):
        """Per-candidate NNI scores summed over the stream units (one
        device program per distinct partition signature, each scored
        with its signature's schedule)."""
        from .ops import spr_stream
        totals = None
        for ue, p in self._stream_units():
            sched = scheds[self._sig(p)]
            margs = ue._model_args()
            pw, invariant, clv_arg, sc_arg, base = self._stream_inputs(ue, p)
            t = spr_stream.nni_stream_scores(
                clv_arg, sc_arg, *margs,
                spr_stream.ops_from_table(sched.post_table),
                sched.post_valid,
                spr_stream.ops_from_table(sched.up_table),
                sched.up_valid, sched.blen_full, sched.cand_rows, pw,
                invariant, p.scale_threshold, p.scale_factor,
                n_aux=sched.n_aux, n_arows=sched.n_arows, chunk=chunk,
                rate_scalers=p.rate_scalers, base=base,
                asc_type=ue.asc_type, n_real=ue.n_real,
                n_candidates=sched.n_candidates, mesh=p.mesh)
            t = t.cpu().numpy().astype(np.float64)
            totals = t if totals is None else totals + t
        return totals

    @staticmethod
    def _stream_base(p):
        """(clv_arg, scaler_arg, base) for the streamed scorer: the
        partition's dense buffers, or the tip-row base of a pooled
        site-repeats partition (spr_stream._extend_buffers)."""
        if p.repeats is None:
            return p.clv, p.scale_buffer, None
        return p.dense_tip_rows(), None, (p.nodes + 1, p.scale_buffers)

    @classmethod
    def _stream_inputs(cls, ue, p):
        """(pattern weights, invariant, clv_arg, scaler_arg, base) of a
        stream unit: `_stream_base` and the engine's site vectors, or on a
        site mesh each shard's (lists in shard order, for the scorers'
        `mesh=`)."""
        if p.shards is not None:
            site = [e._site_args() for e in ue._shards.engines]
            return ([a for a, _ in site], [b for _, b in site],
                    [sh.clv for sh in p.shards],
                    [sh.scale_buffer for sh in p.shards], None)
        return (*ue._site_args(), *cls._stream_base(p))

    def _summed_spr_scores(self, scheds, chunk):
        """Per-candidate SPR scores summed over the stream units."""
        from .ops import spr_stream
        totals = None
        for ue, p in self._stream_units():
            sched = scheds[self._sig(p)]
            margs = ue._model_args()
            pw, invariant, clv_arg, sc_arg, base = self._stream_inputs(ue, p)
            t = spr_stream.spr_stream_scores(
                clv_arg, sc_arg, *margs,
                spr_stream.ops_from_table(sched.post_table),
                sched.post_valid,
                spr_stream.ops_from_table(sched.up_table),
                sched.up_valid,
                spr_stream.ops_from_table(sched.a_table),
                sched.a_valid, sched.blen_full, sched.merged_len,
                sched.half_len, sched.cand_rows, pw, invariant,
                p.scale_threshold, p.scale_factor,
                n_aux=sched.n_aux, n_arows=sched.n_arows, chunk=chunk,
                rate_scalers=p.rate_scalers, base=base,
                asc_type=ue.asc_type, n_real=ue.n_real,
                n_candidates=sched.n_candidates, mesh=p.mesh)
            t = t.cpu().numpy().astype(np.float64)
            totals = t if totals is None else totals + t
        return totals

    def _ensure_engine(self):
        """Construct the engine without evaluating (so eligibility
        checks can run before any device dispatch)."""
        if self._engine is None:
            self._engine = TreeEngine(self.partition, self.tree,
                                      params_index=self.params_index,
                                      **self.engine_kwargs)

    def _evaluate_begin(self):
        """Round-start evaluation without a host sync where possible: a
        TreeEngine returns the 0-d device logL (the CLV buffers update in
        stream order, so the streamed scoring queues behind the evaluation
        while the host builds the schedule; the blocking float() lands
        after the scores). Injected engines evaluate eagerly."""
        if self._engine is None or not isinstance(self._engine,
                                                  TreeEngine):
            return self.evaluate()
        self._engine.set_topology(self.tree)
        total, _ = self._engine._loglikelihood_dev()
        return total

    def nni_round_streamed(self, chunk: int = 256, verify_top: int = 4
                           ) -> Tuple[float, int]:
        """Steepest-ascent NNI round scored from directional CLVs: both
        alternatives of every internal edge cost 5 op-equivalents each
        (4 flanking matvecs + the central-edge contraction) instead of a
        full traversal — no corrected-CLV pass at all, since an NNI only
        swaps subtrees whose directional CLVs are unchanged. The winner
        is verified with a full engine evaluation before acceptance.
        Falls back to nni_round_batched for ineligible configurations."""
        # eligibility first: the batched fallback evaluates on entry, so
        # dispatching _evaluate_begin before the check would cost every
        # fallback round one extra full evaluation
        self._ensure_engine()
        if not self._streamed_eligible():
            return self.nni_round_batched()
        best = self._evaluate_begin()
        from .ops import spr_stream

        accepted = 0
        while True:
            edges = _internal_edges(self.tree)
            if not edges:
                return float(best), accepted
            scheds = self._stream_schedules(
                spr_stream.build_nni_stream, self.tree, edges)
            sched = next(iter(scheds.values()))
            scores = self._summed_nni_scores(scheds, chunk)
            best = float(best)
            applied = False
            for i in np.argsort(-scores)[:verify_top]:
                if scores[i] <= best + self.epsilon:
                    break
                edge, kind = sched.pairs[i]
                moves.nni(edge, kind, None)
                lk = self.evaluate()
                if lk > best + self.epsilon:
                    best = lk
                    accepted += 1
                    applied = True
                    break
                moves.nni(edge, kind, None)       # NNI is an involution
            if not applied:
                return best, accepted

    def spr_round_streamed(self, radius: int = 5, seed: int = 0,
                           max_candidates: Optional[int] = None,
                           chunk: int = 256, verify_top: int = 4
                           ) -> Tuple[float, int]:
        """Steepest-ascent SPR round scored from DIRECTIONAL CLVs — the
        reference consumers' partial-traversal rescoring
        (test/src/partial-traversal.c) batched on the device: every
        candidate costs ~3 pruning-op equivalents instead of a full
        traversal (ops/spr_stream.py). Ranking uses the
        streamed scores; the winning move is verified with a FULL
        engine evaluation before acceptance (fp association differs
        between a streamed composition and a from-scratch traversal),
        falling through the next-best candidates on a near-tie. Falls
        back to spr_round_batched for configurations the streamed
        scorer excludes."""
        self._ensure_engine()
        if not self._streamed_eligible():
            return self.spr_round_batched(radius=radius, seed=seed,
                                          max_candidates=max_candidates)
        best = self._evaluate_begin()
        from .ops import spr_stream

        accepted = 0
        rng = np.random.default_rng(seed)
        while True:
            # native whole-round schedule construction (C++ enumeration
            # + row emission + wave packing; bit-identical tables, same
            # rng consumption) — the Python builder is the fallback
            scheds = self._stream_schedules(
                spr_stream.build_spr_stream_native, self.tree, radius,
                max_candidates=max_candidates, rng=rng)
            if scheds is None:
                groups = []
                for pr in list(_internal_edges(self.tree)):
                    ts = spr_stream.enumerate_targets(pr, radius)
                    kept = None
                    if max_candidates and len(ts) > max_candidates:
                        # same rng consumption pattern as
                        # spr_round_batched, so both rounds score the
                        # same candidate subsets
                        kept = list(
                            rng.permutation(len(ts))[:max_candidates])
                    groups.append((pr, ts, kept))
                if not any(ts for _, ts, _ in groups):
                    return float(best), accepted
                scheds = self._stream_schedules(
                    spr_stream.build_spr_stream, self.tree, groups)
            sched = next(iter(scheds.values()))
            if sched.n_candidates == 0:
                return float(best), accepted
            scores = self._summed_spr_scores(scheds, chunk)
            best = float(best)
            applied = False
            for i in np.argsort(-scores)[:verify_top]:
                if scores[i] <= best + self.epsilon:
                    break
                pr, t = sched.pairs[i]
                rb = moves.Rollback()
                try:
                    moves.spr(pr, t, rb, safe=True)
                except C.PllError:
                    continue
                lk = self.evaluate()
                if lk > best + self.epsilon:
                    best = lk
                    accepted += 1
                    applied = True
                    break
                moves.rollback_move(rb)
            if not applied:
                return best, accepted

    def _native_candidates(self, moves_list):
        """Whole-round candidate construction via the native builder
        (apply + pack + rollback per move). `moves_list` holds
        (kind, a[, b]) tuples of UNodes with kind 0 = SPR(prune,
        regraft), 1/2 = NNI-left/right on edge a. Returns (tables,
        blens, roots, slots, kept_moves) or None (no native lib /
        unpackable topology -> Python fallback)."""
        from . import native
        from .ops.fused import ctip_rows

        eng = self._engine
        if not isinstance(eng, TreeEngine):
            # a PartitionedEngine: its units share one candidate table
            # when they share the index space the tables address
            eng = getattr(eng, "shared_unit", None)
            if eng is None:
                return None
        part = eng.partition
        flat = _flatten_tree(self.tree)
        back, nxt, clv, scaler, pmat, length, node_of, ids = flat
        mv = np.asarray(
            [[m[0], ids[id(m[1])],
              ids[id(m[2])] if m[0] == 0 else 0] for m in moves_list],
            np.int32).reshape(-1, 3)
        ctips = ctip_rows(part) if eng._packed_ctips else None
        res = native.move_candidates(
            back, nxt, clv, scaler, pmat, length, self.tree.tip_count,
            int(clv.max()) + 1, ctips, mv,
            ids[id(self.tree.vroot)], part.prob_matrices)
        if res is None:
            return None
        tables, blens, roots, slots, kept = res
        kept_moves = [moves_list[i] for i in np.flatnonzero(kept)]
        return tables, blens, roots, slots, kept_moves

    def _native_spr_candidates(self, pairs):
        """SPR-pair wrapper over _native_candidates (kept for tests)."""
        res = self._native_candidates([(0, p, r) for p, r in pairs])
        if res is None:
            return None
        tables, blens, roots, slots, kept_moves = res
        return tables, blens, roots, slots, [(m[1], m[2])
                                             for m in kept_moves]

    def spr_round(self, max_candidates: Optional[int] = None,
                  seed: int = 0) -> Tuple[float, int]:
        """Try SPR regrafts of each prunable subtree onto candidate edges;
        keep improvements (first-improvement per prune edge)."""
        best = self.evaluate()
        accepted = 0
        rng = np.random.default_rng(seed)
        for p in list(_internal_edges(self.tree)):
            targets = [r for r in _all_edges(self.tree)
                       if r not in (p, p.back, p.next, p.next.back,
                                    p.next.next, p.next.next.back)
                       and not moves.utree_find(p.back, r)
                       and r.back is not None]
            if max_candidates and len(targets) > max_candidates:
                idx = rng.permutation(len(targets))[:max_candidates]
                targets = [targets[i] for i in idx]
            for r in targets:
                rb = moves.Rollback()
                try:
                    moves.spr(p, r, rb, safe=True)
                except C.PllError:
                    continue
                lk = self.evaluate()
                if lk > best + self.epsilon:
                    best = lk
                    accepted += 1
                    break              # re-enumerate from the new topology
                moves.rollback_move(rb)
        return best, accepted

    def run(self, max_rounds: int = 10, use_spr: bool = True) -> float:
        """Alternate NNI (and optionally SPR) rounds until no move is
        accepted. Returns the final logL."""
        best = self.evaluate()
        for _ in range(max_rounds):
            best, acc = self.nni_round()
            if use_spr:
                best_spr, acc_spr = self.spr_round()
                best, acc = max(best, best_spr), acc + acc_spr
            if acc == 0:
                break
        return best
