"""Site repeats: compute each distinct subtree site pattern once.

Port of libpll2_tpu/repeats.py (host numpy code; reference: libpll-2
src/repeats.c). Semantics preserved:

  * a node's site **class** is the identity of the site pattern restricted
    to the node's subtree; tips class sites by their character
    (repeats.c:189-254), inner nodes by the pair (left class, right class)
    (repeats.c:334-347), in first-occurrence order;
  * repeats are disabled per node (class id count = 0, identity mapping)
    when a child has no classes or more than sites/2, or when the pair
    space would overflow (pll_default_enable_repeats, repeats.c:100-110),
    or when compression yields nothing (ids == sites, repeats.c:366-371);
  * parent scalers propagate through the class indirection
    (repeats.c:392-540).

A repeats partition stores its CLVs as one pool of class columns
(`FlatLayout`), the reference's per-node reallocation (repeats.c:256-296)
with every node's region rounded up to a 128-column bucket, exactly as the
JAX package lays it out, so that the two pools line up column for column.
Classes come from the native classer (native/pllnative.cpp
pll_tpu_repeats_tips and pll_tpu_repeats_update, the reference's
lookup-buffer pass), as in the JAX package; without the library, from
numpy's first-occurrence dedup, which gives the same classes
(`native.load` says so on stderr once).

One difference from the JAX package: a scaler's capacity covers the nodes
that READ it in the schedule as well as those that write it, and a scaler
that the schedule does not write keeps the capacity it had in the previous
layout (`classify_operations`). For a full postorder on a fresh partition
that changes nothing; for a partial op list it keeps the scaler regions of
the nodes that the list does not recompute (the JAX layout gives them no
columns).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import native

__all__ = ["LOOKUP_BUFFER_SIZE", "RepeatsTable", "FlatLayout",
           "build_flat_layout", "bucket_width", "classify_operations",
           "op_fields", "schedule_buckets_flat", "schedule_buckets"]

LOOKUP_BUFFER_SIZE = 2_000_000       # pll.h:128 PLL_REPEATS_LOOKUP_SIZE


def _first_occurrence_classes(codes: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(site_id, id_site, ids) with classes numbered in first-occurrence
    order over the site axis (the reference's lookup-buffer fill order)."""
    uniq, first_idx, inv = np.unique(codes, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    site_id = rank[inv.reshape(-1)].astype(np.int32)
    id_site = first_idx[order].astype(np.int32)
    return site_id, id_site, int(uniq.size)


@dataclass
class RepeatsTable:
    """Per-node class structure for one partition."""
    nodes: int
    sites: int
    site_id: np.ndarray = field(init=False)   # [nodes, sites] int32
    id_site: np.ndarray = field(init=False)   # [nodes, sites] int32
    ids: np.ndarray = field(init=False)       # [nodes] int32; 0 = plain
    # the native classer's pair lookup buffer (all -1 between calls)
    _lookup: Optional[np.ndarray] = field(init=False, default=None,
                                          repr=False)

    def __post_init__(self):
        # identity mapping = repeats disabled
        ident = np.tile(np.arange(self.sites, dtype=np.int32),
                        (self.nodes, 1))
        self.site_id = ident.copy()
        self.id_site = ident.copy()
        self.ids = np.zeros(self.nodes, dtype=np.int32)

    def reset_node(self, node: int) -> None:
        """Restore the identity mapping (repeats disabled) for one node."""
        ident = np.arange(self.sites, dtype=np.int32)
        self.site_id[node, :] = ident
        self.id_site[node, :] = ident
        self.ids[node] = 0

    def classes(self, node: int) -> int:
        """Effective class count (sites when repeats are off)."""
        n = int(self.ids[node])
        return n if n else self.sites

    def set_tip(self, tip_index: int, codes: np.ndarray) -> None:
        """Class tips by state code (pll_update_repeats_tips)."""
        codes = np.asarray(codes, dtype=np.uint64)
        nat = native.repeats_tips(codes)
        site_id, id_site, ids = (nat if nat is not None
                                 else _first_occurrence_classes(codes))
        self.site_id[tip_index, :] = site_id
        self.id_site[tip_index, :ids] = id_site
        self.id_site[tip_index, ids:] = 0
        self.ids[tip_index] = ids

    def enable_for(self, left: int, right: int) -> bool:
        """pll_default_enable_repeats (repeats.c:100-110)."""
        li, ri = int(self.ids[left]), int(self.ids[right])
        if not li or not ri:
            return False
        if li * ri >= LOOKUP_BUFFER_SIZE:
            return False
        return li <= self.sites // 2 and ri <= self.sites // 2

    def update_op(self, op) -> None:
        """Class the parent by (left class, right class) pairs
        (pll_update_repeats, repeats.c:299-383)."""
        p = op.parent_clv_index
        l, r = op.child1_clv_index, op.child2_clv_index
        if not self.enable_for(l, r):
            self.reset_node(p)
            return
        li, ri = int(self.ids[l]), int(self.ids[r])
        if self._lookup is None or self._lookup.size < li * ri:
            self._lookup = np.full(li * ri, -1, dtype=np.int32)
        nat = native.repeats_update(self.site_id[l], self.site_id[r], li,
                                    li * ri, self._lookup)
        if nat is not None:
            site_id, id_site, ids = nat
        else:
            site_id, id_site, ids = _first_occurrence_classes(
                self.site_id[l].astype(np.int64)
                + self.site_id[r].astype(np.int64) * li)
        if ids >= self.sites:         # no compression: force plain
            self.reset_node(p)
            return
        self.ids[p] = ids
        self.site_id[p, :] = site_id
        self.id_site[p, :ids] = id_site
        self.id_site[p, ids:] = 0

    def gathers_for(self, op) -> Tuple[np.ndarray, np.ndarray, int]:
        """Child class-column index per parent class (the kernels' gather
        maps): gl[c] = left class feeding parent class c. Width = parent's
        effective class count."""
        p = op.parent_clv_index
        l, r = op.child1_clv_index, op.child2_clv_index
        width = self.classes(p)
        rep = self.id_site[p, :width] if self.ids[p] \
            else np.arange(width, dtype=np.int32)
        gl = self.site_id[l, rep]
        gr = self.site_id[r, rep]
        return gl.astype(np.int32), gr.astype(np.int32), width


@dataclass
class FlatLayout:
    """Pooled class-column storage map (reference: repeats.c:256-296
    reallocate_repeats).

    A repeats partition stores one column pool [rate, state, total]: node n
    owns columns [off[n], off[n]+cap[n]) where cap[n] is its class count
    rounded up to a bucket (`bucket_width`). Scalers pool likewise, with two
    extra full-width regions: trash (absorbs the counts of ops without a
    scaler buffer) and a guaranteed-zero region (serves SCALE_BUFFER_NONE
    reads)."""
    caps: np.ndarray        # [nodes] int64 column capacity per node
    off: np.ndarray         # [nodes] int64 column offset per node
    total: int              # pool column count (incl. scratch tail)
    sc_caps: np.ndarray     # [K] per-scaler capacities
    sc_off: np.ndarray      # [K] scaler offsets
    sc_trash: int           # offset of the trash region (width = s_pad)
    sc_zero: int            # offset of the guaranteed-zero region
    sc_total: int


def build_flat_layout(table: RepeatsTable, scaler_of: dict,
                      sites: int, scale_buffers: int,
                      lane: int = 128, sc_floor=None) -> FlatLayout:
    """Column-pool layout from the current class table.

    scaler_of: {scaler_index -> list of nodes whose class columns index it};
    a scaler's capacity is the largest of those nodes' capacities, and at
    least sc_floor[k] where given. The pool ends with an `s_pad`-wide
    scratch tail, as in the JAX package."""
    nodes = table.nodes
    s_pad = -(-sites // lane) * lane        # lane-aligned width ceiling
    caps = np.zeros(nodes, dtype=np.int64)
    off = np.zeros(nodes, dtype=np.int64)
    cur = 0
    for n in range(nodes):
        caps[n] = bucket_width(table.classes(n), sites, lane)
        off[n] = cur
        cur += caps[n]
    total = cur + s_pad

    sc_caps = np.zeros(scale_buffers, dtype=np.int64)
    sc_off = np.zeros(scale_buffers, dtype=np.int64)
    cur = 0
    for k in range(scale_buffers):
        users = scaler_of.get(k)
        sc_caps[k] = max(caps[n] for n in users) if users else 0
        if sc_floor is not None:
            sc_caps[k] = max(sc_caps[k], sc_floor[k])
        sc_off[k] = cur
        cur += sc_caps[k]
    sc_trash = cur
    cur += s_pad
    sc_zero = cur
    cur += s_pad
    return FlatLayout(caps=caps, off=off, total=int(total),
                      sc_caps=sc_caps, sc_off=sc_off,
                      sc_trash=int(sc_trash), sc_zero=int(sc_zero),
                      sc_total=int(cur))


def bucket_width(classes: int, sites: int, lane: int = 128) -> int:
    """Round a class count up to a power-of-two multiple of the lane width,
    capped at the lane-aligned site count (the JAX package's widths, kept
    so that the two pools line up)."""
    cap = -(-sites // lane) * lane
    w = lane
    while w < classes:
        w *= 2
    return min(w, cap)


def classify_operations(table: RepeatsTable,
                        operations: Sequence,
                        sites: int,
                        scale_buffers: int,
                        lane: int = 128,
                        update_repeats: bool = True,
                        previous: "FlatLayout" = None):
    """Update the class table op by op (skipped with `update_repeats`
    False: the tables stay as they are, pll_update_partials_rep with
    update_repeats=0) and lay out the pool. Scalers that the list does not
    write keep their capacity in `previous`, the layout the pool holds now,
    so that their counts can be carried over.

    Returns (layout, per_op) with per_op = [(W, op, gl, gr)] in list order:
    W is the parent's bucket width, gl/gr its gather maps (length = the
    parent's class count)."""
    per_op = []
    scaler_of: Dict[int, List[int]] = {}
    for op in operations:
        if update_repeats:
            table.update_op(op)
        gl, gr, width = table.gathers_for(op)
        per_op.append((bucket_width(width, sites, lane), op, gl, gr))
        if op.parent_scaler_index >= 0:
            scaler_of.setdefault(op.parent_scaler_index, []).append(
                op.parent_clv_index)
    floor = None
    if previous is not None:
        floor = previous.sc_caps.copy()
        floor[list(scaler_of)] = 0           # rewritten: the writers decide
    for op in operations:
        for c, k in ((op.child1_clv_index, op.child1_scaler_index),
                     (op.child2_clv_index, op.child2_scaler_index)):
            if k >= 0:
                scaler_of.setdefault(k, []).append(c)
    layout = build_flat_layout(table, scaler_of, sites, scale_buffers, lane,
                               sc_floor=floor)
    return layout, per_op


def op_fields(layout: FlatLayout, op) -> List[int]:
    """(p_off, psc_off, c1_off, m1, s1_off, c2_off, m2, s2_off) of one op:
    a missing parent scaler writes the trash region, a missing child scaler
    reads the zero region."""
    psc = op.parent_scaler_index
    s1, s2 = op.child1_scaler_index, op.child2_scaler_index
    return [int(layout.off[op.parent_clv_index]),
            int(layout.sc_off[psc]) if psc >= 0 else layout.sc_trash,
            int(layout.off[op.child1_clv_index]),
            op.child1_matrix_index,
            int(layout.sc_off[s1]) if s1 >= 0 else layout.sc_zero,
            int(layout.off[op.child2_clv_index]),
            op.child2_matrix_index,
            int(layout.sc_off[s2]) if s2 >= 0 else layout.sc_zero]


def schedule_buckets_flat(table: RepeatsTable,
                          operations: Sequence,
                          sites: int,
                          scale_buffers: int,
                          lane: int = 128):
    """The JAX package's flat-pool bucket schedule, kept to check the
    port's tables against JAX's (the port runs levels, ops/pool.py):
    `classify_operations`' layout and its ops grouped by width W in
    increasing order, each width split into order-preserving runs of one
    identity profile. Returns (layout, [(W, fields [n, 8] int32, gl [n, W],
    gr [n, W], ident_l, ident_r)]); fields columns are (p_off, psc_off,
    c1_off, m1, s1_off, c2_off, m2, s2_off), and padding classes gather
    class 0."""
    layout, per_op = classify_operations(table, operations, sites,
                                         scale_buffers, lane)
    groups: Dict[int, List] = {}
    for w, op, gl, gr in per_op:
        groups.setdefault(w, []).append((op, gl, gr))

    buckets = []
    for w in sorted(groups):
        ident = np.arange(w, dtype=np.int32)

        def profile(g1, g2):
            return (bool(g1.size == w and np.array_equal(g1, ident)),
                    bool(g2.size == w and np.array_equal(g2, ident)))

        runs = []
        for op, g1, g2 in groups[w]:
            pr = profile(g1, g2)
            if not runs or runs[-1][0] != pr:
                runs.append((pr, []))
            runs[-1][1].append((op, g1, g2))

        for (il, ir), run in runs:
            n = len(run)
            fields = np.zeros((n, 8), dtype=np.int32)
            glm = np.zeros((n, w), dtype=np.int32)
            grm = np.zeros((n, w), dtype=np.int32)
            for i, (op, g1, g2) in enumerate(run):
                fields[i] = op_fields(layout, op)
                glm[i, :g1.size] = g1
                grm[i, :g2.size] = g2
            buckets.append((w, fields, glm, grm, il, ir))
    return layout, buckets


def schedule_buckets(table: RepeatsTable,
                     operations: Sequence,
                     sites: int,
                     lane: int = 128
                     ) -> List[Tuple[int, list, np.ndarray, np.ndarray]]:
    """Group the postorder operation list into capacity buckets: updates
    the class table for each op in order, then groups ops by padded width.
    Returns [(width, ops, gl [n, width], gr [n, width])] in execution
    order."""
    per_op = []
    for op in operations:
        table.update_op(op)
        gl, gr, width = table.gathers_for(op)
        per_op.append((bucket_width(width, sites, lane), op, gl, gr))

    groups: Dict[int, List] = {}
    for w, op, gl, gr in per_op:
        groups.setdefault(w, []).append((op, gl, gr))

    out = []
    for w in sorted(groups):
        ops = [g[0] for g in groups[w]]
        gl = np.zeros((len(ops), w), dtype=np.int32)
        gr = np.zeros((len(ops), w), dtype=np.int32)
        for i, (_, g1, g2) in enumerate(groups[w]):
            gl[i, :g1.size] = g1
            gr[i, :g2.size] = g2
        out.append((w, ops, gl, gr))
    return out
