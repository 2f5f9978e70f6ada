"""The whole postorder traversal in one kernel launch.

Port of libpll2_tpu/ops/pallas_fused.py. The host packs the postorder into
an op table whose inner CLVs live in a small set of reusable slots
(`pack_fused_schedule`); one launch walks the table for every site and
returns only the root edge's two CLVs and their scaler counts. Tips enter
as int32 state bitmasks (`tip_code_matrix`) and are decoded on the fly, or,
for tips set with `Partition.set_tip_clv`, as raw probability rows
(`tip_clv_matrix`, [n_ctips, states, S], the same for every rate).

`fused_traversal` is the entry point. For CPU tensors it runs
`fused_traversal_reference`, the plain PyTorch version of the walk. For
CUDA tensors it launches a hand-written kernel: alphabets below
`ROWS_STATES_MIN` states take csrc/fused_traversal.cu (counted in
`fused_traversal.launches`), larger ones (proteins) take
csrc/fused_traversal_rows.cu through `fused_traversal_rows` (counted in
`fused_traversal_rows.launches`).

Both take one topology or K candidates (the candidate form, for candidate
scoring; libpll2_tpu vmaps its Pallas kernels over them): K op tables
[K, n_ops+1, 8] and P [K, E, R, s, s] that share the tip codes and raw tip
rows walk in ONE launch, one more grid dimension, and every output gains a
leading K. One topology is the kernels' K = 1. `fused_candidate_from_tree`
packs the current topology of a tree in one walk, without Operation
objects.

The query form (placement: libpll2_tpu/placement.py:_place_scores vmaps the
Pallas kernel over Q queries' tip codes) adds Q queries, `query_codes` [Q,
S], to the candidate form: every (query, candidate) pair walks in ONE
launch, the query's codes standing in for tip row `query_row` and every
other tip row shared, and every output gains a leading [Q, K]. Each launch
counts in `launches` and in `query_launches`. `query_edge_split` bounds the
candidates (attachment edges) a launch takes by the device memory of its
walks, `QUERY_LAUNCH_BYTES`: the root rows, and on a spill plan the slots
(`query_spill_slots`).

Semantics (per op row [pslot, l_is_tip, l_idx, m1, r_is_tip, r_idx, m2,
has_scaler]; is_tip 0 is a slot, 1 a state-code tip, 2 a row of the raw
tip matrix): x = (P[m1] . left) * (P[m2] . right) per rate; when
has_scaler and max over all rates and states of x < threshold, the site is
multiplied by `factor` and its count grows by one; counts of the children
are added, tips count 0. With `rate_scalers` (PLL_ATTRIB_RATE_SCALERS,
core_partials.c:760-771) each rate block is compared with the threshold
and rescaled on its own, and the counts are [R, S], one per rate.

Contraction modes (`mxu`, libpll2_tpu's names and numerics; they act on
float32 with `ROWS_STATES_MIN` or more states, as in JAX, and smaller
alphabets always contract exactly):
  'split' -- JAX's three-term bf16 product (pallas_fused.py:_fused_kernel's
      unified MXU path): P and every child, slot rows, raw tip rows and
      state-code tips alike, are split into a bf16 pair (`split_bf16`: hi
      the half-up rounding, lo the residual rounded to nearest even; a
      code tip's lo is 0), and each rate's product is Ph.ch + Ph.cl + Pl.ch
      with float32 products (exact: bf16 times bf16) and float32 sums.
      The rows kernel runs it on the tensor cores (wgmma).
  'bf16' -- one bf16 term: P and every inner-child CLV value rounded to
      bf16 half-up (`round_bf16`, the hi part of split_bf16), raw tip
      values to nearest even (`round_bf16_rne`, the `astype(bfloat16)` that
      JAX's kernel applies to them), state-code tips' 0/1 indicators exact;
      products and sums float32. Also on the tensor cores in the rows
      kernel.
  'highest' -- exact float32 products and sums (CUDA-core FMAs in the
      rows kernel).
float64 contracts exactly in every mode, as libpll2_tpu's float64 path
does. `fused_traversal_f64` is the walk in float64 on the card (the certified
final evaluation, ops/df64.py): csrc/fused_traversal.cu's runtime-size body
instantiated on double, one topology, per-site counts, counted in
`fused_traversal_f64.launches`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["pack_fused_schedule", "fused_candidate_from_tree",
           "tip_code_matrix", "ctip_rows", "tip_clv_matrix",
           "fused_traversal", "fused_traversal_rows", "fused_traversal_f64",
           "fused_traversal_reference", "round_bf16", "round_bf16_rne",
           "split_bf16", "split_fused_schedule", "fused_split_reference",
           "FusedSplit", "FusedSplits",
           "query_edge_split", "query_spill_slots", "MXU_MODES",
           "ROWS_STATES_MIN", "FUSED_MAX_STATES", "ROWS_RATE_SCALERS_MAX",
           "QUERY_LAUNCH_BYTES"]

MXU_MODES = ("split", "bf16", "highest")
# alphabets from this size on take the row-layout kernel and the mxu modes
# (libpll2_tpu/ops/pallas_fused.py:PLANE_STATES_MAX)
ROWS_STATES_MIN = 16
# the most states the fused kernels take: their tip codes are int32 masks
# (`tip_code_matrix`); TreeEngine routes larger alphabets to the level and
# pool kernels (JAX's 'fused' casts the uint64 masks to int32 there and
# returns -inf: ROADMAP C-J1)
FUSED_MAX_STATES = 32
# the rows route takes per-rate scalers for at most this many categories,
# as libpll2_tpu's row-layout kernel (pallas_fused.py:747-756), whose [8, T]
# scaler block holds one count row per rate
ROWS_RATE_SCALERS_MAX = 8
# the device memory one launch of the query form may take for its walks:
# the root rows (both CLVs and counts of every walk) and, on a spill plan,
# the slots; at 16 queries x 251 edges x 16384 DNA sites the root rows alone
# take 8.4 GB, so a chunk's edges are split over launches above this
QUERY_LAUNCH_BYTES = 2 << 30
# the slots the query form's plain version holds at once (it walks a piece
# of the candidates at a time below this)
QUERY_REFERENCE_BYTES = 1 << 30


def _check_mxu(mxu: str) -> None:
    if mxu not in MXU_MODES:
        raise ValueError(f"mxu must be one of {MXU_MODES}, got {mxu!r}")


def query_edge_split(queries: int, edges: int, rates: int, states: int,
                     sites: int, rate_scalers: bool,
                     budget: int = QUERY_LAUNCH_BYTES,
                     slots: int = 0) -> int:
    """The edges (candidates) one launch of the query form takes for
    `queries` queries: all `edges` when the launch's walks fit in `budget`
    bytes, else the most that fit, at least one. A walk takes its root rows
    (two float32 CLVs [R, s, S] and two int32 count rows) and its `slots`
    spill slots (`query_spill_slots`: a CLV and at most a count row each)."""
    walk = (2 + slots) * 4 * sites * (rates * states
                                      + (rates if rate_scalers else 1))
    return max(1, min(edges, budget // (queries * walk)))


def query_spill_slots(device, rates: int, states: int, n_slots: int,
                      rate_scalers: bool, sites: int,
                      raw_tips: bool = False, mxu: str = "split") -> int:
    """The slots a walk of the query form keeps in device memory on
    `device`: the spill plan's (ops/_kernels.py:spill_slots; the rows
    kernel's from ROWS_STATES_MIN states, else fused_plan's, with raw tip
    rows staged where `raw_tips`), none on chip, and none on the CPU, whose
    plain version holds its own within QUERY_REFERENCE_BYTES."""
    if torch.device(device).type != "cuda":
        return 0
    from . import _kernels

    if states >= ROWS_STATES_MIN:
        plan = _kernels.device_rows_plan(device, rates, states, n_slots,
                                         rate_scalers, sites, mxu=mxu)
    else:
        plan = _kernels.device_fused_plan(device, rates, states, n_slots,
                                          rate_scalers, sites,
                                          raw_tips=raw_tips)
    return _kernels.spill_slots(plan, n_slots)


def _check_rows_rate_scalers(rates: int, rate_scalers: bool) -> None:
    if rate_scalers and rates > ROWS_RATE_SCALERS_MAX:
        raise ValueError(
            f"fused-kernel per-rate scalers above {ROWS_RATE_SCALERS_MAX} "
            f"rate categories need the small-alphabet route (fewer than "
            f"{ROWS_STATES_MIN} states); got {rates} categories")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bf16 precision, kept as float32: the top
    16 bits after a half-up carry, `(bits + 0x8000) & 0xFFFF0000`
    (libpll2_tpu/ops/pallas_fused.py:split_bf16's hi part). The rows
    kernel rounds with the same bit operation."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x8000, -0x10000).view(torch.float32)


def round_bf16_rne(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bf16, ties to even, kept as
    float32 (`x.astype(bfloat16)` in JAX, `.to(torch.bfloat16)` here). The
    rows kernel rounds raw tip values with the same bit operation."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor):
    """float32 values split into a bf16 pair kept as float32, (hi, lo):
    hi = `round_bf16(x)`, lo = `round_bf16_rne(x - hi)`, so that hi + lo is
    x to ~2^-17 relative (libpll2_tpu/ops/pallas_fused.py:split_bf16, the
    operands of the 'split' mode). The rows kernel splits with the same
    bit operations."""
    hi = round_bf16(x)
    return hi, round_bf16_rne(x - hi)


def _mode_operands(mxu: str, states: int, dtype):
    """(bf16, split): which rounded contraction a walk in `dtype` runs."""
    rounded = states >= ROWS_STATES_MIN and dtype == torch.float32
    return rounded and mxu == "bf16", rounded and mxu == "split"


def _split_p(pmatrix: torch.Tensor) -> torch.Tensor:
    """P [..., s, s] as 'split''s K-stacked weights [..., s, 3s]: [Ph | Ph |
    Pl], against a child stacked as [ch; cl; ch] (`_split_child`), as JAX
    concatenates them (pallas_fused.py:_fused_kernel's mv_inner)."""
    ph, pl = split_bf16(pmatrix)
    return torch.cat([ph, ph, pl], dim=-1)


def _split_child(clv: torch.Tensor, is_code_tip) -> torch.Tensor:
    """A child [..., s, S] stacked as [ch; cl; ch] along its states: a
    state-code tip's 0/1 indicator is its own hi and its lo is 0."""
    if is_code_tip is True:
        return torch.cat([clv, torch.zeros_like(clv), clv], dim=-2)
    hi, lo = split_bf16(clv)
    if is_code_tip is not False:     # a mask over the walks (query form)
        lo = torch.where(is_code_tip, torch.zeros_like(lo), lo)
        hi = torch.where(is_code_tip, clv, hi)
    return torch.cat([hi, lo, hi], dim=-2)


def pack_fused_schedule(operations, n_tips: int, root_pair,
                        clv_tip_rows=None):
    """Linear-scan register allocation of the postorder onto CLV slots.

    Returns (table [n_ops+1, 8] int32, n_slots). Table rows per op:
      [parent_slot, l_is_tip, l_idx, m1, r_is_tip, r_idx, m2, has_scaler]
    where l_idx/r_idx is a tip row (is_tip=1), a row of the raw tip-CLV
    matrix (is_tip=2, set_tip_clv tips) or a slot id (is_tip=0). The extra
    last row holds the root edge:
      [p_is_tip, p_idx, c_is_tip, c_idx, 0, 0, 0, 0].
    `clv_tip_rows`, if given, maps a tip's clv_index to its row of
    `tip_clv_matrix` (-1 for a state-code tip).

    Returns (None, 0) when the list is not a postorder the kernel supports
    (an op consumes a CLV that was never produced, or an inner op lacks a
    scaler buffer).
    """
    root_p, root_c = root_pair

    def tip_entry(c):
        if clv_tip_rows is not None and clv_tip_rows[c] >= 0:
            return 2, int(clv_tip_rows[c])
        return 1, c

    last_use = {}
    for k, op in enumerate(operations):
        for c in (op.child1_clv_index, op.child2_clv_index):
            if c >= n_tips:
                last_use[c] = k
    n_ops = len(operations)
    for rn in (root_p, root_c):
        if rn >= n_tips:
            last_use[rn] = n_ops          # alive until the end

    free: list = []
    slot_of: dict = {}
    n_slots = 0
    table = np.zeros((n_ops + 1, 8), dtype=np.int32)
    for k, op in enumerate(operations):
        if op.parent_scaler_index < 0:
            return None, 0                 # kernel assumes scaler per op
        row = [0] * 8
        for pos, (c, m) in enumerate(
                ((op.child1_clv_index, op.child1_matrix_index),
                 (op.child2_clv_index, op.child2_matrix_index))):
            if c < n_tips:
                row[1 + 3 * pos], row[2 + 3 * pos] = tip_entry(c)
            else:
                if c not in slot_of:
                    return None, 0         # consumed before produced
                row[1 + 3 * pos] = 0
                row[2 + 3 * pos] = slot_of[c]
            row[3 + 3 * pos] = m
        # free dying children BEFORE allocating the parent: the kernels
        # read both children completely before writing, so the parent may
        # reuse a dead child's slot
        for c in (op.child1_clv_index, op.child2_clv_index):
            if c >= n_tips and last_use.get(c) == k:
                free.append(slot_of.pop(c))
        if free:
            ps = free.pop()
        else:
            ps = n_slots
            n_slots += 1
        slot_of[op.parent_clv_index] = ps
        row[0] = ps
        row[7] = 1
        table[k] = row

    def root_entry(c):
        if c < n_tips:
            return tip_entry(c)
        if c not in slot_of:
            return None
        return 0, slot_of[c]

    pe, ce = root_entry(root_p), root_entry(root_c)
    if pe is None or ce is None:
        return None, 0
    table[n_ops] = [pe[0], pe[1], ce[0], ce[1], 0, 0, 0, 0]
    return table, max(n_slots, 1)


class FusedSplit(NamedTuple):
    """One walk's table split over the `parts` blocks of a thread block
    cluster (`split_fused_schedule`): `table` [n_ops + 1 +
    FUSED_SPLIT_HEADER, 8] int32, the blocks' programs one after another,
    the root edge's row at n_ops as in the packed table, then the header;
    `n_slots` the slots of the largest program; `critical` the ops run one
    after another: the longest block's stream, then the top stream."""
    table: np.ndarray
    parts: int
    n_slots: int
    critical: int


# The split table (csrc/fused_traversal.cu, fused_onchip in a cluster):
# after the root edge's row, FUSED_SPLIT_HEADER rows: the first row of each
# block's program, the row past its last, then [join, parts, n_slots, 0...],
# `join` the first row of the top stream, which block 0 runs after its own
# stream once every peer has finished its own. A child entry with is_tip
# FUSED_REMOTE is a slot in a peer's shared memory, its index rank <<
# FUSED_RANK_SHIFT | slot. FUSED_MAX_PARTS blocks a cluster at most (the
# portable cluster size).
FUSED_SPLIT_HEADER = 3
FUSED_REMOTE = 3
FUSED_RANK_SHIFT = 16
FUSED_MAX_PARTS = 8


def _trivial_split(table: np.ndarray) -> FusedSplit:
    """The packed table as a split of one part: the walk as it is."""
    n_ops = len(table) - 1
    out = np.zeros((n_ops + 1 + FUSED_SPLIT_HEADER, 8), dtype=np.int32)
    out[:n_ops + 1] = table
    n_slots = int(table[:n_ops, 0].max()) + 1 if n_ops else 1
    out[n_ops + 2, 0] = n_ops
    out[n_ops + 3, :3] = [n_ops, 1, n_slots]
    return FusedSplit(out, 1, n_slots, n_ops)


def _op_children(rows: list):
    """Each op's producing ops, by child position (None for a tip), from a
    packed table's rows (lists) whose slots are reused, and the ops the
    root row reads; None where an op's output is read twice or before it
    is written (no tree to split)."""
    n_ops = len(rows) - 1
    writer: dict = {}
    read = [False] * n_ops
    kids = []
    for k in range(n_ops):
        row = rows[k]
        pair = []
        for pos in (0, 1):
            j = None
            if row[1 + 3 * pos] == 0:
                j = writer.get(row[2 + 3 * pos])
                if j is None or read[j]:
                    return None
                read[j] = True
            pair.append(j)
        kids.append(pair)
        writer[row[0]] = k
    ends = []
    for pos in (0, 1):
        j = None
        if rows[n_ops][2 * pos] == 0:
            j = writer.get(rows[n_ops][2 * pos + 1])
            if j is None or read[j]:
                return None
            read[j] = True
        ends.append(j)
    return kids, ends, read


def _pack_bins(parts, size, n_bins):
    """Longest first onto the least loaded bin (ties to the lower bin):
    the bins' op counts and their parts."""
    load = [0] * n_bins
    bins: list = [[] for _ in range(n_bins)]
    for p in sorted(parts, key=lambda p: (-size[p], p)):
        b = load.index(min(load))
        load[b] += size[p]
        bins[b].append(p)
    return load, bins


def _allocate(program, kids, inside):
    """Linear-scan slots of one block's program, as pack_fused_schedule
    allocates them: a child read here frees its slot at its last read
    before the parent takes one; an op read elsewhere (the root row, a peer)
    or never keeps its slot. Returns ({op: slot}, slots)."""
    last = {}
    for i, k in enumerate(program):
        for j in kids[k]:
            if j is not None and j in inside:
                last[j] = i
    free: list = []
    slot: dict = {}
    n = 0
    for i, k in enumerate(program):
        for j in kids[k]:
            if j is not None and last.get(j) == i:
                free.append(slot[j])
        if free:
            slot[k] = free.pop()
        else:
            slot[k] = n
            n += 1
    return slot, max(n, 1)


def split_fused_schedule(table, parts: int) -> FusedSplit:
    """A packed table (`pack_fused_schedule`) split over `parts` blocks
    that walk the same sites side by side: disjoint subtrees on each block,
    each a postorder with its own slots (the same linear scan), then the
    top stream, the ops above the subtree roots, which block 0 runs after
    its own, reading the roots that its peers hold (FUSED_REMOTE). The
    split starts from the root edge's two subtrees and splits the largest
    part at its root (the root op joins the top stream) while that shortens
    the critical path; the parts go longest first onto the least loaded
    block; block 0 is the least loaded, the top stream after it. A table
    that does not split (a single op, or an op read twice) and `parts` 1
    give the packed table as it is. Every op keeps its row but for its
    slots, so each block computes what the whole walk computes, to the
    bit."""
    table = np.asarray(table, dtype=np.int32)
    n_ops = len(table) - 1
    if not 1 <= parts <= FUSED_MAX_PARTS:
        raise ValueError(f"split_fused_schedule: {parts} parts, not 1 to "
                         f"{FUSED_MAX_PARTS}")
    rows = table.tolist()
    tree = _op_children(rows) if parts > 1 and n_ops > 1 else None
    if tree is None:
        return _trivial_split(table)
    kids, ends, read = tree
    size = [0] * n_ops
    for k in range(n_ops):
        size[k] = 1 + sum(size[j] for j in kids[k] if j is not None)
    # the parts: subtrees nothing reads but the root row (or nothing)
    current = [k for k in range(n_ops) if not read[k]] + [
        j for j in ends if j is not None]
    top: list = []

    def critical(cur, n_top):
        return max(_pack_bins(cur, size, parts)[0]) + n_top

    best = (critical(current, 0), list(current), [])
    while len(current) < 4 * parts:
        big = max(current, key=lambda p: (size[p], p))
        inner = [j for j in kids[big] if j is not None]
        # every later split adds one op to the top stream, and no block
        # runs fewer than its share
        if not inner or len(top) + 1 + -(-(n_ops - len(top) - 1)
                                        // parts) >= best[0]:
            break
        current.remove(big)
        current.extend(inner)
        top.append(big)
        c = critical(current, len(top))
        if c < best[0]:
            best = (c, list(current), list(top))
    crit, current, top = best
    if crit >= n_ops:
        return _trivial_split(table)
    top_set = set(top)
    load, bins = _pack_bins(current, size, parts)
    owner = {}

    def collect(p, b):
        stack = [p]
        while stack:
            k = stack.pop()
            owner[k] = b
            stack.extend(j for j in kids[k]
                         if j is not None and j not in top_set)

    for b, ps in enumerate(bins):
        for p in ps:
            collect(p, b)
    # block 0 takes the least loaded bin, then the top stream
    order = sorted(range(parts), key=lambda b: (load[b], b))
    programs = [sorted(k for k in owner if owner[k] == b) for b in order]
    programs[0] += sorted(top)
    where = {}
    n_slots = 1
    for rank, prog in enumerate(programs):
        slot, n = _allocate(prog, kids, set(prog))
        n_slots = max(n_slots, n)
        for k in prog:
            where[k] = (rank, slot[k])

    def entry(j, rank):
        r, s = where[j]
        return (0, s) if r == rank else (FUSED_REMOTE,
                                          r << FUSED_RANK_SHIFT | s)

    out = np.zeros((n_ops + 1 + FUSED_SPLIT_HEADER, 8), dtype=np.int32)
    head = n_ops + 1
    at = 0
    for rank in list(range(1, parts)) + [0]:
        out[head, rank] = at
        for k in programs[rank]:
            row = list(rows[k])
            row[0] = where[k][1]
            for pos, j in enumerate(kids[k]):
                if j is not None:
                    row[1 + 3 * pos], row[2 + 3 * pos] = entry(j, rank)
            out[at] = row
            at += 1
        out[head + 1, rank] = at
    out[n_ops] = table[n_ops]
    for pos, j in enumerate(ends):
        if j is not None:
            out[n_ops, 2 * pos], out[n_ops, 2 * pos + 1] = entry(j, 0)
    out[head + 2, :3] = [n_ops - len(top), parts, n_slots]
    return FusedSplit(out, parts, n_slots, crit)


class FusedSplits:
    """The subtree splits (`split_fused_schedule`) of a packed table
    [n_ops+1, 8], or of K candidates' tables [K, n_ops+1, 8], held on the
    host, each part count split at its first use: called with `parts`, the
    largest slots and critical ops over the candidates (the `split` of
    ops/_kernels.py:fused_plan); `table(parts, device)`, the kernel's split
    tables [K, n_ops+1+FUSED_SPLIT_HEADER, 8] on `device`, uploaded once.
    Whoever packs a table builds its splits from the same array (the
    engine a topology, `_candidate_chunks` a chunk), so a launch never
    reads a table back from the card."""

    def __init__(self, table):
        table = np.asarray(table, dtype=np.int32)
        self.host = table[None] if table.ndim == 2 else table
        self._splits: dict = {}
        self._tables: dict = {}

    def of(self, parts: int) -> list:
        if parts not in self._splits:
            self._splits[parts] = [split_fused_schedule(t, parts)
                                   for t in self.host]
        return self._splits[parts]

    def __call__(self, parts: int) -> tuple:
        got = self.of(parts)
        return (max(x.n_slots for x in got), max(x.critical for x in got))

    def table(self, parts: int, device) -> torch.Tensor:
        key = (parts, torch.device(device))
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(
                np.stack([x.table for x in self.of(parts)]), device=device)
        return self._tables[key]


def fused_candidate_from_tree(vroot, n_tips: int, n_matrices: int,
                              clv_tip_rows=None):
    """The fused kernel's (table, branch vector, root_info, n_slots) for the
    CURRENT topology rooted at `vroot`, in one iterative postorder walk:
    what pack_fused_schedule(create_operations(traverse(vroot))) packs,
    without Operation objects (libpll2_tpu/ops/pallas_fused.py:
    fused_candidate_from_tree; the per-candidate host cost of batched
    NNI/SPR scoring).

    Returns (table [n_ops+1, 8] int32, blens [n_matrices] float64,
    root_info (p_clv, p_scaler, c_clv, c_scaler, root matrix), n_slots), or
    (None, None, None, 0) when the kernel cannot run this topology (an inner
    op without a scaler row, or a node that is not binary)."""
    vback = vroot.back
    blens = np.zeros(n_matrices)
    rows = []
    free: list = []
    slot_of: dict = {}
    n_slots = 0

    def tip_entry(c):
        if clv_tip_rows is not None and clv_tip_rows[c] >= 0:
            return 2, int(clv_tip_rows[c])
        return 1, c

    # as trees.utree.traverse: vroot.back's subtree, then vroot's, children
    # in ring order before their node (postorder)
    stack = [(vroot, False), (vback, False)]
    while stack:
        node, done = stack.pop()
        tip = node.is_tip()
        if not done and not tip:
            stack.append((node, True))
            if node.next.next.next is not node:
                return None, None, None, 0         # not binary
            stack.append((node.next.next.back, False))
            stack.append((node.next.back, False))
            continue
        # the branch toward the traversal root (vroot.back's would repeat
        # vroot's entry)
        if node is not vback:
            blens[node.pmatrix_index] = node.length
        if tip:
            continue
        if node.scaler_index < 0:
            return None, None, None, 0             # the kernel needs one
        row = [0] * 8
        freed = []
        for pos, c in ((0, node.next.back), (1, node.next.next.back)):
            ci = c.clv_index
            if ci < n_tips:
                row[1 + 3 * pos], row[2 + 3 * pos] = tip_entry(ci)
            else:
                # a postorder consumes an inner CLV once: its slot is free
                # for the parent
                s = slot_of.pop(ci, None)
                if s is None:
                    return None, None, None, 0     # not a postorder
                row[2 + 3 * pos] = s
                freed.append(s)
            row[3 + 3 * pos] = c.pmatrix_index
        free.extend(freed)
        if free:
            ps = free.pop()
        else:
            ps = n_slots
            n_slots += 1
        slot_of[node.clv_index] = ps
        row[0] = ps
        row[7] = 1
        rows.append(row)

    table = np.zeros((len(rows) + 1, 8), dtype=np.int32)
    table[:len(rows)] = rows

    def root_entry(c):
        if c < n_tips:
            return tip_entry(c)
        return (0, slot_of[c]) if c in slot_of else None

    pe, ce = root_entry(vroot.clv_index), root_entry(vback.clv_index)
    if pe is None or ce is None:
        return None, None, None, 0
    table[len(rows)] = [pe[0], pe[1], ce[0], ce[1], 0, 0, 0, 0]
    root_info = (vroot.clv_index, vroot.scaler_index, vback.clv_index,
                 vback.scaler_index, vroot.pmatrix_index)
    return table, blens, root_info, max(n_slots, 1)


def tip_code_matrix(partition) -> np.ndarray:
    """int32 state-bitmask matrix [tips, sites_padded]: real sites carry
    the charmap masks, the asc columns the single-state masks (column
    sites + k has 1 << k), the columns of a `sites_alignment` padding 0
    (zero CLVs, zero weight). The kernel needs no padding to a site grain,
    so the port passes no `pad_to`. A shard of a sharded partition
    (partition.py:PartitionShard) takes its block of the parent's."""
    p = partition
    parent = getattr(p, "_parent", None)
    if parent is not None:
        return np.ascontiguousarray(tip_code_matrix(parent)[:, p.lo:p.hi])
    codes = np.zeros((p.tips, p.sites_padded), dtype=np.int32)
    codes[:, :p.sites] = p.tip_states[:, :p.sites].astype(np.int64) \
        .astype(np.int32)
    codes[:, p.sites:p.sites + p.asc_extra] = 1 << np.arange(p.asc_extra)
    return codes


def ctip_rows(partition):
    """Tip clv_index -> row of `tip_clv_matrix` (-1 for a state-code tip),
    or None when no tip was set with set_tip_clv (libpll2_tpu/engine.py:
    _ctip_rows). Rows follow ascending tip index."""
    if not bool(np.any(partition._tips_clv_set)):
        return None
    rows = np.full(partition.tips, -1, np.int32)
    idxs = np.flatnonzero(partition._tips_clv_set)
    rows[idxs] = np.arange(len(idxs), dtype=np.int32)
    return rows


def tip_clv_matrix(partition):
    """The raw tip-CLV rows [n_ctips, states, sites_padded] of the tips set
    with set_tip_clv, ascending by tip index (the order `ctip_rows`
    encodes), in the partition's dtype on its device; None when there is
    none. The values are the same for every rate (pll.c:1063), and the asc
    columns ride along; a sharded partition gathers them from its
    shards."""
    p = partition
    idxs = np.flatnonzero(p._tips_clv_set)
    if len(idxs) == 0:
        return None
    if p.repeats is not None:
        # the identity mapping: a raw tip's columns are per site
        rows = np.stack([p._tip_cols[int(t)] for t in idxs])
        return torch.as_tensor(rows, dtype=p.dtype).to(p.device)
    return p._tip_clv_rows(idxs).contiguous()


def fused_traversal_reference(tip_codes: torch.Tensor,   # [n_tips, S] int32
                              pmatrix: torch.Tensor,     # [E, R, s, s]
                              table,                     # [n_ops+1, 8] int
                              rates: int, states: int, n_slots: int,
                              threshold: float, factor: float,
                              mxu: str = "split", rate_scalers: bool = False,
                              tip_clvs: torch.Tensor = None,
                              query_codes: torch.Tensor = None,
                              query_row: int = -1, splits=None):
    """Plain PyTorch version of the fused traversal, in the dtype of
    `pmatrix` (float32 or float64) and on its device: the op table is
    walked in Python, each op vectorised over sites. `mxu` is the
    contraction mode, `rate_scalers` the per-rate scaler mode and
    `tip_clvs` [n_ctips, s, S] the raw tip rows (module docstring). Returns
    (clv_p, clv_c [R, s, S], sc_p, sc_c [S] int32, or [R, S] per rate) for
    the root edge; in the candidate form (`table` [K, n_ops+1, 8],
    `pmatrix` [K, E, R, s, s]) the candidates one after another, each
    output with a leading K; in the query form (`query_codes` [Q, S] in tip
    row `query_row`, the candidate form's table and P) every output with a
    leading [Q, K], all walks an op at a time (`_query_reference`).
    `splits`, the kernel's subtree splits of the table (`FusedSplits`),
    does not change the function and is not read here."""
    _check_mxu(mxu)
    if query_codes is not None:
        return _query_reference(tip_codes, pmatrix, table, rates, states,
                                n_slots, threshold, factor, mxu,
                                rate_scalers, tip_clvs, query_codes,
                                query_row)
    if table.ndim == 3:
        outs = [fused_traversal_reference(tip_codes, pmatrix[k], table[k],
                                          rates, states, n_slots, threshold,
                                          factor, mxu, rate_scalers,
                                          tip_clvs)
                for k in range(table.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    dtype, device = pmatrix.dtype, pmatrix.device
    sites = tip_codes.shape[1]
    rows = torch.as_tensor(table).cpu().tolist()
    n_ops = len(rows) - 1
    shifts = torch.arange(states, device=device, dtype=torch.int32)
    zero_sc = torch.zeros((rates, sites) if rate_scalers else (sites,),
                          dtype=torch.int32, device=device)
    scale_values = _scale_values(factor, pmatrix)
    slots: list = [None] * n_slots
    bf16, split = _mode_operands(mxu, states, dtype)
    if bf16:
        pmatrix = round_bf16(pmatrix)
    if split:
        pmatrix = _split_p(pmatrix)

    def child(is_tip, idx):
        if is_tip == 1:
            # bit j of the code is state j; a gap sets every bit
            bits = (tip_codes[idx][None, :] >> shifts[:, None]) & 1
            return bits.to(dtype).expand(rates, states, sites), zero_sc
        if is_tip == 2:
            return (tip_clvs[idx].to(dtype).expand(rates, states, sites),
                    zero_sc)
        return slots[idx]

    def operand(is_tip, idx):
        clv, sc = child(is_tip, idx)
        if bf16 and is_tip != 1:
            clv = round_bf16(clv) if is_tip == 0 else round_bf16_rne(clv)
        if split:
            clv = _split_child(clv, is_tip == 1)
        return clv, sc

    for row in rows[:n_ops]:
        slots[row[0]] = _reference_op(pmatrix, row, operand(row[1], row[2]),
                                      operand(row[4], row[5]), threshold,
                                      scale_values, rate_scalers)

    root = rows[n_ops]
    clv_p, sc_p = child(root[0], root[1])
    clv_c, sc_c = child(root[2], root[3])
    return (clv_p.contiguous(), clv_c.contiguous(), sc_p.clone(),
            sc_c.clone())


def _scale_values(factor, pmatrix):
    """The rescale factor and 1 as 0-d tensors of P's dtype and device."""
    return (torch.tensor(factor, dtype=pmatrix.dtype, device=pmatrix.device),
            torch.ones((), dtype=pmatrix.dtype, device=pmatrix.device))


def _reference_op(pmatrix, row, left, right, threshold, scale_values,
                  rate_scalers):
    """One op of the plain walk on its children's (CLVs [R, s, S], counts)
    `left` and `right`: the two products, the rescale test by the factor
    of `scale_values` (`_scale_values`) and the counts (module docstring).
    Returns the parent's (CLVs, counts)."""
    (lclv, lsc), (rclv, rsc) = left, right
    x = (torch.einsum('rij,rjs->ris', pmatrix[row[3]], lclv)
         * torch.einsum('rij,rjs->ris', pmatrix[row[6]], rclv))
    sc = lsc + rsc
    if row[7]:
        fac, one = scale_values
        if rate_scalers:
            scale = torch.amax(x, dim=1) < threshold                # [R, S]
            x = x * torch.where(scale, fac, one)[:, None, :]
        else:
            scale = torch.amax(x, dim=(0, 1)) < threshold           # [S]
            x = x * torch.where(scale, fac, one)
        sc = sc + scale.to(torch.int32)
    return x, sc


def fused_split_reference(tip_codes: torch.Tensor, pmatrix: torch.Tensor,
                          split_table, rates: int, states: int,
                          threshold: float, factor: float,
                          rate_scalers: bool = False,
                          tip_clvs: torch.Tensor = None):
    """The plain version of a walk split over a cluster's blocks
    (`split_fused_schedule`'s table [n_ops + 1 + FUSED_SPLIT_HEADER, 8], or
    K of them with P [K, E, R, s, s]), as the cluster runs it: each peer's
    program in slots of its own, then block 0's, whose top stream reads the
    peers' subtree roots (FUSED_REMOTE entries), then the root row in block
    0. Every op is `fused_traversal_reference`'s arithmetic on the same
    children, so the outputs equal its walk of the packed table to the bit.
    Returns (clv_p, clv_c, sc_p, sc_c) as that function does."""
    if split_table.ndim == 3:
        outs = [fused_split_reference(tip_codes, pmatrix[k], split_table[k],
                                      rates, states, threshold, factor,
                                      rate_scalers, tip_clvs)
                for k in range(split_table.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    dtype, device = pmatrix.dtype, pmatrix.device
    sites = tip_codes.shape[1]
    rows = torch.as_tensor(split_table).cpu().tolist()
    n_ops = len(rows) - 1 - FUSED_SPLIT_HEADER
    begin, end, (_, parts, n_slots) = (rows[n_ops + 1], rows[n_ops + 2],
                                       rows[n_ops + 3][:3])
    shifts = torch.arange(states, device=device, dtype=torch.int32)
    zero_sc = torch.zeros((rates, sites) if rate_scalers else (sites,),
                          dtype=torch.int32, device=device)
    scale_values = _scale_values(factor, pmatrix)
    slots = [[None] * n_slots for _ in range(parts)]
    mask = (1 << FUSED_RANK_SHIFT) - 1

    def child(is_tip, idx, rank):
        if is_tip == 1:
            bits = (tip_codes[idx][None, :] >> shifts[:, None]) & 1
            return bits.to(dtype).expand(rates, states, sites), zero_sc
        if is_tip == 2:
            return (tip_clvs[idx].to(dtype).expand(rates, states, sites),
                    zero_sc)
        if is_tip == FUSED_REMOTE:
            return slots[idx >> FUSED_RANK_SHIFT][idx & mask]
        return slots[rank][idx]

    for rank in list(range(1, parts)) + [0]:
        for row in rows[begin[rank]:end[rank]]:
            slots[rank][row[0]] = _reference_op(
                pmatrix, row, child(row[1], row[2], rank),
                child(row[4], row[5], rank), threshold, scale_values,
                rate_scalers)
    root = rows[n_ops]
    clv_p, sc_p = child(root[0], root[1], 0)
    clv_c, sc_c = child(root[2], root[3], 0)
    return (clv_p.contiguous(), clv_c.contiguous(), sc_p.clone(),
            sc_c.clone())


def _query_reference(tip_codes, pmatrix, table, rates, states, n_slots,
                     threshold, factor, mxu, rate_scalers, tip_clvs,
                     query_codes, query_row):
    """The query form's plain version: the Q x K walks of candidates
    `table` [K, n_ops+1, 8] and `pmatrix` [K, E, R, s, s] with each query's
    codes in tip row `query_row`, op by op over all walks at once (the K
    tables have one length), QUERY_REFERENCE_BYTES of slots at a time.
    Returns the root rows [Q, K, ...]."""
    _check_query_form(table, query_codes)
    q_n, sites = query_codes.shape[0], tip_codes.shape[1]
    k = table.shape[0]
    walk = n_slots * rates * states * sites * pmatrix.element_size()
    step = max(1, QUERY_REFERENCE_BYTES // (q_n * walk))
    if k > step:
        outs = [_query_reference(tip_codes, pmatrix[i:i + step],
                                 table[i:i + step], rates, states, n_slots,
                                 threshold, factor, mxu, rate_scalers,
                                 tip_clvs, query_codes, query_row)
                for i in range(0, k, step)]
        return tuple(torch.cat(o, dim=1) for o in zip(*outs))
    dtype, device = pmatrix.dtype, pmatrix.device
    t = torch.as_tensor(table, device=device).long()
    n_ops = t.shape[1] - 1
    kk = torch.arange(k, device=device)
    shifts = torch.arange(states, device=device, dtype=torch.int64)
    codes, qcodes = tip_codes.long(), query_codes.long()
    bf16, split = _mode_operands(mxu, states, dtype)
    if bf16:
        pmatrix = round_bf16(pmatrix)
    if split:
        pmatrix = _split_p(pmatrix)
    sc_tail = (rates, sites) if rate_scalers else (sites,)
    slots = torch.zeros((q_n, k, n_slots, rates, states, sites), dtype=dtype,
                        device=device)
    slot_sc = torch.zeros((q_n, k, n_slots) + sc_tail, dtype=torch.int32,
                          device=device)
    fac = torch.tensor(factor, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)

    def operand(is_tip, idx, rounded):
        """Each walk's child (is_tip [K], idx [K]): CLVs [Q, K, R, s, S]
        and counts [Q, K, ...], where `rounded` as the kernel's contraction
        reads them: rounded to bf16 in 'bf16', stacked as [ch; cl; ch] in
        'split'."""
        tip_idx = idx.clamp(0, codes.shape[0] - 1)
        c = torch.where((tip_idx == query_row)[None, :, None],
                        qcodes[:, None, :], codes[tip_idx][None])
        x = ((c[:, :, None, :] >> shifts[:, None]) & 1).to(dtype)
        x = x[:, :, None].expand(q_n, k, rates, states, sites)
        pick = (is_tip == 1)[None, :, None, None, None]
        if tip_clvs is not None:
            raw = tip_clvs[idx.clamp(0, tip_clvs.shape[0] - 1)].to(dtype)
            if rounded and bf16:
                raw = round_bf16_rne(raw)
            x = torch.where((is_tip == 2)[None, :, None, None, None],
                            raw[None, :, None], x)
            pick = pick | (is_tip == 2)[None, :, None, None, None]
        slot_idx = idx.clamp(0, n_slots - 1)
        sl = slots[:, kk, slot_idx]
        if rounded and bf16:
            sl = round_bf16(sl)
        inner = (is_tip == 0)
        sc = torch.where(inner.view((1, k) + (1,) * len(sc_tail)),
                         slot_sc[:, kk, slot_idx], 0)
        x = torch.where(pick, x, sl)
        if rounded and split:
            x = _split_child(x, (is_tip == 1)[None, :, None, None, None])
        return x, sc

    for op in range(n_ops):
        row = t[:, op]
        left, lsc = operand(row[:, 1], row[:, 2], True)
        right, rsc = operand(row[:, 4], row[:, 5], True)
        x = (torch.einsum('krij,qkrjs->qkris', pmatrix[kk, row[:, 3]], left)
             * torch.einsum('krij,qkrjs->qkris', pmatrix[kk, row[:, 6]],
                            right))
        has = (row[:, 7] != 0)
        if rate_scalers:
            scale = (torch.amax(x, dim=3) < threshold) & has[None, :, None,
                                                            None]
            x = x * torch.where(scale, fac, one)[:, :, :, None, :]
        else:
            scale = (torch.amax(x, dim=(2, 3)) < threshold) & has[None, :,
                                                                 None]
            x = x * torch.where(scale, fac, one)[:, :, None, None, :]
        slots[:, kk, row[:, 0]] = x
        slot_sc[:, kk, row[:, 0]] = lsc + rsc + scale.to(torch.int32)
    root = t[:, n_ops]
    clv_p, sc_p = operand(root[:, 0], root[:, 1], False)
    clv_c, sc_c = operand(root[:, 2], root[:, 3], False)
    return (clv_p.contiguous(), clv_c.contiguous(), sc_p.contiguous(),
            sc_c.contiguous())


def _launch(launch, tip_codes, pmatrix, table, *args, **kw):
    """A candidate-form launcher on K candidates, or on one topology as
    K = 1."""
    if table.dim() == 3:
        return launch(tip_codes, pmatrix, table, *args, **kw)
    out = launch(tip_codes, pmatrix[None], table[None], *args, **kw)
    return tuple(o[0] for o in out)


def fused_traversal(tip_codes: torch.Tensor,   # [n_tips, S] int32 bitmasks
                    pmatrix: torch.Tensor,     # [(K,) E, R, s, s]
                    table: torch.Tensor,       # [(K,) n_ops+1, 8] int32
                    rates: int, states: int, n_slots: int,
                    threshold: float, factor: float, mxu: str = "split",
                    rate_scalers: bool = False,
                    tip_clvs: torch.Tensor = None,
                    query_codes: torch.Tensor = None, query_row: int = -1,
                    splits: FusedSplits = None):
    """One full postorder; returns (clv_p, clv_c, sc_p, sc_c) for the root
    edge: CLVs [R, s, S], scaler counts [S] int32 ([R, S] with
    `rate_scalers`). `mxu` is the contraction mode (module docstring);
    below `ROWS_STATES_MIN` states it is ignored. `tip_clvs` [n_ctips, s,
    S] holds the raw tip rows that is_tip == 2 table entries index. The
    candidate form, `table` [K, n_ops+1, 8] and `pmatrix` [K, E, R, s, s]
    (the tip operands shared), walks K topologies in one launch and returns
    each output with a leading K; `n_slots` is then the largest over the
    candidates. The query form adds `query_codes` [Q, S] int32, the codes
    of Q queries that stand in for tip row `query_row` (placement): the Q x
    K walks run in one launch and every output gains a leading [Q, K].
    `splits`, the `FusedSplits` of the host array `table` was uploaded
    from, lets the 4 x 4 on-chip body walk each table's subtrees on the
    blocks of a thread block cluster where the plan finds that faster
    (ops/_kernels.py:fused_plan); without it a block walks a whole table.

    CUDA tensors launch a hand-written kernel (float32 only) on the
    current stream, without synchronising, or raise: fused_traversal.cu
    below `ROWS_STATES_MIN` states, else `fused_traversal_rows` (per-rate
    scalers there for at most ROWS_RATE_SCALERS_MAX categories, as in
    JAX). `launches` counts launches, not candidates. CPU tensors run
    `fused_traversal_reference`. The table's indices are trusted: callers
    build it with `pack_fused_schedule` or `fused_candidate_from_tree`,
    whose tip, raw-tip and slot indices are in range by construction, and
    check its matrix indices against `pmatrix` (the engine does so when it
    packs a topology or a batch of candidates)."""
    _check_mxu(mxu)
    _check_query_form(table, query_codes)
    if states >= ROWS_STATES_MIN:
        _check_rows_rate_scalers(rates, rate_scalers)
    if pmatrix.device.type == "cpu" and tip_codes.device.type == "cpu":
        return fused_traversal_reference(tip_codes, pmatrix, table, rates,
                                         states, n_slots, threshold, factor,
                                         mxu, rate_scalers, tip_clvs,
                                         query_codes, query_row)
    if states >= ROWS_STATES_MIN:
        return fused_traversal_rows(tip_codes, pmatrix, table, rates, states,
                                    n_slots, threshold, factor, mxu,
                                    rate_scalers, tip_clvs, query_codes,
                                    query_row)
    from . import _kernels
    out = _launch(_kernels.launch_fused_traversal, tip_codes, pmatrix, table,
                  rates, states, n_slots, threshold, factor, rate_scalers,
                  tip_clvs, query_codes=query_codes, query_row=query_row,
                  splits=splits)
    fused_traversal.launches += 1
    fused_traversal.query_launches += query_codes is not None
    return out


fused_traversal.launches = 0
fused_traversal.query_launches = 0


def _check_query_form(table, query_codes) -> None:
    if query_codes is not None and table.ndim != 3:
        raise ValueError("the query form takes the candidate form's table "
                         "[K, n_ops+1, 8] and P [K, E, R, s, s]")


def fused_traversal_rows(tip_codes: torch.Tensor,   # [n_tips, S] int32
                         pmatrix: torch.Tensor,     # [(K,) E, R, s, s]
                         table: torch.Tensor,       # [(K,) n_ops+1, 8]
                         rates: int, states: int, n_slots: int,
                         threshold: float, factor: float,
                         mxu: str = "split", rate_scalers: bool = False,
                         tip_clvs: torch.Tensor = None,
                         query_codes: torch.Tensor = None,
                         query_row: int = -1, splits=None):
    """The same walk through the row-layout kernel
    (csrc/fused_traversal_rows.cu, any states <= 32, one thread block per
    tile of sites), which replaces libpll2_tpu's `_fused_kernel`.
    `fused_traversal` sends alphabets of `ROWS_STATES_MIN` or more states
    here, one topology, K candidates or the query form as there. Per-rate
    scalers are refused above ROWS_RATE_SCALERS_MAX categories
    (ValueError), as in JAX. CUDA tensors launch the kernel (float32 only)
    or raise; CPU tensors run `fused_traversal_reference`. A block walks a
    whole table here: `splits` is not read."""
    _check_mxu(mxu)
    _check_query_form(table, query_codes)
    _check_rows_rate_scalers(rates, rate_scalers)
    if pmatrix.device.type == "cpu" and tip_codes.device.type == "cpu":
        return fused_traversal_reference(tip_codes, pmatrix, table, rates,
                                         states, n_slots, threshold, factor,
                                         mxu, rate_scalers, tip_clvs,
                                         query_codes, query_row)
    from . import _kernels
    out = _launch(
        _kernels.launch_fused_traversal_rows, tip_codes, pmatrix, table,
        rates, states, n_slots, threshold, factor, mxu,
        rate_scalers=rate_scalers, tip_clvs=tip_clvs,
        query_codes=query_codes, query_row=query_row)
    fused_traversal_rows.launches += 1
    fused_traversal_rows.query_launches += query_codes is not None
    return out


fused_traversal_rows.launches = 0
fused_traversal_rows.query_launches = 0


def fused_traversal_f64(tip_codes: torch.Tensor,   # [n_tips, S] int32
                        pmatrix: torch.Tensor,     # [E, R, s, s] float64
                        table: torch.Tensor,       # [n_ops+1, 8] int32
                        rates: int, states: int, n_slots: int,
                        threshold: float, factor: float,
                        tip_clvs: torch.Tensor = None,
                        rate_scalers: bool = False,
                        query_codes: torch.Tensor = None):
    """One full postorder in float64 (the certified evaluation's walk):
    returns (clv_p, clv_c [R, s, S] float64, sc_p, sc_c [S] int32) for the
    root edge, as `fused_traversal` does for one topology. `tip_clvs`
    [n_ctips, s, S] float64 holds the raw tip rows. Its scope is one
    topology with per-site counts and 2 to 32 states: the candidate and
    query forms and per-rate scalers raise NotImplementedError.

    CUDA tensors launch csrc/fused_traversal.cu's float64 walk
    (pll_fused_traversal_f64) on the current stream, without synchronising,
    or raise; `launches` counts them. CPU tensors run
    `fused_traversal_reference`."""
    if table.ndim != 2:
        raise NotImplementedError(
            "fused_traversal_f64: the candidate form (a [K, n_ops+1, 8] "
            "table) is not instantiated in float64")
    if query_codes is not None:
        raise NotImplementedError(
            "fused_traversal_f64: the query form is not instantiated in "
            "float64")
    if rate_scalers:
        raise NotImplementedError(
            "fused_traversal_f64: per-rate scalers are not instantiated in "
            "float64")
    if pmatrix.dtype != torch.float64:
        raise ValueError(f"fused_traversal_f64 takes float64 P-matrices, "
                         f"got {pmatrix.dtype}")
    if pmatrix.device.type == "cpu" and tip_codes.device.type == "cpu":
        return fused_traversal_reference(tip_codes, pmatrix, table, rates,
                                         states, n_slots, threshold, factor,
                                         tip_clvs=tip_clvs)
    from . import _kernels
    out = _kernels.launch_fused_traversal_f64(tip_codes, pmatrix, table,
                                              rates, states, n_slots,
                                              threshold, factor, tip_clvs)
    fused_traversal_f64.launches += 1
    return out


fused_traversal_f64.launches = 0
