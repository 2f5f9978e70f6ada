"""The 4x4 pool kernel's host side on the CPU: one launch a traversal.

csrc/pool_update.cu's 4x4 kernel runs a whole plan in one launch. Blocks
draw tickets in the order of ops/pool.py:traversal_arrays (each op's tiles
of 64 class columns, level after level) and a tile waits until every op
of its op's wait list (ops/pool.py:wait_lists) has finished all its tiles.
These tests hold the host side to that contract without a card:
  * the tickets cover every computed column of every op once, in level
    order, and ops/_kernels.py:pool_fixed_plan sizes the launch;
  * ops/_kernels.py:check_traversal takes a plan of more ops than one
    level's table may hold, and refuses what the kernel cannot read;
  * the wait lists hold every hazard of the op list (read after write,
    write after write, write after read) and point to earlier ops only;
  * an emulation of the launch: tiles run through the plain version
    (ops/pool.py:pool_update_reference, one tile as a one-op table) in
    random orders the wait lists allow, equal bit for bit to the tiles in
    ticket order, which equal the level-by-level plain path to 1e-12
    relative (the per-tile einsums may round apart from the per-op ones);
  * the emulated traversal against JAX's Pallas pool kernel in interpret
    mode from the same pools (float32: counts equal, class columns to rtol
    2e-6, as tests/test_torch_repeats.py holds the level path).
Every construction passes device="cpu"."""
import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from libpll2_tpu.ops import pallas_repeats as jpool

import libpll2_tpu_torch as tp
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.ops import levels as tlevels
from libpll2_tpu_torch.ops import _kernels, pool
from libpll2_tpu_torch.ops._kernels import (LEVEL_MAX_OPS,
                                            POOL_COUNTER_STRIDE,
                                            POOL_FIXED_BLOCKS_PER_SM,
                                            POOL_FIXED_TILE, PoolFixedPlan,
                                            PoolTraversal, check_traversal,
                                            pool_fixed_plan)
from libpll2_tpu_torch.trees import create_operations, random_utree, traverse
from libpll2_tpu_torch.utils import simulate_alignment
from test_torch_repeats import (_conserve, _fill, _jax, _jax_pools,
                                _layouts_equal, _problem)

SMS = 132


def _tables(levels):
    """Per-level [11, n] tables whose ops are `levels`' widths, each op
    writing a region of its own and reading the tips (no hazards)."""
    out, k = [], 0
    for widths in levels:
        t = np.zeros((pool.POOL_ROWS, len(widths)), np.int64)
        t[0] = 10 ** 6 + np.arange(k, k + len(widths))
        t[8] = widths
        out.append(t)
        k += len(widths)
    return out


# ----------------------------------------------------- tickets and plan
@settings(max_examples=120, deadline=None, derandomize=True, database=None)
@given(levels=st.lists(st.lists(st.integers(1, 40).map(lambda k: 128 * k)
                                | st.integers(1, 5000), min_size=1,
                                max_size=8), min_size=1, max_size=6),
       sms=st.sampled_from([1, 7, 132]))
def test_tickets_cover_every_column_once_in_level_order(levels, sms):
    """For random levels of op widths and SM counts: one ticket per 64
    columns of each op, op after op in level order, so that every column
    below W is computed once; each level's tickets and ops are a
    contiguous range; the plan counts the tickets and fills the card once
    with no more blocks than tickets."""
    tile = POOL_FIXED_TILE
    tables = _tables(levels)
    tickets, waits, op_tiles, bounds = pool.traversal_arrays(tables)
    widths = [w for lv in levels for w in lv]
    assert tickets.dtype == waits.dtype == op_tiles.dtype == np.int32
    assert waits.shape == (0, 2)
    got = [(int(k), c) for k, c0 in tickets[:, :2]
           for c in range(c0, min(c0 + tile, widths[k]))]
    assert got == [(k, c) for k, w in enumerate(widths) for c in range(w)]
    assert list(tickets[:, 0]) == sorted(tickets[:, 0])
    assert op_tiles.tolist() == [-(-w // tile) for w in widths]
    t_end = k_end = 0
    for (t0, t1, k0, k1), lv in zip(bounds, levels):
        assert (t0, k0) == (t_end, k_end) and k1 - k0 == len(lv)
        assert set(tickets[t0:t1, 0]) == set(range(k0, k1))
        t_end, k_end = t1, k1
    assert (t_end, k_end) == (len(tickets), len(widths))
    plan = pool_fixed_plan(widths, sms)
    assert plan.tiles == len(tickets)
    assert plan.blocks == min(plan.tiles, sms * POOL_FIXED_BLOCKS_PER_SM)


def _repeats_dna_levels():
    """The widths of each level of chip_smoke.py's repeats DNA problem
    (tools/benchmarks.py:221-254: 246 taxa x 4465 sites, seed 13, branches
    0.15 len + 0.001, GTR (1,2,1,1,2,1) with equal frequencies,
    Gamma(0.7) x 4), as the port's packer schedules them."""
    tree = _conserve(random_utree([f"t{i}" for i in range(246)], seed=13),
                     0.15, 0.001)
    headers, seqs = simulate_alignment(tree, 4465, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1.0], alpha=0.7,
                                       seed=13)
    by = dict(zip(headers, seqs))
    part = tp.Partition(246, 244, 4, 4465, 1, tree.edge_count, 4, 244,
                        device="cpu", site_repeats=True)
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_nt, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    ops, _, _ = create_operations(traverse(tree.vroot))
    layout, levels = pool.schedule_pool_levels(
        copy.deepcopy(part.repeats), ops, part.tips, part.sites_padded,
        part.scale_buffers)
    return [[int(w) for w, *_ in lv] for lv in levels]


def test_pool_fixed_plan_for_the_repeats_dna_traversal():
    """The 246 x 4465 repeats DNA problem: 244 ops in 14 levels of
    4,480-20,480 computed class columns, 183,680 in all. On an H100's 132
    SMs its one launch takes tickets of 64 columns (2 columns a lane),
    2,870 of them, drawn by the 792 blocks of 128 threads that fill the
    card once at 6 an SM."""
    levels = _repeats_dna_levels()
    assert [len(lv) for lv in levels] == [79, 46, 30, 23, 17, 13, 10, 9, 5,
                                          4, 3, 2, 2, 1]
    assert [sum(lv) for lv in levels] == [10112, 6272, 8064, 13568, 17920,
                                          17920, 20480, 19456, 16512, 17536,
                                          13440, 8960, 8960, 4480]
    widths = [w for lv in levels for w in lv]
    assert POOL_FIXED_TILE == 64
    assert pool_fixed_plan(widths, SMS) == PoolFixedPlan(2870, 792)


@pytest.mark.parametrize("args", [([], 132), ([128], 0), ([128], -1),
                                  ([0, 128], 132), ([-64], 132)])
def test_pool_fixed_plan_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError):
        pool_fixed_plan(*args)


def test_constants_match_the_kernel_source():
    """The plan's tile width, blocks an SM and counter stride are the
    kernel's: a tile is its passes of 32 columns (4 lanes a column), and
    the grid and counters are laid out from the same numbers."""
    src = (Path(_kernels.__file__).resolve().parent.parent / "csrc"
           / "pool_update.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m.group(1))

    assert const("kTravThreads") // 4 * const("kTravPasses") \
        == POOL_FIXED_TILE
    assert const("kTravBlocksPerSm") == POOL_FIXED_BLOCKS_PER_SM
    assert const("kCounterStride") == POOL_COUNTER_STRIDE


def _cpu_traversal(n_ops, width=64):
    """A PoolTraversal on the CPU for `n_ops` independent ops of `width`
    class columns in one level, built as plan_to_device builds it."""
    tables = _tables([[width] * n_ops])
    tickets, waits, _, _ = pool.traversal_arrays(tables)
    return PoolTraversal(
        pool_fixed_plan([width] * n_ops, SMS), torch.as_tensor(tables[0]),
        torch.as_tensor(tickets), torch.as_tensor(waits),
        torch.zeros((1 + n_ops) * POOL_COUNTER_STRIDE, dtype=torch.int32))


def test_traversal_check_takes_more_ops_than_a_level_table():
    """A traversal runs the whole op list in one launch with no grid axis
    over the ops, so its joined table may hold more ops than one level's
    table may (LEVEL_MAX_OPS, the old grid.y limit): a plan of 70,000 ops
    (a tree of 70,002 taxa) passes the check."""
    n_ops = 70000
    assert n_ops > LEVEL_MAX_OPS
    trav = _cpu_traversal(n_ops)
    assert trav.table.shape == (pool.POOL_ROWS, n_ops)
    check_traversal(trav, torch.device("cpu"))


@pytest.mark.parametrize("fault", ["not_a_traversal", "int32_table",
                                   "table_rows", "tickets", "waits",
                                   "counters", "ticket_overflow", "device"])
def test_traversal_check_refuses_what_the_kernel_cannot_read(fault):
    trav = _cpu_traversal(10)
    dev = torch.device("cpu")
    if fault == "not_a_traversal":
        trav = tuple(trav)
    elif fault == "int32_table":
        trav = trav._replace(table=trav.table.int())
    elif fault == "table_rows":
        trav = trav._replace(table=trav.table[:10])
    elif fault == "tickets":
        trav = trav._replace(tickets=trav.tickets[1:])
    elif fault == "waits":
        trav = trav._replace(waits=trav.waits.reshape(-1))
    elif fault == "counters":
        trav = trav._replace(counters=trav.counters[POOL_COUNTER_STRIDE:])
    elif fault == "ticket_overflow":
        trav = trav._replace(plan=PoolFixedPlan(2 ** 31 - 10, 10))
    else:
        dev = torch.device("meta")
    with pytest.raises(ValueError):
        check_traversal(trav, dev)


# ----------------------------------------------------------- wait lists
def _partition(kind, dtype=torch.float64, **options):
    """A CPU repeats partition of tests/test_torch_repeats.py's `kind`
    problem, its op list, and P-matrices set from the branches; `options`
    (rate_scalers) go to Partition."""
    tree, by, sites, states, rates = _problem(kind)
    part = tp.Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                        tree.edge_count, rates, tree.inner_count,
                        device="cpu", dtype=dtype, site_repeats=True,
                        **options)
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_nt, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    _fill(part, states, rates)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * rates, pidx, br)
    return part, ops


def _swapped(ops):
    """`ops` again with each op's two P-matrices swapped. Run after a
    traversal, the first half of its postorder swapped rewrites, with
    other values, nodes whose parents the traversal read and that half
    does not rewrite: a write after read that the final pools show."""
    again = [copy.copy(op) for op in ops]
    for op in again:
        op.child1_matrix_index, op.child2_matrix_index = \
            op.child2_matrix_index, op.child1_matrix_index
    return again


def _case(case):
    """(partition, op list, the list to run first or None) of one
    emulation case: float64 DNA, but float32 for the caterpillar and the
    per-rate counts on full-length branches, where scaling triggers."""
    kind = {"caterpillar": "caterpillar", "per_rate": "deep"}.get(case,
                                                                 "dna")
    part, ops = _partition(kind, torch.float32 if kind != "dna"
                           else torch.float64,
                           rate_scalers=case == "per_rate")
    if case == "partial":
        return part, ops[len(ops) // 2:], ops
    if case == "serial":
        return part, ops + _swapped(ops[:len(ops) // 2]), None
    if case == "no_scaler":
        for op in ops[::3]:
            op.parent_scaler_index = -1
    return part, ops, None


CASES = ["full", "partial", "serial", "no_scaler", "per_rate",
         "caterpillar"]


def _plan_ops(part, ops):
    """The partition's plan of `ops` (its pools laid out) and the op
    objects in the plan's level order."""
    plan = part._pool_plan(ops, True)
    levels = tlevels.schedule_levels(ops, part.tips)
    return plan, [op for lv in levels for op in lv]


def _regions(op):
    """(read, written) regions of one op: node CLVs and scaler indices,
    a missing scaler none."""
    reads = {("clv", op.child1_clv_index), ("clv", op.child2_clv_index)}
    reads |= {("sc", s) for s in (op.child1_scaler_index,
                                  op.child2_scaler_index) if s >= 0}
    writes = {("clv", op.parent_clv_index)}
    if op.parent_scaler_index >= 0:
        writes.add(("sc", op.parent_scaler_index))
    return reads, writes


@pytest.mark.parametrize("case", CASES)
def test_wait_lists_hold_every_hazard(case):
    """Against an oracle over the op objects (not the tables' offsets):
    every earlier op that writes what op k reads, or reads or writes what
    it writes, is in k's wait list or reached from it through the lists;
    every entry is such an op, earlier than k; the serial-fallback list
    has write-after-read and write-after-write hazards, the others only
    read-after-write ones, each child's producer listed directly."""
    part, ops, first = _case(case)
    if first is not None:
        part.update_partials(first)
    plan, flat = _plan_ops(part, ops)
    offsets, entries = pool.wait_lists([t.numpy() for t in plan.tables])
    assert offsets[0] == 0 and offsets[-1] == entries.size
    assert len(offsets) == len(flat) + 1
    lists = [set(entries[offsets[k]:offsets[k + 1]].tolist())
             for k in range(len(flat))]
    reach = []
    kinds = set()
    for k, op in enumerate(flat):
        r_k, w_k = _regions(op)
        closure = set(lists[k])
        for j in lists[k]:
            assert j < k
            closure |= reach[j]
        reach.append(closure)
        producer = {}
        for j in range(k):
            r_j, w_j = _regions(flat[j])
            hazards = {"raw"} if w_j & r_k else set()
            hazards |= {"waw"} if w_j & w_k else set()
            hazards |= {"war"} if r_j & w_k else set()
            if hazards:
                assert j in closure, (case, k, j, hazards)
                kinds |= hazards
            for node in (op.child1_clv_index, op.child2_clv_index):
                if ("clv", node) in w_j:
                    producer[node] = j
        for j in lists[k]:
            r_j, w_j = _regions(flat[j])
            assert (w_j & r_k) or (w_j & w_k) or (r_j & w_k)
        assert set(producer.values()) <= lists[k]
    assert kinds == ({"raw", "waw", "war"} if case == "serial" else {"raw"})
    if case == "serial":
        assert len(plan.tables) == len(ops)     # one op a level


# ------------------------------------------------------ the emulation
def _tile_table(col, c0, tile):
    """One ticket as a one-op table: the op's columns c0 .. c0+tile-1."""
    p, psc, c1, m1, s1, c2, m2, s2, w, g, has = (int(v) for v in col)
    return np.array([[p + c0], [psc + c0], [c1], [m1], [s1], [c2], [m2],
                     [s2], [min(tile, w - c0)], [g + c0], [has]], np.int64)


def _emulate(part, plan, rng=None):
    """The 4x4 kernel's launch over `plan`, on the CPU: each ticket's tile
    through pool_update_reference once every op of its wait list has
    finished all its tiles, the next tile drawn among those ready by
    `rng`, or in ticket order."""
    tables = [t.numpy() for t in plan.tables]
    table = np.concatenate(tables, axis=1)
    tickets, waits, op_tiles, _ = pool.traversal_arrays(tables)
    left = op_tiles.astype(np.int64)
    pending = list(range(len(tickets)))
    pool2d = part.clv_flat.view(part.rate_cats * part.states, -1)
    while pending:
        ready = [t for t in pending
                 if not left[waits[tickets[t, 2]:tickets[t, 3], 0]].any()]
        # at random, or half the time the latest ticket ready: later ops
        # as early as their lists let them, where a missing entry shows
        t = ready[0] if rng is None else (
            ready[-1] if rng.random() < 0.5 else
            ready[rng.integers(len(ready))])
        k, c0 = int(tickets[t, 0]), int(tickets[t, 1])
        pool.pool_update_reference(
            pool2d, part.sc_flat, part.pmatrix,
            _tile_table(table[:, k], c0, POOL_FIXED_TILE), plan.gl, plan.gr,
            part.rate_cats, part.states, part.scale_threshold,
            part.scale_factor)
        left[k] -= 1
        pending.remove(t)


def _state(part):
    """The pools but the trash region, which scaler-less ops of one level
    write at once in any order."""
    lay = part._flat
    keep = torch.ones(part.sc_flat.shape[-1], dtype=torch.bool)
    keep[lay.sc_trash:lay.sc_zero] = False
    return part.clv_flat.clone(), part.sc_flat[..., keep].clone()


@pytest.mark.parametrize("case", CASES)
@settings(max_examples=4, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_emulated_launch_equals_the_serial_list(case, seed):
    """Tiles in random orders that the wait lists allow give the tiles'
    serial result bit for bit, which is the plain level path's."""
    part, ops, first = _case(case)
    if first is not None:
        part.update_partials(first)
    plan = part._pool_plan(ops, True)
    start = part.clv_flat.clone(), part.sc_flat.clone()
    _emulate(part, plan)
    serial = _state(part)
    for t, s in zip((part.clv_flat, part.sc_flat), start):
        t.copy_(s)
    _emulate(part, plan, np.random.default_rng(seed))
    got = _state(part)
    assert torch.equal(got[0], serial[0]) and torch.equal(got[1], serial[1])
    for t, s in zip((part.clv_flat, part.sc_flat), start):
        t.copy_(s)
    pool.update_partials_pool(part.clv_flat, part.sc_flat, part.pmatrix,
                              plan, part.scale_threshold, part.scale_factor)
    want = _state(part)
    assert torch.equal(got[1], want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-12,
                               atol=1e-300)
    if case in ("caterpillar", "per_rate"):
        assert int(want[1].max()) > 0, "scaling never triggered"


@pytest.mark.parametrize("kind", ["dna", "caterpillar"])
def test_emulated_launch_matches_jax_pool_kernel(kind):
    """The emulated one-launch traversal (tiles in a random allowed order)
    against JAX's Pallas pool kernel in interpret mode from the same
    float32 pools; every op has a scaler buffer, where JAX's pooled paths
    and the port agree."""
    tree, by, sites, states, rates = _problem(kind)
    jp = _jax(tree, by, sites, states, rates, f64=False)
    part = tp.Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                        tree.edge_count, rates, tree.inner_count,
                        device="cpu", dtype=torch.float32,
                        site_repeats=True)
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_nt, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    _fill(part, states, rates)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    assert all(op.parent_scaler_index >= 0 for op in ops)
    jp.update_prob_matrices([0] * rates, pidx, br)
    jlay, clv0, sc0, sched, profiles = _jax_pools(jp, ops, sites)
    jclv, jsc = jpool.update_partials_repeats_pool_pallas(
        jp.clv_flat, jp.sc_flat, jp.pmatrix, sched, rates=rates,
        states=states, profiles=profiles, interpret=True,
        scale_threshold=jp.scale_threshold, scale_factor=jp.scale_factor)
    plan = part._pool_plan(ops, True)
    _layouts_equal(part._flat, jlay)
    part.clv_flat.copy_(torch.tensor(clv0))
    part.sc_flat.copy_(torch.tensor(sc0))
    part.pmatrix.copy_(torch.tensor(np.asarray(jp.pmatrix)))
    _emulate(part, plan, np.random.default_rng(13))
    np.testing.assert_array_equal(part.sc_flat.numpy(), np.asarray(jsc))
    np.testing.assert_allclose(part.clv_flat.numpy(), np.asarray(jclv),
                               rtol=2e-6, atol=1e-30)
    if kind == "caterpillar":
        assert int(np.asarray(jsc).max()) > 0, "scaling never triggered"


def test_trial_traversal_check_sizes_counters_for_every_trial():
    """The trial form of a traversal (ops/_kernels.py:trial_traversal) draws
    every ticket once a trial, so its plan counts K times the tickets, and
    each trial has its own finished-tile count for every op: a traversal
    whose counters cover one trial only (a count shared by the trials would
    release a tile early) or whose plan counts the tickets once is
    refused."""
    trav = _cpu_traversal(10)
    dev = torch.device("cpu")
    t3 = trav._replace(
        plan=pool_fixed_plan([64] * 10, SMS, trials=3),
        counters=torch.zeros((1 + 3 * 10) * POOL_COUNTER_STRIDE,
                             dtype=torch.int32), trials=3)
    assert t3.plan.tiles == 3 * trav.plan.tiles
    check_traversal(t3, dev)
    for bad in (t3._replace(counters=trav.counters),
                t3._replace(plan=trav.plan), t3._replace(trials=0)):
        with pytest.raises(ValueError):
            check_traversal(bad, dev)
    with pytest.raises(ValueError):
        pool_fixed_plan([64] * 10, SMS, trials=0)
