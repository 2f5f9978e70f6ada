"""The runtime-size pool kernel's launch plan and tile maps, pure host
functions: ops/_kernels.py:pool_plan lays one level out from its class
columns, rates, states and the device's SM count (a thread a column, a
column's rates split over up to 4 warps as far as the rates go; blocks
over runs of tiles), ops/pool.py:level_launches computes it once for each
level of a plan, and ops/pool.py:tile_map gives each level's flat grid its
(op, first column) pair per POOL_GRANULE class columns.
csrc/pool_update.cu walks the map as `_kernel_columns` does here. From 33
states on pool_plan is the 64-state body's layout (one rate a block, a
tile's rates in a thread block cluster, runs of 64-column tiles over every
trial's), walked as `_s64_kernel_columns` does. An H100 has 132 SMs."""
import copy
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from libpll2_tpu_torch import Partition, compute_gamma_cats
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.models import load_aa_model
from libpll2_tpu_torch.ops import pool
from libpll2_tpu_torch.ops._kernels import (POOL_BLOCK, POOL_BLOCKS_PER_SM,
                                            POOL_GRANULE,
                                            STATES64_MAX_CLUSTER,
                                            STATES64_TILE, PoolLaunch,
                                            pool_plan, states64_resident)
from libpll2_tpu_torch.repeats import op_fields
from libpll2_tpu_torch.trees import (create_operations, random_utree,
                                     traverse)
from libpll2_tpu_torch.utils import simulate_alignment

SMS = 132


def _kernel_columns(tiles, widths, plan):
    """The (op, column) pairs of class columns < W that the kernel's blocks
    compute, in the order of csrc/pool_update.cu's walk: block b takes
    tiles b * per .. (b + 1) * per - 1; tile t is part t % (GRANULE /
    tile) of granule t // (GRANULE / tile), whose map row gives its op and
    first column."""
    per_granule = POOL_GRANULE // plan.tile
    got = []
    for b in range(plan.blocks):
        for t in range(b * plan.tiles_per_block,
                       min((b + 1) * plan.tiles_per_block, plan.tiles)):
            op, first = (int(v) for v in tiles[t // per_granule])
            c0 = first + (t % per_granule) * plan.tile
            got += [(op, c) for c in range(c0, c0 + plan.tile)
                    if c < widths[op]]
    return got


# ------------------------------------------------------------- pool_plan
def _conserved_protein_levels():
    """The computed class columns, the ops and the tile map of each level
    of chip_smoke.py's conserved protein (tools/benchmarks.py:38-66 with
    conserved=True at 128 x 8192: columns drawn with repetition from the
    first quarter of the 20-state alignment simulated on the seed-11
    tree), as the port's packer schedules them."""
    tree = random_utree([f"t{i}" for i in range(128)], seed=11)
    headers, seqs = simulate_alignment(tree, 8192, np.full(20, 0.05),
                                       np.ones(190), alpha=0.9, seed=11)
    src = np.random.default_rng(111).integers(0, 8192 // 4, size=8192)
    by = {h: "".join(np.asarray(list(s))[src])
          for h, s in zip(headers, seqs)}
    part = Partition(128, 126, 20, 8192, 1, tree.edge_count, 4, 126,
                     device="cpu", site_repeats=True)
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_aa, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    load_aa_model(part, "lg")
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    ops, _, _ = create_operations(traverse(tree.vroot))
    layout, levels = pool.schedule_pool_levels(
        copy.deepcopy(part.repeats), ops, part.tips, part.sites_padded,
        part.scale_buffers)
    return [sum(int(w) for w, *_ in lv) for lv in levels], \
        [len(lv) for lv in levels], pool.pack_pool_levels(layout, levels)[3]


def test_conserved_protein_levels_take_the_designed_layouts():
    """The conserved 128 x 8192 LG+G4 protein: 14 levels of 8,192-33,792
    computed class columns (62-256 an SM), 262,656 in all. At 4 rates
    every level splits its columns' rates over 4 warps: tiles of 32
    columns; blocks take runs of 2 tiles where one tile a block would need
    more than 4 blocks an SM. `level_launches` lays them out from the
    levels' tile maps."""
    cols, n_ops, tiles = _conserved_protein_levels()
    assert n_ops == [40, 25, 18, 11, 9, 7, 3, 3, 3, 2, 2, 1, 1, 1]
    assert cols == [19968, 28672, 33792, 22528, 18432, 20480, 18432, 18432,
                    24576, 16384, 16384, 8192, 8192, 8192]
    assert sum(cols) == 262656
    plans = pool.level_launches(tiles, 4, 20, SMS)
    assert len(plans) == len(cols)
    for c, p in zip(cols, plans):
        assert (p.rate_threads, p.tile) == (4, POOL_BLOCK // 4)
        assert p.tiles * p.tile == c
        assert p.blocks <= POOL_BLOCKS_PER_SM * SMS
        assert (p.blocks - 1) * p.tiles_per_block < p.tiles \
            <= p.blocks * p.tiles_per_block
    assert [p.tiles_per_block for p in plans] == [2] * 9 + [1] * 5
    assert [p.blocks for p in plans] == [312, 448, 528, 352, 288, 320, 288,
                                         288, 384, 512, 512, 256, 256, 256]


@pytest.mark.parametrize("cols", [POOL_GRANULE, 8192, 67584, 135168,
                                  40 * 16384])
def test_rate_warps_do_not_depend_on_the_level_width(cols):
    """At 4 rates a column's rates split over 4 warps at every width,
    from one granule to past a thread a column for every thread the card
    holds."""
    plan = pool_plan(cols, 4, 20, SMS)
    assert plan.rate_threads == 4
    assert plan.tile == POOL_BLOCK // 4
    assert plan.tiles * plan.tile == cols


@pytest.mark.parametrize("rates,states,want", [
    (1, 20, 1), (2, 20, 2), (3, 4, 2), (3, 20, 2), (8, 20, 4), (16, 32, 4),
    (4, 2, 4), (3, 2, 2), (4, 5, 4), (4, 17, 4), (4, 32, 4)])
def test_narrow_level_splits_as_far_as_the_rates_go(rates, states, want):
    """A level splits a column's rates over the largest power of two up
    to 4 that the rates fill, whatever the states."""
    plan = pool_plan(POOL_GRANULE, rates, states, SMS)
    assert plan.rate_threads == want
    assert plan.tile * plan.rate_threads == POOL_BLOCK
    assert (plan.tiles, plan.tiles_per_block, plan.blocks) == (
        POOL_GRANULE // plan.tile, 1, POOL_GRANULE // plan.tile)


def test_wide_level_runs_in_runs_of_tiles():
    """A wide level's tiles are shared out in runs so that the grid is
    one fill of the card."""
    cols = 40 * 16384
    plan = pool_plan(cols, 4, 20, SMS)
    assert plan == PoolLaunch(4, 32, 20480, 39, 526)
    assert plan.blocks <= POOL_BLOCKS_PER_SM * SMS


@pytest.mark.parametrize("args", [(4, 4, 4), (POOL_GRANULE, 4, 4),
                                  (POOL_GRANULE + 1, 4, 20),
                                  (0, 4, 20), (POOL_GRANULE, 0, 20),
                                  (POOL_GRANULE, 4, 65)])
def test_pool_plan_refuses_what_has_no_runtime_size_plan(args):
    """The 4x4 size runs the traversal kernel; columns come in
    granules; the kernel takes at most 64 states."""
    with pytest.raises(ValueError):
        pool_plan(*args, SMS)


# ------------------------------------------------------------- tile maps
def test_tile_map_rows():
    """One row (op, first column) per POOL_GRANULE columns of each op, the
    last granule of an op partial."""
    tiles = pool.tile_map([256, 128, 300])
    assert tiles.dtype == np.int32
    np.testing.assert_array_equal(tiles, [[0, 0], [0, 128], [1, 0], [2, 0],
                                          [2, 128], [2, 256]])
    assert pool.tile_map([]).shape == (0, 2)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(widths=st.lists(st.integers(1, 40).map(lambda k: 128 * k)
                       | st.integers(1, 5000), min_size=1, max_size=12),
       rates=st.integers(1, 9), states=st.integers(2, 32),
       sms=st.sampled_from([1, 2, 7, 132]))
def test_flat_tile_map_covers_every_column_once(widths, rates, states, sms):
    """For random op widths, sizes and SM counts, the kernel's walk over
    the flat tile map computes every op's W columns exactly once and no
    column twice; the grid covers the ops' columns rounded up to the
    granule and no more."""
    if (rates, states) == (4, 4):
        states = 5
    tiles = pool.tile_map(widths)
    granules = sum(-(-w // POOL_GRANULE) for w in widths)
    assert tiles.shape == (granules, 2)
    plan = pool_plan(granules * POOL_GRANULE, rates, states, sms)
    got = _kernel_columns(tiles, widths, plan)
    want = [(k, c) for k, w in enumerate(widths) for c in range(w)]
    assert len(got) == len(set(got)) == len(want)
    assert sorted(got) == want
    assert plan.tiles * plan.tile == granules * POOL_GRANULE
    assert plan.blocks <= POOL_BLOCKS_PER_SM * sms


def _repeats_levels():
    """A conserved 20-taxon DNA repeats partition's level schedule."""
    tree = random_utree([f"t{i}" for i in range(20)], seed=5)
    headers, seqs = simulate_alignment(tree, 700, [0.3, 0.2, 0.25, 0.25],
                                       [1, 2, 1, 1, 2, 1.0], alpha=0.5,
                                       seed=5)
    by = dict(zip(headers, seqs))
    part = Partition(20, 18, 4, 700, 1, tree.edge_count, 4, 18,
                     device="cpu", site_repeats=True)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    ops, _, _ = create_operations(traverse(tree.vroot))
    for op in ops[::4]:
        op.parent_scaler_index = -1
    return pool.schedule_pool_levels(copy.deepcopy(part.repeats), ops,
                                     part.tips, part.sites_padded,
                                     part.scale_buffers)


def test_packer_tables_and_gathers_are_unchanged_beside_the_maps():
    """pack_pool_levels' rows 0-10 and gather maps are what the module
    docstring lays out (the kernels' contract, unchanged by the tile
    maps): the op's fields, its W, the offset of its gather entries and
    whether it has a scaler; each op's W child class indices zero-padded
    past its class count. Each level's tile map is `tile_map` of its W
    row, and the device plan keeps them in one tensor of views (on the
    host without a launch or a traversal)."""
    layout, levels = _repeats_levels()
    tables, gl, gr, tiles = pool.pack_pool_levels(layout, levels)
    assert len(tables) == len(tiles) == len(levels)
    g_off, want_gl, want_gr = 0, [], []
    for table, tmap, lv in zip(tables, tiles, levels):
        assert table.shape == (pool.POOL_ROWS, len(lv))
        assert table.dtype == np.int64
        for k, (w, op, l_idx, r_idx) in enumerate(lv):
            np.testing.assert_array_equal(table[:8, k],
                                          op_fields(layout, op))
            assert tuple(table[8:, k]) == (
                w, g_off, int(op.parent_scaler_index >= 0))
            for idx, out in ((l_idx, want_gl), (r_idx, want_gr)):
                padded = np.zeros(w, np.int32)
                padded[:idx.size] = idx
                out.append(padded)
            g_off += w
        np.testing.assert_array_equal(tmap, pool.tile_map(table[8]))
    np.testing.assert_array_equal(gl, np.concatenate(want_gl))
    np.testing.assert_array_equal(gr, np.concatenate(want_gr))
    plan = pool.plan_to_device(tables, gl, gr, tiles, "cpu", 4, 4)
    for got, want in zip(plan.tables, tables):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(plan.tiles, tiles):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert plan.tiles[0].untyped_storage().data_ptr() == \
        plan.tiles[-1].untyped_storage().data_ptr()
    assert plan.launches == (None,) * len(levels)
    assert plan.traversal is None


@pytest.mark.parametrize("rates,states,want", [
    (4, 4, (None, None)), (4, 20, (4, 4)), (3, 4, (2, 2)), (1, 5, (1, 1))])
def test_level_launches_lay_out_every_level(rates, states, want):
    """`level_launches` gives each level its `pool_plan` from the level's
    tile map, and None at every level of the 4x4 size (the traversal
    kernel); a plan on the host carries no launch."""
    tiles = (pool.tile_map([256, 100]), pool.tile_map([4096]))
    got = pool.level_launches(tiles, rates, states, SMS)
    assert tuple(g and g.rate_threads for g in got) == want
    for g, t in zip(got, tiles):
        if g is not None:
            assert g == pool_plan(t.shape[0] * POOL_GRANULE, rates, states,
                                  SMS)
    plan = pool.plan_to_device((np.zeros((pool.POOL_ROWS, 2), np.int64),
                                np.zeros((pool.POOL_ROWS, 1), np.int64)),
                               np.zeros(4452, np.int32),
                               np.zeros(4452, np.int32), tiles, "cpu",
                               rates, states)
    assert plan.launches == (None, None)


# ------------------------------------- 33-64 states: the 64-state body
def _s64_kernel_columns(tiles, widths, plan, rates, trials):
    """How often the 64-state kernel's blocks compute each (trial, op,
    rate, column < W), in the order of csrc/states64.cuh's `run` over
    pool_update.cu's Pooled64: block b is rank b % cluster of run b //
    cluster; a run takes tiles run * per .. of the flat (trial, tile)
    list (plan.tiles a trial); tile t is half t % 2 of granule t // 2; a
    block takes rates rank, rank + cluster, ..."""
    per_granule = POOL_GRANULE // plan.tile
    got = np.zeros((trials, len(widths), rates, max(widths)), np.int64)
    for b in range(plan.blocks):
        run, rank = divmod(b, plan.cluster)
        for t in range(run * plan.tiles_per_block,
                       min((run + 1) * plan.tiles_per_block,
                           trials * plan.tiles)):
            k, tile = divmod(t, plan.tiles)
            op, first = (int(v) for v in tiles[tile // per_granule])
            c0 = first + (tile % per_granule) * plan.tile
            c1 = min(c0 + plan.tile, widths[op])
            got[k, op, rank::plan.cluster, c0:c1] += 1
    return got


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(widths=st.lists(st.integers(1, 8).map(lambda k: 128 * k)
                       | st.integers(1, 900), min_size=1, max_size=8),
       rates=st.integers(1, 20), states=st.integers(33, 64),
       trials=st.integers(1, 3), sms=st.sampled_from([1, 2, 7, 132]))
def test_states64_tiles_cover_every_trial_op_rate_and_column_once(
        widths, rates, states, trials, sms):
    """From 33 states on, for random op widths, rates, trials and cards,
    the 64-state kernel computes every (trial, op, rate, column < W)
    exactly once; the cluster is min(rates, 8) blocks, divides the grid,
    and no more runs are launched than clusters stay resident."""
    tiles = pool.tile_map(widths)
    plan = pool_plan(tiles.shape[0] * POOL_GRANULE, rates, states, sms,
                     trials)
    assert plan.rate_threads == 1 and plan.tile == STATES64_TILE
    assert plan.cluster == min(rates, STATES64_MAX_CLUSTER) <= 8
    assert plan.blocks % plan.cluster == 0
    assert plan.blocks // plan.cluster <= states64_resident(rates, sms)
    got = _s64_kernel_columns(tiles, widths, plan, rates, trials)
    for k, w in enumerate(widths):
        assert (got[:, k, :, :w] == 1).all()
        assert not got[:, k, :, w:].any()


@pytest.mark.parametrize("rates,cluster,per_block", [
    (1, 1, 1), (3, 3, 1), (4, 4, 1), (5, 5, 2), (8, 8, 2), (10, 8, 2),
    (16, 8, 2)])
def test_states64_narrow_level_fills_the_card(rates, cluster, per_block):
    """A level of 4096 class columns (64 tiles) at 61 states on 132 SMs: a
    cluster holds a tile's rates (8 blocks at most, each taking
    ceil(rates / 8) rates above that), runs of one tile where the
    resident clusters allow it (66 clusters of 4), two at 5 rates and
    more (52 of 5, 33 of 8); at 4 rates 256 blocks."""
    plan = pool_plan(4096, rates, 61, SMS)
    assert (plan.cluster, plan.tiles_per_block) == (cluster, per_block)
    assert plan.tiles == 64
    assert plan.blocks == -(-64 // per_block) * cluster
    if rates == 4:
        assert plan.blocks == 256


def test_states64_constants_match_the_pool_source():
    """pool_update.cu cuts each tile-map granule into tiles of
    csrc/states64.cuh's kTile columns."""
    csrc = Path(pool.__file__).resolve().parent.parent / "csrc"
    pool_src = (csrc / "pool_update.cu").read_text()
    m = re.search(r"constexpr int kGranule = (\d+);", pool_src)
    assert m and int(m.group(1)) == POOL_GRANULE
    m = re.search(r"constexpr int kTile = (\d+);",
                  (csrc / "states64.cuh").read_text())
    assert m and int(m.group(1)) == STATES64_TILE
    assert POOL_GRANULE % STATES64_TILE == 0
