"""The level kernel's launch plans, pure host functions. The 4x4 plan:
ops/_kernels.py:level_fixed_plan lays one level out from its ops, its
sites, whether the buffers are 16-byte aligned, the counting mode and the
device's SM count (four lanes a site group, one per rate; 4, 2 or 1 sites
a lane; blocks over runs of tiles, as many as the instantiation keeps
resident fill the card). csrc/level_update.cu's fixed_plan computes the
same, and its kernel walks the tiles as `_kernel_sites` does here. The
33-64-state plan: ops/_kernels.py:level64_plan (one rate a block, a
tile's rates in a thread block cluster, runs of tiles from the clusters
the card keeps resident), which csrc/states64.cuh's `plan` recomputes; its
kernel walks the tiles as `_s64_kernel_work` does. An H100 has 132 SMs."""
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from libpll2_tpu_torch.ops import _kernels
from libpll2_tpu_torch.ops._kernels import (
    LEVEL_FIXED_BLOCKS_PER_SM, LEVEL_FIXED_BLOCKS_PER_SM_NARROW,
    LEVEL_FIXED_BLOCKS_PER_SM_RATE, LEVEL_FIXED_MIN_TILES_PER_SM,
    LEVEL_FIXED_THREADS, LEVEL_MAX_OPS, LEVEL_MAX_TRIALS,
    STATES64_BLOCKS_PER_SM, STATES64_MAX_CLUSTER, STATES64_THREADS,
    STATES64_TILE, LevelFixedPlan, level64_plan, level_fixed_blocks_per_sm,
    level_fixed_plan, states64_resident)
from libpll2_tpu_torch.ops.levels import schedule_levels
from libpll2_tpu_torch.trees import (create_operations, random_utree,
                                     traverse)

SMS = 132


def _kernel_sites(plan, ops, sites):
    """The (op, site) pairs the kernel's lanes compute, in the order of
    csrc/level_update.cu's walk: block b takes tiles b * per .. (b + 1) *
    per - 1 of the op-major list; tile t is tile t % (tiles an op) of op t
    // (tiles an op); its site group g (lanes 4g .. 4g + 3) covers sites
    tile_start + g * V .. + V - 1, those < S."""
    v, per_op = plan.sites_per_lane, plan.tiles // ops
    got = []
    for b in range(plan.blocks):
        for t in range(b * plan.tiles_per_block,
                       min((b + 1) * plan.tiles_per_block, plan.tiles)):
            op, first = t // per_op, (t % per_op) * plan.tile
            got += [(op, s) for g in range(LEVEL_FIXED_THREADS // 4)
                    for s in range(first + g * v, first + (g + 1) * v)
                    if s < sites]
    return got


def _dna_level_widths():
    """The ops of each level of bench.py's 128-taxon tree (seed 7), as the
    port's schedule packs them."""
    tree = random_utree([f"t{i}" for i in range(128)], seed=7)
    ops, _, _ = create_operations(traverse(tree.vroot))
    return [len(lv) for lv in schedule_levels(ops, 128)]


def test_dna_main_path_levels_take_the_designed_layouts():
    """The DNA main path at 128 x 16384 on 132 SMs: 13 levels of 42 down
    to 1 ops. 16-byte accesses (4 sites a lane, 128-site tiles) down to 3
    ops, which still give every SM 2 tiles; 2 sites a lane at 2 ops and 1
    at 1 op (512 tiles of 32 sites). The wide levels run 2-9 tiles a
    block, all blocks resident at once (5 an SM); from 5 ops down one
    tile a block."""
    widths = _dna_level_widths()
    assert widths == [42, 25, 15, 11, 9, 6, 5, 4, 3, 2, 2, 1, 1]
    plans = [level_fixed_plan(w, 16384, SMS) for w in widths]
    assert [p.sites_per_lane for p in plans] == [4] * 9 + [2, 2, 1, 1]
    assert [p.tiles_per_block for p in plans] == \
        [9, 5, 3, 3, 2, 2] + [1] * 7
    assert all(p.blocks <= level_fixed_blocks_per_sm(p.sites_per_lane,
                                                     False) * SMS
               for p in plans)
    assert plans[0] == LevelFixedPlan(4, 128, 5376, 9, 598)
    # the asc columns of a DNA partition keep S % 4 == 0
    assert level_fixed_plan(42, 16388, SMS).sites_per_lane == 4


def test_per_rate_takes_the_same_sites_a_lane():
    """Per-rate counts take the per-site layout's sites a lane at every
    level; at 4 sites a lane their instantiation keeps 4 blocks an SM
    resident (its registers), so its runs of tiles are longer."""
    for w in _dna_level_widths():
        site = level_fixed_plan(w, 16384, SMS)
        rate = level_fixed_plan(w, 16384, SMS, rate_scalers=True)
        assert rate.sites_per_lane == site.sites_per_lane
        assert rate.tiles == site.tiles
        bps = level_fixed_blocks_per_sm(rate.sites_per_lane, True)
        assert rate.tiles_per_block == -(-rate.tiles // (bps * SMS))
    assert level_fixed_plan(42, 16384, SMS, rate_scalers=True)[3:] == \
        (11, 489)


@pytest.mark.parametrize("sites,lanes", [(16387, 1), (16385, 1),
                                         (16386, 2), (60002, 2)])
def test_site_counts_off_the_16_byte_grain_take_narrower_accesses(sites,
                                                                  lanes):
    """A row starts on 16 bytes only where S % 4 == 0: S % 4 == 2 takes 2
    sites a lane (8-byte accesses), odd S the scalar layout."""
    assert level_fixed_plan(42, sites, SMS).sites_per_lane == lanes


def test_unaligned_buffers_take_the_scalar_layout():
    assert level_fixed_plan(42, 16384, SMS, aligned=False).sites_per_lane \
        == 1


@pytest.mark.parametrize("sites", [8448, 16384, 16387, 60000, 1 << 20])
def test_one_op_levels_fill_the_card(sites):
    """A one-op level gives every SM at least LEVEL_FIXED_MIN_TILES_PER_SM
    blocks wherever one site a lane can (S >= 32 x 2 x SMs), and never
    more blocks than fill the card once."""
    plan = level_fixed_plan(1, sites, SMS)
    assert plan.blocks >= LEVEL_FIXED_MIN_TILES_PER_SM * SMS
    assert plan.blocks <= level_fixed_blocks_per_sm(plan.sites_per_lane,
                                                    False) * SMS


def test_constants_match_the_kernel_source():
    """The C entry recomputes the plan from the same constants and refuses
    a launch whose layout differs, so they must agree."""
    src = (Path(_kernels.__file__).resolve().parent.parent / "csrc"
           / "level_update.cu").read_text()
    for name, value in (("kFixedThreads", LEVEL_FIXED_THREADS),
                        ("kFixedBlocksPerSm", LEVEL_FIXED_BLOCKS_PER_SM),
                        ("kFixedBlocksPerSmRate",
                         LEVEL_FIXED_BLOCKS_PER_SM_RATE),
                        ("kFixedBlocksPerSmNarrow",
                         LEVEL_FIXED_BLOCKS_PER_SM_NARROW),
                        ("kFixedMinTilesPerSm",
                         LEVEL_FIXED_MIN_TILES_PER_SM)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name


@pytest.mark.parametrize("ops,sites,sms", [(0, 100, SMS), (1, 0, SMS),
                                           (1, 100, 0),
                                           (LEVEL_MAX_OPS + 1, 100, SMS)])
def test_shapes_outside_the_kernel_raise(ops, sites, sms):
    with pytest.raises(ValueError):
        level_fixed_plan(ops, sites, sms)


def test_the_largest_level_has_a_plan():
    plan = level_fixed_plan(LEVEL_MAX_OPS, 1 << 20, SMS)
    assert plan.tiles == LEVEL_MAX_OPS * (1 << 20) // plan.tile
    assert plan.blocks <= LEVEL_FIXED_BLOCKS_PER_SM * SMS
    assert level_fixed_plan(LEVEL_MAX_OPS, 1, SMS).sites_per_lane == 1


@settings(max_examples=60, deadline=None)
@given(ops=st.integers(1, 40), sites=st.integers(1, 3000),
       sms=st.integers(1, 160), aligned=st.booleans(),
       rate_scalers=st.booleans())
def test_tiles_cover_every_op_and_site_once(ops, sites, sms, aligned,
                                            rate_scalers):
    plan = level_fixed_plan(ops, sites, sms, aligned, rate_scalers)
    v = plan.sites_per_lane
    assert v in (1, 2, 4) and sites % v == 0 and (aligned or v == 1)
    assert plan.tile == LEVEL_FIXED_THREADS // 4 * v
    assert plan.tiles_per_block >= 1
    assert plan.blocks <= level_fixed_blocks_per_sm(v, rate_scalers) * sms
    got = _kernel_sites(plan, ops, sites)
    assert len(got) == ops * sites
    assert set(got) == {(o, s) for o in range(ops) for s in range(sites)}


def test_trial_form_widens_the_dna_levels():
    """The trial form lays a level of w ops over K trials out as w x K ops
    ((trial, op, tile), the trial outermost). A DNA step's 19 trials at
    128 x 16384 give every one of the 13 levels 4 sites a lane (a one-op
    level is 19 ops wide: 2432 tiles), per site and per rate; the final
    pair's 2 trials leave the two one-op levels at 2 sites a lane."""
    widths = _dna_level_widths()
    for rate_scalers in (False, True):
        k19 = [level_fixed_plan(w, 16384, SMS, rate_scalers=rate_scalers,
                                trials=19) for w in widths]
        assert [p.sites_per_lane for p in k19] == [4] * 13
        assert k19[-1] == level_fixed_plan(19, 16384, SMS,
                                           rate_scalers=rate_scalers)
        k2 = [level_fixed_plan(w, 16384, SMS, rate_scalers=rate_scalers,
                               trials=2).sites_per_lane for w in widths]
        assert k2 == [4] * 11 + [2, 2]
    assert level_fixed_plan(42, 16384, SMS, trials=19).tiles == 19 * 5376


@pytest.mark.parametrize("trials", [0, LEVEL_MAX_TRIALS + 1])
def test_trials_outside_the_grid_raise(trials):
    with pytest.raises(ValueError):
        level_fixed_plan(1, 100, SMS, trials=trials)


@settings(max_examples=40, deadline=None)
@given(ops=st.integers(1, 12), trials=st.integers(1, 8),
       sites=st.integers(1, 1500), sms=st.integers(1, 160),
       aligned=st.booleans())
def test_trial_tiles_cover_every_trial_op_and_site_once(ops, trials, sites,
                                                        sms, aligned):
    """The trial form's tiles, op j of the flat list being trial j // ops
    and op j % ops (csrc/level_update.cu: load_op_of), cover every (trial,
    op, site) once."""
    plan = level_fixed_plan(ops, sites, sms, aligned, trials=trials)
    assert plan == level_fixed_plan(ops * trials, sites, sms, aligned)
    got = [(j // ops, j % ops, s)
           for j, s in _kernel_sites(plan, ops * trials, sites)]
    assert len(got) == trials * ops * sites
    assert set(got) == {(k, o, s) for k in range(trials)
                        for o in range(ops) for s in range(sites)}


# ------------------------------------------- 33-64 states: level64_plan
# The 61-state problem's tree is the DNA main path's (128 taxa, seed 7):
# levels of 42, 25, 15, 11, 9, 6, 5, 4, 3, 2, 2, 1 and 1 ops.
S64_SITES = 4096


def _s64_kernel_work(plan, ops, sites, rates, trials=1):
    """How often the 64-state kernel's blocks compute each (trial, op,
    rate, site), in the order of csrc/states64.cuh's `run`: block b is rank
    b % cluster of run b // cluster; a run takes tiles run * per .. (run +
    1) * per - 1 of the flat (trial, op, tile) list; a block takes rates
    rank, rank + cluster, ...; a tile covers sites tile * TILE .. + TILE -
    1, those < S."""
    per_op = -(-sites // plan.tile)
    got = np.zeros((trials, ops, rates, sites), np.int64)
    for b in range(plan.blocks):
        run, rank = divmod(b, plan.cluster)
        for t in range(run * plan.tiles_per_block,
                       min((run + 1) * plan.tiles_per_block, plan.tiles)):
            k, rest = divmod(t, ops * per_op)
            op, tile = divmod(rest, per_op)
            got[k, op, rank::plan.cluster,
                tile * plan.tile:(tile + 1) * plan.tile] += 1
    return got


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(ops=st.integers(1, 12), trials=st.integers(1, 4),
       sites=st.integers(1, 700), rates=st.integers(1, 20),
       sms=st.sampled_from([1, 2, 7, 132]))
def test_states64_tiles_cover_every_trial_op_rate_and_site_once(
        ops, trials, sites, rates, sms):
    """For random levels, trials, rate counts and cards, the 64-state
    kernel's blocks compute every (trial, op, rate, site) exactly once;
    the cluster size divides the grid, and no more runs are launched than
    clusters stay resident."""
    resident = states64_resident(rates, sms)
    plan = level64_plan(ops, sites, rates, resident, trials)
    assert plan.tile == STATES64_TILE
    assert plan.tiles == trials * ops * -(-sites // STATES64_TILE)
    assert plan.blocks % plan.cluster == 0
    assert plan.blocks // plan.cluster <= resident
    assert (_s64_kernel_work(plan, ops, sites, rates, trials) == 1).all()


@pytest.mark.parametrize("rates", [1, 2, 3, 4, 5, 7, 8, 9, 10, 16, 17, 33])
def test_states64_cluster_holds_a_tiles_rates(rates):
    """A cluster is min(rates, 8) blocks (8 is the portable cluster size),
    one rate a block up to 8 rates, ceil(rates / 8) above; 5 and 7 rates
    give clusters that are not powers of two. The cluster divides the
    grid."""
    plan = level64_plan(3, 1000, rates, states64_resident(rates, SMS))
    assert plan.cluster == min(rates, STATES64_MAX_CLUSTER) <= 8
    assert plan.rates_per_block == -(-rates // plan.cluster)
    assert (plan.rates_per_block > 1) == (rates > STATES64_MAX_CLUSTER)
    assert plan.blocks % plan.cluster == 0


@pytest.mark.parametrize("rates,per,blocks", [(4, 1, 256), (8, 2, 256)])
def test_states64_one_op_level_fills_a_wave(rates, per, blocks):
    """A one-op level of the 61-state problem (4096 sites: 64 tiles) puts
    a block on every SM of a 132-SM card: at 4 rates 64 clusters of 4,
    256 blocks, one tile each; at 8 rates (33 resident clusters of 8)
    32 runs of 2 tiles. Nothing waits for a second wave."""
    resident = states64_resident(rates, SMS)
    plan = level64_plan(1, S64_SITES, rates, resident)
    assert (plan.tiles_per_block, plan.blocks) == (per, blocks)
    assert plan.blocks >= SMS
    assert plan.blocks // plan.cluster <= resident


def test_states64_wide_levels_stage_p_once_a_run():
    """The 61-state problem's levels on 132 SMs, 4 rates (66 resident
    clusters of 4): from 2 ops up a level takes one wave of runs, the
    42-op level 2688 tiles in runs of 41 (P staged once for each op a run
    meets: at most 2), the one-op levels 64 runs of one tile."""
    widths = _dna_level_widths()
    assert widths == [42, 25, 15, 11, 9, 6, 5, 4, 3, 2, 2, 1, 1]
    resident = states64_resident(4, SMS)
    assert resident == 66
    plans = [level64_plan(w, S64_SITES, 4, resident) for w in widths]
    assert [p.tiles_per_block for p in plans] == [
        41, 25, 15, 11, 9, 6, 5, 4, 3, 2, 2, 1, 1]
    assert all(p.blocks // 4 <= resident for p in plans)
    per_op = S64_SITES // STATES64_TILE
    for p in plans:
        runs = range(p.blocks // p.cluster)
        assert max(len({t // per_op for t in range(
            r * p.tiles_per_block,
            min((r + 1) * p.tiles_per_block, p.tiles))}) for r in runs) <= 2


def test_states64_constants_match_the_kernel_source():
    """csrc/states64.cuh's `plan` recomputes the layout from the same
    constants (the C entries refuse a launch whose layout differs)."""
    src = (Path(_kernels.__file__).resolve().parent.parent / "csrc"
           / "states64.cuh").read_text()
    for name, value in (("kThreads", STATES64_THREADS),
                        ("kBlocksPerSm", STATES64_BLOCKS_PER_SM),
                        ("kTile", STATES64_TILE),
                        ("kMaxCluster", STATES64_MAX_CLUSTER),
                        ("kSP", _kernels.KERNEL_MAX_STATES)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name


@pytest.mark.parametrize("args", [(0, 100, 4, 66), (1, 0, 4, 66),
                                  (1, 100, 0, 66), (1, 100, 4, 0),
                                  (LEVEL_MAX_OPS + 1, 100, 4, 66)])
def test_states64_shapes_outside_the_kernel_raise(args):
    with pytest.raises(ValueError):
        level64_plan(*args)
