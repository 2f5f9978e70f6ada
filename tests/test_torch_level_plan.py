"""The 4x4 level kernel's launch plan, a pure host function:
ops/_kernels.py:level_fixed_plan lays one level out from its ops, its
sites, whether the buffers are 16-byte aligned, the counting mode and the
device's SM count (four lanes a site group, one per rate; 4, 2 or 1 sites
a lane; blocks over runs of tiles, as many as the instantiation keeps
resident fill the card). csrc/level_update.cu's fixed_plan computes the
same, and its kernel walks the tiles as `_kernel_sites` does here. An H100
has 132 SMs."""
import re
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from libpll2_tpu_torch.ops import _kernels
from libpll2_tpu_torch.ops._kernels import (
    LEVEL_FIXED_BLOCKS_PER_SM, LEVEL_FIXED_BLOCKS_PER_SM_NARROW,
    LEVEL_FIXED_BLOCKS_PER_SM_RATE, LEVEL_FIXED_MIN_TILES_PER_SM,
    LEVEL_FIXED_THREADS, LEVEL_MAX_OPS, LEVEL_MAX_TRIALS, LevelFixedPlan,
    level_fixed_blocks_per_sm, level_fixed_plan)
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
