"""The rows kernel's plan (libpll2_tpu_torch/ops/_kernels.py:rows_plan), a
pure function of the shape, the site count and the device: on chip where a
block's slots, their counts and two buffers of both P-matrices fit in its
shared memory, with two sites a thread (64-site tiles) where the sites
still give nearly every SM a block, else one; else spilled to device
memory. The bytes are those of the layout in csrc/fused_traversal_rows.cu
(smem_words), which refuses a launch whose count differs. An H100 has 132
SMs and lets a block use 232,448 bytes."""
import pytest

from libpll2_tpu_torch.ops._kernels import (ROWS_MAX_RS, ROWS_PADDED_STATES,
                                            ROWS_SPILL_P_BYTES,
                                            ROWS_SPT2_SM_SHARE, rows_plan)

H100, SMS = 232448, 132
MAIN = 8192          # the protein main path's sites: 128 tiles of 64
NARROW = 1000        # 16 tiles of 64: one site a thread


def _words(rates, states, sp, n_slots, rate_scalers, groups, spt):
    """The layout's 4-byte words on chip, spelled out part by part."""
    tile, h = 32 * spt, 8 // groups
    p = 2 * 2 * rates * sp * sp                  # two buffers of P[m1], P[m2]
    codes = 2 * 2 * tile                         # two buffers of two code rows
    red = (rates * h + rates if rate_scalers else 8) * tile
    sr = rates if rate_scalers else 1
    slots = n_slots * (rates * states + sr) * tile
    return p + codes + red + slots


def test_lg_g4_main_path_runs_on_chip_two_sites_a_thread():
    """The protein main path (LG+G4, 6 slots, 128 x 8192): 153,088 bytes,
    one block of 64 sites an SM, 128 blocks for 132 SMs."""
    plan = rows_plan(4, 20, 6, False, H100, MAIN, SMS)
    assert plan.plan == "on-chip" and plan.sites_per_thread == 2
    assert plan.smem_bytes == 153088 == 4 * _words(4, 20, 20, 6, False, 4, 2)
    assert (plan.padded_states, plan.rate_chunk, plan.groups) == (20, 4, 4)


def test_narrow_alignment_keeps_one_site_a_thread():
    """At 1000 sites the same tree takes tiles of 32 (89,344 bytes, two
    blocks an SM): 64-site tiles would leave most SMs without a block."""
    plan = rows_plan(4, 20, 6, False, H100, NARROW, SMS)
    assert plan.plan == "on-chip" and plan.sites_per_thread == 1
    assert plan.smem_bytes == 89344 == 4 * _words(4, 20, 20, 6, False, 4, 1)
    assert 2 * plan.smem_bytes <= 228 * 1024


def test_site_count_boundary_for_two_sites_a_thread():
    """Two sites a thread from ceil(sites / 64) >= 0.9 * SMs on."""
    first = int(-(-ROWS_SPT2_SM_SHARE * SMS // 1)) * 64 - 63
    assert rows_plan(4, 20, 6, False, H100, first, SMS).sites_per_thread == 2
    assert rows_plan(4, 20, 6, False, H100, first - 1,
                     SMS).sites_per_thread == 1


@pytest.mark.parametrize("rate_scalers", [False, True])
@pytest.mark.parametrize("sites", [NARROW, MAIN])
def test_on_chip_bytes_follow_the_layout(rate_scalers, sites):
    for rates, states, n_slots in ((1, 16, 3), (3, 17, 5), (4, 20, 9),
                                   (8, 20, 4), (4, 32, 2)):
        plan = rows_plan(rates, states, n_slots, rate_scalers, H100, sites,
                         SMS)
        assert plan.plan == "on-chip", (rates, states, n_slots)
        assert plan.smem_bytes == 4 * _words(
            rates, states, plan.padded_states, n_slots, rate_scalers,
            plan.groups, plan.sites_per_thread)
        assert plan.rate_chunk == rates


@pytest.mark.parametrize("rate_scalers", [False, True])
def test_slot_count_boundary(rate_scalers):
    """At 1000 sites LG+G4 stays on chip up to 19 slots and spills at one
    more: a slot adds its [80, 32] floats and its counts. At 8192 sites two
    sites a thread fit up to 9 slots; from 10 on the tiles of 32 take over,
    up to the same 19."""
    slot = (80 + (4 if rate_scalers else 1)) * 32 * 4
    on = rows_plan(4, 20, 19, rate_scalers, H100, NARROW, SMS)
    assert on.plan == "on-chip" and on.smem_bytes <= H100
    assert on.smem_bytes + slot > H100
    assert rows_plan(4, 20, 20, rate_scalers, H100, NARROW,
                     SMS).plan == "spill"
    # exactly at the limit is on chip
    assert rows_plan(4, 20, 19, rate_scalers, on.smem_bytes, NARROW,
                     SMS).plan == "on-chip"
    assert rows_plan(4, 20, 19, rate_scalers, on.smem_bytes - 1, NARROW,
                     SMS).plan == "spill"
    wide = [rows_plan(4, 20, n, rate_scalers, H100, MAIN, SMS)
            for n in (9, 10, 19, 20)]
    assert [(p.plan, p.sites_per_thread) for p in wide] == [
        ("on-chip", 2), ("on-chip", 1), ("on-chip", 1), ("spill", 1)]


def test_32_by_32_spills_with_p_in_chunks():
    """ROWS_MAX_RS (32 rates x 32 states): one slot alone is 128 KB, P's
    two buffers 512 KB; the spill plan stages 8 rates (64 KB) at a time,
    one site a thread."""
    assert 32 * 32 == ROWS_MAX_RS
    plan = rows_plan(32, 32, 1, False, H100, MAIN, SMS)
    assert (plan.plan, plan.sites_per_thread) == ("spill", 1)
    assert plan.rate_chunk == ROWS_SPILL_P_BYTES // (2 * 32 * 32 * 4) == 8
    assert plan.smem_bytes == 4 * (2 * 8 * 32 * 32 + 2 * 32 + 8 * 32)
    assert plan.groups == 8


def test_16_rates_32_states_spill():
    plan = rows_plan(16, 32, 4, False, H100, 300, SMS)
    assert (plan.plan, plan.rate_chunk, plan.padded_states) == \
        ("spill", 8, 32)
    per_rate = rows_plan(8, 32, 4, True, H100, 300, SMS)
    # P's two buffers (128 KB) leave no room for 4 slots of 32 KB
    assert per_rate.plan == "spill" and per_rate.rate_chunk == 8
    assert per_rate.smem_bytes == 4 * (2 * 8 * 1024 + 2 * 32
                                       + (8 * 1 + 8) * 32)


@pytest.mark.parametrize("states,padded", [(1, 8), (4, 8), (8, 8), (9, 16),
                                           (16, 16), (17, 20), (20, 20),
                                           (21, 24), (24, 24), (25, 32),
                                           (28, 32), (32, 32)])
def test_padded_states(states, padded):
    assert padded in ROWS_PADDED_STATES
    assert rows_plan(4, states, 3, False, H100, MAIN,
                     SMS).padded_states == padded


@pytest.mark.parametrize("rates,groups", [(1, 1), (2, 2), (3, 2), (4, 4),
                                          (5, 4), (7, 4), (8, 8), (16, 8),
                                          (32, 8)])
def test_warp_groups(rates, groups):
    """Groups are the largest power of two <= min(rates, 8) warps' share."""
    assert rows_plan(rates, 20, 2, False, H100, MAIN, SMS).groups == groups


def test_every_accepted_shape_has_a_plan():
    """No shape the rows route takes (states <= 32, rates * states <=
    ROWS_MAX_RS) is refused on an H100, whatever its slot and site count."""
    for states in range(1, 33):
        for rates in range(1, ROWS_MAX_RS // states + 1):
            for n_slots in (1, 7, 40):
                for sites in (1, MAIN):
                    plan = rows_plan(rates, states, n_slots, rates <= 8,
                                     H100, sites, SMS)
                    assert plan.smem_bytes <= H100
                    assert 1 <= plan.rate_chunk <= rates


def test_refuses_what_no_plan_takes():
    with pytest.raises(ValueError):
        rows_plan(4, 33, 3, False, H100, MAIN, SMS)
    with pytest.raises(ValueError):
        rows_plan(4, 20, 3, False, 4096, MAIN, SMS)


# the candidate form: one launch of K candidates, each its own row of tiles
@pytest.mark.parametrize("k,sites,spt", [
    (1, NARROW, 1),      # 16 tiles of 64
    (7, NARROW, 1),      # 112 tiles: still short of 0.9 x 132
    (8, NARROW, 2),      # 128 tiles
    (2, 4096, 2),        # 64 tiles a candidate
    (1, 4096, 1),
    (64, MAIN, 2),       # the candidate batch of the protein main path
    (128, 300, 2),
    (1, 300, 1),
])
def test_candidates_count_their_tiles_together(k, sites, spt):
    """Two sites a thread where the launch's tiles of 64 sites, those of
    all K candidates, reach 0.9 of the SMs; the bytes are a block's, which
    K does not change."""
    plan = rows_plan(4, 20, 6, False, H100, sites, SMS, candidates=k)
    assert plan.plan == "on-chip" and plan.sites_per_thread == spt
    assert plan.smem_bytes == 4 * _words(4, 20, 20, 6, False, 4, spt)
    assert (k * -(-sites // 64) >= ROWS_SPT2_SM_SHARE * SMS) == (spt == 2)


def test_candidates_spill_as_one_topology_does():
    """The spill plan does not depend on K: 16 rates x 32 states."""
    for k in (1, 3, 128):
        plan = rows_plan(16, 32, 6, False, H100, MAIN, SMS, candidates=k)
        assert plan == rows_plan(16, 32, 6, False, H100, MAIN, SMS)
        assert plan.plan == "spill"
    with pytest.raises(ValueError):
        rows_plan(4, 20, 6, False, H100, MAIN, SMS, candidates=0)
