"""The rows kernel's plan (libpll2_tpu_torch/ops/_kernels.py:rows_plan), a
pure function of the shape, the contraction mode, the site count and the
device. 'highest' (the default here): on chip where a block's slots, their
counts and two buffers of both P-matrices fit in its shared memory, with
two sites a thread (64-site tiles) where the sites still give nearly every
SM a block, else one; else spilled to device memory. 'bf16' and 'split'
(from 16 states): on the tensor cores ('tc-on-chip': 64-site tiles, two
warpgroups, P's bf16 atoms and the slots in shared memory) where that
fits, else with the slots in device memory ('tc-spill') where P's atoms
fit, else spilled on the CUDA cores ('split' staging Pl beside Ph). The
bytes are those of
the layouts in csrc/fused_traversal_rows.cu (smem_words, tc_smem_bytes),
which refuses a launch whose count differs. An H100 has 132 SMs and lets a
block use 232,448 bytes."""
import pytest

from libpll2_tpu_torch.ops._kernels import (ROWS_MAX_RS, ROWS_PADDED_STATES,
                                            ROWS_SPILL_P_BYTES,
                                            ROWS_SPT2_SM_SHARE, rows_plan,
                                            rows_tc_bytes)

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


# ------------------------------------------------ 'bf16' and 'split' plans
def _tc_bytes(rates, states, sp, n_slots, rate_scalers, onchip=True):
    """The tensor-core layout's bytes, spelled out part by part (the slots
    on chip, or not at all: 'tc-spill')."""
    n = -(-sp // 8) * 8                      # wgmma's N: SP padded to 8
    align = 1024                             # the swizzle atoms' alignment
    atoms = 2 * rates * n * 128              # Ph (and Pl) rows of 128 bytes
    codes = 2 * 2 * 64                       # two buffers of two code rows
    red = (2 * rates if rate_scalers else 2) * 64    # maxima (+ counts)
    sr = rates if rate_scalers else 1
    slots = n_slots * (rates * states * 68 + sr * 64) if onchip else 0
    return align + atoms + 4 * (codes + red + slots)


@pytest.mark.parametrize("mxu", ["split", "bf16"])
def test_lg_g4_main_path_runs_on_the_tensor_cores(mxu):
    """The protein main path (LG+G4, 6 slots, 128 x 8192) in either
    rounded mode: 159,232 bytes (N = 24: atoms of 3,072 bytes), tiles of
    64 sites, two warpgroups taking the rates."""
    plan = rows_plan(4, 20, 6, False, H100, MAIN, SMS, mxu=mxu)
    assert (plan.plan, plan.sites_per_thread) == ("tc-on-chip", 2)
    assert plan.smem_bytes == 159232 == _tc_bytes(4, 20, 20, 6, False)
    assert plan.smem_bytes == rows_tc_bytes(4, 20, 20, 6, False)
    assert (plan.padded_states, plan.rate_chunk, plan.groups) == (20, 4, 2)


@pytest.mark.parametrize("mxu", ["split", "bf16"])
@pytest.mark.parametrize("rate_scalers", [False, True])
@pytest.mark.parametrize("states", [16, 17, 20, 21, 24, 32])
@pytest.mark.parametrize("rates", [1, 3, 4, 8])
def test_rounded_modes_take_the_tensor_cores_where_they_fit(mxu, rate_scalers,
                                                            states, rates):
    """Every slot count and candidate count: 'tc-on-chip' exactly where
    the layout fits (one warpgroup for one rate, else two), else
    'tc-spill' (the slots in device memory) where P's atoms fit; the tile
    and the bytes do not depend on the sites or the candidates."""
    sp = next(p for p in ROWS_PADDED_STATES if p >= states)
    for n_slots in (1, 2, 5, 9, 12, 30):
        for sites, k in ((300, 1), (MAIN, 1), (MAIN, 64)):
            plan = rows_plan(rates, states, n_slots, rate_scalers, H100,
                             sites, SMS, candidates=k, mxu=mxu)
            on = _tc_bytes(rates, states, sp, n_slots, rate_scalers)
            off = _tc_bytes(rates, states, sp, n_slots, rate_scalers, False)
            want = ("tc-on-chip", on) if on <= H100 else ("tc-spill", off)
            assert plan == (want[0], 2, want[1], sp, rates,
                            2 if rates > 1 else 1)


@pytest.mark.parametrize("rate_scalers,last", [(False, 9), (True, 8)])
def test_tensor_core_slot_boundary(rate_scalers, last):
    """At LG+G4 the tensor-core plan holds 9 slots (per rate 8): a slot
    adds [80, 68] floats and its counts [SR, 64]; from one more the slots
    go to device memory ('tc-spill', 29,184 bytes of P's atoms and the
    rest), where 'highest' keeps its own on-chip plan."""
    slot = 4 * (80 * 68 + (4 if rate_scalers else 1) * 64)
    on = rows_plan(4, 20, last, rate_scalers, H100, MAIN, SMS, mxu="split")
    assert on.plan == "tc-on-chip" and on.smem_bytes + slot > H100
    for mxu in ("split", "bf16"):
        off = rows_plan(4, 20, last + 1, rate_scalers, H100, MAIN, SMS,
                        mxu=mxu)
        assert (off.plan, off.sites_per_thread) == ("tc-spill", 2)
        assert off.smem_bytes == _tc_bytes(4, 20, 20, 1, rate_scalers,
                                           False)
    assert rows_plan(4, 20, last + 1, rate_scalers, H100, MAIN,
                     SMS).plan == "on-chip"
    # exactly at the limit is on chip
    assert rows_plan(4, 20, last, rate_scalers, on.smem_bytes, MAIN, SMS,
                     mxu="bf16").plan == "tc-on-chip"
    assert rows_plan(4, 20, last, rate_scalers, on.smem_bytes - 1, MAIN,
                     SMS, mxu="bf16").plan == "tc-spill"


def test_split_spill_stages_pl_beside_ph():
    """16 rates x 32 states: the rounded modes keep the tensor cores with
    the slots in device memory (P's atoms 131,072 bytes); at 32 rates x 32
    states the atoms do not fit and every mode spills on the CUDA cores,
    'split' staging Pl beside Ph, so half the rates a chunk (4 of 64 KB
    each side), 'bf16' as 'highest' (8)."""
    for mxu in ("bf16", "split"):
        plan = rows_plan(16, 32, 4, False, H100, 300, SMS, mxu=mxu)
        assert plan == ("tc-spill", 2, 1024 + 131072 + 4 * (256 + 128), 32,
                        16, 2)
    plans = {m: rows_plan(32, 32, 4, False, H100, 300, SMS, mxu=m)
             for m in ("highest", "bf16", "split")}
    assert {p.plan for p in plans.values()} == {"spill"}
    assert plans["split"].rate_chunk == ROWS_SPILL_P_BYTES // (
        2 * 2 * 32 * 32 * 4) == 4
    assert plans["split"].smem_bytes == 4 * (2 * 2 * 4 * 32 * 32 + 2 * 32
                                             + 8 * 32)
    assert plans["bf16"] == plans["highest"]


@pytest.mark.parametrize("states", [1, 4, 8, 9, 15])
def test_rounded_modes_below_16_states_take_highest_plan(states):
    """Below 16 states every mode contracts exactly: the 'highest' plan."""
    for mxu in ("split", "bf16"):
        assert rows_plan(4, states, 3, False, H100, MAIN, SMS, mxu=mxu) \
            == rows_plan(4, states, 3, False, H100, MAIN, SMS)


def test_rows_plan_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mxu"):
        rows_plan(4, 20, 3, False, H100, MAIN, SMS, mxu="fast")
