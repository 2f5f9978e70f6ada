"""The DNA fused kernel's plan (libpll2_tpu_torch/ops/_kernels.py:
fused_plan), a pure function of the shape, the site count and the device:
4 states x 4 rates run on chip (a block's slots and counts in shared
memory, a producer warp staging each op's inputs), 4 threads holding the
4 rates of two sites (2 threads a site) where blocks of 64 sites still
reach FUSED_SPT2_SM_SHARE of the SMs and fit, else of one site (4 threads
a site), and spill to device memory where neither fits; every other size
takes the spill plan's runtime-size body.
The bytes are those of the layout in csrc/fused_traversal.cu
(onchip_smem_words), which refuses a launch whose count differs. An H100
has 132 SMs and lets a block use 232,448 bytes."""
import pytest

from libpll2_tpu_torch.ops._kernels import (FUSED_COMPUTE_THREADS,
                                            FUSED_DEPTH, FUSED_SPILL_BLOCK,
                                            FUSED_SPT2_SM_SHARE, FusedPlan,
                                            fused_onchip_bytes, fused_plan)

H100, SMS = 232448, 132
DNA = 16384          # the DNA main path: 128 taxa, 7 slots
REPEATS = 4465       # the site-repeats problem: 246 taxa, 10 slots
NARROW = 1000
SPILL = FusedPlan("spill", 1, FUSED_SPILL_BLOCK, 0)


def _words(n_slots, spt):
    """The on-chip layout's 4-byte words, spelled out part by part."""
    sites = 32 * spt                          # the block's
    barriers = 2 * FUSED_DEPTH * 2            # full and empty, 8 bytes each
    row, p = 8, 2 * 4 * 20                    # table row; P[m1], P[m2] padded
    tips = 2 * sites * (4 + 1)                # raw rows and codes, 2 children
    ring = barriers + FUSED_DEPTH * (row + p + tips)
    counts = spt * FUSED_COMPUTE_THREADS      # a count a site of each thread
    return ring + n_slots * (sites * 4 * 4 + counts)


def _plan(n_slots, sites, rate_scalers=False, smem=H100, rates=4, states=4):
    return fused_plan(rates, states, n_slots, rate_scalers, smem, sites, SMS)


@pytest.mark.parametrize("rate_scalers", [False, True])
def test_dna_main_path_runs_two_sites_a_thread(rate_scalers):
    """128 x 16384, 7 slots: 64 sites a block of 128 threads, 256 blocks."""
    plan = _plan(7, DNA, rate_scalers)
    assert plan == FusedPlan("on-chip", 2, 64, 48832)
    assert plan.smem_bytes == 4 * _words(7, 2)


@pytest.mark.parametrize("rate_scalers", [False, True])
def test_repeats_shape_runs_two_sites_a_thread(rate_scalers):
    """246 x 4465, 10 slots: 70 blocks of 64 sites, over half the SMs."""
    plan = _plan(10, REPEATS, rate_scalers)
    assert plan == FusedPlan("on-chip", 2, 64, 4 * _words(10, 2))


@pytest.mark.parametrize("rate_scalers", [False, True])
def test_narrow_alignment_runs_one_site_a_thread(rate_scalers):
    plan = _plan(7, NARROW, rate_scalers)
    assert plan == FusedPlan("on-chip", 4, 32, 25792)
    assert plan.smem_bytes == 4 * _words(7, 1)


@pytest.mark.parametrize("rate_scalers", [False, True])
@pytest.mark.parametrize("n_slots", [7, 10])
def test_bytes_follow_the_layout(n_slots, rate_scalers):
    """Per-rate counts take the bytes of per-site ones: each thread keeps
    one count a site either way."""
    for spt in (1, 2):
        assert fused_onchip_bytes(n_slots, spt) == 4 * _words(n_slots, spt)
    for sites, spt in ((DNA, 2), (REPEATS, 2), (NARROW, 1)):
        plan = _plan(n_slots, sites, rate_scalers)
        assert plan.smem_bytes == fused_onchip_bytes(n_slots, spt)
        assert plan.threads_per_site == 4 // spt
        assert plan.sites_per_block == 32 * spt


def test_seven_and_ten_slots_bytes():
    """The ring (7,872 bytes at one site a thread, 12,992 at two), then
    2,560 or 5,120 bytes a slot."""
    assert fused_onchip_bytes(7, 1) == 7872 + 7 * 2560 == 25792
    assert fused_onchip_bytes(7, 2) == 12992 + 7 * 5120 == 48832
    assert fused_onchip_bytes(10, 1) == 7872 + 10 * 2560 == 33472
    assert fused_onchip_bytes(10, 2) == 12992 + 10 * 5120 == 64192


def test_site_count_boundary_for_two_sites_a_thread():
    """Two sites a thread from ceil(sites / 64) >= FUSED_SPT2_SM_SHARE *
    SMs on: 4161 sites (66 blocks) on an H100, one below."""
    first = int(-(-FUSED_SPT2_SM_SHARE * SMS // 1)) * 64 - 63
    assert first == 4161
    assert _plan(7, first).threads_per_site == 2
    assert _plan(7, first - 1).threads_per_site == 4
    assert _plan(7, 10 ** 6).threads_per_site == 2
    for sites in (1, 31, 33, NARROW, 4159, 4160):
        assert _plan(7, sites).threads_per_site == 4


def test_slot_count_boundaries():
    """At 16384 sites two sites a thread fit up to 42 slots; from 43 on
    one site a thread takes over, up to 87 slots; 88 spill."""
    assert fused_onchip_bytes(42, 2) <= H100 < fused_onchip_bytes(43, 2)
    assert fused_onchip_bytes(87, 1) <= H100 < fused_onchip_bytes(88, 1)
    got = [(p.plan, p.threads_per_site) for p in
           (_plan(n, DNA) for n in (42, 43, 87, 88))]
    assert got == [("on-chip", 2), ("on-chip", 4), ("on-chip", 4),
                   ("spill", 1)]
    # exactly at the limit is on chip
    at = fused_onchip_bytes(7, 2)
    assert _plan(7, DNA, smem=at).threads_per_site == 2
    assert _plan(7, DNA, smem=at - 1).threads_per_site == 4
    assert _plan(7, DNA, smem=fused_onchip_bytes(7, 1) - 1) == SPILL


@pytest.mark.parametrize("rate_scalers", [False, True])
@pytest.mark.parametrize("sites", [NARROW, REPEATS, DNA])
def test_spill_at_a_large_slot_count(sites, rate_scalers):
    assert _plan(250, sites, rate_scalers) == SPILL
    assert fused_onchip_bytes(250, 1) > H100


@pytest.mark.parametrize("rates,states", [(3, 4), (4, 5), (1, 4), (16, 4),
                                          (4, 2), (8, 15)])
def test_other_sizes_take_the_runtime_size_body(rates, states):
    for sites in (NARROW, DNA):
        assert _plan(7, sites, rates=rates, states=states) == SPILL


def test_every_accepted_4x4_shape_has_a_plan():
    """No 4 x 4 shape the kernel takes is refused on an H100, whatever its
    slot and site count, and an on-chip block fits its bytes."""
    for n_slots in (1, 2, 7, 10, 42, 43, 87, 88, 250, 1000):
        for sites in (1, 2, 33, NARROW, 4160, 4161, REPEATS, DNA, 40003,
                      10 ** 6):
            for rate_scalers in (False, True):
                plan = _plan(n_slots, sites, rate_scalers)
                assert plan.plan in ("on-chip", "spill")
                if plan.plan == "on-chip":
                    assert plan.smem_bytes <= H100
                    assert plan.threads_per_site in (2, 4)
                    assert plan.sites_per_block * plan.threads_per_site \
                        == FUSED_COMPUTE_THREADS


def test_refuses_what_no_plan_takes():
    for bad in (dict(rates=0), dict(states=0), dict(states=33),
                dict(n_slots=0), dict(sites=0)):
        kw = dict(rates=4, states=4, n_slots=7, sites=DNA)
        kw.update(bad)
        with pytest.raises(ValueError):
            fused_plan(kw["rates"], kw["states"], kw["n_slots"], False, H100,
                       kw["sites"], SMS)


# the candidate form: one launch of K candidates, each its own row of blocks
@pytest.mark.parametrize("k,sites,tps", [
    (1, NARROW, 4),      # 16 blocks of 64
    (4, NARROW, 4),      # 64 blocks: short of half the SMs
    (5, NARROW, 2),      # 80 blocks
    (2, 2049, 2),        # 33 blocks a candidate, 66 in all
    (2, 2048, 4),        # 32 a candidate, 64 in all
    (1, 4159, 4),        # the widest one topology at one site a thread
    (2, 4159, 2),
    (128, DNA, 2),       # a chunk of the DNA main path's candidates
    (130, 300, 2),
    (1, 300, 4),
])
def test_candidates_count_their_blocks_together(k, sites, tps):
    """Two sites a thread where the launch's blocks of 64 sites, those of
    all K candidates, reach FUSED_SPT2_SM_SHARE of the SMs; the bytes are a
    block's, which K does not change."""
    plan = fused_plan(4, 4, 7, False, H100, sites, SMS, candidates=k)
    spt = 4 // tps
    assert plan == FusedPlan("on-chip", tps, 32 * spt, 4 * _words(7, spt))
    assert (k * -(-sites // 64) >= FUSED_SPT2_SM_SHARE * SMS) == (tps == 2)


@pytest.mark.parametrize("k", [1, 3, 128])
def test_candidates_spill_as_one_topology_does(k):
    assert _plan(250, DNA) == SPILL
    assert fused_plan(4, 4, 250, False, H100, DNA, SMS, candidates=k) \
        == SPILL
    assert fused_plan(3, 4, 7, False, H100, DNA, SMS, candidates=k) \
        == SPILL
    with pytest.raises(ValueError):
        fused_plan(4, 4, 7, False, H100, DNA, SMS, candidates=0)
