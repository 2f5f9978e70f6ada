"""The fused kernel's plans (libpll2_tpu_torch/ops/_kernels.py), pure
functions of the shape, the site count and the device.

`fused_plan`: 4 states x 4 rates run on chip (a block's slots and counts
in shared memory, a producer warp staging each op's inputs), 4 threads
holding the 4 rates of two sites (2 threads a site) where blocks of 64
sites still reach FUSED_SPT2_SM_SHARE of the SMs and fit, else of one site
(4 threads a site), and spill to device memory where neither fits; every
other size takes the runtime-size body's plan.
The bytes are those of the layout in csrc/fused_traversal.cu
(onchip_smem_words), which refuses a launch whose count differs. On chip,
given the launch's subtree splits (`split`), the plan takes a thread block
cluster of 2, 4 or 8 blocks where its model (`fused_walk_cost`: one wave
of resident blocks, an op's time from the SM's compute warps, a cost a
block of a cluster) puts it below one block a walk; a launch that fills
the card's block slots without one keeps one.

`generic_plan`, the runtime-size body's (fused_generic, float32 and the
float64 walk): a site's rates on G neighbouring lanes, the state count
padded to an instantiated width, compute warps a block from the sites, the
candidates and the SM count, on chip with the deepest ring that fits, else
spilled with P read through L1; its bytes are generic_layout's in
csrc/fused_traversal.cu. An H100 has 132 SMs and lets a block use 232,448
bytes."""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from libpll2_tpu_torch.ops._kernels import (FUSED_CLUSTER_COST,
                                            FUSED_COMPUTE_THREADS,
                                            FUSED_DEPTH, FUSED_LATENCY_WARPS,
                                            FUSED_SPILL_BLOCK,
                                            FUSED_SPT2_SM_SHARE,
                                            GENERIC_DEPTHS, GENERIC_MAX_WARPS,
                                            GENERIC_WIDTHS, FusedPlan,
                                            GenericPlan, fused_onchip_bytes,
                                            fused_plan, fused_resident_blocks,
                                            fused_walk_cost, generic_bytes,
                                            generic_plan, spill_slots)

H100, SMS = 232448, 132
DNA = 16384          # the DNA main path: 128 taxa, 7 slots
REPEATS = 4465       # the site-repeats problem: 246 taxa, 10 slots
NARROW = 1000
SPILL = FusedPlan("spill", 1, FUSED_SPILL_BLOCK, 0)


def _words(n_slots, spt):
    """The on-chip layout's 4-byte words, spelled out part by part."""
    sites = 32 * spt                          # the block's
    # full and empty, and the cluster's join and done: 8 bytes each
    barriers = (2 * FUSED_DEPTH + 2) * 2
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
    assert plan == FusedPlan("on-chip", 2, 64, 48848)
    assert plan.smem_bytes == 4 * _words(7, 2)


@pytest.mark.parametrize("rate_scalers", [False, True])
def test_repeats_shape_runs_two_sites_a_thread(rate_scalers):
    """246 x 4465, 10 slots: 70 blocks of 64 sites, over half the SMs."""
    plan = _plan(10, REPEATS, rate_scalers)
    assert plan == FusedPlan("on-chip", 2, 64, 4 * _words(10, 2))


@pytest.mark.parametrize("rate_scalers", [False, True])
def test_narrow_alignment_runs_one_site_a_thread(rate_scalers):
    plan = _plan(7, NARROW, rate_scalers)
    assert plan == FusedPlan("on-chip", 4, 32, 25808)
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
    """The ring (7,888 bytes at one site a thread, 13,008 at two), then
    2,560 or 5,120 bytes a slot."""
    assert fused_onchip_bytes(7, 1) == 7888 + 7 * 2560 == 25808
    assert fused_onchip_bytes(7, 2) == 13008 + 7 * 5120 == 48848
    assert fused_onchip_bytes(10, 1) == 7888 + 10 * 2560 == 33488
    assert fused_onchip_bytes(10, 2) == 13008 + 10 * 5120 == 64208


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


@pytest.mark.parametrize("rates,states,lanes,width", [
    (3, 4, 4, 4), (4, 5, 4, 8), (1, 4, 1, 4), (16, 4, 16, 4), (4, 2, 4, 4),
    (8, 15, 8, 16), (8, 4, 8, 4), (33, 4, 32, 4), (2, 9, 2, 16),
    (5, 16, 8, 16)])
def test_other_sizes_take_the_runtime_size_body(rates, states, lanes, width):
    """Every float32 shape but 4 x 4 takes the runtime-size body's plan:
    on chip at 7 slots, a site's rates on `lanes` lanes (rates a lane
    above 32), P padded to the instantiated `width`."""
    for sites in (NARROW, DNA):
        plan = _plan(7, sites, rates=rates, states=states)
        assert isinstance(plan, GenericPlan) and plan.plan == "on-chip"
        assert plan == generic_plan(rates, states, 7, False, H100, sites,
                                    SMS)
        assert (plan.threads_per_site, plan.padded_states) == (lanes, width)
        assert plan.rates_per_lane == -(-rates // lanes)
        assert plan.sites_per_block == 32 * plan.warps // lanes


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
    assert fused_plan(3, 4, 7, False, H100, DNA, SMS, candidates=k).plan \
        == "on-chip"
    assert fused_plan(3, 4, 1000, False, H100, DNA, SMS,
                      candidates=k).plan == "spill"
    with pytest.raises(ValueError):
        fused_plan(4, 4, 7, False, H100, DNA, SMS, candidates=0)


# the runtime-size body (generic_plan): float32 and the float64 walk
FLAGSHIP = 3581       # the flagship's 1000 x 4000 alignment's patterns
PROTEIN = 8192        # the protein main path: 128 taxa, 6 slots


def _gwords(onchip, rates, states, n_slots, rate_scalers, itemsize, width,
            warps, depth, raw):
    """generic_layout's 4-byte words, spelled out part by part."""
    lanes = 32 * warps
    g = min(32, 1 << (rates - 1).bit_length())
    rpl, sites = -(-rates // g), lanes // g
    barriers = 2 * depth * 2                  # full and empty, 8 bytes each
    p = 2 * rates * (width * width * itemsize // 4 + 4) if onchip else 0
    codes = 2 * (-(-sites // 4) * 4)          # 2 children, rounded to 16 B
    tips = -(-2 * states * sites * itemsize // 16) * 4 if raw else 0
    ring = barriers + depth * (8 + p + codes + tips)
    if not onchip:
        return ring
    slots = n_slots * rpl * states * lanes * itemsize // 4
    counts = n_slots * (rpl if rate_scalers else 1) * lanes
    return ring + slots + counts


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rate_scalers", [False, True])
@pytest.mark.parametrize("raw", [False, True])
def test_generic_bytes_follow_the_layout(itemsize, rate_scalers, raw):
    for rates, states in ((1, 4), (3, 4), (4, 5), (8, 15), (33, 4),
                          (4, 16)):
        width = next(w for w in GENERIC_WIDTHS[itemsize] if w >= states)
        for onchip in (True, False):
            for warps in (1, 2, 4):
                for depth in GENERIC_DEPTHS:
                    got = generic_bytes(onchip, rates, states, 7,
                                        rate_scalers, itemsize, width, warps,
                                        depth, raw)
                    assert got == 4 * _gwords(onchip, rates, states, 7,
                                              rate_scalers, itemsize, width,
                                              warps, depth, raw)
                    assert got % 16 == 0


def test_generic_bytes_of_the_main_shapes():
    """DNA at 8 rates, 4 warps: a ring of 4 entries (1,440 bytes an entry:
    the row, P of 2 sides x 8 rates at 20 words, 16 sites' codes of 2
    children), 2,560 bytes a slot (128 lanes' 4 floats and counts); the
    float64 protein (20 states) at 4 warps: 25,728 bytes of P an entry,
    20,992 a slot, so 6 slots leave room for a ring of 4."""
    assert generic_bytes(True, 8, 4, 7, False, 4, 4, 4, 4, False) \
        == 64 + 4 * (32 + 2 * 8 * 80 + 2 * 16 * 4) + 7 * (2048 + 512) \
        == 23744
    entry = 32 + 2 * 4 * 804 * 4 + 2 * 32 * 4
    assert generic_bytes(True, 4, 20, 6, False, 8, 20, 4, 4, False) \
        == 64 + 4 * entry + 6 * (20 * 128 * 8 + 128 * 4) == 230080


@pytest.mark.parametrize("itemsize,states,width", [
    (4, 1, 4), (4, 2, 4), (4, 4, 4), (4, 5, 8), (4, 8, 8), (4, 9, 16),
    (4, 15, 16), (4, 16, 16), (8, 2, 4), (8, 4, 4), (8, 5, 8), (8, 12, 16),
    (8, 17, 20), (8, 20, 20), (8, 21, 32), (8, 32, 32)])
def test_instantiated_width_for_each_state_count(itemsize, states, width):
    plan = generic_plan(4, states, 7, False, H100, NARROW, SMS,
                        itemsize=itemsize)
    assert plan.padded_states == width
    assert width in GENERIC_WIDTHS[itemsize]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rates", [1, 3, 8, 33])
def test_generic_spills_at_a_large_slot_count(itemsize, rates):
    """The slots of one warp's sites do not fit at 2000 slots: spilled,
    P through L1 (the ring holds the rows and tips only), the warps the
    sites ask for, and the walk's slots in device memory."""
    plan = generic_plan(rates, 4, 2000, False, H100, DNA, SMS,
                        itemsize=itemsize)
    onchip = generic_plan(rates, 4, 7, False, H100, DNA, SMS,
                          itemsize=itemsize)
    assert plan.plan == "spill" and plan.depth == GENERIC_DEPTHS[0]
    assert plan.warps == onchip.warps
    assert plan.smem_bytes == generic_bytes(False, rates, 4, 2000, False,
                                            itemsize, 4, plan.warps,
                                            plan.depth, False)
    assert spill_slots(plan, 2000) == 2000
    assert onchip.plan == "on-chip" and spill_slots(onchip, 7) == 0


def test_generic_spills_where_p_does_not_fit():
    """float64 at 16 rates x 32 states: P's two sides take 262,656 bytes
    an entry, more than a block has, so the walk spills and reads P
    through L1 whatever its slots; 4 rates fit at one warp and a ring of
    2."""
    assert 2 * 16 * (32 * 32 * 2 + 4) * 4 > H100
    for n_slots in (1, 7):
        plan = generic_plan(16, 32, n_slots, False, H100, 300, SMS,
                            itemsize=8)
        assert plan.plan == "spill"
    plan = generic_plan(4, 32, 1, False, H100, 300, SMS, itemsize=8)
    assert (plan.plan, plan.warps, plan.depth) == ("on-chip", 1, 2)


def test_the_ring_shallows_before_the_warps_drop():
    """The float64 protein at 4 warps: a ring of 4 fits 6 slots, of 2 a
    seventh and more; only then do the warps drop."""
    plans = [generic_plan(4, 20, n, False, H100, PROTEIN, SMS, itemsize=8)
             for n in (6, 7, 8)]
    assert [(p.warps, p.depth) for p in plans] == [(4, 4), (4, 2), (4, 2)]
    assert all(p.smem_bytes <= H100 for p in plans)
    assert generic_bytes(True, 4, 20, 7, False, 8, 20, 4, 4, False) > H100


@pytest.mark.parametrize("states,itemsize", [(4, 8), (4, 4), (5, 4)])
def test_the_flagships_sites_reach_every_sm(states, itemsize):
    """3581 sites at 4 rates (8 sites a warp): 4 warps a block would give
    112 blocks, so a block takes 2 warps, 224 blocks; and at any width
    the blocks reach every SM, or the block is one warp."""
    plan = generic_plan(4, states, 20, False, H100, FLAGSHIP, SMS,
                        itemsize=itemsize)
    assert (plan.warps, plan.sites_per_block) == (2, 16)
    assert -(-FLAGSHIP // plan.sites_per_block) >= SMS
    assert -(-FLAGSHIP // (2 * plan.sites_per_block)) < SMS
    for sites in (1, 100, 1000, FLAGSHIP, 4224, 4225, DNA, 10 ** 6):
        for rates in (1, 3, 8, 33):
            p = generic_plan(rates, states, 7, False, H100, sites, SMS,
                             itemsize=itemsize)
            assert p.warps == 1 or -(-sites // p.sites_per_block) >= SMS


@pytest.mark.parametrize("k,warps", [(1, 2), (2, GENERIC_MAX_WARPS),
                                     (64, GENERIC_MAX_WARPS)])
def test_generic_candidates_count_their_blocks_together(k, warps):
    """The DNA problem without +G (1 rate, 32 sites a warp): one walk at
    16384 sites fills 132 SMs with blocks of 2 warps, K walks with 4."""
    plan = generic_plan(1, 4, 7, False, H100, DNA, SMS, candidates=k)
    assert plan.warps == warps


def test_generic_refuses_what_no_plan_takes():
    for kw in (dict(states=17), dict(states=0), dict(rates=0),
               dict(n_slots=0), dict(sites=0), dict(candidates=0),
               dict(states=33, itemsize=8), dict(states=1, itemsize=8),
               dict(itemsize=2)):
        args = dict(rates=4, states=5, n_slots=7, sites=DNA, candidates=1,
                    itemsize=4)
        args.update(kw)
        with pytest.raises(ValueError):
            generic_plan(args["rates"], args["states"], args["n_slots"],
                         False, H100, args["sites"], SMS, args["candidates"],
                         args["itemsize"])
    # a device whose blocks cannot hold even the spill plan's ring
    with pytest.raises(ValueError):
        generic_plan(4, 5, 7, False, 256, DNA, SMS)
    with pytest.raises(ValueError):
        fused_plan(4, 17, 7, False, H100, DNA, SMS)


# The 4 x 4 on-chip body's thread block clusters (fused_plan's `split`,
# ops/fused.py:split_fused_schedule of the launch's tables): the trees of
# the DNA main path (128 taxa, 126 ops, 7 slots) and of the 246 x 4465
# repeats problem (244 ops, 10 slots)
def _tree_table(taxa, seed):
    from libpll2_tpu_torch.ops.fused import pack_fused_schedule
    from libpll2_tpu_torch.trees import (create_operations, random_utree,
                                         traverse)

    tree = random_utree([f"t{i}" for i in range(taxa)], seed=seed)
    ops, _, _ = create_operations(traverse(tree.vroot))
    root = tree.vroot
    return pack_fused_schedule(ops, tree.tip_count,
                               (root.clv_index, root.back.clv_index))


def _split_of(table, calls=None):
    """fused_plan's `split` for one table, recording the parts asked."""
    from libpll2_tpu_torch.ops.fused import split_fused_schedule

    def split(parts):
        if calls is not None:
            calls.append(parts)
        sp = split_fused_schedule(table, parts)
        return sp.n_slots, sp.critical
    return split


def _cluster_plan(taxa, seed, sites, candidates=1, rate_scalers=False):
    table, n_slots = _tree_table(taxa, seed)
    calls = []
    plan = fused_plan(4, 4, n_slots, rate_scalers, H100, sites, SMS,
                      candidates, split=_split_of(table, calls))
    return plan, calls


@pytest.mark.parametrize("rate_scalers", [False, True])
def test_dna_main_path_walk_takes_a_cluster_of_two(rate_scalers):
    """128 x 16384: two subtree streams (5 slots, 66 ops on the critical
    path) on 512 blocks of 64 sites, 256 clusters of 2, one wave of the
    card's 4 blocks an SM; 4 and 8 blocks a cluster would take two and four
    waves (both lost on an H100: PERF.md, Findings)."""
    plan, calls = _cluster_plan(128, 7, DNA, rate_scalers=rate_scalers)
    assert plan == FusedPlan("on-chip", 2, 64, fused_onchip_bytes(5, 2), 2)
    # 4 and 8 blocks a cluster take more than one wave whatever the split:
    # only the walk's op count and the split into 2 are asked for
    assert calls == [1, 2]


def test_repeats_walk_takes_a_cluster_of_four():
    """246 x 4465: four streams (8 slots, 67 ops) on 280 blocks; 8 blocks
    a cluster (560 blocks) would not fit one wave. The split into 4 is
    asked for first (its least possible cost is the lowest), and then 2
    blocks a cluster cannot beat it even split evenly: it is not split."""
    plan, calls = _cluster_plan(246, 13, REPEATS)
    assert plan == FusedPlan("on-chip", 2, 64, fused_onchip_bytes(8, 2), 4)
    assert calls == [1, 4]


def _exhaustive_cluster(plan, smem_bytes, sites, sms, candidates, split):
    """The cluster plan by every size's own cost, least first, of equal
    costs the smaller size: what `fused_plan` picks without splitting
    every size."""
    spt = 4 // plan.threads_per_site
    blocks = candidates * -(-sites // plan.sites_per_block)
    resident = fused_resident_blocks(plan.smem_bytes, spt)
    if blocks >= sms * resident:
        return plan
    best = (fused_walk_cost(blocks, resident, split(1)[1], sms), 1, plan)
    for parts in (2, 4, 8):
        n_slots, critical = split(parts)
        nbytes = fused_onchip_bytes(n_slots, spt)
        if nbytes > smem_bytes:
            continue
        c = fused_walk_cost(blocks * parts,
                            fused_resident_blocks(nbytes, spt), critical,
                            sms, parts)
        if c is not None and (c, parts) < best[:2]:
            best = (c, parts, plan._replace(smem_bytes=nbytes,
                                            cluster=parts))
    return best[2]


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(taxa=st.integers(4, 300), seed=st.integers(0, 2**16),
       sites=st.sampled_from([300, 1000, 4096, 4465, 9000, 16384]),
       candidates=st.sampled_from([1, 2, 3]))
def test_cluster_plan_splits_only_what_could_win(taxa, seed, sites,
                                                 candidates):
    """The plan that splits a size only where its least possible cost
    could beat the best so far picks what splitting every size picks."""
    table, n_slots = _tree_table(taxa, seed)
    split = _split_of(table)
    plan = fused_plan(4, 4, n_slots, False, H100, sites, SMS, candidates,
                      split=split)
    base = fused_plan(4, 4, n_slots, False, H100, sites, SMS, candidates)
    if base.plan != "on-chip":
        assert plan == base
        return
    assert plan == _exhaustive_cluster(base, H100, sites, SMS, candidates,
                                       split)


def test_a_shard_of_the_main_path_takes_a_cluster_of_four():
    """A 4096-site shard: one site a thread, 128 blocks of 32 sites, four
    streams of 5 slots."""
    plan, _ = _cluster_plan(128, 7, 4096)
    assert plan == FusedPlan("on-chip", 4, 32, fused_onchip_bytes(5, 1), 4)


@pytest.mark.parametrize("walks", [128, 16 * 60, 19])
def test_launches_that_fill_the_card_keep_one_block_a_walk(walks):
    """A chunk of 128 candidates, a 14-slot query launch of 16 queries x
    60 edges and 19 model trials at 128 x 16384 fill every SM's block
    slots with one block a walk: no split is asked for."""
    table, _ = _tree_table(128, 7)
    calls = []
    plan = fused_plan(4, 4, 14 if walks == 960 else 7, False, H100, DNA,
                      SMS, walks, split=_split_of(table, calls))
    assert plan.cluster == 1 and plan.threads_per_site == 2
    assert calls == []


def test_small_and_chained_walks_keep_one_block_a_walk():
    """A 16-taxon walk at 1000 sites (14 ops) gains less than a cluster
    costs; a caterpillar has no subtrees to split."""
    assert _cluster_plan(16, 3, NARROW)[0] == FusedPlan(
        "on-chip", 4, 32, fused_onchip_bytes(4, 1))
    from libpll2_tpu_torch.ops.fused import pack_fused_schedule
    from libpll2_tpu_torch.trees import (create_operations, parse_newick,
                                         traverse)

    text = "t79:0.1"
    for i in range(78, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    tree = parse_newick(f"(t0:0.1,t1:0.1,{text});")
    ops, _, _ = create_operations(traverse(tree.vroot))
    root = tree.vroot
    table, n_slots = pack_fused_schedule(
        ops, tree.tip_count, (root.clv_index, root.back.clv_index))
    plan = fused_plan(4, 4, n_slots, False, H100, DNA, SMS,
                      split=_split_of(table))
    assert plan.cluster == 1


def test_spill_and_other_sizes_take_no_cluster():
    table, _ = _tree_table(128, 7)
    calls = []
    assert fused_plan(4, 4, 250, False, H100, DNA, SMS,
                      split=_split_of(table, calls)) == SPILL
    plan = fused_plan(3, 4, 7, False, H100, DNA, SMS,
                      split=_split_of(table, calls))
    assert isinstance(plan, GenericPlan) and calls == []


def test_resident_blocks_and_the_cost_model():
    """An SM holds the cluster body's blocks by shared memory (228 KB, 1
    KB reserved a block), threads (12 blocks of 160) and registers (96 a
    thread at two sites a thread: 4 blocks; 64 at one: 6); the model
    refuses a second wave and charges a cluster FUSED_CLUSTER_COST a
    block."""
    assert fused_resident_blocks(fused_onchip_bytes(7, 2), 2) == 4
    assert fused_resident_blocks(fused_onchip_bytes(10, 2), 2) == 3
    assert fused_resident_blocks(fused_onchip_bytes(5, 1), 1) == 6
    assert fused_resident_blocks(2048, 1) == 6
    assert fused_walk_cost(529, 4, 10, SMS) is None
    assert fused_walk_cost(528, 4, 10, SMS) == 10 * (FUSED_LATENCY_WARPS
                                                     + 16)
    assert fused_walk_cost(264, 4, 10, SMS, 2) == (
        10 * (FUSED_LATENCY_WARPS + 8) + 2 * FUSED_CLUSTER_COST)
